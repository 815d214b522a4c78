"""Mesh export of a checkpoint (the port's counterpart of
scripts/export_mesh.py): the field's dense alpha on its own grid, on the
card, then the ``alpha > level`` surface extracted on the host and written
as a binary PLY beside the checkpoint (``ckpt_final.npz`` ->
``ckpt_final.ply``).

Usage:
  python -m tensoir_tpu_torch.scripts.export_mesh --ckpt <ckpt_final.npz> [--level 0.005]

It runs on the card; ``main(argv, device="cpu")`` runs it on the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys

from tensoir_tpu_torch.device import DeviceLike, resolve_device


def mesh_path(ckpt: str) -> str:
    """The PLY beside ``ckpt``; never the checkpoint's own path."""
    root, ext = os.path.splitext(ckpt)
    return (root if ext == ".npz" else ckpt) + ".ply"


def export_checkpoint(ckpt: str, level: float = 0.005,
                      device: DeviceLike = None):
    """Load ``ckpt`` on ``device``, evaluate its dense alpha at the field's
    grid and write the mesh; returns (PLY path, verts, faces)."""
    dev = resolve_device(device)
    from tensoir_tpu_torch.models.field import grid_size_of
    from tensoir_tpu_torch.models.lifecycle import dense_alpha
    from tensoir_tpu_torch.utils.ckpt import load_checkpoint
    from tensoir_tpu_torch.utils.mesh_export import export_mesh_from_alpha

    fcfg, params, scene, _ = load_checkpoint(ckpt, device=dev)
    alpha = dense_alpha(fcfg, params, scene, grid_size_of(params))
    out = mesh_path(ckpt)
    verts, faces = export_mesh_from_alpha(
        alpha.cpu().numpy(), scene["aabb"].cpu().numpy(), out, level=level)
    return out, verts, faces


def main(argv=None, device: DeviceLike = None):
    """Returns (PLY path, verts, faces)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--level", type=float, default=0.005)
    args = parser.parse_args(argv)
    out, verts, faces = export_checkpoint(args.ckpt, args.level, device)
    print(f"mesh written to {out}: {len(verts)} verts, {len(faces)} faces")
    return out, verts, faces


if __name__ == "__main__":
    main(sys.argv[1:])
