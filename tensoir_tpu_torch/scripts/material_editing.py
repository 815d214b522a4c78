"""Material editing (the port's counterpart of scripts/material_editing.py,
with the material-editing test set).

Loads a checkpoint, edits the decoded materials (an albedo tint, a
roughness scale) and renders them under a held-out environment light,
writing ``<out>/edit_<view>_<light>.png``.

Usage:
  python -m tensoir_tpu_torch.scripts.material_editing \\
      --config configs/relighting_test/armadillo.txt --ckpt <ckpt.npz> \\
      [--albedo_tint 1.0,0.3,0.3] [--roughness_scale 0.5]

It runs on the card; ``main(argv, device="cpu")`` runs it on the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from tensoir_tpu_torch.device import DeviceLike, resolve_device


def main(argv=None, device: DeviceLike = None) -> list:
    """Returns the edited images, float32 [H, W, 3] per view."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--datadir", type=str, default=None)
    parser.add_argument("--hdrdir", type=str, default=None)
    parser.add_argument("--light", type=str, default="city")
    parser.add_argument("--albedo_tint", type=str, default="1,1,1")
    parser.add_argument("--roughness_scale", type=float, default=1.0)
    parser.add_argument("--out", type=str, default="./material_edit")
    parser.add_argument("--n_views", type=int, default=1)
    parser.add_argument("--chunk", type=int, default=1024)
    args = parser.parse_args(argv)
    dev = resolve_device(device)

    import torch
    from tensoir_tpu_torch.config import load_config
    from tensoir_tpu_torch.data import get_dataset
    from tensoir_tpu_torch.models.env_light import EnvironmentLight
    from tensoir_tpu_torch.models.field import grid_size_of
    from tensoir_tpu_torch.models.lifecycle import cal_n_samples
    from tensoir_tpu_torch.render.relight_pipeline import make_relight_chunk_fn
    from tensoir_tpu_torch.utils.ckpt import load_checkpoint
    from tensoir_tpu_torch.utils.png import write_png

    cfg = load_config(args.config) if args.config else None
    datadir = args.datadir or (cfg.datadir if cfg else None)
    hdrdir = args.hdrdir or (cfg.hdrdir if cfg else None)

    fcfg, params, scene, _ = load_checkpoint(args.ckpt, device=dev)
    n_samples = cal_n_samples(grid_size_of(params), fcfg.step_ratio)

    ds = get_dataset("tensoIR_material_editing_test")(
        datadir, hdrdir, split="test", light_names=[args.light],
        sub=args.n_views)
    env = EnvironmentLight(hdrdir, device=dev)

    # the edits scale the decoded BRDF before the light integral: the tint
    # goes in as the albedo rescale, the roughness scale into the renderer
    tint = torch.as_tensor([float(v) for v in args.albedo_tint.split(",")],
                           dtype=torch.float32, device=dev)
    chunk_fn = make_relight_chunk_fn(
        fcfg, env, args.light, n_samples=n_samples, n_light_samples=256,
        second_n_sample=96, roughness_scale=args.roughness_scale)

    os.makedirs(args.out, exist_ok=True)
    key = torch.Generator(device=dev).manual_seed(0)
    images = []
    for vi in range(len(ds)):
        item = ds[vi]
        W, H = item["img_wh"]
        rays = np.asarray(item["rays"], np.float32)
        n = rays.shape[0]
        pad = -n % args.chunk
        if pad:
            rays = np.concatenate([rays, np.repeat(rays[-1:], pad, 0)], 0)
        rays_d = torch.as_tensor(rays, device=dev)
        outs = []
        for start in range(0, n + pad, args.chunk):
            _, with_bg, *_ = chunk_fn(params, scene,
                                      rays_d[start:start + args.chunk], key,
                                      tint)
            outs.append(with_bg.cpu().numpy())
        img = np.concatenate(outs, 0)[:n].reshape(H, W, 3)
        path = os.path.join(args.out, f"edit_{vi:03d}_{args.light}.png")
        write_png(path, (np.clip(img, 0, 1) * 255).astype(np.uint8))
        print("wrote", path)
        images.append(img)
    return images


if __name__ == "__main__":
    main(sys.argv[1:])
