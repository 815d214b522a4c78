"""Relighting against true ground truth (the port's counterpart of
examples/relight_demo.py).

Builds two synthetic held-out HDR probes, renders the exact env-lit ground
truth of the analytic shadow scene (lambertian shading with shadow
visibility is closed-form, ``SyntheticShadowDataset.render_env_gt``), and
runs the importance-sampled relighting benchmark on a trained checkpoint
(the demo's ``ckpt_final.npz``), writing ``<out>/relight_metrics.json``.

Usage:
  python -m tensoir_tpu_torch.examples.relight_demo \
      --ckpt log/synthetic_demo/ckpt_final.npz

It runs on the card; ``main(argv, device="cpu")`` runs it on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from tensoir_tpu_torch.device import DeviceLike, resolve_device


def make_probes(out_dir: str, h: int = 16, w: int = 32):
    """Two synthetic HDR probes, written to ``out_dir``: a warm directional
    blob (sunset2) and a cool and a warm blob (twinlight)."""
    from tensoir_tpu_torch.data.hdr import write_hdr
    from tensoir_tpu_torch.models.lighting import envmap_dirs

    _, dirs = envmap_dirs(h, w)
    dirs = dirs.reshape(h, w, 3)

    def blob(center_dir, sharp, color):
        d = np.asarray(center_dir, np.float64)
        d /= np.linalg.norm(d)
        dots = (dirs * d).sum(-1)
        return np.exp(sharp * (dots - 1.0))[..., None] * np.asarray(color)

    probes = {
        "sunset2": (0.10 + 3.0 * blob([0.6, 0.2, 0.75], 12,
                                      [1.0, 0.8, 0.55])).astype(np.float32),
        "twinlight": (0.06 + 2.0 * blob([-0.5, 0.5, 0.7], 18, [0.5, 0.7, 1.0])
                      + 1.5 * blob([0.7, -0.4, 0.6], 18,
                                   [1.0, 0.6, 0.4])).astype(np.float32),
    }
    os.makedirs(out_dir, exist_ok=True)
    for name, img in probes.items():
        write_hdr(os.path.join(out_dir, f"{name}.hdr"), img)
    return probes


class RelightGTDataset:
    """The shadow scene's test views, each with its white-composited ground
    truth under every probe of ``hdr_dir`` (the relighting test set's
    contract; the benchmark scores the white-background image)."""

    def __init__(self, base, hdr_dir: str, light_names):
        from tensoir_tpu_torch.data.hdr import read_hdr
        self.base = base
        self.light_names = list(light_names)
        self.probes = [read_hdr(os.path.join(hdr_dir, f"{n}.hdr"))
                       for n in self.light_names]

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        item = self.base[i]
        rays = np.asarray(item["rays"], np.float32)
        item["rgbs"] = np.stack([
            self.base.render_env_gt(rays, p, background="white")
            for p in self.probes], 0)
        return item


def main(argv=None, device: DeviceLike = None) -> dict:
    """Returns {light: {psnr, ssim}}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--out", type=str, default="./log/relight_demo")
    parser.add_argument("--img", type=int, default=96)
    parser.add_argument("--n_views", type=int, default=2)
    parser.add_argument("--chunk", type=int, default=1024)
    parser.add_argument("--n_light_samples", type=int, default=512)
    args = parser.parse_args(argv)
    dev = resolve_device(device)

    from tensoir_tpu_torch.data.synthetic import SyntheticShadowDataset
    from tensoir_tpu_torch.models.env_light import EnvironmentLight
    from tensoir_tpu_torch.models.field import grid_size_of
    from tensoir_tpu_torch.models.lifecycle import cal_n_samples
    from tensoir_tpu_torch.render.relight_pipeline import relight_benchmark
    from tensoir_tpu_torch.utils.ckpt import load_checkpoint

    hdr_dir = os.path.join(args.out, "probes")
    probes = make_probes(hdr_dir)
    env = EnvironmentLight(hdr_dir, device=dev)

    fcfg, params, scene, _ = load_checkpoint(args.ckpt, device=dev)
    n_samples = cal_n_samples(grid_size_of(params), fcfg.step_ratio)

    base = SyntheticShadowDataset(split="test", n_views=args.n_views,
                                  img_wh=(args.img, args.img))
    results = relight_benchmark(
        fcfg, params, scene, RelightGTDataset(base, hdr_dir, probes), env,
        n_samples=n_samples, save_path=args.out, chunk=args.chunk,
        n_light_samples=args.n_light_samples, second_n_sample=96,
        vis_tile=32768)
    print(json.dumps(results, indent=2))
    with open(os.path.join(args.out, "relight_metrics.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
