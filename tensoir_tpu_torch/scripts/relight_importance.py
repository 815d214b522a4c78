"""The relighting benchmark (the port's counterpart of
scripts/relight_importance.py).

Loads a checkpoint, builds the held-out environment lights from
``--hdrdir``, computes the global 3-channel albedo rescale through the
eval's G-buffer chunk, and relights every test view (``--test_number``
caps them) under the five held-out maps (bridge, city, fireplace, forest,
night), writing ``relight_psnr.txt`` and the per-view folders under
``<basedir>/relight_<expname>``.

Usage:
  python -m tensoir_tpu_torch.scripts.relight_importance \\
      --config configs/relighting_test/armadillo.txt --ckpt <ckpt_final.npz>

Any config key can be overridden as ``--key value`` (``--relight_fast_vis
1``: the fast visibility march on a baked grid). It runs on the card;
``main(argv, device="cpu")`` runs it on the CPU.
"""
from __future__ import annotations

import os
import sys

from tensoir_tpu_torch.data.relight_test import RELIGHT_LIGHTS
from tensoir_tpu_torch.device import DeviceLike, resolve_device
from tensoir_tpu_torch.train_tensoir import parse_cli

LIGHT_NAMES = list(RELIGHT_LIGHTS)


def main(argv=None, device: DeviceLike = None) -> dict:
    """Returns {light: {psnr, ssim}} over the views."""
    cfg = parse_cli(argv)
    # the reference fixes both (its relight_importance.py:354-365)
    for key, fixed in (("vis_equation", "nerv"), ("acc_mask_threshold", 0.5)):
        if getattr(cfg, key) != fixed:
            raise SystemExit(f"relighting uses {key} = {fixed}, as the "
                             f"reference does; got {getattr(cfg, key)}")
    dev = resolve_device(device)

    from tensoir_tpu_torch.data import get_dataset
    from tensoir_tpu_torch.models.env_light import EnvironmentLight
    from tensoir_tpu_torch.models.field import grid_size_of
    from tensoir_tpu_torch.models.lifecycle import cal_n_samples
    from tensoir_tpu_torch.render.eval import (compute_rescale_ratio,
                                               make_eval_chunk_fn)
    from tensoir_tpu_torch.render.relight_pipeline import relight_benchmark
    from tensoir_tpu_torch.utils.ckpt import load_checkpoint

    fcfg, params, scene, _ = load_checkpoint(cfg.ckpt, device=dev)
    n_samples = min(cfg.nSamples,
                    cal_n_samples(grid_size_of(params), cfg.step_ratio))

    dataset = get_dataset("tensoIR_relighting_test")(
        cfg.datadir, cfg.hdrdir, split="test", light_names=LIGHT_NAMES,
        downsample=cfg.downsample_test, sub=cfg.test_number)
    env = EnvironmentLight(cfg.hdrdir, device=dev)

    # the global 3-channel albedo rescale, from G-buffer chunks (one token
    # ray through the rendering equation)
    chunk_fn, chunk = make_eval_chunk_fn(
        fcfg, n_samples=n_samples, chunk=cfg.batch_size_test,
        is_relight=True, relight_ray_cap=1, second_n_sample=8,
        secondary_tile=1024)
    _, rescale3 = compute_rescale_ratio(chunk_fn, chunk, params, scene,
                                        dataset)
    print("three channels rescale ratio:", rescale3)

    results = relight_benchmark(
        fcfg, params, scene, dataset, env, n_samples=n_samples,
        save_path=os.path.join(cfg.basedir, f"relight_{cfg.expname}"),
        chunk=cfg.batch_size, n_light_samples=512,
        second_n_sample=cfg.second_nSample, vis_tile=cfg.secondary_tile,
        rescale3=rescale3, seed=cfg.seed, fast_vis=bool(cfg.relight_fast_vis),
        compute_extra_metrics=True)
    for name, r in results.items():
        print(f"{name}: {r}")
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
