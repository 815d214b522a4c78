"""Rotated multi-light demo of the port: the analytic shadow scene lit by
three azimuthal rotations of one light (the rotated-lights capture
setting) trains the shared SG set with its per-light rotations and the
``light_line`` multi-light factorization; then each light's test views are
evaluated against the ground truth (novel-view and BRDF PSNR, normal MAE,
albedo PSNR) and the metrics written to ``<out>/final_metrics.json``. The
flags and the configuration are those of the JAX package's
``examples/train_multilight_demo.py``, including its curriculum: only the
``--cap_start`` highest-acc rays are relit, and the fast-march knobs stay
off, until ``--fast_march_start`` (default 0.6 x ``--iters``).

Usage:  python -m tensoir_tpu_torch.examples.train_multilight_demo [--iters 4000] [--out DIR]

``train_general_multilight_demo`` runs the general setting (three distinct
lights, one SG set each) through the same functions. Both run on the card;
``main(argv, device="cpu")`` runs them on the CPU from Python.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from tensoir_tpu_torch.device import DeviceLike, resolve_device

LIGHTS = 3
# the rotated demo's batch and fast-march flags with their defaults; the
# general demo has no such flags and runs at these values
KNOBS = {"batch": 4096, "window": 48, "window_back": 16, "prepass": 12,
         "dilate": 3, "compact": 0.5625, "app_bake": 64, "bake_reso": 128,
         "sec_stats": 0}


def parse_args(argv=None, general: bool = False):
    parser = argparse.ArgumentParser()
    parser.add_argument("--iters", type=int, default=4000)
    parser.add_argument("--out", type=str, default=(
        "./log/general_multilight_demo" if general
        else "./log/multilight_demo"))
    parser.add_argument("--img", type=int, default=96)
    parser.add_argument("--views", type=int, default=16)
    if not general:
        for key, value in KNOBS.items():
            parser.add_argument(f"--{key}", type=type(value), default=value)
    parser.add_argument("--relight_cap", type=int, default=4096,
                        help="surface rays fed to the relight branch after "
                             "the curriculum flip")
    parser.add_argument("--fast_march_start", type=int, default=None,
                        help="iteration at which the fast-march knobs and "
                             "the full relight cap switch on (0 = from the "
                             "start; default 0.6 x --iters)")
    parser.add_argument("--brdf_warmup", type=int, default=0,
                        help="linear BRDF-weight ramp over the first N "
                             "relight iterations (0 = constant weight)")
    if general:
        parser.add_argument("--lr_light", type=float, default=1e-3,
                            help="learning rate of the light group")
    parser.add_argument("--cap_start", type=int, default=512,
                        help="relight only this many highest-acc rays until "
                             "the fast_march_start flip (0 = off)")
    args = parser.parse_args(argv)
    if general:
        vars(args).update(KNOBS)
    args.general = general
    return args


def demo_config(args):
    """The JAX demo's TensoIRConfig for the flags ``args``."""
    from tensoir_tpu_torch.config import TensoIRConfig
    it = args.iters
    lights = (dict(light_name_list=("sunset", "noon", "dusk"),
                   lr_light=args.lr_light) if args.general
              else dict(light_rotation=("000", "120", "240")))
    return TensoIRConfig(
        expname=("general_multilight_demo" if args.general
                 else "multilight_demo"),
        basedir=args.out,
        n_iters=it,
        batch_size=args.batch,
        lr_decay_iters=it,
        N_voxel_init=64 ** 3,
        N_voxel_final=128 ** 3,
        upsamp_list=(int(it * 0.3),),
        update_AlphaMask_list=(int(it * 0.3), int(it * 0.45)),
        n_lamb_sigma=(16, 16, 16),
        n_lamb_sh=(48, 48, 48),
        light_kind="sg",
        numLgtSGs=64,
        envmap_h=8,
        envmap_w=16,
        second_nSample=96,
        rgb_brdf_weight=0.2,
        normals_diff_weight=0.0005,
        normals_orientation_weight=0.001,
        albedo_smoothness_loss_weight=0.001,
        roughness_smoothness_loss_weight=0.001,
        L1_weight_inital=8e-5,
        L1_weight_rest=4e-5,
        TV_weight_density=0.05,
        TV_weight_app=0.005,
        app_cap_per_ray=32,
        march_cap_primary=192,
        relight_ray_cap=args.relight_cap,
        secondary_bake_reso=args.bake_reso,
        second_window=args.window,
        second_window_back=args.window_back,
        second_prepass_n=args.prepass,
        coarse_dilate=args.dilate,
        secondary_compact_frac=args.compact,
        app_bake_reso=args.app_bake,
        secondary_stats=bool(args.sec_stats),
        fast_march_start=(args.fast_march_start
                          if args.fast_march_start is not None
                          else int(it * 0.6)),
        rgb_brdf_warmup_iters=args.brdf_warmup,
        relight_cap_start=args.cap_start,
        secondary_tile=32768,
        vis_every=0, N_vis=0, save_iters=0,
        progress_refresh_rate=50,
        **lights,
    )


def run(args, device: DeviceLike = None) -> dict:
    """Train on the three-light scene, evaluate each light's test views;
    returns the metrics written to ``final_metrics.json``."""
    dev = resolve_device(device)
    from tensoir_tpu_torch.data.synthetic import SyntheticShadowDataset
    from tensoir_tpu_torch.render.eval import evaluation_iter
    from tensoir_tpu_torch.train.loop import reconstruction

    cfg = demo_config(args)
    train_ds = SyntheticShadowDataset(split="train", n_views=args.views,
                                      img_wh=(args.img, args.img),
                                      light_num=LIGHTS)
    test_ds = SyntheticShadowDataset(split="test", n_views=3,
                                     img_wh=(args.img, args.img),
                                     light_num=LIGHTS)

    t0 = time.time()
    result = reconstruction(
        cfg, train_ds, log_dir=args.out,
        progress_cb=lambda i, m: print(
            f"it {i:05d} psnr {m.get('psnr', 0):.2f} "
            f"brdf {m.get('loss_rgb_brdf', 0):.5f} "
            f"elapsed {m['elapsed_s']:.0f}s", flush=True),
        device=dev)
    train_time = time.time() - t0

    all_metrics = {"train_time_s": train_time, "iters": args.iters}
    for li in range(LIGHTS):
        metrics = evaluation_iter(
            result.fcfg, result.params, result.scene, test_ds,
            n_samples=result.n_samples,
            save_path=os.path.join(args.out, f"eval_light{li}"),
            chunk=cfg.batch_size_test, test_all=True,
            compute_extra_metrics=False,
            second_n_sample=cfg.second_nSample,
            secondary_tile=cfg.secondary_tile, light_idx_to_test=li)
        all_metrics[f"light{li}"] = metrics
        print(f"light {li}: {metrics}", flush=True)
    print(json.dumps(all_metrics, indent=2), flush=True)
    with open(os.path.join(args.out, "final_metrics.json"), "w") as f:
        json.dump(all_metrics, f, indent=2)
    return all_metrics


def main(argv=None, device: DeviceLike = None) -> dict:
    """The rotated setting; returns the metrics of ``final_metrics.json``."""
    return run(parse_args(argv), device)


if __name__ == "__main__":
    main(sys.argv[1:])
