"""End-to-end demo of the port: inverse rendering of the procedural shadow
scene (a sphere over a disc, analytic ground truth with cast shadows).

The whole TensoIR pipeline runs: the radiance phase, the alpha-mask /
shrink / upsample schedule, then the relight phase (BRDF, normals,
secondary visibility); then the test views are evaluated against the
ground truth (novel-view and BRDF PSNR/SSIM, normal MAE, albedo PSNR) and
the metrics written to ``<out>/final_metrics.json``. The flags and the
configuration are those of the JAX package's ``examples/
train_synthetic_demo.py``.

Usage:  python -m tensoir_tpu_torch.examples.train_synthetic_demo [--iters 5000] [--out DIR]

It runs on the card; ``main(argv, device="cpu")`` runs it on the CPU from
Python.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from tensoir_tpu_torch.device import DeviceLike, resolve_device


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--iters", type=int, default=5000)
    parser.add_argument("--out", type=str, default="./log/synthetic_demo")
    parser.add_argument("--img", type=int, default=128)
    parser.add_argument("--views", type=int, default=24)
    parser.add_argument("--batch", type=int, default=4096)
    parser.add_argument("--save_iters", type=int, default=0,
                        help="periodic full-state checkpoints (long runs)")
    parser.add_argument("--resume", type=str, default="",
                        help="resume exactly from a checkpoint of a run with "
                             "the same flags (optimizer, generator, sampler "
                             "and schedule state)")
    parser.add_argument("--bake_reso", type=int, default=0,
                        help="coarse secondary-visibility bake cap (0=full)")
    parser.add_argument("--window", type=int, default=0,
                        help="interval-culled secondary march window (0=off)")
    parser.add_argument("--window_back", type=int, default=0,
                        help="back-anchored part of the window")
    parser.add_argument("--prepass", type=int, default=18,
                        help="coarse-occupancy prepass samples")
    parser.add_argument("--dilate", type=int, default=2,
                        help="coarse-occupancy dilation (cells)")
    parser.add_argument("--compact", type=float, default=0.0,
                        help="hemisphere-pair compaction fraction (0=off)")
    parser.add_argument("--relight_cap", type=int, default=512,
                        help="surface rays fed to the relight branch")
    parser.add_argument("--app_bake", type=int, default=0,
                        help="per-light radiance-feature bake resolution for "
                             "the secondary appearance path (0=exact VM)")
    parser.add_argument("--march_group", type=int, default=0,
                        help="grouped secondary march (0/1=off)")
    parser.add_argument("--group_bake", type=int, default=0,
                        help="bake resolution of the grouped march's block "
                             "rows (0=secondary_bake_reso)")
    parser.add_argument("--primary_group", type=int, default=0,
                        help="grouped primary march (0/1=off)")
    parser.add_argument("--app_cap_secondary", type=int, default=16,
                        help="app samples per selected secondary pair (k)")
    parser.add_argument("--pair_frac", type=float, default=0.0,
                        help="per-tile app pair cap as a tile fraction "
                             "(0=auto: tile/2 compacted, tile/4 dense)")
    parser.add_argument("--sec_stats", type=int, default=0,
                        help="log the sec/* cap occupancy/overflow statistics")
    parser.add_argument("--fast_march_start", type=int, default=0,
                        help="iteration at which the lossy fast-march knobs "
                             "(window, app bake) switch on; 0 = from the "
                             "start")
    parser.add_argument("--phase_anchor", type=int, default=0,
                        help="place the upsample / alpha-mask / relight "
                             "schedule within THIS many iterations instead "
                             "of scaling it with --iters (0 = scale)")
    return parser.parse_args(argv)


def demo_config(args):
    """The JAX demo's TensoIRConfig for the flags ``args``."""
    from tensoir_tpu_torch.config import TensoIRConfig
    it = args.iters
    anchor = min(args.phase_anchor or it, it)
    return TensoIRConfig(
        expname="synthetic_demo",
        basedir=args.out,
        n_iters=it,
        batch_size=args.batch,
        lr_decay_iters=it,
        N_voxel_init=64 ** 3,
        N_voxel_final=160 ** 3,
        upsamp_list=(int(anchor * 0.24), int(anchor * 0.52)),
        update_AlphaMask_list=(int(anchor * 0.24), int(anchor * 0.36),
                               int(anchor * 0.6)),
        n_lamb_sigma=(16, 16, 16),
        n_lamb_sh=(48, 48, 48),
        shadingMode="MLP_Fea",
        normals_kind="derived_plus_predicted",
        light_kind="sg",
        numLgtSGs=128,
        envmap_h=8,
        envmap_w=16,
        second_nSample=96,
        light_rotation=("000",),
        rgb_brdf_weight=0.2,
        normals_diff_weight=0.0005,
        normals_orientation_weight=0.001,
        albedo_smoothness_loss_weight=0.001,
        roughness_smoothness_loss_weight=0.001,
        L1_weight_inital=8e-5,
        L1_weight_rest=4e-5,
        TV_weight_density=0.05,
        TV_weight_app=0.005,
        Ortho_weight=0.0,
        app_cap_per_ray=32,
        march_cap_primary=192,
        march_cap_secondary=32,
        relight_ray_cap=args.relight_cap,
        second_window=args.window,
        second_window_back=args.window_back,
        second_prepass_n=args.prepass,
        coarse_dilate=args.dilate,
        secondary_compact_frac=args.compact,
        secondary_tile=32768,
        secondary_bake_reso=args.bake_reso,
        app_bake_reso=args.app_bake,
        second_march_group=args.march_group,
        group_bake_reso=args.group_bake,
        march_group=args.primary_group,
        second_app_cap=args.app_cap_secondary,
        app_pair_frac=args.pair_frac,
        secondary_stats=bool(args.sec_stats),
        fast_march_start=args.fast_march_start,
        vis_every=0,
        N_vis=0,
        save_iters=args.save_iters,
        progress_refresh_rate=50,
        ckpt=args.resume or None,
        resume_full=bool(args.resume),
    )


def main(argv=None, device: DeviceLike = None) -> dict:
    """Train and evaluate; returns the metrics written to
    ``final_metrics.json``."""
    args = parse_args(argv)
    dev = resolve_device(device)
    from tensoir_tpu_torch.data.synthetic import SyntheticShadowDataset
    from tensoir_tpu_torch.render.eval import evaluation_iter
    from tensoir_tpu_torch.train.loop import reconstruction

    cfg = demo_config(args)
    train_ds = SyntheticShadowDataset(split="train", n_views=args.views,
                                      img_wh=(args.img, args.img))
    test_ds = SyntheticShadowDataset(split="test", n_views=4,
                                     img_wh=(args.img, args.img))

    t0 = time.time()
    result = reconstruction(
        cfg, train_ds, log_dir=args.out,
        progress_cb=lambda i, m: print(
            f"it {i:05d} psnr {m.get('psnr', 0):.2f} "
            f"brdf {m.get('loss_rgb_brdf', 0):.5f} "
            f"elapsed {m['elapsed_s']:.0f}s", flush=True),
        device=dev)
    train_time = time.time() - t0
    print(f"training done in {train_time:.0f}s", flush=True)

    metrics = evaluation_iter(
        result.fcfg, result.params, result.scene, test_ds,
        n_samples=result.n_samples,
        save_path=os.path.join(args.out, "eval"),
        chunk=cfg.batch_size_test, test_all=True, compute_extra_metrics=True,
        second_n_sample=cfg.second_nSample,
        secondary_tile=cfg.secondary_tile)
    metrics["train_time_s"] = train_time
    metrics["iters"] = args.iters
    print(json.dumps(metrics, indent=2), flush=True)
    with open(os.path.join(args.out, "final_metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    return metrics


if __name__ == "__main__":
    main(sys.argv[1:])
