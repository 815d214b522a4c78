#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (tensoir_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, one JSON line each:
  build        compile every CUDA kernel of the port from its source (nvcc,
               sm_90a), one nvcc per source, all at once
  kernels      each kernel against its plain PyTorch version on the card, at
               the shapes the training step gives it and at the Pallas
               probe's shapes: max abs error, kernel / plain / library ms,
               and the bound (bytes moved at 3.35 TB/s)
  step_parity  one deterministic training step at a reduced size (grid 64,
               batch 512, 128 samples) on the card with the kernels and on
               the CPU with the plain versions: loss and every parameter
  train        the radiance-phase training step of
               configs/single_light/armadillo.txt at full width (the grid
               and march length the config gives at iteration 0, batch
               4096) on a solid-blob scene: 2 warm-up steps, then 10 timed
               steps with the launch counts zeroed just before them
Then the kernel summary line, the card's name and power limit, and the last
line {"ok": true, "device": ...}. Any failure exits non-zero without that
line; so does a machine without CUDA. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (data sheet)
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
F32_EPS = 2.0 ** -23
ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "single_light" / "armadillo.txt"
# data/tensoir.py scene_bbox, float32 as train/loop.py reads it: in f32,
# n_to_reso(128**3) gives 128 per axis (in f64 it would give 127)
AABB = np.array([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]], np.float32)
NEAR_FAR = (2.0, 6.0)                          # data/tensoir.py near_far
BATCH = 4096
KERNEL_SOURCES = {
    "row_gather": ("tensoir_tpu_torch/csrc/row_gather.cu",
                   "scripts/bench_pallas_scatter.py:78 (make_gather.kernel)"),
    "row_scatter_add": (
        "tensoir_tpu_torch/csrc/row_scatter_add.cu",
        "scripts/bench_pallas_scatter.py:37 (make_scatter_add.kernel)"),
}


class SmokeFailure(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build():
    from tensoir_tpu_torch.kernels import build
    t0 = time.perf_counter()
    info = build.build(force=True)
    wall = time.perf_counter() - t0
    ptxas = {k: [ln.strip() for ln in v["log"].splitlines()
                 if "registers" in ln] for k, v in info.items()}
    emit({"phase": "build", "ok": True, "seconds": wall,
          "per_source_s": {k: v["seconds"] for k, v in info.items()},
          "ptxas": ptxas})


def kernel_case(R: int, C: int, N: int, seed: int) -> dict:
    """Both kernels against their plain versions at one shape."""
    import torch
    from tensoir_tpu_torch.kernels import rows
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = torch.randn((R, C), device=dev, generator=gen)
    idx = torch.randint(0, R, (N,), device=dev, generator=gen,
                        dtype=torch.int32)
    val = torch.randn((N, C), device=dev, generator=gen)

    got = rows.row_gather(table, idx)
    want = rows.row_gather_plain(table, idx)
    torch.cuda.synchronize()
    g_err = float((got - want).abs().max())
    check(g_err == 0.0, f"row_gather R={R} C={C} N={N}: max abs err {g_err}")

    got = rows.row_scatter_add(idx, val, R)
    want = rows.row_scatter_add_plain(idx, val, R)
    torch.cuda.synchronize()
    s_err = float((got - want).abs().max())
    # atomics add in another order than index_add_: bound the difference of
    # two orders of the same f32 sum of at most n_max terms
    n_max = int(torch.bincount(idx.long(), minlength=R).max())
    s_tol = 2.0 * n_max * F32_EPS * float(val.abs().max())
    check(s_err <= s_tol, f"row_scatter_add R={R} C={C} N={N}: max abs err "
          f"{s_err} > {s_tol}")

    io_bytes = 4 * N + 4 * N * C + 4 * R * C
    bound_ms = io_bytes / HBM_BYTES_PER_S * 1e3
    scatter_ops_ms = N * C / F32_OPS_PER_S * 1e3
    acc = torch.empty((R, C), device=dev)

    def lib_scatter():
        acc.zero_()
        acc.index_add_(0, idx, val)

    return {
        "R": R, "C": C, "N": N,
        "row_gather": {
            "max_abs_err": g_err,
            "ms": time_ms(lambda: rows.row_gather(table, idx)),
            "plain_ms": time_ms(lambda: rows.row_gather_plain(table, idx)),
            "library_ms": time_ms(lambda: torch.index_select(table, 0, idx)),
            "bound_ms": bound_ms, "bound_by": "bytes", "tol": 0.0},
        "row_scatter_add": {
            "max_abs_err": s_err,
            "ms": time_ms(lambda: rows.row_scatter_add(idx, val, R)),
            "plain_ms": time_ms(
                lambda: rows.row_scatter_add_plain(idx, val, R)),
            "library_ms": time_ms(lib_scatter),
            "bound_ms": max(bound_ms, scatter_ops_ms),
            "bound_by": "bytes" if bound_ms >= scatter_ops_ms else "operations",
            "tol": s_tol},
    }


def slice_sizes():
    from tensoir_tpu_torch import config as C
    from tensoir_tpu_torch.models.lifecycle import cal_n_samples, n_to_reso
    cfg = C.load_config(str(CONFIG))
    reso = n_to_reso(cfg.N_voxel_init, AABB)
    n_samples = min(cfg.nSamples, cal_n_samples(reso, cfg.step_ratio))
    return cfg, reso, n_samples


def phase_kernels():
    cfg, reso, n_samples = slice_sizes()
    plane_rows = (reso[0] - 1) * (reso[1] - 1)
    shapes = {
        # (R, C, N): the step's packed density and appearance plane lookups
        "slice_density": (plane_rows, 4 * cfg.n_lamb_sigma[0],
                          BATCH * n_samples),
        "slice_app": (plane_rows, 4 * cfg.n_lamb_sh[0],
                      BATCH * cfg.app_cap_per_ray),
        # the Pallas probe's own shapes (scripts/bench_pallas_scatter.py)
        "probe_w64": (39601, 64, 2359296),
        "probe_w192": (39601, 192, 2359296 // 4),
    }
    out = {name: kernel_case(*shape, seed=i)
           for i, (name, shape) in enumerate(shapes.items())}
    emit({"phase": "kernels", "ok": True, "cases": out})
    return out


def make_step(fcfg, cfg, n_samples, deterministic, device):
    from tensoir_tpu_torch.train.optim import decay_factor, make_optimizer
    from tensoir_tpu_torch.train.step import (LossWeights, StepStatic,
                                              make_train_step)
    lr_factor = decay_factor(cfg.lr_decay_target_ratio, cfg.lr_decay_iters,
                             cfg.n_iters)
    st = StepStatic(n_samples=n_samples, is_relight=False, white_bg=True,
                    app_cap=cfg.app_cap_per_ray, march_cap=0,
                    deterministic=deterministic)
    w = LossWeights(ortho=cfg.Ortho_weight, l1=cfg.L1_weight_inital,
                    tv_density=cfg.TV_weight_density,
                    tv_app=cfg.TV_weight_app, lr_factor=lr_factor,
                    n_iters=cfg.n_iters,
                    relight_start=cfg.update_AlphaMask_list[0])
    opt = make_optimizer(None, cfg.lr_init, cfg.lr_basis, lr_factor,
                         lr_light=cfg.lr_light)
    return opt, make_train_step(fcfg, opt, st, w, device=device)


def field(fcfg, reso, seed, device):
    import torch
    from tensoir_tpu_torch.models.field import init_field_params
    from tensoir_tpu_torch.utils.bench_scene import seed_solid_blob
    gen = torch.Generator().manual_seed(seed)
    params, scene = init_field_params(gen, fcfg, reso, AABB, device=device)
    return seed_solid_blob(params), scene


def batch_of(n: int, device):
    import torch
    from tensoir_tpu_torch.utils.bench_scene import bench_rays
    return {"rays": torch.as_tensor(bench_rays(n), device=device),
            "rgbs": torch.full((n, 3), 0.5, device=device),
            "light_idx": torch.zeros((n,), dtype=torch.int32, device=device)}


def phase_step_parity():
    """One deterministic step, card (kernels) vs CPU (plain versions).

    Tolerance: loss 1e-5 relative; parameters 1e-4 absolute. The two runs
    sum in different orders (atomics, other reductions), which moves the
    gradients by f32 rounding; Adam's first step moves each element by
    about lr * sign(grad) (lr >= 1e-3), so rounding reaches a parameter
    only through a sign, far below 1e-4 unless a gradient is rounding noise.
    """
    import torch
    from tensoir_tpu_torch import config as C
    from tensoir_tpu_torch.train.optim import flatten
    cfg, _, _ = slice_sizes()
    fcfg = C.field_config_from(cfg, NEAR_FAR)
    reso, n_samples, n_rays = (64, 64, 64), 128, 512
    results = {}
    for dev in ("cuda", "cpu"):
        params, scene = field(fcfg, reso, seed=1, device=dev)
        opt, step_fn = make_step(fcfg, cfg, n_samples, True, dev)
        state = opt.init(params)
        params, state, m = step_fn(params, state, scene,
                                   batch_of(n_rays, dev), None, 0)
        results[dev] = (float(m["total_loss"]),
                        {k: v.detach().cpu() for k, v in flatten(params).items()})
    (l_gpu, p_gpu), (l_cpu, p_cpu) = results["cuda"], results["cpu"]
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    worst = {k: float((p_gpu[k] - p_cpu[k]).abs().max()) for k in p_cpu}
    over = {k: int(((p_gpu[k] - p_cpu[k]).abs() > 1e-4).sum())
            for k in p_cpu if worst[k] > 1e-4}
    emit({"phase": "step_parity", "ok": rel <= 1e-5 and not over,
          "loss_cuda": l_gpu, "loss_cpu": l_cpu, "loss_rel_err": rel,
          "param_max_abs_err": max(worst.values()),
          "worst_param": max(worst, key=worst.get),
          "elements_over_tol": over, "tol": {"loss_rel": 1e-5,
                                             "param_abs": 1e-4}})
    check(math.isfinite(l_gpu) and rel <= 1e-5,
          f"step_parity loss {l_gpu} vs {l_cpu}")
    check(not over, f"step_parity parameters over 1e-4: {over}")


def phase_train():
    import torch
    from tensoir_tpu_torch import config as C
    from tensoir_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from tensoir_tpu_torch.models.field import grid_size_of
    cfg, reso, n_samples = slice_sizes()
    fcfg = C.field_config_from(cfg, NEAR_FAR)
    params, scene = field(fcfg, reso, seed=0, device="cuda")
    check(grid_size_of(params) == reso, "grid")
    opt, step_fn = make_step(fcfg, cfg, n_samples, False, "cuda")
    state = opt.init(params)
    batch = batch_of(BATCH, "cuda")
    key = torch.Generator(device="cuda").manual_seed(1)
    it = 0
    for _ in range(2):
        params, state, m = step_fn(params, state, scene, batch, key, it)
        it += 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(10):
        params, state, m = step_fn(params, state, scene, batch, key, it)
        losses.append(m["total_loss"])
        it += 1
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 10 * 1e3
    launches = dict(LAUNCHES)
    losses = [float(x) for x in losses]
    res = {"phase": "train", "grid": list(reso), "n_samples": n_samples,
           "batch": BATCH, "points_per_step": BATCH * n_samples,
           "step_ms": step_ms, "loss_first": losses[0],
           "loss_last": losses[-1], "losses": losses,
           "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "psnr_last": float(m["psnr"])}
    ok = (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
          and all(v > 0 for v in launches.values()))
    res["ok"] = ok
    emit(res)
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel was not launched on the main path: {launches}")

    # where one step's device time goes, by CUDA kernel, and the share of
    # the timed step the card sat idle (informational: not a pass/fail)
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            params, state, m = step_fn(params, state, scene, batch, key, it)
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
        emit({"phase": "breakdown", "device_busy_ms": busy_ms,
              "idle_share": 1.0 - busy_ms / step_ms,
              "top_kernels": [
                  {"name": e.key[:90], "ms": e.self_device_time_total / 1e3,
                   "calls": e.count}
                  for e in sorted(kern, key=lambda e: -e.self_device_time_total)
                  [:20]]})
    except Exception as exc:  # noqa: BLE001  diagnostic only
        emit({"phase": "breakdown", "measured": False, "error": repr(exc)})
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    try:
        import tensoir_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable ({exc}); run from "
              "the root of a checkout", file=sys.stderr)
        return 2
    from tensoir_tpu_torch import resolve_device
    resolve_device("cuda")
    t_start = time.perf_counter()
    try:
        phase_build()
        cases = phase_kernels()
        phase_step_parity()
        launches = phase_train()
    except SmokeFailure as exc:
        emit({"ok": False, "failure": str(exc)})
        return 1
    dens = cases["slice_density"]
    summary = []
    for name, (src, replaces) in KERNEL_SOURCES.items():
        c = dens[name]
        summary.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "shape": {"R": dens["R"], "C": dens["C"], "N": dens["N"]}})
    emit({"kernels": summary})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"# total seconds {time.perf_counter() - t_start:.1f}",
          file=sys.stderr)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
