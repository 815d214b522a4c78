#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (tensoir_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, one JSON line each:
  build        compile every CUDA kernel of the port from its source (nvcc,
               sm_90a), one nvcc per source, all at once
  kernels      each kernel against its plain PyTorch version on the card, at
               the shapes both training steps give it (K1 on bf16 rows at
               the baked grid's and the alpha masks') and at the Pallas
               probe's shapes: max abs error, kernel / plain / library ms,
               and the bound (bytes moved at 3.35 TB/s)
  step_parity  one deterministic training step at a reduced size (grid 64,
               batch 512, 128 samples) on the card with the kernels and on
               the CPU with the plain versions: loss and every parameter
  relight_step_parity
               one deterministic relight step at a reduced size (grid 48,
               batch 256, 64 relit rays, 8x16 light directions, tile 4096)
               on the card and on the CPU: loss, every parameter's
               gradient, and the baked sigma grid, with the step's per-tile
               pair cap, with the card's pair choice replayed on the CPU,
               and with the cap lifted
  train        the radiance-phase training step of
               configs/single_light/armadillo.txt at full width (the grid
               and march length the config gives at iteration 0, batch
               4096) on a solid-blob scene: 2 warm-up steps, then 10 timed
               steps with the launch counts zeroed just before them; then
               breakdown, one profiled step
  relight_train
               the relight-phase step of the same config at full width (the
               grid of the first alpha-mask update, 158^3, 547 samples,
               march cap 192, 1024 relit rays, 16x32 stratified light
               directions, 96 baked secondary samples in tiles of 16384) on
               the blob masked by update_alpha_mask: 2 warm-up steps, then
               10 timed steps with the counts zeroed just before them; then
               relight_breakdown, one profiled step
Then the kernel summary line, the card's name and power limit, and the last
line {"ok": true, "device": ...}. Any failure exits non-zero without that
line; so does a machine without CUDA. Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
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
    "row_gather_bf16": (
        "tensoir_tpu_torch/csrc/row_gather.cu",
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

    # the gather reads each distinct row it needs once; the scatter-add
    # writes every output row
    gather_ms = gather_bound_ms(idx, 4 * C)
    scatter_ms = (4 * N + 4 * N * C + 4 * R * C) / HBM_BYTES_PER_S * 1e3
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
            "bound_ms": gather_ms, "bound_by": "bytes", "tol": 0.0},
        "row_scatter_add": {
            "max_abs_err": s_err,
            "ms": time_ms(lambda: rows.row_scatter_add(idx, val, R)),
            "plain_ms": time_ms(
                lambda: rows.row_scatter_add_plain(idx, val, R)),
            "library_ms": time_ms(lib_scatter),
            "bound_ms": max(scatter_ms, scatter_ops_ms),
            "bound_by": ("bytes" if scatter_ms >= scatter_ops_ms
                         else "operations"),
            "tol": s_tol},
    }


def gather_bound_ms(idx, row_bytes: int) -> float:
    """The least time of a row gather: the index read, each output row
    written, and each distinct table row it needs read once, at the HBM
    rate."""
    import torch
    n, distinct = idx.numel(), torch.unique(idx).numel()
    return ((4 + row_bytes) * n + row_bytes * distinct) / HBM_BYTES_PER_S * 1e3


def bf16_gather_case(R: int, N: int, seed: int) -> dict:
    """K1 on bf16 rows of 8 corners (16 B) against its plain version,
    exactly."""
    import torch
    from tensoir_tpu_torch.kernels import rows
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = torch.randn((R, 8), device=dev, generator=gen).to(torch.bfloat16)
    idx = torch.randint(0, R, (N,), device=dev, generator=gen,
                        dtype=torch.int32)
    got = rows.row_gather(table, idx)
    want = rows.row_gather_plain(table, idx)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    check(torch.equal(got, want), f"row_gather_bf16 R={R} N={N}: max abs "
          f"err {err}")
    return {"R": R, "C": 8, "N": N, "max_abs_err": err, "tol": 0.0,
            "ms": time_ms(lambda: rows.row_gather(table, idx)),
            "plain_ms": time_ms(lambda: rows.row_gather_plain(table, idx)),
            "library_ms": time_ms(lambda: torch.index_select(table, 0, idx)),
            "bound_ms": gather_bound_ms(idx, 16), "bound_by": "bytes",
            "table_mb": R * 16 / 1e6}


def slice_sizes():
    from tensoir_tpu_torch import config as C
    from tensoir_tpu_torch.models.lifecycle import cal_n_samples, n_to_reso
    cfg = C.load_config(str(CONFIG))
    reso = n_to_reso(cfg.N_voxel_init, AABB)
    n_samples = min(cfg.nSamples, cal_n_samples(reso, cfg.step_ratio))
    return cfg, reso, n_samples


def phase_kernels():
    cfg, reso, n_samples = slice_sizes()
    _, rreso, _ = relight_sizes(cfg)
    plane_rows = (reso[0] - 1) * (reso[1] - 1)
    rplane_rows = (rreso[0] - 1) * (rreso[1] - 1)
    sigma_c, app_c = 4 * cfg.n_lamb_sigma[0], 4 * cfg.n_lamb_sh[0]
    shapes = {
        # (R, C, N): the radiance step's packed density and appearance
        # plane lookups
        "slice_density": (plane_rows, sigma_c, BATCH * n_samples),
        "slice_app": (plane_rows, app_c, BATCH * cfg.app_cap_per_ray),
        # the relight step's: the culled primary march, the appearance,
        # intrinsic and normal points, and one secondary tile's app stage
        "relight_density": (rplane_rows, sigma_c,
                            BATCH * cfg.march_cap_primary),
        "relight_app": (rplane_rows, app_c, BATCH * cfg.app_cap_per_ray),
        "relight_second_app": (rplane_rows, app_c, cfg.secondary_tile // 4
                               * cfg.second_app_cap),
        # the Pallas probe's own shapes (scripts/bench_pallas_scatter.py)
        "probe_w64": (39601, 64, 2359296),
        "probe_w192": (39601, 192, 2359296 // 4),
    }
    out = {name: kernel_case(*shape, seed=i)
           for i, (name, shape) in enumerate(shapes.items())}
    # K1 on bf16 rows: the relight step's baked sigma grid of one secondary
    # tile and its alpha mask at the culled primary march, and the
    # radiance step's one-row mask at its dense march
    cells = (rreso[0] - 1) * (rreso[1] - 1) * (rreso[2] - 1)
    out["bf16"] = {
        "baked_grid": bf16_gather_case(cells, cfg.secondary_tile
                                       * cfg.second_nSample, seed=10),
        "alpha_mask": bf16_gather_case(cells, BATCH * cfg.march_cap_primary,
                                       seed=11),
        "train_alpha_mask": bf16_gather_case(1, BATCH * n_samples, seed=12)}
    emit({"phase": "kernels", "ok": True, "cases": out})
    return out


def relight_sizes(cfg):
    """The grid and march length of the relight phase's start: the first
    upsampling's voxel count on the float32 AABB (158^3), as train/loop.py
    computes them when the first alpha-mask update turns relighting on."""
    from tensoir_tpu_torch.models.lifecycle import (cal_n_samples, n_to_reso,
                                                    voxel_schedule)
    n_vox = voxel_schedule(cfg.N_voxel_init, cfg.N_voxel_final,
                           len(cfg.upsamp_list))[0]
    reso = n_to_reso(n_vox, AABB)
    return n_vox, reso, min(cfg.nSamples, cal_n_samples(reso, cfg.step_ratio))


def make_step(fcfg, cfg, n_samples, deterministic, device, relight=False,
              **relight_kw):
    """The step train/loop.py builds for the radiance phase, or with
    ``relight`` for the relight phase (``relight_kw`` overrides its
    StepStatic fields, to cut the size)."""
    from tensoir_tpu_torch.train.optim import decay_factor, make_optimizer
    from tensoir_tpu_torch.train.step import (LossWeights, StepStatic,
                                              make_train_step)
    lr_factor = decay_factor(cfg.lr_decay_target_ratio, cfg.lr_decay_iters,
                             cfg.n_iters)
    if relight:
        kw = dict(sample_method=cfg.light_sample_train,
                  march_cap=cfg.march_cap_primary,
                  second_march_cap=cfg.march_cap_secondary,
                  secondary_use_baked=cfg.secondary_use_baked,
                  secondary_bake_reso=cfg.secondary_bake_reso,
                  second_app_cap=cfg.second_app_cap,
                  relight_ray_cap=cfg.relight_ray_cap,
                  second_n_sample=cfg.second_nSample,
                  second_near=cfg.second_near, second_far=cfg.second_far,
                  secondary_tile=cfg.secondary_tile)
        kw.update(relight_kw)
        st = StepStatic(n_samples=n_samples, is_relight=True, white_bg=True,
                        app_cap=cfg.app_cap_per_ray,
                        deterministic=deterministic, **kw)
        w = LossWeights(ortho=cfg.Ortho_weight, l1=cfg.L1_weight_rest,
                        rgb_brdf=cfg.rgb_brdf_weight,
                        normals_diff=cfg.normals_diff_weight,
                        normals_ori=cfg.normals_orientation_weight,
                        albedo_sm=cfg.albedo_smoothness_loss_weight,
                        rough_sm=cfg.roughness_smoothness_loss_weight,
                        lr_factor=lr_factor, n_iters=cfg.n_iters,
                        relight_start=cfg.update_AlphaMask_list[0])
    else:
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

    emit_breakdown("breakdown", lambda: step_fn(params, state, scene, batch,
                                                key, it), step_ms)
    return launches


# the record_function ranges of the step (train/step.py, render/*.py)
RANGES = ("forward", "backward", "adam", "primary", "derived_normals",
          "brdf_render", "bake", "secondary_march")


def emit_breakdown(phase: str, run_step, step_ms: float) -> None:
    """Where one step's device time goes, by CUDA kernel and by the step's
    own ranges, and the share of the timed step the card sat idle.
    Informational: not a pass/fail."""
    import torch
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run_step()
            torch.cuda.synchronize()
        events = prof.key_averages()
        # the step's ranges also appear on the device timeline as spans:
        # they are not kernels
        kern = [e for e in events if e.device_type == DeviceType.CUDA
                and e.key not in RANGES]
        busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
        host = [e for e in events if e.device_type == DeviceType.CPU
                and e.key not in RANGES]
        # device time of the kernels launched inside each range (the
        # backward runs on autograd's own thread, outside the ranges: it is
        # the busy time the forward and adam leave)
        ranges = {e.key: {"device_ms": e.device_time_total / 1e3,
                          "host_ms": e.cpu_time_total / 1e3}
                  for e in events
                  if e.key in RANGES and e.device_type == DeviceType.CPU}
        emit({"phase": phase, "device_busy_ms": busy_ms,
              "idle_share": 1.0 - busy_ms / step_ms, "ranges": ranges,
              "top_kernels": [
                  {"name": e.key[:90], "ms": e.self_device_time_total / 1e3,
                   "calls": e.count}
                  for e in sorted(kern, key=lambda e: -e.self_device_time_total)
                  [:20]],
              "top_host_ops": [
                  {"name": e.key[:60], "self_ms": e.self_cpu_time_total / 1e3,
                   "calls": e.count}
                  for e in sorted(host, key=lambda e: -e.self_cpu_time_total)
                  [:15]]})
    except Exception as exc:  # noqa: BLE001  diagnostic only
        emit({"phase": phase, "measured": False, "error": repr(exc)})


def masked_field(fcfg, reso, seed, device):
    """The blob field and the scene update_alpha_mask makes for it at the
    field's own grid, as train/loop.py does when relighting starts (the
    AABB is not shrunk: shrink is not ported yet)."""
    from tensoir_tpu_torch.models.lifecycle import update_alpha_mask
    params, scene = field(fcfg, reso, seed, device)
    scene, _ = update_alpha_mask(fcfg, params, scene,
                                 tuple(min(r, 256) for r in reso))
    return params, scene


def _bake_agreement(cfg, b_gpu, b_cpu):
    """Entries of two bf16 bakes that differ by more than one bf16 ulp,
    leaving out the nodes on the alpha mask's edge that one side folds to
    -1e4 while the other keeps a feature whose density is under 2e-4 (a
    resampled mask value of 0 on one side, a rounding residue on the other).
    Returns (entries over 1 ulp, entries 1 ulp apart, mask-edge nodes)."""
    import torch
    a, b = b_gpu.float(), b_cpu.float()
    big = torch.maximum(a.abs(), b.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    diff = (a - b).abs()
    fold = torch.where(a == -9984.0, b, a)
    edge = ((a == -9984.0) ^ (b == -9984.0)) & (
        torch.nn.functional.softplus(fold + cfg.density_shift) < 2e-4)
    over = (diff > ulp) & ~edge
    return int(over.sum()), int(((diff > 0) & (diff <= ulp)).sum()), int(
        edge.sum())


@contextlib.contextmanager
def _pair_choice(record=None, replay=None):
    """Record the secondary pass's choice of pairs for the app stage (the
    ``primary.compact_nonzero`` call each tile of ``compute_radiance``
    makes) into the list ``record``, or hand out the choices in ``replay``
    in their place."""
    from tensoir_tpu_torch.render import primary
    choose = primary.compact_nonzero
    replay = None if replay is None else list(replay)

    def wrapped(score, cap):
        if replay is not None:
            idx, ok = replay.pop(0)
            check(idx.shape == (cap,), "replayed pair choice of another cap")
            return idx.to(score.device), ok.to(score.device)
        idx, ok = choose(score, cap)
        if record is not None:
            record.append((idx.cpu(), ok.cpu()))
        return idx, ok

    primary.compact_nonzero = wrapped
    try:
        yield
    finally:
        primary.compact_nonzero = choose
    check(not replay, "pair choices left over after the replayed step")


def _relight_step_on(dev, fcfg, cfg, params0, scene0, small, n_samples,
                     n_rays, record=None, replay=None):
    """One deterministic relight step on ``dev`` from a copy of the CPU
    field: (loss, n_acc_masked, parameters, gradients, bf16 bake), all on
    the CPU. ``record`` / ``replay`` as in _pair_choice."""
    import copy
    from tensoir_tpu_torch.models.field import bake_packed_sigma_grid
    from tensoir_tpu_torch.train.optim import flatten
    # a copy each: the step updates its parameters in place
    params = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                  if isinstance(v, dict) else v.to(dev))
              for k, v in copy.deepcopy(params0).items()}
    scene = {k: v.to(dev) for k, v in scene0.items()}
    baked = bake_packed_sigma_grid(fcfg, params, scene).cpu()
    opt, step_fn = make_step(fcfg, cfg, n_samples, True, dev, relight=True,
                             **small)
    state = opt.init(params)
    with _pair_choice(record, replay):
        params, state, m = step_fn(params, state, scene,
                                   batch_of(n_rays, dev), None,
                                   cfg.update_AlphaMask_list[0])
    # Adam's first moment after one step is (1 - b1) * grad
    grads = {k: v.cpu() / 0.1 for k, v in state["mu"].items()}
    return (float(m["total_loss"]), float(m["n_acc_masked"]),
            {k: v.detach().cpu() for k, v in flatten(params).items()},
            grads, baked)


def _grad_rel_err(g_gpu, g_cpu) -> dict:
    """Per parameter: |g_gpu - g_cpu| / |g_cpu| in the L2 norm, over every
    element (0 where both are zero)."""
    out = {}
    for k, g in g_cpu.items():
        diff = float((g_gpu[k] - g).norm())
        out[k] = diff / float(g.norm()) if diff else 0.0
    return out


def _pairs_swapped(rec_a, rec_b) -> int:
    """Pairs that reach the app stage in one record of pair choices and not
    in the other, summed over tiles."""
    check(len(rec_a) == len(rec_b), "records of different tile counts")
    n = 0
    for (ia, oa), (ib, ob) in zip(rec_a, rec_b):
        n += len(set(ia[oa].tolist()) ^ set(ib[ob].tolist()))
    return n


def phase_relight_step_parity():
    """One deterministic relight step, card (kernels) vs CPU (plain
    versions), from the same masked field made on the CPU, in three
    variants: the per-tile pair cap the step runs with (``tile // 4``), the
    CPU step given the card's choice of pairs under that cap, and the cap
    lifted (``app_pair_frac`` 1).

    Tolerances:
    - loss 1e-4 relative with the same pairs (cap lifted, or the card's
      choice replayed). The loss passes through top-k cut-offs, weight
      thresholds and the clip of colour to 1 that a rounding can flip, and
      through derived normals, each a normalised gradient;
    - gradients, for every parameter over all its elements, 1e-3 relative
      in the L2 norm with the same pairs: ten times the loss's tolerance,
      because a flipped threshold or clip removes or adds the terms of one
      sample or ray in full, which moves the gradient of the few elements
      it reaches by more than the loss. Gradients are held, not the
      parameters after the step: Adam's first step moves each element by
      about lr * sign(grad), so an element whose gradient is rounding noise
      moves by 2 lr on a sign flip (the largest such move is reported);
    - loss under the cap, each device choosing its own pairs: 1e-4 relative
      plus what the pairs chosen differently can move. The cap keeps the
      first pairs by index whose march passes the weight threshold, so a
      rounding at the threshold moves the choice by whole pairs. A pair
      only adds indirect light to one relit ray, whose loss term per
      channel lies in [0, 0.25] (a colour in [0, 1] against 0.5), so each
      pair chosen on one side only moves the loss by at most
      rgb_brdf_weight * 0.25 / n_computed, n_computed the rays the
      brdf loss averages over. Its gradients are reported, not held: the
      replayed variant holds them;
    - the bf16 bake 1 bf16 ulp, as _bake_agreement says."""
    from tensoir_tpu_torch import config as C
    loss_tol, grad_tol = 1e-4, 1e-3
    cfg, _, _ = slice_sizes()
    fcfg = C.field_config_from(cfg, NEAR_FAR)
    fcfg = dataclasses.replace(fcfg, envmap_h=8, envmap_w=16)
    reso, n_samples, n_rays, ray_cap = (48, 48, 48), 128, 256, 64
    params0, scene0 = masked_field(fcfg, reso, seed=2, device="cpu")
    capped = dict(relight_ray_cap=ray_cap, secondary_tile=4096, march_cap=64)
    lifted = dict(capped, app_pair_frac=1.0)

    def run(dev, small, **kw):
        return _relight_step_on(dev, fcfg, cfg, params0, scene0, small,
                                n_samples, n_rays, **kw)

    rec_gpu, rec_cpu = [], []
    runs = {"lifted": (run("cuda", lifted), run("cpu", lifted)),
            "capped": (run("cuda", capped, record=rec_gpu),
                       run("cpu", capped, record=rec_cpu))}
    runs["replayed"] = (runs["capped"][0],
                        run("cpu", capped, replay=rec_gpu))
    res, fails = {}, []
    for name, (gpu, cpu) in runs.items():
        (l_gpu, n_acc, p_gpu, g_gpu, _), (l_cpu, _, p_cpu, g_cpu, _) = gpu, cpu
        rel = abs(l_gpu - l_cpu) / abs(l_cpu)
        g_rel = _grad_rel_err(g_gpu, g_cpu)
        r = {"loss_cuda": l_gpu, "loss_cpu": l_cpu, "loss_rel_err": rel,
             "grad_rel_err_max": max(g_rel.values()),
             "worst_grad": max(g_rel, key=g_rel.get),
             "param_max_abs_err": max(float((p_gpu[k] - p_cpu[k]).abs()
                                            .max()) for k in p_cpu)}
        if name == "capped":
            swapped = _pairs_swapped(rec_gpu, rec_cpu)
            n_comp = min(ray_cap, n_acc) + n_rays - n_acc
            tol = loss_tol + (cfg.rgb_brdf_weight * 0.25 * swapped / n_comp
                              / abs(l_cpu))
            r.update(pairs_swapped=swapped, n_computed=n_comp,
                     loss_rel_tol=tol)
            if not (math.isfinite(l_gpu) and rel <= tol):
                fails.append(f"capped loss {l_gpu} vs {l_cpu}: {rel} > {tol}")
        else:
            r["grad_rel_err"] = g_rel
            if not (math.isfinite(l_gpu) and rel <= loss_tol):
                fails.append(f"{name} loss {l_gpu} vs {l_cpu}: {rel}")
            over = {k: v for k, v in g_rel.items() if v > grad_tol}
            if over:
                fails.append(f"{name} gradients over {grad_tol}: {over}")
        res[name] = r
    k_gpu, k_cpu = runs["lifted"][0][4], runs["lifted"][1][4]
    bake_over, bake_ulp, bake_edge = _bake_agreement(fcfg, k_gpu, k_cpu)
    if bake_over:
        fails.append(f"bake: {bake_over} entries over 1 bf16 ulp")
    emit({"phase": "relight_step_parity", "ok": not fails, "fails": fails,
          "variants": res,
          "n_params": sum(v.numel() for v in runs["lifted"][1][2].values()),
          "bake_entries": k_cpu.numel(), "bake_over_1ulp": bake_over,
          "bake_1ulp_apart": bake_ulp, "bake_mask_edge": bake_edge,
          "tol": {"loss_rel": loss_tol, "grad_rel_l2": grad_tol,
                  "bake_ulp": 1}})
    check(not fails, "relight_step_parity: " + "; ".join(fails))


def phase_relight_train():
    """The relight step at full width; returns the launch counts of its 10
    timed steps."""
    import torch
    from tensoir_tpu_torch import config as C
    from tensoir_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from tensoir_tpu_torch.render import secondary
    cfg, _, _ = slice_sizes()
    n_vox, reso, n_samples = relight_sizes(cfg)
    fcfg = C.field_config_from(cfg, NEAR_FAR)
    t0 = time.perf_counter()
    params, scene = masked_field(fcfg, reso, seed=0, device="cuda")
    torch.cuda.synchronize()
    mask_s = time.perf_counter() - t0
    opt, step_fn = make_step(fcfg, cfg, n_samples, False, "cuda",
                             relight=True)
    state = opt.init(params)
    batch = batch_of(BATCH, "cuda")
    key = torch.Generator(device="cuda").manual_seed(1)
    it = cfg.update_AlphaMask_list[0]
    for _ in range(2):
        params, state, m = step_fn(params, state, scene, batch, key, it)
        it += 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mets = []
    reset_launch_counts()
    secondary.reset_march_counts()
    t0 = time.perf_counter()
    for _ in range(10):
        params, state, m = step_fn(params, state, scene, batch, key, it)
        mets.append(m)
        it += 1
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 10 * 1e3
    launches = dict(LAUNCHES)
    marched = dict(secondary.MARCHED)
    losses = [float(x["total_loss"]) for x in mets]
    pairs_per_step = cfg.relight_ray_cap * cfg.envmap_h * cfg.envmap_w
    res = {"phase": "relight_train", "n_voxels": n_vox, "grid": list(reso),
           "n_samples": n_samples, "batch": BATCH,
           "march_cap": cfg.march_cap_primary,
           "relight_ray_cap": cfg.relight_ray_cap,
           "light_dirs": cfg.envmap_h * cfg.envmap_w,
           "second_n_sample": cfg.second_nSample,
           "secondary_tile": cfg.secondary_tile,
           "step_ms": step_ms, "alpha_mask_s": mask_s,
           "loss_first": losses[0], "loss_last": losses[-1],
           "losses": losses,
           "loss_rgb_brdf": [float(x["loss_rgb_brdf"]) for x in mets],
           "n_acc_masked": float(mets[-1]["n_acc_masked"]),
           "march_overflow_frac": float(mets[-1]["march_overflow_frac"]),
           "secondary_pairs_marched": marched["pairs"],
           "secondary_tiles_marched": marched["tiles"],
           "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "psnr_last": float(mets[-1]["psnr"])}
    ok = (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
          and all(v > 0 for v in launches.values())
          and marched["pairs"] == 10 * pairs_per_step)
    res["ok"] = ok
    emit(res)
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"relight loss did not fall: {losses}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel was not launched on the relight path: {launches}")
    check(marched["pairs"] == 10 * pairs_per_step,
          f"secondary marched {marched['pairs']} pairs in 10 steps, not "
          f"10 x {pairs_per_step}")
    emit_breakdown("relight_breakdown",
                   lambda: step_fn(params, state, scene, batch, key, it),
                   step_ms)
    return launches


# each path's own shape for each kernel: the lookup that moves the most
# bytes per launch on that path
PATH_CASES = {
    "train": {"row_gather": ("slice_density", "row_gather"),
              "row_gather_bf16": ("bf16", "train_alpha_mask"),
              "row_scatter_add": ("slice_density", "row_scatter_add")},
    "relight_train": {"row_gather": ("relight_density", "row_gather"),
                      "row_gather_bf16": ("bf16", "baked_grid"),
                      "row_scatter_add": ("relight_density",
                                          "row_scatter_add")},
}


def kernel_summary(cases, launches) -> list:
    """One entry per kernel: the relight path's launches beside its own
    shape and times, and each path's under ``by_path``."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    summary = []
    for name, (src, replaces) in KERNEL_SOURCES.items():
        by_path = {}
        for path, picks in PATH_CASES.items():
            group, sub = picks[name]
            c = cases[group][sub]
            # a bf16 case holds its own shape, an f32 one its group's
            shape = c if group == "bf16" else cases[group]
            by_path[path] = {"launches": launches[path][name],
                             "shape": {k: shape[k] for k in ("R", "C", "N")},
                             **{k: c[k] for k in keys}}
        main_path = by_path["relight_train"]
        summary.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, **main_path,
                        "by_path": by_path})
    return summary


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
        phase_relight_step_parity()
        launches = {"train": phase_train(),
                    "relight_train": phase_relight_train()}
    except SmokeFailure as exc:
        emit({"ok": False, "failure": str(exc)})
        return 1
    emit({"kernels": kernel_summary(cases, launches)})
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
