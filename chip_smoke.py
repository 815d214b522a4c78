#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (tensoir_tpu_torch) on one card.

    python3 chip_smoke.py            # every phase, as below
    python3 chip_smoke.py --steps    # build, train, relight_train and
                                     # bench_train only (for timing two
                                     # trees against each other); it ends
                                     # after them without the summary or
                                     # the last line

Phases, one JSON line each, in this order:
  build        compile every CUDA kernel of the port from its source (nvcc,
               sm_90a), one nvcc per source, all at once
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
  bench_step_parity
               one deterministic step of bench.py's configuration at its CPU
               sizes (grid 48, batch 256, 4x8 directions, tile 1024, window
               12/4, app bake 32) with the sigma bake cut to 32, on the card
               and on the CPU: as relight_step_parity (the pair-choice
               replay covers the hemisphere compaction too), both bf16
               bakes, the coarse occupancy, and the window march's indices
               from the same tables
  train        the radiance-phase training step of
               configs/single_light/armadillo.txt at full width (the grid
               and march length the config gives at iteration 0, batch
               4096) on a solid-blob scene: 2 warm-up steps, then 10 timed
               steps with the launch counts zeroed just before them (and
               counted by shape: launches_by_shape); the second warm-up
               step records the index stream of each kernel shape; then
               breakdown, one profiled step
  relight_train
               the relight-phase step of the same config at full width (the
               grid of the first alpha-mask update, 158^3, 547 samples,
               march cap 192, 1024 relit rays, 16x32 stratified light
               directions, 96 baked secondary samples in tiles of 16384) on
               the blob masked by update_alpha_mask: 2 warm-up steps (the
               second records the index streams), then 10 timed steps with
               the counts zeroed just before them; then relight_breakdown,
               one profiled step
  bench_train  bench.py's fast-knob relight step at full width (grid 200,
               700 samples, march cap 192, 4096 relit rays x 16x32
               directions, 96 secondary samples, window 48/16 over the
               coarse occupancy (prepass 8, dilate 3), compaction 0.5625
               into 36 tiles of 32768, sigma bake 128, app bake 64, caps
               12 and 0.4375) on the blob masked at 128^3: 2 warm-up steps
               (the second records the index streams), 10 timed steps with
               the counts zeroed just before them (step_ms, rays_per_s as
               bench.py counts them); then bench_breakdown, one profiled
               step, and bench_secondary_stats, one step with the
               secondary statistics on
  lifecycle_parity
               the first alpha-mask event of the armadillo schedule on a
               full-width blob field at 128^3, on the card and on the CPU:
               update_alpha_mask, shrink, upsample to the next voxel count,
               filter_rays_mask of the demo's 393,216 rays; box, AABB,
               masks, grids and keep masks equal, factors allclose
  train_run    a whole training run: the port's reconstruction of
               configs/single_light/armadillo.txt at full width from random
               weights, with its voxel schedule (128^3 to 300^3 over four
               upsamples) and its six alpha-mask updates on compressed
               iterations (TRAIN_RUN_RADIANCE radiance steps, then events 10
               and 20 apart), on the demo's data (24 views of 128x128 of
               the sphere over a disc), with one periodic checkpoint; per
               phase and grid the steps' median ms and launches, each
               event's seconds; then ckpt_final.npz is reloaded and must
               render the same as the run's result
  eval_parity  one eval chunk (every ray relit under 512 fixed directions,
               96 secondary samples) of train_run's reloaded field at full
               width, 256 rays, on the card and on the CPU: every map
  eval         evaluation_iter(test_all=True, compute_extra_metrics=True)
               of train_run's reloaded ckpt_final on one EVAL_WH x EVAL_WH
               test view of the shadow scene, with its PNGs, as the CLI's
               final render_test runs it: seconds per view, chunks, tiles
               and K1/K2 launches per chunk (K2 must stay 0), peak memory,
               the metrics; then eval_breakdown, one profiled chunk
  cli_run      python -m tensoir_tpu_torch.train_tensoir on
               configs/single_light/armadillo.txt, in this process, on a
               rotated-lights scene written to a temporary directory (3
               views of 800x800 for training, 2 of 200x200 for test, PNG
               rows through all five filters, a 1024x2048 probe): the
               loaders, 200 radiance iterations, one alpha mask with the
               shrink, one upsample to 300^3, relight iterations with two
               evals, ckpt_final, the final render_test; then render-only
               from ckpt_final, whose metrics must equal the run's bit for
               bit. Its launches are the summary line's (MAIN_PATH)
  relight_parity
               one relight chunk of train_run's reloaded field at full
               width, 64 rays x 512 light samples of a 1024x2048 probe (two
               visibility tiles of 16384 pairs, 96 secondary samples), on
               the card and on the CPU from the same uniforms: the exact
               march and the fast route (the same bake): all eight outputs
  relight      python -m tensoir_tpu_torch.scripts.relight_importance on
               configs/relighting_test/armadillo.txt and train_run's
               ckpt_final, in this process, over a relighting test set it
               writes to a temporary directory (RELIGHT_VIEWS views of
               RELIGHT_WH x RELIGHT_WH, five 1024x2048 probes): seconds
               per view and of the G-buffer pass, chunks per view and
               light, tiles and K1/K2 launches per chunk (K2 must stay 0),
               peak memory, HDR decode seconds, PSNR/SSIM per light (a
               sanity number), the artifact tree; relight_fast_vis, one
               view again with --relight_fast_vis 1;
               relight_chunk_breakdown, one profiled chunk (the name
               relight_breakdown is relight_train's)
  material_edit
               python -m tensoir_tpu_torch.scripts.material_editing on one
               view of that scene, edited (--roughness_scale 0.5
               --albedo_tint 1,0.3,0.3) and not, on the same draws: the
               images must differ
  kernels      each kernel against its plain PyTorch version on the card:
               at the shapes the training steps give it on random indices
               (K1 on bf16 rows at the baked grids', the app bake's and the
               alpha masks')
               and at the Pallas probe's shapes; on the index streams the
               steps recorded (instep: with the streams' mean run of
               equal indices and distinct rows); and at the edge cases of
               every route (edge). Max abs error, kernel / plain / library
               ms, the bound (bytes moved at 3.35 TB/s) and, for bf16 rows,
               bound_sector_ms (every row read as whole 32-byte sectors);
               at the busiest shape of each kernel in the training run,
               the eval, the CLI run and the relight runs (the visibility
               march's density lookup, the fast route's baked grid), and
               at the eval's density and appearance lookups
Then the kernel summary line, the card's name and power limit, and the last
line {"ok": true, "device": ...}. Any failure exits non-zero without that
line; so does a machine without CUDA. Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
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
    """Mean ms of ``fn`` over ``reps`` eager calls (CUDA events), after
    ``warm`` calls. Where a call is shorter than its host dispatch this is
    the dispatch's time, not the device's."""
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


def graph_ms(fn, reps: int = 20, replays: int = 5, warm: int = 3) -> float:
    """Mean device ms of ``fn``: ``reps`` calls captured in one CUDA graph,
    replayed ``replays`` times between CUDA events, so that the host's
    dispatch does not count. ``fn`` must not synchronise with the host."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warm):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


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


def gather_check(table, idx) -> float:
    """K1 against its plain version, exactly; returns the max abs error."""
    import torch
    from tensoir_tpu_torch.kernels import rows
    got = rows.row_gather(table, idx)
    want = rows.row_gather_plain(table, idx)
    torch.cuda.synchronize()
    err = (float((got.float() - want.float()).abs().max())
           if got.numel() else 0.0)
    check(got.shape == want.shape and torch.equal(got, want),
          f"row_gather {table.dtype} R={table.shape[0]} C={table.shape[1]} "
          f"N={idx.numel()} {idx.dtype}: max abs err {err}")
    return err


def scatter_check(idx, val, R: int) -> tuple:
    """K2 against its plain version within the reordering of f32 sums;
    returns (max abs error, tolerance)."""
    import torch
    from tensoir_tpu_torch.kernels import rows
    got = rows.row_scatter_add(idx, val, R)
    want = rows.row_scatter_add_plain(idx, val, R)
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    # atomics add in another order than index_add_: bound the difference of
    # two orders of the same f32 sum of at most n_max terms
    n_max = (int(torch.bincount(idx.long(), minlength=R).max())
             if idx.numel() else 0)
    tol = 2.0 * n_max * F32_EPS * (float(val.abs().max()) if val.numel()
                                   else 0.0)
    check(got.shape == want.shape and err <= tol,
          f"row_scatter_add R={R} C={val.shape[1]} N={idx.numel()} "
          f"{idx.dtype}: max abs err {err} > {tol}")
    return err, tol


def gather_case(table, idx) -> dict:
    """K1 at one table and index stream: error, times and bounds."""
    import torch
    from tensoir_tpu_torch.kernels import rows
    err = gather_check(table, idx)
    row_bytes = table.shape[1] * table.element_size()
    out = {"max_abs_err": err, "tol": 0.0,
           "ms": graph_ms(lambda: rows.row_gather(table, idx)),
           "eager_ms": time_ms(lambda: rows.row_gather(table, idx)),
           "plain_ms": time_ms(lambda: rows.row_gather_plain(table, idx)),
           "library_ms": graph_ms(lambda: torch.index_select(table, 0, idx)),
           "bound_ms": gather_bound_ms(idx, row_bytes), "bound_by": "bytes"}
    if table.dtype == torch.bfloat16:
        out["bound_sector_ms"] = gather_sector_bound_ms(idx, row_bytes)
    return out


def scatter_case(idx, val, R: int) -> dict:
    """K2 at one index stream and values: error, times and bound."""
    import torch
    from tensoir_tpu_torch.kernels import rows
    err, tol = scatter_check(idx, val, R)
    N, C = val.shape
    # the scatter-add reads the index and the values and writes every
    # output row
    bytes_ms = (4 * N + 4 * N * C + 4 * R * C) / HBM_BYTES_PER_S * 1e3
    ops_ms = N * C / F32_OPS_PER_S * 1e3
    acc = torch.empty((R, C), device=val.device)

    def lib_scatter():
        acc.zero_()
        acc.index_add_(0, idx, val)

    return {"max_abs_err": err, "tol": tol,
            "ms": graph_ms(lambda: rows.row_scatter_add(idx, val, R)),
            "eager_ms": time_ms(lambda: rows.row_scatter_add(idx, val, R)),
            "plain_ms": time_ms(
                lambda: rows.row_scatter_add_plain(idx, val, R)),
            "library_ms": graph_ms(lib_scatter),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def kernel_case(R: int, C: int, N: int, seed: int) -> dict:
    """Both kernels against their plain versions at one shape, on random
    indices."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = torch.randn((R, C), device=dev, generator=gen)
    idx = torch.randint(0, R, (N,), device=dev, generator=gen,
                        dtype=torch.int32)
    val = torch.randn((N, C), device=dev, generator=gen)
    return {"R": R, "C": C, "N": N,
            "row_gather": gather_case(table, idx),
            "row_scatter_add": scatter_case(idx, val, R)}


def gather_bound_ms(idx, row_bytes: int) -> float:
    """The least time of a row gather: the index read, each output row
    written, and each distinct table row it needs read once, at the HBM
    rate."""
    import torch
    n, distinct = idx.numel(), torch.unique(idx).numel()
    return ((4 + row_bytes) * n + row_bytes * distinct) / HBM_BYTES_PER_S * 1e3


def gather_sector_bound_ms(idx, row_bytes: int) -> float:
    """The same bound with every gathered row read as whole 32-byte sectors
    from device memory, as a table larger than the 50 MB L2 costs on random
    indices: N * (4 + row + sectors) bytes."""
    sectors = -(-row_bytes // 32) * 32
    return idx.numel() * (4 + row_bytes + sectors) / HBM_BYTES_PER_S * 1e3


def bf16_gather_case(R: int, N: int, seed: int, C: int = 8) -> dict:
    """K1 on bf16 rows (8 corners, 16 B, or the app bake's 8 x 27, 432 B)
    against its plain version, exactly, on random indices."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = torch.randn((R, C), device=dev, generator=gen).to(torch.bfloat16)
    idx = torch.randint(0, R, (N,), device=dev, generator=gen,
                        dtype=torch.int32)
    return {"R": R, "C": C, "N": N, **gather_case(table, idx),
            "table_mb": R * C * 2 / 1e6}


def run_stats(idx) -> dict:
    """Mean length of the runs of equal consecutive indices, and the number
    of distinct rows, of one index stream."""
    import torch
    n = idx.numel()
    runs = 1 + int((idx[1:] != idx[:-1]).sum()) if n else 0
    return {"mean_run": n / runs if runs else 0.0,
            "distinct": torch.unique(idx).numel()}


def instep_cases(streams) -> list:
    """Each kernel on the index streams one training step fed it (recorded
    by ``kernel_calls``), on random tables and values of the step's shapes:
    K1 exactly, K2 within its tolerance."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20)
    out = []
    for (path, name, R, C, N), idx in sorted(streams.items()):
        case = {"path": path, "kernel": name, "R": R, "C": C, "N": N,
                **run_stats(idx)}
        if name == "row_scatter_add":
            val = torch.randn((N, C), device=dev, generator=gen)
            case.update(scatter_case(idx, val, R))
        else:
            dtype = (torch.bfloat16 if name == "row_gather_bf16"
                     else torch.float32)
            table = torch.randn((R, C), device=dev, generator=gen).to(dtype)
            case.update(gather_case(table, idx))
        out.append(case)
    return out


EDGE_N = (0, 1, 31, 257, 5000)
EDGE_PATTERNS = ("runs", "chunk", "long", "ends")


def index_pattern(kind: str, R: int, N: int, rng) -> np.ndarray:
    """Index streams that stress the kernels' edges: random; runs of equal
    indices of lengths 1-40 (``runs``); random with one index through a
    whole 256-entry chunk (``chunk``); one index throughout, runs longer
    than a chunk (``long``); only the first and last row (``ends``)."""
    if kind == "random":
        return rng.integers(0, R, size=N)
    if kind == "runs":
        lengths = rng.integers(1, 41, size=N)
        return np.repeat(rng.integers(0, R, size=N), lengths)[:N]
    if kind == "chunk":
        idx = rng.integers(0, R, size=N)
        idx[256:512] = rng.integers(0, R)
        return idx
    if kind == "long":
        return np.full(N, rng.integers(0, R))
    if kind == "ends":
        return rng.choice(np.array([0, R - 1]), size=N)
    raise ValueError(kind)


def edge_cases() -> dict:
    """K1 (f32 and bf16 rows) and K2 against their plain versions at the
    widths and lengths each route's edges meet: C in {3, 4, 8, 16, 64, 192}
    f32 and {3, 8, 16, 32, 216} bf16 (scalar, narrow and wide routes; 216
    is the app bake's row), int32 and
    int64, N in EDGE_N on random indices, the clustered patterns at N 5000,
    and tables and values one element off 16-byte alignment (scalar route).
    K1 exactly, K2 within its tolerance; fails on the first disagreement."""
    import torch
    dev = torch.device("cuda")
    rng = np.random.default_rng(30)
    R = 97
    n_cases, worst = 0, 0.0

    def tensor(shape, dtype, misaligned):
        n = int(np.prod(shape))
        flat = torch.as_tensor(rng.normal(size=n + 1).astype(np.float32),
                               device=dev).to(dtype)
        return (flat[1:] if misaligned else flat[:n]).view(*shape)

    plan = [(kind, n, False) for n in EDGE_N for kind in ("random",)]
    plan += [(kind, 5000, False) for kind in EDGE_PATTERNS]
    plan += [("random", 5000, True), ("runs", 5000, True)]
    for dtype, widths in ((torch.float32, (3, 4, 8, 16, 64, 192)),
                          (torch.bfloat16, (3, 8, 16, 32, 216))):
        for C in widths:
            for kind, N, mis in plan:
                idx_np = index_pattern(kind, R, N, rng)
                table = tensor((R, C), dtype, mis)
                val = tensor((N, C), torch.float32, mis)
                for idt in (torch.int32, torch.int64):
                    idx = torch.as_tensor(idx_np, device=dev).to(idt)
                    gather_check(table, idx)
                    if dtype == torch.float32:
                        err, tol = scatter_check(idx, val, R)
                        if tol > 0:
                            worst = max(worst, err / tol)
                    n_cases += 1
    return {"cases": n_cases, "scatter_worst_err_over_tol": worst,
            "patterns": ["random", *EDGE_PATTERNS], "N": list(EDGE_N),
            "misaligned": ["random", "runs"]}


def slice_sizes():
    from tensoir_tpu_torch import config as C
    from tensoir_tpu_torch.models.lifecycle import cal_n_samples, n_to_reso
    cfg = C.load_config(str(CONFIG))
    reso = n_to_reso(cfg.N_voxel_init, AABB)
    n_samples = min(cfg.nSamples, cal_n_samples(reso, cfg.step_ratio))
    return cfg, reso, n_samples


def phase_kernels(streams, busiest):
    """Random-index cases at the steps' shapes, at the busiest shapes of
    the training run, the eval, the CLI run and the relight runs (from
    their launches by shape, ``busiest``: path -> counts) and the probe's,
    the index streams the steps recorded (``streams``) and the edge
    cases."""
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
        # bench.py's step (grid 200: 199^2 packed plane rows): the culled
        # primary march's density lookup and the appearance lookup
        "bench_density": (39601, sigma_c, BATCH * 192),
        "bench_app": (39601, app_c, BATCH * 32),
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
        "train_alpha_mask": bf16_gather_case(1, BATCH * n_samples, seed=12),
        # bench.py's step: the 127^3 sigma bake at one tile of 32768 pairs x
        # 48 window samples, the 127^3 alpha mask at the culled march, and
        # the 63^3 app bake (8 corners x 27 features) at the tile's 14336
        # kept pairs x 12 samples (the wide-row route)
        "bench_sigma_bake": bf16_gather_case(127 ** 3, 32768 * 48, seed=13),
        "bench_alpha_mask": bf16_gather_case(127 ** 3, BATCH * 192, seed=14),
        "bench_app_bake": bf16_gather_case(63 ** 3, 14336 * 12, seed=15,
                                           C=8 * 27)}
    for i, path in enumerate(sorted(("train_run", "eval", "cli_run"))):
        out[path] = busiest_cases(busiest[path], seed=40 + 10 * i)
    # the relight runs' busiest shapes: the visibility march's density
    # lookup (K1-f32) and alpha mask (K1-bf16), and the fast route's baked
    # grid (K1-bf16)
    for i, path in enumerate(("relight", "relight_fast")):
        out[path] = busiest_cases(busiest[path], seed=80 + 10 * i)
    out["eval_lookups"] = eval_lookup_cases(busiest["eval"])
    out["instep"] = instep_cases(streams)
    out["edge"] = edge_cases()
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


@contextlib.contextmanager
def kernel_calls(path: str, counts: dict, streams=None):
    """Count the row kernels' launches by shape into ``counts`` while the
    block runs, keyed (path, kernel, R, C, N); with ``streams``, also keep
    each shape's first index stream there. Wraps the port's call sites: the
    module functions that ``gather_rows`` and its backward call, and the
    name ``models.field`` imported. Only calls that launch (N > 0) count."""
    import torch
    from tensoir_tpu_torch.kernels import rows
    from tensoir_tpu_torch.models import field as field_mod
    gather, scatter = rows.row_gather, rows.row_scatter_add

    def note(name, R, C, idx):
        if idx.numel() == 0:
            return
        key = (path, name, int(R), int(C), idx.numel())
        counts[key] = counts.get(key, 0) + 1
        if streams is not None and key not in streams:
            streams[key] = idx.detach().clone()

    def counted_gather(table, idx):
        note("row_gather_bf16" if table.dtype == torch.bfloat16
             else "row_gather", *table.shape, idx)
        return gather(table, idx)

    def counted_scatter(idx, val, num_rows):
        note("row_scatter_add", num_rows, val.shape[1], idx)
        return scatter(idx, val, num_rows)

    rows.row_gather = field_mod.row_gather = counted_gather
    rows.row_scatter_add = counted_scatter
    try:
        yield
    finally:
        rows.row_gather = field_mod.row_gather = gather
        rows.row_scatter_add = scatter


def by_shape(counts: dict, steps: int) -> list:
    """Launches per step at each shape, from ``kernel_calls`` counts."""
    return [{"kernel": name, "R": R, "C": C, "N": N,
             "launches_per_step": n / steps}
            for (_, name, R, C, N), n in sorted(counts.items())]


def phase_train(streams):
    """The radiance step at full width; records its index streams (second
    warm-up step) into ``streams``; returns (launch counts, launches by
    shape) of its 10 timed steps."""
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
    params, state, m = step_fn(params, state, scene, batch, key, it)
    with kernel_calls("train", {}, streams):
        params, state, m = step_fn(params, state, scene, batch, key, it + 1)
    it += 2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, shapes = [], {}
    reset_launch_counts()
    t0 = time.perf_counter()
    with kernel_calls("train", shapes):
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
           "launches": launches, "launches_by_shape": by_shape(shapes, 10),
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
    return launches, shapes


# the record_function ranges of the step (train/step.py, render/*.py)
RANGES = ("forward", "backward", "adam", "primary", "derived_normals",
          "brdf_render", "bake", "secondary_march", "visibility")


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
    """Record the secondary pass's choices of pairs (every
    ``primary.compact_nonzero`` call: the hemisphere compaction's, when it
    is on, then the app-stage pair cap's of each tile of
    ``compute_radiance``) into the list ``record``, or hand out the choices
    in ``replay`` in their place, in the same order."""
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


def _to(tree, dev):
    """A copy on ``dev`` of a dict of tensors and dicts of tensors."""
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev, copy=True)
            for k, v in tree.items()}


def _step_on(dev, params0, scene0, make, n_rays, step, bakes, record=None,
             replay=None):
    """One deterministic step on ``dev`` from a copy of the CPU field: (loss,
    n_acc_masked, parameters, gradients, the tables ``bakes(params, scene)``
    makes before the step), all on the CPU. ``make(dev)`` builds (optimizer,
    step function); ``record`` / ``replay`` as in _pair_choice."""
    from tensoir_tpu_torch.train.optim import flatten
    # a copy each: the step updates its parameters in place
    params, scene = _to(params0, dev), _to(scene0, dev)
    tables = [b.cpu() for b in bakes(params, scene)]
    opt, step_fn = make(dev)
    state = opt.init(params)
    with _pair_choice(record, replay):
        params, state, m = step_fn(params, state, scene,
                                   batch_of(n_rays, dev), None, step)
    # Adam's first moment after one step is (1 - b1) * grad
    grads = {k: v.cpu() / 0.1 for k, v in state["mu"].items()}
    return (float(m["total_loss"]), float(m["n_acc_masked"]),
            {k: v.detach().cpu() for k, v in flatten(params).items()},
            grads, tables)


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
    from tensoir_tpu_torch.models.field import bake_packed_sigma_grid
    loss_tol, grad_tol = 1e-4, 1e-3
    cfg, _, _ = slice_sizes()
    fcfg = C.field_config_from(cfg, NEAR_FAR)
    fcfg = dataclasses.replace(fcfg, envmap_h=8, envmap_w=16)
    reso, n_samples, n_rays, ray_cap = (48, 48, 48), 128, 256, 64
    params0, scene0 = masked_field(fcfg, reso, seed=2, device="cpu")
    capped = dict(relight_ray_cap=ray_cap, secondary_tile=4096, march_cap=64)
    lifted = dict(capped, app_pair_frac=1.0)

    def run(dev, small, **kw):
        return _step_on(
            dev, params0, scene0,
            lambda d: make_step(fcfg, cfg, n_samples, True, d, relight=True,
                                **small),
            n_rays, cfg.update_AlphaMask_list[0],
            lambda p, s: [bake_packed_sigma_grid(fcfg, p, s)], **kw)

    res, fails, runs = _capped_parity(run, capped, lifted, ray_cap, n_rays,
                                      cfg.rgb_brdf_weight, loss_tol, grad_tol)
    k_gpu, k_cpu = runs["lifted"][0][4][0], runs["lifted"][1][4][0]
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


def _capped_parity(run, capped, lifted, ray_cap, n_rays, brdf_weight,
                   loss_tol, grad_tol):
    """Run ``run(dev, knobs, record=, replay=)`` on the card and the CPU with
    the step's caps (``capped``), with the card's pair choice replayed on
    the CPU, and with the cap lifted (``lifted``); hold each variant as
    phase_relight_step_parity says. Returns (per-variant results, failures,
    the runs)."""
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
            tol = loss_tol + (brdf_weight * 0.25 * swapped / n_comp
                              / abs(l_cpu))
            r.update(pairs_swapped=swapped, n_computed=n_comp,
                     loss_rel_tol=tol, pair_choices=len(rec_gpu))
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
    return res, fails, runs


def phase_relight_train(streams):
    """The relight step at full width; records its index streams (second
    warm-up step) into ``streams``; returns (launch counts, launches by
    shape) of its 10 timed steps."""
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
    params, state, m = step_fn(params, state, scene, batch, key, it)
    with kernel_calls("relight_train", {}, streams):
        params, state, m = step_fn(params, state, scene, batch, key, it + 1)
    it += 2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mets, shapes = [], {}
    reset_launch_counts()
    secondary.reset_march_counts()
    t0 = time.perf_counter()
    with kernel_calls("relight_train", shapes):
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
           "launches": launches, "launches_by_shape": by_shape(shapes, 10),
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
    return launches, shapes


def bench_setup(full: bool = True):
    """bench.py's configuration: its FieldConfig, StepStatic fields and
    LossWeights, at full width (bench.py:48-149) or at its CPU sizes
    (bench.py:95-101), and the alpha mask's resolution (128, or 24)."""
    from tensoir_tpu_torch.models.field import FieldConfig
    from tensoir_tpu_torch.train.step import LossWeights
    if full:
        sizes = dict(B=4096, grid=200, n_samples=700, relight_cap=4096,
                     env=(16, 32), second_n=96, tile=32768, window=48,
                     window_back=16, app_bake=64, mask=128)
    else:
        sizes = dict(B=256, grid=48, n_samples=64, relight_cap=256,
                     env=(4, 8), second_n=16, tile=1024, window=12,
                     window_back=4, app_bake=32, mask=24)
    fcfg = FieldConfig(density_n_comp=(16, 16, 16), app_n_comp=(48, 48, 48),
                       app_dim=27, shading_mode="MLP_Fea",
                       normals_kind="derived_plus_predicted", light_kind="sg",
                       num_sgs=128, envmap_h=sizes["env"][0],
                       envmap_w=sizes["env"][1], feature_c=128,
                       step_ratio=0.5)
    st = dict(n_samples=sizes["n_samples"], is_relight=True, white_bg=True,
              app_cap=32, relight_ray_cap=sizes["relight_cap"],
              march_cap=192, march_select="scatter", second_march_cap=32,
              secondary_use_baked=True, secondary_bake_reso=128,
              second_window=sizes["window"],
              second_window_back=sizes["window_back"], second_prepass_n=8,
              coarse_dilate=3, secondary_compact_frac=0.5625,
              app_bake_reso=sizes["app_bake"], second_app_cap=12,
              app_pair_frac=0.4375, second_n_sample=sizes["second_n"],
              secondary_tile=sizes["tile"])
    w = LossWeights(ortho=0.0, l1=4e-5, tv_density=0.0, tv_app=0.0,
                    lr_factor=0.999971, n_iters=80000, relight_start=10000)
    return fcfg, st, w, sizes


def make_bench_step(fcfg, st, w, device, **overrides):
    """bench.py's optimizer and step on ``device``, with ``overrides`` of
    its StepStatic fields."""
    from tensoir_tpu_torch.train.optim import make_optimizer
    from tensoir_tpu_torch.train.step import StepStatic, make_train_step
    opt = make_optimizer(None, 0.02, 1e-3, 0.999971)
    return opt, make_train_step(fcfg, opt, StepStatic(**{**st, **overrides}),
                                w, device=device)


def bench_field(fcfg, sizes, seed, device):
    """bench.py's scene: the blob field at its grid, masked by
    update_alpha_mask at its mask resolution."""
    from tensoir_tpu_torch.models.lifecycle import update_alpha_mask
    params, scene = field(fcfg, (sizes["grid"],) * 3, seed, device)
    scene, _ = update_alpha_mask(fcfg, params, scene, (sizes["mask"],) * 3)
    return params, scene


def _window_agreement(fcfg, baked, coarse, sizes_list, seed: int):
    """The window march on the card and on the CPU from the same bf16 bake,
    coarse grid and pairs (points in the blob's shell, random directions),
    for each (n_sample, window, window_back) of ``sizes_list``. Returns
    (results, failures): the indices jj and the mask m must be equal, the
    density within 1e-5 relative and 1e-6 absolute (the same K1 rows and
    corner weights, summed over the 8 corners in another order)."""
    import torch
    from tensoir_tpu_torch.render import secondary
    rng = np.random.default_rng(seed)
    n = 65536
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    host = [torch.as_tensor(AABB),
            torch.as_tensor((u * rng.uniform(0.2, 0.9, (n, 1)))
                            .astype(np.float32)),
            torch.as_tensor(d.astype(np.float32))]
    out, fails = {}, []
    for n_sample, window, back in sizes_list:
        kw = dict(n_sample=n_sample, vis_near=0.05, vis_far=1.5,
                  window=window, prepass_n=8, window_back=back)
        got = {}
        for dev in ("cuda", "cpu"):
            aabb, o, dirs = (x.to(dev) for x in host)
            jj, m = secondary.window_indices(coarse.to(dev), baked.shape,
                                             aabb, o, dirs, **kw)
            _, sigma, _ = secondary._march_window(
                fcfg, baked.to(dev), coarse.to(dev), aabb, o, dirs, **kw)
            got[dev] = (jj.cpu(), m.cpu(), sigma.cpu())
        (jg, mg, sg), (jc, mc, sc) = got["cuda"], got["cpu"]
        key = f"S{n_sample}_w{window}_b{back}"
        err = float((sg - sc).abs().max())
        out[key] = {"jj_differ": int((jg != jc).sum()),
                    "m_differ": int((mg != mc).sum()),
                    "marched_share": float(mc.float().mean()),
                    "sigma_max_abs_err": err}
        if out[key]["jj_differ"] or out[key]["m_differ"]:
            fails.append(f"window {key}: indices differ {out[key]}")
        if not torch.allclose(sg, sc, rtol=1e-5, atol=1e-6):
            fails.append(f"window {key}: sigma max abs err {err}")
    return out, fails


def phase_bench_step_parity():
    """One deterministic step of bench.py's configuration at its CPU sizes,
    with the sigma bake cut to 32 nodes per axis (below the grid of 48, so
    the factor resize runs), card (kernels) against CPU (plain versions),
    from the same masked field made on the CPU: the variants and
    tolerances of phase_relight_step_parity. The pair-choice replay covers
    every ``primary.compact_nonzero`` call of the step: the hemisphere
    compaction's, then each tile's pair cap. Also held:
    - the sigma bake and the appearance bake, each within 1 bf16 ulp;
    - the coarse occupancy each device makes from its own bake: equal;
    - the window march from the same tables and pairs, on the parity's
      window (16 samples, 12/4) and bench.py's (96, 48/16): jj and m
      equal, the density as _window_agreement says."""
    import torch
    from tensoir_tpu_torch.models import field as F
    loss_tol, grad_tol = 1e-4, 1e-3
    fcfg, st, w, sizes = bench_setup(full=False)
    st = dict(st, secondary_bake_reso=32, deterministic=True)
    params0, scene0 = bench_field(fcfg, sizes, seed=3, device="cpu")
    n_rays = ray_cap = sizes["B"]

    def bakes(p, s):
        return [F.bake_packed_sigma_grid(fcfg, p, s, max_reso=32),
                F.bake_app_feature_grid(fcfg, p, max_reso=sizes["app_bake"])]

    def run(dev, knobs, **kw):
        return _step_on(dev, params0, scene0,
                        lambda d: make_bench_step(fcfg, st, w, d, **knobs),
                        n_rays, 0, bakes, **kw)

    res, fails, runs = _capped_parity(run, {}, dict(app_pair_frac=1.0),
                                      ray_cap, n_rays, w.rgb_brdf, loss_tol,
                                      grad_tol)
    (s_gpu, a_gpu), (s_cpu, a_cpu) = runs["lifted"][0][4], runs["lifted"][1][4]
    bake_over, bake_ulp, bake_edge = _bake_agreement(fcfg, s_gpu, s_cpu)
    if bake_over:
        fails.append(f"sigma bake: {bake_over} entries over 1 bf16 ulp")
    app_over, app_ulp, _ = _bake_agreement(fcfg, a_gpu, a_cpu)
    if app_over:
        fails.append(f"app bake: {app_over} entries over 1 bf16 ulp")
    c_gpu = F.bake_coarse_occupancy(s_gpu.cuda(), dilate=st["coarse_dilate"])
    c_cpu = F.bake_coarse_occupancy(s_cpu, dilate=st["coarse_dilate"])
    coarse_differ = int((c_gpu.cpu() != c_cpu).sum())
    if coarse_differ:
        fails.append(f"coarse occupancy: {coarse_differ} cells differ")
    window, wfails = _window_agreement(
        fcfg, s_cpu, c_cpu, [(sizes["second_n"], sizes["window"],
                              sizes["window_back"]), (96, 48, 16)], seed=4)
    fails += wfails
    emit({"phase": "bench_step_parity", "ok": not fails, "fails": fails,
          "variants": res, "sigma_bake_shape": list(s_cpu.shape),
          "sigma_bake_over_1ulp": bake_over, "sigma_bake_1ulp_apart": bake_ulp,
          "sigma_bake_mask_edge": bake_edge,
          "app_bake_shape": list(a_cpu.shape), "app_bake_over_1ulp": app_over,
          "app_bake_1ulp_apart": app_ulp,
          "coarse_cells": c_cpu.numel(), "coarse_occupied": int(c_cpu.sum()),
          "coarse_differ": coarse_differ, "window": window,
          "tol": {"loss_rel": loss_tol, "grad_rel_l2": grad_tol,
                  "bake_ulp": 1, "window": "equal"}})
    check(not fails, "bench_step_parity: " + "; ".join(fails))


def phase_bench_train(streams):
    """bench.py's step at full width; records its index streams (second
    warm-up step) into ``streams``; returns (launch counts, launches by
    shape) of its 10 timed steps. Then one profiled step
    (bench_breakdown), and one step with the secondary statistics on,
    outside the timed loop, as bench.py:281-295 takes them."""
    import torch
    from tensoir_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from tensoir_tpu_torch.models.field import check_march_contract
    from tensoir_tpu_torch.render import secondary
    fcfg, st, w, sizes = bench_setup(full=True)
    contract = check_march_contract(AABB, prepass_n=st["second_prepass_n"],
                                    dilate=st["coarse_dilate"])
    t0 = time.perf_counter()
    params, scene = bench_field(fcfg, sizes, seed=0, device="cuda")
    torch.cuda.synchronize()
    mask_s = time.perf_counter() - t0
    opt, step_fn = make_bench_step(fcfg, st, w, "cuda")
    state = opt.init(params)
    B = sizes["B"]
    batch = batch_of(B, "cuda")
    key = torch.Generator(device="cuda").manual_seed(1)
    params, state, m = step_fn(params, state, scene, batch, key, 0)
    with kernel_calls("bench_train", {}, streams):
        params, state, m = step_fn(params, state, scene, batch, key, 1)
    it = 2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mets, shapes = [], {}
    reset_launch_counts()
    secondary.reset_march_counts()
    t0 = time.perf_counter()
    with kernel_calls("bench_train", shapes):
        for _ in range(10):
            params, state, m = step_fn(params, state, scene, batch, key, it)
            mets.append(m)
            it += 1
        torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 10 * 1e3
    launches = dict(LAUNCHES)
    marched = dict(secondary.MARCHED)
    losses = [float(x["total_loss"]) for x in mets]
    n_acc = float(mets[-1]["n_acc_masked"])
    dirs = sizes["env"][0] * sizes["env"][1]
    # bench.py's count: the primary rays and the real visibility rays
    rays_per_step = B + min(int(n_acc), sizes["relight_cap"]) * dirs
    total = sizes["relight_cap"] * dirs
    cap = -(-int(total * st["secondary_compact_frac"]) // st["secondary_tile"]
            ) * st["secondary_tile"]
    res = {"phase": "bench_train", "grid": [sizes["grid"]] * 3,
           "n_samples": sizes["n_samples"], "batch": B,
           "march_cap": st["march_cap"],
           "relight_ray_cap": sizes["relight_cap"], "light_dirs": dirs,
           "second_n_sample": sizes["second_n"],
           "secondary_tile": st["secondary_tile"],
           "window": [st["second_window"], st["second_window_back"]],
           "bake_reso": st["secondary_bake_reso"],
           "app_bake_reso": st["app_bake_reso"],
           "march_contract_ratio": contract,
           "step_ms": step_ms, "rays_per_step": rays_per_step,
           "rays_per_s": rays_per_step / step_ms * 1e3,
           "alpha_mask_s": mask_s,
           "loss_first": losses[0], "loss_last": losses[-1],
           "losses": losses,
           "loss_rgb_brdf": [float(x["loss_rgb_brdf"]) for x in mets],
           "n_acc_masked": n_acc,
           "march_overflow_frac": float(mets[-1].get("march_overflow_frac",
                                                     0.0)),
           "secondary_pairs_marched": marched["pairs"],
           "secondary_tiles_marched": marched["tiles"],
           "secondary_rows_per_step": cap,
           "launches": launches, "launches_by_shape": by_shape(shapes, 10),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "psnr_last": float(mets[-1]["psnr"])}
    # the K1-bf16 shapes of the step: the app bake (L x 63^3 rows of 8 x 27
    # bf16) at pair cap x second_app_cap points per tile, and the 127^3
    # sigma bake at tile x window samples per tile
    app_cells = (min(sizes["grid"], st["app_bake_reso"]) - 1) ** 3
    sigma_cells = (min(sizes["grid"], st["secondary_bake_reso"]) - 1) ** 3
    pair_cap = int(st["secondary_tile"] * st["app_pair_frac"])
    bf16_at = {
        "app_bake": shapes.get(("bench_train", "row_gather_bf16", app_cells,
                                8 * fcfg.app_dim,
                                pair_cap * st["second_app_cap"]), 0),
        "sigma_bake": shapes.get(("bench_train", "row_gather_bf16",
                                  sigma_cells, 8,
                                  st["secondary_tile"] * st["second_window"]),
                                 0)}
    res["row_gather_bf16_at"] = bf16_at
    fails = []
    if not all(math.isfinite(x) for x in losses):
        fails.append(f"non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        fails.append(f"bench loss did not fall: {losses}")
    if not all(v > 0 for v in launches.values()):
        fails.append(f"a kernel was not launched on the bench path: "
                     f"{launches}")
    if marched != {"pairs": 10 * cap, "tiles": 10 * cap // st[
            "secondary_tile"]}:
        fails.append(f"secondary marched {marched} in 10 steps, not "
                     f"10 x {cap} rows")
    if not all(bf16_at.values()):
        fails.append(f"row_gather_bf16 not launched at each bake: {bf16_at}")
    res["ok"] = not fails
    emit(res)
    check(not fails, "bench_train: " + "; ".join(fails))
    emit_breakdown("bench_breakdown",
                   lambda: step_fn(params, state, scene, batch, key, it),
                   step_ms)
    _, stats_fn = make_bench_step(fcfg, st, w, "cuda", secondary_stats=True)
    _, _, ms = stats_fn(params, state, scene, batch, key, it + 1)
    sec = {k.replace("/", "_"): float(v) for k, v in ms.items()
           if k.startswith("sec/")}
    emit({"phase": "bench_secondary_stats", "ok": bool(sec), **sec})
    check(all(k in sec for k in ("sec_app_pair_overflow_frac",
                                 "sec_compact_overflow_frac",
                                 "sec_app_pair_occupancy")),
          f"bench secondary stats missing: {sorted(sec)}")
    return launches, shapes


def _timed(fn, *args, **kw):
    """(result, seconds) of ``fn``, with the card drained before and
    after."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def shadow_dataset():
    """The JAX demo's data (examples/train_synthetic_demo.py defaults): the
    sphere-over-disc scene, 24 views at 128x128, 393,216 rays."""
    from tensoir_tpu_torch.data.synthetic import SyntheticShadowDataset
    return SyntheticShadowDataset(split="train", n_views=24, img_wh=(128, 128))


def phase_lifecycle_parity():
    """The first alpha-mask event of the armadillo schedule on a full-width
    field (VM 16/48, app_dim 27, featureC 128, 128 SGs) at 128^3 with the
    blob of utils/bench_scene.py, on the card and on the CPU from the same
    CPU-made field: update_alpha_mask at 128^3, shrink to its box, upsample
    to the schedule's next voxel count on the shrunk box, and
    filter_rays_mask (256 samples per ray, chunks of 51,200) of the demo's
    393,216 rays. The box, the shrunk AABB, the three alpha volumes, the
    grids and the keep masks must be equal; the upsampled factors within
    1e-6 relative and 1e-6 absolute (the same align-corners lerps, which
    the card may contract into multiply-adds; an ulp of the blob's 8 is
    9.5e-7)."""
    import torch
    from tensoir_tpu_torch import config as C
    from tensoir_tpu_torch.models import lifecycle as LC
    from tensoir_tpu_torch.models.field import grid_size_of
    from tensoir_tpu_torch.train.optim import flatten
    cfg, reso, _ = slice_sizes()
    fcfg = C.field_config_from(cfg, NEAR_FAR)
    n_vox = relight_sizes(cfg)[0]
    params0, scene0 = field(fcfg, reso, seed=5, device="cpu")
    all_rays = shadow_dataset().all_rays
    got, secs = {}, {}
    for dev in ("cuda", "cpu"):
        params, scene = _to(params0, dev), _to(scene0, dev)
        s = {}
        (scene, box), s["alpha_mask"] = _timed(
            LC.update_alpha_mask, fcfg, params, scene,
            tuple(min(r, 256) for r in reso))
        (params, scene), s["shrink"] = _timed(LC.shrink, fcfg, params, scene,
                                              box)
        shrunk_grid = grid_size_of(params)
        new_reso = LC.n_to_reso(n_vox, scene["aabb"].cpu().numpy())
        params, s["upsample"] = _timed(LC.upsample, params, new_reso)
        keep, s["filter_rays_mask"] = _timed(LC.filter_rays_mask, fcfg,
                                             scene, all_rays)
        got[dev] = {"box": box, "shrunk_grid": shrunk_grid,
                    "grid": grid_size_of(params),
                    "scene": {k: v.cpu() for k, v in scene.items()},
                    "factors": {k: v.cpu() for k, v in
                                flatten(params).items()
                                if k.startswith(("density_", "app_"))},
                    "keep": keep}
        secs[dev] = s
    g, c = got["cuda"], got["cpu"]
    fails = []
    if not np.array_equal(g["box"], c["box"]):
        fails.append(f"box {g['box'].tolist()} vs {c['box'].tolist()}")
    for k in ("aabb", "alpha_volume", "alpha_volume_dilated",
              "alpha_volume_packed"):
        if not torch.equal(g["scene"][k], c["scene"][k]):
            fails.append(f"scene {k} differs")
    if (g["shrunk_grid"], g["grid"]) != (c["shrunk_grid"], c["grid"]):
        fails.append(f"grids {g['grid']} vs {c['grid']}")
    err = max(float((g["factors"][k] - v).abs().max())
              for k, v in c["factors"].items())
    if not all(torch.allclose(g["factors"][k], v, rtol=1e-6, atol=1e-6)
               for k, v in c["factors"].items()):
        fails.append(f"upsampled factors: max abs err {err}")
    keep_differ = int((g["keep"] != c["keep"]).sum())
    if keep_differ:
        fails.append(f"filter_rays_mask: {keep_differ} rays differ")
    full = AABB
    shrank = bool((c["box"][0] > full[0]).any() or (c["box"][1] < full[1]).any())
    if not shrank:
        fails.append("the mask's box did not shrink")
    emit({"phase": "lifecycle_parity", "ok": not fails, "fails": fails,
          "mask_grid": list(reso), "box": c["box"].tolist(),
          "aabb": c["scene"]["aabb"].tolist(),
          "alpha_occupied": int(c["scene"]["alpha_volume"].sum()),
          "shrunk_grid": list(c["shrunk_grid"]), "n_voxels": n_vox,
          "upsampled_grid": list(c["grid"]), "factor_max_abs_err": err,
          "rays": int(all_rays.shape[0]), "rays_kept": int(c["keep"].sum()),
          "keep_differ": keep_differ, "seconds": secs,
          "tol": {"factors": {"rtol": 1e-6, "atol": 1e-6},
                  "rest": "equal"}})
    check(not fails, "lifecycle_parity: " + "; ".join(fails))


# radiance iterations of train_run before its first alpha-mask event (the
# reference runs 10,000): enough that the mask keeps a box smaller than
# the scene's; then the events follow 10 and 20 iterations apart
TRAIN_RUN_RADIANCE = 250


def train_run_config():
    """configs/single_light/armadillo.txt through the port's load_config,
    with its voxel schedule (128^3 -> 300^3 over four upsamples) and its six
    alpha-mask updates; only the iterations are compressed: the upsamples
    20 apart and the mask updates 10 apart from TRAIN_RUN_RADIANCE, 20
    iterations after the last upsample, and one periodic checkpoint."""
    from tensoir_tpu_torch import config as C
    cfg = C.load_config(str(CONFIG))
    first = TRAIN_RUN_RADIANCE
    upsamp = tuple(first + 20 * i for i in range(len(cfg.upsamp_list)))
    masks = tuple(first + 10 * i
                  for i in range(len(cfg.update_AlphaMask_list)))
    n_iters = upsamp[-1] + 20
    return cfg.replace(n_iters=n_iters, upsamp_list=upsamp,
                       update_AlphaMask_list=masks, save_iters=n_iters - 10)


@contextlib.contextmanager
def _run_probe(loop_mod, log):
    """Time and count what ``loop_mod.reconstruction`` does, without a
    change to it: each step (CUDA events around it, K1/K2 launches, its
    phase, grid and sample count), each lifecycle event and checkpoint save
    (host clock, with the card drained before and after), and each rebuild
    (from make_optimizer to make_train_step, the Adam init between)."""
    import torch
    from tensoir_tpu_torch.kernels import LAUNCHES
    from tensoir_tpu_torch.models.field import grid_size_of
    lc = loop_mod.LC
    saved = {name: getattr(loop_mod, name) for name in
             ("make_train_step", "make_optimizer", "save_checkpoint")}
    saved_lc = {name: getattr(lc, name) for name in
                ("update_alpha_mask", "shrink", "upsample",
                 "filter_rays_bbox")}
    it = [-1]

    def event(name, fn):
        def run(*a, **kw):
            out, s = _timed(fn, *a, **kw)
            rec = {"it": it[0], "event": name, "s": s}
            if name == "update_alpha_mask":
                rec["mask_grid"] = list(out[0]["alpha_volume"].shape[::-1])
                rec["box"] = np.asarray(out[1]).tolist()
                rec["occupied"] = int(out[0]["alpha_volume"].sum())
            elif name == "shrink":
                rec["grid"] = list(grid_size_of(out[0]))
                rec["aabb"] = out[1]["aabb"].tolist()
            elif name == "upsample":
                rec["grid"] = list(grid_size_of(out))
            elif name == "filter_rays_bbox":
                rec["rays_kept"] = int(out.sum())
            elif name == "save_checkpoint":
                rec["file"] = Path(a[0]).name
            log["events"].append(rec)
            return out
        return run

    def make_optimizer(*a, **kw):
        torch.cuda.synchronize()
        log["rebuild_t0"] = time.perf_counter()
        return saved["make_optimizer"](*a, **kw)

    def make_train_step(fcfg, optimizer, st, w, **kw):
        step_fn = saved["make_train_step"](fcfg, optimizer, st, w, **kw)
        torch.cuda.synchronize()
        log["events"].append({"it": it[0], "event": "rebuild",
                              "s": time.perf_counter() - log["rebuild_t0"],
                              "relight": st.is_relight,
                              "n_samples": st.n_samples,
                              "relight_ray_cap": st.relight_ray_cap})
        phase = "relight" if st.is_relight else "radiance"

        def step(params, opt_state, scene, batch, key, i):
            it[0] = i
            before = dict(LAUNCHES)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            out = step_fn(params, opt_state, scene, batch, key, i)
            t1.record()
            log["steps"].append({
                "it": i, "phase": phase, "grid": tuple(grid_size_of(params)),
                "n_samples": st.n_samples, "events": (t0, t1),
                "launches": {k: LAUNCHES[k] - before[k] for k in LAUNCHES}})
            return out
        return step

    loop_mod.make_optimizer = make_optimizer
    loop_mod.make_train_step = make_train_step
    loop_mod.save_checkpoint = event("save_checkpoint",
                                     saved["save_checkpoint"])
    for name, fn in saved_lc.items():
        setattr(lc, name, event(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(loop_mod, name, fn)
        for name, fn in saved_lc.items():
            setattr(lc, name, fn)


def _segments(steps) -> list:
    """The run's steps grouped by phase and grid, in order: iterations,
    median and mean step ms (CUDA events around each step), and K1/K2
    launches per step."""
    out = []
    for s in steps:
        key = (s["phase"], s["grid"], s["n_samples"])
        if not out or out[-1]["key"] != key:
            out.append({"key": key, "its": [], "ms": [], "launches": {}})
        seg = out[-1]
        seg["its"].append(s["it"])
        seg["ms"].append(s["events"][0].elapsed_time(s["events"][1]))
        for k, v in s["launches"].items():
            seg["launches"][k] = seg["launches"].get(k, 0) + v
    return [{"phase": seg["key"][0], "grid": list(seg["key"][1]),
             "n_samples": seg["key"][2],
             "iterations": [seg["its"][0], seg["its"][-1]],
             "steps": len(seg["ms"]),
             "median_step_ms": float(np.median(seg["ms"])),
             "mean_step_ms": float(np.mean(seg["ms"])),
             "launches_per_step": {k: v / len(seg["ms"])
                                   for k, v in seg["launches"].items()}}
            for seg in out]


def phase_train_run(keep_dir: str):
    """The port's reconstruction on the card at full width (see
    train_run_config) on the demo's data (shadow_dataset), from random
    weights made from the config's seed, writing its log and checkpoints to
    a temporary directory. Then ckpt_final.npz is loaded back and its
    field, and a deterministic render of 4,096 of the data's rays from it,
    must equal the run's in-memory result bit for bit; the file is copied
    to ``keep_dir`` for the relight phases. Returns (launch counts,
    launches by shape) of the run, counted from 0 just before it, and the
    reloaded field as the eval phases take it (fcfg, params, scene,
    n_samples)."""
    import shutil
    import tempfile
    import torch
    from tensoir_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from tensoir_tpu_torch.models.field import grid_size_of
    from tensoir_tpu_torch.models.lifecycle import cal_n_samples, n_to_reso
    from tensoir_tpu_torch.render.primary import render_rays
    from tensoir_tpu_torch.train import loop
    from tensoir_tpu_torch.train.optim import flatten
    from tensoir_tpu_torch.utils.ckpt import load_checkpoint
    cfg = train_run_config()
    t0 = time.perf_counter()
    ds = shadow_dataset()
    data_s = time.perf_counter() - t0
    log = {"events": [], "steps": []}
    shapes = {}
    with tempfile.TemporaryDirectory() as log_dir:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        with _run_probe(loop, log), kernel_calls("train_run", shapes):
            result = loop.reconstruction(cfg, ds, log_dir=log_dir)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        files = sorted(os.listdir(log_dir))
        (fcfg, params, scene, extra), load_s = _timed(
            load_checkpoint, os.path.join(log_dir, "ckpt_final.npz"),
            device="cuda")
        shutil.copy(os.path.join(log_dir, "ckpt_final.npz"), keep_dir)
    segs = _segments(log["steps"])
    hist = result.metrics_history
    losses = [h["total_loss"] for h in hist]
    relit = [h["n_acc_masked"] for h in hist if "n_acc_masked" in h]
    masks = [e for e in log["events"] if e["event"] == "update_alpha_mask"]
    aabb = result.scene["aabb"].cpu().numpy()
    final_grid = grid_size_of(result.params)
    want_grid = n_to_reso(cfg.N_voxel_final, aabb)

    # the reloaded field, and what it renders, against the in-memory one
    loaded = flatten(params)
    differ = [k for k, v in flatten(result.params).items()
              if not torch.equal(v, loaded[k])]
    differ += [f"scene/{k}" for k, v in result.scene.items()
               if not torch.equal(v, scene[k])]
    rays = torch.as_tensor(ds.all_rays[::96][:4096], device="cuda")
    lidx = torch.zeros((rays.shape[0],), dtype=torch.int32, device="cuda")
    kw = dict(n_samples=result.n_samples, key=None, is_relight=False,
              white_bg=True, app_cap=cfg.app_cap_per_ray)
    with torch.no_grad():
        r_mem = render_rays(result.fcfg, result.params, result.scene, rays,
                            lidx, **kw)
        r_ck = render_rays(fcfg, params, scene, rays, lidx, **kw)
    differ += [f"render/{k}" for k in ("rgb_map", "depth_map", "acc_map")
               if not torch.equal(r_mem[k], r_ck[k])]

    by_event = {}
    for e in log["events"]:
        by_event.setdefault(e["event"], []).append(e["s"])
    res = {"phase": "train_run", "n_iters": cfg.n_iters,
           "upsamp_list": list(cfg.upsamp_list),
           "update_AlphaMask_list": list(cfg.update_AlphaMask_list),
           "save_iters": cfg.save_iters, "rays": int(ds.all_rays.shape[0]),
           "data_s": data_s, "wall_s": wall_s,
           "step_ms_total": sum(s["mean_step_ms"] * s["steps"]
                                for s in segs),
           "segments": segs, "events": log["events"],
           "event_s": {k: {"n": len(v), "total": sum(v), "max": max(v)}
                       for k, v in by_event.items()},
           "final_grid": list(final_grid), "final_n_samples":
           result.n_samples, "aabb": aabb.tolist(),
           "loss_first": losses[0], "loss_last": losses[-1],
           "n_acc_masked": relit, "launches": launches,
           "launches_by_shape": by_shape(shapes, cfg.n_iters),
           "log_files": files, "ckpt_load_s": load_s,
           "ckpt_iteration": extra["train_state"]["iteration"],
           "reload_differ": differ,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    fails = []
    if not masks or masks[0]["occupied"] == 0:
        fails.append("the first alpha mask is empty")
    elif not (np.asarray(masks[0]["box"][0]) > AABB[0]).any() and not (
            np.asarray(masks[0]["box"][1]) < AABB[1]).any():
        fails.append(f"the first mask's box did not shrink: {masks[0]}")
    if not any(r > 0 for r in relit):
        fails.append(f"no ray relit: n_acc_masked {relit}")
    if not all(math.isfinite(x) for x in losses):
        fails.append(f"non-finite loss {losses}")
    if tuple(final_grid) != tuple(want_grid):
        fails.append(f"final grid {final_grid}, not n_to_reso "
                     f"{want_grid}")
    if extra["train_state"]["iteration"] != cfg.n_iters:
        fails.append(f"ckpt_final iteration {extra['train_state']}")
    if differ:
        fails.append(f"the reloaded checkpoint differs: {differ}")
    if not all(v > 0 for v in launches.values()):
        fails.append(f"a kernel was not launched in the run: {launches}")
    # every event the schedule calls for, at its iteration: a probe that
    # stops seeing the loop fails here. Rebuilds: the first step (before
    # iteration 0), the shrink, and each upsample
    first_mask = cfg.update_AlphaMask_list[0]
    want_events = {
        "update_alpha_mask": list(cfg.update_AlphaMask_list),
        "shrink": [first_mask],
        "upsample": list(cfg.upsamp_list),
        "filter_rays_bbox": [-1, cfg.update_AlphaMask_list[1]],
        "rebuild": sorted([-1, first_mask, *cfg.upsamp_list]),
        "save_checkpoint": [cfg.save_iters, cfg.n_iters - 1]}
    for name, its in want_events.items():
        got_its = sorted(e["it"] for e in log["events"]
                         if e["event"] == name)
        if got_its != its:
            fails.append(f"{name} at iterations {got_its}, not {its}")
    res["ok"] = not fails
    emit(res)
    check(not fails, "train_run: " + "; ".join(fails))
    # the n_samples a render-only run of the CLI derives from the grid
    n_samples = min(cfg.nSamples, cal_n_samples(grid_size_of(params),
                                                cfg.step_ratio))
    check(n_samples == result.n_samples,
          f"n_samples {n_samples} of the reloaded grid, {result.n_samples} "
          f"in the run")
    return launches, shapes, (fcfg, params, scene, n_samples)


# the eval's view, cut from a TensoIR-Synthetic view's 800 x 800: one
# 800 x 800 view took 226.0 s on the card (PERF.md), 400 x 400 a quarter
EVAL_WH = 400
# rays of eval_parity (both devices render them, the CPU at full width)
EVAL_PARITY_RAYS = 256


def eval_dataset():
    """One test view of the demo's shadow scene at EVAL_WH x EVAL_WH."""
    from tensoir_tpu_torch.data.synthetic import SyntheticShadowDataset
    return SyntheticShadowDataset(split="test", n_views=1,
                                  img_wh=(EVAL_WH, EVAL_WH))


def eval_knobs(cfg) -> dict:
    """The eval knobs the CLI passes from the config."""
    return dict(chunk=cfg.batch_size_test, second_n_sample=cfg.second_nSample,
                secondary_tile=cfg.secondary_tile)


@contextlib.contextmanager
def _eval_probe(log: list):
    """Record each eval chunk the block renders: which chunk function
    (``main``, or ``gbuf`` for the rescale ratio's G-buffer chunks), its
    time (CUDA events), its K1/K2 launches and its secondary tiles. Wraps
    ``render.eval.make_eval_chunk_fn``, which ``evaluation_iter`` calls."""
    import torch
    from tensoir_tpu_torch.kernels import LAUNCHES
    from tensoir_tpu_torch.render import eval as E
    from tensoir_tpu_torch.render import secondary
    make = E.make_eval_chunk_fn

    def wrapped(cfg, **kw):
        fn, chunk = make(cfg, **kw)
        kind = "gbuf" if kw.get("relight_ray_cap") == 1 else "main"

        def run(params, scene, rays, light_idx):
            before = dict(LAUNCHES)
            tiles = secondary.MARCHED["tiles"]
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            out = fn(params, scene, rays, light_idx)
            t1.record()
            log.append({"kind": kind, "events": (t0, t1),
                        "tiles": secondary.MARCHED["tiles"] - tiles,
                        "launches": {k: LAUNCHES[k] - before[k]
                                     for k in LAUNCHES}})
            return out
        return run, chunk

    E.make_eval_chunk_fn = wrapped
    try:
        yield
    finally:
        E.make_eval_chunk_fn = make


def _chunk_stats(chunks) -> dict:
    """Per kind of chunk (eval ``main``, G-buffer ``gbuf``, ``relight``):
    count, median and total ms, secondary tiles and launches per chunk."""
    out = {}
    for kind in ("main", "gbuf", "relight"):
        mine = [c for c in chunks if c["kind"] == kind]
        if not mine:
            continue
        ms = [c["events"][0].elapsed_time(c["events"][1]) for c in mine]
        out[kind] = {
            "chunks": len(mine), "median_ms": float(np.median(ms)),
            "total_s": sum(ms) / 1e3,
            "tiles_per_chunk": sorted({c["tiles"] for c in mine}),
            "launches_per_chunk": {
                k: sum(c["launches"][k] for c in mine) / len(mine)
                for k in mine[0]["launches"]}}
    return out


def phase_eval_parity(trained):
    """One eval chunk of train_run's reloaded field at full width (the
    config's eval: 512 fixed light directions per relit ray, every ray
    relit, 96 secondary samples in tiles of 16384, march cap 256, app cap
    64) on the card and on the CPU from the same field: EVAL_PARITY_RAYS
    rays spread over the eval view, one chunk. Tolerance: each map within
    1e-4 absolute on all but 1 % of the rays; a rounding at a weight
    threshold, a top-k cut-off or the app stage's pair cap moves whole
    samples or pairs of the few rays it reaches."""
    import torch
    from tensoir_tpu_torch import config as C
    from tensoir_tpu_torch.render.eval import make_eval_chunk_fn
    fcfg, params, scene, n_samples = trained
    cfg = C.load_config(str(CONFIG))
    rays = eval_dataset().all_rays
    rays = rays[::rays.shape[0] // EVAL_PARITY_RAYS][:EVAL_PARITY_RAYS]
    n = rays.shape[0]
    fn, _ = make_eval_chunk_fn(fcfg, n_samples=n_samples,
                               **dict(eval_knobs(cfg), chunk=n))
    maps, secs = {}, {}
    for dev in ("cuda", "cpu"):
        p, sc = (params, scene) if dev == "cuda" else (_to(params, dev),
                                                       _to(scene, dev))
        out, secs[dev] = _timed(
            fn, p, sc, torch.as_tensor(rays, device=dev),
            torch.zeros((n,), dtype=torch.int32, device=dev))
        maps[dev] = {k: v.float().reshape(n, -1).cpu()
                     for k, v in out.items() if v.dim() >= 1}
    tol, frac = 1e-4, 0.01
    report, fails = {}, []
    for k, c in maps["cpu"].items():
        d = (maps["cuda"][k] - c).abs().amax(1)
        over = int((d > tol).sum())
        report[k] = {"max_abs_err": float(d.max()), "rays_over_tol": over}
        if over > frac * n:
            fails.append(f"{k}: {over} of {n} rays over {tol}")
    relit = int(maps["cpu"]["acc_mask"].sum())
    if not relit:
        fails.append("no ray of the chunk reaches the surface")
    emit({"phase": "eval_parity", "ok": not fails, "fails": fails,
          "rays": n, "surface_rays": relit, "n_samples": n_samples,
          "maps": report, "seconds": secs,
          "tol": {"abs": tol, "rays_over_frac": frac}})
    check(not fails, "eval_parity: " + "; ".join(fails))


def phase_eval(trained):
    """evaluation_iter(test_all=True, compute_extra_metrics=True) of
    train_run's reloaded ckpt_final on one EVAL_WH x EVAL_WH view of the
    shadow scene, with its artifacts written to a temporary directory, as
    the CLI's final render_test runs it: seconds per view, chunks, tiles
    and K1/K2 launches per chunk, peak memory, the metrics; then one
    profiled chunk (eval_breakdown: device-busy ms and idle share). K2 must
    not launch: no gradient of a table is asked for. Returns (launch
    counts, launches by shape, chunk statistics)."""
    import tempfile
    import torch
    from tensoir_tpu_torch import config as C
    from tensoir_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from tensoir_tpu_torch.render.eval import (evaluation_iter,
                                               make_eval_chunk_fn)
    fcfg, params, scene, n_samples = trained
    cfg = C.load_config(str(CONFIG))
    ds = eval_dataset()
    chunks, shapes = [], {}
    with tempfile.TemporaryDirectory() as out_dir:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        # the eval's own notes go to stderr: stdout holds the JSON lines
        with _eval_probe(chunks), kernel_calls("eval", shapes), \
                contextlib.redirect_stdout(sys.stderr):
            metrics = evaluation_iter(
                fcfg, params, scene, ds, n_samples=n_samples,
                save_path=out_dir, test_all=True, compute_extra_metrics=True,
                **eval_knobs(cfg))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        files = sorted(os.path.relpath(os.path.join(r, f), out_dir)
                       for r, _, fs in os.walk(out_dir) for f in fs)
    stats = _chunk_stats(chunks)
    main = stats.get("main", {})
    n_rays = EVAL_WH * EVAL_WH
    want_chunks = -(-n_rays // cfg.batch_size_test)
    want_tiles = cfg.batch_size_test * fcfg.envmap_h * fcfg.envmap_w \
        // cfg.secondary_tile
    res = {"phase": "eval", "view": [EVAL_WH, EVAL_WH], "rays": n_rays,
           "n_samples": n_samples, "seconds_per_view": wall_s,
           "main_pass_s": main.get("total_s"),
           "gbuf_pass_s": stats.get("gbuf", {}).get("total_s"),
           "chunks": stats, "launches": launches,
           "launches_by_shape": by_shape(shapes, max(len(chunks), 1)),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "metrics": metrics, "files": files}
    fails = []
    if main.get("chunks") != want_chunks:
        fails.append(f"{main.get('chunks')} main chunks, not {want_chunks}")
    if main.get("tiles_per_chunk") != [want_tiles]:
        fails.append(f"tiles per chunk {main.get('tiles_per_chunk')}, not "
                     f"{want_tiles}")
    if not (launches["row_gather"] > 0 and launches["row_gather_bf16"] > 0):
        fails.append(f"K1 not launched in the eval: {launches}")
    if launches["row_scatter_add"] != 0:
        fails.append(f"K2 launched {launches['row_scatter_add']} times in "
                     f"the eval")
    want = {"psnr_nvs", "psnr_nvs_brdf", "ssim_nvs", "ssim_nvs_brdf",
            "normal_mae_deg", "psnr_albedo_single", "psnr_albedo_three",
            "ssim_albedo_single", "ssim_albedo_three"}
    if set(metrics) != want or not all(math.isfinite(v)
                                       for v in metrics.values()):
        fails.append(f"metrics {metrics}")
    panels = {"nvs_with_radiance_field/000.png", "nvs_with_brdf/000.png",
              "normal/000.png", "brdf/000.png", "acc_map/000.png",
              "envir_map/envirmap.png", "metrics_record.txt"}
    if not panels <= set(files):
        fails.append(f"artifacts missing: {sorted(panels - set(files))}")
    res["ok"] = not fails
    emit(res)
    check(not fails, "eval: " + "; ".join(fails))
    fn, chunk = make_eval_chunk_fn(fcfg, n_samples=n_samples,
                                   **eval_knobs(cfg))
    rays = torch.as_tensor(ds.all_rays[n_rays // 2:n_rays // 2 + chunk],
                           device="cuda")
    lidx = torch.zeros((chunk,), dtype=torch.int32, device="cuda")
    emit_breakdown("eval_breakdown", lambda: fn(params, scene, rays, lidx),
                   main.get("median_ms", float("nan")))
    return launches, shapes, stats


# the CLI run: its views (800 x 800 training views, 200 x 200 test views)
# and radiance iterations before its one alpha-mask event
CLI_VIEWS = (("train", 3, 800), ("test", 2, 200))
CLI_RADIANCE = 200
CLI_VIS_EVERY = 5


def phase_cli_run():
    """The port's CLI on configs/single_light/armadillo.txt, in this
    process: a rotated-lights scene of the shadow scene written to a
    temporary directory (write_shadow_scene: CLI_VIEWS, every PNG's rows
    through the five filter types, a 1024 x 2048 sunset.hdr), then
    ``python -m tensoir_tpu_torch.train_tensoir`` overriding only the data
    and log paths, the iterations and the schedule (one alpha mask with
    the shrink at CLI_RADIANCE, one upsample to 300^3 five iterations
    later, seven relight iterations after it), N_vis 1, vis_every and
    test_number 2: the loaders, training with the evals during it,
    ckpt_final, the final render_test over both test views; then
    ``--render_only 1 --render_test 1 --ckpt ckpt_final.npz``, whose
    metrics must equal the run's final render_test bit for bit. Launch
    counts from 0 before the run to the end of the render-only run; every
    kernel must launch. Returns (launch counts, launches by shape)."""
    import tempfile
    import torch
    from tensoir_tpu_torch import train_tensoir
    from tensoir_tpu_torch.data.synthetic import write_shadow_scene
    from tensoir_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from tensoir_tpu_torch.train import loop
    from tensoir_tpu_torch.utils.png import read_png
    n_iters = CLI_RADIANCE + 12
    want_evals = [it for it in range(CLI_RADIANCE, n_iters)
                  if it % CLI_VIS_EVERY == CLI_VIS_EVERY - 1]
    with tempfile.TemporaryDirectory() as tmp:
        data, hdr, logs = (os.path.join(tmp, d) for d in ("scene", "hdr",
                                                           "log"))
        t0 = time.perf_counter()
        write_shadow_scene(data, hdr, views=CLI_VIEWS)
        write_s = time.perf_counter() - t0
        png = os.path.join(data, "train_000", "rgba_sunset_000.png")
        decode_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            img = read_png(png)
            decode_ms.append((time.perf_counter() - t0) * 1e3)
        argv = ["--config", str(CONFIG), "--datadir", data, "--hdrdir", hdr,
                "--basedir", logs, "--n_iters", str(n_iters),
                "--update_AlphaMask_list", f"[{CLI_RADIANCE}]",
                "--upsamp_list", f"[{CLI_RADIANCE + 5}]", "--N_vis", "1",
                "--vis_every", str(CLI_VIS_EVERY), "--test_number", "2"]
        log, chunks, shapes = {"events": [], "steps": []}, [], {}
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        # the CLI's printing goes to stderr: stdout holds the JSON lines
        with _run_probe(loop, log), _eval_probe(chunks), \
                kernel_calls("cli_run", shapes), \
                contextlib.redirect_stdout(sys.stderr):
            trained = train_tensoir.main(argv)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            run_dir = os.path.join(logs, "armadillo")
            files = sorted(os.path.relpath(os.path.join(r, f), run_dir)
                           for r, _, fs in os.walk(run_dir) for f in fs)
            evals = open(os.path.join(run_dir, "imgs_vis",
                                      "metrics_record.txt")).read()
            n_train_chunks = len(chunks)
            t1 = time.perf_counter()
            again = train_tensoir.main(argv + [
                "--render_only", "1", "--render_test", "1", "--ckpt",
                os.path.join(run_dir, "ckpt_final.npz")])
            torch.cuda.synchronize()
            render_only_s = time.perf_counter() - t1
        launches = dict(LAUNCHES)
    segs = _segments(log["steps"])
    final, reloaded = trained.get("imgs_test_all"), again.get("imgs_test_all")
    res = {"phase": "cli_run", "views": [list(v) for v in CLI_VIEWS],
           "scene_write_s": write_s, "png_decode_ms_800": decode_ms,
           "png_shape": list(img.shape), "n_iters": n_iters,
           "train_and_eval_s": train_s, "render_only_s": render_only_s,
           "segments": segs,
           "events": [e for e in log["events"] if e["event"] != "rebuild"],
           "eval_chunks": {"run": _chunk_stats(chunks[:n_train_chunks]),
                           "render_only": _chunk_stats(
                               chunks[n_train_chunks:])},
           "evals_during_training": evals.splitlines(),
           "final_render_test": final, "render_only_test": reloaded,
           "launches": launches, "files": files,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    fails = []
    if final is None or final != reloaded:
        fails.append(f"render-only metrics {reloaded} differ from the run's "
                     f"{final}")
    if len(res["evals_during_training"]) != len(want_evals) or not all(
            ln.startswith(f"Iteration:{it:06d}: ")
            for ln, it in zip(res["evals_during_training"], want_evals)):
        fails.append(f"evals during training {res['evals_during_training']}"
                     f", not at {want_evals}")
    want = {"ckpt_final.npz", "config.txt", "metrics.jsonl",
            "imgs_test_all/metrics_record.txt",
            "imgs_test_all/envir_map/envirmap.png",
            "imgs_vis/metrics_record.txt"}
    want |= {f"imgs_test_all/{d}/{v:03d}.png" for v in range(2) for d in (
        "nvs_with_radiance_field", "nvs_with_brdf", "normal", "brdf",
        "acc_map")}
    want |= {f"imgs_vis/{d}/{it:06d}_000.png" for it in want_evals
             for d in ("nvs_with_radiance_field", "acc_map")}
    missing = sorted(want - set(files))
    if missing or not any(f.startswith("events.out.tfevents")
                          for f in files):
        fails.append(f"artifacts missing: {missing}")
    if not all(v > 0 for v in launches.values()):
        fails.append(f"a kernel was not launched in the CLI run: {launches}")
    res["ok"] = not fails
    emit(res)
    check(not fails, "cli_run: " + "; ".join(fails))
    return launches, shapes


# the relight phases: the relighting test config, the side of its test
# views (cut from TensoIR-Synthetic's 800 x 800: at 80 x 80 a view took
# 8.4 s on the card, 200 x 200 keeps the phase near two minutes), and the
# rays of relight_parity (both devices relight them, the CPU at full width)
RELIGHT_CONFIG = ROOT / "configs" / "relighting_test" / "armadillo.txt"
RELIGHT_WH = 200
RELIGHT_VIEWS = 2
RELIGHT_PARITY_RAYS = 64
RELIGHT_LIGHTS = ("bridge", "city", "fireplace", "forest", "night")


def _relight_chunk_kw(cfg, n_samples: int) -> dict:
    """The chunk options relight_importance passes from the config."""
    return dict(n_samples=n_samples, n_light_samples=512,
                second_n_sample=cfg.second_nSample,
                vis_tile=cfg.secondary_tile)


def phase_relight_parity(trained):
    """One relight chunk of train_run's reloaded field at full width on the
    card (K1) and on the CPU (the plain versions): RELIGHT_PARITY_RAYS rays
    spread over a relight view x 512 light samples from a 1024 x 2048
    probe (two visibility tiles of 16,384 pairs, 96 secondary samples),
    the same uniforms, drawn once, given to both; the exact march (first
    48 occupied samples) and the fast route (window 48/16 on the 128^3
    bake, made on the card and given to both: bench_step_parity holds the
    bakes themselves). Tolerance: each of the eight outputs within 1e-4
    absolute on all but 1 % of the rays, as eval_parity."""
    import torch
    from tensoir_tpu_torch import config as C
    from tensoir_tpu_torch.data.synthetic import (SyntheticShadowDataset,
                                                  relight_probe)
    from tensoir_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from tensoir_tpu_torch.models.env_light import EnvironmentLight
    from tensoir_tpu_torch.render import relight_pipeline as RP
    fcfg, params, scene, n_samples = trained
    cfg = C.load_config(str(RELIGHT_CONFIG))
    ds = SyntheticShadowDataset(split="test", n_views=1,
                                img_wh=(RELIGHT_WH, RELIGHT_WH))
    rays = ds.all_rays[::ds.all_rays.shape[0] // RELIGHT_PARITY_RAYS]
    n = RELIGHT_PARITY_RAYS
    rays = rays[:n]
    probe = relight_probe(1, (1024, 2048))
    envs = {}
    for dev in ("cuda", "cpu"):
        envs[dev] = EnvironmentLight(None, device=dev)
        envs[dev].add_light("city", probe)
    u = torch.rand((n, 512), generator=torch.Generator().manual_seed(3))
    bakes = RP.bake_visibility(fcfg, params, scene)
    names = ("relight_without_bg", "relight_with_bg", "acc", "albedo",
             "roughness", "normal", "depth", "rgb")
    tol, frac = 1e-4, 0.01
    report, fails, secs, launches = {}, [], {}, {}
    for route in ("exact", "fast"):
        outs = {}
        for dev in ("cuda", "cpu"):
            p, sc = (params, scene) if dev == "cuda" else (_to(params, dev),
                                                           _to(scene, dev))
            vb = None
            if route == "fast":
                vb = tuple(b.to(dev) for b in bakes)
            fn = RP.make_relight_chunk_fn(fcfg, envs[dev], "city",
                                          fast_vis=route == "fast",
                                          **_relight_chunk_kw(cfg, n_samples))
            reset_launch_counts()
            out, secs[f"{route}_{dev}"] = _timed(
                fn, p, sc, torch.as_tensor(rays, device=dev), None,
                torch.ones(3, device=dev), draws=u, vis_bakes=vb)
            if dev == "cuda":
                launches[route] = dict(LAUNCHES)
            outs[dev] = [o.float().reshape(n, -1).cpu() for o in out]
        rep = {}
        for name, a, b in zip(names, outs["cuda"], outs["cpu"]):
            d = (a - b).abs().amax(1)
            over = int((d > tol).sum())
            rep[name] = {"max_abs_err": float(d.max()), "rays_over_tol": over}
            if over > frac * n:
                fails.append(f"{route} {name}: {over} of {n} rays over {tol}")
        report[route] = rep
        surface = int((outs["cpu"][2] > 0.5).sum())
        report[route]["surface_rays"] = surface
        if not surface:
            fails.append(f"{route}: no ray of the chunk reaches the surface")
        if launches[route]["row_scatter_add"] != 0 or not (
                launches[route]["row_gather"] > 0):
            fails.append(f"{route}: launches {launches[route]}")
    emit({"phase": "relight_parity", "ok": not fails, "fails": fails,
          "rays": n, "light_samples": 512, "n_samples": n_samples,
          "outputs": report, "seconds": secs, "launches": launches,
          "tol": {"abs": tol, "rays_over_frac": frac}})
    check(not fails, "relight_parity: " + "; ".join(fails))


@contextlib.contextmanager
def _relight_probe(log: list, timing: dict):
    """Record each relight chunk call the block makes (its time by CUDA
    events, K1/K2 launches, visibility tiles), the wall seconds of each
    relight_benchmark and of the G-buffer pass of the albedo rescale
    (``timing``). Wraps ``render.relight_pipeline.make_relight_chunk_fn``
    and ``relight_benchmark`` and ``render.eval.compute_rescale_ratio``,
    which the relight script looks up when it runs."""
    import torch
    from tensoir_tpu_torch.kernels import LAUNCHES
    from tensoir_tpu_torch.render import eval as E
    from tensoir_tpu_torch.render import relight_pipeline as RP
    from tensoir_tpu_torch.render import secondary
    make, bench, rescale = (RP.make_relight_chunk_fn, RP.relight_benchmark,
                            E.compute_rescale_ratio)

    def wrapped(*a, **kw):
        fn = make(*a, **kw)

        def run(*args, **kws):
            before = dict(LAUNCHES)
            tiles = secondary.MARCHED["tiles"]
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            out = fn(*args, **kws)
            t1.record()
            log.append({"kind": "relight", "events": (t0, t1),
                        "tiles": secondary.MARCHED["tiles"] - tiles,
                        "launches": {k: LAUNCHES[k] - before[k]
                                     for k in LAUNCHES}})
            return out
        return run

    def timed(name, fn):
        def run(*a, **kw):
            out, s = _timed(fn, *a, **kw)
            timing.setdefault(name, []).append(s)
            return out
        return run

    RP.make_relight_chunk_fn = wrapped
    RP.relight_benchmark = timed("benchmark_s", bench)
    E.compute_rescale_ratio = timed("gbuf_pass_s", rescale)
    try:
        yield
    finally:
        RP.make_relight_chunk_fn, RP.relight_benchmark = make, bench
        E.compute_rescale_ratio = rescale


def _relight_run(argv, path: str, shapes: dict):
    """relight_importance.main(argv) in this process with the launch counts
    zeroed just before it: (results, launch counts, chunk records, timing,
    wall seconds)."""
    import torch
    from tensoir_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from tensoir_tpu_torch.scripts import relight_importance
    chunks, timing = [], {}
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with _relight_probe(chunks, timing), _eval_probe(chunks), \
            kernel_calls(path, shapes), contextlib.redirect_stdout(sys.stderr):
        results = relight_importance.main(argv)
    torch.cuda.synchronize()
    return (results, dict(LAUNCHES), chunks, timing,
            time.perf_counter() - t0)


def phase_relight(work: str, ckpt: str, trained):
    """python -m tensoir_tpu_torch.scripts.relight_importance on
    configs/relighting_test/armadillo.txt, in this process, on train_run's
    ckpt_final over a relighting test set written to ``work``
    (write_relight_test_scene: RELIGHT_VIEWS test views of RELIGHT_WH^2,
    five 1024 x 2048 probes): the loaders, the five lights' tables, the
    G-buffer rescale pass, every view relit under each light (800 rays a
    chunk, 512 light samples, 25 exact visibility tiles), the artifact
    tree. Then one view again with ``--relight_fast_vis 1``. Seconds per
    view and of the G-buffer pass, chunks per view and light, tiles and
    K1/K2 launches per chunk (K2 must stay 0), peak memory, the HDR decode
    seconds per probe, PSNR/SSIM per light (sanity numbers: the ground
    truth is rendered under 16 x 32 copies of the probes); then
    relight_chunk_breakdown, one profiled chunk. Returns (scene dir, hdr
    dir), the launches of each run, their launches by shape and the chunk
    statistics of the exact run."""
    import torch
    from tensoir_tpu_torch import config as C
    from tensoir_tpu_torch.data.hdr import read_hdr
    from tensoir_tpu_torch.data.synthetic import write_relight_test_scene
    from tensoir_tpu_torch.models.env_light import EnvironmentLight
    from tensoir_tpu_torch.render import relight_pipeline as RP
    cfg = C.load_config(str(RELIGHT_CONFIG))
    data, hdr, logs = (os.path.join(work, d) for d in ("relight_scene",
                                                        "relight_hdr",
                                                        "relight_log"))
    t0 = time.perf_counter()
    write_relight_test_scene(data, hdr, n_views=RELIGHT_VIEWS,
                             size=RELIGHT_WH)
    write_s = time.perf_counter() - t0
    decode_s = {}
    for name in RELIGHT_LIGHTS:
        t0 = time.perf_counter()
        read_hdr(os.path.join(hdr, f"{name}.hdr"))
        decode_s[name] = time.perf_counter() - t0
    argv = ["--config", str(RELIGHT_CONFIG), "--ckpt", ckpt, "--datadir",
            data, "--hdrdir", hdr, "--basedir", logs, "--test_number",
            str(RELIGHT_VIEWS)]
    shapes = {}
    torch.cuda.reset_peak_memory_stats()
    results, launches, chunks, timing, wall_s = _relight_run(
        argv, "relight", shapes)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    out_dir = os.path.join(logs, "relight_armadillo")
    files = sorted(os.path.relpath(os.path.join(r, f), out_dir)
                   for r, _, fs in os.walk(out_dir) for f in fs)
    stats = _chunk_stats(chunks)
    rel = stats.get("relight", {})
    n_rays = RELIGHT_WH * RELIGHT_WH
    per_light = -(-n_rays // cfg.batch_size)
    want_tiles = -(-cfg.batch_size * 512 // cfg.secondary_tile)
    bench_s = timing.get("benchmark_s", [float("nan")])[0]
    res = {"phase": "relight", "views": RELIGHT_VIEWS,
           "view": [RELIGHT_WH, RELIGHT_WH], "lights": list(RELIGHT_LIGHTS),
           "scene_write_s": write_s, "hdr_decode_s": decode_s,
           "wall_s": wall_s, "benchmark_s": bench_s,
           "seconds_per_view": bench_s / RELIGHT_VIEWS,
           "gbuf_pass_s": timing.get("gbuf_pass_s", [None])[0],
           "chunks_per_view_per_light": per_light,
           "chunks": stats, "launches": launches,
           "launches_by_shape": by_shape(shapes, max(rel.get("chunks", 1),
                                                     1)),
           "projected_800_view_s": (800 * 800 // cfg.batch_size
                                    * len(RELIGHT_LIGHTS)
                                    * rel.get("median_ms", float("nan"))
                                    / 1e3),
           "peak_mem_gb": peak, "metrics": results, "files": len(files)}
    fails = []
    if rel.get("chunks") != per_light * len(RELIGHT_LIGHTS) * RELIGHT_VIEWS:
        fails.append(f"{rel.get('chunks')} relight chunks, not "
                     f"{per_light * len(RELIGHT_LIGHTS) * RELIGHT_VIEWS}")
    if rel.get("tiles_per_chunk") != [want_tiles]:
        fails.append(f"tiles per chunk {rel.get('tiles_per_chunk')}, not "
                     f"{want_tiles}")
    if not (launches["row_gather"] > 0 and launches["row_gather_bf16"] > 0):
        fails.append(f"K1 not launched in the relight run: {launches}")
    if launches["row_scatter_add"] != 0:
        fails.append(f"K2 launched {launches['row_scatter_add']} times in "
                     f"the relight run")
    if list(results) != list(RELIGHT_LIGHTS) or not all(
            math.isfinite(r["psnr"]) and math.isfinite(r["ssim"])
            for r in results.values()):
        fails.append(f"metrics {results}")
    want = {"relight_psnr.txt"}
    for v in range(RELIGHT_VIEWS):
        view = f"test_{v:03d}"
        want |= {f"{view}/{m}.png" for m in (
            "rgb", "acc", "depth", "albedo", "albedo_gamma_corrected",
            "gt_albedo_gamma_corrected", "roughness", "normal")}
        want.add(f"{view}/relighting_without_bg/relight_psnr.txt")
        for light in RELIGHT_LIGHTS:
            want |= {f"{view}/relighting_{bg}/{light}.png"
                     for bg in ("with_bg", "without_bg")}
            want |= {f"video_{bg}/{light}_video/{v:03d}.png"
                     for bg in ("with_bg", "without_bg")}
        want |= {f"video/{name}/{v:03d}.png" for name in (
            "rgb_video", "render_normal_video", "aligned_albedo_video",
            "roughness_video")}
    missing = sorted(want - set(files))
    if missing:
        fails.append(f"artifacts missing: {missing}")
    res["ok"] = not fails
    emit(res)
    check(not fails, "relight: " + "; ".join(fails))

    # the fast visibility route on one view
    fast_shapes = {}
    results_f, launches_f, chunks_f, timing_f, wall_f = _relight_run(
        argv + ["--relight_fast_vis", "1", "--test_number", "1",
                "--basedir", os.path.join(work, "relight_log_fast")],
        "relight_fast", fast_shapes)
    stats_f = _chunk_stats(chunks_f)
    bench_f = timing_f.get("benchmark_s", [float("nan")])[0]
    res_f = {"phase": "relight_fast_vis", "views": 1, "wall_s": wall_f,
             "seconds_per_view": bench_f,
             "gbuf_pass_s": timing_f.get("gbuf_pass_s", [None])[0],
             "chunks": stats_f, "launches": launches_f,
             "launches_by_shape": by_shape(
                 fast_shapes, max(stats_f.get("relight", {}).get("chunks", 1),
                                  1)),
             "metrics": results_f,
             "psnr_minus_exact": {k: results_f[k]["psnr"] - v["psnr"]
                                  for k, v in results.items()
                                  if k in results_f}}
    fails = []
    if launches_f["row_scatter_add"] != 0 or not (
            launches_f["row_gather_bf16"] > 0):
        fails.append(f"launches {launches_f}")
    if not all(math.isfinite(r["psnr"]) for r in results_f.values()):
        fails.append(f"metrics {results_f}")
    res_f["ok"] = not fails
    emit(res_f)
    check(not fails, "relight_fast_vis: " + "; ".join(fails))

    # one profiled chunk of the exact route: 800 rays from the first view
    fcfg, params, scene, n_samples = trained
    env = EnvironmentLight(hdr, device="cuda")
    fn = RP.make_relight_chunk_fn(fcfg, env, "city",
                                  **_relight_chunk_kw(cfg, n_samples))
    from tensoir_tpu_torch.data import get_dataset
    item = get_dataset("tensoIR_relighting_test")(
        data, hdr, split="test", light_names=RELIGHT_LIGHTS, sub=1)[0]
    mid = max(0, n_rays // 2 - cfg.batch_size // 2)
    rays = torch.as_tensor(item["rays"][mid:mid + cfg.batch_size],
                           device="cuda")
    key = torch.Generator(device="cuda").manual_seed(0)
    ones = torch.ones(3, device="cuda")
    emit_breakdown("relight_chunk_breakdown",
                   lambda: fn(params, scene, rays, key, ones),
                   rel.get("median_ms", float("nan")))
    return ((data, hdr), {"relight": launches, "relight_fast": launches_f},
            {**shapes, **fast_shapes}, stats)


def phase_material_edit(work: str, ckpt: str, scene_dirs) -> None:
    """python -m tensoir_tpu_torch.scripts.material_editing on one view of
    the relight phase's scene under 'city': with ``--roughness_scale 0.5
    --albedo_tint 1,0.3,0.3``, and unedited; both draw from the same seed,
    and the edited image must differ. K2 must not launch."""
    import torch
    from tensoir_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from tensoir_tpu_torch.scripts import material_editing
    data, hdr = scene_dirs
    argv = ["--config", str(RELIGHT_CONFIG), "--ckpt", ckpt, "--datadir",
            data, "--hdrdir", hdr, "--out", os.path.join(work, "edit")]
    secs, images = {}, {}
    reset_launch_counts()
    with contextlib.redirect_stdout(sys.stderr):
        for tag, extra in (("edited", ["--roughness_scale", "0.5",
                                       "--albedo_tint", "1,0.3,0.3"]),
                           ("unedited", [])):
            images[tag], secs[tag] = _timed(material_editing.main,
                                            argv + extra)
    launches = dict(LAUNCHES)
    a, b = images["edited"][0], images["unedited"][0]
    diff = float(np.abs(a - b).max())
    fails = []
    if not (np.isfinite(a).all() and a.shape == (RELIGHT_WH, RELIGHT_WH, 3)):
        fails.append(f"edited image {a.shape}")
    if diff <= 0.01:
        fails.append(f"the edit changed the image by only {diff}")
    if launches["row_scatter_add"] != 0:
        fails.append(f"K2 launched: {launches}")
    emit({"phase": "material_edit", "ok": not fails, "fails": fails,
          "seconds": secs, "max_abs_diff": diff,
          "mean_abs_diff": float(np.abs(a - b).mean()),
          "launches": launches})
    check(not fails, "material_edit: " + "; ".join(fails))


def eval_lookup_cases(shapes) -> dict:
    """Both kernels at the eval's primary VM lookups, on random indices:
    the density at the culled march (C 64, N = chunk x march cap 256) and
    the appearance at the app cap (C 192, N = chunk x 64), each on the
    largest of the three planes the eval gathered from."""
    def largest(C, N):
        return max(R for (_, name, R, c, n) in shapes
                   if name == "row_gather" and (c, n) == (C, N))
    chunk = 4096
    return {"density": kernel_case(largest(64, chunk * 256), 64, chunk * 256,
                                   seed=70),
            "appearance": kernel_case(largest(192, chunk * 64), 192,
                                      chunk * 64, seed=71)}


def busiest_cases(shapes, seed: int) -> dict:
    """Each kernel at the shape of one path (a whole run, or the eval)
    that moved the most bytes (launches x N x C), on random indices,
    against its plain version; kernels the path never launched are left
    out."""
    import torch
    dev = torch.device("cuda")
    out = {}
    for i, name in enumerate(("row_gather", "row_gather_bf16",
                              "row_scatter_add")):
        mine = [(k, n) for k, n in shapes.items() if k[1] == name]
        if not mine:
            continue
        (_, _, R, C, N), _ = max(mine,
                                 key=lambda kn: kn[1] * kn[0][3] * kn[0][4])
        if name == "row_gather_bf16":
            out[name] = bf16_gather_case(R, N, seed=seed + i, C=C)
            continue
        gen = torch.Generator(device=dev).manual_seed(seed + i)
        idx = torch.randint(0, R, (N,), device=dev, generator=gen,
                            dtype=torch.int32)
        if name == "row_gather":
            table = torch.randn((R, C), device=dev, generator=gen)
            out[name] = {"R": R, "C": C, "N": N, **gather_case(table, idx)}
        else:
            val = torch.randn((N, C), device=dev, generator=gen)
            out[name] = {"R": R, "C": C, "N": N,
                         **scatter_case(idx, val, R)}
    return out


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
    "bench_train": {"row_gather": ("bench_density", "row_gather"),
                    "row_gather_bf16": ("bf16", "bench_app_bake"),
                    "row_scatter_add": ("bench_density", "row_scatter_add")},
    # the busiest shape of each kernel in the training run, the eval (K2
    # does not launch there: None, its entry holds its launches and no
    # times) and the CLI run (busiest_cases)
    "train_run": {name: ("train_run", name) for name in KERNEL_SOURCES},
    "eval": {"row_gather": ("eval", "row_gather"),
             "row_gather_bf16": ("eval", "row_gather_bf16"),
             "row_scatter_add": None},
    "cli_run": {name: ("cli_run", name) for name in KERNEL_SOURCES},
    # the relight script, exact (the default) and fast visibility: K2 does
    # not launch there either
    "relight": {"row_gather": ("relight", "row_gather"),
                "row_gather_bf16": ("relight", "row_gather_bf16"),
                "row_scatter_add": None},
    "relight_fast": {"row_gather": ("relight_fast", "row_gather"),
                     "row_gather_bf16": ("relight_fast", "row_gather_bf16"),
                     "row_scatter_add": None},
}
# the path whose numbers lead each kernel's summary entry: the CLI run
# (training, the evals, render-only), the one path that runs all three
# kernels (K2 does not launch on the relight path)
MAIN_PATH = "cli_run"
_OWN_SHAPE_GROUPS = ("bf16", "train_run", "eval", "cli_run", "relight",
                     "relight_fast")


def kernel_summary(cases, launches, shapes, chunks) -> list:
    """One entry per kernel: the main path's launches beside its own shape
    and times, and each path's under ``by_path`` with the launches at that
    shape (``launches_at_shape``); the eval's and the relight run's also
    with their launches per chunk of each kind (``chunks``: path -> chunk
    statistics)."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    summary = []
    for name, (src, replaces) in KERNEL_SOURCES.items():
        by_path = {}
        for path, picks in PATH_CASES.items():
            if picks[name] is None:     # not on this path: no shape, no times
                by_path[path] = {"launches": launches[path][name]}
            else:
                group, sub = picks[name]
                c = cases[group][sub]
                # a bf16 or train_run case holds its own shape, an f32 one
                # its group's
                shape = c if group in _OWN_SHAPE_GROUPS else cases[group]
                at = (path, name, shape["R"], shape["C"], shape["N"])
                by_path[path] = {
                    "launches": launches[path][name],
                    "launches_at_shape": shapes.get(at, 0),
                    "shape": {k: shape[k] for k in ("R", "C", "N")},
                    **{k: c[k] for k in keys}}
            if path in chunks:
                by_path[path]["launches_per_chunk"] = {
                    kind: st["launches_per_chunk"][name]
                    for kind, st in chunks[path].items()}
        main_path = by_path[MAIN_PATH]
        summary.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, **main_path,
                        "by_path": by_path})
    return summary


def main(argv) -> int:
    steps_only = argv == ["--steps"]
    if argv and not steps_only:
        print("usage: python3 chip_smoke.py [--steps]", file=sys.stderr)
        return 2
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
    streams, launches, shapes = {}, {}, {}
    with tempfile.TemporaryDirectory() as work:
        return _run(steps_only, work, t_start, streams, launches, shapes)


def _run(steps_only: bool, work: str, t_start: float, streams: dict,
         launches: dict, shapes: dict) -> int:
    import torch
    try:
        phase_build()
        if not steps_only:
            phase_step_parity()
            phase_relight_step_parity()
            phase_bench_step_parity()
        for path, run in (("train", phase_train),
                          ("relight_train", phase_relight_train),
                          ("bench_train", phase_bench_train)):
            launches[path], counts = run(streams)
            shapes.update(counts)
        if steps_only:
            return 0
        # after the timed steps, so that its CPU half runs after theirs
        phase_lifecycle_parity()
        launches["train_run"], counts, trained = phase_train_run(work)
        ckpt = os.path.join(work, "ckpt_final.npz")
        shapes.update(counts)
        phase_eval_parity(trained)
        launches["eval"], counts, eval_chunks = phase_eval(trained)
        shapes.update(counts)
        launches["cli_run"], counts = phase_cli_run()
        shapes.update(counts)
        phase_relight_parity(trained)
        scene_dirs, counts_by_path, counts, relight_chunks = phase_relight(
            work, ckpt, trained)
        launches.update(counts_by_path)
        shapes.update(counts)
        del trained
        phase_material_edit(work, ckpt, scene_dirs)
        cases = phase_kernels(streams, {
            path: {k: n for k, n in shapes.items() if k[0] == path}
            for path in ("train_run", "eval", "cli_run", "relight",
                         "relight_fast")})
    except SmokeFailure as exc:
        emit({"ok": False, "failure": str(exc)})
        return 1
    emit({"kernels": kernel_summary(cases, launches, shapes,
                                    {"eval": eval_chunks,
                                     "relight": relight_chunks})})
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
    sys.exit(main(sys.argv[1:]))
