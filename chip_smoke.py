#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (tensoir_tpu_torch) on one card.

    python3 chip_smoke.py            # every phase, as below
    python3 chip_smoke.py --steps    # build, train, relight_train and
                                     # bench_train only (for timing two
                                     # trees against each other); it ends
                                     # after them without the summary or
                                     # the last line
    python3 chip_smoke.py --variants # build and the three variants_*
                                     # phases only; ends the same way
    python3 chip_smoke.py --grouped  # build, the three grouped_* phases
                                     # and the grouped rows' kernel cases
                                     # only; ends the same way
    python3 chip_smoke.py --line-taps  # build and the line-taps kernel's
                                       # cases only; ends the same way

Phases, one JSON line each, in this order:
  build        compile every CUDA kernel of the port from its source (nvcc,
               sm_90a) and the host mesh extractor (g++), one compiler per
               source, all at once
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
               final render_test runs it: seconds per view, chunks, tiles,
               launches per chunk (K2 must stay 0, the line taps launch)
               and line lookups by route, peak memory, the metrics; then
               eval_breakdown, one profiled chunk
  cli_run      python -m tensoir_tpu_torch.train_tensoir on
               configs/single_light/armadillo.txt, in this process, on a
               rotated-lights scene written to a temporary directory (3
               views of 800x800 for training, 2 of 200x200 for test, PNG
               rows through all five filters, a 1024x2048 probe): the
               loaders, 200 radiance iterations, one alpha mask with the
               shrink, one upsample to 300^3, relight iterations with two
               evals, ckpt_final, the final render_test; then render-only
               from ckpt_final, whose metrics must equal the run's bit for
               bit; every kernel must launch. Its launches are the summary
               line's (MAIN_PATH)
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
               light, tiles, launches per chunk (K2 must stay 0, the line
               taps launch) and line lookups by route, peak memory, HDR
               decode seconds, PSNR/SSIM per light (a
               sanity number), the artifact tree; relight_fast_vis, one
               view again with --relight_fast_vis 1;
               relight_chunk_breakdown, one profiled chunk (the name
               relight_breakdown is relight_train's)
  material_edit
               python -m tensoir_tpu_torch.scripts.material_editing on one
               view of that scene, edited (--roughness_scale 0.5
               --albedo_tint 1,0.3,0.3) and not, on the same draws: the
               images must differ
  mesh_export  python -m tensoir_tpu_torch.scripts.export_mesh on train_run's
               ckpt_final, in this process: dense_alpha's seconds and its
               launches (3 K1-f32, one K1-bf16 and 3 line taps per chunk,
               K2 none),
               the host extraction's seconds, vertices and faces, the share
               of edges shared by two faces (> 0.99), the card's alpha
               against the CPU's on one x-slab
  lpips        LPIPS alex and vgg with seeded random weights in the
               converter's npz layout on one 800x800 pair: card against
               CPU, ms per call, and rgb_lpips through
               TENSOIR_LPIPS_WEIGHTS
  multilight_step_parity
               one deterministic relight step of each multi-light config
               (rotated: one SG set under three rotations; general: three
               SG sets) at a reduced size, rays going round the three
               lights, on the card and on the CPU: loss and every gradient
  multilight_cli
               python -m tensoir_tpu_torch.train_tensoir on
               configs/multi_light_rotated/armadillo.txt and
               configs/multi_light_general/armadillo.txt at full width, in
               this process, each on a three-light shadow scene written for
               its loader (3 training views of 800x800 and one test view of
               100x100 per light): 100 radiance iterations, one mask with
               the shrink, one upsample to 300^3, 8 relight iterations,
               ckpt_final, the final render_test of every light: median
               step ms and launches per step per phase, run seconds, PSNR
               per light; every row kernel must launch
  variants_step_parity
               one deterministic radiance step of each model variant
               (TensorCP, the stacked TensorVM, the MLP_PE, MLP, SH and RGB
               shaders, bf16, NDC) and one relight step of each (TensorCP,
               stacked, residue and ground-truth normals, the importance and
               equal-area samplers on directions drawn once on the CPU,
               bf16, NDC) at a reduced size, card vs CPU: loss and every
               gradient; and the importance sampler itself, card vs CPU
  variants_train
               the relight step at relight_train's full width and grid for
               TensorCP at TensoRF's published widths (96/288), the stacked
               TensorVM (16/48), and the default VM with importance-sampled
               directions and with bf16 compute: step ms, device-busy ms,
               K1/K2 launches by shape, peak memory
  variants_cli python -m tensoir_tpu_torch.train_tensoir on the armadillo
               config with --model_name TensorCP (96/288) and TensorVM on a
               scene it writes: a mask with the shrink, an upsample to
               300^3, relight iterations, one 200 x 200 test view,
               ckpt_final; render-only from it must equal the run's
               metrics bit for bit. `python3 chip_smoke.py --variants`
               runs only the build and these three phases
  grouped_step_parity
               one deterministic step of bench.py's configuration at its CPU
               sizes (24 secondary samples, march cap 32, the pair cap
               lifted) with each grouped knob: march_group 2 and 4,
               second_march_group 2, and 4 on a bake of 16,
               secondary_app_hoist, and all together, card vs CPU: loss
               1e-4, every gradient 1e-3
  grouped_train
               bench.py's step at full width (bench_setup(full=True)),
               deterministic, ungrouped and then with each grouped knob
               (march_group 2 and 4, second_march_group 2, 4 with
               group_bake_reso 64, secondary_app_hoist, all together), and
               ungrouped again (the host's clock drifts), from
               copies of one masked field: first loss beside the ungrouped
               one (held to 1e-4 where the identity holds), the march's
               overflow fraction, step ms, device-busy ms, peak memory,
               K1/K2 launches per step by shape (the 16-corner block rows
               and the 27-corner rows must launch)
  grouped_cli  python -m tensoir_tpu_torch.train_tensoir on the armadillo
               config at full width with every grouped knob on bench.py's
               fast knobs, in this process, on a scene it writes (2 views
               of 800x800, one of 200x200): mask + shrink, upsample to
               300^3, relight iterations and an eval, the loop's group
               resolutions and downgrade lines; render-only from
               ckpt_final, bit-equal; then a short run at
               --downsample_train 2 over the 800x800 PNGs (resized on load)
  dp_nccl      data-parallel (parallel/): one process in a one-rank NCCL
               group, 3 deterministic relight steps of relight_train's
               field at full width through make_train_step(mesh=...)
               against the same steps without a mesh: the group's
               reduction exact, the first loss bit-equal, the rest
               bit-equal if two ungrouped runs are (K2's atomics may make
               them differ), else loss 1e-5, gradients 1e-3; all_reduce
               bytes and ms, median step ms beside relight_train's
  dp_gloo2     two processes of tensoir_tpu_torch/scripts/multihost_worker.py
               on cuda:0 over gloo: the same step on 2 x 2048 rays against
               one process on 4096 (relight and pair caps lifted): loss
               1e-5, every gradient 1e-3, the ranks' parameters bit-equal;
               then at the config's cap (reported); gloo all_reduce ms,
               peak memory, launches per rank-step
  dp_run       reconstruction on two gloo ranks on cuda:0 at full width on
               the demo's data: mask + shrink, a checkpoint, one upsample,
               a stop file; only rank 0's log_dir, bit-equal ranks, one
               stop iteration, wall s
  dp_launch    the path a user launches: python -m torch.distributed.run
               --standalone --nproc_per_node 1, the group made from the
               launcher's environment (NCCL, cuda:LOCAL_RANK): the worker's
               step against one process (loss 1e-5, gradients 1e-3, ranks
               bit-equal, the NCCL all_reduce's ms), then the CLI at full
               width (mask + shrink, upsample, an eval, a checkpoint, then
               rank 0's STOP written by the smoke): rank 0's artifacts, the
               stop after the save, each rank's states in ckpt_final, ms
               per radiance and relight iteration. `python3 chip_smoke.py
               --dp-launch` runs only this phase, on every card of the
               machine and then on one
               (a failed or hung rank kills the others; each dp phase
               prints its seconds to stderr)
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
               the eval, the CLI run, the relight runs (the visibility
               march's density lookup, the fast route's baked grid), the
               mesh export, the multi-light CLI runs, the data-parallel
               phases and the variants' steps and CLI runs (per
               decomposition), and at the eval's density and appearance
               lookups; the line-taps kernel (line_taps) at the main
               path's line lookups without a gradient, against its plain
               version and the matrix route (library_ms), in ulps of the
               taps' scale; and the grouped marches' rows (grouped_*): K1-f32
               at the 16-corner block rows and K2 at their gradient,
               K1-bf16 at the 27-corner rows as 27 bf16 (54 B) and padded
               to 32 (64 B)
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
# step ms of the timed phases, for the phases that report beside them
STEP_MS = {}
KERNEL_SOURCES = {
    "row_gather": ("tensoir_tpu_torch/csrc/row_gather.cu",
                   "scripts/bench_pallas_scatter.py:78 (make_gather.kernel)"),
    "row_gather_bf16": (
        "tensoir_tpu_torch/csrc/row_gather.cu",
        "scripts/bench_pallas_scatter.py:78 (make_gather.kernel)"),
    "row_scatter_add": (
        "tensoir_tpu_torch/csrc/row_scatter_add.cu",
        "scripts/bench_pallas_scatter.py:37 (make_scatter_add.kernel)"),
    # no Pallas kernel: the JAX package's line lookup is an XLA dot on the
    # dense two-tap matrix
    "line_taps": (
        "tensoir_tpu_torch/csrc/line_taps.cu",
        "none (tensoir_tpu/ops/interp.py:284, lerp_line_matmul's XLA dot)"),
}
# the row kernels: every training path launches all three (K2 only where a
# gradient flows); the line-taps kernel launches only where a line lookup
# takes no gradient, which the eval, the relight runs and the CLI run must
ROW_KERNELS = ("row_gather", "row_gather_bf16", "row_scatter_add")


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
    # the mesh export's dense alpha (K1-f32 density rows, K1-bf16 alpha
    # mask) and the two multi-light CLI runs
    for i, path in enumerate(NEW_PATHS):
        out[path] = busiest_cases(busiest[path], seed=100 + 10 * i)
    block, out["grouped_pair"] = grouped_kernel_cases()
    for g, case in block.items():
        out[f"grouped_block16_g{g}"] = case
    out["eval_lookups"] = eval_lookup_cases(busiest["eval"])
    out["line_taps"] = line_taps_cases()
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


def step_knobs(cfg, n_samples, deterministic, relight=False, **overrides):
    """(StepStatic fields, LossWeights fields, make_optimizer's rates) of
    the step train/loop.py builds for the radiance phase, or with
    ``relight`` for the relight phase (``overrides`` replace StepStatic
    fields, to cut the size or to pick a variant)."""
    from tensoir_tpu_torch.train.optim import decay_factor
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
        kw.update(overrides)
        st = dict(n_samples=n_samples, is_relight=True, white_bg=True,
                  app_cap=cfg.app_cap_per_ray, deterministic=deterministic,
                  **kw)
        w = dict(ortho=cfg.Ortho_weight, l1=cfg.L1_weight_rest,
                 rgb_brdf=cfg.rgb_brdf_weight,
                 normals_diff=cfg.normals_diff_weight,
                 normals_ori=cfg.normals_orientation_weight,
                 albedo_sm=cfg.albedo_smoothness_loss_weight,
                 rough_sm=cfg.roughness_smoothness_loss_weight,
                 lr_factor=lr_factor, n_iters=cfg.n_iters,
                 relight_start=cfg.update_AlphaMask_list[0])
    else:
        st = dict(n_samples=n_samples, is_relight=False, white_bg=True,
                  app_cap=cfg.app_cap_per_ray, march_cap=0,
                  deterministic=deterministic, **overrides)
        w = dict(ortho=cfg.Ortho_weight, l1=cfg.L1_weight_inital,
                 tv_density=cfg.TV_weight_density,
                 tv_app=cfg.TV_weight_app, lr_factor=lr_factor,
                 n_iters=cfg.n_iters,
                 relight_start=cfg.update_AlphaMask_list[0])
    lr = dict(lr_init=cfg.lr_init, lr_basis=cfg.lr_basis,
              lr_decay_factor=lr_factor, lr_light=cfg.lr_light)
    return st, w, lr


def make_step(fcfg, cfg, n_samples, deterministic, device, relight=False,
              mesh=None, **relight_kw):
    """(optimizer, step function) of ``step_knobs``' step on ``device``,
    under ``mesh`` when given."""
    from tensoir_tpu_torch.train.optim import make_optimizer
    from tensoir_tpu_torch.train.step import (LossWeights, StepStatic,
                                              make_train_step)
    st, w, lr = step_knobs(cfg, n_samples, deterministic, relight,
                           **relight_kw)
    opt = make_optimizer(None, **lr)
    return opt, make_train_step(fcfg, opt, StepStatic(**st),
                                LossWeights(**w), device=device, mesh=mesh)


def field(fcfg, reso, seed, device):
    import torch
    from tensoir_tpu_torch.models.field import init_field_params
    gen = torch.Generator().manual_seed(seed)
    params, scene = init_field_params(gen, fcfg, reso, AABB, device=device)
    return seed_blob(fcfg, params), scene


def seed_blob(fcfg, params):
    """The solid blob of ``bench_scene.seed_solid_blob`` (amplitude 8,
    sharpness 0.1) on the decomposition's density factors: VM's planes and
    lines, the first density channel of the stacked tensors, or CP's three
    lines, each bumped by 3 (a product of three bumps, 27 at the centre
    against VM's 24)."""
    import torch
    from tensoir_tpu_torch.utils.bench_scene import seed_solid_blob
    if fcfg.decomp == "vm":
        return seed_solid_blob(params)

    def bump(n):
        z = np.linspace(-1, 1, n)
        return torch.from_numpy(np.exp(-(z ** 2) / 0.10).astype(np.float32))

    with torch.no_grad():
        for i in range(3):
            if fcfg.decomp == "vm_stacked":
                a = fcfg.app_n_comp[i]
                g, ln = params[f"stack_plane_{i}"], params[f"stack_line_{i}"]
                g[..., a] += 8.0 * torch.outer(bump(g.shape[0]),
                                               bump(g.shape[1])).to(g.device)
                ln[:, a] += bump(ln.shape[0]).to(ln.device)
            else:
                ln = params[f"density_line_{i}"]
                ln[:, 0] += 3.0 * bump(ln.shape[0]).to(ln.device)
    return params


def batch_of(n: int, device, lights: int = 1):
    """``n`` bench rays at grey, ray i under light i % ``lights``."""
    import torch
    from tensoir_tpu_torch.utils.bench_scene import bench_rays
    return {"rays": torch.as_tensor(bench_rays(n), device=device),
            "rgbs": torch.full((n, 3), 0.5, device=device),
            "light_idx": (torch.arange(n, device=device) % lights).to(
                torch.int32)}


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
    """Count the kernels' launches by shape into ``counts`` while the
    block runs, keyed (path, kernel, R, C, N); with ``streams``, also keep
    each row kernel's shape's first index stream there. Wraps the port's
    call sites: the module functions that ``gather_rows`` and its backward
    call, the name ``models.field`` imported, and ``ops.interp.line_taps``
    (R, C: a line table's nodes and width). Only calls that launch (N > 0)
    count: while the secondary pass captures a tile graph, its K1 calls
    launch nothing (each replay makes them again; ``render/secondary.py``),
    and neither do its line taps, which its replays launch with no Python
    call: their launches are in ``LAUNCHES``, not by shape here."""
    import torch
    from tensoir_tpu_torch.kernels import rows
    from tensoir_tpu_torch.models import field as field_mod
    from tensoir_tpu_torch.ops import interp
    gather, scatter, taps = (rows.row_gather, rows.row_scatter_add,
                             interp.line_taps)

    def note(name, R, C, idx):
        if idx.numel() == 0 or torch.cuda.is_current_stream_capturing():
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

    def counted_taps(lines, coords, axes, extrapolate=False):
        n = coords.numel() // 3
        if n and not torch.cuda.is_current_stream_capturing():
            key = (path, "line_taps", *map(int, lines[0].shape), n)
            counts[key] = counts.get(key, 0) + 1
        return taps(lines, coords, axes, extrapolate)

    rows.row_gather = field_mod.row_gather = counted_gather
    rows.row_scatter_add = counted_scatter
    interp.line_taps = counted_taps
    try:
        yield
    finally:
        rows.row_gather = field_mod.row_gather = gather
        rows.row_scatter_add = scatter
        interp.line_taps = taps


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
          and all(launches[k] > 0 for k in ROW_KERNELS))
    res["ok"] = ok
    emit(res)
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(all(launches[k] > 0 for k in ROW_KERNELS),
          f"a kernel was not launched on the main path: {launches}")

    emit_breakdown("breakdown", lambda: step_fn(params, state, scene, batch,
                                                key, it), step_ms)
    return launches, shapes


def emit_breakdown(phase: str, run_step, step_ms: float) -> dict:
    """Where one step's device time goes, by CUDA kernel and by the step's
    own ranges, and the share of the timed step the card sat idle.
    Informational: not a pass/fail. Returns the line it emits."""
    import torch

    from tensoir_tpu_torch.profiling import SPANS
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run_step()
            torch.cuda.synchronize()
        events = prof.key_averages()
        # the port's spans also appear on the device timeline: they are
        # not kernels
        kern = [e for e in events if e.device_type == DeviceType.CUDA
                and e.key not in SPANS]
        busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
        host = [e for e in events if e.device_type == DeviceType.CPU
                and e.key not in SPANS]
        # device time of the kernels launched inside each span (the
        # backward runs on autograd's own thread, outside the spans: it is
        # the busy time the forward and adam leave)
        ranges = {e.key: {"device_ms": e.device_time_total / 1e3,
                          "host_ms": e.cpu_time_total / 1e3}
                  for e in events
                  if e.key in SPANS and e.device_type == DeviceType.CPU}
        line = {"phase": phase, "device_busy_ms": busy_ms,
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
                  [:15]]}
    except Exception as exc:  # noqa: BLE001  diagnostic only
        line = {"phase": phase, "measured": False, "error": repr(exc)}
    emit(line)
    return line


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
    in ``replay`` in their place, in the same order. On the card the
    tiles' choices are read after each replay of their tile graph, from the
    tensors its capture chose into; choices are handed out on the CPU
    only."""
    import torch
    from tensoir_tpu_torch.render import primary, secondary
    choose = primary.compact_nonzero
    graph = secondary._TileGraph
    capture, replayed = graph.capture, graph.replay
    replay = None if replay is None else list(replay)
    captured = []

    def wrapped(score, cap):
        if replay is not None:
            check(not score.is_cuda, "pair choices handed out on the card")
            idx, ok = replay.pop(0)
            check(idx.shape == (cap,), "replayed pair choice of another cap")
            return idx.to(score.device), ok.to(score.device)
        idx, ok = choose(score, cap)
        if record is not None:
            if torch.cuda.is_current_stream_capturing():
                captured.append((idx, ok))
            else:
                record.append((idx.cpu(), ok.cpu()))
        return idx, ok

    def capture_choices(self, *args):
        captured.clear()
        out = capture(self, *args)
        self.choices = list(captured)
        return out

    def replay_choices(self, *xs):
        out = replayed(self, *xs)
        if record is not None:
            record.extend((i.cpu(), o.cpu()) for i, o in self.choices)
        return out

    # every graph replayed here is captured here, with its choices
    secondary._GRAPHS.clear()
    primary.compact_nonzero = wrapped
    graph.capture, graph.replay = capture_choices, replay_choices
    try:
        yield
    finally:
        primary.compact_nonzero = choose
        graph.capture, graph.replay = capture, replayed
    check(not replay, "pair choices left over after the replayed step")


def _to(tree, dev):
    """A copy on ``dev`` of a dict of tensors and dicts of tensors."""
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev, copy=True)
            for k, v in tree.items()}


def _step_on(dev, params0, scene0, make, n_rays, step, bakes, record=None,
             replay=None, lights: int = 1, extra=None):
    """One deterministic step on ``dev`` from a copy of the CPU field: (loss,
    n_acc_masked (0 for a radiance step), parameters, gradients, the tables
    ``bakes(params, scene)`` makes before the step), all on the CPU.
    ``make(dev)`` builds (optimizer, step function); ``record`` /
    ``replay`` as in _pair_choice; the rays go round ``lights`` lights;
    ``extra`` adds CPU tensors to the batch."""
    from tensoir_tpu_torch.train.optim import flatten
    # a copy each: the step updates its parameters in place
    params, scene = _to(params0, dev), _to(scene0, dev)
    tables = [b.cpu() for b in bakes(params, scene)]
    opt, step_fn = make(dev)
    state = opt.init(params)
    batch = batch_of(n_rays, dev, lights)
    batch.update({k: v.to(dev) for k, v in (extra or {}).items()})
    with _pair_choice(record, replay):
        params, state, m = step_fn(params, state, scene, batch, None, step)
    # Adam's first moment after one step is (1 - b1) * grad
    grads = {k: v.cpu() / 0.1 for k, v in state["mu"].items()}
    return (float(m["total_loss"]), float(m.get("n_acc_masked", 0.0)),
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
    STEP_MS["relight_train"] = step_ms
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
          and all(launches[k] > 0 for k in ROW_KERNELS)
          and marched["pairs"] == 10 * pairs_per_step)
    res["ok"] = ok
    emit(res)
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"relight loss did not fall: {losses}")
    check(all(launches[k] > 0 for k in ROW_KERNELS),
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
    if not all(launches[k] > 0 for k in ROW_KERNELS):
        fails.append(f"a kernel was not launched on the bench path: "
                     f"{launches}")
    if marched != {"pairs": 10 * cap, "tiles": 10 * cap // st[
            "secondary_tile"], "skipped": 0}:
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
        fails.append(f"a kernel was not launched in the run (the line "
                     f"taps at the alpha masks): {launches}")
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
# 800 x 800 view took 226.0 s on the card (PERF.md), 400 x 400 a quarter;
# 200 x 200 (a sixteenth) leaves the smoke room for the grouped phases
EVAL_WH = 200
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
    time (CUDA events), its K1/K2 launches, its secondary tiles marched and
    skipped (``MARCHED``: tiles of background rays alone) and its line
    lookups by route (``LINE_ROUTE``: a tile graph's lookups count at
    its capture). Wraps ``render.eval.make_eval_chunk_fn``, which
    ``evaluation_iter`` calls."""
    import torch
    from tensoir_tpu_torch.kernels import LAUNCHES
    from tensoir_tpu_torch.ops.interp import LINE_ROUTE
    from tensoir_tpu_torch.render import eval as E
    from tensoir_tpu_torch.render import secondary
    make = E.make_eval_chunk_fn

    def wrapped(cfg, **kw):
        fn, chunk = make(cfg, **kw)
        kind = "gbuf" if kw.get("relight_ray_cap") == 1 else "main"

        def run(params, scene, rays, light_idx):
            before = dict(LAUNCHES)
            routes = dict(LINE_ROUTE)
            tiles = secondary.MARCHED["tiles"]
            skipped = secondary.MARCHED["skipped"]
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            out = fn(params, scene, rays, light_idx)
            t1.record()
            log.append({"kind": kind, "events": (t0, t1),
                        "tiles": secondary.MARCHED["tiles"] - tiles,
                        "skipped": secondary.MARCHED["skipped"] - skipped,
                        "launches": {k: LAUNCHES[k] - before[k]
                                     for k in LAUNCHES},
                        "line_route": {k: LINE_ROUTE[k] - routes[k]
                                       for k in LINE_ROUTE}})
            return out
        return run, chunk

    E.make_eval_chunk_fn = wrapped
    try:
        yield
    finally:
        E.make_eval_chunk_fn = make


def _chunk_stats(chunks) -> dict:
    """Per kind of chunk (eval ``main``, G-buffer ``gbuf``, ``relight``):
    count, median and total ms, secondary tiles marched and skipped per
    chunk (distinct counts) and the skipped share of all, launches per
    chunk, and the distinct counts of line lookups by route a chunk
    made."""
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
            "skipped_per_chunk": sorted({c.get("skipped", 0) for c in mine}),
            "skipped_share": (sum(c.get("skipped", 0) for c in mine)
                              / max(1, sum(c["tiles"] + c.get("skipped", 0)
                                           for c in mine))),
            "launches_per_chunk": {
                k: sum(c["launches"][k] for c in mine) / len(mine)
                for k in mine[0]["launches"]},
            "line_route_per_chunk": {
                k: sorted({c["line_route"][k] for c in mine})
                for k in mine[0]["line_route"]}}
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
    main_tiles = sorted({c["tiles"] + c["skipped"] for c in chunks
                         if c["kind"] == "main"})
    if main_tiles != [want_tiles]:
        fails.append(f"tiles marched and skipped per chunk {main_tiles}, "
                     f"not {want_tiles}")
    if not (launches["row_gather"] > 0 and launches["row_gather_bf16"] > 0):
        fails.append(f"K1 not launched in the eval: {launches}")
    if not launches["line_taps"] > 0:
        fails.append(f"the line taps not launched in the eval: {launches}")
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
# 8.4 s on the card, 200 x 200 about a minute), one view (a second took
# another minute, which the smoke's time limit no longer has room for),
# and the rays of relight_parity (both devices relight them, the CPU at
# full width)
RELIGHT_CONFIG = ROOT / "configs" / "relighting_test" / "armadillo.txt"
RELIGHT_WH = 200
RELIGHT_VIEWS = 1
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
    probe (the kept pairs of two visibility tiles' worth, packed into tiles
    of 16,384, 96 secondary samples),
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
    events, K1/K2 launches, visibility tiles, the (point, light sample)
    pairs offered and kept of ``RP.VIS_PACK``), the wall seconds of each
    relight_benchmark and of the G-buffer pass of the albedo rescale
    (``timing``), and its line lookups by route (``LINE_ROUTE``). Wraps
    ``render.relight_pipeline.make_relight_chunk_fn`` and
    ``relight_benchmark`` and ``render.eval.compute_rescale_ratio``, which
    the relight script looks up when it runs."""
    import torch
    from tensoir_tpu_torch.kernels import LAUNCHES
    from tensoir_tpu_torch.ops.interp import LINE_ROUTE
    from tensoir_tpu_torch.render import eval as E
    from tensoir_tpu_torch.render import relight_pipeline as RP
    from tensoir_tpu_torch.render import secondary
    make, bench, rescale = (RP.make_relight_chunk_fn, RP.relight_benchmark,
                            E.compute_rescale_ratio)

    def wrapped(*a, **kw):
        fn = make(*a, **kw)

        def run(*args, **kws):
            before = dict(LAUNCHES)
            routes = dict(LINE_ROUTE)
            tiles = secondary.MARCHED["tiles"]
            pack = dict(RP.VIS_PACK)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            out = fn(*args, **kws)
            t1.record()
            log.append({"kind": "relight", "events": (t0, t1),
                        "tiles": secondary.MARCHED["tiles"] - tiles,
                        **{k: RP.VIS_PACK[k] - pack[k] for k in pack},
                        "launches": {k: LAUNCHES[k] - before[k]
                                     for k in LAUNCHES},
                        "line_route": {k: LINE_ROUTE[k] - routes[k]
                                       for k in LINE_ROUTE}})
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


def _vis_pack_check(chunks, vis_tile: int, want_tiles: int):
    """(kept share, fails) of the relight chunk records: each chunk marches
    ceil(kept / vis_tile) visibility tiles, no more than the ``want_tiles``
    of every pair of the chunk, and some chunk marches at least one."""
    mine = [c for c in chunks if c["kind"] == "relight"]
    offered = sum(c["offered"] for c in mine)
    share = sum(c["kept"] for c in mine) / max(offered, 1)
    bad = [(c["kept"], c["tiles"]) for c in mine
           if c["tiles"] != -(-c["kept"] // vis_tile)
           or c["tiles"] > want_tiles]
    fails = []
    if bad:
        fails.append(f"(kept pairs, tiles) of {len(bad)} chunks not packed "
                     f"in tiles of {vis_tile}, at most {want_tiles}: "
                     f"{bad[:4]}")
    if not any(c["tiles"] for c in mine):
        fails.append("no relight chunk marched a visibility tile")
    return share, fails


def phase_relight(work: str, ckpt: str, trained):
    """python -m tensoir_tpu_torch.scripts.relight_importance on
    configs/relighting_test/armadillo.txt, in this process, on train_run's
    ckpt_final over a relighting test set written to ``work``
    (write_relight_test_scene: RELIGHT_VIEWS test views of RELIGHT_WH^2,
    five 1024 x 2048 probes): the loaders, the five lights' tables, the
    G-buffer rescale pass, every view relit under each light (800 rays a
    chunk, 512 light samples, the kept pairs of the chunk's 25 tiles'
    worth packed into exact visibility tiles), the artifact tree. Then one
    view again with ``--relight_fast_vis 1``. Seconds per view and of the
    G-buffer pass, chunks per view and light, tiles and K1/K2 launches per
    chunk (K2 must stay 0), the kept share of the (point, light sample)
    pairs (each chunk marches ceil(kept / 16384) tiles), peak memory, the
    HDR decode seconds per probe, PSNR/SSIM per light (sanity numbers: the
    ground truth is rendered under 16 x 32 copies of the probes); then
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
    kept_share, fails = _vis_pack_check(chunks, cfg.secondary_tile,
                                        want_tiles)
    bench_s = timing.get("benchmark_s", [float("nan")])[0]
    res = {"phase": "relight", "views": RELIGHT_VIEWS,
           "view": [RELIGHT_WH, RELIGHT_WH], "lights": list(RELIGHT_LIGHTS),
           "scene_write_s": write_s, "hdr_decode_s": decode_s,
           "wall_s": wall_s, "benchmark_s": bench_s,
           "seconds_per_view": bench_s / RELIGHT_VIEWS,
           "gbuf_pass_s": timing.get("gbuf_pass_s", [None])[0],
           "chunks_per_view_per_light": per_light,
           "chunks": stats, "launches": launches,
           "kept_share": kept_share,
           "launches_by_shape": by_shape(shapes, max(rel.get("chunks", 1),
                                                     1)),
           "projected_800_view_s": (800 * 800 // cfg.batch_size
                                    * len(RELIGHT_LIGHTS)
                                    * rel.get("median_ms", float("nan"))
                                    / 1e3),
           "peak_mem_gb": peak, "metrics": results, "files": len(files)}
    if rel.get("chunks") != per_light * len(RELIGHT_LIGHTS) * RELIGHT_VIEWS:
        fails.append(f"{rel.get('chunks')} relight chunks, not "
                     f"{per_light * len(RELIGHT_LIGHTS) * RELIGHT_VIEWS}")
    if not (launches["row_gather"] > 0 and launches["row_gather_bf16"] > 0):
        fails.append(f"K1 not launched in the relight run: {launches}")
    if not launches["line_taps"] > 0:
        fails.append(f"the line taps not launched in the relight run: "
                     f"{launches}")
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
    kept_share_f, fails = _vis_pack_check(chunks_f, cfg.secondary_tile,
                                          want_tiles)
    bench_f = timing_f.get("benchmark_s", [float("nan")])[0]
    res_f = {"phase": "relight_fast_vis", "views": 1, "wall_s": wall_f,
             "seconds_per_view": bench_f,
             "gbuf_pass_s": timing_f.get("gbuf_pass_s", [None])[0],
             "chunks": stats_f, "launches": launches_f,
             "kept_share": kept_share_f,
             "launches_by_shape": by_shape(
                 fast_shapes, max(stats_f.get("relight", {}).get("chunks", 1),
                                  1)),
             "metrics": results_f,
             "psnr_minus_exact": {k: results_f[k]["psnr"] - v["psnr"]
                                  for k, v in results.items()
                                  if k in results_f}}
    if launches_f["row_scatter_add"] != 0 or not (
            launches_f["row_gather_bf16"] > 0 and launches_f["line_taps"] > 0):
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


# the multi-light configs with the scene writer's lights for each, and the
# multi-light runs' depth: three training views of 800 x 800 per light and
# one test view of 100 x 100 (cli_run's 200 x 200 cut to a quarter: three
# lights are evaluated), MULTI_RADIANCE radiance iterations, then one mask
# with the shrink, one upsample to 300^3 three iterations later and
# MULTI_RELIGHT relight iterations
MULTI_CONFIGS = {
    "rotated": (ROOT / "configs" / "multi_light_rotated" / "armadillo.txt",
                dict(rotations=("000", "120", "240"))),
    "general": (ROOT / "configs" / "multi_light_general" / "armadillo.txt",
                dict(light_names=("sunset", "snow", "courtyard"))),
}
MULTI_VIEWS = (("train", 3, 800), ("test", 1, 100))
MULTI_RADIANCE = 100
MULTI_RELIGHT = 8


def phase_multilight_step_parity():
    """One deterministic relight step of each multi-light config (rotated:
    one SG set under three rotations; general: three SG sets) at a reduced
    size (grid 48, 128 samples, 256 rays going round the three lights, 64
    relit, 8x16 light directions, tile 4096, the pair cap lifted), card
    (kernels) vs CPU (plain versions), from the same masked field made on
    the CPU: loss 1e-4 relative and every gradient 1e-3 relative in the L2
    norm, light_line and lgt_sgs included, as relight_step_parity holds its
    lifted variant (and for the same reasons)."""
    from tensoir_tpu_torch import config as C
    loss_tol, grad_tol = 1e-4, 1e-3
    reso, n_samples, n_rays = (48, 48, 48), 128, 256
    knobs = dict(relight_ray_cap=64, secondary_tile=4096, march_cap=64,
                 app_pair_frac=1.0)
    res, fails = {}, []
    for setting, (config, _) in MULTI_CONFIGS.items():
        cfg = C.load_config(str(config))
        fcfg = dataclasses.replace(C.field_config_from(cfg, NEAR_FAR),
                                   envmap_h=8, envmap_w=16)
        params0, scene0 = masked_field(fcfg, reso, seed=3, device="cpu")
        runs = {dev: _step_on(
            dev, params0, scene0,
            lambda d: make_step(fcfg, cfg, n_samples, True, d, relight=True,
                                **knobs),
            n_rays, cfg.update_AlphaMask_list[0], lambda p, s: [],
            lights=fcfg.light_num) for dev in ("cuda", "cpu")}
        (l_gpu, n_acc, _, g_gpu, _), (l_cpu, _, _, g_cpu, _) = (
            runs["cuda"], runs["cpu"])
        rel = abs(l_gpu - l_cpu) / abs(l_cpu)
        g_rel = _grad_rel_err(g_gpu, g_cpu)
        per_light = g_cpu["light_line"].abs().sum(1)
        res[setting] = {
            "light_num": fcfg.light_num, "per_light_sg": fcfg.per_light_sg,
            "light_rotations": list(fcfg.light_rotations),
            "lgt_sgs_shape": list(g_cpu["lgt_sgs"].shape),
            "loss_cuda": l_gpu, "loss_cpu": l_cpu, "loss_rel_err": rel,
            "n_acc_masked": n_acc, "grad_rel_err_max": max(g_rel.values()),
            "worst_grad": max(g_rel, key=g_rel.get),
            "grad_rel_err_light": {k: g_rel[k]
                                   for k in ("light_line", "lgt_sgs")}}
        if not (math.isfinite(l_gpu) and rel <= loss_tol):
            fails.append(f"{setting} loss {l_gpu} vs {l_cpu}: {rel}")
        over = {k: v for k, v in g_rel.items() if v > grad_tol}
        if over:
            fails.append(f"{setting} gradients over {grad_tol}: {over}")
        if per_light.shape != (3,) or not bool((per_light > 0).all()):
            fails.append(f"{setting}: a light row without gradient "
                         f"{per_light.tolist()}")
        if fcfg.per_light_sg and tuple(g_cpu["lgt_sgs"].shape[:1]) != (3,):
            fails.append(f"{setting}: lgt_sgs {g_cpu['lgt_sgs'].shape}")
    emit({"phase": "multilight_step_parity", "ok": not fails, "fails": fails,
          "settings": res, "reso": list(reso), "n_rays": n_rays,
          "tol": {"loss_rel": loss_tol, "grad_rel_l2": grad_tol}})
    check(not fails, "multilight_step_parity: " + "; ".join(fails))


def phase_multilight_cli():
    """The port's CLI, in this process, on each multi-light config at full
    width (VM 16/48, 128 SGs per set, batch 4096, 128^3 -> 300^3) on the
    shadow scene written for that config's loader (MULTI_VIEWS, three
    lights): MULTI_RADIANCE radiance iterations, the mask with the shrink,
    the upsample to 300^3, MULTI_RELIGHT relight iterations, ckpt_final and
    the final render_test (per light in the general setting, as the CLI
    does; in the rotated setting the CLI evaluates light 0 and lights 1 and
    2 are evaluated here from ckpt_final with the CLI's eval settings).
    Launch counts from 0 before each run to the end of its evals; every
    row kernel must launch, every event happen at its iteration, every PSNR be
    finite. Returns (launch counts per path, launches by shape)."""
    import torch
    from tensoir_tpu_torch import train_tensoir
    from tensoir_tpu_torch.data.synthetic import write_shadow_scene
    from tensoir_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from tensoir_tpu_torch.models.field import grid_size_of
    from tensoir_tpu_torch.models.lifecycle import cal_n_samples
    from tensoir_tpu_torch.render.eval import evaluation_iter
    from tensoir_tpu_torch.train import loop
    from tensoir_tpu_torch.utils.ckpt import load_checkpoint
    n_iters = MULTI_RADIANCE + 3 + MULTI_RELIGHT
    launches, shapes, fails = {}, {}, []
    for setting, (config, lights) in MULTI_CONFIGS.items():
        path = f"multilight_{setting}"
        with tempfile.TemporaryDirectory() as tmp:
            data, hdr, logs = (os.path.join(tmp, d) for d in ("scene", "hdr",
                                                               "log"))
            t0 = time.perf_counter()
            write_shadow_scene(data, hdr, views=MULTI_VIEWS, **lights)
            write_s = time.perf_counter() - t0
            argv = ["--config", str(config), "--datadir", data, "--hdrdir",
                    hdr, "--basedir", logs, "--n_iters", str(n_iters),
                    "--update_AlphaMask_list", f"[{MULTI_RADIANCE}]",
                    "--upsamp_list", f"[{MULTI_RADIANCE + 3}]",
                    "--N_vis", "0", "--test_number", "1"]
            log = {"events": [], "steps": []}
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            with _run_probe(loop, log), kernel_calls(path, shapes), \
                    contextlib.redirect_stdout(sys.stderr):
                results = train_tensoir.main(argv)
                torch.cuda.synchronize()
                run_s = time.perf_counter() - t0
                psnr = {}
                for key, r in results.items():
                    li = int(key[-1]) if key[-1].isdigit() else 0
                    psnr[li] = (r["psnr_nvs"], r["psnr_nvs_brdf"])
                t1 = time.perf_counter()
                if setting == "rotated":
                    cfg = train_tensoir.parse_cli(argv)
                    fcfg, params, scene, _ = load_checkpoint(os.path.join(
                        logs, cfg.expname, "ckpt_final.npz"))
                    n_samples = min(cfg.nSamples, cal_n_samples(
                        grid_size_of(params), cfg.step_ratio))
                    test = train_tensoir.build_dataset(cfg, "test")
                    for li in (1, 2):
                        r = evaluation_iter(
                            fcfg, params, scene, test, n_samples=n_samples,
                            test_all=True, light_idx_to_test=li,
                            **train_tensoir._eval_kw(cfg))
                        psnr[li] = (r["psnr_nvs"], r["psnr_nvs_brdf"])
                torch.cuda.synchronize()
                extra_eval_s = time.perf_counter() - t1
            launches[path] = dict(LAUNCHES)
        segs = _segments(log["steps"])
        res = {"phase": "multilight_cli", "setting": setting,
               "config": str(config.relative_to(ROOT)),
               "views": [list(v) for v in MULTI_VIEWS], "n_iters": n_iters,
               "scene_write_s": write_s, "run_s": run_s,
               "extra_light_evals_s": extra_eval_s, "segments": segs,
               "events": [e for e in log["events"]
                          if e["event"] != "rebuild"],
               "psnr_nvs_by_light": [psnr.get(li, (None,))[0]
                                     for li in range(3)],
               "psnr_nvs_brdf_by_light": [psnr.get(li, (None, None))[1]
                                          for li in range(3)],
               "results": results, "launches": launches[path],
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
        mine = []
        if sorted(psnr) != [0, 1, 2] or not all(
                math.isfinite(x) for v in psnr.values() for x in v):
            mine.append(f"PSNR per light {psnr}")
        if not all(launches[path][k] > 0 for k in ROW_KERNELS):
            mine.append(f"a kernel was not launched: {launches[path]}")
        for name, its in (("update_alpha_mask", [MULTI_RADIANCE]),
                          ("shrink", [MULTI_RADIANCE]),
                          ("upsample", [MULTI_RADIANCE + 3])):
            got = [e["it"] for e in log["events"] if e["event"] == name]
            if got != its:
                mine.append(f"{name} at {got}, not {its}")
        phases = [seg["phase"] for seg in segs]
        if phases[:1] != ["radiance"] or phases[-1:] != ["relight"]:
            mine.append(f"step phases {phases}")
        res["ok"] = not mine
        emit(res)
        fails += [f"{setting}: {f}" for f in mine]
    check(not fails, "multilight_cli: " + "; ".join(fails))
    return launches, shapes


# the model variants: the field and step knobs of each variant
# the parity phase runs, as (FieldConfig overrides, StepStatic overrides)
VARIANT_RADIANCE = {
    "cp": (dict(decomp="cp"), {}),
    "vm_stacked": (dict(decomp="vm_stacked"), {}),
    "MLP_PE": (dict(shading_mode="MLP_PE"), {}),
    "MLP": (dict(shading_mode="MLP"), {}),
    "SH": (dict(shading_mode="SH", app_dim=27), {}),
    "RGB": (dict(shading_mode="RGB", app_dim=3), {}),
    "bf16": (dict(compute_dtype="bfloat16"), {}),
    "ndc": ({}, dict(ndc_ray=True)),
}
VARIANT_RELIGHT = {
    "cp": (dict(decomp="cp"), {}),
    "vm_stacked": (dict(decomp="vm_stacked"), {}),
    "residue_prediction": (dict(normals_kind="residue_prediction"), {}),
    "gt_normals": (dict(normals_kind="gt_normals"), {}),
    "importance_sample": ({}, dict(sample_method="importance_sample")),
    "stratifed_sample_equal_areas": (
        {}, dict(sample_method="stratifed_sample_equal_areas")),
    "bf16": (dict(compute_dtype="bfloat16"), {}),
    "ndc": ({}, dict(ndc_ray=True)),
}
# TensoRF's published TensorCP widths (its README: --model_name TensorCP
# --n_lamb_sigma [96] --n_lamb_sh [288]), per axis as the JAX package reads
# them
CP_WIDTHS = dict(density_n_comp=(96, 96, 96), app_n_comp=(288, 288, 288))
# the full-width relight steps of variants_train: (FieldConfig overrides,
# StepStatic overrides) on relight_train's 158^3 grid
VARIANT_TRAIN = {
    "cp": (dict(decomp="cp", **CP_WIDTHS), {}),
    "vm_stacked": (dict(decomp="vm_stacked"), {}),
    "importance": ({}, dict(sample_method="importance_sample")),
    "bf16": (dict(compute_dtype="bfloat16"), {}),
}
# the CLI's --model_name of each decomposition
DECOMP_OF = {"TensorCP": "cp", "TensorVM": "vm_stacked"}
VARIANT_TRAIN_STEPS = 5
VARIANT_CLI_VIEWS = (("train", 2, 800), ("test", 1, 200))
VARIANT_CLI_RADIANCE = 80
VARIANT_CLI_MODELS = {
    "TensorCP": ["--n_lamb_sigma", "[96,96,96]", "--n_lamb_sh",
                 "[288,288,288]"],
    "TensorVM": [],
}


@contextlib.contextmanager
def _replayed_light_dirs(dirs_pdf):
    """``brdf_render.incident_light_dirs`` handing out the CPU-made
    (dirs [L, 3], pdf [L, 1] or None) on the caller's device, so that a
    step on the card and one on the CPU integrate over the same sampled
    directions."""
    from tensoir_tpu_torch.render import brdf_render
    real = brdf_render.incident_light_dirs
    dirs, pdf = dirs_pdf

    def replay(cfg, sample_method, key, params=None, gt_envmap=None,
               device=None):
        return dirs.to(device), None if pdf is None else pdf.to(device)

    brdf_render.incident_light_dirs = replay
    try:
        yield
    finally:
        brdf_render.incident_light_dirs = real


def _sampler_agreement(fcfg, params0) -> dict:
    """The importance sampler of the learned light on the card against the
    CPU, from the same CPU-drawn uniforms (a 128 x 256 jittered grid, then
    one draw per direction): the share of draws that pick the same texel,
    and for the others how far the uniform lay from a step of the CPU's
    CDF (a rounding of the tables apart, it must be within 1e-6)."""
    import torch
    from tensoir_tpu_torch.models import lighting
    n = fcfg.envmap_h * fcfg.envmap_w
    out = {}
    for dev in ("cuda", "cpu"):
        light = {"lgt_sgs": params0["lgt_sgs"].to(dev)}
        d, _, pdf = lighting.gen_light_incident_dirs_importance(
            light, fcfg, torch.Generator().manual_seed(21), n)
        out[dev] = (d.cpu(), pdf.cpu())
    gen = torch.Generator().manual_seed(21)
    u_jit = [torch.rand((128, 256), generator=gen) for _ in range(2)]
    u = torch.rand((n,), generator=gen)
    env = lighting.get_light_rgbs(
        {"lgt_sgs": params0["lgt_sgs"]}, fcfg,
        lighting.stratified_dirs(None, 128, 256, draws=u_jit))[0]
    sin_t = np.sin(np.linspace(0.5 / 128, np.pi - 0.5 / 128, 128))
    pdf = env.double().sum(-1).reshape(128, 256).numpy() * sin_t[:, None]
    cdf = np.cumsum(pdf / pdf.sum())
    same = (out["cuda"][0] - out["cpu"][0]).abs().amax(-1) < 1e-5
    gaps = [float(np.abs(cdf - float(u[i])).min())
            for i in torch.nonzero(~same).flatten().tolist()]
    return {"draws": n, "same_texel_share": float(same.float().mean()),
            "flip_uniform_to_cdf_step_max": max(gaps, default=0.0),
            "pdf_max_rel_err": float(
                ((out["cuda"][1] - out["cpu"][1]).abs()[same]
                 / out["cpu"][1][same]).max())}


def phase_variants_step_parity():
    """One deterministic radiance step of each variant of VARIANT_RADIANCE
    and one relight step of each of VARIANT_RELIGHT at a reduced size
    (grid 48, 128 samples, 256 rays, 64 relit, 8x16 light directions, tile
    4096, the pair cap lifted), card (kernels) vs CPU (plain versions),
    from the same blob field made on the CPU (masked for the relight
    steps). The importance and equal-area steps integrate over directions
    drawn once on the CPU with their own sampler and handed to both;
    gt_normals reads the same random normals on both. Tolerances: loss
    1e-4 relative and every gradient 1e-3 relative in the L2 norm, as
    relight_step_parity holds its lifted variant; bf16 loss 1e-3 and
    gradients 1e-2: each device rounds its own f32 operands, which differ
    in their last bits, to bf16, so a few round to neighbouring bf16
    values (7.8e-3 apart relative). Also the importance sampler itself on
    the card against the CPU (_sampler_agreement): at least 99 % of the
    draws on the same texel, the others within 1e-6 of a CDF step."""
    import torch
    from tensoir_tpu_torch import config as C
    from tensoir_tpu_torch.render.brdf_render import incident_light_dirs
    cfg, _, _ = slice_sizes()
    base = dataclasses.replace(C.field_config_from(cfg, NEAR_FAR),
                               envmap_h=8, envmap_w=16)
    reso, n_samples, n_rays = (48, 48, 48), 128, 256
    relight_knobs = dict(relight_ray_cap=64, secondary_tile=4096,
                         march_cap=64, app_pair_frac=1.0)
    res, fails, sampler = {}, [], None
    cases = [("radiance", k, v) for k, v in VARIANT_RADIANCE.items()] + [
        ("relight", k, v) for k, v in VARIANT_RELIGHT.items()]
    for phase, name, (f_kw, st_kw) in cases:
        relight = phase == "relight"
        fcfg = dataclasses.replace(base, **f_kw)
        if relight:
            params0, scene0 = masked_field(fcfg, reso, seed=5, device="cpu")
        else:
            params0, scene0 = field(fcfg, reso, seed=5, device="cpu")
        extra, dirs_pdf = None, None
        if fcfg.normals_kind == "gt_normals":
            n = torch.randn((n_rays, 3), generator=torch.Generator()
                            .manual_seed(6))
            extra = {"normal_gt": n / n.norm(dim=-1, keepdim=True)}
        method = st_kw.get("sample_method")
        if method is not None:
            dirs_pdf = incident_light_dirs(
                fcfg, method, torch.Generator().manual_seed(7),
                params=params0, device="cpu")
            if method == "importance_sample":
                sampler = _sampler_agreement(fcfg, params0)
        knobs = dict(st_kw, **relight_knobs) if relight else st_kw
        runs = {}
        for dev in ("cuda", "cpu"):
            with (_replayed_light_dirs(dirs_pdf) if dirs_pdf is not None
                  else contextlib.nullcontext()):
                runs[dev] = _step_on(
                    dev, params0, scene0,
                    lambda d: make_step(fcfg, cfg, n_samples, True, d,
                                        relight=relight, **knobs),
                    n_rays, cfg.update_AlphaMask_list[0] if relight else 0,
                    lambda p, s: [], extra=extra)
        (l_gpu, n_acc, _, g_gpu, _), (l_cpu, _, _, g_cpu, _) = (
            runs["cuda"], runs["cpu"])
        bf16 = fcfg.compute_dtype == "bfloat16"
        loss_tol, grad_tol = (1e-3, 1e-2) if bf16 else (1e-4, 1e-3)
        rel = abs(l_gpu - l_cpu) / abs(l_cpu)
        g_rel = _grad_rel_err(g_gpu, g_cpu)
        key = f"{phase}/{name}"
        res[key] = {"loss_cuda": l_gpu, "loss_cpu": l_cpu,
                    "loss_rel_err": rel, "n_acc_masked": n_acc,
                    "grad_rel_err_max": max(g_rel.values()),
                    "worst_grad": max(g_rel, key=g_rel.get),
                    "tol": {"loss_rel": loss_tol, "grad_rel_l2": grad_tol}}
        if not (math.isfinite(l_gpu) and rel <= loss_tol):
            fails.append(f"{key} loss {l_gpu} vs {l_cpu}: {rel}")
        over = {k: v for k, v in g_rel.items() if v > grad_tol}
        if over:
            fails.append(f"{key} gradients over {grad_tol}: {over}")
        if relight and not 0 < n_acc < n_rays:
            fails.append(f"{key}: {n_acc} of {n_rays} rays relit")
    if sampler is None or sampler["same_texel_share"] < 0.99 or \
            sampler["flip_uniform_to_cdf_step_max"] > 1e-6:
        fails.append(f"importance sampler card vs CPU: {sampler}")
    emit({"phase": "variants_step_parity", "ok": not fails, "fails": fails,
          "variants": res, "importance_sampler": sampler,
          "reso": list(reso), "n_rays": n_rays})
    check(not fails, "variants_step_parity: " + "; ".join(fails))


def phase_variants_train():
    """The relight step at full width on relight_train's grid (158^3, 547
    samples, march cap 192, 1024 relit rays, 16x32 light directions, tiles
    of 16384) for each of VARIANT_TRAIN: TensorCP at TensoRF's published
    widths (96/288 per axis), the stacked TensorVM at armadillo's 16/48,
    and the default VM with importance-sampled light directions and with
    bf16 compute; each on the blob masked by update_alpha_mask, 2 warm-up
    steps, VARIANT_TRAIN_STEPS timed steps (launch counts zeroed just
    before them, and by shape), the peak memory from the warm-up on, then
    one profiled step (device-busy ms). CP must launch K1-bf16 (its baked
    sigma grid and alpha mask; it has no plane gather, so no K1-f32 and no
    K2), the others all three kernels. Launches are kept per decomposition
    (paths variants_train_cp, _vm_stacked and _vm, the last the importance
    and bf16 steps together). Returns (launch counts per path, launches by
    shape)."""
    import torch
    from tensoir_tpu_torch import config as C
    from tensoir_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    cfg, _, _ = slice_sizes()
    n_vox, reso, n_samples = relight_sizes(cfg)
    launches, shapes, fails = {}, {}, []
    for name, (f_kw, st_kw) in VARIANT_TRAIN.items():
        fcfg = dataclasses.replace(C.field_config_from(cfg, NEAR_FAR), **f_kw)
        path = f"variants_train_{fcfg.decomp}"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, scene = masked_field(fcfg, reso, seed=0, device="cuda")
        torch.cuda.synchronize()
        mask_s = time.perf_counter() - t0
        opt, step_fn = make_step(fcfg, cfg, n_samples, False, "cuda",
                                 relight=True, **st_kw)
        state = opt.init(params)
        batch = batch_of(BATCH, "cuda")
        key = torch.Generator(device="cuda").manual_seed(1)
        it = cfg.update_AlphaMask_list[0]
        for _ in range(2):
            params, state, m = step_fn(params, state, scene, batch, key, it)
            it += 1
        torch.cuda.synchronize()
        mets, counts = [], {}
        reset_launch_counts()
        t0 = time.perf_counter()
        with kernel_calls(path, counts):
            for _ in range(VARIANT_TRAIN_STEPS):
                params, state, m = step_fn(params, state, scene, batch, key,
                                           it)
                mets.append(m)
                it += 1
            torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / VARIANT_TRAIN_STEPS * 1e3
        mine_launches = dict(LAUNCHES)
        launches[path] = {k: v + launches.get(path, {}).get(k, 0)
                          for k, v in mine_launches.items()}
        for k, n in counts.items():
            shapes[k] = shapes.get(k, 0) + n
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = [float(x["total_loss"]) for x in mets]
        brk = emit_breakdown(f"{path}_breakdown", lambda: step_fn(
            params, state, scene, batch, key, it), step_ms)
        res = {"phase": "variants_train", "variant": name,
               "decomp": fcfg.decomp, "density_n_comp":
               list(fcfg.density_n_comp), "app_n_comp": list(fcfg.app_n_comp),
               "compute_dtype": fcfg.compute_dtype,
               "sample_method": st_kw.get("sample_method",
                                          cfg.light_sample_train),
               "grid": list(reso), "n_samples": n_samples, "batch": BATCH,
               "n_params": sum(v.numel() for k, v in params.items()
                               if isinstance(v, torch.Tensor)),
               "alpha_mask_s": mask_s, "step_ms": step_ms,
               "device_busy_ms": brk.get("device_busy_ms"),
               "idle_share": brk.get("idle_share"), "losses": losses,
               "n_acc_masked": float(mets[-1]["n_acc_masked"]),
               "launches": mine_launches,
               "launches_by_shape": by_shape(counts, VARIANT_TRAIN_STEPS),
               "peak_mem_gb": peak}
        want = (("row_gather_bf16",) if fcfg.decomp == "cp"
                else ROW_KERNELS)
        mine = []
        if not all(math.isfinite(x) for x in losses):
            mine.append(f"non-finite loss {losses}")
        if not all(mine_launches[k] > 0 for k in want):
            mine.append(f"a kernel of the path was not launched: "
                        f"{mine_launches}")
        res["ok"] = not mine
        emit(res)
        fails += [f"{name}: {f}" for f in mine]
        del params, state, scene, opt, step_fn, m, mets
        torch.cuda.empty_cache()
    check(not fails, "variants_train: " + "; ".join(fails))
    return launches, shapes


def phase_variants_cli():
    """``python -m tensoir_tpu_torch.train_tensoir`` on
    configs/single_light/armadillo.txt, in this process, with
    ``--model_name TensorCP`` at TensoRF's published widths (96/288 per
    axis) and then ``--model_name TensorVM`` (armadillo's 16/48), on one
    rotated-lights scene written to a temporary directory
    (VARIANT_CLI_VIEWS): VARIANT_CLI_RADIANCE radiance iterations, the
    mask with the shrink, the upsample to 300^3 three iterations later,
    relight iterations to VARIANT_CLI_RADIANCE + 8, ckpt_final and the
    final render_test of the 200 x 200 view; then render-only from
    ckpt_final, whose metrics must equal the run's bit for bit. Launch
    counts from 0 before each run to the end of its render-only run; CP
    must launch K1-bf16, TensorVM every row kernel. Returns (launch counts per
    path, launches by shape)."""
    import torch
    from tensoir_tpu_torch import train_tensoir
    from tensoir_tpu_torch.data.synthetic import write_shadow_scene
    from tensoir_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from tensoir_tpu_torch.train import loop
    from tensoir_tpu_torch.utils.ckpt import load_checkpoint
    n_iters = VARIANT_CLI_RADIANCE + 8
    launches, shapes, fails = {}, {}, []
    with tempfile.TemporaryDirectory() as tmp:
        data, hdr = os.path.join(tmp, "scene"), os.path.join(tmp, "hdr")
        t0 = time.perf_counter()
        write_shadow_scene(data, hdr, views=VARIANT_CLI_VIEWS)
        write_s = time.perf_counter() - t0
        for model, widths in VARIANT_CLI_MODELS.items():
            logs = os.path.join(tmp, model)
            argv = ["--config", str(CONFIG), "--datadir", data, "--hdrdir",
                    hdr, "--basedir", logs, "--model_name", model, *widths,
                    "--n_iters", str(n_iters), "--update_AlphaMask_list",
                    f"[{VARIANT_CLI_RADIANCE}]", "--upsamp_list",
                    f"[{VARIANT_CLI_RADIANCE + 3}]", "--N_vis", "0",
                    "--test_number", "1"]
            path = f"variants_cli_{DECOMP_OF[model]}"
            log = {"events": [], "steps": []}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.perf_counter()
            with _run_probe(loop, log), contextlib.redirect_stdout(
                    sys.stderr):
                with kernel_calls(path, shapes):
                    trained = train_tensoir.main(argv)
                    torch.cuda.synchronize()
                    run_s = time.perf_counter() - t0
                    ckpt = os.path.join(logs, "armadillo",
                                        "ckpt_final.npz")
                    fcfg, params, _, _ = load_checkpoint(ckpt)
                    t1 = time.perf_counter()
                    again = train_tensoir.main(argv + [
                        "--render_only", "1", "--render_test", "1",
                        "--ckpt", ckpt])
                    torch.cuda.synchronize()
                    render_only_s = time.perf_counter() - t1
            decomp = fcfg.decomp
            launches[path] = dict(LAUNCHES)
            segs = _segments(log["steps"])
            final = trained.get("imgs_test_all")
            res = {"phase": "variants_cli", "model_name": model,
                   "decomp": decomp, "widths": widths,
                   "factors": {k: list(v.shape) for k, v in params.items()
                               if k.startswith(("density", "app", "stack"))},
                   "views": [list(v) for v in VARIANT_CLI_VIEWS],
                   "n_iters": n_iters, "scene_write_s": write_s,
                   "run_s": run_s, "render_only_s": render_only_s,
                   "segments": segs,
                   "events": [e for e in log["events"]
                              if e["event"] != "rebuild"],
                   "final_render_test": final,
                   "render_only_test": again.get("imgs_test_all"),
                   "launches": launches[path],
                   "peak_mem_gb": torch.cuda.max_memory_allocated()
                   / 2 ** 30}
            mine = []
            if decomp != DECOMP_OF[model]:
                mine.append(f"checkpoint decomposition {decomp}")
            if final is None or final != again.get("imgs_test_all"):
                mine.append(f"render-only metrics {res['render_only_test']}"
                            f" differ from the run's {final}")
            elif not math.isfinite(final["psnr_nvs_brdf"]):
                mine.append(f"metrics {final}")
            for name, its in (("update_alpha_mask", [VARIANT_CLI_RADIANCE]),
                              ("shrink", [VARIANT_CLI_RADIANCE]),
                              ("upsample", [VARIANT_CLI_RADIANCE + 3])):
                got = [e["it"] for e in log["events"] if e["event"] == name]
                if got != its:
                    mine.append(f"{name} at {got}, not {its}")
            want = (("row_gather_bf16",) if decomp == "cp"
                    else ROW_KERNELS)
            if not all(launches[path][k] > 0 for k in want):
                mine.append(f"a kernel of the path was not launched: "
                            f"{launches[path]}")
            res["ok"] = not mine
            emit(res)
            fails += [f"{model}: {f}" for f in mine]
    check(not fails, "variants_cli: " + "; ".join(fails))
    return launches, shapes


# the grouped knobs (slice j), each against the ungrouped step: (name,
# StepStatic overrides). bench.py's step at full width runs them with its
# own sizes (window 48/16, bake 128, app bake 64): a pair of samples spans
# 0.0153 of the 0.0236 cell of the 128 bake, four span 0.0458 of the 0.0476
# cell of the 64 bake; all together is ablate_group.py's g4_gb64_ab64_pg4
# with the hoist
GROUPED_KNOBS = (
    ("march_group_2", dict(march_group=2)),
    ("march_group_4", dict(march_group=4)),
    ("second_march_group_2", dict(second_march_group=2)),
    ("second_march_group_4_gb64", dict(second_march_group=4,
                                       group_bake_reso=64)),
    ("secondary_app_hoist", dict(secondary_app_hoist=True)),
    ("all", dict(march_group=4, second_march_group=4, group_bake_reso=64,
                 secondary_app_hoist=True)))
GROUPED_TRAIN_STEPS = 3
# grouped_step_parity's sizes differ: 24 secondary samples (a pair spans
# 0.063 of the 32 bake's 0.097 cell), so four need a bake of 16 (cell 0.2)
GROUPED_PARITY_BAKE = 16
GROUPED_CLI_VIEWS = (("train", 2, 800), ("test", 1, 200))
GROUPED_CLI_RADIANCE = 80
# the CLI's grouped flags, and bench.py's fast knobs with the eval's
# prepass (12: the shrunk box keeps the march's contract), without which
# the secondary march has no window to group
GROUPED_CLI_FLAGS = ["--march_group", "4", "--second_march_group", "4",
                     "--group_bake_reso", "64", "--secondary_app_hoist", "1",
                     "--second_window", "48", "--second_window_back", "16",
                     "--second_prepass_n", "12", "--coarse_dilate", "3",
                     "--secondary_compact_frac", "0.5625",
                     "--secondary_bake_reso", "128", "--app_bake_reso", "64"]


def phase_grouped_step_parity():
    """One deterministic step of bench.py's configuration at its CPU sizes
    (grid 48, 256 rays, 4x8 directions, window 12/4, tile 1024, bake 32,
    app bake 32) with 24 secondary samples and a march cap of 32 (below the
    64 samples, so that the grouped primary selection runs), the pair cap
    lifted, for each grouped knob of GROUPED_KNOBS (the 4-sample secondary
    group on a bake of GROUPED_PARITY_BAKE), card (kernels) vs CPU (plain
    versions) from the same masked field made on the CPU. Tolerances:
    those of variants_step_parity (loss 1e-4 relative, every gradient 1e-3
    relative in the L2 norm)."""
    loss_tol, grad_tol = 1e-4, 1e-3
    fcfg, st, w, sizes = bench_setup(full=False)
    st = dict(st, secondary_bake_reso=32, second_n_sample=24, march_cap=32,
              app_pair_frac=1.0, deterministic=True)
    params0, scene0 = bench_field(fcfg, sizes, seed=6, device="cpu")
    res, fails = {}, []
    for name, knobs in GROUPED_KNOBS:
        if knobs.get("group_bake_reso"):
            knobs = dict(knobs, group_bake_reso=GROUPED_PARITY_BAKE)
        runs = {dev: _step_on(dev, params0, scene0,
                              lambda d: make_bench_step(fcfg, st, w, d,
                                                        **knobs),
                              sizes["B"], 0, lambda p, s: [])
                for dev in ("cuda", "cpu")}
        (l_gpu, n_acc, _, g_gpu, _), (l_cpu, _, _, g_cpu, _) = (
            runs["cuda"], runs["cpu"])
        rel = abs(l_gpu - l_cpu) / abs(l_cpu)
        g_rel = _grad_rel_err(g_gpu, g_cpu)
        res[name] = {"knobs": knobs, "loss_cuda": l_gpu, "loss_cpu": l_cpu,
                     "loss_rel_err": rel, "n_acc_masked": n_acc,
                     "grad_rel_err_max": max(g_rel.values()),
                     "worst_grad": max(g_rel, key=g_rel.get)}
        if not (math.isfinite(l_gpu) and rel <= loss_tol):
            fails.append(f"{name} loss {l_gpu} vs {l_cpu}: {rel}")
        over = {k: v for k, v in g_rel.items() if v > grad_tol}
        if over:
            fails.append(f"{name} gradients over {grad_tol}: {over}")
    emit({"phase": "grouped_step_parity", "ok": not fails, "fails": fails,
          "variants": res, "grid": sizes["grid"], "n_rays": sizes["B"],
          "tol": {"loss_rel": loss_tol, "grad_rel_l2": grad_tol}})
    check(not fails, "grouped_step_parity: " + "; ".join(fails))


def phase_grouped_train():
    """bench.py's step at full width (bench_setup(full=True): grid 200^3,
    700 samples, march cap 192, 4096 relit rays, window 48/16, 36 tiles of
    32768, bake 128, app bake 64), deterministic, in one process, without a
    grouped knob and then with each of GROUPED_KNOBS, every one from a copy
    of the same masked field: the first step's loss beside the ungrouped
    one's and its march_overflow_frac, 2 warm-up steps, GROUPED_TRAIN_STEPS
    timed steps (launch counts zeroed just before them, and by shape), the
    peak memory, one profiled step (device-busy ms). The secondary
    grouping on the step's own bake and the hoist must give the ungrouped
    loss within 1e-4 relative (grouped equals ungrouped up to the order of
    sums); a primary grouping must where neither march overflows its cap;
    a grouping on a 27-corner pack baked coarser (group_bake_reso 64
    against the 128 of the 8-corner pack) reads another proxy of the field,
    and it and an overflowing primary grouping are reported, not held.
    Every grouped step must launch the 16-corner block rows (K1-f32 and K2,
    with march_group) or the 27-corner rows (K1-bf16, with
    second_march_group) at their shapes. Returns (launch counts of the
    grouped steps, launches by shape)."""
    import torch
    from tensoir_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from tensoir_tpu_torch.models import field as F
    fcfg, st, w, sizes = bench_setup(full=True)
    st = dict(st, deterministic=True)
    B, g200 = sizes["B"], sizes["grid"]
    params0, scene0 = bench_field(fcfg, sizes, seed=0, device="cuda")
    contracts = {g: F.check_pair_contract(
        AABB, (reso - 2,) * 3 + (F.PAIR_ROW,), n_sample=st["second_n_sample"],
        group=g) for g, reso in ((2, st["secondary_bake_reso"]), (4, 64))}
    batch = batch_of(B, "cuda")
    total, shapes, fails, base = {}, {}, [], None
    # the ungrouped step first and again last: the host's clock drifts
    # within a run (PERF.md), and the two bracket the grouped steps' times
    for name, knobs in (("ungrouped", {}),) + GROUPED_KNOBS + (
            ("ungrouped_again", {}),):
        params, scene = _to(params0, "cuda"), _to(scene0, "cuda")
        opt, step_fn = make_bench_step(fcfg, st, w, "cuda", **knobs)
        state = opt.init(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        params, state, m0 = step_fn(params, state, scene, batch, None, 10000)
        first = {"loss": float(m0["total_loss"]),
                 "march_overflow_frac": float(m0["march_overflow_frac"])}
        it = 10001
        params, state, m = step_fn(params, state, scene, batch, None, it)
        it += 1
        torch.cuda.synchronize()
        counts = {}
        path = "grouped_train" if knobs else "grouped_train_ungrouped"
        reset_launch_counts()
        t0 = time.perf_counter()
        with kernel_calls(path, counts):
            for _ in range(GROUPED_TRAIN_STEPS):
                params, state, m = step_fn(params, state, scene, batch, None,
                                           it)
                it += 1
            torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / GROUPED_TRAIN_STEPS * 1e3
        launches = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        brk = emit_breakdown(f"grouped_train_{name}_breakdown",
                             lambda: step_fn(params, state, scene, batch,
                                             None, it), step_ms)
        res = {"phase": "grouped_train", "variant": name, "knobs": knobs,
               "step_ms": step_ms, "device_busy_ms": brk.get(
                   "device_busy_ms"), "idle_share": brk.get("idle_share"),
               "peak_mem_gb": peak, "first_step": first,
               "launches": launches,
               "launches_by_shape": by_shape(counts, GROUPED_TRAIN_STEPS)}
        mine = []
        if base is None:
            base = first
        else:
            rel = abs(first["loss"] - base["loss"]) / abs(base["loss"])
            res["loss_ungrouped"] = base["loss"]
            res["loss_rel_to_ungrouped"] = rel
            overflow = (first["march_overflow_frac"] > 0
                        or base["march_overflow_frac"] > 0)
            # a 27-corner pack baked at another resolution than the
            # 8-corner one is another proxy of the field: reported
            held = not ((knobs.get("march_group") and overflow)
                        or knobs.get("group_bake_reso", 0) not in (
                            0, st["secondary_bake_reso"]))
            res["loss_held"] = held
            if held and not rel <= 1e-4:
                mine.append(f"loss {first['loss']} vs ungrouped "
                            f"{base['loss']}: {rel}")
            for k, n in counts.items():
                shapes[k] = shapes.get(k, 0) + n
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
        if knobs.get("march_group"):
            g = knobs["march_group"]
            want = ((g200 - 3) ** 2, 16 * fcfg.density_n_comp[0],
                    B * st["march_cap"] // g)
            at = {k: counts.get((path, k, *want), 0)
                  for k in ("row_gather", "row_scatter_add")}
            res["block16_launches_per_step"] = {
                k: v / GROUPED_TRAIN_STEPS for k, v in at.items()}
            if not all(at.values()):
                mine.append(f"16-corner rows {want} not launched: {at}")
        if knobs.get("second_march_group"):
            g = knobs["second_march_group"]
            reso = knobs.get("group_bake_reso") or st["secondary_bake_reso"]
            want = ((reso - 2) ** 3, F.PAIR_ROW,
                    st["secondary_tile"] * st["second_window"] // g)
            n = counts.get((path, "row_gather_bf16", *want), 0)
            res["pair27_launches_per_step"] = n / GROUPED_TRAIN_STEPS
            if not n:
                mine.append(f"27-corner rows {want} not launched")
        if not all(math.isfinite(float(x)) for x in (m["total_loss"],)):
            mine.append(f"non-finite loss {float(m['total_loss'])}")
        res["ok"] = not mine
        emit(res)
        fails += [f"{name}: {f}" for f in mine]
        del params, scene, state, opt, step_fn, m, m0
        torch.cuda.empty_cache()
    emit({"phase": "grouped_train_contracts", "pair_contract_ratio":
          {str(g): r for g, r in contracts.items()}})
    check(not fails, "grouped_train: " + "; ".join(fails))
    return total, shapes


class _Tee:
    """Text written to it goes to each of ``streams``."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for s in self.streams:
            s.write(text)

    def flush(self):
        for s in self.streams:
            s.flush()


def phase_grouped_cli():
    """``python -m tensoir_tpu_torch.train_tensoir`` on
    configs/single_light/armadillo.txt at full width, in this process, with
    GROUPED_CLI_FLAGS (every grouped knob, on bench.py's fast knobs) on a
    rotated-lights scene written to a temporary directory
    (GROUPED_CLI_VIEWS): GROUPED_CLI_RADIANCE radiance iterations, the mask
    with the shrink, the upsample to 300^3 three iterations later, relight
    iterations to GROUPED_CLI_RADIANCE + 8 (an eval of the 200 x 200 view
    at the last), ckpt_final and the final render_test; the loop's group
    resolutions and downgrade lines; then render-only from ckpt_final,
    whose metrics must equal the run's bit for bit. Then a second short run
    at ``--downsample_train 2`` over the same 800 x 800 PNGs, which the
    loader resizes to 400 x 400 on load (Lanczos, as PIL). Launch counts
    from 0 before the first run to the end of the second; every row kernel
    must launch. Returns (launch counts, launches by shape)."""
    import io
    import torch
    from tensoir_tpu_torch import train_tensoir
    from tensoir_tpu_torch.data import get_dataset
    from tensoir_tpu_torch.data.synthetic import write_shadow_scene
    from tensoir_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from tensoir_tpu_torch.train import loop
    n_iters = GROUPED_CLI_RADIANCE + 8
    resolved, shapes, fails = [], {}, []
    saved = {name: getattr(loop, name) for name in (
        "resolve_march_group", "resolve_primary_march_group")}

    def recorder(name):
        def run(*args):
            out = saved[name](*args)
            resolved.append({"resolver": name, "grid": list(args[2]),
                             "aabb": np.asarray(args[1]).tolist(),
                             "group": out})
            return out
        return run

    with tempfile.TemporaryDirectory() as tmp:
        data, hdr = os.path.join(tmp, "scene"), os.path.join(tmp, "hdr")
        write_shadow_scene(data, hdr, views=GROUPED_CLI_VIEWS)
        logs = os.path.join(tmp, "log")
        argv = ["--config", str(CONFIG), "--datadir", data, "--hdrdir", hdr,
                "--basedir", logs, *GROUPED_CLI_FLAGS,
                "--n_iters", str(n_iters), "--update_AlphaMask_list",
                f"[{GROUPED_CLI_RADIANCE}]", "--upsamp_list",
                f"[{GROUPED_CLI_RADIANCE + 3}]", "--N_vis", "1",
                "--vis_every", str(n_iters), "--test_number", "1"]
        log, printed = {"events": [], "steps": []}, io.StringIO()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        for name in saved:
            setattr(loop, name, recorder(name))
        t0 = time.perf_counter()
        try:
            with _run_probe(loop, log), kernel_calls("grouped_cli", shapes), \
                    contextlib.redirect_stdout(_Tee(sys.stderr, printed)):
                trained = train_tensoir.main(argv)
                torch.cuda.synchronize()
                run_s = time.perf_counter() - t0
                ckpt = os.path.join(logs, "armadillo", "ckpt_final.npz")
                t1 = time.perf_counter()
                again = train_tensoir.main(argv + [
                    "--render_only", "1", "--render_test", "1", "--ckpt",
                    ckpt])
                torch.cuda.synchronize()
                render_only_s = time.perf_counter() - t1
                # the resize on load: the 800 x 800 PNGs as 400 x 400 views
                t1 = time.perf_counter()
                small = get_dataset("tensoIR_unknown_rotated_lights")(
                    data, hdr, split="train", downsample=2.0,
                    light_rotation=("000",))
                load_s = time.perf_counter() - t1
                t1 = time.perf_counter()
                down = train_tensoir.main([
                    "--config", str(CONFIG), "--datadir", data, "--hdrdir",
                    hdr, "--basedir", os.path.join(tmp, "down"),
                    "--downsample_train", "2", "--n_iters", "12",
                    "--update_AlphaMask_list", "[100]", "--upsamp_list",
                    "[100]", "--N_vis", "0", "--render_test", "0"])
                torch.cuda.synchronize()
                down_s = time.perf_counter() - t1
        finally:
            for name, fn in saved.items():
                setattr(loop, name, fn)
        launches = dict(LAUNCHES)
    lines = [ln for ln in printed.getvalue().splitlines()
             if "grouped" in ln and "downgraded" in ln]
    final = trained.get("imgs_test_all")
    res = {"phase": "grouped_cli", "flags": GROUPED_CLI_FLAGS,
           "views": [list(v) for v in GROUPED_CLI_VIEWS], "n_iters": n_iters,
           "run_s": run_s, "render_only_s": render_only_s,
           "segments": _segments(log["steps"]),
           "events": [e for e in log["events"] if e["event"] != "rebuild"],
           "resolved_groups": resolved, "downgrade_lines": lines,
           "final_render_test": final,
           "render_only_test": again.get("imgs_test_all"),
           "downsample_train_2": {"img_wh": list(small.img_wh),
                                  "rays": int(small.all_rays.shape[0]),
                                  "load_s": load_s, "run_s": down_s,
                                  "result": down},
           "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    if final is None or final != again.get("imgs_test_all"):
        fails.append(f"render-only metrics {res['render_only_test']} differ "
                     f"from the run's {final}")
    elif not math.isfinite(final["psnr_nvs_brdf"]):
        fails.append(f"metrics {final}")
    kinds = {r["resolver"] for r in resolved}
    if kinds != set(saved):
        fails.append(f"the loop resolved only {sorted(kinds)}")
    groups = [r["group"] for r in resolved]
    if not any(groups):
        fails.append(f"no grouped march was legal in any phase: {resolved}")
    downgraded = [r for r in resolved if r["group"] != 4]
    if len(lines) != len(downgraded):
        fails.append(f"{len(downgraded)} downgrades, {len(lines)} lines")
    if tuple(small.img_wh) != (400, 400) or not np.isfinite(
            small.all_rgbs).all():
        fails.append(f"downsample 2 loaded {small.img_wh}")
    if not all(launches[k] > 0 for k in ROW_KERNELS):
        fails.append(f"a kernel was not launched: {launches}")
    res["ok"] = not fails
    emit(res)
    check(not fails, "grouped_cli: " + "; ".join(fails))
    return launches, shapes


def grouped_kernel_cases() -> dict:
    """The grouped marches' rows at bench.py's full-width shapes, each
    kernel against its plain version: K1-f32 at the 16-corner block rows
    of a density plane (197^2 rows of 16 x 16 floats, 1 KB, at the 4096
    rays x 192 / g groups) and K2 at their gradient; K1-bf16 at the
    27-corner rows of the 128 bake (126^3 rows, a tile of 32768 pairs x 48
    / 2 samples) and of the 64 bake (62^3, 48 / 4), each as 27 bf16 (54 B,
    K1's element-per-thread route) and padded to 32 (64 B, its 16-byte
    route). ``pair_b*_g*`` without a width is the width the port stores
    (``field.PAIR_ROW``). Returns (the block-row cases by group size, the
    27-corner cases)."""
    from tensoir_tpu_torch.models.field import PAIR_ROW
    rows = (200 - 3) ** 2
    block = {g: kernel_case(rows, 256, 4096 * 192 // g, seed=120 + g)
             for g in (2, 4)}
    pair = {}
    for i, (reso, g) in enumerate(((128, 2), (64, 4))):
        for c in (27, 32):
            pair[f"pair_b{reso}_g{g}_c{c}"] = bf16_gather_case(
                (reso - 2) ** 3, 32768 * 48 // g, seed=130 + 2 * i + c,
                C=c)
        pair[f"pair_b{reso}_g{g}"] = pair[f"pair_b{reso}_g{g}_c{PAIR_ROW}"]
    return block, pair


def phase_mesh_export(ckpt: str):
    """``python -m tensoir_tpu_torch.scripts.export_mesh`` on train_run's
    ckpt_final, in this process: the dense alpha at the field's own grid
    on the card (launches counted from 0 just before; 3 K1-f32, one
    K1-bf16 and 3 line-taps per chunk of x-slabs, K2 none), the host
    extraction, the PLY.
    Reports each part's seconds, the mesh's size and the share of its edges
    shared by exactly two faces (must exceed 0.99), and holds the card's
    alpha on the middle x-slab against the CPU's (1e-5 absolute: the same
    sums in other orders, on values in [0, 1]). Returns (launch counts,
    launches by shape)."""
    import torch
    from tensoir_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from tensoir_tpu_torch.models import field as F
    from tensoir_tpu_torch.models import lifecycle
    from tensoir_tpu_torch.scripts import export_mesh
    from tensoir_tpu_torch.utils import mesh_export
    from tensoir_tpu_torch.utils.ckpt import load_checkpoint
    timing, keep, shapes = {}, {}, {}
    saved = (lifecycle.dense_alpha, mesh_export.extract_mesh)

    def timed(name, fn):
        def run(*a, **kw):
            out, timing[name] = _timed(fn, *a, **kw)
            keep[name] = out
            return out
        return run

    lifecycle.dense_alpha = timed("dense_alpha", saved[0])
    mesh_export.extract_mesh = timed("extract", saved[1])
    torch.cuda.synchronize()
    reset_launch_counts()
    try:
        with kernel_calls("mesh_export", shapes), \
                contextlib.redirect_stdout(sys.stderr):
            (out, verts, faces), total_s = _timed(export_mesh.main,
                                                  ["--ckpt", ckpt])
    finally:
        lifecycle.dense_alpha, mesh_export.extract_mesh = saved
    launches = dict(LAUNCHES)
    alpha = keep["dense_alpha"]
    gx, gy, gz = alpha.shape
    chunks = -(-gx // max(1, lifecycle._ALPHA_CHUNK_POINTS // (gy * gz)))
    # the CPU's alpha on the middle x-slab, from the same file, computed as
    # dense_alpha computes each slab
    fcfg, params, scene, _ = load_checkpoint(ckpt, device="cpu")
    x0 = gx // 2
    lin = [torch.from_numpy(np.linspace(0, 1, g, dtype=np.float32))
           for g in (gx, gy, gz)]
    yy, zz = torch.meshgrid(lin[1], lin[2], indexing="ij")
    samples = torch.stack([lin[0][x0].expand(gy, gz), yy, zz], -1)
    xyz = scene["aabb"][0] * (1.0 - samples) + scene["aabb"][1] * samples
    step = F.step_size(scene["aabb"], F.grid_size_of(params), fcfg.step_ratio)
    cpu_slab = F.compute_alpha_grid(fcfg, params, scene, xyz.reshape(-1, 3),
                                    step).reshape(gy, gz)
    slab_err = float((alpha[x0].cpu() - cpu_slab).abs().max())
    edges = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                                    faces[:, [2, 0]]]), 1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    two = float((counts == 2).mean())
    want = {"row_gather": 3 * chunks, "row_gather_bf16": chunks,
            "row_scatter_add": 0, "line_taps": 3 * chunks}
    res = {"phase": "mesh_export", "grid": [gx, gy, gz], "chunks": chunks,
           "seconds": total_s, "dense_alpha_s": timing["dense_alpha"],
           "extract_s": timing["extract"], "vertices": len(verts),
           "faces": len(faces), "ply_bytes": os.path.getsize(out),
           "edges_shared_by_two": two, "occupied": float(
               (alpha > 0.005).float().mean()),
           "launches": launches, "launches_expected": want,
           "slab_x": x0, "slab_max_abs_err": slab_err,
           "tol": {"slab_abs": 1e-5, "edges_shared_by_two": 0.99}}
    fails = []
    if launches != want:
        fails.append(f"launches {launches}, not {want}")
    if not (len(faces) > 1000 and two > 0.99):
        fails.append(f"{len(faces)} faces, {two} of edges shared by two")
    if not slab_err <= 1e-5:
        fails.append(f"card alpha vs CPU on slab {x0}: {slab_err}")
    if Path(out).suffix != ".ply" or not Path(out).exists():
        fails.append(f"no PLY at {out}")
    res["ok"] = not fails
    emit(res)
    check(not fails, "mesh_export: " + "; ".join(fails))
    return launches, shapes


def _lpips_plan(net: str):
    """(in, out, kernel) of each feature convolution and the channels of
    each tap's lin head, from utils/lpips.py's layer tables."""
    from tensoir_tpu_torch.utils import lpips
    if net == "alex":
        outs = [c[0] for c in lpips.ALEX_CONVS]
        kernels = [c[1] for c in lpips.ALEX_CONVS]
        taps = outs
    else:
        outs = [c for group in lpips.VGG_GROUPS for c in group]
        kernels = [3] * len(outs)
        taps = [group[-1] for group in lpips.VGG_GROUPS]
    return list(zip([3] + outs[:-1], outs, kernels)), taps


def _lpips_weights(path: str, net: str, seed: int) -> None:
    """Seeded random LPIPS weights in the converter's npz layout
    (scripts/convert_lpips_weights.py): conv{i}_w [Kh, Kw, I, O] He-scaled,
    conv{i}_b [O], lin{t}_w [C] >= 0, net."""
    rng = np.random.default_rng(seed)
    convs, taps = _lpips_plan(net)
    out = {"net": np.asarray(net)}
    for i, (ci, co, k) in enumerate(convs):
        out[f"conv{i}_w"] = (rng.normal(size=(k, k, ci, co))
                             * np.sqrt(2.0 / (ci * k * k))).astype(np.float32)
        out[f"conv{i}_b"] = (0.01 * rng.normal(size=co)).astype(np.float32)
    for t, c in enumerate(taps):
        out[f"lin{t}_w"] = (0.1 * rng.uniform(size=c)).astype(np.float32)
    np.savez(path, **out)


def phase_lpips():
    """LPIPS (alex and vgg) with seeded random weights written in the
    converter's npz layout, on one 800 x 800 pair: the card's distance
    against the CPU's (1e-4 relative: cuDNN may take Winograd or FFT
    algorithms for f32, whose rounding exceeds a direct sum's, through up to
    13 layers; TF32 is off), ms per call on the card (CUDA events, the
    upload of the pair included, as rgb_lpips calls it), the CPU's seconds;
    then rgb_lpips through TENSOIR_LPIPS_WEIGHTS, which must give the card's
    distance."""
    import torch
    from tensoir_tpu_torch.utils import lpips, metrics
    rng = np.random.default_rng(9)
    a = rng.uniform(0, 1, (800, 800, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    res, fails = {}, []
    env = os.environ.get("TENSOIR_LPIPS_WEIGHTS")
    with tempfile.TemporaryDirectory() as tmp:
        for i, net in enumerate(("alex", "vgg")):
            path = os.path.join(tmp, f"lpips_{net}.npz")
            _lpips_weights(path, net, seed=20 + i)
            p_gpu, _ = lpips.load_lpips_params(path, "cuda")
            p_cpu, _ = lpips.load_lpips_params(path, "cpu")
            d_gpu = float(lpips.lpips_distance(p_gpu, a, b, net)[0])
            t0 = time.perf_counter()
            d_cpu = float(lpips.lpips_distance(p_cpu, a, b, net)[0])
            cpu_s = time.perf_counter() - t0
            ms = time_ms(lambda: lpips.lpips_distance(p_gpu, a, b, net),
                         reps=5, warm=2)
            os.environ["TENSOIR_LPIPS_WEIGHTS"] = path
            via_metric = metrics.rgb_lpips(a, b, net)
            rel = abs(d_gpu - d_cpu) / abs(d_cpu)
            res[net] = {"cuda": d_gpu, "cpu": d_cpu, "rel_err": rel,
                        "ms": ms, "cpu_s": cpu_s, "rgb_lpips": via_metric}
            if not (math.isfinite(d_gpu) and d_cpu > 0 and rel <= 1e-4):
                fails.append(f"{net}: card {d_gpu} vs CPU {d_cpu}")
            if not abs(via_metric - d_gpu) <= 1e-4 * d_gpu:
                fails.append(f"{net}: rgb_lpips {via_metric} vs {d_gpu}")
    if env is None:
        os.environ.pop("TENSOIR_LPIPS_WEIGHTS", None)
    else:
        os.environ["TENSOIR_LPIPS_WEIGHTS"] = env
    emit({"phase": "lpips", "ok": not fails, "fails": fails, "size": 800,
          "nets": res, "tol": {"rel": 1e-4}})
    check(not fails, "lpips: " + "; ".join(fails))


# ---- data-parallel training (parallel/): dp_nccl, dp_gloo2, dp_run ----

DP_STEPS = 3
# the dp_run schedule: radiance steps, then the first mask with the shrink,
# a checkpoint, the armadillo schedule's first upsample, and the stop file
DP_RUN = dict(mask=20, save=22, upsample=25, stop=30)
DP_TIMEOUT = 300


def _dp_relight_setup():
    """The relight step's full-width field (relight_train's: the blob at the
    first upsample's grid, masked) and its iteration."""
    from tensoir_tpu_torch import config as C
    cfg, _, _ = slice_sizes()
    n_vox, reso, n_samples = relight_sizes(cfg)
    fcfg = C.field_config_from(cfg, NEAR_FAR)
    params, scene = masked_field(fcfg, reso, seed=0, device="cuda")
    return cfg, fcfg, reso, n_samples, params, scene


def phase_dp_nccl(work: str):
    """One process, a one-rank NCCL group: DP_STEPS deterministic relight
    steps at full width through make_train_step(mesh=...) against the same
    steps without a mesh, each from a copy of one field.

    Held: the group's reduction is the identity, bit for bit (the sum over
    one rank, divided by one), on the gradients and metrics of every step;
    the first step's loss equals the ungrouped step's, bit for bit. The
    later steps and the parameters equal the ungrouped run's bit for bit
    when two ungrouped runs do; when they do not (K2 adds with atomics, in
    an order that changes from run to run), their losses within 1e-5
    relative and the first step's gradients within 1e-3 relative L2 (the
    relight step parity's bounds). Reported: the all_reduce's bytes and ms
    per step (CUDA events), the steps' median ms, grouped and not (timed
    in turns, without the checks' wrappers), beside relight_train's, and
    what NCCL says to two ranks on this one card.
    Returns (launch counts, launches by shape) of the grouped run."""
    import torch
    from tensoir_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from tensoir_tpu_torch.parallel import make_mesh, multihost
    from tensoir_tpu_torch.scripts.multihost_worker import time_all_reduce
    from tensoir_tpu_torch.train import step as step_mod
    from tensoir_tpu_torch.train.optim import flatten
    t_phase = time.perf_counter()
    cfg, fcfg, reso, n_samples, params0, scene = _dp_relight_setup()
    batch = batch_of(BATCH, "cuda")
    it0 = cfg.update_AlphaMask_list[0]
    dev = torch.device("cuda", 0)
    check(multihost.initialize(init_method=f"file://{work}/nccl_rdzv",
                               world_size=1, rank=0, backend="nccl",
                               device=dev), "dp_nccl: no group was made")
    reduce = step_mod._reduce
    exact = []

    def recorded(mesh, grads, metrics):
        g, m = reduce(mesh, grads, metrics)
        exact.append(all(torch.equal(grads[k], g[k]) for k in grads)
                     and all(torch.equal(metrics[k], m[k]) for k in m))
        return g, m

    def run(mesh):
        params = _to(params0, "cuda")
        opt, step_fn = make_step(fcfg, cfg, n_samples, True, "cuda",
                                 relight=True, mesh=mesh)
        state = opt.init(params)
        losses, ms, grads = [], [], None
        for i in range(DP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step_fn(params, state, scene, batch, None,
                                       it0 + i)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["total_loss"]))
            if i == 0:
                grads = {k: v / 0.1 for k, v in state["mu"].items()}
        return losses, flatten(params), grads, ms

    shapes = {}
    try:
        mesh = make_mesh(1)
        check(mesh.group is not None and mesh.world == 1, "dp_nccl mesh")
        plain = run(None)
        step_mod._reduce = recorded
        torch.cuda.synchronize()
        reset_launch_counts()
        try:
            with kernel_calls("dp_nccl", shapes):
                grouped = run(mesh)
        finally:
            step_mod._reduce = reduce
        launches = dict(LAUNCHES)
        again = run(None)
        # step times without the checks' wrappers, in turns
        timed = {"plain": [], "grouped": []}
        for m in (None, mesh, mesh, None):
            timed["grouped" if m else "plain"] += run(m)[3]
        numel = sum(v.numel() for v in grouped[1].values())
        ar = time_all_reduce(mesh, numel, dev, 20)
        backend = torch.distributed.get_backend()
    finally:
        multihost.shutdown()

    def same(a, b):
        return a[0] == b[0] and all(torch.equal(a[1][k], b[1][k])
                                    for k in a[1])
    reproducible = same(plain, again)
    bit_equal = same(grouped, plain)
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(grouped[0], plain[0]))
    g_rel = _grad_rel_err(grouped[2], plain[2])
    fails = []
    if backend != "nccl":
        fails.append(f"backend {backend}")
    if not (len(exact) == DP_STEPS and all(exact)):
        fails.append(f"the one-rank reduction is not the identity: {exact}")
    if grouped[0][0] != plain[0][0]:
        fails.append(f"first loss {grouped[0][0]!r} != {plain[0][0]!r}")
    if reproducible and not bit_equal:
        fails.append("grouped steps differ from reproducible plain steps")
    if not reproducible:
        if not loss_rel <= 1e-5:
            fails.append(f"loss {loss_rel} over 1e-5")
        over = {k: v for k, v in g_rel.items() if v > 1e-3}
        if over:
            fails.append(f"gradients over 1e-3: {over}")
    if not all(launches[k] > 0 for k in ROW_KERNELS):
        fails.append(f"a kernel was not launched: {launches}")
    # two NCCL ranks on one card: NCCL refuses them; what it says
    pair_s, pair_failed, pair_logs = _spawn_ranks(
        "nccl_pair", lambda r: {"rdzv": f"file://{work}/nccl_pair_rdzv",
                                "rank": r}, work, may_fail=True, timeout=90)
    refusal = sorted({ln.strip() for log in pair_logs
                      for ln in log.splitlines()[-1:] + [
                          x for x in log.splitlines()
                          if "Duplicate GPU" in x or "NCCL" in x]})
    param_diff = max(float((grouped[1][k] - plain[1][k]).abs().max())
                     for k in plain[1])
    rerun_diff = max(float((again[1][k] - plain[1][k]).abs().max())
                     for k in plain[1])
    emit({"phase": "dp_nccl", "ok": not fails, "fails": fails,
          "backend": backend, "world": 1, "grid": list(reso),
          "batch": BATCH, "steps": DP_STEPS,
          "reduction_exact": exact, "plain_reproducible": reproducible,
          "bit_equal": bit_equal, "losses": grouped[0],
          "losses_plain": plain[0], "loss_rel_err": loss_rel,
          "grad_rel_err_max": max(g_rel.values()),
          "param_max_abs_diff": param_diff,
          "plain_rerun_param_max_abs_diff": rerun_diff,
          "all_reduce_bytes": ar["bytes"], "all_reduce_ms": ar["ms"],
          "step_ms": timed["grouped"], "plain_step_ms": timed["plain"],
          "step_ms_median": float(np.median(timed["grouped"])),
          "plain_step_ms_median": float(np.median(timed["plain"])),
          "relight_train_step_ms": STEP_MS.get("relight_train"),
          "launches": launches,
          "launches_per_step": {k: v / DP_STEPS for k, v in launches.items()},
          "two_ranks_one_card": {"failed": pair_failed, "seconds": pair_s,
                                 "refusal": refusal[:6]},
          "seconds": time.perf_counter() - t_phase,
          "tol": {"loss_rel": 1e-5, "grad_rel_l2": 1e-3}})
    check(not fails, "dp_nccl: " + "; ".join(fails))
    return launches, shapes


def _spawn_ranks(role: str, args_of_rank, work: str, world: int = 2,
                 may_fail: bool = False, timeout: float = DP_TIMEOUT):
    """Run ``world`` children of this script (``--dp-child role args``),
    each rank's output in a log under ``work``. A child that fails kills the
    others, and so does the time limit, so that no rank is left waiting in
    a collective. Returns the seconds it took; a failure raises, or with
    ``may_fail`` is returned: (seconds, what failed, each rank's log)."""
    procs, logs = [], []
    t0 = time.perf_counter()
    for r in range(world):
        log = open(os.path.join(work, f"{role}_rank{r}.log"), "w")
        logs.append(log)
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                            "TENSOIR_STOP_FILE")}
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--dp-child",
             role, json.dumps(args_of_rank(r))], stdout=log,
            stderr=subprocess.STDOUT, env=env, cwd=str(ROOT)))
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                break
            if time.perf_counter() - t0 > timeout:
                failed = f"ranks still running after {timeout} s"
                break
            time.sleep(0.2)
        if failed is None:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    seconds = time.perf_counter() - t0
    tails = []
    for r in range(world):
        with open(os.path.join(work, f"{role}_rank{r}.log")) as f:
            tails.append(f.read()[-3000:])
    if may_fail:
        return seconds, failed, tails
    if failed:
        raise SmokeFailure(f"{role}: {failed}\n" + "\n".join(
            f"--- rank {r}:\n{t}" for r, t in enumerate(tails)))
    return seconds


def _read_counts(path: str) -> dict:
    with open(path) as f:
        return {tuple(k): n for k, n in json.load(f)}


def phase_dp_gloo2(work: str):
    """Two worker processes (tensoir_tpu_torch/scripts/multihost_worker.py),
    both on cuda:0, in a gloo group: the full-width deterministic relight
    step on 2 x 2048 rays against this process's step on all 4096. The
    relight cap is lifted to the batch and the per-tile pair cap to the
    tile (app_pair_frac 1), so that no cap keeps other rays or pairs on
    one rank than on one process. Held: the first step's loss within 1e-5
    relative, every gradient within 1e-3 relative L2 (the relight step
    parity's bounds), both ranks' parameters bit-equal after 2 steps, and
    every row kernel launched. Then once more at the config's own cap (1024 a
    rank, 1024 on one process): how far per-rank capping moves the loss,
    reported, not held. Reported: the gloo all_reduce's ms (CUDA tensors
    through the host), peak memory per rank, K1/K2 launches per rank-step.
    Returns (rank 0's launch counts, its launches by shape)."""
    import dataclasses as dc
    import torch
    from tensoir_tpu_torch.scripts import multihost_worker as W
    t_phase = time.perf_counter()
    cfg, fcfg, reso, n_samples, params, scene = _dp_relight_setup()
    it0 = cfg.update_AlphaMask_list[0]
    st, w, lr = step_knobs(cfg, n_samples, True, relight=True,
                           relight_ray_cap=BATCH, app_pair_frac=1.0)
    spec = os.path.join(work, "dp_spec.npz")
    batch = {k: v.cpu() for k, v in batch_of(BATCH, "cuda").items()}
    W.write_spec(spec, dc.asdict(fcfg), params, scene, batch,
                 {"relight": {"static": st, "weights": w, "step": it0}}, lr)
    del params, scene
    # one process on the whole batch, each cap
    dev = torch.device("cuda", 0)
    loaded = W.load_spec(spec, dev)
    one = {cap: W.run_case(loaded, "relight", 1, dev, None,
                           relight_ray_cap=cap)
           for cap in (BATCH, cfg.relight_ray_cap)}
    del loaded
    torch.cuda.empty_cache()
    steps = 2

    def args(r):
        return {"path": "dp_gloo2",
                "counts": os.path.join(work, f"dp_gloo2_counts{r}.json"),
                "argv": ["--init-method", f"file://{work}/gloo_rdzv",
                         "--world", "2", "--rank", str(r), "--device",
                         "cuda:0", "--backend", "gloo", "--params-npz", spec,
                         "--out", os.path.join(work, f"dp_gloo2_{r}.npz"),
                         "--steps", str(steps), "--relight",
                         "--relight-ray-cap", str(BATCH),
                         str(cfg.relight_ray_cap), "--time-all-reduce", "10"]}
    wall_s = _spawn_ranks("dp_gloo2", args, work)
    outs = [W.read_out(os.path.join(work, f"dp_gloo2_{r}.npz"))
            for r in range(2)]
    m0, m1 = outs[0]["meta"], outs[1]["meta"]
    fails = []
    lifted, capped = m0["cases"]
    ref = one[BATCH]
    loss_rel = abs(lifted["losses"][0] - ref["losses"][0]) / abs(
        ref["losses"][0])
    g_rel = {k: float(np.linalg.norm(g - ref["grads"][k].cpu().numpy())
                      / max(np.linalg.norm(ref["grads"][k].cpu().numpy()),
                            1e-30))
             for k, g in outs[0]["grads"][0].items()}
    if not loss_rel <= 1e-5:
        fails.append(f"loss {lifted['losses'][0]} vs {ref['losses'][0]}: "
                     f"{loss_rel} over 1e-5")
    over = {k: v for k, v in g_rel.items() if v > 1e-3}
    if over:
        fails.append(f"gradients over 1e-3: {over}")
    for i, (a, b) in enumerate(zip(m0["cases"], m1["cases"])):
        if a["digests"] != b["digests"] or a["losses"] != b["losses"]:
            fails.append(f"case {i}: the ranks' parameters differ")
    if (m0["backend"], m1["backend"]) != ("gloo", "gloo"):
        fails.append(f"backends {m0['backend']}, {m1['backend']}")
    launches = {k: sum(c["launches"][k] for c in m0["cases"])
                for k in m0["cases"][0]["launches"]}
    if not all(launches[k] > 0 for k in ROW_KERNELS):
        fails.append(f"a kernel was not launched: {launches}")
    cap_ref = one[cfg.relight_ray_cap]
    emit({"phase": "dp_gloo2", "ok": not fails, "fails": fails,
          "backend": "gloo", "world": 2, "device": m0["device"],
          "grid": list(reso), "batch": BATCH, "rays_per_rank": BATCH // 2,
          "steps": steps, "loss_ranks": lifted["losses"][0],
          "loss_one_process": ref["losses"][0], "loss_rel_err": loss_rel,
          "grad_rel_err_max": max(g_rel.values()),
          "worst_grad": max(g_rel, key=g_rel.get),
          "n_acc_masked": lifted["n_acc_masked"][0],
          "n_acc_masked_one_process": ref["n_acc_masked"][0],
          "config_cap": cfg.relight_ray_cap,
          "config_cap_loss_ranks": capped["losses"][0],
          "config_cap_loss_one_process": cap_ref["losses"][0],
          "config_cap_loss_rel_diff": abs(
              capped["losses"][0] - cap_ref["losses"][0])
          / abs(cap_ref["losses"][0]),
          "all_reduce_bytes": m0["all_reduce"]["bytes"],
          "all_reduce_ms": [m0["all_reduce"]["ms"], m1["all_reduce"]["ms"]],
          "step_s_ranks": [lifted["step_s"], m1["cases"][0]["step_s"]],
          "peak_mem_gb": [m0["cases"][0].get("peak_mem_gb"),
                          m1["cases"][0].get("peak_mem_gb")],
          # per case: the lifted cap relights 2048 rays a rank (64 tiles of
          # pairs), the config's 1024 (32 tiles)
          "launches_per_rank_step": [
              {k: v / steps for k, v in c["launches"].items()}
              for c in m0["cases"]],
          "wall_s": wall_s, "seconds": time.perf_counter() - t_phase,
          "tol": {"loss_rel": 1e-5, "grad_rel_l2": 1e-3}})
    check(not fails, "dp_gloo2: " + "; ".join(fails))
    return launches, _read_counts(os.path.join(work, "dp_gloo2_counts0.json"))


def dp_run_config():
    """configs/single_light/armadillo.txt at full width with the iterations
    cut to DP_RUN's: the first alpha mask with the shrink, a periodic
    checkpoint, the armadillo schedule's first upsample (its voxel count
    made the final one), progress every 5 iterations, and a long n_iters
    that the stop file ends."""
    from tensoir_tpu_torch import config as C
    from tensoir_tpu_torch.models.lifecycle import voxel_schedule
    cfg = C.load_config(str(CONFIG))
    first_upsample = voxel_schedule(cfg.N_voxel_init, cfg.N_voxel_final,
                                    len(cfg.upsamp_list))[0]
    return cfg.replace(n_iters=1000, update_AlphaMask_list=(DP_RUN["mask"],),
                       upsamp_list=(DP_RUN["upsample"],),
                       N_voxel_final=first_upsample,
                       save_iters=DP_RUN["save"], progress_refresh_rate=5,
                       vis_every=0)


def phase_dp_run(work: str):
    """reconstruction on two gloo ranks on cuda:0 (children of this script)
    on the demo's data, dp_run_config's schedule; rank 0's progress
    callback makes its <log_dir>/STOP at iteration DP_RUN["stop"]. Held:
    only rank 0's log_dir exists (with the checkpoints, the metrics and
    the config), both ranks end with bit-equal parameters, both stop at
    that iteration, every row kernel launched. Reported: wall s of each rank,
    launches per rank-iteration. Returns (rank 0's launch counts, its
    launches by shape)."""
    t_phase = time.perf_counter()
    root = os.path.join(work, "dp_run")
    os.makedirs(root)

    def args(r):
        return {"rdzv": f"file://{work}/run_rdzv", "rank": r,
                "log_dir": os.path.join(root, f"log_r{r}"),
                "out": os.path.join(root, f"rank{r}.json"),
                "counts": os.path.join(root, f"counts{r}.json")}
    wall_s = _spawn_ranks("dp_run", args, work)
    res = []
    for r in range(2):
        with open(os.path.join(root, f"rank{r}.json")) as f:
            res.append(json.load(f))
    fails = []
    files = sorted(os.listdir(os.path.join(root, "log_r0")))
    want = {f"ckpt_{DP_RUN['save']}.npz", "ckpt_final.npz", "config.txt",
            "metrics.jsonl"}
    if not want <= set(files):
        fails.append(f"rank 0's log_dir holds {files}")
    if os.path.exists(os.path.join(root, "log_r1")):
        fails.append("rank 1 made its log_dir")
    if res[0]["digests"] != res[1]["digests"]:
        fails.append("the ranks' final parameters differ")
    stops = [x["iterations"][-1] for x in res]
    if stops != [DP_RUN["stop"]] * 2:
        fails.append(f"the ranks stopped at {stops}")
    launches = res[0]["launches"]
    if not all(launches[k] > 0 for k in ROW_KERNELS):
        fails.append(f"a kernel was not launched: {launches}")
    n_it = DP_RUN["stop"] + 1
    emit({"phase": "dp_run", "ok": not fails, "fails": fails,
          "backend": "gloo", "world": 2, "batch_per_rank": BATCH // 2,
          "schedule": DP_RUN, "grid_final": res[0]["grid"],
          "stopped_at": stops, "rank0_files": files,
          "run_s": [x["run_s"] for x in res], "wall_s": wall_s,
          "seconds": time.perf_counter() - t_phase,
          "loss_last": [x["loss_last"] for x in res],
          "peak_mem_gb": [x["peak_mem_gb"] for x in res],
          "launches": launches,
          "launches_per_iteration": {k: v / n_it
                                     for k, v in launches.items()}})
    check(not fails, "dp_run: " + "; ".join(fails))
    return launches, _read_counts(os.path.join(root, "counts0.json"))


# the dp_launch CLI schedule: radiance steps, the first mask with the
# shrink at 20, the upsample to 300^3 at 21, relight steps, the eval at 29,
# the checkpoint at 30, then rank 0's STOP, written by this process as soon
# as that checkpoint appears
DP_LAUNCH = dict(mask=20, upsample=21, eval=29, save=30)
DP_LAUNCH_VIEWS = (("train", 1, 800), ("test", 1, 200))
DP_LAUNCH_STEPS = 5


def _torchrun(nproc: int, argv: list, log_path: str,
              timeout: float = DP_TIMEOUT, on_poll=None) -> float:
    """``python -m torch.distributed.run --standalone --nproc_per_node
    nproc`` + ``argv``, its output in ``log_path``; ``on_poll()`` runs while
    it does. The launcher and its ranks are a session of their own, killed
    together on the time limit. Returns the seconds it took; a failure
    raises with the log's end."""
    import signal
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                        "TENSOIR_STOP_FILE")}
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", str(nproc), *argv], stdout=log,
            stderr=subprocess.STDOUT, env=env, cwd=str(ROOT),
            start_new_session=True)
        try:
            while proc.poll() is None:
                if time.perf_counter() - t0 > timeout:
                    break
                if on_poll:
                    on_poll()
                time.sleep(0.2)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        with open(log_path) as f:
            tail = f.read()[-6000:]
        raise SmokeFailure(f"{' '.join(argv[:3])} on {nproc} ranks exited "
                           f"{proc.returncode} after {seconds:.1f} s:\n{tail}")
    return seconds


def _dp_spec(work: str):
    """dp_gloo2's spec (relight_train's field, the relight and pair caps
    lifted to the batch), written once into ``work``: (path, iteration)."""
    import dataclasses as dc
    from tensoir_tpu_torch.scripts import multihost_worker as W
    spec = os.path.join(work, "dp_spec.npz")
    cfg, fcfg, reso, n_samples, params, scene = _dp_relight_setup()
    it0 = cfg.update_AlphaMask_list[0]
    if not os.path.exists(spec):
        st, w, lr = step_knobs(cfg, n_samples, True, relight=True,
                               relight_ray_cap=BATCH, app_pair_frac=1.0)
        batch = {k: v.cpu() for k, v in batch_of(BATCH, "cuda").items()}
        W.write_spec(spec, dc.asdict(fcfg), params, scene, batch,
                     {"relight": {"static": st, "weights": w, "step": it0}},
                     lr)
    return spec, cfg, reso


def phase_dp_launch(work: str, nproc: int):
    """The path a user launches: PyTorch's launcher (python -m
    torch.distributed.run --standalone --nproc_per_node nproc), every rank
    joining its group in multihost.initialize() from the launcher's
    environment: NCCL, on the default device cuda:LOCAL_RANK.
    1. tensoir_tpu_torch.scripts.multihost_worker on dp_gloo2's spec: the
       full-width relight step on nproc x 4096 / nproc rays against this
       process on all 4096 (caps lifted), DP_LAUNCH_STEPS steps each. Held:
       the first loss within 1e-5 relative, every gradient within 1e-3
       relative L2, the ranks' parameters bit-equal after the steps.
       Reported: the median step ms after the first, launched and in this
       process, and the NCCL all_reduce's ms for the gradients' bucket
       (over NVLink when nproc > 1).
    2. the CLI (train_tensoir.main, through a child of this script that
       counts the kernels' launches) on configs/single_light/armadillo.txt
       at full width over a shadow scene written to ``work`` (one 800^2
       training view, one 200^2 test view), on DP_LAUNCH's schedule with
       N_vis 1 and no final render. Held: every rank exits 0; rank 0's
       run directory holds both checkpoints, the config, one metrics line
       per iteration, and the eval's one record and images; ckpt_final was
       written at the stop, after the save, with each rank's generator and
       sampler states; every row kernel launched on rank 0. Reported: wall s,
       median ms per radiance and per relight iteration (from rank 0's
       elapsed_s), the eval's s.
    Returns (rank 0's launch counts, its launches by shape)."""
    import torch
    from tensoir_tpu_torch.data.synthetic import write_shadow_scene
    from tensoir_tpu_torch.scripts import multihost_worker as W
    from tensoir_tpu_torch.utils.ckpt import load_checkpoint
    t_phase = time.perf_counter()
    root = os.path.join(work, f"dp_launch{nproc}")
    os.makedirs(root)
    fails = []
    # 1. the worker's step under the launcher, against one process
    spec, cfg, reso = _dp_spec(work)
    dev = torch.device("cuda", 0)
    ref = W.run_case(W.load_spec(spec, dev), "relight", DP_LAUNCH_STEPS,
                     dev, None, relight_ray_cap=BATCH)
    torch.cuda.empty_cache()
    worker_s = _torchrun(nproc, [
        "-m", "tensoir_tpu_torch.scripts.multihost_worker", "--params-npz",
        spec, "--out", os.path.join(root, "worker_{rank}.npz"), "--steps",
        str(DP_LAUNCH_STEPS), "--relight", "--relight-ray-cap", str(BATCH),
        "--time-all-reduce", "20"], os.path.join(root, "worker.log"))
    outs = [W.read_out(os.path.join(root, f"worker_{r}.npz"))
            for r in range(nproc)]
    metas = [o["meta"] for o in outs]
    case0 = metas[0]["cases"][0]
    loss_rel = abs(case0["losses"][0] - ref["losses"][0]) / abs(
        ref["losses"][0])
    g_rel = _grad_rel_err({k: torch.from_numpy(v) for k, v in
                           outs[0]["grads"][0].items()},
                          {k: v.cpu() for k, v in ref["grads"].items()})
    if not loss_rel <= 1e-5:
        fails.append(f"worker loss {loss_rel} over 1e-5")
    over = {k: v for k, v in g_rel.items() if v > 1e-3}
    if over:
        fails.append(f"worker gradients over 1e-3: {over}")
    if any(m["cases"][0]["digests"] != case0["digests"] for m in metas):
        fails.append("the worker ranks' parameters differ")
    backends = sorted({(m["backend"], m["device"], m["rank"], m["world"])
                       for m in metas})
    if backends != [("nccl", f"cuda:{r}", r, nproc) for r in range(nproc)]:
        fails.append(f"worker groups {backends}")
    ref_step_s = ref["step_s"]
    del ref
    torch.cuda.empty_cache()

    # 2. the CLI under the launcher
    data, hdr, logs = (os.path.join(root, d) for d in ("scene", "hdr",
                                                        "log"))
    write_shadow_scene(data, hdr, views=DP_LAUNCH_VIEWS)
    run_dir = os.path.join(logs, "armadillo")
    argv = ["--config", str(CONFIG), "--datadir", data, "--hdrdir", hdr,
            "--basedir", logs, "--n_iters", "1000",
            "--update_AlphaMask_list", f"[{DP_LAUNCH['mask']}]",
            "--upsamp_list", f"[{DP_LAUNCH['upsample']}]",
            "--vis_every", str(DP_LAUNCH["eval"] + 1), "--N_vis", "1",
            "--save_iters", str(DP_LAUNCH["save"]),
            "--progress_refresh_rate", "1", "--render_test", "0"]
    saved = os.path.join(run_dir, f"ckpt_{DP_LAUNCH['save']}.npz")
    stop = os.path.join(run_dir, "STOP")

    def stop_after_save():
        if os.path.exists(saved) and not os.path.exists(stop):
            open(stop, "w").close()
    child = {"argv": argv, "out": os.path.join(root, "cli_{rank}.json"),
             "counts": os.path.join(root, "cli_counts_{rank}.json")}
    cli_s = _torchrun(nproc, [str(Path(__file__).resolve()), "--dp-child",
                              "dp_launch", json.dumps(child)],
                      os.path.join(root, "cli.log"), on_poll=stop_after_save)
    res = []
    for r in range(nproc):
        with open(child["out"].format(rank=r)) as f:
            res.append(json.load(f))
    files = sorted(os.path.relpath(os.path.join(d, f), run_dir)
                   for d, _, fs in os.walk(run_dir) for f in fs)
    want = {saved, os.path.join(run_dir, "ckpt_final.npz")}
    want = {os.path.relpath(x, run_dir) for x in want} | {
        "config.txt", "metrics.jsonl", "imgs_vis/metrics_record.txt",
        f"imgs_vis/nvs_with_radiance_field/{DP_LAUNCH['eval']:06d}_000.png"}
    if not want <= set(files):
        fails.append(f"missing from rank 0's run: {sorted(want - set(files))}")
    recs = [json.loads(x) for x in
            open(os.path.join(run_dir, "metrics.jsonl")).read().splitlines()
            if '"train/total_loss"' in x]
    steps = [x["step"] for x in recs]
    evals = open(os.path.join(run_dir, "imgs_vis",
                              "metrics_record.txt")).read().splitlines()
    _, _, _, extra = load_checkpoint(os.path.join(run_dir,
                                                  "ckpt_final.npz"),
                                     device="cpu")
    stopped = extra["train_state"]["iteration"]
    if steps != list(range(len(steps))) or stopped != len(steps):
        fails.append(f"metrics steps {steps[:3]}..{steps[-3:]}, final "
                     f"checkpoint at {stopped}")
    if not DP_LAUNCH["save"] < stopped < 1000:
        fails.append(f"stopped at {stopped}")
    if len(evals) != 1 or not evals[0].startswith(
            f"Iteration:{DP_LAUNCH['eval']:06d}: "):
        fails.append(f"evals {evals}")
    if sorted(extra.get("rank_states", {})) != list(range(nproc)):
        fails.append(f"rank states {sorted(extra.get('rank_states', {}))}")
    if [x["result"] for x in res] != [{}] * nproc:
        fails.append(f"results {[x['result'] for x in res]}")
    launches = res[0]["launches"]
    if not all(launches[k] > 0 for k in ROW_KERNELS):
        fails.append(f"a kernel was not launched: {launches}")
    elapsed = {x["step"]: x["train/elapsed_s"] for x in recs}

    def median_ms(its):
        d = [elapsed[i] - elapsed[i - 1] for i in its
             if i in elapsed and i - 1 in elapsed]
        return float(np.median(d)) * 1e3 if d else None
    radiance_ms = median_ms(range(2, DP_LAUNCH["mask"]))
    relight_ms = median_ms(range(DP_LAUNCH["upsample"] + 2,
                                 DP_LAUNCH["eval"]))
    eval_s = (elapsed.get(DP_LAUNCH["eval"] + 1, math.nan)
              - elapsed.get(DP_LAUNCH["eval"], math.nan))
    emit({"phase": "dp_launch", "ok": not fails, "fails": fails,
          "ranks": nproc, "backend": metas[0]["backend"],
          "worker": {"loss_rel_err": loss_rel,
                     "grad_rel_err_max": max(g_rel.values()),
                     "rays_per_rank": BATCH // nproc,
                     "all_reduce_bytes": metas[0]["all_reduce"]["bytes"],
                     "all_reduce_ms": [m["all_reduce"]["ms"] for m in metas],
                     # the first step warms up
                     "step_ms_median": float(np.median(case0["step_s"][1:]))
                     * 1e3,
                     "one_process_step_ms_median": float(np.median(
                         ref_step_s[1:])) * 1e3,
                     "peak_mem_gb": [m["cases"][0].get("peak_mem_gb")
                                     for m in metas],
                     "wall_s": worker_s},
          "cli": {"schedule": DP_LAUNCH, "stopped_at": stopped,
                  "wall_s": cli_s, "run_s": [x["run_s"] for x in res],
                  "radiance_iter_ms_median": radiance_ms,
                  "relight_iter_ms_median": relight_ms,
                  "eval_iteration_s": eval_s, "evals": evals,
                  "files": files, "launches": launches,
                  "peak_mem_gb": [x["peak_mem_gb"] for x in res]},
          "seconds": time.perf_counter() - t_phase,
          "tol": {"loss_rel": 1e-5, "grad_rel_l2": 1e-3}})
    check(not fails, f"dp_launch ({nproc} ranks): " + "; ".join(fails))
    return launches, _read_counts(child["counts"].format(rank=0))


def dp_child(role: str, args: dict) -> int:
    """One rank of dp_gloo2 (the worker) or dp_run (reconstruction), with
    its kernel launches counted by shape into ``args["counts"]``."""
    import torch
    from tensoir_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    shapes = {}
    if role == "dp_launch":
        # one rank of the CLI under the launcher: the group, the backend
        # and the device all come from the launcher's environment
        from tensoir_tpu_torch import train_tensoir
        rank = int(os.environ["RANK"])
        reset_launch_counts()
        t0 = time.perf_counter()
        with kernel_calls("dp_launch", shapes):
            result = train_tensoir.main(args["argv"])
        torch.cuda.synchronize()
        with open(args["out"].format(rank=rank), "w") as f:
            json.dump({"result": result, "run_s": time.perf_counter() - t0,
                       "launches": dict(LAUNCHES),
                       "peak_mem_gb": torch.cuda.max_memory_allocated()
                       / 2 ** 30}, f)
        with open(args["counts"].format(rank=rank), "w") as f:
            json.dump([[list(k), n] for k, n in shapes.items()], f)
        return 0
    if role == "nccl_pair":
        from tensoir_tpu_torch.parallel import multihost
        dev = torch.device("cuda", 0)
        multihost.initialize(init_method=args["rdzv"], world_size=2,
                             rank=args["rank"], backend="nccl", device=dev)
        try:
            t = torch.ones(4, device=dev)
            torch.distributed.all_reduce(t)
            torch.cuda.synchronize()
            print(f"two NCCL ranks on {dev}: all_reduce gave {t.tolist()}",
                  flush=True)
        finally:
            multihost.shutdown()
        return 0
    if role == "dp_gloo2":
        from tensoir_tpu_torch.scripts import multihost_worker
        with kernel_calls(args["path"], shapes):
            multihost_worker.main(args["argv"])
    else:
        from tensoir_tpu_torch.models.field import grid_size_of
        from tensoir_tpu_torch.parallel import multihost
        from tensoir_tpu_torch.scripts.multihost_worker import digest
        from tensoir_tpu_torch.train import loop
        from tensoir_tpu_torch.train.optim import flatten
        rank, log_dir = args["rank"], args["log_dir"]
        dev = torch.device("cuda", 0)
        multihost.initialize(init_method=args["rdzv"], world_size=2,
                             rank=rank, backend="gloo", device=dev)
        try:
            ds = shadow_dataset()
            hist = []

            def progress(it, m):
                hist.append(it)
                if rank == 0 and it == DP_RUN["stop"]:
                    open(os.path.join(log_dir, "STOP"), "w").close()
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            with kernel_calls("dp_run", shapes):
                res = loop.reconstruction(dp_run_config(), ds,
                                          log_dir=log_dir,
                                          progress_cb=progress, device=dev)
            torch.cuda.synchronize()
            out = {"run_s": time.perf_counter() - t0, "iterations": hist,
                   "launches": dict(LAUNCHES),
                   "loss_last": res.metrics_history[-1]["total_loss"],
                   "grid": list(grid_size_of(res.params)),
                   "peak_mem_gb": torch.cuda.max_memory_allocated(dev)
                   / 2 ** 30,
                   "digests": {k: digest(v) for k, v in
                               flatten(res.params).items()}}
            with open(args["out"], "w") as f:
                json.dump(out, f)
        finally:
            multihost.shutdown()
    with open(args["counts"], "w") as f:
        json.dump([[list(k), n] for k, n in shapes.items()], f)
    return 0


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


# the main path's line lookups without a gradient, as (lines k, nodes D,
# width R, rows N, CP's extrapolating taps): CP's appearance lines in a
# secondary tile's app stage, VM's appearance line in the same, and the
# density line of a visibility tile (16,384 pairs x 48 samples)
LINE_TAP_SHAPES = {"cp_app": (3, 500, 288, 65536, True),
                   "vm_app": (1, 300, 48, 65536, False),
                   "vis_density": (1, 300, 16, 786432, False)}


def line_taps_case(k: int, D: int, R: int, N: int, extrapolate: bool,
                   seed: int) -> dict:
    """The line-taps kernel at one shape on random lines and coordinates in
    [-1.1, 1.1]: its gap to the plain version (largest absolute, and in
    ulps of the taps' scale prod_a |w0 l0| + |w1 l1|) and to the matrix
    route, and the share of outputs equal to each; kernel, eager, plain and
    matrix-route ms; the bound (output written and coordinates read at the
    HBM rate). Its shape in the row kernels' terms: each line a table of R
    rows (its D nodes) and C columns (its width), N lookups."""
    import torch
    from tensoir_tpu_torch.ops import interp
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    lines = tuple(torch.randn((D, R), device=dev, generator=gen)
                  for _ in range(k))
    coords = torch.rand((N, 3), device=dev, generator=gen) * 2.2 - 1.1
    axes = (2, 1, 0)[:k]
    got = interp.line_taps(lines, coords, axes, extrapolate)
    plain = interp.line_taps_plain(lines, coords, axes, extrapolate)
    matrix = interp.line_matrix_product(lines, coords, axes, extrapolate)
    scale = None
    for line, axis in zip(lines, axes):
        i0, i1, w0, w1 = interp._taps(line, coords[..., axis], extrapolate)
        s = ((w0[..., None] * line[i0]).abs()
             + (w1[..., None] * line[i1]).abs())
        scale = s if scale is None else scale * s
    unit = (F32_EPS * scale.double()).clamp_min(1e-300)

    def ulps(want):
        return float(((got.double() - want.double()).abs() / unit).max())

    gaps = {"max_abs_err": float((got - plain).abs().max()),
            "ulps_vs_plain": ulps(plain), "ulps_vs_matrix": ulps(matrix),
            "equal_to_plain": float((got == plain).double().mean()),
            "equal_to_matrix": float((got == matrix).double().mean())}
    check(gaps["ulps_vs_plain"] <= 1.0
          and gaps["ulps_vs_matrix"] <= 2 * k - 1,
          f"line_taps k={k} D={D} R={R} N={N}: {gaps}")
    del plain, matrix, scale, unit
    run = (lambda: interp.line_taps(lines, coords, axes, extrapolate))
    return {"k": k, "R": D, "C": R, "N": N, "extrapolate": extrapolate,
            **gaps, "ms": graph_ms(run), "eager_ms": time_ms(run),
            "plain_ms": time_ms(lambda: interp.line_taps_plain(
                lines, coords, axes, extrapolate)),
            "library_ms": graph_ms(lambda: interp.line_matrix_product(
                lines, coords, axes, extrapolate)),
            "bound_ms": (4 * N * R + 12 * N) / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}


def line_taps_cases() -> dict:
    return {name: line_taps_case(*shape, seed=120 + i)
            for i, (name, shape) in enumerate(LINE_TAP_SHAPES.items())}


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
# bytes per launch on that path. The line-taps kernel's is one of its
# main-path cases (LINE_TAP_SHAPES): VM's appearance line of a secondary
# tile, the visibility march's density line where a path marches it (the
# relight script, the mesh export's dense alpha at the same width) and
# CP's three appearance lines on CP's paths; None where no lookup of the
# path is without a gradient (the radiance step)
_VM_TAPS = ("line_taps", "vm_app")


def _own(path: str, taps=_VM_TAPS) -> dict:
    """Each row kernel at the path's busiest shape (busiest_cases), the
    line taps at ``taps``."""
    return {**{name: (path, name) for name in ROW_KERNELS},
            "line_taps": taps}


PATH_CASES = {
    "train": {"row_gather": ("slice_density", "row_gather"),
              "row_gather_bf16": ("bf16", "train_alpha_mask"),
              "row_scatter_add": ("slice_density", "row_scatter_add"),
              "line_taps": None},
    "relight_train": {"row_gather": ("relight_density", "row_gather"),
                      "row_gather_bf16": ("bf16", "baked_grid"),
                      "row_scatter_add": ("relight_density",
                                          "row_scatter_add"),
                      "line_taps": _VM_TAPS},
    "bench_train": {"row_gather": ("bench_density", "row_gather"),
                    "row_gather_bf16": ("bf16", "bench_app_bake"),
                    "row_scatter_add": ("bench_density", "row_scatter_add"),
                    "line_taps": _VM_TAPS},
    # the busiest shape of each kernel in the training run, the eval (K2
    # does not launch there: None, its entry holds its launches and no
    # times) and the CLI run (busiest_cases)
    "train_run": _own("train_run"),
    "eval": {"row_gather": ("eval", "row_gather"),
             "row_gather_bf16": ("eval", "row_gather_bf16"),
             "row_scatter_add": None, "line_taps": _VM_TAPS},
    "cli_run": _own("cli_run"),
    # the relight script, exact (the default) and fast visibility: K2 does
    # not launch there either
    "relight": {"row_gather": ("relight", "row_gather"),
                "row_gather_bf16": ("relight", "row_gather_bf16"),
                "row_scatter_add": None,
                "line_taps": ("line_taps", "vis_density")},
    "relight_fast": {"row_gather": ("relight_fast", "row_gather"),
                     "row_gather_bf16": ("relight_fast", "row_gather_bf16"),
                     "row_scatter_add": None, "line_taps": _VM_TAPS},
    # the mesh export's dense alpha (no gradient: K2 does not launch), and
    # the CLI on each multi-light config
    "mesh_export": {"row_gather": ("mesh_export", "row_gather"),
                    "row_gather_bf16": ("mesh_export", "row_gather_bf16"),
                    "row_scatter_add": None,
                    "line_taps": ("line_taps", "vis_density")},
    "multilight_rotated": _own("multilight_rotated"),
    "multilight_general": _own("multilight_general"),
    # data-parallel: the grouped relight step on one NCCL rank, rank 0 of
    # the two gloo ranks' steps, rank 0 of the two-rank training run
    "dp_nccl": _own("dp_nccl"),
    "dp_gloo2": _own("dp_gloo2"),
    "dp_run": _own("dp_run"),
    # rank 0 of the CLI under the launcher, one NCCL rank
    "dp_launch": _own("dp_launch"),
    # the model variants: TensorCP has no plane gather (K1-f32 and K2 do
    # not launch: only its baked sigma grid and alpha mask, on K1-bf16);
    # the stacked TensorVM's sliced planes and the VM importance and bf16
    # steps run all three
    **{f"variants_{kind}_cp": {
        "row_gather": None,
        "row_gather_bf16": (f"variants_{kind}_cp", "row_gather_bf16"),
        "row_scatter_add": None,
        "line_taps": ("line_taps", "cp_app")} for kind in ("train", "cli")},
    **{path: _own(path)
       for path in ("variants_train_vm_stacked", "variants_train_vm",
                    "variants_cli_vm_stacked")},
    # the grouped knobs: bench.py's steps at their new rows (the 16-corner
    # block rows of march_group 4 and their gradient, the 27-corner rows of
    # the 64 bake at second_march_group 4), and the CLI run's busiest shapes
    "grouped_train": {
        "row_gather": ("grouped_block16_g4", "row_gather"),
        "row_gather_bf16": ("grouped_pair", "pair_b64_g4"),
        "row_scatter_add": ("grouped_block16_g4", "row_scatter_add"),
        "line_taps": _VM_TAPS},
    "grouped_cli": _own("grouped_cli"),
}
VARIANT_PATHS = ("variants_train_cp", "variants_train_vm_stacked",
                 "variants_train_vm", "variants_cli_cp",
                 "variants_cli_vm_stacked")
NEW_PATHS = ("mesh_export", "multilight_rotated", "multilight_general",
             "dp_nccl", "dp_gloo2", "dp_run", "dp_launch", *VARIANT_PATHS,
             "grouped_cli")
# the path whose numbers lead each kernel's summary entry: the CLI run
# (training, the evals, render-only), the one path that runs every kernel
# (K2 does not launch on the relight path, the line taps not in the
# radiance step)
MAIN_PATH = "cli_run"
_OWN_SHAPE_GROUPS = ("bf16", "train_run", "eval", "cli_run", "relight",
                     "relight_fast", "grouped_pair", "line_taps", *NEW_PATHS)


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
    launch_only = argv == ["--dp-launch"]
    variants_only = argv == ["--variants"]
    grouped_only = argv == ["--grouped"]
    taps_only = argv == ["--line-taps"]
    child = len(argv) == 3 and argv[0] == "--dp-child"
    if argv and not (steps_only or launch_only or variants_only
                     or grouped_only or taps_only or child):
        print("usage: python3 chip_smoke.py [--steps | --dp-launch | "
              "--variants | --grouped | --line-taps]", file=sys.stderr)
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
    if child:
        return dp_child(argv[1], json.loads(argv[2]))
    t_start = time.perf_counter()
    streams, launches, shapes = {}, {}, {}
    with tempfile.TemporaryDirectory() as work:
        if launch_only:
            return _run_launch(work, t_start)
        if variants_only:
            return _run_variants(t_start)
        if grouped_only:
            return _run_grouped(t_start)
        if taps_only:
            return _run_line_taps(t_start)
        return _run(steps_only, work, t_start, streams, launches, shapes)


def _run_variants(t_start: float) -> int:
    """--variants: the build and the three phases of the model variants
    only; it ends after them without the summary or the last line."""
    try:
        phase_build()
        _variant_phases()
    except SmokeFailure as exc:
        emit({"ok": False, "failure": str(exc)})
        return 1
    print(f"# total seconds {time.perf_counter() - t_start:.1f}",
          file=sys.stderr)
    return 0


def _run_grouped(t_start: float) -> int:
    """--grouped: the build, the three grouped phases and the grouped
    marches' kernel rows only; it ends after them without the summary or
    the last line."""
    try:
        phase_build()
        _grouped_phases()
        block, pair = grouped_kernel_cases()
        emit({"phase": "grouped_kernels", "ok": True,
              "block16": {f"g{g}": c for g, c in block.items()},
              "pair": pair})
    except SmokeFailure as exc:
        emit({"ok": False, "failure": str(exc)})
        return 1
    print(f"# total seconds {time.perf_counter() - t_start:.1f}",
          file=sys.stderr)
    return 0


def _run_line_taps(t_start: float) -> int:
    """--line-taps: the build and the line-taps kernel's cases only; it
    ends after them without the summary or the last line."""
    try:
        phase_build()
        emit({"phase": "line_taps", "ok": True, "cases": line_taps_cases()})
    except SmokeFailure as exc:
        emit({"ok": False, "failure": str(exc)})
        return 1
    print(f"# total seconds {time.perf_counter() - t_start:.1f}",
          file=sys.stderr)
    return 0


def _grouped_phases():
    """grouped_step_parity, grouped_train, grouped_cli: (launch counts per
    path, launches by shape), each phase's seconds on stderr."""
    launches, shapes = {}, {}
    t0 = time.perf_counter()
    phase_grouped_step_parity()
    print(f"# grouped_step_parity seconds {time.perf_counter() - t0:.1f}",
          file=sys.stderr, flush=True)
    for name, run in (("grouped_train", phase_grouped_train),
                      ("grouped_cli", phase_grouped_cli)):
        t0 = time.perf_counter()
        launches[name], counts = run()
        shapes.update(counts)
        print(f"# {name} seconds {time.perf_counter() - t0:.1f}",
              file=sys.stderr, flush=True)
    return launches, shapes


def _variant_phases():
    """variants_step_parity, variants_train, variants_cli: (launch counts
    per path, launches by shape), each phase's seconds on stderr."""
    launches, shapes = {}, {}
    t0 = time.perf_counter()
    phase_variants_step_parity()
    print(f"# variants_step_parity seconds {time.perf_counter() - t0:.1f}",
          file=sys.stderr, flush=True)
    for name, run in (("variants_train", phase_variants_train),
                      ("variants_cli", phase_variants_cli)):
        t0 = time.perf_counter()
        counts_by_path, counts = run()
        launches.update(counts_by_path)
        shapes.update(counts)
        print(f"# {name} seconds {time.perf_counter() - t0:.1f}",
              file=sys.stderr, flush=True)
    return launches, shapes


def _run_launch(work: str, t_start: float) -> int:
    """--dp-launch: only dp_launch, on every card of the machine, then on
    one card for comparison (when there are several)."""
    import torch
    n = torch.cuda.device_count()
    try:
        phase_build()
        for nproc in sorted({n, 1}, reverse=True):
            phase_dp_launch(work, nproc)
    except SmokeFailure as exc:
        emit({"ok": False, "failure": str(exc)})
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(" | ".join(smi.stdout.strip().splitlines()), flush=True)
    print(f"# total seconds {time.perf_counter() - t_start:.1f}",
          file=sys.stderr)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": n}})
    return 0


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
        launches["mesh_export"], counts = phase_mesh_export(ckpt)
        shapes.update(counts)
        phase_lpips()
        phase_multilight_step_parity()
        counts_by_path, counts = phase_multilight_cli()
        launches.update(counts_by_path)
        shapes.update(counts)
        counts_by_path, counts = _variant_phases()
        launches.update(counts_by_path)
        shapes.update(counts)
        counts_by_path, counts = _grouped_phases()
        launches.update(counts_by_path)
        shapes.update(counts)
        torch.cuda.empty_cache()    # the gloo ranks share this card
        for path, run in (("dp_nccl", phase_dp_nccl),
                          ("dp_gloo2", phase_dp_gloo2),
                          ("dp_run", phase_dp_run),
                          ("dp_launch", lambda w: phase_dp_launch(w, 1))):
            t0 = time.perf_counter()
            launches[path], counts = run(work)
            shapes.update(counts)
            print(f"# {path} seconds {time.perf_counter() - t0:.1f}",
                  file=sys.stderr, flush=True)
        cases = phase_kernels(streams, {
            path: {k: n for k, n in shapes.items() if k[0] == path}
            for path in ("train_run", "eval", "cli_run", "relight",
                         "relight_fast", *NEW_PATHS)})
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
