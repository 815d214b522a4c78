"""Secondary rays: visibility and indirect light for (surface point, light
direction) pairs (port of tensoir_tpu.render.secondary:
``_march_window``, ``compute_radiance``, ``secondary_shading_tiled``, and
``compute_transmittance``, the visibility-only march of relighting).

Each pair marches equally spaced samples toward the light, in one of three
ways:
- through the per-step baked, corner-packed bf16 sigma grid, one K1 row per
  sample: all ``second_n_sample`` samples (the default), or with
  ``second_window`` only that many samples of the 96-sample grid, which a
  prepass of the coarse occupancy finds around the occupied span (the
  window march);
- through the exact VM field on the first ``second_march_cap`` occupied
  samples.
The pairs whose march picks up weight then get the radiance field's colour
on their top-k samples, a fixed number of pairs per tile, from the VM
factors or from the baked per-light appearance grid (one K1 row of bf16
corners per sample). With ``secondary_compact_frac`` only the pairs above
the horizon are marched, packed into a fixed number of tiles. With
``second_march_group`` the window march reads one K1 row of a 27-corner
bf16 block pack per group of consecutive samples instead of one 8-corner
row per sample; with ``secondary_app_hoist`` the tiles only march, and the
colour of every tile's selected samples is computed at once after the last
tile. These knobs travel as one ``SecondaryKnobs``. The whole pass runs
without gradients, tile by tile, and never waits on the device but to read
which tiles hold a pair whose result the caller uses (``ray_used``: the
others are skipped) and to keep at most two replayed tiles queued there.

On CUDA every tile runs the same kernels on the same shapes, so the pass
captures one tile as CUDA graphs and replays them for each tile: a few
launches a tile in place of a few hundred. K1 stays out of the graphs: the
tile is captured in pieces, one ending at each K1 call, and a replay makes
each K1 call itself between its pieces, into the buffer the next piece
reads. A graph is kept per knob set and holds while the parameters and
scene keep their addresses and shapes (``tile_graph_key``); CPU tensors
take the eager tile. The machinery (``graph_runner``) takes any function
of fixed-shape inputs: the relight chunk's G-buffer pass and visibility
tile run through it too (``render/relight_pipeline.py``).
"""
from __future__ import annotations

import sys
from collections import deque
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from tensoir_tpu_torch.kernels import rows
from tensoir_tpu_torch.models import field as F
from tensoir_tpu_torch.ops.compositing import raw2alpha
from tensoir_tpu_torch.ops.interp import recip as _recip
from tensoir_tpu_torch.ops.rays import (linspace, sample_ray_equally,
                                        z_to_dists)
from tensoir_tpu_torch.profiling import span
from tensoir_tpu_torch.render import primary


@dataclass(frozen=True)
class SecondaryKnobs:
    """The knobs of the secondary march (``secondary_shading_tiled``), under
    the names ``TensoIRConfig`` and ``train.step.StepStatic`` give them; what
    each one does is set out beside its field in ``config.py``
    (``second_march_cap`` is the config's ``march_cap_secondary``,
    ``second_n_sample`` its ``second_nSample``). The defaults are the
    training step's."""
    second_march_cap: int = 32
    secondary_use_baked: bool = True
    secondary_bake_reso: int = 0
    second_window: int = 0
    second_window_back: int = 0
    second_prepass_n: int = 18
    coarse_dilate: int = 2
    secondary_compact_frac: float = 0.0
    second_march_group: int = 0
    group_bake_reso: int = 0
    app_bake_reso: int = 0
    secondary_app_hoist: bool = False
    second_app_cap: int = 16
    app_pair_frac: float = 0.0
    secondary_stats: bool = False
    second_window_probe: int = 0
    second_window_probe_back: int = 0
    second_n_sample: int = 96
    second_near: float = 0.05
    second_far: float = 1.5
    secondary_tile: int = 16384


# the canonical fast-march knobs (bench.py's configuration): window march
# over the coarse occupancy, hemisphere-pair compaction, the 128^3 sigma
# bake and the 64^3 baked appearance; the relight benchmark's fast
# visibility march takes its window, prepass, dilation and bake
FAST_MARCH_KNOBS = dict(
    second_window=48, second_window_back=16, second_prepass_n=12,
    coarse_dilate=3, secondary_compact_frac=0.5625,
    secondary_bake_reso=128, app_bake_reso=64)

# rows and tiles marched since the last reset (real pairs, or under the
# hemisphere compaction every row of its fixed capacity; not the padding of
# the last tile), and tiles skipped because no ray of theirs is used
# (``ray_used``): lets a run show how much secondary work its steps did
MARCHED = {"pairs": 0, "tiles": 0, "skipped": 0}


# tiles of ``secondary_shading_tiled`` since the last reset, each counted
# once by how it ran: captured as a CUDA graph (its warm-up gives its
# result), replayed from one, or eager (CPU tensors, or inside a capture)
TILE_GRAPH = {"captures": 0, "replays": 0, "eager": 0}


def reset_march_counts() -> None:
    for k in MARCHED:
        MARCHED[k] = 0


def reset_tile_graph_counts() -> None:
    for k in TILE_GRAPH:
        TILE_GRAPH[k] = 0


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(x, idx, axis=0)`` with JAX's clipping of indices past the
    end (``compact_nonzero`` marks unfilled slots with ``len(x)``)."""
    return x[idx.clamp(max=x.shape[0] - 1)]


def window_indices(coarse: torch.Tensor, packed_shape, aabb, o, d, *,
                   n_sample: int, vis_near: float, vis_far: float,
                   window: int, prepass_n: int, window_back: int = 0):
    """The window march's sample indices on the ``n_sample`` grid, jj [N,
    K] int32, and which of them to march, m [N, K] bool.

    A prepass looks up the coarse occupancy at ``prepass_n`` points spread
    over each ray's stretch inside the AABB (within [vis_near, vis_far]);
    the occupied points, widened by half the prepass spacing, bound the span
    [j0, j1]. The window takes ``window`` samples from j0, or with
    ``window_back`` a front part from j0 and a back part that ends at j1
    (never overlapping the front). Every quantity that places a sample is
    computed as the reference computes it under ``jit``, so the indices are
    the reference's on every device."""
    S = n_sample
    dt = (vis_far - vis_near) / (S - 1)
    dd = torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
    t0b = (aabb[0] - o) / dd
    t1b = (aabb[1] - o) / dd
    t_lo = torch.minimum(t0b, t1b).amax(-1).clamp(vis_near, vis_far)
    t_hi = torch.maximum(t0b, t1b).amin(-1).clamp(vis_near, vis_far)
    hit = t_hi > t_lo + 1e-9
    frac = linspace(0.0, 1.0, prepass_n, o.dtype, o.device)
    tp = t_lo[:, None] * (1.0 - frac) + t_hi[:, None] * frac     # [N, P]
    s_p = ((t_hi - t_lo) * _recip(prepass_n - 1))[:, None]      # [N, 1]
    xyz_p = o[:, None, :] + d[:, None, :] * tp[..., None]
    occ = F.coarse_occupancy_lookup(coarse, packed_shape,
                                    F.normalize_coord(aabb, xyz_p))
    occ = occ & hit[:, None]
    t_ent = torch.where(occ, tp - 0.5 * s_p, 1e9).amin(1)
    t_exit = torch.where(occ, tp + 0.5 * s_p, -1e9).amax(1)
    inv_dt = _recip(dt)
    j0 = torch.floor((t_ent - vis_near) * inv_dt).clamp(0, S - 1).int()
    j1 = torch.ceil((t_exit - vis_near) * inv_dt).clamp(0, S - 1).int()

    def run(start, n):
        return start[:, None] + torch.arange(n, dtype=torch.int32,
                                             device=o.device)
    if 0 < window_back < window:
        k_front = window - window_back
        start_b = torch.maximum(j1 - window_back + 1, j0 + k_front)
        jj = torch.cat([run(j0, k_front), run(start_b, window_back)], 1)
    else:
        jj = run(j0, window)
    m = occ.any(1)[:, None] & (jj <= j1[:, None]) & (jj <= S - 1)
    return jj, m


def _march_window(cfg, baked, coarse, aabb, o, d, *, n_sample: int,
                  vis_near: float, vis_far: float, window: int,
                  prepass_n: int, window_back: int = 0, baked27=None,
                  group: int = 2):
    """The window march: (coords [N, K, 3], sigma [N, K], dists [N, K]) at
    the canonical positions of the ``window_indices`` samples, the same as
    ``sample_ray_equally`` gives them. With the conservative coarse bake
    this is the full march up to the bake's feature threshold and to spans
    longer than the window.

    With ``baked27`` (the 27-corner pack) each run of ``group`` consecutive
    window samples reads one block row: the front and back windows are
    each a multiple of ``group`` (``secondary_shading_tiled`` checks it),
    so no group straddles their seam, and under ``check_pair_contract`` a
    group's cells are at most one apart per axis."""
    S = n_sample
    jj, m = window_indices(coarse, baked.shape, aabb, o, d, n_sample=S,
                           vis_near=vis_near, vis_far=vis_far, window=window,
                           prepass_n=prepass_n, window_back=window_back)
    tfrac = jj.to(o.dtype) * _recip(S - 1)
    z = vis_near * (1.0 - tfrac) + vis_far * tfrac
    xyz = o[:, None, :] + d[:, None, :] * z[..., None]
    valid = m & ((xyz >= aabb[0]) & (xyz <= aabb[1])).all(-1)
    coords = F.normalize_coord(aabb, xyz)
    if baked27 is not None:
        N, K, _ = coords.shape
        feat = F.density_feature_group_packed(
            baked27, coords.reshape(N, K // group, group, 3)).reshape(N, K)
    else:
        feat = F.density_feature_packed(baked, coords)
    sigma = torch.where(valid, F.feature2density(cfg, feat),
                        torch.zeros_like(feat))
    dt = torch.full_like(z, (vis_far - vis_near) / (S - 1))
    dists = torch.where(jj >= S - 1, torch.zeros_like(z), dt)
    return coords, sigma, dists


@torch.no_grad()
def compute_transmittance(
    cfg: F.FieldConfig,
    params: Dict,
    scene: Dict,
    surf_pts: torch.Tensor,       # [N, 3] world-space surface points
    light_in_dir: torch.Tensor,   # [N, 3] surface -> light unit dirs
    *,
    n_sample: int = 96,
    vis_near: float = 0.05,
    vis_far: float = 1.5,
    march_cap: int = 0,
    baked: Optional[torch.Tensor] = None,
    coarse: Optional[torch.Tensor] = None,
    baked27: Optional[torch.Tensor] = None,
    march_group: int = 2,
    window: int = 0,
    window_back: int = 0,
    prepass_n: int = 18,
):
    """Visibility only, for the relighting eval: (nerv_vis [N],
    nerfactor_vis [N]), the final transmittance and 1 - acc. The exact VM
    march (``march_cap``: its first occupied samples only), or with
    ``baked`` and ``coarse`` the window march on the baked grid (grouped
    by ``march_group`` with ``baked27``; the JAX package's baked march
    without a window has no caller)."""
    aabb = scene["aabb"]
    if baked is not None:
        if coarse is None or not 0 < window < n_sample:
            raise ValueError("the baked visibility march needs the coarse "
                             f"occupancy and 0 < window < {n_sample}")
        _, sigma, dists = _march_window(
            cfg, baked, coarse, aabb, surf_pts, light_in_dir,
            n_sample=n_sample, vis_near=vis_near, vis_far=vis_far,
            window=window, prepass_n=prepass_n, window_back=window_back,
            baked27=baked27, group=march_group)
    else:
        xyz, z_vals, valid = sample_ray_equally(surf_pts, light_in_dir, aabb,
                                                vis_near, vis_far, n_sample)
        dists = z_to_dists(z_vals.expand(xyz.shape[:2]))
        if 0 < march_cap < n_sample:
            occ = F.sample_alpha_mask_nearest(scene, xyz)
            midx, valid = primary.select_occupied_samples(valid & occ,
                                                          march_cap)
            dists = primary.take_samples(dists, midx)
            xyz = primary.take_samples(xyz, midx)
        valid = valid & (F.sample_alpha_mask(scene, xyz) > 0)
        feat = F.density(cfg, params, F.normalize_coord(aabb, xyz))
        sigma = torch.where(valid, feat, torch.zeros_like(feat))
    _, weight, transmittance = raw2alpha(sigma, dists * cfg.distance_scale)
    return transmittance[..., 0], 1.0 - weight.sum(-1)


def _window_probe(sigma, weight, pair_ok, window: int, window_back: int):
    """The weight a front (and back) window of the given size would cut off
    the full march, and the full march's total weight: the span runs from
    the first to the last sample with sigma > 0. A subnormal sigma counts
    as 0, as in the reference, whose backends flush subnormal results to
    zero (a softplus far below the shift leaves one here)."""
    S = sigma.shape[1]
    occ = sigma >= torch.finfo(sigma.dtype).tiny
    if pair_ok is not None:
        occ = occ & pair_ok[:, None]       # the tiles' padding pairs
    iota = torch.arange(S, device=sigma.device)
    j0 = torch.where(occ, iota, S).amin(1)
    j1 = torch.where(occ, iota, -1).amax(1)
    split = 0 < window_back < window
    front_end = j0 + (window - window_back if split else window)
    lost = iota >= front_end[:, None]
    if split:
        lost = lost & (iota < torch.maximum(j1 - window_back + 1,
                                            front_end)[:, None])
    w = torch.where(occ.any(1)[:, None], weight, torch.zeros_like(weight))
    return {"window_lost_w": (w * lost).sum(), "window_tot_w": w.sum()}


def compute_radiance(
    cfg: F.FieldConfig,
    params: Dict,
    scene: Dict,
    surf_pts: torch.Tensor,       # [N, 3] world-space surface points
    light_in_dir: torch.Tensor,   # [N, 3] surface -> light unit dirs
    light_idx: torch.Tensor,      # [N] int
    *,
    n_sample: int = 96,
    vis_near: float = 0.05,
    vis_far: float = 1.5,
    app_cap: int = 16,
    app_pair_cap: int = 0,
    march_cap: int = 0,
    baked: Optional[torch.Tensor] = None,
    coarse: Optional[torch.Tensor] = None,
    baked27: Optional[torch.Tensor] = None,
    march_group: int = 2,
    app_baked=None,
    window: int = 0,
    window_back: int = 0,
    prepass_n: int = 18,
    return_app_payload: bool = False,
    return_stats: bool = False,
    pair_ok: Optional[torch.Tensor] = None,
    probe_window: int = 0,
    probe_window_back: int = 0,
):
    """March secondary rays: (nerv_vis [N], nerfactor_vis [N],
    indirect [N, 3]), and with ``return_stats`` a dict of the tile's cap
    occupancy.

    Visibility is the final transmittance ('nerv') or 1 - acc
    ('nerfactor'); indirect light is the weight-composited radiance-field
    RGB along the ray, from the VM factors or from ``app_baked`` = (the
    per-light app bake, its cell counts). ``pair_ok`` marks real pairs:
    padding pairs march but claim no slot of the ``app_pair_cap`` pairs
    that reach the app stage. ``probe_window`` adds to the stats the weight
    a window march of that size would lose, measured on the full baked
    march.

    With ``return_app_payload`` the colour is not computed here: the third
    value is the app stage's inputs instead, a dict of ``pts_sel`` [cap,
    k, 3], ``w_sel`` [cap, k], ``dirs`` [cap, 3], ``lidx`` [cap],
    ``pair_idx`` [cap] (the pair of each slot; ``N`` for an unfilled one)
    and ``pair_valid`` [cap], for ``_app_stage_global``."""
    aabb = scene["aabb"]
    windowed = (baked is not None and coarse is not None
                and 0 < window < n_sample)
    if windowed:
        coords, sigma, dists = _march_window(
            cfg, baked, coarse, aabb, surf_pts, light_in_dir,
            n_sample=n_sample, vis_near=vis_near, vis_far=vis_far,
            window=window, prepass_n=prepass_n, window_back=window_back,
            baked27=baked27, group=march_group)
    else:
        xyz, z_vals, valid = sample_ray_equally(surf_pts, light_in_dir, aabb,
                                                vis_near, vis_far, n_sample)
        dists = z_to_dists(z_vals.expand(xyz.shape[:2]))
        coords = F.normalize_coord(aabb, xyz)
        if baked is not None:
            # the alpha mask is folded into the bake, so no cull here
            feat = F.density_feature_packed(baked, coords)
            sigma = torch.where(valid, F.feature2density(cfg, feat),
                                torch.zeros_like(feat))
        else:  # the exact VM march
            if 0 < march_cap < n_sample:
                occ = F.sample_alpha_mask_nearest(scene, xyz)
                midx, valid = primary.select_occupied_samples(valid & occ,
                                                              march_cap)
                coords = primary.take_samples(coords, midx)
                dists = primary.take_samples(dists, midx)
                xyz = primary.take_samples(xyz, midx)
            valid = valid & (F.sample_alpha_mask(scene, xyz) > 0)
            feat = F.density(cfg, params, coords)
            sigma = torch.where(valid, feat, torch.zeros_like(feat))
    _, weight, transmittance = raw2alpha(sigma, dists * cfg.distance_scale)

    probe = None
    if (return_stats and probe_window > 0 and not windowed
            and not (baked is None and 0 < march_cap < n_sample)):
        probe = _window_probe(sigma, weight, pair_ok, probe_window,
                              probe_window_back)

    # indirect light, compacted twice: a fixed number of pairs with any
    # sample above the weight threshold, then their top app_cap samples
    N, S = sigma.shape
    masked_w = torch.where(weight > cfg.raymarch_weight_thres, weight,
                           torch.zeros_like(weight))
    if pair_ok is not None:
        masked_w = torch.where(pair_ok[:, None], masked_w,
                               torch.zeros_like(masked_w))
    pair_cap = app_pair_cap if 0 < app_pair_cap < N else N
    pair_idx = None
    if pair_cap < N:
        # any pair with weight, up to the cap, in index order
        pair_idx, pair_valid = primary.compact_nonzero(masked_w.amax(1),
                                                       pair_cap)
        sub_w = _take_rows(masked_w, pair_idx)
        sub_coords = _take_rows(coords, pair_idx)
        sub_dirs = _take_rows(light_in_dir, pair_idx)
        sub_lidx = _take_rows(light_idx, pair_idx)
    else:
        pair_valid = torch.ones((N,), dtype=torch.bool, device=sigma.device)
        sub_w, sub_coords = masked_w, coords
        sub_dirs, sub_lidx = light_in_dir, light_idx

    k = app_cap if 0 < app_cap < S else S
    if k < S:
        top_w, top_idx = torch.topk(sub_w, k, dim=1)
        pts_sel = primary.take_samples(sub_coords, top_idx)
        w_sel = top_w * (top_w > 0.0)
    else:
        pts_sel, w_sel = sub_coords, sub_w

    nerv_vis = transmittance[..., 0]
    nerfactor_vis = 1.0 - weight.sum(-1)
    if return_app_payload:
        return nerv_vis, nerfactor_vis, {
            "pts_sel": pts_sel, "w_sel": w_sel, "dirs": sub_dirs,
            "lidx": sub_lidx,
            "pair_idx": (pair_idx if pair_idx is not None else
                         torch.arange(N, device=sigma.device)),
            "pair_valid": pair_valid}

    sub_indirect = _app_stage(cfg, params, pts_sel, w_sel, sub_dirs,
                              sub_lidx, app_baked) * pair_valid[:, None]
    if pair_idx is None:
        indirect = sub_indirect
    else:
        # scatter back; unfilled slots (marker N) land in a dump row that is
        # cut off, the only row written more than once
        indirect = sub_indirect.new_zeros((N + 1, 3)).index_copy(
            0, pair_idx, sub_indirect)[:N]
    if not return_stats:
        return nerv_vis, nerfactor_vis, indirect

    # cap occupancy: pairs with weight before and after the pair cap, and
    # the slots of the kept pairs that carry weight. Unfilled slots read a
    # clipped row here (NaN in the reference), so only kept pairs count.
    f32 = torch.float32
    demand = torch.where(pair_valid, (sub_w > 0.0).sum(1), 0)
    stats = {"valid_pairs": (masked_w.amax(1) > 0.0).sum(dtype=f32),
             "kept_pairs": pair_valid.sum(dtype=f32),
             "valid_slots": ((w_sel > 0.0) & pair_valid[:, None]).sum(
                 dtype=f32),
             "slot_demand_max": demand.amax().to(f32),
             "slot_overflow_pairs": (demand > k).sum(dtype=f32),
             "pair_cap": sigma.new_full((), float(pair_cap)),
             "slot_cap": sigma.new_full((), float(k))}
    if probe is not None:
        stats.update(probe)
    return nerv_vis, nerfactor_vis, indirect, stats


def _app_stage(cfg, params, pts_sel, w_sel, dirs, lidx,
               app_baked) -> torch.Tensor:
    """Indirect light [M, 3] of M pairs: the radiance field's colour at
    their selected samples pts_sel [M, k, 3] (from the VM factors, or from
    ``app_baked``), composited with the weights w_sel [M, k]; dirs [M, 3]
    and lidx [M] are each pair's light direction and light."""
    vdirs = dirs[:, None, :].expand(pts_sel.shape)
    li = lidx[:, None].expand(pts_sel.shape[:2])
    if app_baked is not None:
        feat = F.app_feature_baked(*app_baked, pts_sel, li)
    else:
        feat = F.app_feature(cfg, params, pts_sel, li)
    rgb = primary.shade_radiance(cfg, params, pts_sel, vdirs, feat)
    return (w_sel[..., None] * rgb).sum(-2)


def _app_stage_global(cfg, params, payload: Dict, app_baked,
                      tile: int) -> torch.Tensor:
    """The app stage of every tile at once, on their payloads stacked to
    [T, cap, ...]: the same arithmetic as each tile's own app stage, in one
    batch of T times its size. Returns the indirect light [T, tile, 3],
    each tile's pairs put back through its ``pair_idx``; an unfilled slot
    (``pair_idx == tile``) writes a dump row that is cut off, as the
    reference's dropped scatter."""
    pts_sel, w_sel = payload["pts_sel"], payload["w_sel"]
    T, cap, k, _ = pts_sel.shape
    sub = _app_stage(cfg, params, pts_sel.reshape(T * cap, k, 3),
                     w_sel.reshape(T * cap, k),
                     payload["dirs"].reshape(T * cap, 3),
                     payload["lidx"].reshape(T * cap), app_baked)
    sub = sub * payload["pair_valid"].reshape(T * cap, 1)
    rows = (torch.arange(T, device=sub.device)[:, None] * (tile + 1)
            + payload["pair_idx"]).reshape(-1)
    ind = sub.new_zeros((T * (tile + 1), 3)).index_copy(0, rows, sub)
    return ind.reshape(T, tile + 1, 3)[:, :tile]


def _reduce_stats(ts: Dict, *, n_tiles: int, app_pair_cap: int,
                  compact_overflow: Optional[torch.Tensor]) -> Dict:
    """The pass's occupancy statistics from the per-tile ones, ``ts`` a
    dict of [n_tiles] tensors."""
    valid = ts["valid_pairs"].sum()
    kept = ts["kept_pairs"].sum()
    stats = {
        # the most weight-bearing samples any kept pair has, and the pairs
        # with more than second_app_cap of them
        "app_slot_demand_max": ts["slot_demand_max"].amax(),
        "app_slot_overflow_pairs": ts["slot_overflow_pairs"].sum(),
        # pairs with weight that did not fit their tile's app pair cap
        "app_pair_overflow_frac": ((valid - kept).clamp_min(0.0)
                                   / valid.clamp_min(1.0)),
        "app_pair_occupancy": valid * _recip(n_tiles * app_pair_cap),
        "app_slot_occupancy": (ts["valid_slots"].sum()
                               / (kept * ts["slot_cap"][0]).clamp_min(1.0)),
        # pairs above the horizon dropped by the compaction's capacity
        "compact_overflow_frac": (compact_overflow if compact_overflow
                                  is not None else valid.new_zeros(())),
    }
    if "window_lost_w" in ts:
        # the weight the configured window would cut off, over the marched
        # total; 1.0 ("not safe") when nothing was marched
        tot = ts["window_tot_w"].sum()
        stats["window_resid_rel"] = torch.where(
            tot > 0.0, ts["window_lost_w"].sum() / tot.clamp_min(1e-6),
            torch.ones_like(tot))
    return stats


# the app stage's inputs that a tile of the hoisted pass hands on, in order
_PAYLOAD = ("pts_sel", "w_sel", "dirs", "lidx", "pair_idx", "pair_valid")


def _tile(cfg, params, scene, pts, dirs, lidx, ok, tables, knobs):
    """One tile of ``secondary_shading_tiled``: (outputs, stat names). The
    outputs are the visibility [tile], zero outside ``ok``, then either the
    indirect light [tile, 3], zero outside ``ok``, or the app payload's
    ``_PAYLOAD`` entries, then with ``return_stats`` the tile's statistics
    stacked in the order of the names. ``tables`` are the pass's baked
    grids (baked, coarse, baked27, app grid; None where absent), ``knobs``
    ``compute_radiance``'s static arguments and the app grid's cells."""
    baked, coarse, baked27, app_grid = tables
    knobs = dict(knobs)
    cells = knobs.pop("app_cells")
    out = compute_radiance(
        cfg, params, scene, pts, dirs, lidx, baked=baked, coarse=coarse,
        baked27=baked27,
        app_baked=None if app_grid is None else (app_grid, cells),
        pair_ok=ok, **knobs)
    mf = ok.to(out[0].dtype)
    outs = [out[0] * mf]
    if knobs["return_app_payload"]:
        outs += [out[2][k] for k in _PAYLOAD]
    else:
        outs.append(out[2] * mf[:, None])
    names = ()
    if knobs["return_stats"]:
        names = tuple(out[3])
        outs.append(torch.stack([out[3][k] for k in names]))
    return tuple(outs), names


def _meta(t: Optional[torch.Tensor]):
    return None if t is None else (tuple(t.shape), t.stride(), t.dtype,
                                   t.device)


def _tensors(tree: Dict, prefix: str = ""):
    """(path, tensor) of every tensor in a nested dict, in key order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _tensors(v, f"{prefix}{k}/")
        elif isinstance(v, torch.Tensor):
            yield f"{prefix}{k}", v


def tile_graph_key(fn, cfg, params: Dict, scene: Dict, tables,
                   knobs: Dict, inputs):
    """(knob set, tensor key) of the graph of ``fn(*inputs, tables)``, a
    function of fixed-shape inputs (a tile). The knob set: ``fn``'s code,
    the field's config, every static knob of ``fn``, and the shape, stride,
    dtype and device of its inputs; a knob set has one graph. The tensor
    key: the same of the baked tables (copied in before the replays, so
    not their addresses), and of every tensor in ``params`` and ``scene``
    with its address, which the graph reads in place. Adam's in-place
    updates keep it; a mask, shrink or upsample replaces tensors and
    changes it."""
    knob_set = (fn.__code__, cfg, tuple(sorted(knobs.items())),
                tuple(_meta(x) for x in inputs))
    tensors = (tuple(_meta(t) for t in tables),
               tuple((path, _meta(t), t.data_ptr()) for path, t in
                     _tensors({"params": params, "scene": scene})))
    return knob_set, tensors


# one tile graph per captured function and knob set, a new tensor key
# replacing it; the knob sets used last, at most _MAX_GRAPHS of them (a
# process that trains, evaluates and relights uses four: its step's tile,
# its eval's tile, the relight chunk's G-buffer pass and its visibility
# tile, one route of it at a time)
_GRAPHS: Dict = {}
_MAX_GRAPHS = 6
# the stream of the warm-ups and captures, per device
_SIDE: Dict = {}
# the operator that replays a piece, once defined; the piece it replays
_OP = None
_REPLAYING = []
# replayed tiles the host keeps queued on the card: before it launches a
# tile it waits for the one _AHEAD tiles back. The device always has a
# tile to run, and the driver's launch queue never fills: a launch into a
# full queue blocks inside the replay's operator, and a profiler then
# charges the kernels of that launch twice (to the operator and to the
# block inside it)
_AHEAD = 2


def _replay(piece: torch.cuda.CUDAGraph, anchor: torch.Tensor) -> None:
    """``piece.replay()`` inside an operator of its own
    (``tensoir::replay_graph``, ``anchor`` any tensor on the card). A
    profiler charges each kernel to the operator whose launch ran it; a
    bare replay runs inside none, and its kernels would belong to no range
    of the program (``profiling.span``)."""
    global _OP
    if _OP is None:
        lib = torch.library.Library("tensoir", "DEF")
        lib.define("replay_graph(Tensor anchor) -> ()")
        lib.impl("replay_graph", lambda anchor: _REPLAYING.pop().replay(),
                 "CUDA")
        _OP = (lib, torch.ops.tensoir.replay_graph)
    _REPLAYING.append(piece)
    _OP[1](anchor)


def _through_row_gather_fn(stop) -> bool:
    """Whether the K1 call being captured comes through ``RowGather.apply``
    (``kernels.gather_rows``, an operator that a profiler charges K1's time
    to) rather than straight from the field; ``stop`` is the code of the
    captured function, where the search ends."""
    f = sys._getframe(1)
    while f is not None:
        if f.f_code is rows.RowGather.forward.__code__:
            return True
        if f.f_code is stop:
            return False
        f = f.f_back
    return False


class _TileGraph:
    """A tile (any function of fixed-shape inputs) captured as CUDA graphs
    in pieces, K1 launched between them: static copies of the tile's inputs
    and of its tables, the pieces, after each piece but the last its K1
    call (whether through ``RowGather``, table, index, the output buffer
    the next piece reads), the outputs the capture allocated, the launches
    of the kernels captured inside the pieces (each replay adds them to
    ``kernels.LAUNCHES``; the capture launches nothing), and the events of
    the tiles queued on the card. Each capture and replay counts in
    ``counts`` under ``prefix`` + ``captures`` or ``replays``."""

    def __init__(self, key, counts: Dict, prefix: str = ""):
        self.key = key
        self.counts, self.prefix = counts, prefix
        self.pieces = []
        self.queued = deque()

    def capture(self, tile_fn, xs, tables):
        """Run ``tile_fn(*xs, tables)`` once on a side stream (its result is
        the tile's), then capture it on static copies of ``xs`` and
        ``tables``, a new piece after each K1 call; returns the first run's
        (outputs, names)."""
        cur = torch.cuda.current_stream()
        side = _SIDE.get(cur.device)
        if side is None:
            side = _SIDE[cur.device] = torch.cuda.Stream(cur.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            outs, names = tile_fn(*xs, tables)
        cur.wait_stream(side)
        for o in outs:
            o.record_stream(cur)
        self.inputs = [x.clone() for x in xs]
        self.tables = [None if t is None else t.clone() for t in tables]
        self.calls = []
        pool = torch.cuda.graph_pool_handle()

        def begin():
            piece = torch.cuda.CUDAGraph()
            piece.capture_begin(pool=pool, capture_error_mode="thread_local")
            self.pieces.append(piece)

        def split(table, idx):
            # the piece ends at K1, which each replay launches itself, the
            # way the tile called it
            self.pieces[-1].capture_end()
            out = torch.empty((idx.shape[0], table.shape[1]),
                              dtype=table.dtype, device=table.device)
            self.calls.append((_through_row_gather_fn(tile_fn.__code__),
                               table, idx, out))
            begin()
            return out

        torch.cuda.synchronize()
        before = dict(rows.LAUNCHES)
        with torch.cuda.stream(side):
            begin()
            rows.PIECES["split"] = split
            try:
                self.outputs, self.names = tile_fn(*self.inputs, self.tables)
            finally:
                rows.PIECES["split"] = None
                self.pieces[-1].capture_end()
        self.launches = {k: rows.LAUNCHES[k] - n for k, n in before.items()
                         if rows.LAUNCHES[k] != n}
        for k, n in self.launches.items():
            rows.LAUNCHES[k] -= n
        self.counts[self.prefix + "captures"] += 1
        return outs, names

    def load(self, tables) -> None:
        for buf, t in zip(self.tables, tables):
            if buf is not None:
                buf.copy_(t)

    def replay(self, *xs):
        """The tile on inputs ``xs``: (outputs, names). The outputs are the
        graph's own, overwritten by the next replay."""
        while len(self.queued) >= _AHEAD:
            self.queued.popleft().synchronize()
        for buf, x in zip(self.inputs, xs):
            buf.copy_(x)
        for i, piece in enumerate(self.pieces):
            _replay(piece, self.inputs[0])
            if i < len(self.calls):
                through_fn, table, idx, out = self.calls[i]
                rows.PIECES["out"] = out
                try:
                    got = (rows.RowGather.apply(table, idx) if through_fn
                           else rows.row_gather(table, idx))
                finally:
                    rows.PIECES["out"] = None
                if got.data_ptr() != out.data_ptr():
                    raise RuntimeError("K1 did not write the buffer of the "
                                       "tile graph's next piece")
        for k, n in self.launches.items():
            rows.LAUNCHES[k] += n
        self.queued.append(torch.cuda.Event())
        self.queued[-1].record()
        self.counts[self.prefix + "replays"] += 1
        return self.outputs, self.names


def graph_runner(fn, cfg, params, scene, tables, knobs: Dict, first,
                 counts: Dict, prefix: str = ""):
    """``run(*xs) -> (outputs, names)``, ``fn(*xs, tables)`` for calls in
    turn: ``fn`` a function of fixed-shape inputs ``xs`` that reads the
    ``tables``, ``params`` and ``scene`` and returns a tuple of tensors and
    a tuple of names, ``knobs`` its static arguments, ``first`` the first
    call's inputs (only their shapes, strides, dtypes and devices key the
    graph). On CUDA a replay of the knob set's graph (``tile_graph_key``),
    captured on the first call ``run`` is given where its tensor key is
    new; the outputs are the graph's own, which the next replay
    overwrites. For CPU tensors, or inside another capture, ``fn`` itself.
    Each call counts once in ``counts``: as ``prefix`` + ``captures`` or
    ``replays``, or as ``eager``."""
    if not first[0].is_cuda or torch.cuda.is_current_stream_capturing():
        def eager(*xs):
            counts["eager"] += 1
            return fn(*xs, tables)
        return eager
    knob_set, key = tile_graph_key(fn, cfg, params, scene, tables, knobs,
                                   first)
    graph = _GRAPHS.pop(knob_set, None)
    if graph is not None and graph.key == key:
        _GRAPHS[knob_set] = graph
        graph.load(tables)
    else:
        # the old graph, its pool and its buffers go before the new capture
        while len(_GRAPHS) >= _MAX_GRAPHS:
            del _GRAPHS[next(iter(_GRAPHS))]
        graph = _TileGraph(key, counts, prefix)

    def run(*xs):
        # capture and replay on the inputs' card's streams
        with torch.cuda.device(xs[0].device):
            if graph.pieces:
                return graph.replay(*xs)
            out = graph.capture(fn, xs, tables)
        _GRAPHS[knob_set] = graph
        return out
    return run


def _tile_runner(cfg, params, scene, tables, knobs, first):
    """``run(pts, dirs, lidx, ok) -> (outputs, names)`` for the pass's
    tiles in turn, ``first`` the first tile's inputs: the knob set's tile
    graph on CUDA, the eager tile for CPU tensors (``graph_runner``)."""
    return graph_runner(
        lambda *ys: _tile(cfg, params, scene, *ys, knobs), cfg, params,
        scene, tables, knobs, first, TILE_GRAPH)


@torch.no_grad()
def secondary_shading_tiled(
    cfg: F.FieldConfig,
    params: Dict,
    scene: Dict,
    surf_pts: torch.Tensor,      # [P, 3]
    surf2light: torch.Tensor,    # [P, L, 3]
    light_idx: torch.Tensor,     # [P] int
    pair_mask: torch.Tensor,     # [P, L] bool (cosine mask)
    secondary: SecondaryKnobs,
    ray_used: Optional[torch.Tensor] = None,    # [P] bool
):
    """Visibility [P, L, 1] and indirect light [P, L, 3] of every (surface
    point, light dir) pair, marched ``secondary_tile`` pairs at a time;
    pairs outside ``pair_mask`` get zeros. With ``secondary_stats`` also
    the pass's cap occupancy statistics (a dict of 0-d tensors).

    ``ray_used`` marks the points whose results the caller reads (None:
    all). Without compaction, hoist or stats, a tile that holds no pair of
    a used point is not marched (``MARCHED["skipped"]``) and gets zeros,
    so the pass reads the tiles' flags to the host once; every other tile
    marches the pairs it would march without ``ray_used``, bit for bit.

    ``secondary_compact_frac`` in (0, 1) marches only the pairs in
    ``pair_mask``, packed in order into ceil(P L frac / tile) tiles; pairs
    past that capacity get zeros (``compact_overflow_frac`` counts them).
    ``second_march_group`` > 1 groups the window march's samples on a
    27-corner pack baked at ``group_bake_reso`` (or
    ``secondary_bake_reso``); the caller checks its contract
    (``F.check_pair_contract``). ``secondary_app_hoist`` computes every
    tile's colour in one batch after the march (its stats dict is empty).
    Runs without gradients, as the reference's secondary pass does. On CUDA
    each tile is a replay of its knob set's CUDA graphs, K1 launched
    between them (``_tile_runner``), bit for bit the eager tile."""
    k = secondary
    tile, window = k.secondary_tile, k.second_window
    group = k.second_march_group
    P, L, _ = surf2light.shape
    total = P * L
    compact = 0.0 < k.secondary_compact_frac < 1.0
    todo = None     # the tiles to march, where some are skipped
    if ray_used is not None and not (compact or k.secondary_app_hoist
                                     or k.secondary_stats):
        n_tiles = -(-total // tile)
        used = ray_used[:, None].expand(P, L).reshape(-1)
        used = torch.cat([used, used.new_zeros(n_tiles * tile - total)])
        flags = used.reshape(n_tiles, tile).any(1).tolist()
        todo = [t for t, f in enumerate(flags) if f]
        MARCHED["skipped"] += n_tiles - len(todo)
        if not todo:
            return (surf_pts.new_zeros((P, L, 1)),
                    surf_pts.new_zeros((P, L, 3)))
    baked = coarse = baked27 = app_baked = None
    if k.secondary_use_baked:
        with span("bake"):
            baked = F.bake_packed_sigma_grid(cfg, params, scene,
                                             max_reso=k.secondary_bake_reso)
            if 0 < window < k.second_n_sample:
                coarse = F.bake_coarse_occupancy(baked,
                                                 dilate=k.coarse_dilate)
                if group > 1:
                    # groups must not straddle the front/back seam
                    back = k.second_window_back
                    if (window - back) % group or back % group:
                        raise ValueError(
                            f"second_march_group={group} must divide "
                            f"both the front window ({window - back}) and "
                            f"the back window ({back})")
                    baked27 = F.bake_pair_packed_sigma_grid(
                        cfg, params, scene,
                        max_reso=k.group_bake_reso or k.secondary_bake_reso)
            # CP has no appearance bake: it keeps the exact app stage
            if k.app_bake_reso > 0 and cfg.decomp in ("vm", "vm_stacked"):
                grid = F.bake_app_feature_grid(cfg, params,
                                               max_reso=k.app_bake_reso)
                cells = F.app_bake_cells(cfg, params, k.app_bake_reso)
                assert int(np.prod(cells)) == grid.shape[1], (cells,
                                                              grid.shape)
                app_baked = (grid, cells)

    pts = surf_pts[:, None, :].expand(P, L, 3).reshape(-1, 3)
    dirs = surf2light.reshape(-1, 3)
    lidx = light_idx[:, None].expand(P, L).reshape(-1)
    mask = pair_mask.reshape(-1)
    compact_overflow = None
    if compact:
        # march only the pairs above the horizon, in order, up to cap
        cap = -(-int(total * k.secondary_compact_frac) // tile) * tile
        cidx, cvalid = primary.compact_nonzero(mask, cap)
        src = cidx.clamp(max=total - 1)
        pts, dirs, lidx = pts[src], dirs[src], lidx[src]
        if k.secondary_stats:
            n_in = mask.sum(dtype=torch.float32)
            compact_overflow = ((n_in - cvalid.sum(dtype=torch.float32))
                                .clamp_min(0.0) / n_in.clamp_min(1.0))
        mask = cvalid
        n_rows = cap
        app_pair_cap = tile // 2    # twice the weight-bearing pairs per tile
    else:
        n_rows = total
        app_pair_cap = tile // 4
    if 0.0 < k.app_pair_frac <= 1.0:
        app_pair_cap = max(1, int(tile * k.app_pair_frac))

    n_tiles = -(-n_rows // tile)
    pad = n_tiles * tile - n_rows
    if pad:
        pts = torch.cat([pts, pts.new_zeros((pad, 3))])
        dirs = torch.cat([dirs, dirs.new_ones((pad, 3))])
        lidx = torch.cat([lidx, lidx.new_zeros((pad,))])
        mask = torch.cat([mask, mask.new_zeros((pad,))])

    hoist = k.secondary_app_hoist
    tables = (baked, coarse, baked27,
              None if app_baked is None else app_baked[0])
    # compute_radiance's static arguments, under its own names
    knobs = dict(n_sample=k.second_n_sample, vis_near=k.second_near,
                 vis_far=k.second_far, app_cap=k.second_app_cap,
                 app_pair_cap=app_pair_cap, march_cap=k.second_march_cap,
                 march_group=max(group, 2), window=window,
                 window_back=k.second_window_back,
                 prepass_n=k.second_prepass_n, return_app_payload=hoist,
                 return_stats=k.secondary_stats and not hoist,
                 probe_window=k.second_window_probe,
                 probe_window_back=k.second_window_probe_back,
                 app_cells=None if app_baked is None else tuple(app_baked[1]))
    rows = names = None     # each output of the tiles, [n_tiles, ...]
    new = torch.Tensor.new_empty if todo is None else torch.Tensor.new_zeros
    with span("secondary_march"):
        run = _tile_runner(cfg, params, scene, tables, knobs,
                           (pts[:tile], dirs[:tile], lidx[:tile], mask[:tile]))
        for t in range(n_tiles) if todo is None else todo:
            sl = slice(t * tile, (t + 1) * tile)
            outs, names = run(pts[sl], dirs[sl], lidx[sl], mask[sl])
            if rows is None:
                rows = [new(o, (n_tiles,) + o.shape) for o in outs]
            for r, o in zip(rows, outs):
                r[t].copy_(o)
            MARCHED["pairs"] += min(tile, n_rows - t * tile)
            MARCHED["tiles"] += 1
    vis = rows[0].reshape(-1)
    if hoist:
        with span("app_stage_global"):
            payload = dict(zip(_PAYLOAD, rows[1:]))
            ind = _app_stage_global(cfg, params, payload, app_baked, tile)
            ind = ind.reshape(-1, 3) * mask.to(ind.dtype)[:, None]
    else:
        ind = rows[1].reshape(-1, 3)
    if compact:
        # one scatter of [cap, 4] rows back to the pairs; unfilled slots
        # (marker total) land in a dump row that is cut off
        both = torch.cat([vis[:cap, None], ind[:cap]], -1)
        out = both.new_zeros((total + 1, 4)).index_copy(0, cidx, both)
        vis, ind = out[:total, :1], out[:total, 1:]
    else:
        vis, ind = vis[:total, None], ind[:total]
    vis, ind = vis.reshape(P, L, 1), ind.reshape(P, L, 3)
    if not k.secondary_stats:
        return vis, ind
    if hoist:
        return vis, ind, {}
    ts = dict(zip(names, rows[-1].t().contiguous()))
    return vis, ind, _reduce_stats(ts, n_tiles=n_tiles,
                                   app_pair_cap=app_pair_cap,
                                   compact_overflow=compact_overflow)
