"""Secondary rays: visibility and indirect light for (surface point, light
direction) pairs (port of tensoir_tpu.render.secondary:
``_march_window``, ``compute_radiance``, ``secondary_shading_tiled``, and
``compute_transmittance``, the visibility-only march of relighting).

Each pair marches equally spaced samples toward the light, in one of three
ways:
- through the per-step baked, corner-packed bf16 sigma grid, one K1 row per
  sample: all ``n_sample`` samples (the default), or with ``window`` only
  the ``window`` samples of the 96-sample grid that a prepass of the coarse
  occupancy finds around the occupied span (the window march);
- through the exact VM field on the first ``march_cap`` occupied samples.
The pairs whose march picks up weight then get the radiance field's colour
on their top-k samples, a fixed number of pairs per tile, from the VM
factors or from the baked per-light appearance grid (one K1 row of bf16
corners per sample). With ``compact_frac`` only the pairs above the
horizon are marched, packed into a fixed number of tiles. The whole pass
runs without gradients, tile by tile, and never waits on the device.

Not ported yet, and raising: the grouped fine march and the global app
stage.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from tensoir_tpu_torch.models import field as F
from tensoir_tpu_torch.ops.compositing import raw2alpha
from tensoir_tpu_torch.ops.interp import recip as _recip
from tensoir_tpu_torch.ops.rays import (linspace, sample_ray_equally,
                                        z_to_dists)
from tensoir_tpu_torch.render import primary

# rows and tiles marched since the last reset (real pairs, or under the
# hemisphere compaction every row of its fixed capacity; not the padding of
# the last tile): lets a run show how much secondary work its steps did
MARCHED = {"pairs": 0, "tiles": 0}


def reset_march_counts() -> None:
    for k in MARCHED:
        MARCHED[k] = 0


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
                  prepass_n: int, window_back: int = 0):
    """The window march: (coords [N, K, 3], sigma [N, K], dists [N, K]) at
    the canonical positions of the ``window_indices`` samples, the same as
    ``sample_ray_equally`` gives them. With the conservative coarse bake
    this is the full march up to the bake's feature threshold and to spans
    longer than the window."""
    S = n_sample
    jj, m = window_indices(coarse, baked.shape, aabb, o, d, n_sample=S,
                           vis_near=vis_near, vis_far=vis_far, window=window,
                           prepass_n=prepass_n, window_back=window_back)
    tfrac = jj.to(o.dtype) * _recip(S - 1)
    z = vis_near * (1.0 - tfrac) + vis_far * tfrac
    xyz = o[:, None, :] + d[:, None, :] * z[..., None]
    valid = m & ((xyz >= aabb[0]) & (xyz <= aabb[1])).all(-1)
    coords = F.normalize_coord(aabb, xyz)
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
    window: int = 0,
    window_back: int = 0,
    prepass_n: int = 18,
):
    """Visibility only, for the relighting eval: (nerv_vis [N],
    nerfactor_vis [N]), the final transmittance and 1 - acc. The exact VM
    march (``march_cap``: its first occupied samples only), or with
    ``baked`` and ``coarse`` the window march on the baked grid (the JAX
    package's baked march without a window has no caller)."""
    aabb = scene["aabb"]
    if baked is not None:
        if coarse is None or not 0 < window < n_sample:
            raise ValueError("the baked visibility march needs the coarse "
                             f"occupancy and 0 < window < {n_sample}")
        _, sigma, dists = _march_window(
            cfg, baked, coarse, aabb, surf_pts, light_in_dir,
            n_sample=n_sample, vis_near=vis_near, vis_far=vis_far,
            window=window, prepass_n=prepass_n, window_back=window_back)
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
    app_baked=None,
    window: int = 0,
    window_back: int = 0,
    prepass_n: int = 18,
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
    march."""
    aabb = scene["aabb"]
    windowed = (baked is not None and coarse is not None
                and 0 < window < n_sample)
    if windowed:
        coords, sigma, dists = _march_window(
            cfg, baked, coarse, aabb, surf_pts, light_in_dir,
            n_sample=n_sample, vis_near=vis_near, vis_far=vis_far,
            window=window, prepass_n=prepass_n, window_back=window_back)
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

    vdirs = sub_dirs[:, None, :].expand(pts_sel.shape)
    lidx = sub_lidx[:, None].expand(pts_sel.shape[:2])
    if app_baked is not None:
        feat = F.app_feature_baked(*app_baked, pts_sel, lidx)
    else:
        feat = F.app_feature(cfg, params, pts_sel, lidx)
    rgb = primary.shade_radiance(cfg, params, vdirs, feat)
    sub_indirect = ((w_sel[..., None] * rgb).sum(-2)
                    * pair_valid[:, None])                       # [cap, 3]
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


def _require_unported_off(**knobs) -> None:
    for name, value in knobs.items():
        if value:
            raise NotImplementedError(
                f"{name}={value!r}: not ported yet (the secondary pass has "
                "no grouped march and no global app stage)")


def _reduce_stats(tile_stats, *, n_tiles: int, app_pair_cap: int,
                  compact_overflow: Optional[torch.Tensor]) -> Dict:
    """The pass's occupancy statistics from the per-tile ones."""
    ts = {k: torch.stack([s[k] for s in tile_stats]) for k in tile_stats[0]}
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


@torch.no_grad()
def secondary_shading_tiled(
    cfg: F.FieldConfig,
    params: Dict,
    scene: Dict,
    surf_pts: torch.Tensor,      # [P, 3]
    surf2light: torch.Tensor,    # [P, L, 3]
    light_idx: torch.Tensor,     # [P] int
    pair_mask: torch.Tensor,     # [P, L] bool (cosine mask)
    *,
    n_sample: int,
    vis_near: float,
    vis_far: float,
    tile: int = 16384,
    app_cap: int = 16,
    march_cap: int = 32,
    use_baked: bool = True,
    bake_reso: int = 0,
    window: int = 0,
    window_back: int = 0,
    prepass_n: int = 18,
    coarse_dilate: int = 2,
    compact_frac: float = 0.0,
    march_group: int = 0,
    app_bake_reso: int = 0,
    app_hoist: bool = False,
    app_pair_frac: float = 0.0,
    return_stats: bool = False,
    window_probe: int = 0,
    window_probe_back: int = 0,
):
    """Visibility [P, L, 1] and indirect light [P, L, 3] of every (surface
    point, light dir) pair, marched ``tile`` pairs at a time; pairs outside
    ``pair_mask`` get zeros. With ``return_stats`` also the pass's cap
    occupancy statistics (a dict of 0-d tensors).

    ``compact_frac`` in (0, 1) marches only the pairs in ``pair_mask``,
    packed in order into ceil(P L compact_frac / tile) tiles; pairs past
    that capacity get zeros (``compact_overflow_frac`` counts them). Runs
    without gradients, as the reference's secondary pass does."""
    _require_unported_off(
        second_march_group=march_group if march_group > 1 else 0,
        secondary_app_hoist=app_hoist)
    baked = coarse = app_baked = None
    if use_baked:
        with record_function("bake"):
            baked = F.bake_packed_sigma_grid(cfg, params, scene,
                                             max_reso=bake_reso)
            if 0 < window < n_sample:
                coarse = F.bake_coarse_occupancy(baked, dilate=coarse_dilate)
            if app_bake_reso > 0:
                grid = F.bake_app_feature_grid(cfg, params,
                                               max_reso=app_bake_reso)
                cells = F.app_bake_cells(cfg, params, app_bake_reso)
                assert int(np.prod(cells)) == grid.shape[1], (cells,
                                                              grid.shape)
                app_baked = (grid, cells)

    P, L, _ = surf2light.shape
    pts = surf_pts[:, None, :].expand(P, L, 3).reshape(-1, 3)
    dirs = surf2light.reshape(-1, 3)
    lidx = light_idx[:, None].expand(P, L).reshape(-1)
    mask = pair_mask.reshape(-1)
    total = P * L
    compact = 0.0 < compact_frac < 1.0
    compact_overflow = None
    if compact:
        # march only the pairs above the horizon, in order, up to cap
        cap = -(-int(total * compact_frac) // tile) * tile
        cidx, cvalid = primary.compact_nonzero(mask, cap)
        src = cidx.clamp(max=total - 1)
        pts, dirs, lidx = pts[src], dirs[src], lidx[src]
        if return_stats:
            n_in = mask.sum(dtype=torch.float32)
            compact_overflow = ((n_in - cvalid.sum(dtype=torch.float32))
                                .clamp_min(0.0) / n_in.clamp_min(1.0))
        mask = cvalid
        n_rows = cap
        app_pair_cap = tile // 2    # twice the weight-bearing pairs per tile
    else:
        n_rows = total
        app_pair_cap = tile // 4
    if 0.0 < app_pair_frac <= 1.0:
        app_pair_cap = max(1, int(tile * app_pair_frac))

    n_tiles = -(-n_rows // tile)
    pad = n_tiles * tile - n_rows
    if pad:
        pts = torch.cat([pts, pts.new_zeros((pad, 3))])
        dirs = torch.cat([dirs, dirs.new_ones((pad, 3))])
        lidx = torch.cat([lidx, lidx.new_zeros((pad,))])
        mask = torch.cat([mask, mask.new_zeros((pad,))])

    vis, ind, tile_stats = [], [], []
    with record_function("secondary_march"):
        for t0 in range(0, n_tiles * tile, tile):
            sl = slice(t0, t0 + tile)
            m = mask[sl]
            out = compute_radiance(
                cfg, params, scene, pts[sl], dirs[sl], lidx[sl],
                n_sample=n_sample, vis_near=vis_near, vis_far=vis_far,
                app_cap=app_cap, app_pair_cap=app_pair_cap,
                march_cap=march_cap, baked=baked, coarse=coarse,
                app_baked=app_baked, window=window, window_back=window_back,
                prepass_n=prepass_n, return_stats=return_stats, pair_ok=m,
                probe_window=window_probe,
                probe_window_back=window_probe_back)
            mf = m.to(out[0].dtype)
            vis.append(out[0] * mf)
            ind.append(out[2] * mf[:, None])
            if return_stats:
                tile_stats.append(out[3])
            MARCHED["pairs"] += min(tile, n_rows - t0)
            MARCHED["tiles"] += 1
    vis, ind = torch.cat(vis), torch.cat(ind)
    if compact:
        # one scatter of [cap, 4] rows back to the pairs; unfilled slots
        # (marker total) land in a dump row that is cut off
        both = torch.cat([vis[:cap, None], ind[:cap]], -1)
        out = both.new_zeros((total + 1, 4)).index_copy(0, cidx, both)
        vis, ind = out[:total, :1], out[:total, 1:]
    else:
        vis, ind = vis[:total, None], ind[:total]
    vis, ind = vis.reshape(P, L, 1), ind.reshape(P, L, 3)
    if not return_stats:
        return vis, ind
    return vis, ind, _reduce_stats(tile_stats, n_tiles=n_tiles,
                                   app_pair_cap=app_pair_cap,
                                   compact_overflow=compact_overflow)
