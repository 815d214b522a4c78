"""Secondary rays: visibility and indirect light for (surface point, light
direction) pairs (port of tensoir_tpu.render.secondary:
``compute_radiance`` and ``secondary_shading_tiled``).

Each pair marches ``n_sample`` equally spaced samples toward the light,
either through the per-step baked, corner-packed bf16 sigma grid (one K1
row per sample, the default) or through the exact VM field on the first
``march_cap`` occupied samples. The pairs whose march picks up weight then
get the radiance field's colour on their top-k samples, a fixed number of
pairs per tile. The whole pass runs without gradients, tile by tile.

Not ported yet, and raising: the interval-culled window march and its
coarse occupancy, hemisphere-pair compaction, the grouped fine march, the
baked appearance feature, the global app stage, the factor-resized bake,
and the occupancy statistics and window probe.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.profiler import record_function

from tensoir_tpu_torch.models import field as F
from tensoir_tpu_torch.ops.compositing import raw2alpha
from tensoir_tpu_torch.ops.rays import sample_ray_equally, z_to_dists
from tensoir_tpu_torch.render import primary

# pairs and tiles marched since the last reset (real pairs, not padding):
# lets a run show how much secondary work its steps did
MARCHED = {"pairs": 0, "tiles": 0}


def reset_march_counts() -> None:
    for k in MARCHED:
        MARCHED[k] = 0


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(x, idx, axis=0)`` with JAX's clipping of indices past the
    end (``compact_nonzero`` marks unfilled slots with ``len(x)``)."""
    return x[idx.clamp(max=x.shape[0] - 1)]


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
    pair_ok: Optional[torch.Tensor] = None,
):
    """March secondary rays: (nerv_vis [N], nerfactor_vis [N],
    indirect [N, 3]).

    Visibility is the final transmittance ('nerv') or 1 - acc
    ('nerfactor'); indirect light is the weight-composited radiance-field
    RGB along the ray. ``pair_ok`` marks real pairs: padding pairs march
    but claim no slot of the ``app_pair_cap`` pairs that reach the app
    stage."""
    aabb = scene["aabb"]
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
    feat = F.app_feature(cfg, params, pts_sel, lidx)
    rgb = primary.shade_radiance(cfg, params, vdirs, feat)
    sub_indirect = ((w_sel[..., None] * rgb).sum(-2)
                    * pair_valid[:, None])                       # [cap, 3]
    if pair_idx is None:
        return nerv_vis, nerfactor_vis, sub_indirect
    # scatter back; unfilled slots (marker N) land in a dump row that is
    # cut off, the only row written more than once
    indirect = sub_indirect.new_zeros((N + 1, 3)).index_copy(
        0, pair_idx, sub_indirect)[:N]
    return nerv_vis, nerfactor_vis, indirect


def _require_unported_off(**knobs) -> None:
    for name, value in knobs.items():
        if value:
            raise NotImplementedError(
                f"{name}={value!r}: not ported yet (the secondary pass has "
                "the baked full march and the exact march only)")


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
    compact_frac: float = 0.0,
    march_group: int = 0,
    app_bake_reso: int = 0,
    app_hoist: bool = False,
    app_pair_frac: float = 0.0,
    return_stats: bool = False,
    window_probe: int = 0,
):
    """Visibility [P, L, 1] and indirect light [P, L, 3] of every (surface
    point, light dir) pair, marched ``tile`` pairs at a time; pairs outside
    ``pair_mask`` get zeros. Runs without gradients, as the reference's
    secondary pass does."""
    _require_unported_off(
        window=window if 0 < window < n_sample else 0,
        secondary_compact_frac=compact_frac if 0 < compact_frac < 1 else 0,
        second_march_group=march_group if march_group > 1 else 0,
        app_bake_reso=app_bake_reso, secondary_app_hoist=app_hoist,
        secondary_stats=return_stats, second_window_probe=window_probe)
    baked = None
    if use_baked:
        with record_function("bake"):
            baked = F.bake_packed_sigma_grid(cfg, params, scene,
                                             max_reso=bake_reso)

    P, L, _ = surf2light.shape
    pts = surf_pts[:, None, :].expand(P, L, 3).reshape(-1, 3)
    dirs = surf2light.reshape(-1, 3)
    lidx = light_idx[:, None].expand(P, L).reshape(-1)
    mask = pair_mask.reshape(-1)
    total = P * L
    app_pair_cap = tile // 4
    if 0.0 < app_pair_frac <= 1.0:
        app_pair_cap = max(1, int(tile * app_pair_frac))

    n_tiles = -(-total // tile)
    pad = n_tiles * tile - total
    if pad:
        pts = torch.cat([pts, pts.new_zeros((pad, 3))])
        dirs = torch.cat([dirs, dirs.new_ones((pad, 3))])
        lidx = torch.cat([lidx, lidx.new_zeros((pad,))])
        mask = torch.cat([mask, mask.new_zeros((pad,))])

    vis, ind = [], []
    with record_function("secondary_march"):
        for t0 in range(0, n_tiles * tile, tile):
            sl = slice(t0, t0 + tile)
            m = mask[sl]
            nerv, _, indirect = compute_radiance(
                cfg, params, scene, pts[sl], dirs[sl], lidx[sl],
                n_sample=n_sample, vis_near=vis_near, vis_far=vis_far,
                app_cap=app_cap, app_pair_cap=app_pair_cap,
                march_cap=march_cap, baked=baked, pair_ok=m)
            mf = m.to(nerv.dtype)
            vis.append(nerv * mf)
            ind.append(indirect * mf[:, None])
            MARCHED["pairs"] += min(tile, total - t0)
            MARCHED["tiles"] += 1
    vis = torch.cat(vis)[:total].reshape(P, L, 1)
    ind = torch.cat(ind)[:total].reshape(P, L, 3)
    return vis, ind
