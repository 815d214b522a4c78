"""Primary ray rendering for the radiance phase (port of
tensoir_tpu.render.primary.render_rays with ``is_relight=False``).

Dense march over ``n_samples`` fixed steps, density on every sample
(masked to zero outside the AABB and the alpha mask), compositing, then
appearance and the MLP_Fea shader on a fixed per-ray top-k of samples by
weight (``app_cap``). Randomness comes from a ``torch.Generator`` passed as
``key``; ``key=None`` is the deterministic eval path.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from tensoir_tpu_torch.models import field as F
from tensoir_tpu_torch.models import mlps
from tensoir_tpu_torch.ops.compositing import raw2alpha
from tensoir_tpu_torch.ops.rays import sample_ray, z_to_dists


def shade_radiance(cfg: F.FieldConfig, params, viewdirs, features):
    """RGB from the MLP_Fea shader."""
    if cfg.shading_mode != "MLP_Fea":
        raise NotImplementedError(
            f"shading_mode={cfg.shading_mode!r}: the port has only MLP_Fea")
    x = mlps.render_fea_inputs(features, viewdirs, cfg.view_pe, cfg.fea_pe)
    return torch.sigmoid(mlps.apply_mlp(params["render_mlp"], x))


def render_rays(
    cfg: F.FieldConfig,
    params: Dict,
    scene: Dict,
    rays: torch.Tensor,        # [B, 6]
    light_idx: torch.Tensor,   # [B] int
    *,
    n_samples: int,
    key: Optional[torch.Generator] = None,
    is_train: bool = False,
    is_relight: bool = True,
    white_bg: bool = True,
    app_cap: int = 32,
    march_cap: int = 0,
    march_group: int = 0,
    ndc_ray: bool = False,
) -> Dict[str, torch.Tensor]:
    if is_relight:
        raise NotImplementedError("render_rays(is_relight=True): the relight "
                                  "branch is not ported yet")
    if 0 < march_cap < n_samples:
        raise NotImplementedError("march_cap > 0 (occupancy-culled march)")
    if march_group > 1:
        raise NotImplementedError("march_group > 1 (grouped primary march)")
    if ndc_ray:
        raise NotImplementedError("ndc_ray=True (forward-facing NDC march)")
    B = rays.shape[0]
    rays_o, viewdirs = rays[:, :3], rays[:, 3:6]
    aabb = scene["aabb"]
    step = F.step_size(aabb, F.grid_size_of(params), cfg.step_ratio)
    near, far = cfg.near_far

    jitter = None
    if key is not None and is_train:
        jitter = torch.rand((B, 1), generator=key, device=rays.device,
                            dtype=rays.dtype)
    xyz, z_vals, ray_valid = sample_ray(rays_o, viewdirs, aabb, near, far,
                                        step, n_samples, jitter=jitter)
    dists = z_to_dists(z_vals)
    coords = F.normalize_coord(aabb, xyz)                      # [B, S, 3]
    ray_valid = ray_valid & (F.sample_alpha_mask(scene, xyz) > 0)

    sigma_feat = F.density_feature(cfg, params, coords)
    sigma = torch.where(ray_valid, F.feature2density(cfg, sigma_feat),
                        torch.zeros_like(sigma_feat))
    _, weight, _ = raw2alpha(sigma, dists * cfg.distance_scale)
    acc_map = weight.sum(-1)
    depth_map = (weight * z_vals).sum(-1)

    # appearance on a fixed top-k of samples by weight; slots past the
    # samples above the threshold carry weight 0
    S = weight.shape[1]
    k = app_cap if 0 < app_cap < S else S
    if k < S:
        masked_w = torch.where(weight > cfg.raymarch_weight_thres, weight,
                               torch.full_like(weight, -1.0))
        top_w, top_idx = torch.topk(masked_w, k, dim=1)
        sel_mask = top_w > 0.0
    else:
        top_idx = torch.arange(S, device=rays.device).expand(B, S)
        top_w = weight
        sel_mask = weight > cfg.raymarch_weight_thres
    pts_sel = torch.gather(coords, 1, top_idx[..., None].expand(-1, -1, 3))
    w_sel = top_w * sel_mask
    vdirs_sel = viewdirs[:, None, :].expand(pts_sel.shape)
    lidx_sel = light_idx[:, None].expand(B, pts_sel.shape[1])

    rad_feat = F.app_feature(cfg, params, pts_sel, lidx_sel)
    rgb = shade_radiance(cfg, params, vdirs_sel, rad_feat)     # [B, k, 3]
    rgb_map = (w_sel[..., None] * rgb).sum(-2)

    # white background, or a coin flip per batch at train time
    if white_bg:
        bgw = 1.0
    elif is_train and key is not None:
        bgw = (torch.rand((), generator=key, device=rays.device)
               < 0.5).to(rgb_map.dtype)
    else:
        bgw = 0.0
    return {
        "rgb_map": rgb_map + bgw * (1.0 - acc_map[..., None]),
        "depth_map": depth_map + bgw * (1.0 - acc_map) * rays[:, -1],
        "acc_map": acc_map,
    }
