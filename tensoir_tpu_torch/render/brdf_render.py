"""The rendering equation at surface points (port of
tensoir_tpu.render.brdf_render).

Given per-ray depth, normal, albedo, roughness and fresnel, pick incident
light directions, march secondary rays for visibility and indirect light
(without gradients), evaluate the GGX BRDF and the learned light (with
gradients), and sum over the directions with their area weights.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from tensoir_tpu_torch.models import field as F
from tensoir_tpu_torch.models import lighting
from tensoir_tpu_torch.ops.brdf import ggx_specular
from tensoir_tpu_torch.ops.color import linear2srgb
from tensoir_tpu_torch.ops.interp import clip
from tensoir_tpu_torch.ops.rays import safe_l2_normalize
from tensoir_tpu_torch.render.secondary import secondary_shading_tiled


def incident_light_dirs(cfg: F.FieldConfig, sample_method: str,
                        key: Optional[torch.Generator],
                        device=None) -> torch.Tensor:
    """Light directions [L, 3] of the integral: the fixed lat-long texel
    centres (``fixed_envirmap``, or any method with ``key=None``), or those
    jittered within their texels (``stratified_sampling``). The importance
    and equal-area samplers are not ported yet."""
    if sample_method in ("importance_sample", "stratifed_sample_equal_areas"):
        raise NotImplementedError(
            f"light sample method {sample_method!r}: not ported yet")
    if sample_method == "fixed_envirmap" or key is None:
        _, dirs = lighting.envmap_dirs(cfg.envmap_h, cfg.envmap_w)
        return torch.as_tensor(dirs, device=device)
    if sample_method == "stratified_sampling":
        return lighting.stratified_dirs(key, cfg.envmap_h, cfg.envmap_w,
                                        device=device)
    raise ValueError(f"unknown light sample method {sample_method}")


def render_with_brdf(
    cfg: F.FieldConfig,
    params: Dict,
    scene: Dict,
    depth_map: torch.Tensor,      # [P]
    normal_map: torch.Tensor,     # [P, 3]
    albedo_map: torch.Tensor,     # [P, 3]
    roughness_map: torch.Tensor,  # [P, 1]
    fresnel_map: torch.Tensor,    # [P, 3]
    rays: torch.Tensor,           # [P, 6]
    light_idx: torch.Tensor,      # [P] int
    *,
    sample_method: str = "stratified_sampling",
    key: Optional[torch.Generator] = None,
    second_n_sample: int = 96,
    second_near: float = 0.05,
    second_far: float = 1.5,
    secondary_tile: int = 16384,
    second_march_cap: int = 32,
    secondary_use_baked: bool = True,
    secondary_bake_reso: int = 0,
    second_window: int = 0,
    second_window_back: int = 0,
    second_prepass_n: int = 18,
    coarse_dilate: int = 2,
    secondary_compact_frac: float = 0.0,
    second_march_group: int = 0,
    app_bake_reso: int = 0,
    secondary_app_hoist: bool = False,
    second_app_cap: int = 16,
    app_pair_frac: float = 0.0,
    return_secondary_stats: bool = False,
    second_window_probe: int = 0,
    second_window_probe_back: int = 0,
):
    """Physically based RGB per ray, [P, 3]; with
    ``return_secondary_stats`` also the secondary pass's statistics,
    (rgb, stats)."""
    rays_o, rays_d = rays[:, :3], rays[:, 3:6]
    dev = rays.device
    surface_xyz = rays_o + depth_map[:, None] * rays_d           # [P, 3]

    area_weight, _ = lighting.envmap_dirs(cfg.envmap_h, cfg.envmap_w)
    area_weight = torch.as_tensor(area_weight, device=dev)       # [L]
    in_dirs = incident_light_dirs(cfg, sample_method, key, device=dev)
    P, L = rays.shape[0], in_dirs.shape[0]
    surf2l = in_dirs[None].expand(P, L, 3)
    surf2c = safe_l2_normalize(-rays_d)

    # the hemisphere above each normal
    cosine = clip(torch.einsum("plk,pk->pl", surf2l, normal_map), 0.0, None)
    if sample_method == "importance_sample":
        # importance directions crowd around the light's lobe, so far more
        # than the compaction's capacity of pairs can face a surface
        secondary_compact_frac = 0.0
    sec = secondary_shading_tiled(
        cfg, params, scene, surface_xyz.detach(), surf2l, light_idx,
        cosine > 1e-6, n_sample=second_n_sample, vis_near=second_near,
        vis_far=second_far, tile=secondary_tile, march_cap=second_march_cap,
        app_cap=second_app_cap, use_baked=secondary_use_baked,
        bake_reso=secondary_bake_reso, window=second_window,
        window_back=second_window_back, prepass_n=second_prepass_n,
        coarse_dilate=coarse_dilate, compact_frac=secondary_compact_frac,
        march_group=second_march_group, app_bake_reso=app_bake_reso,
        app_hoist=secondary_app_hoist, app_pair_frac=app_pair_frac,
        return_stats=return_secondary_stats,
        window_probe=second_window_probe,
        window_probe_back=second_window_probe_back)
    visibility, indirect = sec[0], sec[1]

    specular = ggx_specular(normal_map, surf2c, surf2l, roughness_map,
                            fresnel_map)                         # [P, L, 3]
    surface_brdf = albedo_map[:, None, :] / np.pi + specular

    env_rgbs = lighting.get_light_rgbs(
        params, cfg, in_dirs, gt_envmap=scene.get("gt_envmap"))  # [Ln, L, 3]
    # env_rgbs[light_idx] as a one-hot product (a gather's backward would
    # pile every ray's [L, 3] gradient onto the few light rows)
    direct = F.light_rows(env_rgbs.reshape(env_rgbs.shape[0], -1), light_idx)
    light_rgbs = visibility * direct.reshape(P, L, 3) + indirect

    rgb = (surface_brdf * light_rgbs * cosine[..., None]
           * area_weight[None, :, None]).sum(1)
    rgb = linear2srgb(clip(rgb, 0.0, 1.0))
    return (rgb, sec[2]) if return_secondary_stats else rgb
