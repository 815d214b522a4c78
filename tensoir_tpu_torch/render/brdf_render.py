"""The rendering equation at surface points (port of
tensoir_tpu.render.brdf_render).

Given per-ray depth, normal, albedo, roughness and fresnel, pick incident
light directions, march secondary rays for visibility and indirect light
(without gradients), evaluate the GGX BRDF and the learned light (with
gradients), and integrate over the directions: a sum with the texels' area
weights, the equal-area mean times 4 pi, or with importance-sampled
directions the Monte Carlo mean of brdf * L * cos / pdf.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from tensoir_tpu_torch.models import field as F
from tensoir_tpu_torch.models import lighting
from tensoir_tpu_torch.ops.brdf import ggx_specular
from tensoir_tpu_torch.ops.color import linear2srgb
from tensoir_tpu_torch.ops.interp import clip
from tensoir_tpu_torch.ops.rays import safe_l2_normalize
from tensoir_tpu_torch.render.secondary import (SecondaryKnobs,
                                                secondary_shading_tiled)


def incident_light_dirs(cfg: F.FieldConfig, sample_method: str,
                        key: Optional[torch.Generator],
                        params: Optional[Dict] = None, gt_envmap=None,
                        device=None):
    """The light directions of the integral, (dirs [L, 3], pdf [L, 1] or
    None): the fixed lat-long texel centres (``fixed_envirmap``, or any
    method with ``key=None``), those jittered within their texels
    (``stratified_sampling``) or within equal-area cells
    (``stratifed_sample_equal_areas``), or L draws from the learned light
    (``importance_sample``, which alone returns a pdf)."""
    n_dirs = cfg.envmap_h * cfg.envmap_w
    if sample_method == "importance_sample" and key is not None:
        if params is None:
            raise ValueError("importance_sample needs the light params")
        dirs, _, pdf = lighting.gen_light_incident_dirs_importance(
            params, cfg, key, n_dirs, gt_envmap=gt_envmap)
        return dirs.to(device), pdf.to(device)
    if sample_method in ("fixed_envirmap", "importance_sample") or key is None:
        _, dirs = lighting.envmap_dirs(cfg.envmap_h, cfg.envmap_w)
        return torch.as_tensor(dirs, device=device), None
    if sample_method == "stratified_sampling":
        return lighting.stratified_dirs(key, cfg.envmap_h, cfg.envmap_w,
                                        device=device), None
    if sample_method == "stratifed_sample_equal_areas":
        return lighting.stratified_equal_area_dirs(
            key, cfg.envmap_h, cfg.envmap_w, device=device), None
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
    secondary: SecondaryKnobs = SecondaryKnobs(),
    ray_used: Optional[torch.Tensor] = None,
):
    """Physically based RGB per ray, [P, 3]; with
    ``secondary.secondary_stats`` also the secondary pass's statistics,
    (rgb, stats). ``ray_used`` [P] bool, where given, marks the rays whose
    RGB the caller keeps: the others' RGB may then leave out their
    visibility and indirect light, whose tiles the secondary pass skips
    (``secondary_shading_tiled``)."""
    rays_o, rays_d = rays[:, :3], rays[:, 3:6]
    dev = rays.device
    surface_xyz = rays_o + depth_map[:, None] * rays_d           # [P, 3]

    area_weight, _ = lighting.envmap_dirs(cfg.envmap_h, cfg.envmap_w)
    area_weight = torch.as_tensor(area_weight, device=dev)       # [L]
    in_dirs, light_pdf = incident_light_dirs(
        cfg, sample_method, key, params=params,
        gt_envmap=scene.get("gt_envmap"), device=dev)
    P, L = rays.shape[0], in_dirs.shape[0]
    surf2l = in_dirs[None].expand(P, L, 3)
    surf2c = safe_l2_normalize(-rays_d)

    # the hemisphere above each normal
    cosine = clip(torch.einsum("plk,pk->pl", surf2l, normal_map), 0.0, None)
    if sample_method == "importance_sample":
        # importance directions crowd around the light's lobe, so far more
        # than the compaction's capacity of pairs can face a surface
        secondary = dataclasses.replace(secondary, secondary_compact_frac=0.0)
    sec = secondary_shading_tiled(
        cfg, params, scene, surface_xyz.detach(), surf2l, light_idx,
        cosine > 1e-6, secondary, ray_used=ray_used)
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

    if sample_method == "stratifed_sample_equal_areas":
        rgb = (4.0 * np.pi * surface_brdf * light_rgbs
               * cosine[..., None]).mean(1)
    elif light_pdf is not None:
        # the importance-sampled Monte Carlo estimator
        inv_pdf = 1.0 / clip(light_pdf[None, :, :], 1e-8, None)
        rgb = (surface_brdf * light_rgbs * cosine[..., None]
               * inv_pdf).mean(1)
    else:
        rgb = (surface_brdf * light_rgbs * cosine[..., None]
               * area_weight[None, :, None]).sum(1)
    rgb = linear2srgb(clip(rgb, 0.0, 1.0))
    return (rgb, sec[2]) if secondary.secondary_stats else rgb
