"""Training-step renderer: the primary pass, and in the relight phase the
physically based branch (port of
tensoir_tpu.render.train_render.render_train_batch).

The reference relights every ray whose accumulated opacity passes 0.5 (a
count that varies); here a fixed ``relight_ray_cap`` of rays is relit,
those rays first (a stable argsort), and the result is scattered back.
Rays that are not relit keep the white background. Where every ray is
relit and no gradient is recorded (an eval chunk), the secondary march
skips the tiles whose rays all keep it. With
``normals_kind='gt_normals'`` the dataset's normals ``normal_gt`` [B, 3]
take the place of the normal map.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from tensoir_tpu_torch.models import field as F
from tensoir_tpu_torch.profiling import span
from tensoir_tpu_torch.render.brdf_render import render_with_brdf
from tensoir_tpu_torch.render.primary import render_rays
from tensoir_tpu_torch.render.secondary import SecondaryKnobs


def render_train_batch(
    cfg: F.FieldConfig,
    params: Dict,
    scene: Dict,
    rays: torch.Tensor,
    light_idx: torch.Tensor,
    *,
    n_samples: int,
    key: Optional[torch.Generator],
    is_train: bool = True,
    is_relight: bool = True,
    white_bg: bool = True,
    sample_method: str = "stratified_sampling",
    app_cap: int = 32,
    march_cap: int = 0,
    march_select: str = "scatter",
    march_group: int = 0,
    ndc_ray: bool = False,
    relight_ray_cap: int = 1024,
    secondary: SecondaryKnobs = SecondaryKnobs(),
    normal_gt: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    with span("primary"):
        ret = render_rays(cfg, params, scene, rays, light_idx,
                          n_samples=n_samples, key=key, is_train=is_train,
                          is_relight=is_relight, white_bg=white_bg,
                          app_cap=app_cap, march_cap=march_cap,
                          march_select=march_select, march_group=march_group,
                          ndc_ray=ndc_ray)
    if not is_relight:
        ret["rgb_with_brdf_map"] = torch.ones_like(ret["rgb_map"])
        return ret

    B = rays.shape[0]
    acc_mask = ret["acc_mask"]
    if cfg.normals_kind == "gt_normals" and normal_gt is not None:
        ret["normal_map"] = normal_gt
    cap = min(relight_ray_cap, B) if relight_ray_cap > 0 else B
    ray_used = None
    if cap < B:
        # stable: the rays with acc > 0.5 first, each group in batch order
        order = torch.argsort((~acc_mask).to(torch.uint8), stable=True)
        sel = order[:cap]
    else:
        sel = torch.arange(B, device=rays.device)
        if not torch.is_grad_enabled():
            # an eval chunk's rays lie in image order, so whole tiles of
            # the march may hold only rays that keep the white background;
            # a training batch's shuffled rays fill every tile, and its
            # step reads nothing back
            ray_used = acc_mask
    sel_valid = acc_mask[sel]

    with span("brdf_render"):
        rgb_sel = render_with_brdf(
            cfg, params, scene, ret["depth_map"][sel], ret["normal_map"][sel],
            ret["albedo_map"][sel], ret["roughness_map"][sel],
            ret["fresnel_map"][sel], rays[sel], light_idx[sel],
            sample_method=sample_method, key=key, secondary=secondary,
            ray_used=ray_used)
    if secondary.secondary_stats:
        rgb_sel, sec_stats = rgb_sel
        ret.update({f"sec/{k}": v for k, v in sec_stats.items()})
    rgb_sel = torch.where(sel_valid[:, None], rgb_sel,
                          torch.ones_like(rgb_sel))

    ret["rgb_with_brdf_map"] = rgb_sel.new_ones((B, 3)).index_copy(
        0, sel, rgb_sel)
    # the rays whose rgb_with_brdf enters the loss: the relit surface rays
    # and every ray that is not a surface ray (white against white); a
    # surface ray left out by the cap must not count as white
    computed = torch.zeros_like(acc_mask).index_copy(0, sel, sel_valid)
    ret["relight_computed_mask"] = computed | ~acc_mask
    return ret
