"""Training-step renderer (port of the ``is_relight=False`` branch of
tensoir_tpu.render.train_render.render_train_batch)."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from tensoir_tpu_torch.models import field as F
from tensoir_tpu_torch.render.primary import render_rays


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
    app_cap: int = 32,
    march_cap: int = 0,
    march_group: int = 0,
    ndc_ray: bool = False,
) -> Dict[str, torch.Tensor]:
    if is_relight:
        raise NotImplementedError("render_train_batch(is_relight=True): the "
                                  "BRDF / secondary branch is not ported yet")
    ret = render_rays(cfg, params, scene, rays, light_idx,
                      n_samples=n_samples, key=key, is_train=is_train,
                      is_relight=False, white_bg=white_bg, app_cap=app_cap,
                      march_cap=march_cap, march_group=march_group,
                      ndc_ray=ndc_ray)
    ret["rgb_with_brdf_map"] = torch.ones_like(ret["rgb_map"])
    return ret
