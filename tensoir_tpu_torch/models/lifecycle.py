"""Coarse-to-fine lifecycle helpers (port of tensoir_tpu.models.lifecycle:
the grid-size schedule and ``update_alpha_mask``).

``shrink`` and ``upsample`` are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn

from tensoir_tpu_torch.models import field as F

# points per chunk of the dense alpha evaluation (bounds its memory)
_ALPHA_CHUNK_POINTS = 1 << 18


def n_to_reso(n_voxels: int, aabb) -> Tuple[int, int, int]:
    """Voxel count -> per-axis resolution."""
    aabb = np.asarray(aabb).reshape(2, 3)
    size = aabb[1] - aabb[0]
    voxel_size = (np.prod(size) / n_voxels) ** (1.0 / 3.0)
    return tuple(int(v) for v in (size / voxel_size))


def cal_n_samples(reso, step_ratio: float = 0.5) -> int:
    return int(np.linalg.norm(np.asarray(reso, np.float64)) / step_ratio)


def voxel_schedule(n_init: int, n_final: int, n_upsamples: int):
    """Log-linear voxel counts of the upsampling steps."""
    return [int(round(v)) for v in np.exp(
        np.linspace(np.log(n_init), np.log(n_final), n_upsamples + 1))][1:]


@torch.no_grad()
def dense_alpha(cfg: F.FieldConfig, params: Dict, scene: Dict,
                grid_size) -> torch.Tensor:
    """Alpha on a dense [gx, gy, gz] grid of world points spanning the AABB,
    evaluated a chunk of x-slices at a time."""
    gx, gy, gz = (int(g) for g in grid_size)
    aabb = scene["aabb"]
    sx, sy, sz = (torch.from_numpy(np.linspace(0, 1, g, dtype=np.float32))
                  .to(aabb.device) for g in (gx, gy, gz))
    step = F.step_size(aabb, F.grid_size_of(params), cfg.step_ratio)
    yy, zz = torch.meshgrid(sy, sz, indexing="ij")
    per = max(1, _ALPHA_CHUNK_POINTS // (gy * gz))
    out = []
    for x0 in range(0, gx, per):
        xs = sx[x0:x0 + per]
        n = xs.shape[0]
        samples = torch.stack([xs[:, None, None].expand(n, gy, gz),
                               yy.expand(n, gy, gz), zz.expand(n, gy, gz)], -1)
        xyz = aabb[0] * (1.0 - samples) + aabb[1] * samples
        out.append(F.compute_alpha_grid(cfg, params, scene,
                                        xyz.reshape(-1, 3), step)
                   .reshape(n, gy, gz))
    return torch.cat(out, 0)


def _maxpool3(alpha: torch.Tensor) -> torch.Tensor:
    """3x3x3 max-pool, stride 1, padding 1."""
    return Fn.max_pool3d(alpha[None, None], 3, stride=1, padding=1)[0, 0]


@torch.no_grad()
def update_alpha_mask(cfg: F.FieldConfig, params: Dict, scene: Dict,
                      grid_size):
    """(new scene, new AABB [2, 3] numpy): dense alpha, dilated by a 3^3
    max-pool and thresholded, becomes the alpha mask; the new AABB is the
    box of the grid points the mask keeps."""
    alpha = dense_alpha(cfg, params, scene, grid_size).clamp(0, 1)
    alpha = (_maxpool3(alpha) >= cfg.alpha_mask_thres).float()  # [gx, gy, gz]

    aabb = scene["aabb"].detach().cpu().numpy()
    valid = alpha > 0.5
    if bool(valid.any()):
        lo, hi = [], []
        for axis, g in enumerate(alpha.shape):
            others = tuple(a for a in range(3) if a != axis)
            hit = valid.any(dim=others).cpu().numpy()
            s = np.linspace(0, 1, g, dtype=np.float32)[hit]
            # the world coordinate of the kept points along this axis,
            # computed as the reference computes each point's
            coord = aabb[0][axis] * (1 - s) + aabb[1][axis] * s
            lo.append(coord.min())
            hi.append(coord.max())
        new_aabb = np.stack([np.array(lo), np.array(hi)]).astype(np.float32)
    else:
        new_aabb = aabb.copy()

    scene = dict(scene)
    # storage layout [D=gz, H=gy, W=gx] for (x, y, z) trilinear queries
    vol = alpha.permute(2, 1, 0).contiguous()
    scene["alpha_volume"] = vol
    # one more 3^3 dilation: the nearest-voxel cull on it keeps a superset
    # of what the trilinear test keeps (field.sample_alpha_mask_nearest)
    scene["alpha_volume_dilated"] = _maxpool3(vol).to(torch.uint8)
    scene["alpha_volume_packed"] = F.pack_corner_volume(vol)
    scene["alpha_aabb"] = torch.as_tensor(aabb, dtype=torch.float32,
                                          device=vol.device)
    scene["has_alpha_mask"] = torch.tensor(1.0, device=vol.device)
    return scene, new_aabb
