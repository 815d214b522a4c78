"""Coarse-to-fine lifecycle transforms (port of
tensoir_tpu.models.lifecycle), run between training steps:

* ``update_alpha_mask``: dense alpha -> 3^3 max-pool dilation -> binary
  mask -> the box of the kept grid points, the new AABB;
* ``shrink``: every factor sliced to the new AABB's index box, with the
  AABB corrected onto the factor grid when the mask grid differs;
* ``upsample``: align-corners resizes of every factor to a new grid;
* ``filter_rays_bbox`` / ``filter_rays_mask``: the training rays that hit
  the AABB, or an occupied voxel of the alpha mask.

The port's step runs eagerly, so unlike the JAX loop nothing recompiles
after an event: the next step simply runs on the new shapes.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn

from portbench.reference.models import field as F
from portbench.reference.models.field import MAT_MODE, VEC_MODE
from portbench.reference.ops.interp import (resize_bilinear_align_corners,
                                          resize_line_align_corners)
from portbench.reference.ops.rays import sample_ray

# points per chunk of the dense alpha evaluation (bounds its memory)
_ALPHA_CHUNK_POINTS = 1 << 18
# samples per ray, and rays per chunk, of the mask ray filter
_FILTER_N_SAMPLES = 256
_FILTER_CHUNK = 51200


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


def _factor_keys(params: Dict):
    """(key, axis index i, is_plane) of every VM factor in ``params``."""
    for name in ("density", "app", "stack"):
        for i in range(3):
            for kind in ("line", "plane"):
                key = f"{name}_{kind}_{i}"
                if key in params:
                    yield key, i, kind == "plane"


@torch.no_grad()
def shrink(cfg: F.FieldConfig, params: Dict, scene: Dict, new_aabb):
    """(params, scene) with every factor sliced to ``new_aabb``'s index
    box. The box is computed on the host in float64, exactly as the
    reference writes it (the double round included): it decides the grid,
    and the grid decides where every sample lands."""
    aabb = scene["aabb"].detach().cpu().numpy().astype(np.float64)
    new_aabb = np.asarray(new_aabb, np.float64).reshape(2, 3)
    grid = np.asarray(F.grid_size_of(params), np.int64)      # (X, Y, Z)
    units = (aabb[1] - aabb[0]) / (grid - 1)

    t_l = np.round(np.round((new_aabb[0] - aabb[0]) / units)).astype(np.int64)
    b_r = np.round((new_aabb[1] - aabb[0]) / units).astype(np.int64) + 1
    b_r = np.minimum(b_r, grid)
    t_l = np.clip(t_l, 0, None)

    params = dict(params)
    for key, i, is_plane in _factor_keys(params):
        if is_plane:
            m0, m1 = MAT_MODE[i]
            sl = (slice(t_l[m1], b_r[m1]), slice(t_l[m0], b_r[m0]))
        else:
            sl = (slice(t_l[VEC_MODE[i]], b_r[VEC_MODE[i]]),)
        # a copy, not a view: the old factor's memory is freed
        params[key] = params[key][sl].clone()

    # the mask grid differs from the factor grid: snap the AABB to the
    # factor grid's nodes at the box's ends
    mask_grid = np.asarray(scene["alpha_volume"].shape)[::-1]  # (X, Y, Z)
    if not np.all(mask_grid == grid):
        t_l_r = t_l / (grid - 1)
        b_r_r = (b_r - 1) / (grid - 1)
        corrected = np.zeros_like(new_aabb)
        corrected[0] = (1 - t_l_r) * aabb[0] + t_l_r * aabb[1]
        corrected[1] = (1 - b_r_r) * aabb[0] + b_r_r * aabb[1]
        new_aabb = corrected

    scene = dict(scene)
    scene["aabb"] = torch.as_tensor(new_aabb.astype(np.float32),
                                    device=scene["aabb"].device)
    return params, scene


@torch.no_grad()
def upsample(params: Dict, reso) -> Dict:
    """Every factor resized to the grid ``reso`` (X, Y, Z) with
    ``align_corners``: planes [reso[m1], reso[m0]], lines reso[vec]."""
    reso = tuple(int(r) for r in reso)
    params = dict(params)
    for key, i, is_plane in _factor_keys(params):
        if is_plane:
            m0, m1 = MAT_MODE[i]
            params[key] = resize_bilinear_align_corners(
                params[key], (reso[m1], reso[m0]))
        else:
            params[key] = resize_line_align_corners(params[key],
                                                    reso[VEC_MODE[i]])
    return params


def filter_rays_bbox(all_rays: np.ndarray, aabb) -> np.ndarray:
    """Boolean keep-mask of the rays [N, 6] that hit the AABB (numpy, on
    the host)."""
    aabb = np.asarray(aabb).reshape(2, 3)
    rays_o = all_rays[:, :3]
    rays_d = all_rays[:, 3:6]
    vec = np.where(rays_d == 0, 1e-6, rays_d)
    rate_a = (aabb[1] - rays_o) / vec
    rate_b = (aabb[0] - rays_o) / vec
    t_min = np.minimum(rate_a, rate_b).max(-1)
    t_max = np.maximum(rate_a, rate_b).min(-1)
    return t_max > t_min


@torch.no_grad()
def filter_rays_mask(cfg: F.FieldConfig, scene: Dict,
                     all_rays: np.ndarray) -> np.ndarray:
    """Boolean keep-mask (numpy) of the rays [N, 6] with a sample in an
    occupied voxel of the alpha mask: 256 samples per ray at the mask
    grid's step, 51,200 rays at a time on the scene's device."""
    aabb = scene["aabb"]
    dev = aabb.device
    grid = scene["alpha_volume"].shape                        # (Z, Y, X)
    step = F.step_size(aabb, tuple(int(g) for g in grid[::-1]),
                       cfg.step_ratio)
    out = []
    for start in range(0, all_rays.shape[0], _FILTER_CHUNK):
        rays = torch.as_tensor(all_rays[start:start + _FILTER_CHUNK],
                               device=dev)
        xyz, _, valid = sample_ray(rays[:, :3], rays[:, 3:6], aabb,
                                   cfg.near_far[0], cfg.near_far[1], step,
                                   _FILTER_N_SAMPLES)
        occ = F.sample_alpha_mask(scene, xyz) > 0
        out.append((occ & valid).any(-1).cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0,), bool)
