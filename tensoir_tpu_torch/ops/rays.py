"""Ray marching primitives (port of tensoir_tpu.ops.rays, the parts the
radiance step needs). Random jitter is passed in, not drawn here, so a test
can hand both packages the same numbers."""
from __future__ import annotations

from typing import Optional

import torch


def aabb_ray_tmin(rays_o, rays_d, aabb, near: float, far: float):
    """Entry distance of each ray into the AABB, clamped to [near, far]."""
    vec = torch.where(rays_d == 0, torch.full_like(rays_d, 1e-6), rays_d)
    rate_a = (aabb[1] - rays_o) / vec
    rate_b = (aabb[0] - rays_o) / vec
    t_min = torch.minimum(rate_a, rate_b).amax(-1)
    return t_min.clamp(near, far)


def sample_ray(rays_o, rays_d, aabb, near: float, far: float, step_size,
               n_samples: int, jitter: Optional[torch.Tensor] = None):
    """Fixed-step marching from the AABB entry point.

    jitter: [N, 1] uniform offsets in sample units, one per ray (the
    reference's train-time jitter), or None.
    Returns xyz [N, S, 3], z_vals [N, S], valid [N, S] (inside the AABB).
    """
    t_min = aabb_ray_tmin(rays_o, rays_d, aabb, near, far)
    rng = torch.arange(n_samples, dtype=rays_o.dtype,
                       device=rays_o.device)[None, :]
    if jitter is not None:
        rng = rng + jitter
    z_vals = t_min[:, None] + step_size * rng
    xyz = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    valid = ((xyz >= aabb[0]) & (xyz <= aabb[1])).all(-1)
    return xyz, z_vals, valid


def z_to_dists(z_vals):
    """Consecutive sample spacing with a trailing zero."""
    return torch.cat([z_vals[..., 1:] - z_vals[..., :-1],
                      torch.zeros_like(z_vals[..., :1])], -1)


def safe_l2_normalize(x, dim: int = -1, eps: float = 1e-6):
    """x / max(||x||, eps), with a zero (not NaN) gradient at x = 0."""
    sq = (x * x).sum(dim, keepdim=True)
    return x / torch.sqrt(sq.clamp_min(eps * eps))
