"""Ray marching primitives (port of tensoir_tpu.ops.rays, the parts the
training step needs, the NDC march and warp included). Random jitter is
passed in, not drawn here, so a test can hand both packages the same
numbers."""
from __future__ import annotations

from typing import Optional

import numpy as np
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


def linspace(start: float, stop: float, num: int, dtype=torch.float32,
             device=None) -> torch.Tensor:
    """``jnp.linspace`` as XLA computes it, bit for bit: start * (1 - s) +
    stop * s with s = i * (1/d) in ``dtype`` (XLA turns the division by the
    constant d into a product with its reciprocal), and ``stop`` itself
    last. ``torch.linspace`` rounds some points differently."""
    if num < 2:
        return torch.full((num,), start, dtype=dtype, device=device)
    div = num - 1
    # Python floats holding the f32 values: a product with an f32 tensor
    # rounds as XLA's f32 product does, and nothing is copied to the device
    f32 = np.float32
    lo, hi, recip = float(f32(start)), float(f32(stop)), float(f32(1) / div)
    step = torch.arange(div, dtype=dtype, device=device) * recip
    return torch.cat([lo * (1 - step) + hi * step,
                      torch.full((1,), hi, dtype=dtype, device=device)])


def sample_ray_equally(rays_o, rays_d, aabb, vis_near: float,
                       vis_far: float, n_samples: int):
    """Equally spaced samples in [vis_near, vis_far] along secondary rays,
    one z grid for all. Returns xyz [N, S, 3], z_vals [1, S], valid [N, S]
    (inside the AABB)."""
    t = linspace(0.0, 1.0, n_samples, rays_o.dtype, rays_o.device)
    z_vals = (vis_near * (1.0 - t) + vis_far * t)[None, :]
    xyz = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    valid = ((xyz >= aabb[0]) & (xyz <= aabb[1])).all(-1)
    return xyz, z_vals, valid


def sample_ray_ndc(rays_o, rays_d, aabb, near: float, far: float,
                   n_samples: int, jitter: Optional[torch.Tensor] = None):
    """NDC-space marching: ``n_samples`` uniform z in [near, far], each
    moved by ``jitter`` [N, S] (uniform draws) times the bin width when
    given. Returns xyz [N, S, 3], z_vals [N, S], valid [N, S] (inside the
    AABB)."""
    N = rays_o.shape[0]
    interpx = linspace(near, far, n_samples, rays_o.dtype,
                       rays_o.device)[None, :]
    if jitter is not None:
        interpx = interpx + jitter * ((far - near) / n_samples)
    xyz = rays_o[:, None, :] + rays_d[:, None, :] * interpx[..., None]
    valid = ((xyz >= aabb[0]) & (xyz <= aabb[1])).all(-1)
    return xyz, interpx.expand(N, n_samples), valid


def ndc_rays_blender(h: int, w: int, focal: float, near: float, rays_o,
                     rays_d):
    """Blender-convention NDC warp of rays [..., 3] -> (origins,
    directions)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d
    o0 = -1.0 / (w / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (h / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]
    d0 = -1.0 / (w / (2.0 * focal)) * (
        rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2])
    d1 = -1.0 / (h / (2.0 * focal)) * (
        rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2])
    d2 = -2.0 * near / rays_o[..., 2]
    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)


def z_to_dists(z_vals):
    """Consecutive sample spacing with a trailing zero."""
    return torch.cat([z_vals[..., 1:] - z_vals[..., :-1],
                      torch.zeros_like(z_vals[..., :1])], -1)


def safe_l2_normalize(x, dim: int = -1, eps: float = 1e-6):
    """x / max(||x||, eps), with a zero (not NaN) gradient at x = 0."""
    sq = (x * x).sum(dim, keepdim=True)
    return x / torch.sqrt(sq.clamp_min(eps * eps))
