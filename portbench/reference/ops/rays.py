"""Ray marching primitives (port of tensoir_tpu.ops.rays: the marches the
training step needs, the NDC march and warp, the ray/AABB test, inverse-CDF
sampling and the spherical-coordinate helpers of the light-probe tooling).
The marches' random jitter is passed in, not drawn here, so a test can
hand both packages the same numbers; ``sample_pdf`` draws from a
``torch.Generator``."""
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


def aabb_intersect(rays_o, rays_d, aabb):
    """(t_min, t_max, hit) of each ray with the AABB: the ``bbox_only`` ray
    filter's test."""
    vec = torch.where(rays_d == 0, torch.full_like(rays_d, 1e-6), rays_d)
    rate_a = (aabb[1] - rays_o) / vec
    rate_b = (aabb[0] - rays_o) / vec
    t_min = torch.minimum(rate_a, rate_b).amax(-1)
    t_max = torch.maximum(rate_a, rate_b).amin(-1)
    return t_min, t_max, t_max > t_min


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


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               key: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverse-CDF sampling of bins [B, M+1] by weights [B, M] ->
    [B, n_samples]: at ``n_samples`` evenly spaced quantiles in [0, 1]
    with ``key=None`` (the deterministic path), else at uniform draws from
    ``key``."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    shape = cdf.shape[:-1] + (n_samples,)
    if key is None:
        u = linspace(0.0, 1.0, n_samples, cdf.dtype,
                     cdf.device).expand(shape).contiguous()
    else:
        u = torch.rand(shape, generator=key, dtype=cdf.dtype,
                       device=cdf.device)
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = (inds - 1).clamp_min(0)
    above = inds.clamp_max(cdf.shape[-1] - 1)
    cdf_g0 = torch.gather(cdf, -1, below)
    cdf_g1 = torch.gather(cdf, -1, above)
    bins_g0 = torch.gather(bins, -1, below)
    bins_g1 = torch.gather(bins, -1, above)
    denom = cdf_g1 - cdf_g0
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_g0) / denom
    return bins_g0 + t * (bins_g1 - bins_g0)


def convert_sph_conventions(pts_r_angle1_angle2, what2what: str):
    """Convert [n, 3] spherical coordinates between conventions, in numpy:
    'lat-lng' is (r, latitude in [-pi/2, pi/2] from the equator, longitude
    in [-pi, pi]), 'theta-phi' (r, polar angle in [0, pi] from +z, azimuth
    in [0, 2 pi]); ``what2what`` is 'lat-lng_to_theta-phi' or
    'theta-phi_to_lat-lng'."""
    pts = np.asarray(pts_r_angle1_angle2)
    out = np.zeros(pts.shape)
    out[:, 0] = pts[:, 0]
    out[:, 1] = np.pi / 2 - pts[:, 1]
    if what2what == "lat-lng_to_theta-phi":
        out[:, 2] = np.where(pts[:, 2] < 0, 2 * np.pi + pts[:, 2], pts[:, 2])
        return out
    if what2what == "theta-phi_to_lat-lng":
        out[:, 2] = np.where(pts[:, 2] > np.pi, pts[:, 2] - 2 * np.pi,
                             pts[:, 2])
        return out
    raise NotImplementedError(what2what)


def sph2cart(pts_sph, convention: str = "lat-lng"):
    """Spherical [n, 3] -> cartesian, in numpy: z = r sin(lat), x = r
    cos(lat) cos(lng), y = r cos(lat) sin(lng); a 'theta-phi' input is
    converted to 'lat-lng' first."""
    pts_sph = np.asarray(pts_sph)
    if pts_sph.ndim != 2 or pts_sph.shape[-1] != 3:
        raise ValueError("shape of input must be (n, 3)")
    if not (np.abs(pts_sph[:, 1:]) <= 2 * np.pi).all():
        raise ValueError("input angle falls out of [-2pi, 2pi]")
    if convention == "lat-lng":
        p = pts_sph
    elif convention == "theta-phi":
        p = convert_sph_conventions(pts_sph, "theta-phi_to_lat-lng")
    else:
        raise NotImplementedError(convention)
    r, lat, lng = p[:, 0], p[:, 1], p[:, 2]
    return np.stack((r * np.cos(lat) * np.cos(lng),
                     r * np.cos(lat) * np.sin(lng),
                     r * np.sin(lat)), axis=-1)
