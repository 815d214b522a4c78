"""The learned environment light (port of tensoir_tpu.models.lighting):
the lat-long direction sets (texel centres, stratified, stratified in equal
areas), spherical Gaussians (init and evaluation), the lat-long map lookup,
the per-light query of every light kind (``sg``, ``pixel``: a learned
lat-long map, ``gt``: the dataset's probe), and importance sampling of the
learned light (CDF inversion in place of the reference's multinomial).

Every sampler draws its uniforms from a ``torch.Generator``, or takes them
as ``draws``, so that a test can hand it the JAX package's own.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from portbench.reference.ops.interp import bilerp_plane, clip, recip
from portbench.reference.ops.rays import linspace


def envmap_dirs(envmap_h: int, envmap_w: int):
    """Texel-centre lat-long directions and their area weights: phi from
    +pi/2 down to -pi/2, theta from +pi to -pi, dirs = (cos t cos p,
    sin t cos p, sin p), weights 4 pi sin(pi/2 - phi) / sum. Returns
    (area_weight [H*W], dirs [H*W, 3]) as numpy float32."""
    lat_step = np.pi / envmap_h
    lng_step = 2 * np.pi / envmap_w
    phi = np.linspace(np.pi / 2 - 0.5 * lat_step, -np.pi / 2 + 0.5 * lat_step,
                      envmap_h, dtype=np.float64)
    theta = np.linspace(np.pi - 0.5 * lng_step, -np.pi + 0.5 * lng_step,
                        envmap_w, dtype=np.float64)
    phi, theta = np.meshgrid(phi, theta, indexing="ij")
    sin_phi = np.sin(np.pi / 2 - phi)
    area = 4 * np.pi * sin_phi / np.sum(sin_phi)
    dirs = np.stack([np.cos(theta) * np.cos(phi), np.sin(theta) * np.cos(phi),
                     np.sin(phi)], axis=-1)
    return (area.reshape(-1).astype(np.float32),
            dirs.reshape(-1, 3).astype(np.float32))


def stratified_dirs(key: Optional[torch.Generator], envmap_h: int,
                    envmap_w: int, *, draws: Optional[Tuple] = None,
                    device=None) -> torch.Tensor:
    """Jittered lat-long directions [H*W, 3]: each texel centre moves by a
    uniform draw of up to half a texel in phi and in theta. The two [H, W]
    uniform draws come from ``key`` (phi first), or are given as ``draws``
    = (u_phi, u_theta), so that a test can pass the JAX package's own."""
    lat_step = np.pi / envmap_h
    lng_step = 2 * np.pi / envmap_w
    u_phi, u_theta, dev = _uniform_pair(key, (envmap_h, envmap_w), draws,
                                        device)
    phi0 = linspace(np.pi / 2 - 0.5 * lat_step, -np.pi / 2 + 0.5 * lat_step,
                    envmap_h, device=dev)
    th0 = linspace(np.pi - 0.5 * lng_step, -np.pi + 0.5 * lng_step, envmap_w,
                   device=dev)
    phi0, th0 = torch.meshgrid(phi0, th0, indexing="ij")
    phi = phi0 + lat_step * (u_phi - 0.5)
    theta = th0 + lng_step * (u_theta - 0.5)
    dirs = torch.stack([torch.cos(theta) * torch.cos(phi),
                        torch.sin(theta) * torch.cos(phi),
                        torch.sin(phi)], -1)
    return dirs.reshape(-1, 3)


def _uniform_pair(key, shape, draws, device):
    """Two uniform tensors of ``shape``, drawn from ``key`` (the first
    first) or given as ``draws``, on ``device`` (default: where they
    are)."""
    if draws is None:
        u = [torch.rand(shape, generator=key, device=key.device)
             for _ in range(2)]
    else:
        u = [torch.as_tensor(d, dtype=torch.float32) for d in draws]
    dev = u[0].device if device is None else torch.device(device)
    return u[0].to(dev), u[1].to(dev), dev


def stratified_equal_area_dirs(key: Optional[torch.Generator], envmap_h: int,
                               envmap_w: int, *, draws: Optional[Tuple] = None,
                               device=None) -> torch.Tensor:
    """Directions [H*W, 3] stratified in equal areas: sin(phi) on a grid
    of H rows from 1 down to -1 and theta on W columns, each jittered by a
    uniform draw of up to half a cell; ``draws`` = (u_sin_phi, u_theta)
    as in ``stratified_dirs``."""
    sp_step = 2.0 / envmap_h
    lng_step = 2 * np.pi / envmap_w
    u_sp, u_theta, dev = _uniform_pair(key, (envmap_h, envmap_w), draws,
                                       device)
    sp0 = linspace(1 - 0.5 * sp_step, -1 + 0.5 * sp_step, envmap_h,
                   device=dev)
    th0 = linspace(np.pi - 0.5 * lng_step, -np.pi + 0.5 * lng_step, envmap_w,
                   device=dev)
    sp0, th0 = torch.meshgrid(sp0, th0, indexing="ij")
    sin_phi = sp0 + sp_step * (u_sp - 0.5)
    theta = th0 + lng_step * (u_theta - 0.5)
    phi = torch.arcsin(clip(sin_phi, -1.0, 1.0))
    dirs = torch.stack([torch.cos(theta) * torch.cos(phi),
                        torch.sin(theta) * torch.cos(phi),
                        torch.sin(phi)], -1)
    return dirs.reshape(-1, 3)


def rotation_matrices(rotations_deg) -> np.ndarray:
    """Z-axis rotations of the rotated-lights setting, [R, 3, 3] float32."""
    mats = []
    for deg in rotations_deg:
        a = float(deg) / 180.0 * np.pi
        mats.append(np.array([[np.cos(a), -np.sin(a), 0.0],
                              [np.sin(a), np.cos(a), 0.0],
                              [0.0, 0.0, 1.0]], dtype=np.float32))
    return np.stack(mats, axis=0)


def fibonacci_sphere(samples: int) -> np.ndarray:
    """Uniform points on a sphere, [samples, 3] float32."""
    phi = np.pi * (3.0 - np.sqrt(5.0))
    i = np.arange(samples, dtype=np.float64)
    z = 1 - (i / float(samples - 1)) * 2
    radius = np.sqrt(np.maximum(1 - z * z, 0.0))
    theta = phi * i
    return np.stack([np.cos(theta) * radius, np.sin(theta) * radius, z],
                    axis=-1).astype(np.float32)


def sg_energy(lgt_sgs: torch.Tensor) -> torch.Tensor:
    """Total energy per SG lobe, [M, 3]."""
    lam = lgt_sgs[:, 3:4].abs()
    mu = lgt_sgs[:, 4:].abs()
    return mu * 2.0 * np.pi / lam * (1.0 - torch.exp(-2.0 * lam))


def init_sg_params(gen: torch.Generator, num_sgs: int) -> torch.Tensor:
    """[M, 7] SG mixture: fibonacci lobes (both halves), lambda in
    [10, inf), mu normalized to a total energy of 2*pi*0.8."""
    sgs = torch.randn((num_sgs, 7), generator=gen)
    sgs[:, -2:] = sgs[:, -3:-2].expand(num_sgs, 2)
    sgs[:, 3:4] = 10.0 + (sgs[:, 3:4] * 20.0).abs()
    energy = sg_energy(sgs)
    sgs[:, 4:] = (sgs[:, 4:].abs() / energy.sum(0, keepdim=True)
                  * 2.0 * np.pi * 0.8)
    lobes = torch.from_numpy(fibonacci_sphere(num_sgs // 2))
    sgs[: num_sgs // 2, :3] = lobes
    sgs[num_sgs // 2:, :3] = lobes
    return sgs


def render_envmap_sg(lgt_sgs: torch.Tensor, viewdirs: torch.Tensor):
    """An SG mixture [M, 7] evaluated at directions [..., 3] -> [..., 3]."""
    lobes = lgt_sgs[:, :3] / torch.linalg.norm(lgt_sgs[:, :3], dim=-1,
                                               keepdim=True)
    lam = lgt_sgs[:, 3:4].abs()
    mu = lgt_sgs[:, -3:].abs()
    dots = torch.matmul(viewdirs, lobes.T)                       # [..., M]
    return torch.matmul(torch.exp(lam[:, 0] * (dots - 1.0)), mu)


def latlong_lookup(env_hw3: torch.Tensor, dirs: torch.Tensor,
                   align_corners: bool, padding: str = "zeros"):
    """An [H, W, 3] lat-long map at unit directions [..., 3] -> [..., 3]:
    phi = arccos(z) - 1e-6, theta = atan2(y, x), looked up at
    y = phi / pi * 2 - 1 and x = -theta / pi. The divisions by pi are
    products with its f32 reciprocal, as XLA computes them under ``jit``."""
    phi = torch.arccos(clip(dirs[..., 2], -1.0, 1.0)) - 1e-6
    theta = torch.atan2(dirs[..., 1], dirs[..., 0])
    qy = (phi * recip(np.pi)) * 2.0 - 1.0
    qx = -theta * recip(np.pi)
    return bilerp_plane(env_hw3, qx, qy, align_corners=align_corners,
                        padding=padding)


def get_light_rgbs(light_params, cfg, dirs: torch.Tensor,
                   gt_envmap: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Radiance of every light at directions [S, 3] -> [light_num, S, 3].

    One SG set per light (``per_light_sg``), queried at the directions as
    they are; or one light shared by all, queried at the directions
    rotated by each light's z rotation: an SG set (``sg``), the learned
    lat-long map softplus(5 p) / 5 (``pixel``), or the dataset's probe
    ``gt_envmap`` [H, W, 3] (``gt``)."""
    if cfg.per_light_sg:
        return torch.stack([render_envmap_sg(s, dirs)
                            for s in light_params["lgt_sgs"]])
    rots = torch.as_tensor(rotation_matrices(cfg.light_rotations),
                           device=dirs.device)
    remapped = torch.einsum("sd,lde->lse", dirs, rots)          # [L, S, 3]
    if cfg.light_kind == "sg":
        return render_envmap_sg(light_params["lgt_sgs"], remapped)
    if cfg.light_kind == "pixel":
        env = torch.nn.functional.softplus(
            5.0 * light_params["light_pixel"]) * recip(5.0)
        env = env.reshape(cfg.envmap_h, cfg.envmap_w, 3)
        return latlong_lookup(env, remapped, align_corners=False)
    if cfg.light_kind == "gt":
        if gt_envmap is None:
            raise ValueError("light_kind='gt' needs the dataset's probe "
                             "(scene['gt_envmap'])")
        return latlong_lookup(gt_envmap, remapped, align_corners=False)
    raise ValueError(f"unknown light_kind {cfg.light_kind}")


@torch.no_grad()
def gen_light_incident_dirs_importance(light_params, cfg, key,
                                       sample_number: int, env_h: int = 128,
                                       env_w: int = 256, gt_envmap=None, *,
                                       draws: Optional[Tuple] = None):
    """Light directions drawn from the learned light (light 0's, as the
    training step samples it): the light rendered on a stratified
    ``env_h`` x ``env_w`` lat-long grid (its two [env_h, env_w] uniform
    draws first), then ``sample_number`` draws from pdf proportional to
    intensity * sin(theta) (the third draw). ``draws`` = (u_phi, u_theta,
    u) replaces the generator. No gradient reaches the light. Returns
    (dir [n, 3], rgb [n, 3], pdf [n, 1])."""
    u_jit, u = (None, None) if draws is None else (draws[:2], draws[2])
    light = gt_envmap if cfg.light_kind == "gt" and not cfg.per_light_sg \
        else light_params.get("lgt_sgs", light_params.get("light_pixel"))
    dirs = stratified_dirs(key, env_h, env_w, draws=u_jit,
                           device=light.device)
    env = get_light_rgbs(light_params, cfg, dirs, gt_envmap=gt_envmap)
    return importance_sample_env(key, env[0].reshape(env_h, env_w, 3), dirs,
                                 sample_number, u=u)


@torch.no_grad()
def importance_sample_env(key, env_map: torch.Tensor, env_dirs: torch.Tensor,
                          n_samples: int, *, u=None):
    """Directions drawn from a lat-long map [H, W, 3] by CDF inversion:
    pdf_sample proportional to sum_rgb(env) * sin(theta), searchsorted of
    ``n_samples`` uniforms (from ``key``, or ``u``), and the pdf per solid
    angle pdf_sample * H * W / (2 pi^2 sin(theta)) of each draw.

    The tables follow the JAX package's f32 arithmetic, except the
    cumulative sum, which is taken in float64 and rounded to f32: the
    correctly rounded prefix sums, equal on the CPU and the card (an f32
    scan rounds in an order of its own on each). ``env_dirs`` [H*W, 3]
    are the texels' directions. Returns (dir [n, 3], rgb [n, 3],
    pdf [n, 1])."""
    H, W, _ = env_map.shape
    dev = env_map.device
    intensity = env_map.sum(2)                                   # [H, W]
    h_int = 1.0 / H
    sin_theta = torch.sin(linspace(0.5 * h_int, np.pi - 0.5 * h_int, H,
                                   device=dev))
    pdf = intensity * sin_theta[:, None]
    pdf_sample = (pdf / pdf.sum()).reshape(-1)
    pdf_return = (pdf_sample.reshape(H, W) * H * W
                  / (2.0 * np.pi * np.pi * sin_theta[:, None])).reshape(-1)
    cdf = torch.cumsum(pdf_sample.double(), 0).float()
    if u is None:
        u = torch.rand((n_samples,), generator=key, device=key.device)
    u = torch.as_tensor(u, dtype=torch.float32).to(dev)
    idx = torch.searchsorted(cdf, u, right=True).clamp(0, H * W - 1)
    return (env_dirs[idx], env_map.reshape(-1, 3)[idx],
            pdf_return[idx][:, None])
