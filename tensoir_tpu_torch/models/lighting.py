"""Environment light as spherical Gaussians (port of
tensoir_tpu.models.lighting: the lat-long direction sets, SG init and
evaluation, and the per-light query for ``light_kind='sg'``).

Light kinds ``pixel`` and ``gt`` and the importance / equal-area samplers
are not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tensoir_tpu_torch.ops.rays import linspace


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
    if draws is None:
        gen_dev = key.device
        u_phi = torch.rand((envmap_h, envmap_w), generator=key, device=gen_dev)
        u_theta = torch.rand((envmap_h, envmap_w), generator=key,
                             device=gen_dev)
    else:
        u_phi, u_theta = (torch.as_tensor(d, dtype=torch.float32)
                          for d in draws)
    dev = u_phi.device if device is None else torch.device(device)
    phi0 = linspace(np.pi / 2 - 0.5 * lat_step, -np.pi / 2 + 0.5 * lat_step,
                    envmap_h, device=dev)
    th0 = linspace(np.pi - 0.5 * lng_step, -np.pi + 0.5 * lng_step, envmap_w,
                   device=dev)
    phi0, th0 = torch.meshgrid(phi0, th0, indexing="ij")
    phi = phi0 + lat_step * (u_phi.to(dev) - 0.5)
    theta = th0 + lng_step * (u_theta.to(dev) - 0.5)
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


def get_light_rgbs(light_params, cfg, dirs: torch.Tensor) -> torch.Tensor:
    """Radiance of every light at directions [S, 3] -> [light_num, S, 3].

    One SG set per light (``per_light_sg``), queried at the directions as
    they are; or one set shared by all lights, queried at the directions
    rotated by each light's z rotation."""
    if cfg.light_kind != "sg":
        raise NotImplementedError(
            f"light_kind={cfg.light_kind!r}: the port has only 'sg' so far")
    sgs = light_params["lgt_sgs"]
    if cfg.per_light_sg:
        return torch.stack([render_envmap_sg(s, dirs) for s in sgs])
    rots = torch.as_tensor(rotation_matrices(cfg.light_rotations),
                           device=dirs.device)
    remapped = torch.einsum("sd,lde->lse", dirs, rots)          # [L, S, 3]
    return render_envmap_sg(sgs, remapped)
