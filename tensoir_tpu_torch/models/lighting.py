"""Spherical-Gaussian light init (port of the SG-init part of
tensoir_tpu.models.lighting)."""
from __future__ import annotations

import numpy as np
import torch


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
