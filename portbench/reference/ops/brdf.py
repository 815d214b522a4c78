"""Cook-Torrance GGX specular term (port of tensoir_tpu.ops.brdf).

The reference's quirks are kept, because they are part of its trained
behaviour: the normal is flipped toward the camera with ``N * sign(NoV)``,
Schlick's Fresnel uses the exponential approximation
``2^((-5.55473 VoH - 6.98316) VoH)``, the denominator is clipped to
[1e-6, 4 pi], and the half vector is normalize((L + V) / 2).
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.ops.interp import clip
from portbench.reference.ops.rays import safe_l2_normalize


def ggx_specular(normal, pts2c, pts2l, roughness, fresnel):
    """normal [N, 3], pts2c [N, 3], pts2l [N, L, 3], roughness [N, 1],
    fresnel [N, 3] -> specular reflectance [N, L, 3]."""
    L = safe_l2_normalize(pts2l)
    V = safe_l2_normalize(pts2c)
    H = safe_l2_normalize((L + V[:, None, :]) / 2.0)
    N = safe_l2_normalize(normal)

    NoV = (V * N).sum(-1, keepdim=True)
    N = N * torch.sign(NoV)                      # flip toward the camera

    NoL = clip((N[:, None, :] * L).sum(-1, keepdim=True), 1e-6, 1.0)
    NoV = clip((N * V).sum(-1, keepdim=True), 1e-6, 1.0)
    NoH = clip((N[:, None, :] * H).sum(-1, keepdim=True), 1e-6, 1.0)
    VoH = clip((V[:, None, :] * H).sum(-1, keepdim=True), 1e-6, 1.0)

    alpha = roughness * roughness
    alpha2 = alpha * alpha
    k = (alpha + 2.0 * roughness + 1.0) / 8.0
    fmi = ((-5.55473) * VoH - 6.98316) * VoH
    f = fresnel[:, None, :]
    frac0 = f + (1.0 - f) * torch.exp2(fmi)

    frac = frac0 * alpha2[:, None, :]
    nom0 = NoH * NoH * (alpha2[:, None, :] - 1.0) + 1.0
    nom1 = NoV * (1.0 - k) + k
    nom2 = NoL * (1.0 - k[:, None, :]) + k[:, None, :]
    nom = clip(4.0 * np.pi * nom0 * nom0 * nom1[:, None, :] * nom2,
               1e-6, 4.0 * np.pi)
    return frac / nom
