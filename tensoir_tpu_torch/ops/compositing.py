"""Alpha compositing along rays (port of tensoir_tpu.ops.compositing)."""
from __future__ import annotations

import torch


def raw2alpha(sigma: torch.Tensor, dist: torch.Tensor):
    """alpha = 1 - exp(-sigma * dist); weights = alpha * exclusive
    cumprod(1 - alpha + 1e-10). Returns (alpha, weights, bg [..., 1])."""
    alpha = 1.0 - torch.exp(-sigma * dist)
    one_minus = 1.0 - alpha + 1e-10
    t_excl = torch.cumprod(
        torch.cat([torch.ones_like(one_minus[..., :1]), one_minus], -1), -1)
    weights = alpha * t_excl[..., :-1]
    return alpha, weights, t_excl[..., -1:]
