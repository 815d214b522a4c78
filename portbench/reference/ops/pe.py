"""Positional encoding (port of tensoir_tpu.ops.pe): for x [..., D] and F
frequencies, [sin | cos] of the dim-major products x_d * 2^f -> [..., 2DF]."""
from __future__ import annotations

import torch


def positional_encoding(x: torch.Tensor, freqs: int) -> torch.Tensor:
    if freqs <= 0:
        return x.new_zeros(x.shape[:-1] + (0,))
    bands = 2.0 ** torch.arange(freqs, dtype=x.dtype, device=x.device)
    pts = (x[..., None] * bands).reshape(*x.shape[:-1], x.shape[-1] * freqs)
    return torch.cat([torch.sin(pts), torch.cos(pts)], -1)
