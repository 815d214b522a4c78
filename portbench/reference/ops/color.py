"""Colour-space conversion (port of tensoir_tpu.ops.color)."""
from __future__ import annotations

import torch

from portbench.reference.ops.interp import clip

_SRGB_LINEAR_THRES = 0.0031308
_SRGB_LINEAR_COEFF = 12.92
_SRGB_EXP_COEFF = 1.055
_SRGB_EXPONENT = 2.4


def linear2srgb(x: torch.Tensor) -> torch.Tensor:
    """Linear -> sRGB with the reference's 1e-6-biased power; the input is
    clipped to [0, 1] first."""
    x = clip(x, 0.0, 1.0)
    lin = x * _SRGB_LINEAR_COEFF
    nonlin = (_SRGB_EXP_COEFF * torch.pow(x + 1e-6, 1.0 / _SRGB_EXPONENT)
              - (_SRGB_EXP_COEFF - 1.0))
    return torch.where(x <= _SRGB_LINEAR_THRES, lin, nonlin)


def srgb2linear(x: torch.Tensor) -> torch.Tensor:
    """sRGB -> linear, the inverse curve without the bias; the input is
    clipped to [0, 1] first."""
    x = clip(x, 0.0, 1.0)
    lin = x / _SRGB_LINEAR_COEFF
    nonlin = torch.pow((x + (_SRGB_EXP_COEFF - 1.0)) / _SRGB_EXP_COEFF,
                       _SRGB_EXPONENT)
    return torch.where(x <= _SRGB_LINEAR_THRES * _SRGB_LINEAR_COEFF, lin,
                       nonlin)
