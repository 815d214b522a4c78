"""Device selection for the port's entry points.

Every entry point takes ``device=None``, which means the card. The CPU is
used only when the caller asks for it by name (the tests do); there is no
silent fallback, because a CPU run measures nothing about the card.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``. Raises if CUDA is asked for and absent.

    Also turns TF32 off for matmuls and cuDNN: the JAX reference computes
    every f32 product at full precision (``Precision.HIGHEST``), and TF32
    keeps only about three decimal digits.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
