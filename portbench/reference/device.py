"""Device selection for the port's entry points.

Every entry point takes ``device=None``, which means the card: under a
launcher (``LOCAL_RANK`` set, one process per GPU) the rank's own card
``cuda:LOCAL_RANK``. The CPU is used only when the caller asks for it by
name (the tests do); there is no silent fallback, because a CPU run
measures nothing about the card.
"""
from __future__ import annotations

import os
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (``cuda:LOCAL_RANK`` under a launcher); an
    explicit device always wins. Raises if CUDA is asked for and absent,
    or if the launcher's card does not exist.

    Also turns TF32 off for matmuls and cuDNN: the JAX reference computes
    every f32 product at full precision (``Precision.HIGHEST``), and TF32
    keeps only about three decimal digits.
    """
    local = os.environ.get("LOCAL_RANK")
    if device is not None:
        dev = torch.device(device)
    elif local is not None:
        dev = torch.device(f"cuda:{int(local)}")
    else:
        dev = torch.device("cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is not None \
            and dev.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"{dev} does not exist: this machine has "
            f"{torch.cuda.device_count()} CUDA device(s)"
            + (f" and LOCAL_RANK is {local}" if device is None else ""))
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if device is None and local is not None:
        # the rank's card becomes current, for NCCL and the kernels' streams
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
