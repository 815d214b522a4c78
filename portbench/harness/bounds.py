"""The yardstick: the H100's published peaks and the least time of the
port's two row kernels, copied from ``chip_smoke.py``'s roofline
arithmetic (``gather_bound_ms``)."""
from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12
# float32 outside the tensor cores: the port turns TF32 off
F32_FLOPS_PER_S = 67e12


def gather_bound_ms(idx: torch.Tensor, row_bytes: int) -> float:
    """K1's least time: the index read, each output row written, and each
    distinct table row it needs read once, at the HBM rate."""
    n, distinct = idx.numel(), torch.unique(idx).numel()
    return ((idx.element_size() + row_bytes) * n + row_bytes * distinct
            ) / HBM_BYTES_PER_S * 1e3


def scatter_bound_ms(idx: torch.Tensor, row_bytes: int) -> float:
    """K2's least time: the index and the values read, and each distinct
    output row written once. (``chip_smoke.py`` counts every output row:
    there the zeroing, a separate memset, is inside the timed call; the
    trace times the kernel alone.)"""
    n, distinct = idx.numel(), torch.unique(idx).numel()
    return ((idx.element_size() + row_bytes) * n + row_bytes * distinct
            ) / HBM_BYTES_PER_S * 1e3
