"""Plain versions of the port's two row kernels: ``table[idx]`` and its
adjoint ``index_add_``, through autograd's own indexing."""
from __future__ import annotations

import torch


def row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` (rows of any dtype)."""
    return table[idx.long()]


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``, differentiable in ``table``."""
    return table[idx.long()]
