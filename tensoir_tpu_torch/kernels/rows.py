"""Row gather (K1) and row scatter-add (K2): wrappers, plain versions and
their autograd pairing.

K1 ``row_gather(table [R, C], idx [N]) -> [N, C]`` replaces the Pallas
kernel ``make_gather`` (f32 rows, and bf16 rows for the corner-packed baked
sigma grid and alpha mask) and K2 ``row_scatter_add(idx [N], val [N, C], R) ->
[R, C]`` replaces ``make_scatter_add`` (both in
``scripts/bench_pallas_scatter.py``). Each wrapper takes its plain PyTorch
version only for tensors on the CPU; for CUDA tensors it launches the
kernel from ``csrc/`` or raises. ``LAUNCHES`` counts kernel launches, and
nothing else.

``RowGather`` is K1 with K2 as its backward; ``RowScatterAdd`` is K2 with
K1 as its backward. Gather and scatter-add are each other's adjoints, so
gradients of any order go through the two kernels alone.
"""
from __future__ import annotations

import torch

from tensoir_tpu_torch.kernels import build

# K1 on f32 rows, K1 on 2-byte (bf16) rows, K2
LAUNCHES = {"row_gather": 0, "row_gather_bf16": 0, "row_scatter_add": 0}
_GATHER_SYMBOL = {torch.float32: ("row_gather_f32", "row_gather"),
                  torch.bfloat16: ("row_gather_b16", "row_gather_bf16")}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_idx(idx: torch.Tensor) -> None:
    if idx.dim() != 1 or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"idx must be 1-D int32/int64, got {idx.dtype} "
                         f"{tuple(idx.shape)}")


def _check_range(idx: torch.Tensor, num_rows: int) -> None:
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= num_rows):
        raise IndexError(f"row index out of range [0, {num_rows})")


def row_gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: ``table[idx]``."""
    _check_range(idx, table.shape[0])
    return table[idx]


def row_scatter_add_plain(idx: torch.Tensor, val: torch.Tensor,
                          num_rows: int) -> torch.Tensor:
    """Plain version of K2: ``zeros(R, C).index_add_(0, idx, val)``."""
    _check_range(idx, num_rows)
    out = torch.zeros((num_rows, val.shape[1]), dtype=val.dtype,
                      device=val.device)
    return out.index_add_(0, idx, val)


def _check_cuda(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {t.device} "
                             f"vs {dev}")
        if not t.is_contiguous():
            raise ValueError("CUDA row kernels need contiguous tensors")
    if dev.type != "cuda":
        raise ValueError(f"row kernels run on CPU or CUDA, not {dev}")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K1: ``out[i, :] = table[idx[i], :]`` for an f32 or bf16 ``table [R,
    C]``. Not differentiable by itself (``gather_rows`` is)."""
    _check_idx(idx)
    if table.dim() != 2 or table.dtype not in _GATHER_SYMBOL:
        raise ValueError(f"table must be 2-D float32 or bfloat16, got "
                         f"{table.dtype} {tuple(table.shape)}")
    if table.device.type == "cpu" and idx.device.type == "cpu":
        return row_gather_plain(table, idx)
    _check_cuda(table, idx)
    n, c = idx.shape[0], table.shape[1]
    out = torch.empty((n, c), dtype=table.dtype, device=table.device)
    symbol, counter = _GATHER_SYMBOL[table.dtype]
    fn = build.kernel(symbol)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(table.data_ptr(), idx.data_ptr(),
                 int(idx.dtype == torch.int64), out.data_ptr(), n, c, stream)
    _raise_on(err, symbol)
    if n and c:     # the kernel returns without a launch on empty input
        LAUNCHES[counter] += 1
    return out


def row_scatter_add(idx: torch.Tensor, val: torch.Tensor,
                    num_rows: int) -> torch.Tensor:
    """K2: ``out = zeros(R, C); out[idx[i], :] += val[i, :]`` for f32
    ``val [N, C]``."""
    _check_idx(idx)
    if (val.dim() != 2 or val.dtype != torch.float32
            or val.shape[0] != idx.shape[0]):
        raise ValueError(f"val must be float32 [N={idx.shape[0]}, C], got "
                         f"{val.dtype} {tuple(val.shape)}")
    if val.device.type == "cpu" and idx.device.type == "cpu":
        return row_scatter_add_plain(idx, val, num_rows)
    _check_cuda(idx, val)
    n, c = val.shape
    out = torch.empty((num_rows, c), dtype=val.dtype, device=val.device)
    fn = build.kernel("row_scatter_add_f32")
    with torch.cuda.device(val.device):
        stream = torch.cuda.current_stream(val.device).cuda_stream
        err = fn(idx.data_ptr(), int(idx.dtype == torch.int64),
                 val.data_ptr(), out.data_ptr(), n, num_rows, c, stream)
    _raise_on(err, "row_scatter_add")
    if n and c:     # on empty input only the memset runs
        LAUNCHES["row_scatter_add"] += 1
    return out


class RowGather(torch.autograd.Function):
    """Differentiable K1 in ``table``; its backward is K2."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.num_rows = table.shape[0]
        return row_gather(table, idx)

    @staticmethod
    def backward(ctx, grad_out):
        (idx,) = ctx.saved_tensors
        return RowScatterAdd.apply(idx, grad_out.contiguous(),
                                   ctx.num_rows), None


class RowScatterAdd(torch.autograd.Function):
    """Differentiable K2 in ``val``; its backward is K1."""

    @staticmethod
    def forward(ctx, idx, val, num_rows):
        ctx.save_for_backward(idx)
        return row_scatter_add(idx, val, num_rows)

    @staticmethod
    def backward(ctx, grad_out):
        (idx,) = ctx.saved_tensors
        return None, RowGather.apply(grad_out.contiguous(), idx), None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` through K1, differentiable in ``table``."""
    return RowGather.apply(table.contiguous(), idx)
