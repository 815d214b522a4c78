"""The port's row kernels: the plain versions against the repo's Pallas
kernels, the autograd pairing of gather and scatter-add, the device rules
of the entry points, and (on a card only) each CUDA kernel against its
plain version.

Tolerances: gathers copy values, so they match exactly. Scatter-adds sum
the same f32 terms in another order than the Pallas loop: 1e-5 relative,
1e-5 absolute (a row receives at most a few tens of terms of size ~1).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from tensoir_tpu_torch import kernels as K
from tensoir_tpu_torch.device import resolve_device

ROOT = Path(__file__).resolve().parent.parent
R, CHUNK, N = 97, 256, 1024


def _pallas_probe():
    """The repo's Pallas probe, which imports JAX only inside its makers:
    this file imports no JAX itself, so its card test runs where JAX is
    not installed."""
    spec = importlib.util.spec_from_file_location(
        "bench_pallas_scatter", ROOT / "scripts" / "bench_pallas_scatter.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(C, seed=0, n=N):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, R, size=(n,)).astype(np.int32)
    table = rng.normal(size=(R, C)).astype(np.float32)
    val = rng.normal(size=(n, C)).astype(np.float32)
    return idx, table, val


@pytest.mark.parametrize("C", [64, 192])
def test_plain_gather_matches_pallas_gather(C):
    idx, table, _ = _inputs(C)
    gather = _pallas_probe().make_gather(R, C, CHUNK, interpret=True)
    want = np.asarray(gather(idx, table))
    got = K.row_gather(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("C", [64, 192])
def test_plain_scatter_add_matches_pallas_scatter_add(C):
    idx, _, val = _inputs(C, seed=1)
    scatter = _pallas_probe().make_scatter_add(R, C, CHUNK, interpret=True)
    want = np.asarray(scatter(idx, val))
    got = K.row_scatter_add(torch.from_numpy(idx), torch.from_numpy(val), R)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_row_gather_gradients(idx_dtype):
    """First order: K1's backward (K2) equals autograd of ``table[idx]``.
    Second order: K2's backward (K1) equals autograd of ``index_add_``."""
    idx_np, table_np, val_np = _inputs(8, seed=2, n=300)
    idx = torch.from_numpy(idx_np).to(idx_dtype)
    up = torch.from_numpy(val_np)

    table = torch.from_numpy(table_np).requires_grad_(True)
    (g_port,) = torch.autograd.grad((K.gather_rows(table, idx) * up).sum(),
                                    table)
    (g_ref,) = torch.autograd.grad((table[idx.long()] * up).sum(), table)
    torch.testing.assert_close(g_port, g_ref, rtol=1e-6, atol=1e-6)

    val = torch.from_numpy(val_np).requires_grad_(True)
    w = torch.from_numpy(table_np)
    out = K.RowScatterAdd.apply(idx, val, R)
    (gv_port,) = torch.autograd.grad((out * w).sum(), val)
    ref = torch.zeros((R, 8)).index_add(0, idx.long(), val)
    (gv_ref,) = torch.autograd.grad((ref * w).sum(), val)
    torch.testing.assert_close(gv_port, gv_ref, rtol=0, atol=0)

    # the gradient of a gradient goes through the pair again
    table = torch.from_numpy(table_np).requires_grad_(True)
    (g1,) = torch.autograd.grad((K.gather_rows(table, idx) ** 2).sum(), table,
                                create_graph=True)
    (g2,) = torch.autograd.grad((g1 * w).sum(), table)
    counts = torch.bincount(idx.long(), minlength=R).float()[:, None]
    torch.testing.assert_close(g2, 2.0 * counts * w, rtol=1e-6, atol=1e-6)


def test_cpu_calls_launch_nothing_and_check_their_input():
    K.reset_launch_counts()
    idx_np, table_np, val_np = _inputs(4, n=16)
    idx, table = torch.from_numpy(idx_np), torch.from_numpy(table_np)
    K.row_gather(table, idx)
    K.row_scatter_add(idx, torch.from_numpy(val_np), R)
    assert K.LAUNCHES == {"row_gather": 0, "row_scatter_add": 0}
    with pytest.raises(IndexError):
        K.row_gather(table, torch.tensor([0, R], dtype=torch.int32))
    with pytest.raises(IndexError):
        K.row_scatter_add(torch.tensor([-1], dtype=torch.int32),
                          torch.ones((1, 4)), R)
    with pytest.raises(ValueError):
        K.row_gather(table.double(), idx)
    with pytest.raises(ValueError):
        K.row_gather(table, idx.float())


def test_non_cpu_tensors_never_take_the_plain_version():
    """Off the CPU a wrapper launches its kernel or raises; a tensor on a
    device that is not CUDA raises instead of falling back."""
    table = torch.empty((R, 4), device="meta")
    idx = torch.empty((8,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        K.row_gather(table, idx)
    with pytest.raises(ValueError):
        K.row_scatter_add(idx, torch.empty((8, 4), device="meta"), R)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: device=None is valid here")
    from tensoir_tpu_torch.models.field import FieldConfig, init_field_params
    from tensoir_tpu_torch.train.optim import make_optimizer
    from tensoir_tpu_torch.train.step import (LossWeights, StepStatic,
                                              make_train_step)
    from tensoir_tpu_torch.weights import params_from_numpy
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({}, {})
    with pytest.raises(RuntimeError, match="CUDA"):
        init_field_params(torch.Generator(), FieldConfig(), (4, 4, 4),
                          [[-1] * 3, [1] * 3])
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(FieldConfig(), make_optimizer({}, 0.02, 1e-3, 1.0),
                        StepStatic(n_samples=8, is_relight=False,
                                   white_bg=True), LossWeights())
    assert resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.cuda
@pytest.mark.parametrize("C", [3, 64, 192])
def test_cuda_kernels_match_plain_versions(C):
    """Run on the card: ``python -m pytest tests/test_torch_kernels.py -m
    cuda --noconftest`` (the suite's conftest needs JAX). K1 exactly; K2
    within the reordering of f32 sums."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    idx_np, table_np, val_np = _inputs(C, seed=3, n=5000)
    dev = torch.device("cuda")
    table = torch.from_numpy(table_np).to(dev)
    val = torch.from_numpy(val_np).to(dev)
    for dtype in (torch.int32, torch.int64):
        idx = torch.from_numpy(idx_np).to(dev, dtype)
        K.reset_launch_counts()
        got = K.row_gather(table, idx)
        torch.testing.assert_close(got, K.row_gather_plain(table, idx),
                                   rtol=0, atol=0)
        got = K.row_scatter_add(idx, val, R)
        torch.testing.assert_close(got, K.row_scatter_add_plain(idx, val, R),
                                   rtol=1e-5, atol=1e-4)
        torch.cuda.synchronize()
        assert K.LAUNCHES == {"row_gather": 1, "row_scatter_add": 1}
