"""The port's row kernels: the plain versions against the repo's Pallas
kernels (and K1 on bf16 rows against ``jnp.take``), the autograd pairing of
gather and scatter-add, the device rules of the entry points, and (on a
card only) each CUDA kernel against its plain version.

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


def _index_pattern(pattern, rng, n, num_rows=R):
    """Index streams of the shapes the kernels meet: ``random``; ``runs`` of
    equal consecutive indices of lengths 1-40 (a ray's samples in one plane
    cell); ``chunk``, random with one index through the whole second chunk
    of CHUNK entries; ``long``, one index throughout (runs longer than a
    chunk); ``ends``, only the first and the last row."""
    if pattern == "random":
        idx = rng.integers(0, num_rows, size=(n,))
    elif pattern == "runs":
        lengths = rng.integers(1, 41, size=(n,))
        idx = np.repeat(rng.integers(0, num_rows, size=(n,)), lengths)[:n]
    elif pattern == "chunk":
        idx = rng.integers(0, num_rows, size=(n,))
        idx[CHUNK:2 * CHUNK] = rng.integers(0, num_rows)
    elif pattern == "long":
        idx = np.full((n,), rng.integers(0, num_rows))
    elif pattern == "ends":
        idx = rng.choice(np.array([0, num_rows - 1]), size=(n,))
    else:
        raise ValueError(pattern)
    return idx.astype(np.int32)


def _inputs(C, seed=0, n=N, pattern="random"):
    rng = np.random.default_rng(seed)
    idx = _index_pattern(pattern, rng, n)
    table = rng.normal(size=(R, C)).astype(np.float32)
    val = rng.normal(size=(n, C)).astype(np.float32)
    return idx, table, val


# each width on random indices (ids "64", "192") and on the clustered and
# edge streams
_PALLAS_CASES = [pytest.param(C, p, id=str(C) if p == "random" else f"{C}-{p}")
                 for C in (64, 192)
                 for p in ("random", "runs", "chunk", "ends")]


@pytest.mark.parametrize("C,pattern", _PALLAS_CASES)
def test_plain_gather_matches_pallas_gather(C, pattern):
    idx, table, _ = _inputs(C, pattern=pattern)
    gather = _pallas_probe().make_gather(R, C, CHUNK, interpret=True)
    want = np.asarray(gather(idx, table))
    got = K.row_gather(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("C,pattern", _PALLAS_CASES)
def test_plain_scatter_add_matches_pallas_scatter_add(C, pattern):
    idx, _, val = _inputs(C, seed=1, pattern=pattern)
    scatter = _pallas_probe().make_scatter_add(R, C, CHUNK, interpret=True)
    want = np.asarray(scatter(idx, val))
    got = K.row_scatter_add(torch.from_numpy(idx), torch.from_numpy(val), R)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("C", [8, 5])
def test_plain_bf16_gather_matches_jnp_take(C):
    """K1 on bf16 rows (the corner-packed baked grid has C = 8) copies the
    bits: equal to ``jnp.take`` on the same bf16 table."""
    import jax.numpy as jnp
    idx, table, _ = _inputs(C, seed=4)
    jtab = jnp.asarray(table, jnp.bfloat16)
    want = np.asarray(jnp.take(jtab, jnp.asarray(idx), axis=0))
    ttab = torch.from_numpy(np.asarray(jtab).view(np.uint16).astype(
        np.int16)).view(torch.bfloat16)
    got = K.row_gather(ttab, torch.from_numpy(idx))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.uint16).astype(np.int16))
    with pytest.raises(ValueError):     # K2 takes f32 only
        K.gather_rows(ttab.requires_grad_(True),
                      torch.from_numpy(idx)).float().sum().backward()


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
    K.row_gather(table.to(torch.bfloat16), idx)
    K.row_scatter_add(idx, torch.from_numpy(val_np), R)
    assert K.LAUNCHES == {"row_gather": 0, "row_gather_bf16": 0,
                          "row_scatter_add": 0, "line_taps": 0}
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
@pytest.mark.parametrize("C", [3, 8, 64, 192])
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
        assert K.LAUNCHES == {"row_gather": 1, "row_gather_bf16": 0,
                              "row_scatter_add": 1, "line_taps": 0}


def _misaligned(a, dev, dtype, misaligned):
    """``a`` on the card, contiguous, one element past a 16-byte boundary
    when ``misaligned`` (the kernels' scalar routes)."""
    flat = torch.zeros(a.size + 1, device=dev, dtype=dtype)
    view = flat[1:] if misaligned else flat[:-1]
    view.copy_(torch.from_numpy(a.reshape(-1)).to(dev, dtype))
    return view.view(a.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [3, 8, 64, 192])
@pytest.mark.parametrize("n,pattern,misaligned", [
    (0, "random", False), (1, "random", False), (31, "random", False),
    (257, "runs", False), (5000, "runs", False), (5000, "chunk", False),
    (5000, "long", False), (5000, "ends", False), (5000, "runs", True)])
def test_cuda_kernels_at_their_edges(C, n, pattern, misaligned):
    """Run on the card, as above. Both kernels (K1 on f32 and bf16 rows)
    at lengths that are not a multiple of a block's rows, on clustered
    streams (runs within and across chunks, the first and last row), with
    int32 and int64 indices, and on tables and values off 16-byte alignment:
    K1 exactly, K2 within the reordering of f32 sums (1e-5 relative, and
    1e-5 absolute per term of the longest sum)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    idx_np, table_np, val_np = _inputs(C, seed=6, n=n, pattern=pattern)
    dev = torch.device("cuda")
    val = _misaligned(val_np, dev, torch.float32, misaligned)
    n_max = int(np.bincount(idx_np, minlength=R).max()) if n else 0
    for dtype in (torch.int32, torch.int64):
        idx = torch.from_numpy(idx_np).to(dev, dtype)
        for tdt in (torch.float32, torch.bfloat16):
            table = _misaligned(table_np, dev, tdt, misaligned)
            got = K.row_gather(table, idx)
            torch.cuda.synchronize()
            assert torch.equal(got, K.row_gather_plain(table, idx))
        got = K.row_scatter_add(idx, val, R)
        torch.testing.assert_close(got, K.row_scatter_add_plain(idx, val, R),
                                   rtol=1e-5, atol=1e-5 * max(n_max, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [8, 3])
def test_cuda_bf16_gather_matches_plain_version(C):
    """Run on the card, as above. K1 on bf16 rows, exactly: 16-byte rows
    (C = 8) take the vector route, others the per-element one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    idx_np, table_np, _ = _inputs(C, seed=5, n=5000)
    dev = torch.device("cuda")
    table = torch.from_numpy(table_np).to(dev, torch.bfloat16)
    for dtype in (torch.int32, torch.int64):
        idx = torch.from_numpy(idx_np).to(dev, dtype)
        K.reset_launch_counts()
        got = K.row_gather(table, idx)
        torch.cuda.synchronize()
        assert torch.equal(got, K.row_gather_plain(table, idx))
        assert K.LAUNCHES == {"row_gather": 0, "row_gather_bf16": 1,
                              "row_scatter_add": 0, "line_taps": 0}
