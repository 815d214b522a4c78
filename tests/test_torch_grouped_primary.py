"""The port's grouped primary march against the JAX package's, on the CPU:
the 16-corner block-row plane lookup with its first and second
derivatives, ``density_feature_grouped``, ``render_rays`` with
``march_group`` (VM, the stacked TensorVM, bf16 compute, and CP, which
keeps the per-sample density on the grouped selection) with its
gradients, the contract's refusals, and the loop's downgrade chain.

Tolerances, f32 on the CPU:
- forward values against JAX: 1e-5 relative (2e-6 absolute: the block
  contraction and the products sum in another order);
- gradients against JAX: 1e-4 relative (1e-6 absolute), the second
  derivatives too;
- the JAX identities (tests/test_grouped_primary.py) at JAX's
  tolerances: the grouped lookup, density and march equal the per-sample
  ones to 1e-5 absolute (1e-5, resp. 1e-4 relative); bf16 compute
  against JAX's bf16: 1e-3 relative (its products round to bf16 in
  either package, a few of the 2^-8 roundings may fall apart).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoir_tpu.config import TensoIRConfig as JConfig
from tensoir_tpu.models import field as JF
from tensoir_tpu.ops import interp as JI
from tensoir_tpu.render import primary as JP
from tensoir_tpu.train.loop import resolve_primary_march_group as j_resolve

from tensoir_tpu_torch.config import TensoIRConfig as TConfig
from tensoir_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from tensoir_tpu_torch.models import field as TF
from tensoir_tpu_torch.ops import interp as TI
from tensoir_tpu_torch.render.primary import render_rays as t_render_rays
from tensoir_tpu_torch.train.loop import resolve_primary_march_group as \
    t_resolve

from torch_parity import (masked_jax_field, one_torch_thread,  # noqa: F401
                          port_cfg, port_field, t)

GRID = (24, 24, 24)
PORT = dict(rtol=1e-5, atol=2e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)


def _group_points(n, g, hw, seed, lo=-1.1, hi=1.1, span=1.5):
    """[n, g, 2] points of groups within ``span`` cells of a random base
    on an [H, W] plane, borders included."""
    H, W = hw
    rng = np.random.default_rng(seed)
    base = rng.uniform(lo, hi, size=(n, 1, 2))
    cell = np.array([2.0 / (W - 1), 2.0 / (H - 1)])
    off = rng.uniform(0.0, span, size=(n, g, 2)) * cell
    return (base + off).astype(np.float32)


@pytest.mark.parametrize("g", [2, 4])
def test_group_packed_plane_matches_jax_and_per_sample(g):
    plane = np.random.default_rng(0).normal(size=(17, 13, 5)).astype(
        np.float32)
    pts = _group_points(64, g, (17, 13), seed=g)
    x, y = pts[..., 0], pts[..., 1]
    want = np.asarray(JI.bilerp_plane_group_packed(jnp.asarray(plane), x, y))
    reset_launch_counts()
    got = TI.bilerp_plane_group_packed(t(plane), t(x), t(y))
    assert LAUNCHES["row_gather"] == 0           # the CPU runs no kernel
    np.testing.assert_allclose(got.numpy(), want, **PORT)
    single = TI.bilerp_plane_packed(t(plane), t(x), t(y))
    np.testing.assert_allclose(got.numpy(), single.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_group_packed_plane_first_and_second_derivatives_match_jax():
    """The plane's and the coordinates' gradients, and the plane's
    gradient of the squared coordinate gradient (a double backward, as the
    derived normals take), against JAX's."""
    rng = np.random.default_rng(1)
    plane = rng.normal(size=(9, 9, 3)).astype(np.float32)
    pts = _group_points(16, 4, (9, 9), seed=1, lo=-0.9, hi=0.9, span=1.4)

    def j_f(p, c):
        return jnp.sum(jnp.sin(JI.bilerp_plane_group_packed(
            p, c[..., 0], c[..., 1])))

    j_gp, j_gc = jax.grad(j_f, argnums=(0, 1))(jnp.asarray(plane),
                                                jnp.asarray(pts))
    j_gg = jax.grad(lambda p, c: jnp.sum(jax.grad(j_f, 1)(p, c) ** 2))(
        jnp.asarray(plane), jnp.asarray(pts))

    tp = t(plane).requires_grad_(True)
    tc = t(pts).requires_grad_(True)
    f = torch.sin(TI.bilerp_plane_group_packed(tp, tc[..., 0],
                                               tc[..., 1])).sum()
    gp, gc = torch.autograd.grad(f, (tp, tc), create_graph=True)
    (gg,) = torch.autograd.grad((gc ** 2).sum(), tp)
    np.testing.assert_allclose(gp.detach().numpy(), np.asarray(j_gp), **GRAD)
    np.testing.assert_allclose(gc.detach().numpy(), np.asarray(j_gc), **GRAD)
    np.testing.assert_allclose(gg.numpy(), np.asarray(j_gg), **GRAD)
    assert np.abs(np.asarray(j_gg)).max() > 1e-3


@pytest.mark.parametrize("decomp", ["vm", "vm_stacked"])
def test_density_feature_grouped_matches_jax(decomp):
    jcfg, jp, _ = masked_jax_field(grid=GRID, decomp=decomp)
    tp, _ = port_field(jp, {})
    rng = np.random.default_rng(2)
    base = rng.uniform(-0.95, 0.95, size=(32, 1, 3)).astype(np.float32)
    d = rng.normal(size=(32, 1, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    # 4 consecutive samples half a cell apart along a ray
    tt = np.arange(4, dtype=np.float32).reshape(1, 4, 1) * 0.5 * (2.0 / 23)
    coords = np.clip(base + d * tt, -1.2, 1.2).astype(np.float32)
    want = np.asarray(JF.density_feature_grouped(jcfg, jp,
                                                 jnp.asarray(coords)))
    tcfg = port_cfg(jcfg)
    got = TF.density_feature_grouped(tcfg, tp, t(coords))
    np.testing.assert_allclose(got.numpy(), want, **PORT)
    plain = TF.density_feature(tcfg, tp, t(coords))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5,
                               rtol=1e-5)
    with pytest.raises(ValueError, match="no grouped density"):
        TF.density_feature_grouped(dataclasses.replace(tcfg, decomp="cp"),
                                   tp, t(coords))


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = np.zeros((n, 3), np.float32)
    o[:, 2] = -4.0
    d = rng.normal(size=(n, 3)).astype(np.float32) * 0.1
    d[:, 2] = 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([o, d], -1)


_j_render = jax.jit(JP.render_rays, static_argnums=0,
                    static_argnames=("n_samples", "is_train", "is_relight",
                                     "white_bg", "app_cap", "march_cap",
                                     "march_group"))
KEYS = ("rgb_map", "depth_map", "acc_map", "albedo_map", "normal_map",
        "march_overflow_frac")


@pytest.mark.parametrize("decomp,g,dtype", [
    ("vm", 2, "float32"), ("vm", 4, "float32"), ("vm_stacked", 4, "float32"),
    ("cp", 4, "float32"), ("vm", 4, "bfloat16")])
def test_render_rays_grouped_matches_jax_and_ungrouped(decomp, g, dtype,
                                                       one_torch_thread):
    jcfg, jp, js = masked_jax_field(grid=GRID, decomp=decomp,
                                    compute_dtype=dtype)
    tp, ts = port_field(jp, js)
    rays = _rays(16, seed=3)
    lidx = np.zeros(16, np.int32)
    # n_samples not divisible by 4: the group padding and its clip; a cap
    # generous enough that the grouped selection never overflows
    kw = dict(n_samples=70, is_train=False, is_relight=True, white_bg=True,
              app_cap=0, march_cap=64)
    # CP against JAX's eager march: its jitted one moves depth by 1.4e-3
    # here with or without groups (XLA's rewrites of the line products;
    # the port follows eager JAX, ROADMAP section 3)
    j_render = JP.render_rays if decomp == "cp" else _j_render
    jout = j_render(jcfg, jp, js, jnp.asarray(rays), jnp.asarray(lidx),
                    key=None, march_group=g, **kw)
    reset_launch_counts()
    args = (port_cfg(jcfg), tp, ts, t(rays), t(lidx, torch.int32))
    tout = t_render_rays(*args, key=None, march_group=g, **kw)
    plain = t_render_rays(*args, key=None, **kw)
    tol = PORT if dtype == "float32" else dict(rtol=1e-3, atol=1e-5)
    for k in KEYS:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   err_msg=k, **tol)
        np.testing.assert_allclose(tout[k].numpy(), plain[k].numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=k)
    assert float(tout["march_overflow_frac"]) == 0.0
    acc = np.asarray(jout["acc_map"])
    assert (acc > 0.5).any() and (acc < 0.5).any()


def test_render_rays_grouped_gradients_match_jax(one_torch_thread):
    """Parameter gradients through the grouped march (the block rows'
    scatter) against JAX's, and against the per-sample march's."""
    jcfg, jp, js = masked_jax_field(grid=GRID)
    rays = _rays(8, seed=4)
    lidx = np.zeros(8, np.int32)
    kw = dict(n_samples=64, is_train=False, is_relight=False, white_bg=True,
              app_cap=0, march_cap=48)

    def j_loss(p):
        out = JP.render_rays(jcfg, p, js, jnp.asarray(rays),
                             jnp.asarray(lidx), key=None, march_group=4,
                             **kw)
        return jnp.sum(out["rgb_map"] ** 2) + jnp.sum(out["depth_map"])

    j_grads = jax.jit(jax.grad(j_loss))(jp)
    tcfg = port_cfg(jcfg)

    def t_grads(group):
        tp, ts = port_field(jp, js)
        leaves = {k: v.requires_grad_(True) for k, v in tp.items()
                  if isinstance(v, torch.Tensor)}
        out = t_render_rays(tcfg, tp, ts, t(rays), t(lidx, torch.int32),
                            key=None, march_group=group, **kw)
        loss = (out["rgb_map"] ** 2).sum() + out["depth_map"].sum()
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names],
                                    allow_unused=True)
        return {k: (np.zeros(leaves[k].shape, np.float32) if g is None
                    else g.numpy()) for k, g in zip(names, grads)}

    grouped, plain = t_grads(4), t_grads(0)
    for k, g in grouped.items():
        np.testing.assert_allclose(g, np.asarray(j_grads[k]), err_msg=k,
                                   **GRAD)
        np.testing.assert_allclose(g, plain[k], atol=1e-5, rtol=1e-4,
                                   err_msg=k)
    assert np.abs(grouped["density_plane_0"]).max() > 1e-3


@pytest.mark.parametrize("change,kw", [
    (dict(step_ratio=2.0), dict(march_cap=16, march_group=4)),
    ({}, dict(march_cap=18, march_group=4)),
    ({}, dict(march_cap=16, march_group=2, ndc_ray=True))],
    ids=["block_contract", "cap_divisible", "ndc"])
def test_march_group_contract_refusals_match_jax(change, kw):
    jcfg, jp, js = masked_jax_field(grid=GRID)
    jcfg = dataclasses.replace(jcfg, **change)
    tp, ts = port_field(jp, js)
    rays = np.zeros((4, 6), np.float32)
    rays[:, 5] = 1.0
    lidx = np.zeros(4, np.int32)
    with pytest.raises(ValueError) as want:
        JP.render_rays(jcfg, jp, js, jnp.asarray(rays), jnp.asarray(lidx),
                       n_samples=32, key=None, is_relight=False, **kw)
    with pytest.raises(ValueError) as got:
        t_render_rays(port_cfg(jcfg), tp, ts, t(rays), t(lidx, torch.int32),
                      n_samples=32, key=None, is_relight=False, **kw)
    assert str(got.value) == str(want.value)


def test_resolve_primary_march_group_downgrades(capsys):
    iso = np.array([[-1.5] * 3, [1.5] * 3], np.float32)
    aniso = np.array([[-0.6, -1.5, -1.5], [0.6, 1.5, 1.5]], np.float32)
    grid = (200, 200, 200)
    cases = [(dict(march_group=4, march_cap_primary=192), iso, 0.5, 4),
             (dict(march_group=4, march_cap_primary=192), aniso, 0.5, 2),
             (dict(march_group=4, march_cap_primary=192), iso, 2.0, 0),
             (dict(march_group=4, march_cap_primary=190), iso, 0.5, 2),
             (dict(march_group=2, march_cap_primary=0), iso, 0.5, 0),
             (dict(march_group=0), iso, 0.5, 0)]
    for kw, aabb, step_ratio, want in cases:
        assert j_resolve(JConfig(**kw), aabb, grid, step_ratio) == want
        j_out = capsys.readouterr().out
        assert t_resolve(TConfig(**kw), aabb, grid, step_ratio) == want
        assert capsys.readouterr().out == j_out
