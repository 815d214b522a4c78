"""The port's secondary pass and rendering equation against the JAX
package's, on the CPU: the baked sigma grid, ``compute_radiance`` and
``secondary_shading_tiled`` on the baked and on the exact march, and
``render_with_brdf`` with its gradients.

Tolerances, f32 on the CPU:
- the bf16 bake: 1 bf16 ulp against JAX's eager bake. The two sum the
  three einsums in their own orders, so a node near a rounding boundary of
  bf16 could round to its neighbour (none does at this size); the f32
  bake matches at 1e-5 relative. JAX's own jitted bake, which its step
  runs, folds the mask into a few more nodes than its eager bake: XLA
  fuses the mask's resampling, and nodes on the mask's edge get 0 where
  the eager bake and the port get a residue of 5e-7;
- the march, given the same bf16 grid: visibility and indirect light
  2e-5 relative and 2e-6 absolute (transmittance products and composited
  colours of the same inputs, summed in another order);
- the march where each package bakes its own grid (JAX inside jit):
  1e-3 relative and 1e-4 absolute. The mask-edge nodes above carry a
  density of at most softplus(f - 10) ~ 1e-4 in the port and 0 in JAX; a
  few pairs in a hundred move by up to 6e-4;
- ``render_with_brdf``: the colour and its gradients as the march they
  read on the baked march; on the exact march the colour as the march and
  gradients 1e-4 relative and 1e-5 absolute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoir_tpu.models import field as JF
from tensoir_tpu.models import lifecycle as JLC
from tensoir_tpu.render.brdf_render import render_with_brdf as _j_brdf
from tensoir_tpu.render.secondary import compute_radiance as _j_radiance
from tensoir_tpu.render.secondary import \
    secondary_shading_tiled as _j_tiled

from tensoir_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from tensoir_tpu_torch.models import field as TF
from tensoir_tpu_torch.render import secondary as TSec
from tensoir_tpu_torch.render.brdf_render import render_with_brdf as t_brdf

from torch_parity import (jax_field, port_cfg, port_field, small_cfg,
                          split_knobs, t, tiled_knobs)

MARCH = dict(rtol=2e-5, atol=2e-6)
OWN_BAKE = dict(rtol=1e-3, atol=1e-4)
GRID = (24, 20, 16)
N_SAMPLE = 16
SEC = dict(n_sample=N_SAMPLE, vis_near=0.05, vis_far=1.5)


@pytest.fixture(scope="module")
def masked():
    jcfg = small_cfg(envmap_h=4, envmap_w=8)
    jp, js = jax_field(jcfg)
    js, _ = JLC.update_alpha_mask(jcfg, jp, js, GRID)
    return jcfg, jp, js


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pairs(n, seed):
    """Surface points around the blob's shell and unit directions."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pts = d * rng.uniform(0.2, 0.7, size=(n, 1))
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return pts.astype(np.float32), dirs.astype(np.float32)


def _bf16_ulp(x):
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


def test_baked_grid_matches_jax_within_one_bf16_ulp(masked):
    jcfg, jp, js = masked
    tp, ts = port_field(jp, js)
    tcfg = port_cfg(jcfg)
    j32 = np.asarray(JF.bake_packed_sigma_grid(jcfg, jp, js,
                                               dtype=jnp.float32))
    t32 = TF.bake_packed_sigma_grid(tcfg, tp, ts, dtype=torch.float32)
    np.testing.assert_allclose(_np(t32), j32, rtol=1e-5, atol=1e-5)
    assert (j32 == -1e4).any() and (j32 > -1e4).any()  # mask folded in

    want = np.asarray(JF.bake_packed_sigma_grid(jcfg, jp, js), np.float32)
    got = TF.bake_packed_sigma_grid(tcfg, tp, ts)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    got = got.float().numpy()
    diff = np.abs(got - want)
    n_diff = int((diff > 0).sum())
    assert (diff <= _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))).all(), \
        f"{n_diff} of {want.size} entries differ, some by more than 1 ulp"
    print(f"bf16 bake: {n_diff} of {want.size} entries differ by 1 ulp")

    # JAX's jitted bake differs only where it folds the mask into an edge
    # node that the port keeps, and such a node has next to no density
    jit = np.asarray(jax.jit(JF.bake_packed_sigma_grid, static_argnums=0)(
        jcfg, jp, js), np.float32)
    edge = np.abs(got - jit) > _bf16_ulp(np.abs(jit))
    assert edge.sum() < want.size // 100
    assert (jit[edge] == -9984.0).all()
    assert (np.log1p(np.exp(got[edge] + jcfg.density_shift)) < 2e-4).all()


_j_rad = jax.jit(_j_radiance, static_argnums=0,
                 static_argnames=("n_sample", "vis_near", "vis_far",
                                  "app_cap", "app_pair_cap", "march_cap"))


@pytest.mark.parametrize("branch,pair_cap", [
    ("baked", 48), ("baked", 0), ("exact", 48), ("exact_culled", 48)])
def test_compute_radiance_matches_jax(masked, branch, pair_cap):
    jcfg, jp, js = masked
    tp, ts = port_field(jp, js)
    n = 256
    pts, dirs = _pairs(n, seed=1)
    lidx = np.zeros((n,), np.int32)
    ok = np.random.default_rng(2).uniform(size=n) > 0.2
    kw = dict(app_cap=8, app_pair_cap=pair_cap,
              march_cap=6 if branch == "exact_culled" else 0, **SEC)
    jbaked = tbaked = None
    if branch == "baked":
        # the same bf16 grid for both packages
        jbaked = JF.bake_packed_sigma_grid(jcfg, jp, js)
        tbaked = port_field({}, {"b": jbaked})[1]["b"]
    jout = _j_rad(jcfg, jp, js, jnp.asarray(pts), jnp.asarray(dirs),
                  jnp.asarray(lidx), baked=jbaked, pair_ok=jnp.asarray(ok),
                  **kw)
    reset_launch_counts()
    tout = TSec.compute_radiance(port_cfg(jcfg), tp, ts, t(pts), t(dirs),
                                 t(lidx, torch.int32), baked=tbaked,
                                 pair_ok=torch.from_numpy(ok), **kw)
    assert LAUNCHES["row_gather_bf16"] == 0      # the CPU runs no kernel
    for name, a, b in zip(("nerv", "nerfactor", "indirect"), tout, jout):
        np.testing.assert_allclose(_np(a), np.asarray(b), err_msg=name,
                                   **MARCH)
    vis = np.asarray(jout[0])
    assert (vis < 0.5).any() and (vis > 0.5).any()     # shadowed and lit
    # more pairs pick up weight than the pair cap lets through
    lit = (np.asarray(jout[2]).sum(-1) > 0).sum()
    assert lit == 48 if pair_cap else lit > 48


_j_sec = jax.jit(_j_tiled, static_argnums=0,
                 static_argnames=("n_sample", "vis_near", "vis_far", "tile",
                                  "app_cap", "march_cap", "use_baked"))


@pytest.mark.parametrize("use_baked", [True, False])
def test_secondary_shading_tiled_matches_jax(masked, use_baked):
    jcfg, jp, js = masked
    tp, ts = port_field(jp, js)
    P, L = 20, 32
    pts, _ = _pairs(P, seed=3)
    _, dirs = _pairs(P * L, seed=4)
    dirs = dirs.reshape(P, L, 3)
    lidx = np.zeros((P,), np.int32)
    mask = np.random.default_rng(5).uniform(size=(P, L)) > 0.4
    kw = dict(tile=256, app_cap=8, march_cap=6, use_baked=use_baked, **SEC)
    jvis, jind = _j_sec(jcfg, jp, js, jnp.asarray(pts), jnp.asarray(dirs),
                        jnp.asarray(lidx), jnp.asarray(mask), **kw)
    TSec.reset_march_counts()
    tvis, tind = TSec.secondary_shading_tiled(
        port_cfg(jcfg), tp, ts, t(pts), t(dirs), t(lidx, torch.int32),
        torch.from_numpy(mask), tiled_knobs(**kw))
    # 640 pairs in three tiles of 256, the last one padded
    assert TSec.MARCHED == {"pairs": P * L, "tiles": 3, "skipped": 0}
    assert tvis.shape == (P, L, 1) and tind.shape == (P, L, 3)
    tol = OWN_BAKE if use_baked else MARCH   # each package bakes its own
    np.testing.assert_allclose(_np(tvis), np.asarray(jvis), **tol)
    np.testing.assert_allclose(_np(tind), np.asarray(jind), **tol)
    assert not np.asarray(jvis)[~mask].any()


_j_knobs = jax.jit(_j_tiled, static_argnums=0,
                   static_argnames=("n_sample", "vis_near", "vis_far",
                                    "tile", "app_cap", "window",
                                    "window_back", "prepass_n",
                                    "march_group", "app_hoist"))


@pytest.mark.parametrize("kw", [dict(march_group=2), dict(app_hoist=True)],
                         ids=["march_group", "app_hoist"])
def test_secondary_knobs_not_ported_raise(masked, kw):
    """The grouped march and the global app stage, once refused here, run
    and match JAX's (tests/test_torch_grouped_march.py holds them in
    detail): on the window march, each package baking its own tables."""
    jcfg, jp, js = masked
    tp, ts = port_field(jp, js)
    P, L = 12, 16
    pts, _ = _pairs(P, seed=12)
    _, dirs = _pairs(P * L, seed=13)
    dirs = dirs.reshape(P, L, 3)
    lidx = np.zeros((P,), np.int32)
    mask = np.random.default_rng(14).uniform(size=(P, L)) > 0.3
    knobs = dict(tile=64, app_cap=6, window=12, window_back=4, prepass_n=8,
                 **SEC, **kw)
    jvis, jind = _j_knobs(jcfg, jp, js, jnp.asarray(pts), jnp.asarray(dirs),
                          jnp.asarray(lidx), jnp.asarray(mask), **knobs)
    tvis, tind = TSec.secondary_shading_tiled(
        port_cfg(jcfg), tp, ts, t(pts), t(dirs), t(lidx, torch.int32),
        torch.from_numpy(mask), tiled_knobs(**knobs))
    np.testing.assert_allclose(_np(tvis), np.asarray(jvis), **OWN_BAKE)
    np.testing.assert_allclose(_np(tind), np.asarray(jind), **OWN_BAKE)
    assert np.asarray(jvis)[mask].min() < 0.5 < np.asarray(jvis)[mask].max()


_j_render_brdf = jax.jit(
    _j_brdf, static_argnums=0,
    static_argnames=("sample_method", "second_n_sample", "secondary_tile",
                     "second_march_cap", "second_app_cap",
                     "secondary_use_baked"))


@pytest.mark.parametrize("use_baked", [True, False])
def test_render_with_brdf_matches_jax_with_gradients(masked, use_baked):
    jcfg, jp, js = masked
    tp, ts = port_field(jp, js)
    P = 16
    rng = np.random.default_rng(6)
    pts, _ = _pairs(P, seed=7)
    o = np.zeros((P, 3), np.float32)
    o[:, 2] = -4.0
    d = pts - o
    depth = np.linalg.norm(d, axis=-1).astype(np.float32)
    rays = np.concatenate([o, d / depth[:, None]], -1).astype(np.float32)
    normal = (pts / np.linalg.norm(pts, axis=-1, keepdims=True)
              + rng.normal(size=(P, 3)) * 0.2).astype(np.float32)
    albedo = rng.uniform(0.1, 0.9, (P, 3)).astype(np.float32)
    rough = rng.uniform(0.1, 0.9, (P, 1)).astype(np.float32)
    fres = np.full((P, 3), 0.04, np.float32)
    lidx = np.zeros((P,), np.int32)
    up = rng.normal(size=(P, 3)).astype(np.float32)
    kw = dict(sample_method="stratified_sampling", key=None,
              second_n_sample=N_SAMPLE, secondary_tile=256,
              second_march_cap=6, second_app_cap=8,
              secondary_use_baked=use_baked)

    def j_loss(nrm, alb, rgh, sgs):
        p = dict(jp, lgt_sgs=sgs)
        return jnp.sum(_j_render_brdf(jcfg, p, js, jnp.asarray(depth), nrm,
                                      alb, rgh, jnp.asarray(fres),
                                      jnp.asarray(rays), jnp.asarray(lidx),
                                      **kw) * up)

    want = _j_render_brdf(jcfg, jp, js, jnp.asarray(depth), normal, albedo,
                          rough, jnp.asarray(fres), jnp.asarray(rays),
                          jnp.asarray(lidx), **kw)
    jg = jax.grad(j_loss, argnums=(0, 1, 2, 3))(normal, albedo, rough,
                                                jp["lgt_sgs"])
    leaves = [t(x).requires_grad_(True)
              for x in (normal, albedo, rough, np.asarray(jp["lgt_sgs"]))]
    tp = dict(tp, lgt_sgs=leaves[3])
    rest, sec = split_knobs(kw)
    got = t_brdf(port_cfg(jcfg), tp, ts, t(depth), leaves[0], leaves[1],
                 leaves[2], t(fres), t(rays), t(lidx, torch.int32), **rest,
                 secondary=sec)
    np.testing.assert_allclose(_np(got), np.asarray(want),
                               **(OWN_BAKE if use_baked else MARCH))
    w = np.asarray(want)
    assert (w > 0.05).any() and (w < 0.999).all()
    (got * t(up)).sum().backward()
    for name, leaf, g in zip(("normal", "albedo", "roughness", "lgt_sgs"),
                             leaves, jg):
        assert np.abs(np.asarray(g)).max() > 0, name
        np.testing.assert_allclose(
            _np(leaf.grad), np.asarray(g), err_msg=name,
            **(OWN_BAKE if use_baked else dict(rtol=1e-4, atol=1e-5)))
