"""The port's fast-knob secondary pass (``bench.py``'s step) against the JAX
package's, on the CPU: the factor resizes, the resized sigma bake, the
coarse occupancy and its contract, the baked appearance grid, the window
march, ``compute_radiance`` and ``secondary_shading_tiled`` with their
statistics, and one training step at ``bench.py``'s CPU sizes.

Tolerances, f32 on the CPU:
- the resizes: 1e-6 relative (1e-7 absolute). JAX, under ``jit``, sums
  the four weighted corners with fused multiply-adds; the port rounds each
  product;
- the resized sigma bake: f32 1e-5 relative and absolute, bf16 1 bf16 ulp,
  against JAX's eager bake (as ``test_torch_secondary.py`` holds the full
  bake); the appearance bake: f32 1e-5, bf16 1 ulp; ``app_feature_baked``
  on the same bf16 table 1e-5 relative and 1e-6 absolute;
- the coarse occupancy, its lookup and the contract's ratio: exact;
- the window march, given the same bf16 bake and coarse grid: the sample
  indices jj and the marched mask m equal bit for bit (shown by the
  coordinates, which a shift of one sample moves by over 1e-3, and by the
  marched set, read through a density that is 1 wherever it is marched);
  the coordinates 1e-6 absolute and the density 1e-4 relative, 1e-5
  absolute. XLA contracts multiply-adds into FMAs and folds vis_far * (jj
  / 95) into jj * f32(vis_far / 95) inside ``jit``, so JAX's positions
  differ from its own 96-sample grid by an ulp; the port's positions are
  that grid's, bit for bit (the full march's coordinates at jj);
- ``compute_radiance`` on the same tables: visibility and indirect light
  2e-5 relative, 2e-6 absolute; its counts exact, the probe's weights 1e-5
  relative;
- ``secondary_shading_tiled``, each package baking its own tables (JAX
  inside ``jit``): visibility and indirect light 1e-3 relative and 1e-4
  absolute, as in ``test_torch_secondary.py``; the statistics 1e-5
  relative, because no pair here sits at the weight threshold (a pair that
  did would move a count by one);
- the step at ``bench.py``'s CPU sizes: total loss 1e-4 relative, each
  parameter's gradient 1e-3 relative in the L2 norm (sums over every
  sample of the double backward), the ``sec/*`` metrics 1e-5 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoir_tpu.models import field as JF
from tensoir_tpu.models import lifecycle as JLC
from tensoir_tpu.ops import interp as JI
from tensoir_tpu.render import secondary as JSec
from tensoir_tpu.train import optim as JO
from tensoir_tpu.train import step as JS
from tensoir_tpu.utils.bench_scene import bench_rays, seed_solid_blob

from tensoir_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from tensoir_tpu_torch.models import field as TF
from tensoir_tpu_torch.ops import interp as TI
from tensoir_tpu_torch.ops.rays import sample_ray_equally
from tensoir_tpu_torch.render import secondary as TSec
from tensoir_tpu_torch.train import optim as TO
from tensoir_tpu_torch.train import step as TS

from torch_parity import (AABB, jax_field, port_cfg, port_field, small_cfg,
                          t, tiled_knobs, to_numpy)

GRID = (24, 20, 16)
SEC = dict(n_sample=16, vis_near=0.05, vis_far=1.5)
WIN = dict(window=12, prepass_n=8)
MARCH = dict(rtol=2e-5, atol=2e-6)
OWN_BAKE = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(scope="module")
def masked():
    """A small field with two lights, masked by JAX's update_alpha_mask."""
    jcfg = small_cfg(envmap_h=4, envmap_w=8, light_num=2)
    jp, js = jax_field(jcfg)
    js, _ = JLC.update_alpha_mask(jcfg, jp, js, GRID)
    return jcfg, jp, js


@pytest.fixture(scope="module")
def tables(masked):
    """The bf16 sigma bake at max_reso 12, its coarse occupancy (dilate 2,
    reso 8) and the bf16 app bake at max_reso 10, made by JAX."""
    jcfg, jp, js = masked
    baked = JF.bake_packed_sigma_grid(jcfg, jp, js, max_reso=12)
    coarse = JF.bake_coarse_occupancy(baked, reso=8, dilate=2)
    app = JF.bake_app_feature_grid(jcfg, jp, js, max_reso=10)
    return baked, coarse, app


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bf16(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def _bf16_ulp(x):
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


def _assert_within_one_bf16_ulp(got: torch.Tensor, want) -> None:
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert (diff <= _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))).all(), \
        f"{int((diff > 0).sum())} of {want.size} differ, some by over 1 ulp"


def _pairs(n, seed, radius=(0.2, 0.9)):
    """Points inside the blob's shell and unit directions."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pts = d * rng.uniform(*radius, size=(n, 1))
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return pts.astype(np.float32), dirs.astype(np.float32)


# ------------------------------------------------------------ resizes, bakes

@pytest.mark.parametrize("out_hw", [(12, 9), (31, 7), (1, 5)])
def test_resizes_match_jax(out_hw):
    rng = np.random.default_rng(0)
    plane = rng.normal(size=(20, 24, 6)).astype(np.float32)
    line = rng.normal(size=(24, 6)).astype(np.float32)
    want = jax.jit(JI.resize_bilinear_align_corners,
                   static_argnums=1)(plane, out_hw)
    got = TI.resize_bilinear_align_corners(t(plane), out_hw)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    want = jax.jit(JI.resize_line_align_corners,
                   static_argnums=1)(line, out_hw[0])
    got = TI.resize_line_align_corners(t(line), out_hw[0])
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("max_reso", [12, 18])
def test_resized_bake_matches_jax(masked, max_reso):
    jcfg, jp, js = masked
    tp, ts = port_field(jp, js)
    tcfg = port_cfg(jcfg)
    j32 = np.asarray(JF.bake_packed_sigma_grid(jcfg, jp, js,
                                               dtype=jnp.float32,
                                               max_reso=max_reso))
    t32 = TF.bake_packed_sigma_grid(tcfg, tp, ts, dtype=torch.float32,
                                    max_reso=max_reso)
    # every axis at most max_reso nodes, the mask resampled onto them
    assert t32.shape == tuple(min(n, max_reso) - 1 for n in GRID[::-1]) + (8,)
    np.testing.assert_allclose(_np(t32), j32, rtol=1e-5, atol=1e-5)
    assert (j32 == -1e4).any() and (j32 > -1e4).any()
    _assert_within_one_bf16_ulp(
        TF.bake_packed_sigma_grid(tcfg, tp, ts, max_reso=max_reso),
        JF.bake_packed_sigma_grid(jcfg, jp, js, max_reso=max_reso))


@pytest.mark.parametrize("dilate", [0, 2, 3])
def test_coarse_occupancy_and_lookup_match_jax(tables, dilate):
    baked = tables[0]
    want = np.asarray(JF.bake_coarse_occupancy(baked, reso=16,
                                               dilate=dilate))
    got = TF.bake_coarse_occupancy(_bf16(baked), reso=16, dilate=dilate)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(_np(got), want)
    assert 0 < want.mean() < 1
    # the lookup, inside and past the grid's edges
    coords = np.random.default_rng(dilate).uniform(
        -1.1, 1.1, (4000, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        _np(TF.coarse_occupancy_lookup(got, baked.shape, t(coords))),
        np.asarray(JF.coarse_occupancy_lookup(jnp.asarray(want), baked.shape,
                                              coords)))


@pytest.mark.parametrize("aabb,kw", [
    (AABB, dict(prepass_n=8, dilate=3)),                  # bench.py's
    (AABB, dict(prepass_n=18, dilate=2, coarse_reso=48)),  # the defaults
    (AABB * 0.4, dict(prepass_n=12, dilate=2)),           # a shrunk box
    (AABB * 0.4, dict(prepass_n=8, dilate=3, vis_far=2.0)),
])
def test_check_march_contract_matches_jax(aabb, kw):
    try:
        want = JF.check_march_contract(aabb, **kw)
    except ValueError:
        with pytest.raises(ValueError, match="contract violated"):
            TF.check_march_contract(aabb, **kw)
        return
    assert TF.check_march_contract(aabb, **kw) == want


def test_app_bake_and_lookup_match_jax(masked, tables):
    jcfg, jp, js = masked
    tp, _ = port_field(jp, js)
    tcfg = port_cfg(jcfg)
    j32 = JF.bake_app_feature_grid(jcfg, jp, js, dtype=jnp.float32,
                                   max_reso=10)
    t32 = TF.bake_app_feature_grid(tcfg, tp, dtype=torch.float32,
                                   max_reso=10)
    cells = TF.app_bake_cells(tcfg, tp, 10)
    # two lights, 9 cells per axis (every factor longer than 10), 8
    # corners of app_dim features per row
    assert t32.shape == (2, 9 * 9 * 9, 8 * jcfg.app_dim) and cells == (9,) * 3
    np.testing.assert_allclose(_np(t32), np.asarray(j32), rtol=1e-5,
                               atol=1e-5)
    # the second light's grid is not the first's
    assert np.abs(np.asarray(j32[1] - j32[0])).max() > 1e-3
    app = tables[2]
    _assert_within_one_bf16_ulp(
        TF.bake_app_feature_grid(tcfg, tp, max_reso=10), app)

    n = 500
    rng = np.random.default_rng(3)
    coords = rng.uniform(-1.05, 1.05, (n, 6, 3)).astype(np.float32)
    lidx = rng.integers(0, 2, (n, 6)).astype(np.int32)
    want = JF.app_feature_baked(app, cells, coords, lidx)
    reset_launch_counts()
    got = TF.app_feature_baked(_bf16(app), cells, t(coords),
                               t(lidx, torch.int32))
    assert LAUNCHES["row_gather_bf16"] == 0      # the CPU runs no kernel
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------------------ window march

_j_window = jax.jit(JSec._march_window, static_argnums=0,
                    static_argnames=("n_sample", "vis_near", "vis_far",
                                     "window", "prepass_n", "window_back"))


@pytest.mark.parametrize("window_back", [0, 4])
def test_march_window_matches_jax(masked, tables, window_back):
    jcfg, _, js = masked
    baked, coarse = tables[0], tables[1]
    tcfg = port_cfg(jcfg)
    pts, dirs = _pairs(3000, seed=window_back)
    kw = dict(window_back=window_back, **WIN, **SEC)
    aabb = t(AABB)
    jco, jsig, jdist = map(np.asarray, _j_window(
        jcfg, baked, coarse, js["aabb"], pts, dirs, **kw))
    tco, tsig, tdist = TSec._march_window(
        tcfg, _bf16(baked), torch.from_numpy(np.asarray(coarse)), aabb,
        t(pts), t(dirs), **kw)
    # the same samples: a shift of one sample would move the coordinates
    # by |d| dt 2 / 3 ~ 0.01
    np.testing.assert_allclose(_np(tco), jco, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(_np(tdist), jdist)
    np.testing.assert_allclose(_np(tsig), jsig, rtol=1e-4, atol=1e-5)
    assert (jsig > 1e-2).any()

    # the marched mask, read through a density of 1 wherever it is marched
    relu = dataclasses.replace(jcfg, fea2dense="relu")
    ones = jnp.ones_like(baked)
    _, jval, _ = _j_window(relu, ones, coarse, js["aabb"], pts, dirs, **kw)
    _, tval, _ = TSec._march_window(
        port_cfg(relu), torch.ones_like(_bf16(baked)),
        torch.from_numpy(np.asarray(coarse)), aabb, t(pts), t(dirs), **kw)
    np.testing.assert_array_equal(_np(tval) > 0, np.asarray(jval) > 0)
    assert 0.05 < (np.asarray(jval) > 0).mean() < 1.0

    # the port's window samples sit on its full march's grid, bit for bit
    jj, m = TSec.window_indices(torch.from_numpy(np.asarray(coarse)),
                                baked.shape, aabb, t(pts), t(dirs),
                                n_sample=SEC["n_sample"],
                                vis_near=SEC["vis_near"],
                                vis_far=SEC["vis_far"], window=WIN["window"],
                                prepass_n=WIN["prepass_n"],
                                window_back=window_back)
    xyz, _, _ = sample_ray_equally(t(pts), t(dirs), aabb, SEC["vis_near"],
                                   SEC["vis_far"], SEC["n_sample"])
    full = TF.normalize_coord(aabb, xyz)
    on_grid = jj < SEC["n_sample"]
    at = jj.clamp(max=SEC["n_sample"] - 1).long()
    assert torch.equal(torch.gather(full, 1, at[..., None].expand(-1, -1, 3))
                       [on_grid], tco[on_grid])
    assert m.dtype == torch.bool and jj.dtype == torch.int32


def _j_rad(jcfg, params, scene, *args, app=None, cells=None, **kw):
    """JAX's compute_radiance under jit, with the static knobs and the app
    bake's cell counts closed over (the reference's tiled pass holds them
    as Python ints)."""
    def f(params, scene, *args, app):
        app_baked = None if app is None else (app, cells)
        return JSec.compute_radiance(jcfg, params, scene, *args,
                                     app_baked=app_baked, **kw)
    return jax.jit(f)(params, scene, *args, app=app)


@pytest.mark.parametrize("variant", ["window_app", "window", "probe"])
def test_compute_radiance_fast_knobs_match_jax(masked, tables, variant):
    jcfg, jp, js = masked
    tp, ts = port_field(jp, js)
    baked, coarse, app = tables
    n = 512
    pts, dirs = _pairs(n, seed=7)
    rng = np.random.default_rng(8)
    lidx = rng.integers(0, 2, n).astype(np.int32)
    ok = rng.uniform(size=n) > 0.2
    kw = dict(app_cap=6, app_pair_cap=96, return_stats=True, **SEC)
    jx, tx = {}, {}
    if variant == "probe":   # the probe measures the full baked march
        kw.update(probe_window=10, probe_window_back=3)
    else:
        kw.update(window_back=4 if variant == "window_app" else 0, **WIN)
        jx["coarse"] = coarse
        tx["coarse"] = torch.from_numpy(np.asarray(coarse))
    if variant == "window_app":
        cells = TF.app_bake_cells(port_cfg(jcfg), tp, 10)
        jx.update(app=app, cells=cells)
        tx["app_baked"] = (_bf16(app), cells)
    jout = _j_rad(jcfg, jp, js, pts, dirs, lidx, baked=baked,
                  pair_ok=jnp.asarray(ok), **kw, **jx)
    tout = TSec.compute_radiance(port_cfg(jcfg), tp, ts, t(pts), t(dirs),
                                 t(lidx, torch.int32), baked=_bf16(baked),
                                 pair_ok=torch.from_numpy(ok), **kw, **tx)
    for name, a, b in zip(("nerv", "nerfactor", "indirect"), tout, jout):
        np.testing.assert_allclose(_np(a), np.asarray(b), err_msg=name,
                                   **MARCH)
    js_, ts_ = jout[3], tout[3]
    assert set(ts_) == set(js_)
    assert ("window_lost_w" in ts_) == (variant == "probe")
    for k in js_:
        np.testing.assert_allclose(float(ts_[k]), float(js_[k]), rtol=1e-5,
                                   err_msg=k)
    # the pair cap binds, and kept pairs use some but not all their slots
    assert float(js_["valid_pairs"]) > float(js_["kept_pairs"]) == 96
    assert 0 < float(js_["valid_slots"]) < 96 * 6
    lit = (np.asarray(jout[2]).sum(-1) > 0).sum()
    assert 0 < lit <= 96


_j_tiled = jax.jit(
    JSec.secondary_shading_tiled, static_argnums=0,
    static_argnames=("n_sample", "vis_near", "vis_far", "tile", "app_cap",
                     "bake_reso", "window", "window_back", "prepass_n",
                     "coarse_dilate", "compact_frac", "app_bake_reso",
                     "app_pair_frac", "return_stats", "window_probe",
                     "window_probe_back"))


@pytest.mark.parametrize("compact_frac,app_pair_frac", [(0.5625, 0.25),
                                                        (0.0, 0.0)])
def test_secondary_shading_tiled_fast_knobs_match_jax(masked, compact_frac,
                                                      app_pair_frac):
    jcfg, jp, js = masked
    tp, ts = port_field(jp, js)
    P, L = 40, 32
    pts, _ = _pairs(P, seed=9, radius=(0.3, 0.7))
    _, dirs = _pairs(P * L, seed=10)
    dirs = dirs.reshape(P, L, 3)
    lidx = (np.arange(P) % 2).astype(np.int32)
    # a few more pairs face the light than the compaction's 768 rows hold
    mask = np.random.default_rng(11).uniform(size=(P, L)) > 0.37
    kw = dict(tile=256, app_cap=6, bake_reso=12, window=12, window_back=4,
              prepass_n=8, coarse_dilate=2, compact_frac=compact_frac,
              app_bake_reso=10, app_pair_frac=app_pair_frac,
              return_stats=True, **SEC)
    jvis, jind, jst = _j_tiled(jcfg, jp, js, pts, dirs, lidx, mask, **kw)
    TSec.reset_march_counts()
    tvis, tind, tst = TSec.secondary_shading_tiled(
        port_cfg(jcfg), tp, ts, t(pts), t(dirs), t(lidx, torch.int32),
        torch.from_numpy(mask), tiled_knobs(**kw))
    # compacted: the 768 rows of ceil(1280 * 0.5625 / 256) = 3 tiles;
    # otherwise the 1280 pairs in 5 tiles
    assert TSec.MARCHED == ({"pairs": 768, "tiles": 3, "skipped": 0}
                            if compact_frac else
                            {"pairs": P * L, "tiles": 5, "skipped": 0})
    assert tvis.shape == (P, L, 1) and tind.shape == (P, L, 3)
    np.testing.assert_allclose(_np(tvis), np.asarray(jvis), **OWN_BAKE)
    np.testing.assert_allclose(_np(tind), np.asarray(jind), **OWN_BAKE)
    assert not np.asarray(jvis)[~mask].any()
    assert set(tst) == set(jst)
    for k in jst:
        np.testing.assert_allclose(float(tst[k]), float(jst[k]), rtol=1e-5,
                                   err_msg=k)
    if compact_frac:
        # pairs facing the light past the compaction's capacity get zeros
        assert mask.sum() > 768 and float(jst["compact_overflow_frac"]) > 0
        assert float(jst["app_pair_overflow_frac"]) > 0


# ------------------------------------------------------------ the step

def _bench_cpu_step():
    """bench.py's FieldConfig and StepStatic at its CPU sizes (B 256, grid
    48, 64 samples, 4x8 directions, 16 secondary samples, tile 1024, window
    12/4, app bake 32, mask 24^3), with the sigma bake cut to 32 so that the
    resize runs, deterministic, with the secondary statistics."""
    jcfg = JF.FieldConfig(envmap_h=4, envmap_w=8, num_sgs=128, step_ratio=0.5)
    st = dict(n_samples=64, is_relight=True, white_bg=True, app_cap=32,
              relight_ray_cap=256, march_cap=192, march_select="scatter",
              second_march_cap=32, secondary_use_baked=True,
              secondary_bake_reso=32, second_window=12, second_window_back=4,
              second_prepass_n=8, coarse_dilate=3,
              secondary_compact_frac=0.5625, app_bake_reso=32,
              second_app_cap=12, app_pair_frac=0.4375, second_n_sample=16,
              secondary_tile=1024, deterministic=True, secondary_stats=True)
    w = dict(ortho=0.0, l1=4e-5, tv_density=0.0, tv_app=0.0,
             lr_factor=0.999971, n_iters=80000, relight_start=10000)
    return jcfg, st, w


def _jax_mu(state):
    """Adam's first moment of every parameter, from the optax state."""
    out = {}
    for group in state.inner_states.values():
        for k, v in group.inner_state[0].mu.items():
            items = v.items() if isinstance(v, dict) else [(None, v)]
            for kk, vv in items:
                if hasattr(vv, "shape"):
                    out[k if kk is None else f"{k}/{kk}"] = np.asarray(vv)
    return out


def test_bench_cpu_step_matches_jax():
    jcfg, st, w = _bench_cpu_step()
    jp, js = jax.jit(JF.init_field_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jcfg, (48, 48, 48), AABB)
    jp = jax.jit(seed_solid_blob)(jp)
    js, _ = JLC.update_alpha_mask(jcfg, jp, js, (24, 24, 24))
    B = 256
    batch = {"rays": bench_rays(B), "rgbs": np.full((B, 3), 0.5, np.float32),
             "light_idx": np.zeros((B,), np.int32)}
    jopt = JO.make_optimizer(jp, 0.02, 1e-3, 0.999971)
    jstep = JS.make_train_step(jcfg, jopt, JS.StepStatic(**st),
                               JS.LossWeights(**w), donate=False)
    tp, ts = port_field(jp, js)
    _, jstate, jm = jstep(jp, jopt.init(jp), js,
                          {k: jnp.asarray(v) for k, v in batch.items()},
                          jax.random.PRNGKey(1), jnp.asarray(10000))
    topt = TO.make_optimizer(tp, 0.02, 1e-3, 0.999971)
    tstep = TS.make_train_step(port_cfg(jcfg), topt, TS.StepStatic(**st),
                               TS.LossWeights(**w), device="cpu")
    TSec.reset_march_counts()
    _, tstate, tm = tstep(tp, topt.init(tp), ts, batch, None, 10000)
    # 256 relit rays x 32 directions compacted into 5 tiles of 1024
    assert TSec.MARCHED == {"pairs": 5120, "tiles": 5, "skipped": 0}
    for k in ("total_loss", "loss_rgb", "loss_rgb_brdf"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    sec = {k for k in jm if k.startswith("sec/")}
    assert sec == set(TS.SEC_METRICS) - {"sec/window_resid_rel"}
    assert sec == {k for k in tm if k.startswith("sec/")}
    for k in sec:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    assert float(jm["sec/app_pair_overflow_frac"]) > 0   # the caps bind
    jg = _jax_mu(jstate)
    assert set(jg) == set(tstate["mu"])
    g_rel = {k: np.linalg.norm(_np(tstate["mu"][k]) - g) / np.linalg.norm(g)
             for k, g in jg.items()}
    assert max(g_rel.values()) <= 1e-3, g_rel

    def rel(k):
        return abs(float(tm[k]) - float(jm[k])) / abs(float(jm[k]))
    print(f"bench CPU step: sec/app_pair_overflow_frac "
          f"{float(tm['sec/app_pair_overflow_frac']):.4f} (JAX "
          f"{float(jm['sec/app_pair_overflow_frac']):.4f}); relative to "
          f"JAX: total loss {rel('total_loss'):.1e}, loss_normals_diff "
          f"{rel('loss_normals_diff'):.1e}, worst gradient "
          f"{max(g_rel.values()):.1e}")
