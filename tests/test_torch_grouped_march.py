"""The port's grouped secondary march and global app stage against the JAX
package's, on the CPU: the 27-corner pack and its lookup, the contract
checker, the grouped window march through ``compute_radiance`` and
``compute_transmittance``, the app payload, ``secondary_shading_tiled``
with the grouped march, the app bake and the hoisted app stage, the odd
window's refusal, and the loop's downgrade chain.

Tolerances, f32 on the CPU:
- the 27-corner bf16 pack: 1 bf16 ulp against JAX's eager pack (the bake
  sums its three einsums in another order; see test_torch_secondary.py),
  the pad channels 0;
- the grouped lookup on the same bf16 table: 1e-5 relative (1e-6
  absolute); the march given the same tables: visibility and indirect
  light 1e-5 relative, 2e-6 absolute (transmittance products of the same
  densities in another order);
- the JAX identities (tests/test_grouped_march.py) at JAX's tolerances:
  the grouped lookup and march equal the single-sample ones to 2e-4
  absolute, 1e-4 relative (1e-3 for indirect light);
- ``secondary_shading_tiled``, each package baking its own tables (JAX
  inside ``jit``): 1e-3 relative, 1e-4 absolute, as in
  test_torch_secondary.py; the hoisted app stage against the in-tile one:
  1e-6 absolute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoir_tpu.config import TensoIRConfig as JConfig
from tensoir_tpu.models import field as JF
from tensoir_tpu.render import secondary as JSec
from tensoir_tpu.train.loop import resolve_march_group as j_resolve

from tensoir_tpu_torch.config import TensoIRConfig as TConfig
from tensoir_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from tensoir_tpu_torch.models import field as TF
from tensoir_tpu_torch.render import secondary as TSec
from tensoir_tpu_torch.train.loop import resolve_march_group as t_resolve

from torch_parity import (as_np, masked_jax_field,  # noqa: F401
                          one_torch_thread, port_cfg, port_field, t,
                          tiled_knobs)

SEC = dict(n_sample=64, vis_near=0.05, vis_far=1.5)
WIN = dict(window=48, window_back=16, prepass_n=24)
PORT = dict(rtol=1e-5, atol=2e-6)
IDENTITY = dict(rtol=1e-4, atol=2e-4)
OWN_BAKE = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(scope="module")
def masked():
    return masked_jax_field()


@pytest.fixture(scope="module")
def tables(masked):
    """JAX's bf16 8-corner and 27-corner bakes and the coarse occupancy."""
    jcfg, jp, js = masked
    baked = JF.bake_packed_sigma_grid(jcfg, jp, js)
    baked27 = JF.bake_pair_packed_sigma_grid(jcfg, jp, js)
    coarse = JF.bake_coarse_occupancy(baked, reso=16)
    return baked, baked27, coarse


def _bf16(x, width=None) -> torch.Tensor:
    """A JAX bf16 table as the port's, its last axis zero-padded to
    ``width`` (the port's 27-corner row)."""
    x = np.asarray(x, np.float32)
    if width is not None:
        pad = np.zeros(x.shape[:-1] + (width - x.shape[-1],), np.float32)
        x = np.concatenate([x, pad], -1)
    return torch.from_numpy(x).to(torch.bfloat16)


def _bf16_ulp(x):
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


def _pairs(n, seed, radius=(0.2, 0.7)):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pts = d * rng.uniform(*radius, size=(n, 1))
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return pts.astype(np.float32), dirs.astype(np.float32)


def test_pair_pack_matches_jax(masked, one_torch_thread):
    jcfg, jp, js = masked
    tp, ts = port_field(jp, js)
    want = np.asarray(JF.bake_pair_packed_sigma_grid(jcfg, jp, js),
                      np.float32)
    got = TF.bake_pair_packed_sigma_grid(port_cfg(jcfg), tp, ts)
    assert got.dtype == torch.bfloat16
    assert got.shape == want.shape[:-1] + (TF.PAIR_ROW,)
    got = got.float().numpy()
    assert not got[..., 27:].any()
    diff = np.abs(got[..., :27] - want)
    assert (diff <= _bf16_ulp(np.maximum(np.abs(got[..., :27]),
                                         np.abs(want)))).all()
    # the pack of a dense grid: channel 9 dz + 3 dy + dx, exactly
    dense = np.random.default_rng(0).normal(size=(5, 6, 7)).astype(
        np.float32)
    j27 = np.asarray(JF.pack_corner27_grid(jnp.asarray(dense),
                                           jnp.float32))
    t27 = TF.pack_corner27_grid(torch.from_numpy(dense), torch.float32)
    assert np.array_equal(t27[..., :27].numpy(), j27)
    assert not t27[..., 27:].any()


@pytest.mark.parametrize("group", [2, 4])
def test_group_packed_lookup_matches_jax_and_single(tables, group,
                                                    one_torch_thread):
    baked, baked27, _ = tables
    Zc, Yc, Xc, _ = baked.shape
    cell = 2.0 / np.array([Xc, Yc, Zc])      # per axis, x y z
    rng = np.random.default_rng(group)
    base = rng.uniform(-0.95, 0.95, (128, 1, 3)).astype(np.float32)
    # a group's points within one cell of each other per axis
    jit = rng.uniform(0.0, 1.0, (128, group, 3)) * 0.9 * cell / (group - 1)
    coords = np.clip(base + np.cumsum(jit, 1) - jit, -1.0, 1.0).astype(
        np.float32)
    want = np.asarray(JF.density_feature_group_packed(baked27,
                                                      jnp.asarray(coords)))
    reset_launch_counts()
    got = TF.density_feature_group_packed(_bf16(baked27, TF.PAIR_ROW),
                                          t(coords))
    assert LAUNCHES["row_gather_bf16"] == 0       # the CPU runs no kernel
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # the 54-byte row (no pad) gives the same numbers
    np.testing.assert_array_equal(
        TF.density_feature_group_packed(_bf16(baked27), t(coords)).numpy(),
        got.numpy())
    single = TF.density_feature_packed(_bf16(baked), t(coords))
    np.testing.assert_allclose(got.numpy(), single.numpy(), **IDENTITY)


@pytest.mark.parametrize("aabb,shape,n_sample,group", [
    ((-1.5, 1.5), (126, 126, 126, 27), 96, 2),
    ((-1.5, 1.5), (126, 126, 126, 27), 96, 4),
    ((-1.5, 1.5), (61, 61, 61, 27), 96, 4),
    ((-0.9, 0.9), (61, 61, 61, 27), 96, 4),
    ((-0.4, 0.4), (22, 18, 14, 27), 64, 2)])
def test_check_pair_contract_matches_jax(aabb, shape, n_sample, group):
    box = np.array([[aabb[0]] * 3, [aabb[1]] * 3], np.float32)
    kw = dict(n_sample=n_sample, group=group)
    try:
        want = JF.check_pair_contract(box, shape, **kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            TF.check_pair_contract(box, shape, **kw)
        assert str(got.value) == str(e)
        return
    assert TF.check_pair_contract(box, shape, **kw) == want


_j_rad = jax.jit(JSec.compute_radiance, static_argnums=0,
                 static_argnames=("n_sample", "vis_near", "vis_far",
                                  "app_cap", "app_pair_cap", "window",
                                  "window_back", "prepass_n", "march_group",
                                  "return_app_payload"))
_j_trans = jax.jit(JSec.compute_transmittance, static_argnums=0,
                   static_argnames=("n_sample", "vis_near", "vis_far",
                                    "window", "window_back", "prepass_n",
                                    "march_group"))


@pytest.mark.parametrize("group", [2, 4])
def test_grouped_window_march_matches_jax(masked, tables, group,
                                          one_torch_thread):
    jcfg, jp, js = masked
    tp, ts = port_field(jp, js)
    baked, baked27, coarse = tables
    JF.check_pair_contract(np.asarray(js["aabb"]), baked27.shape,
                           n_sample=64, group=group)
    pts, dirs = _pairs(64, seed=1)
    lidx = np.zeros(64, np.int32)
    jt = dict(baked=baked, coarse=coarse, **SEC, **WIN)
    tt = dict(baked=_bf16(baked), coarse=t(coarse, torch.bool), **SEC, **WIN)
    g27 = dict(march_group=group)
    jout = _j_rad(jcfg, jp, js, pts, dirs, lidx, app_cap=8, app_pair_cap=48,
                  baked27=baked27, **g27, **jt)
    args = (port_cfg(jcfg), tp, ts, t(pts), t(dirs))
    tout = TSec.compute_radiance(*args, t(lidx, torch.int32), app_cap=8,
                                 app_pair_cap=48,
                                 baked27=_bf16(baked27, TF.PAIR_ROW), **g27,
                                 **tt)
    single = TSec.compute_radiance(*args, t(lidx, torch.int32), app_cap=8,
                                   app_pair_cap=48, **tt)
    for name, a, b, s in zip(("nerv", "nerfactor", "indirect"), tout, jout,
                             single):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **PORT)
        np.testing.assert_allclose(
            a.numpy(), s.numpy(), err_msg=name,
            **(dict(IDENTITY, rtol=1e-3) if name == "indirect"
               else IDENTITY))
    vis = np.asarray(jout[0])
    assert (vis < 0.5).any() and (vis > 0.5).any()     # shadowed and lit

    jtr = _j_trans(jcfg, jp, js, pts, dirs, baked27=baked27, **g27, **jt)
    ttr = TSec.compute_transmittance(*args,
                                     baked27=_bf16(baked27, TF.PAIR_ROW),
                                     **g27, **tt)
    tsingle = TSec.compute_transmittance(*args, **tt)
    for a, b, s in zip(ttr, jtr, tsingle):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **PORT)
        np.testing.assert_allclose(a.numpy(), s.numpy(), **IDENTITY)


def test_app_payload_matches_jax(masked, tables, one_torch_thread):
    jcfg, jp, js = masked
    tp, ts = port_field(jp, js)
    baked, _, coarse = tables
    pts, dirs = _pairs(96, seed=2)
    lidx = np.zeros(96, np.int32)
    ok = np.random.default_rng(3).uniform(size=96) > 0.2
    for pair_cap in (40, 0):
        kw = dict(app_cap=8, app_pair_cap=pair_cap, **SEC, **WIN)
        jv, jf, jp_ = _j_rad(jcfg, jp, js, pts, dirs, lidx, baked=baked,
                             coarse=coarse, pair_ok=ok,
                             return_app_payload=True, **kw)
        tv, tf, tp_ = TSec.compute_radiance(
            port_cfg(jcfg), tp, ts, t(pts), t(dirs), t(lidx, torch.int32),
            baked=_bf16(baked), coarse=t(coarse, torch.bool),
            pair_ok=torch.from_numpy(ok), return_app_payload=True, **kw)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **PORT)
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **PORT)
        assert set(tp_) == set(jp_) == {"pts_sel", "w_sel", "dirs", "lidx",
                                        "pair_idx", "pair_valid"}
        valid = np.asarray(jp_["pair_valid"])
        assert np.array_equal(tp_["pair_valid"].numpy(), valid)
        assert np.array_equal(tp_["pair_idx"].numpy(),
                              np.asarray(jp_["pair_idx"]))
        assert (valid.sum() == 40) if pair_cap else valid.all()
        # filled slots only: JAX reads NaN through an unfilled one
        for k in ("w_sel", "dirs", "lidx"):
            np.testing.assert_allclose(as_np(tp_[k])[valid],
                                       np.asarray(jp_[k])[valid], err_msg=k,
                                       **PORT)
        # the samples with weight: the top-k orders the zero-weight slots
        # of a pair as it likes, in either package
        held = valid[:, None] & (np.asarray(jp_["w_sel"]) > 0)
        assert held.sum() > 40
        np.testing.assert_allclose(as_np(tp_["pts_sel"])[held],
                                   np.asarray(jp_["pts_sel"])[held], **PORT)


_j_tiled = jax.jit(
    JSec.secondary_shading_tiled, static_argnums=0,
    static_argnames=("n_sample", "vis_near", "vis_far", "tile", "app_cap",
                     "march_cap", "bake_reso", "window", "window_back",
                     "prepass_n", "coarse_dilate", "compact_frac",
                     "march_group", "group_bake_reso", "app_bake_reso",
                     "app_hoist"))


def _tiled_inputs(P=16, L=8, seed=6, mask_frac=0.0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.3, 0.3, (P, 3)).astype(np.float32)
    d = rng.normal(size=(P, L, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    mask = rng.uniform(size=(P, L)) >= mask_frac
    return pts, d, np.zeros(P, np.int32), mask


@pytest.mark.parametrize("kw", [
    dict(march_group=2, app_bake_reso=12, compact_frac=0.9),
    dict(march_group=4, group_bake_reso=12, bake_reso=16),
    dict(march_group=2, app_hoist=True, compact_frac=0.75,
         app_bake_reso=12)],
    ids=["group2_app_bake_compact", "group4_group_bake", "group2_hoist"])
def test_secondary_tiled_grouped_matches_jax(masked, kw, one_torch_thread):
    """JAX's test_secondary_tiled_group_and_app_bake, port against JAX."""
    jcfg, jp, js = masked
    tp, ts = port_field(jp, js)
    pts, dirs, lidx, mask = _tiled_inputs()
    base = dict(tile=64, app_cap=8, **SEC, **WIN)
    jvis, jind = _j_tiled(jcfg, jp, js, pts, dirs, lidx, mask, **base, **kw)
    TSec.reset_march_counts()
    args = (port_cfg(jcfg), tp, ts, t(pts), t(dirs), t(lidx, torch.int32),
            torch.from_numpy(mask))
    tvis, tind = TSec.secondary_shading_tiled(*args,
                                              tiled_knobs(**base, **kw))
    np.testing.assert_allclose(tvis.numpy(), np.asarray(jvis), **OWN_BAKE)
    np.testing.assert_allclose(tind.numpy(), np.asarray(jind), **OWN_BAKE)
    assert TSec.MARCHED["tiles"] == (
        -(-int(128 * kw.get("compact_frac", 1.0)) // 64))
    if "group_bake_reso" in kw:
        return   # its 27-corner pack is baked coarser than the 8-corner one
    # visibility as the single-sample window march's, up to the sum order
    plain = {k: v for k, v in kw.items() if k == "compact_frac"}
    svis, _ = TSec.secondary_shading_tiled(*args,
                                           tiled_knobs(**base, **plain))
    np.testing.assert_allclose(tvis.numpy(), svis.numpy(), atol=3e-4,
                               rtol=1e-3)


def test_secondary_tiled_group_rejects_odd_window(masked):
    jcfg, jp, js = masked
    tp, ts = port_field(jp, js)
    kw = dict(n_sample=64, vis_near=0.05, vis_far=1.5, tile=16, window=42,
              window_back=15, prepass_n=24, march_group=2)
    with pytest.raises(ValueError) as want:
        JSec.secondary_shading_tiled(
            jcfg, jp, js, jnp.zeros((4, 3)), jnp.ones((4, 4, 3)),
            jnp.zeros(4, jnp.int32), jnp.ones((4, 4), bool), **kw)
    with pytest.raises(ValueError, match="must divide") as got:
        TSec.secondary_shading_tiled(
            port_cfg(jcfg), tp, ts, torch.zeros((4, 3)),
            torch.ones((4, 4, 3)), torch.zeros(4, dtype=torch.int32),
            torch.ones((4, 4), dtype=torch.bool), tiled_knobs(**kw))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("compact", [0.0, 0.75])
def test_secondary_app_hoist_exact(masked, compact, one_torch_thread):
    """JAX's test_secondary_app_hoist_exact on the port: the hoisted app
    stage equals the in-tile one; and the hoisted pass equals JAX's."""
    jcfg, jp, js = masked
    tp, ts = port_field(jp, js)
    pts, dirs, lidx, mask = _tiled_inputs(P=48, L=16, seed=3, mask_frac=0.4)
    kw = dict(n_sample=24, vis_near=0.05, vis_far=1.5, tile=256, app_cap=8,
              march_cap=12, bake_reso=32, window=8, window_back=4,
              prepass_n=8, coarse_dilate=2, compact_frac=compact,
              app_bake_reso=32)
    args = (port_cfg(jcfg), tp, ts, t(pts), t(dirs), t(lidx, torch.int32),
            torch.from_numpy(mask))
    v0, i0 = TSec.secondary_shading_tiled(*args, tiled_knobs(**kw))
    v1, i1, stats = TSec.secondary_shading_tiled(
        *args, tiled_knobs(app_hoist=True, return_stats=True, **kw))
    assert stats == {}
    np.testing.assert_allclose(v1.numpy(), v0.numpy(), atol=1e-6)
    np.testing.assert_allclose(i1.numpy(), i0.numpy(), atol=1e-6)
    assert i1.abs().sum() > 0
    jv, ji = _j_tiled(jcfg, jp, js, pts, dirs, lidx, mask, app_hoist=True,
                      **kw)
    np.testing.assert_allclose(v1.numpy(), np.asarray(jv), **OWN_BAKE)
    np.testing.assert_allclose(i1.numpy(), np.asarray(ji), **OWN_BAKE)


def test_resolve_march_group_downgrade_chain(capsys):
    """The loop's 4 -> 2 -> 0 downgrade against the live AABB, and its
    printed line, as JAX's."""
    grid = (200, 200, 200)
    base = dict(second_march_group=4, group_bake_reso=64,
                secondary_bake_reso=128, second_nSample=96,
                second_window=48, second_window_back=16, second_near=0.05,
                second_far=1.5)
    cases = [(base, 1.5, 4), (base, 0.7, 2), (base, 0.2, 0),
             (dict(base, second_window=46), 1.5, 2),
             (dict(base, group_bake_reso=0), 1.5, 2),
             (dict(second_march_group=0), 1.5, 0)]
    for kw, half, want in cases:
        aabb = np.array([[-half] * 3, [half] * 3], np.float32)
        assert j_resolve(JConfig(**kw), aabb, grid) == want
        j_out = capsys.readouterr().out
        assert t_resolve(TConfig(**kw), aabb, grid) == want
        assert capsys.readouterr().out == j_out
