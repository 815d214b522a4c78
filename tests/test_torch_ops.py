"""The port's ops against the JAX package's, on the CPU, with gradients
where the JAX function has them.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances, f32: values 1e-5 relative and 1e-6 absolute (the same
arithmetic in another order, or with a fused multiply-add); gradients
that sum many terms (a plane's or a line's gradient over all points,
weights of an MLP) 1e-5 relative and 1e-5 absolute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoir_tpu.models import mlps as JM
from tensoir_tpu.ops import compositing as JCo
from tensoir_tpu.ops import interp as JI
from tensoir_tpu.ops import pe as JPE
from tensoir_tpu.ops import rays as JR

from tensoir_tpu_torch.models import mlps as TM
from tensoir_tpu_torch.ops import compositing as TCo
from tensoir_tpu_torch.ops import interp as TI
from tensoir_tpu_torch.ops import pe as TPE
from tensoir_tpu_torch.ops import rays as TR

VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-5, atol=1e-5)


def _coords(rng, n):
    """n coordinates in [-1.3, 1.3], with exact -1, 0, 1 and both sides of
    the domain's edge among them."""
    c = rng.uniform(-1.3, 1.3, size=(n,)).astype(np.float32)
    c[:6] = [-1.0, 1.0, 0.0, -1.3, 1.3, 1.0 - 1e-7]
    return c


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def _leaf(x):
    return _t(x).requires_grad_(True)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("hw", [(5, 7), (12, 9)])
def test_bilerp_plane_packed_matches_jax(hw):
    rng = np.random.default_rng(0)
    H, W = hw
    C, n = 6, 200
    plane = rng.normal(size=(H, W, C)).astype(np.float32)
    x, y = _coords(rng, n), _coords(rng, n)[::-1].copy()
    up = rng.normal(size=(n, C)).astype(np.float32)

    def j_loss(p, xx, yy):
        return jnp.sum(JI.bilerp_plane_packed(p, xx, yy) * up)

    jout = JI.bilerp_plane_packed(jnp.asarray(plane), jnp.asarray(x),
                                  jnp.asarray(y))
    jg = jax.grad(j_loss, argnums=(0, 1, 2))(jnp.asarray(plane),
                                             jnp.asarray(x), jnp.asarray(y))
    tp, tx, ty = _leaf(plane), _leaf(x), _leaf(y)
    tout = TI.bilerp_plane_packed(tp, tx, ty)
    _close(tout, jout, VAL)
    (tout * _t(up)).sum().backward()
    _close(tp.grad, jg[0], GRAD)
    _close(tx.grad, jg[1], GRAD)
    _close(ty.grad, jg[2], GRAD)


@pytest.mark.parametrize("D", [2, 17])
def test_line_lookup_matches_lerp_line_matmul(D):
    rng = np.random.default_rng(1)
    C, n = 5, 150
    line = rng.normal(size=(D, C)).astype(np.float32)
    z = _coords(rng, n).reshape(10, 15)
    up = rng.normal(size=(10, 15, C)).astype(np.float32)

    def j_loss(ln, zz):
        return jnp.sum(JI.lerp_line_matmul(ln, zz) * up)

    jout = JI.lerp_line_matmul(jnp.asarray(line), jnp.asarray(z))
    jg = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(line), jnp.asarray(z))
    tl, tz = _leaf(line), _leaf(z)
    tout = TI.lerp_line_matmul(tl, tz)
    assert tout.shape == (10, 15, C)
    _close(tout, jout, VAL)
    (tout * _t(up)).sum().backward()
    _close(tl.grad, jg[0], GRAD)
    _close(tz.grad, jg[1], GRAD)


def test_lerp_line_and_trilerp_volume_match_jax():
    rng = np.random.default_rng(2)
    line = rng.normal(size=(9, 4)).astype(np.float32)
    z = rng.uniform(-1, 1, size=(64,)).astype(np.float32)
    z[:2] = [-1.0, 1.0]
    for ac in (True, False):
        _close(TI.lerp_line(_t(line), _t(z), ac),
               JI.lerp_line(jnp.asarray(line), jnp.asarray(z), ac), VAL)
    vol = rng.uniform(size=(4, 5, 6)).astype(np.float32)
    vol_c = rng.normal(size=(4, 5, 6, 3)).astype(np.float32)
    pts = rng.uniform(-1, 1, size=(7, 9, 3)).astype(np.float32)
    pts[0, :2] = [[-1, -1, -1], [1, 1, 1]]
    for v in (vol, vol_c):
        _close(TI.trilerp_volume(_t(v), _t(pts)),
               JI.trilerp_volume(jnp.asarray(v), jnp.asarray(pts)), VAL)


def _rays(rng, n):
    o = rng.uniform(-0.5, 0.5, size=(n, 3)).astype(np.float32)
    o[:, 2] = -4.0
    d = rng.normal(size=(n, 3)).astype(np.float32) * 0.3
    d[:, 2] = 1.0
    d[0] = [0.0, 0.0, 1.0]             # zero components take the 1e-6 path
    return o, d


@pytest.mark.parametrize("jittered", [False, True])
def test_sample_ray_and_z_to_dists_match_jax(jittered):
    rng = np.random.default_rng(3)
    o, d = _rays(rng, 32)
    aabb = np.array([[-1.5] * 3, [1.5] * 3], np.float32)
    n_samples, step = 40, np.float32(0.04)
    key = jax.random.PRNGKey(7) if jittered else None
    jxyz, jz, jvalid = JR.sample_ray(jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(aabb), 2.0, 6.0, step,
                                     n_samples, key=key)
    # the same jitter JAX draws inside sample_ray, handed to the port
    jitter = (_t(jax.random.uniform(key, (32, 1))) if jittered else None)
    txyz, tz, tvalid = TR.sample_ray(_t(o), _t(d), _t(aabb), 2.0, 6.0,
                                     torch.tensor(step), n_samples,
                                     jitter=jitter)
    _close(txyz, jxyz, VAL)
    _close(tz, jz, VAL)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    assert 0 < int(tvalid.sum()) < tvalid.numel()
    _close(TR.z_to_dists(tz), JR.z_to_dists(jz), VAL)
    _close(TR.aabb_ray_tmin(_t(o), _t(d), _t(aabb), 2.0, 6.0),
           JR.aabb_ray_tmin(jnp.asarray(o), jnp.asarray(d),
                            jnp.asarray(aabb), 2.0, 6.0), VAL)


def test_safe_l2_normalize_matches_jax_with_gradient_at_zero():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(6, 3)).astype(np.float32)
    x[0] = 0.0
    jg = jax.grad(lambda a: jnp.sum(JR.safe_l2_normalize(a) ** 3))(
        jnp.asarray(x))
    tx = _leaf(x)
    tout = TR.safe_l2_normalize(tx)
    _close(tout, JR.safe_l2_normalize(jnp.asarray(x)), VAL)
    (tout ** 3).sum().backward()
    _close(tx.grad, jg, GRAD)
    assert torch.isfinite(tx.grad).all()


def test_raw2alpha_matches_jax_with_gradients():
    rng = np.random.default_rng(5)
    sigma = np.abs(rng.normal(size=(8, 30))).astype(np.float32) * 3
    sigma[:, :5] = 0.0
    dist = rng.uniform(0.01, 0.1, size=(8, 30)).astype(np.float32) * 25
    up = rng.normal(size=(8, 30)).astype(np.float32)

    def j_loss(s):
        _, w, bg = JCo.raw2alpha(s, jnp.asarray(dist))
        return jnp.sum(w * up) + jnp.sum(bg)

    ja, jw, jbg = JCo.raw2alpha(jnp.asarray(sigma), jnp.asarray(dist))
    ts = _leaf(sigma)
    ta, tw, tbg = TCo.raw2alpha(ts, _t(dist))
    for got, want in ((ta, ja), (tw, jw), (tbg, jbg)):
        _close(got, want, VAL)
    ((tw * _t(up)).sum() + tbg.sum()).backward()
    _close(ts.grad, jax.grad(j_loss)(jnp.asarray(sigma)), GRAD)


@pytest.mark.parametrize("freqs", [0, 2, 3])
def test_positional_encoding_matches_jax(freqs):
    x = np.random.default_rng(6).normal(size=(5, 4, 3)).astype(np.float32)
    _close(TPE.positional_encoding(_t(x), freqs),
           JPE.positional_encoding(jnp.asarray(x), freqs), VAL)


def test_apply_mlp_and_render_inputs_match_jax():
    rng = np.random.default_rng(7)
    app_dim, view_pe, fea_pe, hidden = 8, 2, 2, 16
    in_dim = TM.render_fea_in_dim(app_dim, view_pe, fea_pe)
    assert in_dim == JM.render_fea_in_dim(app_dim, view_pe, fea_pe)
    assert (TM.brdf_pe_fea_in_dim(app_dim, 2, 2)
            == JM.brdf_pe_fea_in_dim(app_dim, 2, 2))
    jparams = JM.init_mlp(jax.random.PRNGKey(0), in_dim, hidden, 3)
    pnp = {k: np.asarray(v) for k, v in jparams.items()}
    feat = rng.normal(size=(4, 6, app_dim)).astype(np.float32)
    vdir = rng.normal(size=(4, 6, 3)).astype(np.float32)
    jx = JM.render_fea_inputs(jnp.asarray(feat), jnp.asarray(vdir), view_pe,
                              fea_pe)
    tx = TM.render_fea_inputs(_t(feat), _t(vdir), view_pe, fea_pe)
    _close(tx, jx, VAL)

    up = rng.normal(size=(4, 6, 3)).astype(np.float32)

    def j_loss(p, x):
        return jnp.sum(JM.apply_mlp(p, x) * up)

    jg_p, jg_x = jax.grad(j_loss, argnums=(0, 1))(jparams, jx)
    tparams = {k: _leaf(v) for k, v in pnp.items()}
    txl = _leaf(np.asarray(jx))
    tout = TM.apply_mlp(tparams, txl)
    _close(tout, JM.apply_mlp(jparams, jx), VAL)
    (tout * _t(up)).sum().backward()
    for k in pnp:
        _close(tparams[k].grad, jg_p[k], GRAD)
    _close(txl.grad, jg_x, GRAD)

    tinit = TM.init_mlp(torch.Generator().manual_seed(0), in_dim, hidden, 3)
    assert {k: tuple(v.shape) for k, v in tinit.items()} == {
        k: v.shape for k, v in pnp.items()}
    assert float(tinit["b3"].abs().max()) == 0.0
