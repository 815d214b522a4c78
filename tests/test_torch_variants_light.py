"""The port's light samplers and estimators against the JAX package's, on
the CPU: the equal-area and importance samplers on JAX's own uniforms, the
dispatcher of light directions, and both new estimators of
``render_with_brdf`` with their gradients.

Tolerances:
- the samplers: directions, colours and pdfs 1e-5 relative where both
  pick the same texel; a draw may pick the neighbouring texel only where
  its uniform lies within 1e-6 of a step of JAX's CDF (the two cumulative
  sums round apart by about an ulp);
- ``render_with_brdf`` on the exact march, given JAX's directions: colour
  2e-5 relative and 2e-6 absolute, gradients 1e-4 relative and 1e-5
  absolute (test_torch_secondary.py's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoir_tpu.models import lighting as JL
from tensoir_tpu.render import brdf_render as JBR

from tensoir_tpu_torch.models import lighting as TL
from tensoir_tpu_torch.render import brdf_render as TBR

from torch_parity import (as_np, masked_jax_field,  # noqa: F401
                          one_torch_thread, port_cfg, port_field, small_cfg,
                          split_knobs, t)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MAPS = dict(rtol=2e-5, atol=2e-6)


def test_equal_area_sampler_matches_jax_on_its_uniforms():
    key = jax.random.PRNGKey(4)
    kp, kt = jax.random.split(key)
    draws = (np.asarray(jax.random.uniform(kp, (8, 16))),
             np.asarray(jax.random.uniform(kt, (8, 16))))
    want = np.asarray(JL.stratified_equal_area_dirs(key, 8, 16))
    got = TL.stratified_equal_area_dirs(None, 8, 16, draws=draws)
    np.testing.assert_allclose(as_np(got), want, rtol=1e-5, atol=1e-6)
    # equal areas: a row band of sin(phi) per row
    sp = want[:, 2].reshape(8, 16)
    assert (np.diff(sp.mean(1)) < 0).all()
    g = TL.stratified_equal_area_dirs(torch.Generator().manual_seed(0), 8, 16)
    np.testing.assert_allclose(np.linalg.norm(as_np(g), axis=-1), 1.0,
                               rtol=1e-6)


def test_importance_sampler_matches_jax_on_its_uniforms():
    """gen_light_incident_dirs_importance of the learned SG light on a
    32 x 64 grid: JAX's three uniform draws (the grid's jitter, then the
    draws) fed to the port."""
    jcfg, jp, _ = masked_jax_field()
    sgs = np.array(jp["lgt_sgs"])
    sgs[0] = [0.0, 0.0, 1.0, 8.0, 20.0, 20.0, 20.0]
    jlp = {"lgt_sgs": jnp.asarray(sgs)}
    n, h, w = 256, 32, 64
    key = jax.random.PRNGKey(1)
    jd, jrgb, jpdf = JL.gen_light_incident_dirs_importance(
        jlp, jcfg, key, n, env_h=h, env_w=w)
    k_jit, k_draw = jax.random.split(key)
    kp, kt = jax.random.split(k_jit)
    u = np.asarray(jax.random.uniform(k_draw, (n,)))
    draws = (np.asarray(jax.random.uniform(kp, (h, w))),
             np.asarray(jax.random.uniform(kt, (h, w))), u)
    td, trgb, tpdf = TL.gen_light_incident_dirs_importance(
        {"lgt_sgs": t(sgs)}, port_cfg(jcfg), None, n, env_h=h, env_w=w,
        draws=draws)
    # JAX's CDF, to tell a rounding flip from a wrong draw
    env = np.asarray(JL.get_light_rgbs(
        jlp, jcfg, JL.stratified_dirs(k_jit, h, w))[0], np.float64)
    sin_t = np.sin(np.linspace(0.5 / h, np.pi - 0.5 / h, h))
    pdf = env.sum(-1).reshape(h, w) * sin_t[:, None]
    cdf = np.cumsum(pdf / pdf.sum())
    same = np.all(np.isclose(as_np(td), np.asarray(jd), rtol=1e-5, atol=1e-6),
                  -1)
    for i in np.nonzero(~same)[0]:
        assert np.abs(cdf - u[i]).min() < 1e-6, (i, u[i])
    assert same.mean() > 0.98
    np.testing.assert_allclose(as_np(trgb)[same], np.asarray(jrgb)[same],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(as_np(tpdf)[same], np.asarray(jpdf)[same],
                               rtol=1e-5)
    assert float(as_np(td)[:, 2].mean()) > 0.15     # toward the bright lobe


def _surface(P, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.4, 0.4, (P, 3)).astype(np.float32)
    o = np.zeros((P, 3), np.float32)
    o[:, 2] = -4.0
    d = pts - o
    depth = np.linalg.norm(d, axis=-1).astype(np.float32)
    r = np.concatenate([o, d / depth[:, None]], -1).astype(np.float32)
    normal = (pts / np.linalg.norm(pts, axis=-1, keepdims=True)
              + rng.normal(size=(P, 3)) * 0.2).astype(np.float32)
    return dict(depth=depth, rays=r, normal=normal,
                albedo=rng.uniform(0.1, 0.9, (P, 3)).astype(np.float32),
                rough=rng.uniform(0.1, 0.9, (P, 1)).astype(np.float32),
                fres=np.full((P, 3), 0.04, np.float32),
                up=rng.normal(size=(P, 3)).astype(np.float32))


_j_brdf = jax.jit(
    JBR.render_with_brdf, static_argnums=0,
    static_argnames=("sample_method", "second_n_sample", "secondary_tile",
                     "second_march_cap", "second_app_cap",
                     "secondary_use_baked", "secondary_compact_frac"))


@pytest.mark.parametrize("method", ["importance_sample",
                                    "stratifed_sample_equal_areas"])
def test_render_with_brdf_estimators_match_jax(method, monkeypatch):
    """The importance estimator mean(brdf L cos / pdf) and the equal-area
    estimator mean(4 pi brdf L cos), on JAX's light directions for one key
    (the samplers are held above), with the gradients of the maps and the
    light; the hemisphere compaction stays off under importance."""
    jcfg, jp, js = masked_jax_field()
    tp, ts = port_field(jp, js)
    P = 12
    s = _surface(P, 9)
    lidx = np.zeros((P,), np.int32)
    key = jax.random.PRNGKey(11)
    jdirs, jpdf = JBR.incident_light_dirs(jcfg, method, key, params=jp)
    assert (jpdf is None) == (method != "importance_sample")
    kw = dict(sample_method=method, second_n_sample=16, secondary_tile=128,
              second_march_cap=6, second_app_cap=8, secondary_use_baked=False,
              secondary_compact_frac=0.5625)

    def j_loss(nrm, alb, rgh, sgs):
        p = dict(jp, lgt_sgs=sgs)
        return jnp.sum(_j_brdf(jcfg, p, js, jnp.asarray(s["depth"]), nrm, alb,
                               rgh, jnp.asarray(s["fres"]),
                               jnp.asarray(s["rays"]), jnp.asarray(lidx),
                               key=key, **kw) * s["up"])

    want = _j_brdf(jcfg, jp, js, jnp.asarray(s["depth"]), s["normal"],
                   s["albedo"], s["rough"], jnp.asarray(s["fres"]),
                   jnp.asarray(s["rays"]), jnp.asarray(lidx), key=key, **kw)
    jg = jax.grad(j_loss, argnums=(0, 1, 2, 3))(s["normal"], s["albedo"],
                                                s["rough"], jp["lgt_sgs"])
    replayed = (t(np.asarray(jdirs)),
                None if jpdf is None else t(np.asarray(jpdf)))
    monkeypatch.setattr(TBR, "incident_light_dirs",
                        lambda *a, **k: replayed)
    compacted = []
    real_tiled = TBR.secondary_shading_tiled
    monkeypatch.setattr(TBR, "secondary_shading_tiled", lambda *a, **k: (
        compacted.append(a[-1].secondary_compact_frac),
        real_tiled(*a, **k))[1])
    leaves = [t(x).requires_grad_(True) for x in (
        s["normal"], s["albedo"], s["rough"], np.asarray(jp["lgt_sgs"]))]
    rest, sec = split_knobs(kw)
    got = TBR.render_with_brdf(
        port_cfg(jcfg), dict(tp, lgt_sgs=leaves[3]), ts, t(s["depth"]),
        leaves[0], leaves[1], leaves[2], t(s["fres"]), t(s["rays"]),
        t(lidx, torch.int32), key=torch.Generator().manual_seed(0), **rest,
        secondary=sec)
    np.testing.assert_allclose(as_np(got), np.asarray(want), **MAPS)
    w = np.asarray(want)
    assert (w > 0.02).any() and (w < 0.999).all()
    assert compacted == [0.0 if method == "importance_sample" else 0.5625]
    (got * t(s["up"])).sum().backward()
    for name, leaf, g in zip(("normal", "albedo", "roughness", "lgt_sgs"),
                             leaves, jg):
        assert np.abs(np.asarray(g)).max() > 0, name
        np.testing.assert_allclose(as_np(leaf.grad), np.asarray(g),
                                   err_msg=name, rtol=1e-4, atol=1e-5)


def test_incident_light_dirs_of_each_method():
    """The port's dispatcher: fixed directions without a key (importance
    too, with no pdf), a pdf only from the importance sampler, and an
    unknown method refused."""
    cfg = port_cfg(small_cfg(envmap_h=4, envmap_w=8))
    _, fixed = JL.envmap_dirs(4, 8)
    gen = torch.Generator().manual_seed(0)
    params = {"lgt_sgs": TL.init_sg_params(gen, 8)}
    for m in ("fixed_envirmap", "importance_sample", "stratified_sampling",
              "stratifed_sample_equal_areas"):
        d, pdf = TBR.incident_light_dirs(cfg, m, None, params=params)
        np.testing.assert_array_equal(as_np(d), fixed)
        assert pdf is None
        d, pdf = TBR.incident_light_dirs(cfg, m, gen, params=params)
        assert d.shape == (32, 3)
        assert (pdf is not None) == (m == "importance_sample")
        if pdf is not None:
            assert pdf.shape == (32, 1) and bool((pdf > 0).all())
    with pytest.raises(ValueError):
        TBR.incident_light_dirs(cfg, "no_such_mode", gen)
