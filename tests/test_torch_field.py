"""The port's VM field against the JAX package's, on the CPU: feature
queries with the gradients of every parameter, the alpha mask on a scene
that JAX's ``update_alpha_mask`` has masked, and the helpers the step
uses to build its field and scene.

Tolerances, f32: features 1e-5 relative and 1e-6 absolute; parameter
gradients, which sum over every point, 1e-5 relative and 1e-5 absolute;
the alpha mask 1e-6 absolute (its bf16 table is read the same way by
both); renders 2e-5 relative and 2e-6 absolute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoir_tpu.models import field as JF
from tensoir_tpu.models import lifecycle as JLC
from tensoir_tpu.models import lighting as JL
from tensoir_tpu.utils import bench_scene as JB

from tensoir_tpu_torch.models import field as TF
from tensoir_tpu_torch.models import lighting as TL
from tensoir_tpu_torch.render.primary import render_rays as t_render_rays
from tensoir_tpu_torch.utils import bench_scene as TB

from torch_parity import (j_render_rays, jax_field, port_cfg, port_field,
                          rays, small_cfg, t)

FEAT = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-5, atol=1e-5)


def _coords(n, seed=0):
    c = np.random.default_rng(seed).uniform(-1.1, 1.1, size=(n, 3))
    c[:2] = [[-1, -1, -1], [1, 1, 1]]
    return c.astype(np.float32)


def _leaves(params):
    """Port params as leaves that require grad, in a dict of the JAX tree's
    shape."""
    return {k: _leaves(v) if isinstance(v, dict)
            else v.detach().clone().requires_grad_(True)
            for k, v in params.items()}


def _assert_grads(t_tree, j_grads, path=""):
    for k, v in t_tree.items():
        if isinstance(v, dict):
            _assert_grads(v, j_grads[k], f"{path}{k}/")
            continue
        want = np.asarray(j_grads[k])
        got = (np.zeros_like(want) if v.grad is None
               else v.grad.detach().numpy())
        np.testing.assert_allclose(got, want, err_msg=f"{path}{k}", **GRAD)


def test_density_feature_and_its_parameter_gradients_match_jax():
    jcfg = small_cfg()
    jp, js = jax_field(jcfg)
    tp, _ = port_field(jp, js)
    coords = _coords(300)
    up = np.random.default_rng(1).normal(size=(300,)).astype(np.float32)

    def j_loss(p):
        return jnp.sum(JF.density_feature(jcfg, p, jnp.asarray(coords)) * up)

    jfeat = JF.density_feature(jcfg, jp, jnp.asarray(coords))
    leaves = _leaves(tp)
    tfeat = TF.density_feature(port_cfg(jcfg), leaves, t(coords))
    np.testing.assert_allclose(tfeat.detach().numpy(), np.asarray(jfeat),
                               **FEAT)
    (tfeat * t(up)).sum().backward()
    _assert_grads(leaves, jax.jit(jax.grad(j_loss))(jp))
    for fea2dense in ("softplus", "relu"):
        cfg = small_cfg(fea2dense=fea2dense)
        np.testing.assert_allclose(
            TF.feature2density(port_cfg(cfg), tfeat).detach().numpy(),
            np.asarray(JF.feature2density(cfg, jfeat)), **FEAT)


def test_appearance_features_and_their_gradients_match_jax():
    jcfg = small_cfg(light_num=3)
    jp, js = jax_field(jcfg)
    tp, _ = port_field(jp, js)
    n = 120
    coords = _coords(n, seed=2)
    lidx = np.random.default_rng(3).integers(0, 3, size=(n,)).astype(np.int32)
    rng = np.random.default_rng(4)
    u_rad = rng.normal(size=(n, jcfg.app_dim)).astype(np.float32)
    u_int = rng.normal(size=(n, jcfg.app_dim)).astype(np.float32)

    def j_loss(p):
        rad, intr = JF.both_features(jcfg, p, jnp.asarray(coords),
                                     jnp.asarray(lidx))
        return jnp.sum(rad * u_rad) + jnp.sum(intr * u_int)

    jrad, jint = JF.both_features(jcfg, jp, jnp.asarray(coords),
                                  jnp.asarray(lidx))
    leaves = _leaves(tp)
    tcfg = port_cfg(jcfg)
    trad, tint = TF.both_features(tcfg, leaves, t(coords),
                                  t(lidx, torch.int32))
    np.testing.assert_allclose(trad.detach().numpy(), np.asarray(jrad), **FEAT)
    np.testing.assert_allclose(tint.detach().numpy(), np.asarray(jint), **FEAT)
    ((trad * t(u_rad)).sum() + (tint * t(u_int)).sum()).backward()
    _assert_grads(leaves, jax.jit(jax.grad(j_loss))(jp))

    np.testing.assert_allclose(
        TF.app_feature(tcfg, tp, t(coords), t(lidx, torch.int32)).numpy(),
        np.asarray(JF.app_feature(jcfg, jp, jnp.asarray(coords),
                                  jnp.asarray(lidx))), **FEAT)
    np.testing.assert_allclose(
        TF.intrin_feature(tcfg, tp, t(coords)).numpy(),
        np.asarray(JF.intrin_feature(jcfg, jp, jnp.asarray(coords))), **FEAT)


def _masked_scene():
    """A field and the scene JAX's update_alpha_mask makes for it."""
    jcfg = small_cfg()
    jp, js = jax_field(jcfg)
    js, _ = JLC.update_alpha_mask(jcfg, jp, js, JF.grid_size_of(jp))
    vol = np.asarray(js["alpha_volume"])
    assert 0 < vol.sum() < vol.size        # some of the box is masked out
    return jcfg, jp, js


def test_alpha_mask_of_a_jax_masked_scene_matches():
    jcfg, jp, js = _masked_scene()
    tp, ts = port_field(jp, js)
    assert ts["alpha_volume_packed"].dtype == torch.bfloat16
    assert ts["alpha_volume_dilated"].dtype == torch.uint8
    np.testing.assert_array_equal(
        ts["alpha_volume_packed"].float().numpy(),
        np.asarray(js["alpha_volume_packed"], np.float32))
    xyz = np.random.default_rng(5).uniform(-1.7, 1.7, size=(40, 30, 3))
    xyz = xyz.astype(np.float32)
    want = np.asarray(JF.sample_alpha_mask(js, jnp.asarray(xyz)))
    got = TF.sample_alpha_mask(ts, t(xyz)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (want > 0).any() and (want == 0).any()
    # the 8-tap trilinear path of a scene without the packed copy
    js_tri = {k: v for k, v in js.items() if k != "alpha_volume_packed"}
    ts_tri = {k: v for k, v in ts.items() if k != "alpha_volume_packed"}
    np.testing.assert_allclose(
        TF.sample_alpha_mask(ts_tri, t(xyz)).numpy(),
        np.asarray(JF.sample_alpha_mask(js_tri, jnp.asarray(xyz))),
        rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        TF.sample_alpha_mask_nearest(ts, t(xyz)).numpy(),
        np.asarray(JF.sample_alpha_mask_nearest(js, jnp.asarray(xyz))))
    # before a mask exists every point passes
    _, fresh = port_field(*jax_field(jcfg))
    assert bool((TF.sample_alpha_mask(fresh, t(xyz)) == 1).all())
    assert bool(TF.sample_alpha_mask_nearest(fresh, t(xyz)).all())


def test_render_on_a_jax_masked_scene_matches():
    jcfg, jp, js = _masked_scene()
    tp, ts = port_field(jp, js)
    r = rays(48, seed=6)
    lidx = np.zeros((48,), np.int32)
    jout = j_render_rays(jcfg, jp, js, jnp.asarray(r), jnp.asarray(lidx),
                         n_samples=40, key=None, is_relight=False,
                         white_bg=True, app_cap=8)
    tout = t_render_rays(port_cfg(jcfg), tp, ts, t(r), t(lidx, torch.int32),
                         n_samples=40, key=None, is_relight=False,
                         white_bg=True, app_cap=8)
    for k in ("rgb_map", "depth_map", "acc_map"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   rtol=2e-5, atol=2e-6, err_msg=k)


def test_geometry_helpers_match_jax():
    jcfg = small_cfg()
    jp, js = jax_field(jcfg)
    tp, ts = port_field(jp, js)
    assert TF.grid_size_of(tp) == JF.grid_size_of(jp) == (24, 20, 16)
    np.testing.assert_allclose(
        float(TF.step_size(ts["aabb"], (24, 20, 16), 0.5)),
        float(JF.step_size(js["aabb"], (24, 20, 16), 0.5)), rtol=1e-6)
    xyz = np.random.default_rng(7).uniform(-2, 2, size=(10, 3))
    np.testing.assert_allclose(
        TF.normalize_coord(ts["aabb"], t(xyz)).numpy(),
        np.asarray(JF.normalize_coord(js["aabb"],
                                      jnp.asarray(xyz, jnp.float32))),
        **FEAT)


def test_bench_scene_and_sg_init_match_jax():
    jcfg = small_cfg()
    jp, _ = jax_field(jcfg, seed=3, blob=False)
    tp, _ = port_field(jp, {})
    want = jax.tree.map(np.asarray, JB.seed_solid_blob(dict(jp), 5.0, 0.3))
    got = TB.seed_solid_blob(tp, 5.0, 0.3)
    for k in want:
        if k.startswith("density"):
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(TB.bench_rays(64, seed=2),
                                  JB.bench_rays(64, seed=2))

    np.testing.assert_array_equal(TL.fibonacci_sphere(17),
                                  JL.fibonacci_sphere(17))
    sgs = TL.init_sg_params(torch.Generator().manual_seed(0), 16)
    np.testing.assert_allclose(TL.sg_energy(sgs).numpy(),
                               np.asarray(JL.sg_energy(jnp.asarray(
                                   sgs.numpy()))), rtol=1e-6)
    # the init's invariants, as the JAX init has them: fibonacci lobes on
    # both halves, lambda >= 10, grey mu, total energy 2*pi*0.8 per channel
    for s in (sgs.numpy(), np.asarray(JL.init_sg_params(
            jax.random.PRNGKey(0), 16))):
        np.testing.assert_allclose(s[:8, :3], JL.fibonacci_sphere(8))
        np.testing.assert_allclose(s[8:, :3], JL.fibonacci_sphere(8))
        assert (s[:, 3] >= 10).all()
        np.testing.assert_array_equal(s[:, 4], s[:, 5])
        np.testing.assert_allclose(
            np.asarray(JL.sg_energy(jnp.asarray(s))).sum(0),
            [2 * np.pi * 0.8] * 3, rtol=1e-5)


@pytest.mark.parametrize("decomp", ["cp", "vm_stacked"])
def test_unported_decompositions_raise(decomp):
    cfg = TF.FieldConfig(decomp=decomp)
    with pytest.raises(NotImplementedError):
        TF.init_field_params(torch.Generator(), cfg, (4, 4, 4),
                             [[-1] * 3, [1] * 3], device="cpu")
    with pytest.raises(NotImplementedError):
        TF.density_feature(cfg, {}, torch.zeros((2, 3)))
