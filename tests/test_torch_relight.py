"""The port's relight-phase step against the JAX package's, on the CPU.

Same field (made by tensoir_tpu, masked by its ``update_alpha_mask``, then
carried over as numpy), same rays, the deterministic path (fixed lat-long
light directions, no jitter, white background). Tolerances, f32 on the
CPU, where the two packages sum in other orders:
- elementwise ops (GGX, sRGB, SG light) 1e-5 relative and 1e-6 absolute;
- derived normals 1e-5 relative and 2e-6 absolute: they normalise a
  gradient that is itself a sum of products, so its rounding is divided by
  the gradient's length (the largest difference seen is 3e-7);
- parameter gradients through the double backward 1e-4 relative and 1e-5
  absolute (sums over every point of two backward passes);
- render maps 2e-5 relative and 2e-6 absolute (largest seen 7e-7, in the
  depth map);
- losses 1e-4 relative; parameters after three Adam steps 1e-4 absolute
  (Adam's first step moves each element by about lr * sign(grad), so
  rounding shows only through a sign, far below the smallest lr, 1e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoir_tpu.models import field as JF
from tensoir_tpu.models import lifecycle as JLC
from tensoir_tpu.models import lighting as JL
from tensoir_tpu.ops.brdf import ggx_specular as j_ggx
from tensoir_tpu.ops.color import linear2srgb as j_srgb
from tensoir_tpu.render.primary import render_rays as _j_render_rays
from tensoir_tpu.train import optim as JO
from tensoir_tpu.train import step as JS

from tensoir_tpu_torch.models import field as TF
from tensoir_tpu_torch.models import lifecycle as TLC
from tensoir_tpu_torch.models import lighting as TL
from tensoir_tpu_torch.ops.brdf import ggx_specular as t_ggx
from tensoir_tpu_torch.ops.color import linear2srgb as t_srgb
from tensoir_tpu_torch.render.primary import render_rays as t_render_rays
from tensoir_tpu_torch.train import optim as TO
from tensoir_tpu_torch.train import step as TS

from torch_parity import (assert_tree_close, jax_field, port_cfg,
                          port_field, rays, small_cfg, t)

OPS = dict(rtol=1e-5, atol=1e-6)
NRM = dict(rtol=1e-5, atol=2e-6)
MAPS = dict(rtol=2e-5, atol=2e-6)
GRID = (24, 20, 16)
B, S, MARCH_CAP = 48, 48, 24
RELIGHT = dict(relight_ray_cap=16, second_n_sample=16, secondary_tile=256,
               second_app_cap=8)


def relight_cfg(**kw):
    return small_cfg(envmap_h=4, envmap_w=8, **kw)


@pytest.fixture(scope="module")
def masked():
    """(jax cfg, jax params, jax scene masked by JAX's update_alpha_mask)."""
    jcfg = relight_cfg()
    jp, js = jax_field(jcfg)
    js, _ = JLC.update_alpha_mask(jcfg, jp, js, GRID)
    return jcfg, jp, js


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ----------------------------------------------------------------- ops


def test_ggx_specular_and_srgb_match_jax_with_gradients():
    rng = np.random.default_rng(0)
    n, L = 40, 12
    normal = rng.normal(size=(n, 3)).astype(np.float32)
    pts2c = rng.normal(size=(n, 3)).astype(np.float32)
    pts2l = rng.normal(size=(n, L, 3)).astype(np.float32)
    rough = rng.uniform(0.09, 0.99, size=(n, 1)).astype(np.float32)
    fres = np.full((n, 3), 0.04, np.float32)
    up = rng.normal(size=(n, L, 3)).astype(np.float32)

    def j_loss(nrm, r):
        return jnp.sum(j_ggx(nrm, pts2c, pts2l, r, fres) * up)

    jv = j_ggx(normal, pts2c, pts2l, rough, fres)
    jg_n, jg_r = jax.grad(j_loss, argnums=(0, 1))(normal, rough)
    tn, tr = t(normal).requires_grad_(True), t(rough).requires_grad_(True)
    tv = t_ggx(tn, t(pts2c), t(pts2l), tr, t(fres))
    np.testing.assert_allclose(_np(tv), np.asarray(jv), **OPS)
    (tv * t(up)).sum().backward()
    np.testing.assert_allclose(_np(tn.grad), np.asarray(jg_n), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(_np(tr.grad), np.asarray(jg_r), rtol=1e-4,
                               atol=1e-5)

    x = np.concatenate([np.linspace(-0.1, 1.1, 200),
                        [0.0, 0.0031308, 1.0]]).astype(np.float32)
    np.testing.assert_allclose(_np(t_srgb(t(x))), np.asarray(j_srgb(x)),
                               **OPS)
    tx = t(x).requires_grad_(True)
    t_srgb(tx).sum().backward()
    jgx = jax.grad(lambda a: jnp.sum(j_srgb(a)))(x)
    np.testing.assert_allclose(_np(tx.grad), np.asarray(jgx), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("per_light_sg", [False, True])
def test_sg_light_matches_jax(per_light_sg):
    rng = np.random.default_rng(1)
    jcfg = relight_cfg(light_num=3, light_rotations=(0, 90, 215),
                       per_light_sg=per_light_sg)
    M = 8
    sgs = rng.normal(size=((3, M, 7) if per_light_sg else (M, 7)))
    sgs = sgs.astype(np.float32)
    dirs = rng.normal(size=(30, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    up = rng.normal(size=(3, 30, 3)).astype(np.float32)
    want = JL.get_light_rgbs({"lgt_sgs": sgs}, jcfg, jnp.asarray(dirs))
    jg = jax.grad(lambda s: jnp.sum(JL.get_light_rgbs(
        {"lgt_sgs": s}, jcfg, jnp.asarray(dirs)) * up))(sgs)
    ts = t(sgs).requires_grad_(True)
    got = TL.get_light_rgbs({"lgt_sgs": ts}, port_cfg(jcfg), t(dirs))
    assert got.shape == (3, 30, 3)
    np.testing.assert_allclose(_np(got), np.asarray(want), **OPS)
    (got * t(up)).sum().backward()
    np.testing.assert_allclose(_np(ts.grad), np.asarray(jg), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(
        _np(TL.render_envmap_sg(t(sgs.reshape(-1, M, 7)[0]), t(dirs))),
        np.asarray(JL.render_envmap_sg(sgs.reshape(-1, M, 7)[0], dirs)),
        **OPS)
    np.testing.assert_array_equal(TL.rotation_matrices((0, 90, 215)),
                                  JL.rotation_matrices((0, 90, 215)))


def test_light_directions_match_jax():
    for h, w in ((4, 8), (16, 32)):
        ta, td = TL.envmap_dirs(h, w)
        ja, jd = JL.envmap_dirs(h, w)
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(td, jd)
        # the stratified jitter: JAX's own two uniform draws fed to the port
        key = jax.random.PRNGKey(7)
        kp, kt = jax.random.split(key)
        draws = (torch.from_numpy(np.array(jax.random.uniform(kp, (h, w)))),
                 torch.from_numpy(np.array(jax.random.uniform(kt, (h, w)))))
        want = np.asarray(JL.stratified_dirs(key, h, w))
        got = TL.stratified_dirs(None, h, w, draws=draws)
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=2e-6)
    # drawn from a generator: unit vectors within half a texel of the grid
    got = TL.stratified_dirs(torch.Generator().manual_seed(0), 4, 8)
    np.testing.assert_allclose(np.linalg.norm(_np(got), axis=-1), 1.0,
                               rtol=1e-6)
    cos = (_np(got) * TL.envmap_dirs(4, 8)[1]).sum(-1)
    assert (cos > np.cos(np.pi / 4)).all()


# ----------------------------------------------------------- the field


def test_update_alpha_mask_matches_jax():
    jcfg = relight_cfg()
    jp, js = jax_field(jcfg)
    tp, ts = port_field(jp, js)
    j_scene, j_aabb = JLC.update_alpha_mask(jcfg, jp, js, GRID)
    t_scene, t_aabb = TLC.update_alpha_mask(port_cfg(jcfg), tp, ts, GRID)
    np.testing.assert_array_equal(t_aabb, j_aabb)
    for k in ("alpha_volume", "alpha_volume_dilated", "alpha_volume_packed",
              "alpha_aabb", "has_alpha_mask"):
        assert t_scene[k].dtype == {"alpha_volume_dilated": torch.uint8,
                                    "alpha_volume_packed": torch.bfloat16
                                    }.get(k, torch.float32), k
        np.testing.assert_array_equal(
            t_scene[k].float().numpy(), np.asarray(j_scene[k], np.float32),
            err_msg=k)
    vol = t_scene["alpha_volume"].numpy()
    assert 0 < vol.sum() < vol.size
    assert TLC.voxel_schedule(128 ** 3, 300 ** 3, 4) == JLC.voxel_schedule(
        128 ** 3, 300 ** 3, 4)


def test_derived_normals_and_their_double_backward_match_jax(masked):
    jcfg, jp, _ = masked
    tp, _ = port_field(jp, {})
    rng = np.random.default_rng(2)
    coords = rng.uniform(-0.6, 0.6, size=(150, 3)).astype(np.float32)
    up = rng.normal(size=(150, 3)).astype(np.float32)

    def j_loss(p):
        return jnp.sum(JF.derived_normals(jcfg, p, jnp.asarray(coords)) * up)

    jn = JF.derived_normals(jcfg, jp, jnp.asarray(coords))
    jg = jax.jit(jax.grad(j_loss))(jp)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in tp.items() if k.startswith("density")}
    tn = TF.derived_normals(port_cfg(jcfg), leaves, t(coords))
    np.testing.assert_allclose(_np(tn), np.asarray(jn), **NRM)
    (tn * t(up)).sum().backward()
    for k, v in leaves.items():
        np.testing.assert_allclose(_np(v.grad), np.asarray(jg[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    # without grad mode the normals are the same and build no graph
    with torch.no_grad():
        tn0 = TF.derived_normals(port_cfg(jcfg), leaves, t(coords))
    assert not tn0.requires_grad
    np.testing.assert_array_equal(_np(tn0), _np(tn))


# ---------------------------------------------------------- render_rays

_j_render = jax.jit(
    _j_render_rays, static_argnums=0,
    static_argnames=("n_samples", "is_train", "is_relight", "white_bg",
                     "app_cap", "march_cap", "march_select"))

MAP_KEYS = ("rgb_map", "depth_map", "acc_map", "normal_map", "albedo_map",
            "roughness_map", "fresnel_map", "normals_diff_map",
            "normals_orientation_loss_map", "albedo_smoothness_loss",
            "roughness_smoothness_loss", "acc_mask", "march_overflow_frac")


@pytest.mark.parametrize("normals_kind,march_select", [
    ("derived_plus_predicted", "scatter"),
    ("derived_plus_predicted", "topk"),
    ("purely_predicted", "scatter"),
    ("purely_derived", "scatter")])
def test_render_rays_relight_matches_jax(masked, normals_kind, march_select):
    jcfg0, jp, js = masked
    jcfg = relight_cfg(normals_kind=normals_kind)
    tp, ts = port_field(jp, js)
    r = rays(B, seed=4)
    lidx = np.zeros((B,), np.int32)
    kw = dict(n_samples=S, key=None, is_relight=True, white_bg=True,
              app_cap=8, march_cap=MARCH_CAP, march_select=march_select)
    jout = _j_render(jcfg, jp, js, jnp.asarray(r), jnp.asarray(lidx), **kw)
    tout = t_render_rays(port_cfg(jcfg), tp, ts, t(r), t(lidx, torch.int32),
                         **kw)
    acc = np.asarray(jout["acc_map"])
    assert (acc > 0.5).any() and (acc < 0.5).any()   # blob and background
    assert set(tout) == set(MAP_KEYS)
    for k in MAP_KEYS:
        np.testing.assert_allclose(_np(tout[k]).astype(np.float32),
                                   np.asarray(jout[k], np.float32),
                                   err_msg=k, **MAPS)


def test_culled_march_matches_the_dense_march(masked):
    """With a cap above every ray's occupied count the culled march is the
    dense march (the cull keeps a superset of the masked samples)."""
    jcfg, jp, js = masked
    tp, ts = port_field(jp, js)
    r = rays(B, seed=5)
    lidx = t(np.zeros((B,), np.int32), torch.int32)
    kw = dict(n_samples=S, key=None, is_relight=False, app_cap=8)
    dense = t_render_rays(port_cfg(jcfg), tp, ts, t(r), lidx, **kw)
    culled = t_render_rays(port_cfg(jcfg), tp, ts, t(r), lidx,
                           march_cap=S - 1, **kw)
    assert float(culled["march_overflow_frac"]) == 0.0
    for k in ("rgb_map", "depth_map", "acc_map"):
        np.testing.assert_allclose(_np(culled[k]), _np(dense[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


# ------------------------------------------------------------ the step

def _step_kw():
    return dict(n_samples=S, is_relight=True, white_bg=True, app_cap=8,
                march_cap=MARCH_CAP, deterministic=True, **RELIGHT)


def _weights():
    return dict(l1=4e-5, rgb_brdf=0.2, normals_diff=5e-4, normals_ori=1e-3,
                albedo_sm=1e-3, rough_sm=1e-3, lr_factor=0.99997,
                n_iters=80000, relight_start=10000)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (rays(B, seed=seed), np.zeros((B,), np.int32),
            rng.uniform(0, 1, (B, 3)).astype(np.float32))


def test_compute_loss_relight_matches_jax(masked):
    jcfg, jp, js = masked
    tp, ts = port_field(jp, js)
    r, lidx, rgbs = _batch(6)
    st, w = _step_kw(), _weights()
    w["rgb_brdf_warmup_iters"] = 100
    j_loss = jax.jit(JS.compute_loss, static_argnums=(0, 6, 7))
    jl, jm = j_loss(jcfg, jp, js, {"rays": jnp.asarray(r),
                                   "rgbs": jnp.asarray(rgbs),
                                   "light_idx": jnp.asarray(lidx)},
                    None, jnp.asarray(10040), JS.StepStatic(**st),
                    JS.LossWeights(**w))
    tl, tm = TS.compute_loss(port_cfg(jcfg), tp, ts,
                             {"rays": t(r), "rgbs": t(rgbs),
                              "light_idx": t(lidx, torch.int32)},
                             None, 10040, TS.StepStatic(**st),
                             TS.LossWeights(**w))
    assert set(tm) == set(jm)
    assert {"loss_rgb_brdf", "loss_normals_diff", "loss_normals_ori",
            "loss_rough_sm", "loss_albedo_sm", "n_acc_masked",
            "march_overflow_frac"} <= set(tm)
    assert 0 < float(tm["n_acc_masked"]) < B
    for k in tm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   rtol=1e-4, atol=1e-9, err_msg=k)


def test_three_relight_train_steps_match_jax(masked):
    jcfg, jp, js = masked
    tp, ts = port_field(jp, js)
    lr_factor = JO.decay_factor(0.1, 80000, 80000)
    st, w = _step_kw(), _weights()
    jopt = JO.make_optimizer(jp, 0.02, 1e-3, lr_factor, lr_light=1e-3)
    jstate = jopt.init(jp)
    jstep = JS.make_train_step(jcfg, jopt, JS.StepStatic(**st),
                               JS.LossWeights(**w), donate=False)
    topt = TO.make_optimizer(tp, 0.02, 1e-3, lr_factor, lr_light=1e-3)
    tstate = topt.init(tp)
    tstep = TS.make_train_step(port_cfg(jcfg), topt, TS.StepStatic(**st),
                               TS.LossWeights(**w), device="cpu")
    key = jax.random.PRNGKey(0)
    for it in range(10000, 10003):
        r, lidx, rgbs = _batch(it)
        jp, jstate, jm = jstep(jp, jstate, js,
                               {"rays": jnp.asarray(r),
                                "rgbs": jnp.asarray(rgbs),
                                "light_idx": jnp.asarray(lidx)},
                               key, jnp.asarray(it))
        tp, tstate, tm = tstep(tp, tstate, ts,
                               {"rays": r, "rgbs": rgbs, "light_idx": lidx},
                               None, it)
        for k in ("total_loss", "loss_rgb", "loss_rgb_brdf",
                  "loss_normals_diff", "loss_normals_ori", "loss_albedo_sm",
                  "loss_rough_sm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, err_msg=f"step {it} {k}")
        assert_tree_close(tp, jp, rtol=0, atol=1e-4)
    # the relight losses reach the BRDF and normal MLPs and the light
    for name in ("brdf_mlp/w1", "normal_mlp/w1", "lgt_sgs"):
        assert float(tstate["mu"][name].abs().max()) > 0.0, name
