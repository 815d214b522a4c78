"""The port's rendering variants against the JAX package's, on the CPU:
``render_rays`` for each shading mode, each normals kind, the NDC march,
bf16 compute and both new decompositions, the ground-truth normals in the
training renderer, and the NDC ray helpers. (The light samplers and
estimators: test_torch_variants_light.py.)

Same field (JAX's, blob seeded, masked by its ``update_alpha_mask``,
carried over as numpy), same rays, the deterministic path. Tolerances:
- render maps 2e-5 relative and 2e-6 absolute (test_torch_relight.py's:
  the same arithmetic summed in other orders);
- bf16 maps against JAX's bf16 path 2e-3 absolute: both round the same
  f32 operands to bf16, but an operand that the two f32 paths put within
  an ulp of a bf16 rounding boundary rounds to neighbouring bf16 values
  (7.8e-3 apart relative) and moves what follows it; and within
  tests/test_bf16.py's 0.03 of the f32 render.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoir_tpu.ops import rays as JR
from tensoir_tpu.render.primary import render_rays as _j_render_rays
from tensoir_tpu.render.train_render import \
    render_train_batch as _j_render_train

from tensoir_tpu_torch.ops import rays as TR
from tensoir_tpu_torch.render.primary import render_rays as t_render_rays
from tensoir_tpu_torch.render.train_render import \
    render_train_batch as t_render_train

from torch_parity import (as_np, masked_jax_field,  # noqa: F401
                          one_torch_thread, port_cfg, port_field, rays,
                          small_cfg, split_knobs, t)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MAPS = dict(rtol=2e-5, atol=2e-6)
B, S, MARCH_CAP = 48, 48, 24

_j_render = jax.jit(
    _j_render_rays, static_argnums=0,
    static_argnames=("n_samples", "is_train", "is_relight", "white_bg",
                     "app_cap", "march_cap", "ndc_ray"))


def _render_both(jcfg, jp, js, r, is_relight, **kw):
    tp, ts = port_field(jp, js)
    lidx = np.zeros((r.shape[0],), np.int32)
    args = dict(n_samples=S, key=None, is_relight=is_relight, white_bg=True,
                app_cap=8, march_cap=MARCH_CAP, **kw)
    jout = _j_render(jcfg, jp, js, jnp.asarray(r), jnp.asarray(lidx), **args)
    tout = t_render_rays(port_cfg(jcfg), tp, ts, t(r), t(lidx, torch.int32),
                         **args)
    assert set(tout) == set(jout)
    acc = np.asarray(jout["acc_map"])
    assert (acc > 0.5).any() and (acc < 0.5).any()   # blob and background
    return tout, jout


def _assert_maps(tout, jout, **tol):
    for k in jout:
        np.testing.assert_allclose(as_np(tout[k]), as_np(jout[k]), err_msg=k,
                                   **(tol or MAPS))


@pytest.mark.parametrize("shading", ["MLP_PE", "MLP", "SH", "RGB"])
def test_render_rays_of_each_shading_mode_match_jax(shading):
    """The radiance pass with each shader: MLP_PE reads the points' PE, MLP
    the view PE only, SH degree-2 coefficients (27 features), RGB the
    features themselves (3)."""
    app_dim = {"SH": 27, "RGB": 3}.get(shading, 8)
    jcfg, jp, js = masked_jax_field(shading_mode=shading, app_dim=app_dim)
    assert ("render_mlp" in jp) == shading.startswith("MLP")
    tout, jout = _render_both(jcfg, jp, js, rays(B, seed=1), False)
    _assert_maps(tout, jout)


@pytest.mark.parametrize("decomp,normals", [
    ("vm", "residue_prediction"), ("vm", "gt_normals"),
    ("cp", "derived_plus_predicted"), ("vm_stacked", "purely_derived")])
def test_render_rays_relight_of_each_variant_matches_jax(decomp, normals):
    """The relight pass of each normals kind (the residue MLP reads the
    derived normal; gt_normals leaves zeros for the renderer to replace)
    and of each new decomposition."""
    jcfg, jp, js = masked_jax_field(decomp=decomp, normals_kind=normals)
    tout, jout = _render_both(jcfg, jp, js, rays(B, seed=4), True)
    if normals == "gt_normals":
        # the map is (1 - acc) (0, 0, 1) normalised: where 1 - acc comes
        # near the normalisation's eps (1e-6) it is 1 - acc's rounding
        # over 1e-6, so it is held where 1 - acc > 1e-5
        far = 1.0 - as_np(jout["acc_map"]) > 1e-5
        np.testing.assert_allclose(as_np(tout["normal_map"])[far],
                                   as_np(jout["normal_map"])[far], **MAPS)
        tout = {k: v for k, v in tout.items() if k != "normal_map"}
        jout = {k: v for k, v in jout.items() if k != "normal_map"}
    _assert_maps(tout, jout)
    if normals == "residue_prediction":
        assert float(np.abs(as_np(jout["normals_diff_map"])).max()) > 0


def test_gt_normals_replace_the_normal_map_in_the_train_renderer():
    """render_train_batch puts the batch's normal_gt in place of the
    normal map before the relight pass, as JAX's does."""
    jcfg, jp, js = masked_jax_field(normals_kind="gt_normals")
    tp, ts = port_field(jp, js)
    r = rays(B, seed=5)
    lidx = np.zeros((B,), np.int32)
    ngt = np.random.default_rng(5).normal(size=(B, 3)).astype(np.float32)
    ngt /= np.linalg.norm(ngt, axis=-1, keepdims=True)
    kw = dict(n_samples=S, is_relight=True, white_bg=True, app_cap=8,
              march_cap=MARCH_CAP, relight_ray_cap=16, second_n_sample=8,
              secondary_tile=256, second_app_cap=4)
    j_train = jax.jit(_j_render_train, static_argnums=0,
                      static_argnames=tuple(kw) + ("is_train",))
    jout = j_train(jcfg, jp, js, jnp.asarray(r), jnp.asarray(lidx), key=None,
                   is_train=False, normal_gt=jnp.asarray(ngt), **kw)
    rest, sec = split_knobs(kw)
    tout = t_render_train(port_cfg(jcfg), tp, ts, t(r), t(lidx, torch.int32),
                          key=None, is_train=False, normal_gt=t(ngt), **rest,
                          secondary=sec)
    np.testing.assert_array_equal(as_np(tout["normal_map"]), ngt)
    for k in ("rgb_with_brdf_map", "rgb_map", "normal_map"):
        np.testing.assert_allclose(as_np(tout[k]), as_np(jout[k]), err_msg=k,
                                   **MAPS)


def test_ndc_ray_helpers_match_jax():
    """sample_ray_ndc (deterministic, and with JAX's jitter draws) and the
    Blender NDC warp."""
    rng = np.random.default_rng(8)
    o = rng.uniform(-0.5, 0.5, (16, 3)).astype(np.float32)
    d = rng.normal(size=(16, 3)).astype(np.float32)
    d[:, 2] = 1.5
    aabb = np.array([[-1, -1, -1], [1, 1, 1]], np.float32)
    key = jax.random.PRNGKey(3)
    for k in (None, key):
        jx, jz, jv = JR.sample_ray_ndc(jnp.asarray(o), jnp.asarray(d),
                                       jnp.asarray(aabb), 0.0, 1.0, 24,
                                       key=k)
        jit = (None if k is None else
               t(np.asarray(jax.random.uniform(k, (16, 24)))))
        tx, tz, tv = TR.sample_ray_ndc(t(o), t(d), t(aabb), 0.0, 1.0, 24,
                                       jitter=jit)
        np.testing.assert_allclose(as_np(tx), as_np(jx), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(as_np(tz), as_np(jz), rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    jo, jd = JR.ndc_rays_blender(800, 800, 1111.1, 1.0, jnp.asarray(o),
                                 jnp.asarray(d))
    to, td = TR.ndc_rays_blender(800, 800, 1111.1, 1.0, t(o), t(d))
    np.testing.assert_allclose(as_np(to), as_np(jo), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(as_np(td), as_np(jd), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("is_relight", [False, True])
def test_render_rays_ndc_matches_jax(is_relight):
    """The NDC march (uniform z in [near, far], dists times the ray's norm,
    view directions normalized) on unnormalized rays."""
    jcfg, jp, js = masked_jax_field(near_far=(1.5, 3.5))
    r = rays(B, seed=6)
    r[:, 3:] *= 1.7
    tout, jout = _render_both(jcfg, jp, js, r, is_relight, ndc_ray=True)
    _assert_maps(tout, jout)


def test_render_rays_bf16_matches_jax_and_f32():
    """bf16 compute: against JAX's bf16 render, and within
    tests/test_bf16.py's 0.03 of the f32 render."""
    jcfg16, jp, js = masked_jax_field(compute_dtype="bfloat16")
    tout, jout = _render_both(jcfg16, jp, js, rays(B, seed=7), True)
    _assert_maps(tout, jout, rtol=0, atol=2e-3)
    t32, _ = _render_both(small_cfg(envmap_h=4, envmap_w=8), jp, js,
                          rays(B, seed=7), True)
    np.testing.assert_allclose(as_np(tout["rgb_map"]), as_np(t32["rgb_map"]),
                               atol=0.03)
    assert not np.array_equal(as_np(tout["rgb_map"]), as_np(t32["rgb_map"]))
