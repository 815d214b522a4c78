"""Shared set-up of the tests that hold tensoir_tpu_torch against
tensoir_tpu: one small field made by the JAX package, carried over to the
port as numpy arrays, and rays aimed at a solid blob in it."""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tensoir_tpu.models import field as JF
from tensoir_tpu.models import lifecycle as JLC
from tensoir_tpu.render.primary import render_rays as _j_render_rays
from tensoir_tpu.utils.bench_scene import seed_solid_blob
from tensoir_tpu_torch.models import field as TF
from tensoir_tpu_torch.render.secondary import SecondaryKnobs
from tensoir_tpu_torch.weights import params_from_numpy

AABB = np.array([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]], np.float32)


def small_cfg(**kw) -> JF.FieldConfig:
    base = dict(density_n_comp=(4, 4, 4), app_n_comp=(6, 6, 6), app_dim=8,
                feature_c=16, num_sgs=8, step_ratio=0.5)
    base.update(kw)
    return JF.FieldConfig(**base)


def port_cfg(jcfg: JF.FieldConfig) -> TF.FieldConfig:
    return TF.FieldConfig(**dataclasses.asdict(jcfg))


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


# jitted once per config and grid: eager JAX would compile every op of the
# init on its own, which takes seconds on the CPU
_init = jax.jit(JF.init_field_params, static_argnums=(1, 2))
_blob = jax.jit(lambda p: seed_solid_blob(dict(p), amp=4.0, sharp=0.2))


def _bump(n: int, sharp: float) -> np.ndarray:
    z = np.linspace(-1, 1, n)
    return np.exp(-(z ** 2) / sharp).astype(np.float32)


def seed_variant_blob(jcfg: JF.FieldConfig, params, amp: float = 4.0,
                      sharp: float = 0.2):
    """The solid blob of ``seed_solid_blob`` for the decompositions it
    does not know: on the first density channel of the stacked tensors
    (``vm_stacked``), or as a product of three line bumps (``cp``)."""
    params = dict(params)
    for i in range(3):
        if jcfg.decomp == "vm_stacked":
            a = jcfg.app_n_comp[i]
            g = params[f"stack_plane_{i}"]
            H, W, _ = g.shape
            bump = np.outer(_bump(H, sharp), _bump(W, sharp))
            params[f"stack_plane_{i}"] = g.at[..., a].add(amp * bump)
            ln = params[f"stack_line_{i}"]
            params[f"stack_line_{i}"] = ln.at[:, a].add(
                _bump(ln.shape[0], sharp))
        else:
            ln = params[f"density_line_{i}"]
            params[f"density_line_{i}"] = ln.at[:, 0].add(
                amp * _bump(ln.shape[0], sharp))
    return params


def jax_field(jcfg: JF.FieldConfig, grid=(24, 20, 16), seed: int = 0,
              blob: bool = True):
    """(params, scene) of the JAX package, with a solid blob seeded."""
    params, scene = _init(jax.random.PRNGKey(seed), jcfg, tuple(grid), AABB)
    if blob:
        params = (_blob(params) if jcfg.decomp == "vm"
                  else seed_variant_blob(jcfg, params))
    return params, scene


def masked_jax_field(grid=(24, 20, 16), **kw):
    """(cfg, params, scene) of the JAX package: the blob field of
    ``small_cfg(envmap_h=4, envmap_w=8, **kw)``, its scene masked by JAX's
    ``update_alpha_mask`` at the field's grid."""
    jcfg = small_cfg(envmap_h=4, envmap_w=8, **kw)
    jp, js = jax_field(jcfg, grid=grid)
    js, _ = JLC.update_alpha_mask(jcfg, jp, js, grid)
    return jcfg, jp, js


def as_np(x) -> np.ndarray:
    """A torch tensor or a JAX array as numpy, bf16 read as f32."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


j_render_rays = jax.jit(
    _j_render_rays, static_argnums=0,
    static_argnames=("n_samples", "is_train", "is_relight", "white_bg",
                     "app_cap"))


def port_field(params, scene):
    """The port's copy, on the CPU."""
    return params_from_numpy(to_numpy(params), to_numpy(scene), device="cpu")


def rays(batch: int, seed: int = 0, spread: float = 0.25) -> np.ndarray:
    """[batch, 6] rays from z = -4 towards the box, spread wide enough that
    some miss the blob and a few miss the box."""
    rng = np.random.default_rng(seed)
    o = np.zeros((batch, 3), np.float32)
    o[:, :2] = rng.uniform(-0.6, 0.6, size=(batch, 2))
    o[:, 2] = -4.0
    d = rng.normal(size=(batch, 3)).astype(np.float32) * spread
    d[:, 2] = 1.0
    return np.concatenate([o, d], -1).astype(np.float32)


def assert_tree_close(t_tree, j_tree, rtol, atol, path=""):
    """Every tensor of the port's tree against the JAX tree's array."""
    for k, v in t_tree.items():
        if isinstance(v, dict):
            assert_tree_close(v, j_tree[k], rtol, atol, f"{path}{k}/")
            continue
        np.testing.assert_allclose(
            v.detach().cpu().float().numpy(), np.asarray(j_tree[k], np.float32),
            rtol=rtol, atol=atol, err_msg=f"{path}{k}")


# the JAX package's ``secondary_shading_tiled`` keywords -> the fields of
# the port's ``SecondaryKnobs``
TILED_NAMES = dict(
    n_sample="second_n_sample", vis_near="second_near", vis_far="second_far",
    tile="secondary_tile", app_cap="second_app_cap",
    march_cap="second_march_cap", use_baked="secondary_use_baked",
    bake_reso="secondary_bake_reso", window="second_window",
    window_back="second_window_back", prepass_n="second_prepass_n",
    coarse_dilate="coarse_dilate", compact_frac="secondary_compact_frac",
    march_group="second_march_group", group_bake_reso="group_bake_reso",
    app_bake_reso="app_bake_reso", app_hoist="secondary_app_hoist",
    app_pair_frac="app_pair_frac", return_stats="secondary_stats",
    window_probe="second_window_probe",
    window_probe_back="second_window_probe_back")


def tiled_knobs(**kw) -> SecondaryKnobs:
    """The port's knobs of JAX's ``secondary_shading_tiled`` keywords."""
    return SecondaryKnobs(**{TILED_NAMES[k]: v for k, v in kw.items()})


def split_knobs(kw: dict):
    """(the other keywords, ``SecondaryKnobs``) of keywords given to JAX's
    ``render_with_brdf`` or ``render_train_batch``, which name the march's
    knobs as the port's fields do."""
    fields = {f.name for f in dataclasses.fields(SecondaryKnobs)}
    return ({k: v for k, v in kw.items() if k not in fields},
            SecondaryKnobs(**{k: v for k, v in kw.items() if k in fields}))


def t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x)).to(dtype)


@pytest.fixture(scope="module")
def one_torch_thread():
    """One intra-op thread for the module's port calls: at these sizes
    torch's default threads (one per core) cost more in their hand-offs
    than they save when the test workers share the cores (a tiny CLI run
    took 154 s at 8 threads and 6.6 s at 1)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
