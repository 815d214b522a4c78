"""Shared set-up of the tests that hold tensoir_tpu_torch against
tensoir_tpu: one small field made by the JAX package, carried over to the
port as numpy arrays, and rays aimed at a solid blob in it."""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

from tensoir_tpu.models import field as JF
from tensoir_tpu.render.primary import render_rays as _j_render_rays
from tensoir_tpu.utils.bench_scene import seed_solid_blob
from tensoir_tpu_torch.models import field as TF
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


def jax_field(jcfg: JF.FieldConfig, grid=(24, 20, 16), seed: int = 0,
              blob: bool = True):
    """(params, scene) of the JAX package, with a solid blob seeded."""
    params, scene = _init(jax.random.PRNGKey(seed), jcfg, tuple(grid), AABB)
    if blob:
        params = _blob(params)
    return params, scene


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


def t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x)).to(dtype)
