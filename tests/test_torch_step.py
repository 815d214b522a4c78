"""The port's radiance-phase step against the JAX package's, on the CPU.

Same field (made by tensoir_tpu, carried over as numpy), same rays, the
deterministic path (no jitter, white background). Tolerances, f32 on the
CPU: render outputs 2e-5 relative (the sums run in another order), loss
1e-5, parameters after three Adam steps 1e-4 absolute (Adam's first step
moves each element by about lr * sign(grad), so a gradient's rounding
shows in the parameter only through its sign, and the tolerance is well
under the smallest step, 1e-3).
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoir_tpu import config as JC
from tensoir_tpu.models import lifecycle as JLC
from tensoir_tpu.train import optim as JO
from tensoir_tpu.train import step as JS
from tensoir_tpu.train.loop import field_config_from as j_field_config_from

from tensoir_tpu_torch import config as TC
from tensoir_tpu_torch.models import field as TF
from tensoir_tpu_torch.models import lifecycle as TLC
from tensoir_tpu_torch.render.primary import render_rays as t_render_rays
from tensoir_tpu_torch.train import optim as TO
from tensoir_tpu_torch.train import step as TS

from torch_parity import (AABB, assert_tree_close, j_render_rays, jax_field,
                          port_cfg, port_field, rays, small_cfg, t)

B, S = 64, 48


def _inputs(seed=0):
    r = rays(B, seed=seed)
    lidx = np.zeros((B,), np.int32)
    rgbs = np.random.default_rng(seed + 1).uniform(
        0, 1, (B, 3)).astype(np.float32)
    return r, lidx, rgbs


@pytest.mark.parametrize("app_cap", [8, 0])
def test_render_rays_matches_jax(app_cap):
    jcfg = small_cfg()
    jp, js = jax_field(jcfg)
    tp, ts = port_field(jp, js)
    r, lidx, _ = _inputs()
    jout = j_render_rays(jcfg, jp, js, jnp.asarray(r), jnp.asarray(lidx),
                         n_samples=S, key=None, is_relight=False,
                         white_bg=True, app_cap=app_cap)
    tout = t_render_rays(port_cfg(jcfg), tp, ts, t(r), t(lidx, torch.int32),
                         n_samples=S, key=None, is_relight=False,
                         white_bg=True, app_cap=app_cap)
    acc = np.asarray(jout["acc_map"])
    assert (acc > 0.5).any() and (acc < 0.5).any()   # blob and background
    for k in ("rgb_map", "depth_map", "acc_map"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   rtol=2e-5, atol=2e-6, err_msg=k)


def test_unported_paths_raise():
    jcfg = small_cfg()
    tp, ts = port_field(*jax_field(jcfg))
    r, lidx, _ = _inputs()
    for kw in (dict(is_relight=True), dict(march_cap=8),
               dict(march_group=2), dict(ndc_ray=True)):
        args = dict(n_samples=S, key=None, is_relight=False)
        args.update(kw)
        with pytest.raises(NotImplementedError):
            t_render_rays(port_cfg(jcfg), tp, ts, t(r),
                          t(lidx, torch.int32), **args)


def _weights(lr_factor):
    return dict(ortho=0.0, l1=8e-5, tv_density=0.05, tv_app=0.005,
                lr_factor=lr_factor, n_iters=80000, relight_start=10000)


def test_compute_loss_matches_jax():
    jcfg = small_cfg()
    jp, js = jax_field(jcfg)
    tp, ts = port_field(jp, js)
    r, lidx, rgbs = _inputs(3)
    st_kw = dict(n_samples=S, is_relight=False, white_bg=True, app_cap=8,
                 deterministic=True)
    w_kw = _weights(0.999)
    w_kw["ortho"] = 1e-3
    jb = {"rays": jnp.asarray(r), "rgbs": jnp.asarray(rgbs),
          "light_idx": jnp.asarray(lidx)}
    tb = {"rays": t(r), "rgbs": t(rgbs), "light_idx": t(lidx, torch.int32)}
    j_loss = jax.jit(JS.compute_loss, static_argnums=(0, 6, 7))
    jl, jm = j_loss(jcfg, jp, js, jb, None, jnp.asarray(5),
                    JS.StepStatic(**st_kw), JS.LossWeights(**w_kw))
    tl, tm = TS.compute_loss(port_cfg(jcfg), tp, ts, tb, None, 5,
                             TS.StepStatic(**st_kw), TS.LossWeights(**w_kw))
    assert set(tm) <= set(jm)
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)


def test_three_train_steps_match_jax():
    jcfg = small_cfg()
    jp, js = jax_field(jcfg)
    tp, ts = port_field(jp, js)
    lr_factor = JO.decay_factor(0.1, 80000, 80000)
    st_kw = dict(n_samples=S, is_relight=False, white_bg=True, app_cap=8,
                 deterministic=True)
    w_kw = _weights(lr_factor)
    jopt = JO.make_optimizer(jp, 0.02, 1e-3, lr_factor, lr_light=1e-3)
    jstate = jopt.init(jp)
    jstep = JS.make_train_step(jcfg, jopt, JS.StepStatic(**st_kw),
                               JS.LossWeights(**w_kw), donate=False)
    topt = TO.make_optimizer(tp, 0.02, 1e-3, lr_factor, lr_light=1e-3)
    tstate = topt.init(tp)
    tstep = TS.make_train_step(port_cfg(jcfg), topt, TS.StepStatic(**st_kw),
                               TS.LossWeights(**w_kw), device="cpu")
    key = jax.random.PRNGKey(0)
    for it in range(3):
        r, lidx, rgbs = _inputs(10 + it)
        jp, jstate, jm = jstep(jp, jstate, js,
                               {"rays": jnp.asarray(r),
                                "rgbs": jnp.asarray(rgbs),
                                "light_idx": jnp.asarray(lidx)},
                               key, jnp.asarray(it))
        tp, tstate, tm = tstep(tp, tstate, ts,
                               {"rays": r, "rgbs": rgbs, "light_idx": lidx},
                               None, it)
        for k in ("total_loss", "loss_rgb", "loss_l1", "loss_tv_density",
                  "loss_tv_app"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=f"step {it} {k}")
        assert_tree_close(tp, jp, rtol=0, atol=1e-4)
    # the Adam schedule: every group stepped three times
    assert tstate["count"] == {"spatial": 3, "network": 3, "light": 3}
    # a parameter the radiance loss does not reach stays where it was
    # (zero gradient, zero moments, zero update), as in JAX
    assert float(tstate["mu"]["brdf_mlp/w1"].abs().max()) == 0.0


@pytest.mark.parametrize("count", [0, 1, 79999])
def test_adam_schedule_matches_optax(count):
    """lr = base * f32(factor)**count, per group. XLA's f32 pow on the CPU
    is less exact than a correctly rounded one (1.5e-4 relative at count
    79999, against the double-precision power of the same f32 factor), so
    the port is held to the exact value at 1e-6 and to optax at 2e-4."""
    lr_factor = JO.decay_factor(0.1, 80000, 80000)
    opt = TO.make_optimizer({}, 0.02, 1e-3, lr_factor, lr_light=5e-4)
    for grp, base in (("spatial", 0.02), ("network", 1e-3), ("light", 5e-4)):
        exact = float(np.float32(base)) * float(np.float32(lr_factor)) ** count
        assert opt.lr(grp, count) == pytest.approx(exact, rel=1e-6)
        want = float(jnp.float32(base) * (lr_factor ** jnp.asarray(
            count, jnp.int32)))
        assert opt.lr(grp, count) == pytest.approx(want, rel=2e-4)
    for name in ("density_plane_0", "app_line_2", "basis_mat", "render_mlp",
                 "light_line", "lgt_sgs"):
        assert TO.param_group(name) == JO.param_group(name)


def test_config_and_slice_sizes_match_jax():
    path = (Path(__file__).resolve().parent.parent
            / "configs/single_light/armadillo.txt")
    jcfg, tcfg = JC.load_config(path), TC.load_config(path)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    near_far = (2.0, 6.0)
    assert (dataclasses.asdict(j_field_config_from(jcfg, near_far))
            == dataclasses.asdict(TC.field_config_from(tcfg, near_far)))
    # the grid and march length of the slice's first phase: 128^3 voxels
    # over a 3-wide box come out at 128 per axis, and 443 samples
    reso = TLC.n_to_reso(tcfg.N_voxel_init, AABB)
    assert reso == JLC.n_to_reso(jcfg.N_voxel_init, AABB) == (128, 128, 128)
    assert TLC.cal_n_samples(reso, 0.5) == JLC.cal_n_samples(reso, 0.5) == 443


def test_init_builds_the_jax_parameter_set():
    jcfg = small_cfg()
    jp, js = jax_field(jcfg, blob=False)
    gen = torch.Generator().manual_seed(0)
    tp, ts = TF.init_field_params(gen, port_cfg(jcfg), (24, 20, 16), AABB,
                                  device="cpu")

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict)
                else (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in tree.items()}
    assert shapes(tp) == shapes(jax.tree.map(np.asarray, jp))
    assert shapes(ts) == shapes(jax.tree.map(np.asarray, js))
