"""One training step with each grouped knob, and with all of them at once,
against the JAX package's step, on the CPU: the grouped primary march
(``march_group`` 2 and 4), the grouped secondary march
(``second_march_group`` 2, and 4 on a coarser ``group_bake_reso``), the
hoisted app stage (``secondary_app_hoist``), and everything together, on
``bench.py``'s fast-knob step at a small size (grid 32, 128 rays, 4 x 8
directions, window 12/4 of 24 secondary samples, tile 512).

Tolerances, f32 on the CPU: every metric of the step (the total loss, its
terms, the overflow fraction) 1e-4 relative; each parameter's gradient,
read from Adam's first moment after the step, 1e-4 relative in the L2 norm
(the worst is 2.7e-5: sums over every sample of the double backward of the
derived normals, in another order). And the JAX identity: each grouped
step's loss equals the ungrouped step's to 1e-4 relative, where both bake
the same grid.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tensoir_tpu.models import field as JF
from tensoir_tpu.models import lifecycle as JLC
from tensoir_tpu.train import optim as JO
from tensoir_tpu.train import step as JS
from tensoir_tpu.utils.bench_scene import bench_rays, seed_solid_blob

from tensoir_tpu_torch.render import secondary as TSec
from tensoir_tpu_torch.train import optim as TO
from tensoir_tpu_torch.train import step as TS

from torch_parity import (AABB, one_torch_thread,  # noqa: F401
                          port_cfg, port_field)

B = 128
STATIC = dict(n_samples=64, is_relight=True, white_bg=True, app_cap=16,
              relight_ray_cap=B, march_cap=32, march_select="scatter",
              second_march_cap=16, secondary_use_baked=True,
              secondary_bake_reso=24, second_window=12, second_window_back=4,
              second_prepass_n=8, coarse_dilate=3,
              secondary_compact_frac=0.5625, app_bake_reso=16,
              second_app_cap=8, app_pair_frac=0.4375, second_n_sample=24,
              secondary_tile=512, deterministic=True)
WEIGHTS = dict(ortho=0.0, l1=4e-5, tv_density=0.0, tv_app=0.0,
               lr_factor=0.999971, n_iters=80000, relight_start=10000)
# the contracts: (g-1) * step_ratio 0.5 <= 2 cells; a secondary group's
# span (g-1) * 1.45 / 23 within a bake cell, 3 / 23 at 24 nodes (g 2) or
# 3 / 11 at 12 (g 4); the windows 8 + 4 divide by 2 and 4
KNOBS = {
    "march_group_2": dict(march_group=2),
    "march_group_4": dict(march_group=4),
    "second_march_group_2": dict(second_march_group=2),
    "second_march_group_4_group_bake": dict(second_march_group=4,
                                            group_bake_reso=12),
    "secondary_app_hoist": dict(secondary_app_hoist=True),
    "all": dict(march_group=4, second_march_group=4, group_bake_reso=12,
                secondary_app_hoist=True),
}


@pytest.fixture(scope="module")
def field():
    jcfg = JF.FieldConfig(density_n_comp=(4, 4, 4), app_n_comp=(6, 6, 6),
                          app_dim=8, feature_c=16, envmap_h=4, envmap_w=8,
                          num_sgs=16, step_ratio=0.5)
    jp, js = jax.jit(JF.init_field_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jcfg, (32, 32, 32), AABB)
    jp = jax.jit(seed_solid_blob)(jp)
    js, _ = JLC.update_alpha_mask(jcfg, jp, js, (24, 24, 24))
    batch = {"rays": bench_rays(B), "rgbs": np.full((B, 3), 0.5, np.float32),
             "light_idx": np.zeros((B,), np.int32)}
    return jcfg, jp, js, batch


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


def _port_step(jcfg, jp, js, batch, st):
    tp, ts = port_field(jp, js)
    topt = TO.make_optimizer(tp, 0.02, 1e-3, 0.999971)
    tstep = TS.make_train_step(port_cfg(jcfg), topt, TS.StepStatic(**st),
                               TS.LossWeights(**WEIGHTS), device="cpu")
    _, state, metrics = tstep(tp, topt.init(tp), ts, batch, None, 10000)
    return state, metrics


@pytest.mark.parametrize("knob", list(KNOBS))
def test_grouped_step_matches_jax(field, knob, one_torch_thread):
    jcfg, jp, js, batch = field
    st = dict(STATIC, **KNOBS[knob])
    jopt = JO.make_optimizer(jp, 0.02, 1e-3, 0.999971)
    jstep = JS.make_train_step(jcfg, jopt, JS.StepStatic(**st),
                               JS.LossWeights(**WEIGHTS), donate=False)
    _, jstate, jm = jstep(jp, jopt.init(jp), js,
                          {k: jnp.asarray(v) for k, v in batch.items()},
                          jax.random.PRNGKey(1), jnp.asarray(10000))
    TSec.reset_march_counts()
    tstate, tm = _port_step(jcfg, jp, js, batch, st)
    # 128 relit rays x 32 directions compacted into 5 tiles of 512
    assert TSec.MARCHED == {"pairs": 2560, "tiles": 5, "skipped": 0}
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    assert float(jm["n_acc_masked"]) > B // 2      # most rays hit the blob
    jg = _jax_mu(jstate)
    assert set(jg) == set(tstate["mu"])
    g_rel = {k: np.linalg.norm(tstate["mu"][k].numpy() - g)
             / np.linalg.norm(g) for k, g in jg.items()}
    assert max(g_rel.values()) <= 1e-4, g_rel
    print(f"{knob}: worst gradient {max(g_rel.values()):.1e} relative")
    if "group_bake_reso" in st:
        return   # its 27-corner pack is baked coarser: another proxy
    # the JAX identity: the grouped step's loss is the ungrouped one's
    _, plain = _port_step(jcfg, jp, js, batch, STATIC)
    np.testing.assert_allclose(float(tm["total_loss"]),
                               float(plain["total_loss"]), rtol=1e-4)
