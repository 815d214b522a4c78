"""The port's training step on the model variants against the JAX
package's, on the CPU: ``compute_loss`` and every gradient for TensorCP,
the stacked TensorVM, the importance and equal-area light samplers and
bf16 compute; and a launched rank without a card refused rather than moved
to the CPU. (The eval and the CLI of the variants:
test_torch_variants_eval.py.)

Deterministic steps (no jitter, the fixed lat-long directions: with no key
the importance sampler falls back to them, with its estimator and with
the hemisphere compaction forced off; the equal-area estimator is the 4 pi
mean over them). Tolerances, f32 on the CPU:
- losses 1e-4 relative, gradients 1e-4 relative and 1e-5 absolute
  (test_torch_relight.py's: sums over every point of two backward passes
  through the derived normals);
- bf16: losses 1e-3 relative and gradients 1e-2 relative in the L2 norm of
  each parameter: the operands of every product are rounded to bf16 on
  both sides, and the f32 values the two packages round differ in their
  last bits, so a few operands round to neighbouring bf16 values (7.8e-3
  apart relative).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoir_tpu.train import step as JS

from tensoir_tpu_torch.parallel import multihost
from tensoir_tpu_torch.train import step as TS

from torch_parity import (masked_jax_field, one_torch_thread,  # noqa: F401
                          port_cfg, port_field, rays, t)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, S = 48, 48


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return out


@pytest.mark.parametrize("variant", [
    dict(decomp="cp"), dict(decomp="vm_stacked"),
    dict(sample_method="importance_sample"),
    dict(sample_method="stratifed_sample_equal_areas"),
    dict(compute_dtype="bfloat16")], ids=lambda v: next(iter(v.values())))
def test_compute_loss_and_every_gradient_match_jax(variant):
    """The relight step's loss terms and the gradient of every parameter."""
    variant = dict(variant)
    method = variant.pop("sample_method", "stratified_sampling")
    jcfg, jp, js = masked_jax_field(**variant)
    tp, ts = port_field(jp, js)
    rng = np.random.default_rng(3)
    r = rays(B, seed=3)
    lidx = np.zeros((B,), np.int32)
    rgbs = rng.uniform(0, 1, (B, 3)).astype(np.float32)
    st = dict(n_samples=S, is_relight=True, white_bg=True, app_cap=8,
              march_cap=24, deterministic=True, sample_method=method,
              relight_ray_cap=16, second_n_sample=16, secondary_tile=256,
              second_app_cap=8, secondary_compact_frac=0.5625)
    w = dict(ortho=1e-3, l1=4e-5, tv_density=0.05, tv_app=0.005,
             rgb_brdf=0.2, normals_diff=5e-4, normals_ori=1e-3,
             albedo_sm=1e-3, rough_sm=1e-3, lr_factor=0.99997,
             n_iters=80000, relight_start=10000)

    def j_loss(p):
        return JS.compute_loss(jcfg, p, js, {
            "rays": jnp.asarray(r), "rgbs": jnp.asarray(rgbs),
            "light_idx": jnp.asarray(lidx)}, None, jnp.asarray(10040),
            JS.StepStatic(**st), JS.LossWeights(**w))

    (jl, jm), jg = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(jp)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in _flat(tp).items()}
    tl, tm = TS.compute_loss(port_cfg(jcfg), _nest(leaves), ts,
                             {"rays": t(r), "rgbs": t(rgbs),
                              "light_idx": t(lidx, torch.int32)},
                             None, 10040, TS.StepStatic(**st),
                             TS.LossWeights(**w))
    names = list(leaves)
    grads = torch.autograd.grad(tl, [leaves[k] for k in names],
                                allow_unused=True)
    assert set(tm) == set(jm)
    assert 0 < float(tm["n_acc_masked"]) < B
    bf16 = jcfg.compute_dtype == "bfloat16"
    for k in tm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   rtol=1e-3 if bf16 else 1e-4, atol=1e-9,
                                   err_msg=k)
    jflat = _flat(jg)
    assert set(jflat) == set(names)
    for k, g in zip(names, grads):
        want = np.asarray(jflat[k])
        got = np.zeros_like(want) if g is None else g.numpy()
        if bf16:
            err = np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30)
            assert err <= 1e-2, (k, err)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                       err_msg=k)
    for k in ("basis_mat", "brdf_mlp/w1", "lgt_sgs"):
        assert np.abs(np.asarray(jflat[k])).max() > 0, k


def test_launched_rank_without_a_card_is_refused(monkeypatch):
    """A process under the launcher that passes no device is put on its
    card, cuda:LOCAL_RANK; without CUDA it raises instead of joining the
    group on gloo and the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"),
                 ("MASTER_ADDR", "localhost"), ("MASTER_PORT", "29500")):
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multihost.initialize()
    assert not torch.distributed.is_initialized()
