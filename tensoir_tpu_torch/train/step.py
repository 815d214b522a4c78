"""Training step: render -> losses -> gradients -> per-group Adam (port of
tensoir_tpu.train.step, for the radiance and the relight phase).

``LossWeights`` and ``StepStatic`` keep the JAX package's fields, so one
config drives both (``bench.py``'s fast-knob step, the grouped marches and
the global app stage included). The step runs eagerly on ``device``:
forward, backward, then the in-place Adam update.
With a ``parallel.Mesh`` of several processes, each rank renders its own
rays and the gradients are averaged over the group before the update.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from functools import cached_property
from typing import Dict, Optional

import numpy as np
import torch

from tensoir_tpu_torch.device import DeviceLike, resolve_device
from tensoir_tpu_torch.models import field as F
from tensoir_tpu_torch.parallel.mesh import Mesh, all_reduce_mean
from tensoir_tpu_torch.profiling import span
from tensoir_tpu_torch.render.secondary import SecondaryKnobs
from tensoir_tpu_torch.render.train_render import render_train_batch
from tensoir_tpu_torch.train import losses as L
from tensoir_tpu_torch.train.optim import GroupAdam, flatten


SEC_METRICS = ("sec/window_resid_rel", "sec/app_pair_overflow_frac",
               "sec/app_pair_occupancy", "sec/app_slot_occupancy",
               "sec/compact_overflow_frac", "sec/app_slot_demand_max",
               "sec/app_slot_overflow_pairs")


@dataclass(frozen=True)
class LossWeights:
    """Loss configuration for one training phase."""
    ortho: float = 0.0
    l1: float = 0.0
    tv_density: float = 0.0
    tv_app: float = 0.0
    rgb_brdf: float = 0.1
    normals_diff: float = 0.0002
    normals_ori: float = 0.001
    albedo_sm: float = 0.0002
    rough_sm: float = 0.0002
    normals_enhance_ratio: float = 1.0
    brdf_enhance_ratio: float = 1.0
    n_iters: int = 80000
    relight_start: int = 10000
    lr_factor: float = 1.0  # per-step TV decay
    rgb_brdf_warmup_iters: int = 0


@dataclass(frozen=True)
class StepStatic:
    """Static knobs of the step (same fields as the JAX package's)."""
    n_samples: int
    is_relight: bool
    white_bg: bool
    sample_method: str = "stratified_sampling"
    app_cap: int = 32
    march_cap: int = 0
    second_march_cap: int = 32
    secondary_use_baked: bool = True
    secondary_bake_reso: int = 0
    second_window: int = 0
    second_window_back: int = 0
    second_prepass_n: int = 18
    coarse_dilate: int = 2
    march_select: str = "scatter"
    march_group: int = 0
    secondary_compact_frac: float = 0.0
    second_march_group: int = 0
    group_bake_reso: int = 0
    app_bake_reso: int = 0
    secondary_app_hoist: bool = False
    second_app_cap: int = 16
    app_pair_frac: float = 0.0
    secondary_stats: bool = False
    second_window_probe: int = 0
    second_window_probe_back: int = 0
    ndc_ray: bool = False
    relight_ray_cap: int = 1024
    second_n_sample: int = 96
    second_near: float = 0.05
    second_far: float = 1.5
    secondary_tile: int = 16384
    # no march jitter, no random background
    deterministic: bool = False

    @cached_property
    def secondary(self) -> SecondaryKnobs:
        """The secondary march's knobs: this step's fields of their names."""
        return SecondaryKnobs(**{f.name: getattr(self, f.name)
                                 for f in fields(SecondaryKnobs)})


def compute_loss(cfg: F.FieldConfig, params, scene, batch,
                 key: Optional[torch.Generator], step: int,
                 st: StepStatic, w: LossWeights):
    """(total loss, metrics) for one batch; ``step`` is the iteration."""
    ret = render_train_batch(
        cfg, params, scene, batch["rays"], batch["light_idx"],
        n_samples=st.n_samples, key=None if st.deterministic else key,
        is_train=not st.deterministic, is_relight=st.is_relight,
        white_bg=st.white_bg, sample_method=st.sample_method,
        app_cap=st.app_cap, march_cap=st.march_cap,
        march_select=st.march_select, march_group=st.march_group,
        ndc_ray=st.ndc_ray, relight_ray_cap=st.relight_ray_cap,
        secondary=st.secondary, normal_gt=batch.get("normal_gt"))

    loss_rgb = ((ret["rgb_map"] - batch["rgbs"]) ** 2).mean()
    total = loss_rgb
    metrics = {"loss_rgb": loss_rgb}
    if w.ortho > 0:
        lo = L.ortho_loss(params, cfg)
        total = total + w.ortho * lo
        metrics["loss_ortho"] = lo
    if w.l1 > 0:
        l1 = L.density_l1(params, cfg)
        total = total + w.l1 * l1
        metrics["loss_l1"] = l1
    # TV weights decay multiplicatively every step they are applied
    if w.tv_density > 0:
        tv = L.tv_loss_density(params, cfg) * _decayed(w.tv_density, w, step)
        total = total + tv
        metrics["loss_tv_density"] = tv
    if w.tv_app > 0:
        tv = L.tv_loss_app(params, cfg) * _decayed(w.tv_app, w, step)
        total = total + tv
        metrics["loss_tv_app"] = tv
    if st.is_relight:
        total = total + _relight_losses(ret, batch["rgbs"], step, w, metrics)
    metrics["total_loss"] = total
    metrics["psnr"] = -10.0 * torch.log10(loss_rgb)
    if "march_overflow_frac" in ret:
        # rays with more occupied samples than march_cap: the culled march
        # is exact only on the others
        metrics["march_overflow_frac"] = ret["march_overflow_frac"]
    # the secondary pass's statistics (with st.secondary_stats)
    metrics.update({k: v for k, v in ret.items() if k in SEC_METRICS})
    if "acc_mask" in ret:
        # the rays the reference would relight
        metrics["n_acc_masked"] = ret["acc_mask"].float().sum()
    return total, metrics


def _decayed(weight: float, w: LossWeights, step: int) -> float:
    """weight * lr_factor ** (step + 1) in f32, as the JAX step computes it
    (a float64 power of the f32-rounded factor drifts from it by 1.9e-4
    relative at step 10,000)."""
    f32 = np.float32
    return float(f32(weight) * np.power(f32(w.lr_factor), f32(step + 1.0)))


def _relight_losses(ret, rgb_gt, step: int, w: LossWeights, metrics):
    """The relight phase's loss terms, added to ``metrics``; their sum."""
    # a masked mean: surface rays left out by relight_ray_cap do not count
    rmask = ret["relight_computed_mask"][:, None].to(rgb_gt.dtype)
    loss_brdf = ((rmask * (ret["rgb_with_brdf_map"] - rgb_gt) ** 2).sum()
                 / torch.clamp_min(rmask.sum() * 3.0, 1.0))
    brdf_w = w.rgb_brdf
    if w.rgb_brdf_warmup_iters > 0:
        brdf_w = brdf_w * min(max(
            (step - w.relight_start + 1.0) / w.rgb_brdf_warmup_iters, 0.0),
            1.0)
    total = loss_brdf * brdf_w
    metrics["loss_rgb_brdf"] = loss_brdf

    # exponential enhancement of the normal and BRDF terms
    prog = (step - w.relight_start) / max(w.n_iters - w.relight_start, 1)
    nw = w.normals_enhance_ratio ** prog
    bw = w.brdf_enhance_ratio ** prog
    terms = (
        ("loss_normals_diff", nw * w.normals_diff,
         ret["normals_diff_map"].mean()),
        ("loss_normals_ori", nw * w.normals_ori,
         ret["normals_orientation_loss_map"].mean()),
        ("loss_rough_sm", bw * w.rough_sm, ret["roughness_smoothness_loss"]),
        ("loss_albedo_sm", bw * w.albedo_sm, ret["albedo_smoothness_loss"]),
    )
    for name, weight, value in terms:
        if weight > 0:
            metrics[name] = weight * value
            total = total + metrics[name]
    return total


def make_train_step(cfg: F.FieldConfig, optimizer: GroupAdam, st: StepStatic,
                    w: LossWeights, device: DeviceLike = None,
                    mesh: Optional[Mesh] = None):
    """Build the step: ``step_fn(params, opt_state, scene, batch, key, step)
    -> (params, opt_state, metrics)``.

    ``batch`` holds ``rays`` [B, 6], ``rgbs`` [B, 3] and ``light_idx`` [B],
    and may hold ``normal_gt`` [B, 3] for ``gt_normals`` (tensors or
    arrays; moved to ``device``). ``key`` is a
    ``torch.Generator`` on ``device`` (or None when ``st.deterministic``).
    Parameters and Adam moments are updated in place and returned;
    metrics are detached 0-d tensors on the device (reading them syncs).

    With ``mesh`` (a process group; JAX's ``shard_map`` over ``data``),
    ``batch`` is this rank's rows and ``key`` this rank's generator (seeded
    by ``parallel.multihost.host_key``). The rank's gradients and metrics
    then go through ONE ``all_reduce`` of a flat bucket: the group's mean
    (``pmean``), except ``n_acc_masked``, which is summed; the same Adam
    update runs on every rank. The caps (``relight_ray_cap``, ``app_cap``,
    the pair caps) apply to the rank's own rays, as in JAX, whose static
    knobs are the same on every shard. Without a group the mesh changes
    nothing.
    """
    dev = resolve_device(device)
    grouped = mesh is not None and mesh.group is not None

    def step_fn(params, opt_state, scene, batch, key, step: int):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        flat = flatten(params)
        leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
        live = _unflatten(leaves)
        with span("forward"):
            loss, metrics = compute_loss(cfg, live, scene, batch, key, step,
                                         st, w)
        names = list(leaves)
        with span("backward"):
            grads = torch.autograd.grad(loss, [leaves[k] for k in names],
                                        allow_unused=True)
        # a parameter the loss does not reach gets a zero gradient, as in
        # JAX, so its moments decay and the group counts stay in step
        grads = {k: torch.zeros_like(leaves[k]) if g is None else g
                 for k, g in zip(names, grads)}
        if grouped:
            with span("all_reduce"):
                grads, metrics = _reduce(mesh, grads, metrics)
        with span("adam"):
            opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, {k: v.detach() for k, v in metrics.items()}

    return step_fn


def _reduce(mesh: Mesh, grads: Dict[str, torch.Tensor],
            metrics: Dict[str, torch.Tensor]):
    """The group's mean of every gradient and metric, the sum of
    ``n_acc_masked`` (a count; JAX psums it too), in one ``all_reduce``."""
    summed = [k for k in metrics if k == "n_acc_masked"]
    averaged = [k for k in metrics if k != "n_acc_masked"]
    means, sums = all_reduce_mean(
        mesh, [*grads.values(), *(metrics[k].detach() for k in averaged)],
        [metrics[k].detach() for k in summed])
    g = dict(zip(grads, means[:len(grads)]))
    m = dict(zip(averaged, means[len(grads):]))
    m.update(zip(summed, sums))
    return g, {k: m[k] for k in metrics}


def _unflatten(flat: Dict[str, torch.Tensor]) -> Dict:
    out: Dict = {}
    for path, v in flat.items():
        node = out
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return out
