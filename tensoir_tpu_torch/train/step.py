"""Training step: render -> losses -> gradients -> per-group Adam (port of
tensoir_tpu.train.step for the radiance phase).

``LossWeights`` and ``StepStatic`` keep the JAX package's fields, so one
config drives both; the knobs of paths the port does not have yet raise in
the renderer. The step runs eagerly on ``device``: forward, backward, then
the in-place Adam update.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from tensoir_tpu_torch.device import DeviceLike, resolve_device
from tensoir_tpu_torch.models import field as F
from tensoir_tpu_torch.render.train_render import render_train_batch
from tensoir_tpu_torch.train import losses as L
from tensoir_tpu_torch.train.optim import GroupAdam, flatten


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


def compute_loss(cfg: F.FieldConfig, params, scene, batch,
                 key: Optional[torch.Generator], step: int,
                 st: StepStatic, w: LossWeights):
    """(total loss, metrics) for one batch; ``step`` is the iteration."""
    ret = render_train_batch(
        cfg, params, scene, batch["rays"], batch["light_idx"],
        n_samples=st.n_samples, key=None if st.deterministic else key,
        is_train=not st.deterministic, is_relight=st.is_relight,
        white_bg=st.white_bg, app_cap=st.app_cap, march_cap=st.march_cap,
        march_group=st.march_group, ndc_ray=st.ndc_ray)

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
        tv = L.tv_loss_density(params, cfg) * (
            w.tv_density * w.lr_factor ** (step + 1.0))
        total = total + tv
        metrics["loss_tv_density"] = tv
    if w.tv_app > 0:
        tv = L.tv_loss_app(params, cfg) * (
            w.tv_app * w.lr_factor ** (step + 1.0))
        total = total + tv
        metrics["loss_tv_app"] = tv
    metrics["total_loss"] = total
    metrics["psnr"] = -10.0 * torch.log10(loss_rgb)
    return total, metrics


def make_train_step(cfg: F.FieldConfig, optimizer: GroupAdam, st: StepStatic,
                    w: LossWeights, device: DeviceLike = None):
    """Build the step: ``step_fn(params, opt_state, scene, batch, key, step)
    -> (params, opt_state, metrics)``.

    ``batch`` holds ``rays`` [B, 6], ``rgbs`` [B, 3] and ``light_idx`` [B]
    (tensors or arrays; moved to ``device``). ``key`` is a
    ``torch.Generator`` on ``device`` (or None when ``st.deterministic``).
    Parameters and Adam moments are updated in place and returned;
    metrics are detached 0-d tensors on the device (reading them syncs).
    """
    dev = resolve_device(device)

    def step_fn(params, opt_state, scene, batch, key, step: int):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        flat = flatten(params)
        leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
        live = _unflatten(leaves)
        loss, metrics = compute_loss(cfg, live, scene, batch, key, step, st, w)
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names],
                                    allow_unused=True)
        # a parameter the loss does not reach gets a zero gradient, as in
        # JAX, so its moments decay and the group counts stay in step
        grads = {k: torch.zeros_like(leaves[k]) if g is None else g
                 for k, g in zip(names, grads)}
        opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, {k: v.detach() for k, v in metrics.items()}

    return step_fn


def _unflatten(flat: Dict[str, torch.Tensor]) -> Dict:
    out: Dict = {}
    for path, v in flat.items():
        node = out
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return out
