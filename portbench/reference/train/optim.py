"""Per-group Adam with exponential LR decay, with optax's arithmetic
(port of tensoir_tpu.train.optim, which chains ``scale_by_adam`` and
``scale_by_schedule`` per group under ``multi_transform``).

Groups: spatial factors at ``lr_init``, basis and MLPs at ``lr_basis``,
light parameters at ``lr_light``; betas (0.9, 0.99), eps 1e-8 outside the
square root, bias correction on, and lr(count) = base * factor**count with
the count read before it increments. Every group steps every update, as in
optax, so the counts agree. The moments are updated in place, and so are
the parameters: the step returns the same tensors, which saves a copy of
every parameter and moment.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

SPATIAL_PREFIXES = ("density_plane", "density_line", "app_plane", "app_line",
                    "stack_plane", "stack_line")
LIGHT_KEYS = ("light_line", "lgt_sgs", "light_pixel")
GROUPS = ("spatial", "network", "light")
B1, B2, EPS = 0.9, 0.99, 1e-8


def param_group(name: str) -> str:
    if name.startswith(SPATIAL_PREFIXES):
        return "spatial"
    if name in LIGHT_KEYS:
        return "light"
    return "network"


def flatten(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested dict -> {"a/b": tensor} in insertion order."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


class GroupAdam:
    """``update(grads, state, params)`` applies one Adam step in place."""

    def __init__(self, lr_init: float, lr_basis: float,
                 lr_decay_factor: float, lr_light: float = 1e-3):
        self.base_lr = {"spatial": lr_init, "network": lr_basis,
                        "light": lr_light}
        self.factor = lr_decay_factor

    def init(self, params: Dict) -> Dict:
        flat = flatten(params)
        return {
            "count": {g: 0 for g in GROUPS},
            "mu": {k: torch.zeros_like(v) for k, v in flat.items()},
            "nu": {k: torch.zeros_like(v) for k, v in flat.items()},
        }

    def lr(self, group: str, count: int) -> float:
        """Step size at a group's count, in f32 like the optax schedule."""
        f32 = np.float32
        return float(f32(self.base_lr[group])
                     * np.power(f32(self.factor), f32(count)))

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: Dict,
               params: Dict) -> Dict:
        f32 = np.float32
        flat = flatten(params)
        count = state["count"]
        new_count = {g: c + 1 for g, c in count.items()}
        for name, p in flat.items():
            g = grads[name]
            grp = param_group(name.split("/", 1)[0])
            n = new_count[grp]
            mu, nu = state["mu"][name], state["nu"][name]
            mu.mul_(B1).add_(g, alpha=1 - B1)
            nu.mul_(B2).add_(g * g, alpha=1 - B2)
            bc1 = float(f32(1) - np.power(f32(B1), f32(n)))
            bc2 = float(f32(1) - np.power(f32(B2), f32(n)))
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
            p.add_(upd * -self.lr(grp, count[grp]))
        state["count"] = new_count
        return state


def make_optimizer(params: Dict, lr_init: float, lr_basis: float,
                   lr_decay_factor: float, lr_light: float = 1e-3) -> GroupAdam:
    """The per-group Adam; ``params`` is accepted for signature parity."""
    del params
    return GroupAdam(lr_init, lr_basis, lr_decay_factor, lr_light)


def decay_factor(lr_decay_target_ratio: float, lr_decay_iters: int,
                 n_iters: int) -> float:
    iters = lr_decay_iters if lr_decay_iters > 0 else n_iters
    return lr_decay_target_ratio ** (1.0 / iters)
