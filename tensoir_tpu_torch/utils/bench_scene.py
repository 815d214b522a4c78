"""Benchmark scene seeding (port of tensoir_tpu.utils.bench_scene).

A solid ellipsoidal blob bumps component 0 of every density plane and line,
so that a ray bundle aimed at the centre hits opaque geometry; the rays
start at z = -4 and point along +z with a small spread.
"""
from __future__ import annotations

import numpy as np
import torch


@torch.no_grad()
def seed_solid_blob(params, amp: float = 8.0, sharp: float = 0.10):
    """Adds the blob to ``params`` in place and returns them."""
    for i in range(3):
        g = params[f"density_plane_{i}"]
        H, W, _ = g.shape
        yy, xx = np.meshgrid(np.linspace(-1, 1, H), np.linspace(-1, 1, W),
                             indexing="ij")
        bump = np.exp(-((xx ** 2 + yy ** 2) / sharp)).astype(np.float32)
        g[..., 0] += amp * torch.from_numpy(bump).to(g.device)

        ln = params[f"density_line_{i}"]
        zz = np.linspace(-1, 1, ln.shape[0])
        lbump = np.exp(-(zz ** 2) / sharp).astype(np.float32)
        ln[:, 0] += torch.from_numpy(lbump).to(ln.device)
    return params


def bench_rays(batch: int, spread: float = 0.05, seed: int = 0) -> np.ndarray:
    """[batch, 6] rays from z = -4 aimed at the blob."""
    rng = np.random.default_rng(seed)
    o = np.zeros((batch, 3), np.float32)
    o[:, 2] = -4.0
    d = rng.normal(size=(batch, 3)).astype(np.float32) * spread
    d[:, 2] = 1.0
    return np.concatenate([o, d], -1)
