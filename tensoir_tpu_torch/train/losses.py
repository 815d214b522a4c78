"""Model-side regularizers (port of tensoir_tpu.train.losses): line
orthogonality, density L1 and plane total variation. ``cfg`` selects the
sliced access of the stacked VM layout; None keeps the split-VM names."""
from __future__ import annotations

from typing import Dict

import torch


def _line_ortho(line: torch.Tensor) -> torch.Tensor:
    """Mean |off-diagonal| of the Gram matrix of a [grid, comps] line."""
    mat = line.T
    dotp = mat @ mat.T
    r = dotp.shape[0]
    off = dotp * (1.0 - torch.eye(r, dtype=dotp.dtype, device=dotp.device))
    return off.abs().sum() / (r * (r - 1))


def _factors(params: Dict, cfg, name: str, i: int):
    if cfg is not None and cfg.decomp == "vm_stacked":
        a = cfg.app_n_comp[i]
        sl = slice(None, a) if name == "app" else slice(a, None)
        return (params[f"stack_plane_{i}"][..., sl],
                params[f"stack_line_{i}"][..., sl])
    return params.get(f"{name}_plane_{i}"), params.get(f"{name}_line_{i}")


def ortho_loss(params: Dict, cfg=None) -> torch.Tensor:
    total = 0.0
    for i in range(3):
        for name in ("density", "app"):
            _, line = _factors(params, cfg, name, i)
            if line is not None:
                total = total + _line_ortho(line)
    return total


def density_l1(params: Dict, cfg=None) -> torch.Tensor:
    """mean|plane| + mean|line| over the density factors."""
    total = 0.0
    for i in range(3):
        plane, line = _factors(params, cfg, "density", i)
        if plane is not None:
            total = total + plane.abs().mean()
        if line is not None:
            total = total + line.abs().mean()
    return total


def _tv_plane(plane: torch.Tensor) -> torch.Tensor:
    """TV of one [H, W, C] plane."""
    H, W, C = plane.shape
    count_h = C * (H - 1) * W
    count_w = C * H * (W - 1)
    h_tv = ((plane[1:, :, :] - plane[:-1, :, :]) ** 2).sum()
    w_tv = ((plane[:, 1:, :] - plane[:, :-1, :]) ** 2).sum()
    return 2.0 * (h_tv / count_h + w_tv / count_w)


def tv_loss_density(params: Dict, cfg=None) -> torch.Tensor:
    total = 0.0
    for i in range(3):
        plane, _ = _factors(params, cfg, "density", i)
        if plane is not None:
            total = total + _tv_plane(plane) * 1e-2
    return total


def tv_loss_app(params: Dict, cfg=None) -> torch.Tensor:
    total = 0.0
    for i in range(3):
        plane, _ = _factors(params, cfg, "app", i)
        if plane is not None:
            total = total + _tv_plane(plane) * 1e-2
    return total
