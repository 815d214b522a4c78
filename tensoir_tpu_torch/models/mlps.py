"""Shading MLPs as parameter dicts + apply functions (port of
tensoir_tpu.models.mlps: init, apply, and the MLP_Fea and BRDF inputs).

Three layers, ReLU, weights [in, out] as in the JAX package. Init is
U(+-1/sqrt(fan_in)) for weights and biases with the last bias zeroed,
drawn from a ``torch.Generator`` on the CPU.
"""
from __future__ import annotations

from typing import Dict

import torch

from tensoir_tpu_torch.ops.pe import positional_encoding


def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def init_mlp(gen: torch.Generator, in_dim: int, hidden: int,
             out_dim: int) -> Dict[str, torch.Tensor]:
    out = {}
    dims = ((in_dim, hidden), (hidden, hidden), (hidden, out_dim))
    for i, (fi, fo) in enumerate(dims, start=1):
        bound = 1.0 / fi ** 0.5
        out[f"w{i}"] = _uniform(gen, (fi, fo), bound)
        out[f"b{i}"] = (torch.zeros(fo) if i == 3
                        else _uniform(gen, (fo,), bound))
    return out


def apply_mlp(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(torch.matmul(x, params["w1"]) + params["b1"])
    h = torch.relu(torch.matmul(h, params["w2"]) + params["b2"])
    return torch.matmul(h, params["w3"]) + params["b3"]


def render_fea_in_dim(app_dim: int, view_pe: int, fea_pe: int) -> int:
    """MLPRender_Fea input width."""
    return 2 * view_pe * 3 + 2 * fea_pe * app_dim + 3 + app_dim


def render_fea_inputs(features, viewdirs, view_pe: int, fea_pe: int):
    parts = [features, viewdirs]
    if fea_pe > 0:
        parts.append(positional_encoding(features, fea_pe))
    if view_pe > 0:
        parts.append(positional_encoding(viewdirs, view_pe))
    return torch.cat(parts, -1)


def brdf_pe_fea_in_dim(app_dim: int, pos_pe: int, fea_pe: int) -> int:
    """MLPBRDF_PEandFeature input width (BRDF and normal MLPs)."""
    return 2 * pos_pe * 3 + 2 * fea_pe * app_dim + 3 + app_dim


def brdf_pe_fea_inputs(pts, features, pos_pe: int, fea_pe: int):
    """MLPBRDF_PEandFeature inputs: [features, pts, PE(features), PE(pts)]."""
    parts = [features, pts]
    if fea_pe > 0:
        parts.append(positional_encoding(features, fea_pe))
    if pos_pe > 0:
        parts.append(positional_encoding(pts, pos_pe))
    return torch.cat(parts, -1)
