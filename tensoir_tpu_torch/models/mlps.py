"""Shading MLPs as parameter dicts + apply functions (port of
tensoir_tpu.models.mlps: init, apply in f32 or bf16, and the inputs of
every decoder: MLP_Fea, MLP_PE and MLP radiance, the BRDF and normal
MLPs, and the residue normal MLP).

Three layers, ReLU, weights [in, out] as in the JAX package. Init is
U(+-1/sqrt(fan_in)) for weights and biases with the last bias zeroed,
drawn from a ``torch.Generator`` on the CPU.
"""
from __future__ import annotations

from typing import Dict

import torch

from tensoir_tpu_torch.ops.pe import positional_encoding
from tensoir_tpu_torch.profiling import span


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


class _RoundBF16(torch.autograd.Function):
    """x rounded to bf16 and held in f32; the gradient rounded the same
    way, as JAX's ``astype(bfloat16)`` feeding a dot with an f32 result
    rounds the dot's operand cotangent to the operand's bf16."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).float()


def dot(x: torch.Tensor, w: torch.Tensor, compute_dtype: str) -> torch.Tensor:
    """x @ w with an f32 result. In ``bfloat16`` both operands are rounded
    to bf16 first and the product of the rounded values is taken in f32
    (every bf16 product is exact in f32, so this is an f32 sum of exact
    products, as JAX's ``preferred_element_type=float32`` gives; a bf16
    ``torch.matmul`` would round the result once more)."""
    if compute_dtype == "bfloat16":
        x, w = _RoundBF16.apply(x), _RoundBF16.apply(w)
    elif compute_dtype != "float32":
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
    return torch.matmul(x, w)


def apply_mlp(params: Dict[str, torch.Tensor], x: torch.Tensor,
              compute_dtype: str = "float32") -> torch.Tensor:
    """Three layers; products in ``compute_dtype`` (see ``dot``), biases
    and ReLU in f32."""
    h = torch.relu(dot(x, params["w1"], compute_dtype) + params["b1"])
    h = torch.relu(dot(h, params["w2"], compute_dtype) + params["b2"])
    return dot(h, params["w3"], compute_dtype) + params["b3"]


def render_fea_in_dim(app_dim: int, view_pe: int, fea_pe: int) -> int:
    """MLPRender_Fea input width."""
    return 2 * view_pe * 3 + 2 * fea_pe * app_dim + 3 + app_dim


def render_fea_inputs(features, viewdirs, view_pe: int, fea_pe: int):
    with span("mlp_inputs"):
        parts = [features, viewdirs]
        if fea_pe > 0:
            parts.append(positional_encoding(features, fea_pe))
        if view_pe > 0:
            parts.append(positional_encoding(viewdirs, view_pe))
        return torch.cat(parts, -1)


def render_pe_in_dim(app_dim: int, view_pe: int, pos_pe: int) -> int:
    """MLPRender_PE input width: [features, viewdirs, PE(pts), PE(view)]
    (the width its forward builds; the raw points are not an input)."""
    return (3 + 2 * view_pe * 3) + (2 * pos_pe * 3) + app_dim


def render_pe_inputs(pts, features, viewdirs, view_pe: int, pos_pe: int):
    with span("mlp_inputs"):
        parts = [features, viewdirs]
        if pos_pe > 0:
            parts.append(positional_encoding(pts, pos_pe))
        if view_pe > 0:
            parts.append(positional_encoding(viewdirs, view_pe))
        return torch.cat(parts, -1)


def render_plain_in_dim(app_dim: int, view_pe: int) -> int:
    """MLPRender input width: [features, viewdirs, PE(view)]."""
    return (3 + 2 * view_pe * 3) + app_dim


def render_plain_inputs(features, viewdirs, view_pe: int):
    with span("mlp_inputs"):
        parts = [features, viewdirs]
        if view_pe > 0:
            parts.append(positional_encoding(viewdirs, view_pe))
        return torch.cat(parts, -1)


def brdf_pe_fea_in_dim(app_dim: int, pos_pe: int, fea_pe: int) -> int:
    """MLPBRDF_PEandFeature input width (BRDF and normal MLPs)."""
    return 2 * pos_pe * 3 + 2 * fea_pe * app_dim + 3 + app_dim


def brdf_pe_fea_inputs(pts, features, pos_pe: int, fea_pe: int):
    """MLPBRDF_PEandFeature inputs: [features, pts, PE(features), PE(pts)]."""
    with span("mlp_inputs"):
        parts = [features, pts]
        if fea_pe > 0:
            parts.append(positional_encoding(features, fea_pe))
        if pos_pe > 0:
            parts.append(positional_encoding(pts, pos_pe))
        return torch.cat(parts, -1)


def normal_residue_in_dim(app_dim: int, pos_pe: int, fea_pe: int) -> int:
    """MLPNormal_normal_and_PExyz input width."""
    return 2 * pos_pe * 3 + 2 * fea_pe * app_dim + 3 + app_dim + 3


def normal_residue_inputs(pts, normal, features, pos_pe: int, fea_pe: int):
    """[pts, derived normal, features, PE(features), PE(pts)]."""
    with span("mlp_inputs"):
        parts = [pts, normal, features]
        if fea_pe > 0:
            parts.append(positional_encoding(features, fea_pe))
        if pos_pe > 0:
            parts.append(positional_encoding(pts, pos_pe))
        return torch.cat(parts, -1)
