"""TensoRF's CP field (TensorCP) written out plainly, in gather form: each
component's value on an axis is its line's two nearest nodes weighted
linearly (``align_corners=True``), the three axes' values are multiplied,
and the density sums the products over the components. float32 with TF32
off; no kernel, no dense two-tap matrix, no bake tables.

Layouts are those of the port and of ``field.py``: ``density_line_i`` and
``app_line_i`` [D_i, R], line i read at coordinate ``VEC_MODE[i]`` (line 0
along z, line 1 along y, line 2 along x), coordinates normalized to
[-1, 1].

One departure from TensoRF, whose lines are read by ``grid_sample`` with
zero padding outside the grid: below a line's first node the value
extends linearly from the first two nodes, and past its last node it is
the last node's value (the JAX package's ``lerp_line``, which its CP field
uses; the port's ``lerp_line_matmul(extrapolate=True)``). The two agree
inside the grid, where every sample of the field lies.
"""
from __future__ import annotations

from typing import Dict

import torch

VEC_MODE = (2, 1, 0)


def _fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def line_lookup(line: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """line [D, R] at z [...] -> [..., R]: two taps, i0 = floor clipped to
    [0, D-1], i1 = i0 + 1 clipped to D-1, the weight not clipped."""
    D = line.shape[0]
    iz = (z + 1.0) * 0.5 * (D - 1.0)
    i0 = torch.floor(iz).clamp(0, D - 1)
    w1 = (iz - i0)[..., None]
    i1 = (i0 + 1).clamp(max=D - 1)
    return line[i0.long()] * (1.0 - w1) + line[i1.long()] * w1


def components(params: Dict, name: str, coords: torch.Tensor
               ) -> torch.Tensor:
    """v^X_r(x) v^Y_r(y) v^Z_r(z) [..., R] of the ``name`` lines."""
    _fp32()
    out = line_lookup(params[f"{name}_line_0"], coords[..., VEC_MODE[0]])
    for i in (1, 2):
        out = out * line_lookup(params[f"{name}_line_{i}"],
                                coords[..., VEC_MODE[i]])
    return out


def density_feature(params: Dict, coords: torch.Tensor) -> torch.Tensor:
    """sigma's feature at coords [..., 3]: the sum of the density products
    over the components."""
    return components(params, "density", coords).sum(-1)


def app_feature(params: Dict, coords: torch.Tensor,
                light_idx: torch.Tensor) -> torch.Tensor:
    """The radiance feature [..., app_dim]: B (v^X o v^Y o v^Z) with
    TensoIR's light factor, ``basis_mat^T (products * light_line[l])``."""
    prod = components(params, "app", coords)
    light = params["light_line"][light_idx.long()]
    return (prod * light) @ params["basis_mat"]


def sigma_on_nodes(params: Dict) -> torch.Tensor:
    """The density feature on the lines' own nodes, [Z, Y, X]: each node
    the sum over components of its three line values' product."""
    _fp32()
    lz = params["density_line_0"][:, None, None, :]
    ly = params["density_line_1"][None, :, None, :]
    lx = params["density_line_2"][None, None, :, :]
    return (lz * ly * lx).sum(-1)
