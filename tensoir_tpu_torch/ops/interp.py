"""Grid interpolation on channels-last factors (port of tensoir_tpu.ops.interp).

Layouts are the JAX package's: planes ``[H, W, C]``, lines ``[D, C]``,
volumes ``[D, H, W(, C)]``, coordinates normalized to [-1, 1] with
``align_corners=True`` (the plain plane lookup also takes the other
convention and zero padding, for the lat-long environment maps). The
corner-packed plane lookup gathers its rows through K1
(``kernels.gather_rows``), whose backward is K2.

``clip`` splits the gradient evenly at a tie with a bound, as ``jnp.clip``
does (``torch.clamp`` passes all of it), so coordinate gradients at the
domain's edge agree with the reference.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tensoir_tpu_torch.kernels import gather_rows
from tensoir_tpu_torch.ops.rays import linspace


def clip(x: torch.Tensor, lo: Optional[float],
         hi: Optional[float]) -> torch.Tensor:
    """``jnp.clip``: either bound may be None. The bounds are filled on
    the tensor's device (``new_tensor`` would copy each from the host)."""
    if lo is not None:
        x = torch.maximum(x, x.new_full((), lo))
    if hi is not None:
        x = torch.minimum(x, x.new_full((), hi))
    return x


def recip(d: float) -> float:
    """1 / d rounded to f32, as a Python float. The reference divides by
    Python constants inside ``jit``, where XLA multiplies by the f32
    reciprocal instead; PyTorch divides on the CPU and multiplies on CUDA.
    Multiplying by this on every device gives XLA's numbers everywhere."""
    return float(np.float32(1.0) / np.float32(d))


def _unnormalize(coord, size: int, align_corners: bool):
    """Map [-1, 1] -> pixel coordinates (grid_sample conventions)."""
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1.0)
    return ((coord + 1.0) * size - 1.0) * 0.5


def lerp_line(line: torch.Tensor, z: torch.Tensor,
              align_corners: bool = True) -> torch.Tensor:
    """Linear interpolation on a [D, C] line at z [...] -> [..., C]."""
    D = line.shape[0]
    iz = _unnormalize(z, D, align_corners)
    iz0 = torch.floor(iz).clamp(0, D - 1)
    iz1 = (iz0 + 1).clamp(0, D - 1)
    w1 = iz - iz0
    w0 = 1.0 - w1
    v0 = line[iz0.long()]
    v1 = line[iz1.long()]
    return v0 * w0[..., None] + v1 * w1[..., None]


def bilerp_plane(plane: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                 align_corners: bool = True,
                 padding: str = "border") -> torch.Tensor:
    """Bilinear lookup on a [H, W, C] plane at x (along W) and y (along H):
    four plain row lookups, each weighted and summed in the reference's
    order. Returns [..., C].

    ``padding`` "border" clamps each corner to the plane; "zeros" gives a
    corner outside the plane no weight (grid_sample's default, which the
    lat-long environment lookups use at the poles and the seam)."""
    if padding not in ("border", "zeros"):
        raise ValueError(f"unknown padding {padding!r}")
    H, W, C = plane.shape
    ix = _unnormalize(x, W, align_corners)
    iy = _unnormalize(y, H, align_corners)
    ix0, iy0 = torch.floor(ix), torch.floor(iy)
    wx1, wy1 = ix - ix0, iy - iy0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    flat = plane.reshape(H * W, C)

    def corner(iyf, ixf, w):
        row = iyf.clamp(0, H - 1).long() * W + ixf.clamp(0, W - 1).long()
        if padding == "zeros":
            inb = (ixf >= 0) & (ixf <= W - 1) & (iyf >= 0) & (iyf <= H - 1)
            w = w * inb.to(w.dtype)
        return flat[row] * w[..., None]

    return (corner(iy0, ix0, wy0 * wx0) + corner(iy0, ix0 + 1, wy0 * wx1)
            + corner(iy0 + 1, ix0, wy1 * wx0)
            + corner(iy0 + 1, ix0 + 1, wy1 * wx1))


def _resize_positions(n: int, device) -> torch.Tensor:
    """The n node positions of an ``align_corners`` resize in [-1, 1], as
    ``jnp.linspace`` places them (a single node sits at 0)."""
    if n > 1:
        return linspace(-1.0, 1.0, n, device=device)
    return torch.zeros((1,), device=device)


def resize_bilinear_align_corners(grid: torch.Tensor, out_hw) -> torch.Tensor:
    """[H, W, C] -> [H_new, W_new, C] bilinear resize with
    ``align_corners=True``: the plane looked up at the new grid's nodes,
    with the reference's arithmetic (not ``F.interpolate``, which rounds
    the weights otherwise)."""
    ys = _resize_positions(int(out_hw[0]), grid.device)
    xs = _resize_positions(int(out_hw[1]), grid.device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return bilerp_plane(grid, xx, yy)


def resize_line_align_corners(line: torch.Tensor, out_d: int) -> torch.Tensor:
    """[D, C] -> [D_new, C] linear resize, ``align_corners=True``."""
    return lerp_line(line, _resize_positions(int(out_d), line.device))


def lerp_line_matmul(line: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Linear line lookup as a product with a two-tap matrix M [..., D]:
    1 - w at iz0 and w at iz0 + 1, the cell clipped to [0, D-2] and the
    weight to [0, 1], as the reference does. The gradient of the line is
    M^T @ g, a dense product: a line has a few hundred rows, so a gather's
    backward would pile millions of adds onto each of them."""
    D = line.shape[0]
    iz = _unnormalize(z, D, True)
    iz0 = torch.floor(iz).clamp(0, D - 2)
    w1 = clip(iz - iz0, 0.0, 1.0)[..., None]
    i0 = iz0.long()[..., None]
    M = z.new_zeros(z.shape + (D,))
    M.scatter_(-1, i0, 1.0 - w1).scatter_(-1, i0 + 1, w1)
    return torch.matmul(M, line)


def bilerp_plane_packed(plane: torch.Tensor, x: torch.Tensor,
                        y: torch.Tensor) -> torch.Tensor:
    """Bilinear plane lookup through ONE corner-packed row per point.

    ``plane`` [H, W, C] is packed into a [(H-1)(W-1), 4C] table whose row
    holds a cell's four corners; K1 gathers one row per point and K2
    scatters its gradient back. Border-clamped like the reference: the cell
    index is clipped to the grid and the weights to [0, 1], so coordinates
    outside [-1, 1] read the edge cell's edge value.
    x indexes W, y indexes H. Returns [..., C].
    """
    H, W, C = plane.shape
    packed = torch.cat([plane[:-1, :-1], plane[:-1, 1:],
                        plane[1:, :-1], plane[1:, 1:]], -1)
    packed = packed.reshape((H - 1) * (W - 1), 4 * C)
    ix = _unnormalize(x, W, True)
    iy = _unnormalize(y, H, True)
    ix0 = torch.floor(ix).clamp(0, W - 2)
    iy0 = torch.floor(iy).clamp(0, H - 2)
    wx1 = clip(ix - ix0, 0.0, 1.0)[..., None]
    wy1 = clip(iy - iy0, 0.0, 1.0)[..., None]
    idx = (iy0 * (W - 1) + ix0).to(torch.int32)
    rows = gather_rows(packed, idx.reshape(-1))
    rows = rows.reshape(*idx.shape, 4 * C)
    v00, v01, v10, v11 = rows.split(C, dim=-1)
    return ((1.0 - wy1) * ((1.0 - wx1) * v00 + wx1 * v01)
            + wy1 * ((1.0 - wx1) * v10 + wx1 * v11))


def trilerp_volume(vol: torch.Tensor, coords: torch.Tensor,
                   align_corners: bool = True) -> torch.Tensor:
    """Trilinear lookup on vol [D, H, W] or [D, H, W, C] at coords [..., 3]
    = (x -> W, y -> H, z -> D). Returns [...] or [..., C]."""
    squeeze = vol.dim() == 3
    if squeeze:
        vol = vol[..., None]
    D, H, W, C = vol.shape
    ix = _unnormalize(coords[..., 0], W, align_corners)
    iy = _unnormalize(coords[..., 1], H, align_corners)
    iz = _unnormalize(coords[..., 2], D, align_corners)
    ix0 = torch.floor(ix).clamp(0, W - 1)
    iy0 = torch.floor(iy).clamp(0, H - 1)
    iz0 = torch.floor(iz).clamp(0, D - 1)
    ix1 = (ix0 + 1).clamp(0, W - 1)
    iy1 = (iy0 + 1).clamp(0, H - 1)
    iz1 = (iz0 + 1).clamp(0, D - 1)
    wx1, wy1, wz1 = ix - ix0, iy - iy0, iz - iz0
    wx0, wy0, wz0 = 1.0 - wx1, 1.0 - wy1, 1.0 - wz1
    flat = vol.reshape(D * H * W, C)

    def take(izp, iyp, ixp):
        return flat[((izp.long() * H + iyp.long()) * W + ixp.long())]

    out = (take(iz0, iy0, ix0) * (wz0 * wy0 * wx0)[..., None]
           + take(iz0, iy0, ix1) * (wz0 * wy0 * wx1)[..., None]
           + take(iz0, iy1, ix0) * (wz0 * wy1 * wx0)[..., None]
           + take(iz0, iy1, ix1) * (wz0 * wy1 * wx1)[..., None]
           + take(iz1, iy0, ix0) * (wz1 * wy0 * wx0)[..., None]
           + take(iz1, iy0, ix1) * (wz1 * wy0 * wx1)[..., None]
           + take(iz1, iy1, ix0) * (wz1 * wy1 * wx0)[..., None]
           + take(iz1, iy1, ix1) * (wz1 * wy1 * wx1)[..., None])
    return out[..., 0] if squeeze else out
