"""Grid interpolation on channels-last factors (port of tensoir_tpu.ops.interp).

Layouts are the JAX package's: planes ``[H, W, C]``, lines ``[D, C]``,
volumes ``[D, H, W(, C)]``, coordinates normalized to [-1, 1] with
``align_corners=True``. The corner-packed plane lookup gathers its rows
through K1 (``kernels.gather_rows``), whose backward is K2.

``clip`` splits the gradient evenly at a tie with a bound, as ``jnp.clip``
does (``torch.clamp`` passes all of it), so coordinate gradients at the
domain's edge agree with the reference.
"""
from __future__ import annotations

import torch

from tensoir_tpu_torch.kernels import gather_rows


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


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
