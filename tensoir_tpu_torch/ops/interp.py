"""Grid interpolation on channels-last factors (port of tensoir_tpu.ops.interp).

Layouts are the JAX package's: planes ``[H, W, C]``, lines ``[D, C]``,
volumes ``[D, H, W(, C)]``, coordinates normalized to [-1, 1] with
``align_corners=True`` (the plain plane lookup also takes the other
convention and zero padding, for the lat-long environment maps). The
corner-packed plane lookup gathers its rows through K1
(``kernels.gather_rows``), whose backward is K2; so does the grouped
lookup, one 16-corner block row per group of nearby points. A line lookup
(``line_product``) is a product with a two-tap matrix wherever a gradient
can flow through it, and otherwise reads its two taps through the
line-taps kernel (``csrc/line_taps.cu``).

``clip`` splits the gradient evenly at a tie with a bound, as ``jnp.clip``
does (``torch.clamp`` passes all of it), so coordinate gradients at the
domain's edge agree with the reference.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from tensoir_tpu_torch.kernels import LAUNCHES, build, gather_rows
from tensoir_tpu_torch.ops.rays import linspace
from tensoir_tpu_torch.profiling import span


def clip(x: torch.Tensor, lo: Optional[float],
         hi: Optional[float]) -> torch.Tensor:
    """``jnp.clip``: either bound may be None. The bounds are filled on
    the tensor's device (``new_tensor`` would copy each from the host)."""
    if lo is not None:
        x = torch.maximum(x, x.new_full((), lo))
    if hi is not None:
        x = torch.minimum(x, x.new_full((), hi))
    return x


# small host constants on their devices (``device_constant``)
_CONSTANTS: Dict = {}


def device_constant(values, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made once per
    (values, dtype, device) and kept; never written to. A copy from the
    host waits for the device, and a CUDA graph cannot capture one: the
    relight chunk's graphs capture ``render_rays``, which reads two such
    constants, after a first run that makes them."""
    k = (tuple(values), dtype, torch.device(device))
    t = _CONSTANTS.get(k)
    if t is None:
        t = _CONSTANTS[k] = torch.tensor(values, dtype=dtype, device=device)
    return t


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


def bilerp_image_nchw_like(image_hwc: torch.Tensor, x: torch.Tensor,
                           y: torch.Tensor,
                           align_corners: bool) -> torch.Tensor:
    """Bilinear lookup on an [H, W, C] image with either corner convention
    (the lat-long environment-map queries): ``bilerp_plane`` with border
    padding."""
    return bilerp_plane(image_hwc, x, y, align_corners=align_corners)


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


def lerp_line_matmul(line: torch.Tensor, z: torch.Tensor,
                     extrapolate: bool = False) -> torch.Tensor:
    """Linear line lookup as a product with a two-tap matrix M [..., D]:
    1 - w at iz0 and w at iz0 + 1, the cell clipped to [0, D-2] and the
    weight to [0, 1], as the reference does. The gradient of the line is
    M^T @ g, a dense product: a line has a few hundred rows, so a gather's
    backward would pile millions of adds onto each of them.

    With ``extrapolate`` the taps are ``lerp_line``'s instead: iz0 and
    iz0 + 1 each clipped to [0, D-1] and the weight not clipped, so the
    line extends linearly below its first node and is flat past its last;
    the value and gradients equal ``lerp_line``'s (the JAX package's CP
    lookup) everywhere. The matrix and its product run in the span
    ``line_matrix``."""
    D = line.shape[0]
    with span("line_matrix"):
        iz = _unnormalize(z, D, True)
        M = z.new_zeros(z.shape + (D,))
        if extrapolate:
            iz0 = torch.floor(iz).clamp(0, D - 1)
            w1 = (iz - iz0)[..., None]
            i0 = iz0.long()[..., None]
            M.scatter_add_(-1, i0, 1.0 - w1).scatter_add_(
                -1, (i0 + 1).clamp(max=D - 1), w1)
            return torch.matmul(M, line)
        iz0 = torch.floor(iz).clamp(0, D - 2)
        w1 = clip(iz - iz0, 0.0, 1.0)[..., None]
        i0 = iz0.long()[..., None]
        M.scatter_(-1, i0, 1.0 - w1).scatter_(-1, i0 + 1, w1)
        return torch.matmul(M, line)


# line lookups by route, counted by ``line_product`` on every device (a
# lookup of CP's three lines counts three); a tile graph's replays run no
# Python, so its lookups count once, at its capture. The kernel's launches
# are ``kernels.LAUNCHES["line_taps"]``.
LINE_ROUTE = {"taps": 0, "matrix": 0}


def reset_line_route_counts() -> None:
    for k in LINE_ROUTE:
        LINE_ROUTE[k] = 0


def _taps(line: torch.Tensor, z: torch.Tensor, extrapolate: bool):
    """(i0, i1, w0, w1) of ``lerp_line_matmul``'s two taps at z [...]: the
    same clipping and weights; where CP's taps fall on one node (i0 ==
    i1) the one weight is fl(fl(1 - w1) + w1), as its ``scatter_add_``
    writes it, and w1 is 0."""
    D = line.shape[0]
    iz = _unnormalize(z, D, True)
    if extrapolate:
        iz0 = torch.floor(iz).clamp(0, D - 1)
        w1 = iz - iz0
        i0 = iz0.long()
        i1 = (i0 + 1).clamp(max=D - 1)
        w0 = 1.0 - w1
        one = i0 == i1
        return (i0, i1, torch.where(one, w0 + w1, w0),
                torch.where(one, torch.zeros_like(w1), w1))
    iz0 = torch.floor(iz).clamp(0, D - 2)
    w1 = clip(iz - iz0, 0.0, 1.0)
    i0 = iz0.long()
    return i0, i0 + 1, 1.0 - w1, w1


def line_taps_plain(lines, coords: torch.Tensor, axes,
                    extrapolate: bool = False) -> torch.Tensor:
    """Plain version of the line-taps kernel: per line two row gathers and
    fma(w1, l1, fl(w0 * l0)), the two-tap matrix's GEMM row in ascending
    node order (the fma exact in float64, then rounded once), and the
    lines' lookups multiplied left to right."""
    out = None
    for line, axis in zip(lines, axes):
        i0, i1, w0, w1 = _taps(line, coords[..., axis], extrapolate)
        l0, l1 = line[i0], line[i1]
        v = (w1[..., None].double() * l1.double()
             + (w0[..., None] * l0).double()).float()
        out = v if out is None else out * v
    return out


def _check_taps(lines, coords: torch.Tensor, axes) -> None:
    if len(lines) not in (1, 3) or len(axes) != len(lines):
        raise ValueError(f"line taps look up 1 or 3 lines, one axis each; "
                         f"got {len(lines)} lines, axes {tuple(axes)}")
    r = lines[0].shape[-1]
    for line, axis in zip(lines, axes):
        if (line.dim() != 2 or line.dtype != torch.float32
                or line.shape[1] != r or line.shape[0] < 2
                or line.stride(1) != 1):
            raise ValueError(f"each line must be a float32 [D >= 2, {r}] "
                             f"table with unit column stride, got "
                             f"{line.dtype} {tuple(line.shape)} strides "
                             f"{line.stride()}")
        if axis not in (0, 1, 2):
            raise ValueError(f"axis {axis} is not a coordinate column")
        if line.device != coords.device:
            raise ValueError(f"tensors on different devices: {line.device} "
                             f"vs {coords.device}")
    if coords.dtype != torch.float32 or coords.shape[-1:] != (3,):
        raise ValueError(f"coords must be float32 [..., 3], got "
                         f"{coords.dtype} {tuple(coords.shape)}")


def line_taps(lines, coords: torch.Tensor, axes,
              extrapolate: bool = False) -> torch.Tensor:
    """prod_a lerp(lines[a], coords[..., axes[a]]) -> [..., R] for one (VM)
    or three (CP) float32 line tables [D, R], with ``lerp_line_matmul``'s
    taps (``extrapolate`` as there) and the value of its product up to the
    order of the GEMM's sum. No gradient flows through it. CPU tensors take
    the plain version; CUDA tensors launch ``csrc/line_taps.cu`` or raise.
    A line may be a channel slice of a wider table (``vm_stacked``); the
    coordinates must be contiguous on CUDA."""
    _check_taps(lines, coords, axes)
    with span("line_taps"):
        if coords.device.type == "cpu":
            return line_taps_plain(lines, coords, axes, extrapolate)
        if coords.device.type != "cuda":
            raise ValueError(f"line taps run on CPU or CUDA, not "
                             f"{coords.device}")
        if not coords.is_contiguous():
            raise ValueError("the line-taps kernel needs contiguous coords")
        n, r = coords.numel() // 3, lines[0].shape[1]
        out = torch.empty(coords.shape[:-1] + (r,), dtype=torch.float32,
                          device=coords.device)
        pad = (tuple(lines) + (lines[0],) * 2)[:3]
        axes3 = (tuple(axes) + (0, 0))[:3]
        fn = build.kernel("line_taps_f32")
        with torch.cuda.device(coords.device):
            stream = torch.cuda.current_stream(coords.device).cuda_stream
            err = fn(*(t.data_ptr() for t in pad),
                     *(t.stride(0) for t in pad), *(t.shape[0] for t in pad),
                     *axes3, len(lines), int(extrapolate), coords.data_ptr(),
                     out.data_ptr(), n, r, stream)
        if err != 0:
            raise RuntimeError(f"line_taps kernel launch failed: cudaError "
                               f"{err}")
        if n and r:     # the kernel returns without a launch on empty input
            LAUNCHES["line_taps"] += 1
        return out


def line_matrix_product(lines, coords: torch.Tensor, axes,
                        extrapolate: bool = False) -> torch.Tensor:
    """The lookups of ``lines`` at ``coords[..., axes[a]]`` as two-tap
    matrix products (``lerp_line_matmul``), multiplied left to right."""
    out = None
    for line, axis in zip(lines, axes):
        v = lerp_line_matmul(line, coords[..., axis], extrapolate)
        out = v if out is None else out * v
    return out


def line_product(lines, coords: torch.Tensor, axes,
                 extrapolate: bool = False) -> torch.Tensor:
    """The product of the lookups of ``lines`` at ``coords[..., axes[a]]``
    (one VM line, or CP's three), routed on what the lookup can observe:
    where a gradient can flow (grad mode on, and a line or the coordinates
    need one), ``line_matrix_product``, whose gradients are products;
    elsewhere ``line_taps``, which never builds the matrix."""
    if torch.is_grad_enabled() and (coords.requires_grad or any(
            line.requires_grad for line in lines)):
        LINE_ROUTE["matrix"] += len(lines)
        return line_matrix_product(lines, coords, axes, extrapolate)
    LINE_ROUTE["taps"] += len(lines)
    return line_taps(tuple(lines), coords.contiguous(), tuple(axes),
                     extrapolate)


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
    with span("plane_pack"):
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


def bilerp_plane_group_packed(plane: torch.Tensor, x: torch.Tensor,
                              y: torch.Tensor) -> torch.Tensor:
    """Bilinear plane lookup for GROUPS of nearby points through ONE
    16-corner block row per group.

    ``plane`` [H, W, C] (H, W >= 4) is packed into a [(H-3)(W-3), 16C]
    table whose row holds the 4 x 4 nodes of a 3 x 3-cell block (node
    order 4*dy + dx). x, y [..., g]: the trailing axis is the group. The
    block starts at the group's smallest cell, clipped so that it fits the
    plane; each point then weights its cell's four nodes inside the block
    (a one-hot of its offset times the bilinear weight, per axis). The
    result equals ``bilerp_plane_packed``'s, up to the order of the sums,
    whenever every point of a group lies within the block: cell indices at
    most 2 apart per axis, which ``render_rays`` checks as
    (g-1) * step_ratio <= 2. K1 gathers the rows (16C floats: its wide
    route) and K2 scatters their gradient; the weights are linear in the
    clipped fractional offsets, so the lookup is twice differentiable in
    the coordinates and the plane. Returns [..., g, C].
    """
    H, W, C = plane.shape
    with span("plane_pack"):
        packed = torch.cat([plane[dy:H - 3 + dy, dx:W - 3 + dx]
                            for dy in range(4) for dx in range(4)], -1)
        packed = packed.reshape((H - 3) * (W - 3), 16 * C)
    ix = _unnormalize(x, W, True)
    iy = _unnormalize(y, H, True)
    ix0 = torch.floor(ix).clamp(0, W - 2)
    iy0 = torch.floor(iy).clamp(0, H - 2)
    bx = ix0.amin(-1).clamp(0, W - 4)                            # [...]
    by = iy0.amin(-1).clamp(0, H - 4)
    idx = (by * (W - 3) + bx).to(torch.int32)
    rows = gather_rows(packed, idx.reshape(-1))
    rows = rows.reshape(*idx.shape, 4, 4, C)                     # dy, dx, C
    ox = (ix0 - bx[..., None])[..., None]                        # [..., g, 1]
    oy = (iy0 - by[..., None])[..., None]
    wx1 = clip(ix - ix0, 0.0, 1.0)[..., None]
    wy1 = clip(iy - iy0, 0.0, 1.0)[..., None]
    iota = torch.arange(4, dtype=plane.dtype, device=plane.device)
    zero = wx1.new_zeros(())
    Wx = (torch.where(iota == ox, 1.0 - wx1, zero)
          + torch.where(iota == ox + 1.0, wx1, zero))            # [..., g, 4]
    Wy = (torch.where(iota == oy, 1.0 - wy1, zero)
          + torch.where(iota == oy + 1.0, wy1, zero))
    return torch.einsum("...ga,...gb,...abc->...gc", Wy, Wx, rows)


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
