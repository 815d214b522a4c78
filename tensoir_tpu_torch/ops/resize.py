"""Bicubic resize of uint8 images as ``cv2.resize(img, (w, h),
interpolation=cv2.INTER_CUBIC)`` computes it, in numpy on the host (the
eval's environment-map strip; the machine with the card has no cv2).

OpenCV's fixed-point path: source coordinate (dx + 0.5) * scale - 0.5 with
scale = 1 / (dst / src) in double, cast to float; four taps from the
cubic of a = -0.75 in float, scaled by 2048 and rounded to integers;
indices past the border clamped to the edge; a horizontal integer pass,
then a vertical one rounded by (v + 2^21) >> 22 and saturated to [0, 255].
OpenCV's vectorised vertical pass rounds in float instead, so a few pixels
may differ from it by one level.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

_COEF_SCALE = 2048
_COEF_BITS = 11


def _cubic_weights(fx: np.ndarray) -> np.ndarray:
    """The four float32 tap weights [n, 4] at fractions fx [n] (float32)."""
    A = np.float32(-0.75)
    one = np.float32(1.0)
    x1 = fx + one
    c0 = ((A * x1 - np.float32(5) * A) * x1 + np.float32(8) * A) * x1 \
        - np.float32(4) * A
    c1 = ((A + np.float32(2)) * fx - (A + np.float32(3))) * fx * fx + one
    y = one - fx
    c2 = ((A + np.float32(2)) * y - (A + np.float32(3))) * y * y + one
    c3 = one - c0 - c1 - c2
    return np.stack([c0, c1, c2, c3], -1)


def _taps(n_out: int, n_in: int) -> Tuple[np.ndarray, np.ndarray]:
    """(source indices [n_out, 4], integer weights [n_out, 4]) of one
    axis."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    frac = (f - s).astype(np.float32)
    weights = np.rint(_cubic_weights(frac) * np.float32(_COEF_SCALE))
    idx = np.clip(s.astype(np.int64)[:, None] + np.arange(-1, 3)[None, :],
                  0, n_in - 1)
    return idx, weights.astype(np.int64)


def resize_cubic_u8(img: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """uint8 [H, W] or [H, W, C] resized to ``dsize`` = (width, height)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize_cubic_u8 takes uint8, not {img.dtype}")
    w_out, h_out = dsize
    h_in, w_in = img.shape[:2]
    xi, xw = _taps(w_out, w_in)
    yi, yw = _taps(h_out, h_in)
    src = img.astype(np.int64)
    # horizontal: [H_in, W_out, (C)]
    extra = (None,) * (img.ndim - 2)
    rows = (src[:, xi] * xw[(None, slice(None), slice(None)) + extra]).sum(2)
    # vertical: [H_out, W_out, (C)]
    out = (rows[yi] * yw[(slice(None), slice(None), None) + extra]).sum(1)
    out = (out + (1 << (2 * _COEF_BITS - 1))) >> (2 * _COEF_BITS)
    return np.clip(out, 0, 255).astype(np.uint8)
