"""Image loading for the dataset loaders (the port's own copy of
tensoir_tpu.data.images, on the port's PNG reader instead of PIL).

A file whose size differs from the view's (``img_wh``) is resized on load,
as the JAX package does with PIL's ``Image.resize``: Lanczos for the
RGBA images, nearest for the normal maps. The resize here is numpy's,
written to give PIL's 8-bit results (the machine with the card has no
PIL):
- Lanczos runs PIL's two separable passes, the horizontal one first, with
  an 8-bit image between them, each output a sum of integer pixels times
  coefficients in 22-bit fixed point, rounded and clipped to 0..255;
- an RGBA image is resized premultiplied by its alpha (PIL's "RGBa") and
  converted back, as PIL does for every filter but nearest;
- a palette image is resized with nearest whatever the filter (PIL's rule
  for mode "P");
- nearest picks the source pixel under each output pixel's centre, the
  position stepped by repeated addition as PIL's affine scaler does.
"""
from __future__ import annotations

import math

import numpy as np

from tensoir_tpu_torch.utils.png import png_is_palette, read_png, write_png

_PRECISION_BITS = 32 - 8 - 2
_LANCZOS_SUPPORT = 3.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    if -_LANCZOS_SUPPORT <= x < _LANCZOS_SUPPORT:
        return _sinc(x) * _sinc(x / 3.0)
    return 0.0


def _lanczos_taps(in_size: int, out_size: int):
    """(first source index [out], integer coefficients [out, k]) of one
    Lanczos pass from ``in_size`` to ``out_size`` pixels, as PIL computes
    them: double-precision weights normalized per output pixel, then
    rounded to fixed point away from zero."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _LANCZOS_SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    first = np.zeros(out_size, np.int64)
    coef = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        for x, v in enumerate(w):
            if ww != 0.0:
                v /= ww
            coef[xx, x] = int((-0.5 if v < 0 else 0.5)
                              + v * (1 << _PRECISION_BITS))
        first[xx] = xmin
    return first, coef


def _lanczos_pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit Lanczos pass of uint8 ``img`` [H, W, C] along ``axis`` (1:
    horizontal, 0: vertical)."""
    in_size = img.shape[axis]
    first, coef = _lanczos_taps(in_size, out_size)
    src = np.moveaxis(img.astype(np.int64), axis, 0)      # [in, other, C]
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int64)
    for j in range(coef.shape[1]):
        idx = np.minimum(first + j, in_size - 1)           # weight 0 past
        acc += src[idx] * coef[:, j].reshape((-1,) + (1,) * (src.ndim - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255)
    return np.moveaxis(out.astype(np.uint8), 0, axis)


def _resize_lanczos(img: np.ndarray, size) -> np.ndarray:
    """PIL's Lanczos resize of a uint8 [H, W, C] image to (W', H')."""
    w_out, h_out = size
    if img.shape[1] != w_out:
        img = _lanczos_pass(img, w_out, 1)
    if img.shape[0] != h_out:
        img = _lanczos_pass(img, h_out, 0)
    return img


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """The source pixel under each output pixel's centre, its position
    accumulated step by step in double precision as PIL's scaler does."""
    step = in_size / out_size
    pos = step * 0.5
    idx = np.zeros(out_size, np.int64)
    for x in range(out_size):
        idx[x] = -1 if pos < 0.0 else int(pos)
        pos += step
    return idx


def _resize_nearest(img: np.ndarray, size) -> np.ndarray:
    w_out, h_out = size
    return img[_nearest_index(img.shape[0], h_out)][
        :, _nearest_index(img.shape[1], w_out)]


def _mul_div_255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    tmp = a.astype(np.int64) * b + 128
    return ((tmp >> 8) + tmp) >> 8


def _premultiply(rgba: np.ndarray) -> np.ndarray:
    """PIL's RGBA -> RGBa: each colour times alpha / 255, rounded."""
    out = rgba.copy()
    alpha = rgba[..., 3:4].astype(np.int64)
    out[..., :3] = _mul_div_255(rgba[..., :3], alpha).astype(np.uint8)
    return out


def _unpremultiply(rgba: np.ndarray) -> np.ndarray:
    """PIL's RGBa -> RGBA: each colour times 255 / alpha, truncated and
    clipped; kept as it is where alpha is 0 or 255."""
    out = rgba.copy()
    alpha = rgba[..., 3:4].astype(np.int64)
    keep = (alpha == 0) | (alpha == 255)
    scaled = np.minimum(255 * rgba[..., :3].astype(np.int64)
                        // np.maximum(alpha, 1), 255)
    out[..., :3] = np.where(keep, rgba[..., :3], scaled).astype(np.uint8)
    return out


def resize_like_pil(img: np.ndarray, size, lanczos: bool,
                    palette: bool = False) -> np.ndarray:
    """``np.asarray(Image.fromarray(img).resize(size, LANCZOS or NEAREST))``
    for a uint8 image [H, W] (grey, or palette indices with ``palette``),
    [H, W, 3] or [H, W, 4]; ``size`` is (width, height)."""
    size = (int(size[0]), int(size[1]))
    if (img.shape[1], img.shape[0]) == size:
        return img
    if not lanczos or palette:
        return _resize_nearest(img, size)
    grey = img.ndim == 2
    x = img[..., None] if grey else img
    if x.shape[-1] == 4:
        out = _unpremultiply(_resize_lanczos(_premultiply(x), size))
    else:
        out = _resize_lanczos(x, size)
    return out[..., 0] if grey else out


def _read(path, img_wh, lanczos: bool) -> np.ndarray:
    img = read_png(path)
    if img_wh is not None and (img.shape[1], img.shape[0]) != tuple(img_wh):
        img = resize_like_pil(img, img_wh, lanczos, png_is_palette(path))
    return img


def load_rgba_white_composite(path, img_wh=None):
    """PNG -> white-composited float RGB [H*W, 3] and the alpha mask
    [H*W, 1] (alpha > 0); resized to ``img_wh`` (Lanczos) when given."""
    arr = np.asarray(_read(path, img_wh, lanczos=True), np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.stack([arr] * 3 + [np.ones_like(arr)], -1)
    if arr.shape[-1] == 3:
        alpha = np.ones(arr.shape[:2] + (1,), np.float32)
    else:
        alpha = arr[..., 3:4]
    rgb = arr[..., :3] * alpha + (1.0 - alpha)
    return rgb.reshape(-1, 3), (alpha.reshape(-1, 1) > 0)


def load_normal_png(path, img_wh=None):
    """normal.png -> unit normals [H*W, 3], +z where the alpha is 0;
    resized to ``img_wh`` (nearest) when given."""
    arr = np.asarray(_read(path, img_wh, lanczos=False), np.float32) / 255.0
    normal = (arr[..., :3] - 0.5) * 2.0
    if arr.shape[-1] >= 4:
        a = arr[..., 3:4]
        normal = normal * a + np.array([0.0, 0.0, 1.0]) * (1.0 - a)
    normal = normal / np.maximum(
        np.linalg.norm(normal, axis=-1, keepdims=True), 1e-8)
    return normal.reshape(-1, 3).astype(np.float32)


def save_png(path, img01):
    """float [H, W, 3] in [0, 1] -> 8-bit PNG, rounded."""
    arr = np.clip(np.asarray(img01) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    write_png(path, arr)
