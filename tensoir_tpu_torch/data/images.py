"""Image loading for the dataset loaders (the port's own copy of
tensoir_tpu.data.images, on the port's PNG reader instead of PIL).

The JAX package resizes a file whose size differs from the view's
(``img_wh``) with PIL's Lanczos or nearest filter; those resizes are not
ported, so such a file raises. Every shipped config loads at downsample 1.
"""
from __future__ import annotations

import numpy as np

from tensoir_tpu_torch.utils.png import read_png, write_png


def _read(path, img_wh) -> np.ndarray:
    img = read_png(path)
    size = (img.shape[1], img.shape[0])
    if img_wh is not None and size != tuple(img_wh):
        raise ValueError(
            f"{path}: {size[0]}x{size[1]} image for a {img_wh[0]}x{img_wh[1]} "
            f"view; resizing on load is not ported (set downsample so that "
            f"the view size equals the file's)")
    return img


def load_rgba_white_composite(path, img_wh=None):
    """PNG -> white-composited float RGB [H*W, 3] and the alpha mask
    [H*W, 1] (alpha > 0)."""
    arr = np.asarray(_read(path, img_wh), np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.stack([arr] * 3 + [np.ones_like(arr)], -1)
    if arr.shape[-1] == 3:
        alpha = np.ones(arr.shape[:2] + (1,), np.float32)
    else:
        alpha = arr[..., 3:4]
    rgb = arr[..., :3] * alpha + (1.0 - alpha)
    return rgb.reshape(-1, 3), (alpha.reshape(-1, 1) > 0)


def load_normal_png(path, img_wh=None):
    """normal.png -> unit normals [H*W, 3], +z where the alpha is 0."""
    arr = np.asarray(_read(path, img_wh), np.float32) / 255.0
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
