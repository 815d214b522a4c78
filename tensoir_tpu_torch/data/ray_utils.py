"""Camera / ray math on the host (numpy; the port's own copy of
tensoir_tpu.data.ray_utils).

Replaces dataLoader/ray_utils.py:25-88 (kornia.create_meshgrid becomes a
trivial meshgrid). All outputs are float32 numpy; device transfer happens at
batch time.
"""
from __future__ import annotations

import numpy as np


def _pixel_grid(h: int, w: int):
    """Pixel-center grid, matching kornia.create_meshgrid(normalized=False)+0.5."""
    j, i = np.meshgrid(np.arange(h, dtype=np.float32) + 0.5,
                       np.arange(w, dtype=np.float32) + 0.5, indexing="ij")
    return i, j


def get_ray_directions(h: int, w: int, focal, center=None) -> np.ndarray:
    """OpenCV convention: +x right, +y down, +z forward
    (dataLoader/ray_utils.py:25-43)."""
    fx, fy = (focal, focal) if np.isscalar(focal) else (focal[0], focal[1])
    i, j = _pixel_grid(h, w)
    cx, cy = center if center is not None else (w / 2, h / 2)
    dirs = np.stack([(i - cx) / fx, (j - cy) / fy, np.ones_like(i)], -1)
    return dirs.astype(np.float32)


def get_ray_directions_blender(h: int, w: int, focal, center=None) -> np.ndarray:
    """Blender/OpenGL convention: +x right, -y down->up flip, -z forward
    (dataLoader/ray_utils.py:46-64)."""
    fx, fy = (focal, focal) if np.isscalar(focal) else (focal[0], focal[1])
    i, j = _pixel_grid(h, w)
    cx, cy = center if center is not None else (w / 2, h / 2)
    dirs = np.stack([(i - cx) / fx, -(j - cy) / fy, -np.ones_like(i)], -1)
    return dirs.astype(np.float32)


def get_rays(directions: np.ndarray, c2w: np.ndarray):
    """World-space (origins, directions), flattened [H*W, 3]
    (dataLoader/ray_utils.py:67-88). Directions are NOT normalized (matches
    the reference's choice; z_vals are metric along the unnormalized dir)."""
    rays_d = directions @ c2w[:3, :3].T
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape)
    return (rays_o.reshape(-1, 3).astype(np.float32),
            rays_d.reshape(-1, 3).astype(np.float32))


def look_at(eye, target=(0.0, 0.0, 0.0), up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """Blender-style c2w (camera -z looks at target). [3, 4]."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    forward = target - eye
    forward /= np.linalg.norm(forward)
    right = np.cross(forward, up)
    right /= np.linalg.norm(right)
    true_up = np.cross(right, forward)
    c2w = np.stack([right, true_up, -forward, eye], axis=1)  # [3, 4]
    return c2w.astype(np.float32)


def read_pfm(filename):
    """Portable FloatMap reader (dataLoader/ray_utils.py:232-267)."""
    import re as _re
    with open(filename, "rb") as f:
        header = f.readline().decode("utf-8").rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError("Not a PFM file.")
        dim_match = _re.match(r"^(\d+)\s(\d+)\s$",
                              f.readline().decode("utf-8"))
        if not dim_match:
            raise ValueError("Malformed PFM header.")
        width, height = map(int, dim_match.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape)), scale
