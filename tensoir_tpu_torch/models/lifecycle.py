"""Grid-size helpers of the coarse-to-fine schedule (port of
tensoir_tpu.models.lifecycle: ``n_to_reso`` and ``cal_n_samples``)."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def n_to_reso(n_voxels: int, aabb) -> Tuple[int, int, int]:
    """Voxel count -> per-axis resolution."""
    aabb = np.asarray(aabb).reshape(2, 3)
    size = aabb[1] - aabb[0]
    voxel_size = (np.prod(size) / n_voxels) ** (1.0 / 3.0)
    return tuple(int(v) for v in (size / voxel_size))


def cal_n_samples(reso, step_ratio: float = 0.5) -> int:
    return int(np.linalg.norm(np.asarray(reso, np.float64)) / step_ratio)
