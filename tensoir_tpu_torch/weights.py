"""Carry a field's parameters and scene over from numpy arrays.

The JAX package's ``params`` and ``scene`` pytrees, turned into numpy
arrays (``jax.tree.map(np.asarray, ...)``), become the port's dicts of
tensors under the same keys, with the same dtypes: the bf16
``alpha_volume_packed`` stays bf16 and the uint8 dilated mask stays uint8.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from tensoir_tpu_torch.device import DeviceLike, resolve_device


def _to_tensor(arr, dev: torch.device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        # numpy has no bf16 of its own: reinterpret the 16-bit pattern
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(arr, copy=True)).to(dev)


def _convert(tree: Dict, dev: torch.device) -> Dict:
    return {k: _convert(v, dev) if isinstance(v, dict) else _to_tensor(v, dev)
            for k, v in tree.items()}


def params_from_numpy(params_np: Dict, scene_np: Dict,
                      device: DeviceLike = None) -> Tuple[Dict, Dict]:
    """(params, scene) as tensors on ``device``."""
    dev = resolve_device(device)
    return _convert(params_np, dev), _convert(scene_np, dev)
