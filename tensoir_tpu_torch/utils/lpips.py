"""LPIPS v0.1 (Zhang et al.) in PyTorch: the port's counterpart of
tensoir_tpu.utils.lpips_jax, computed in NCHW with plain
``torch.nn.functional`` convolutions (the JAX package computes them with
``lax.conv`` outside any Pallas kernel).

  1. Inputs in [0, 1] are mapped to [-1, 1].
  2. ScalingLayer: (x - shift) / scale with lpips v0.1's constants.
  3. Backbone taps: torchvision AlexNet features (relu1..relu5) or VGG16
     features (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3).
  4. Per tap: unit-normalise over channels (eps 1e-10 outside the sqrt),
     squared difference, the non-negative 1x1 "lin" head, spatial mean;
     the sum over taps.

The trained weights do not ship with the repository. ``rgb_lpips``
(``utils/metrics.py``) computes LPIPS once a weights file converted by
``scripts/convert_lpips_weights.py`` is found (``$TENSOIR_LPIPS_WEIGHTS``
or ``./lpips_<net>.npz``); its layout is the JAX package's: conv{i}_w
[Kh, Kw, I, O], conv{i}_b [O], lin{t}_w [C], net.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as Fn

from tensoir_tpu_torch.device import DeviceLike, resolve_device

# lpips/lpips.py ScalingLayer constants (v0.1)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# torchvision AlexNet `features`: (out_ch, kernel, stride, pad), a tap after
# each ReLU; maxpool(3, 2) before the stages in _ALEX_POOL_BEFORE
ALEX_CONVS = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1),
               (256, 3, 1, 1), (256, 3, 1, 1)]
_ALEX_POOL_BEFORE = {1, 2}

# torchvision VGG16 `features` grouped by tap (3x3 convs, pad 1); maxpool(2,
# 2) between groups
VGG_GROUPS = [[64, 64], [128, 128], [256, 256, 256],
               [512, 512, 512], [512, 512, 512]]


def _alex_taps(params: Dict[str, torch.Tensor], x) -> List[torch.Tensor]:
    taps = []
    for i, (_, _, stride, pad) in enumerate(ALEX_CONVS):
        if i in _ALEX_POOL_BEFORE:
            x = Fn.max_pool2d(x, 3, 2)
        x = Fn.relu(Fn.conv2d(x, params[f"conv{i}_w"], params[f"conv{i}_b"],
                              stride=stride, padding=pad))
        taps.append(x)
    return taps


def _vgg_taps(params: Dict[str, torch.Tensor], x) -> List[torch.Tensor]:
    taps = []
    ci = 0
    for gi, group in enumerate(VGG_GROUPS):
        if gi > 0:
            x = Fn.max_pool2d(x, 2, 2)
        for _ in group:
            x = Fn.relu(Fn.conv2d(x, params[f"conv{ci}_w"],
                                  params[f"conv{ci}_b"], padding=1))
            ci += 1
        taps.append(x)
    return taps


@torch.no_grad()
def lpips_distance(params: Dict[str, torch.Tensor], img0, img1,
                   net: str = "alex") -> torch.Tensor:
    """LPIPS distance [N] between two [H, W, 3] (or [N, H, W, 3]) images in
    [0, 1], on the device of ``params`` (``load_lpips_params``: OIHW
    convolution weights, lin{t}_w [C])."""
    dev = params["conv0_w"].device
    x0 = torch.as_tensor(np.asarray(img0, np.float32), device=dev)
    x1 = torch.as_tensor(np.asarray(img1, np.float32), device=dev)
    if x0.ndim == 3:
        x0, x1 = x0[None], x1[None]
    x = 2.0 * torch.cat([x0, x1], 0).permute(0, 3, 1, 2) - 1.0   # NCHW
    shift = torch.as_tensor(_SHIFT, device=dev).view(1, 3, 1, 1)
    scale = torch.as_tensor(_SCALE, device=dev).view(1, 3, 1, 1)
    x = (x - shift) / scale
    taps = (_alex_taps if net == "alex" else _vgg_taps)(params, x)
    n = x0.shape[0]
    total = torch.zeros((n,), device=dev)
    for t, f in enumerate(taps):
        f = f / (torch.sqrt(torch.sum(f ** 2, 1, keepdim=True)) + 1e-10)
        d = (f[:n] - f[n:]) ** 2                             # [N, C, h, w]
        w = params[f"lin{t}_w"].view(1, -1, 1, 1)
        total = total + torch.mean(torch.sum(d * w, 1), dim=(1, 2))
    return total


def load_lpips_params(path: str, device: DeviceLike = None):
    """(params, net) of a converted weights npz, the convolution weights
    turned to OIHW, on ``device`` (None: the card)."""
    dev = resolve_device(device)
    with np.load(path) as z:
        net = str(z["net"]) if "net" in z.files else "alex"
        params = {}
        for k in z.files:
            if k == "net":
                continue
            v = np.asarray(z[k], np.float32)
            if k.startswith("conv") and k.endswith("_w"):
                v = np.transpose(v, (3, 2, 0, 1))               # HWIO -> OIHW
            params[k] = torch.as_tensor(np.ascontiguousarray(v), device=dev)
    return params, net
