"""Evaluation metrics (the port's own copy of tensoir_tpu.utils.metrics):
PSNR, the mipnerf SSIM, normal MAE, LPIPS (``utils/lpips.py``; None
without a weights file) and the JET depth colouring, on numpy arrays."""
from __future__ import annotations

import os

import numpy as np
import scipy.signal


def mse2psnr(mse: float) -> float:
    with np.errstate(divide="ignore"):  # mse == 0 -> inf, silently
        return float(-10.0 * np.log(mse) / np.log(10.0))


def psnr(img, gt) -> float:
    return mse2psnr(float(np.mean((np.asarray(img) - np.asarray(gt)) ** 2)))


def rgb_ssim(img0, img1, max_val=1.0, filter_size=11, filter_sigma=1.5,
             k1=0.01, k2=0.03, return_map=False):
    """mipnerf SSIM with a separable float64 Gaussian of 11 taps, 'valid'
    convolutions, on [H, W, 3] images."""
    img0 = np.asarray(img0, np.float64)
    img1 = np.asarray(img1, np.float64)
    assert img0.ndim == 3 and img0.shape[-1] == 3 and img0.shape == img1.shape

    hw = filter_size // 2
    shift = (2 * hw - filter_size + 1) / 2
    f_i = ((np.arange(filter_size) - hw + shift) / filter_sigma) ** 2
    filt = np.exp(-0.5 * f_i)
    filt /= np.sum(filt)

    def convolve2d(z, f):
        return scipy.signal.convolve2d(z, f, mode="valid")

    def filt_fn(z):
        return np.stack([
            convolve2d(convolve2d(z[..., i], filt[:, None]), filt[None, :])
            for i in range(z.shape[-1])], -1)

    mu0 = filt_fn(img0)
    mu1 = filt_fn(img1)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    sigma00 = filt_fn(img0 ** 2) - mu00
    sigma11 = filt_fn(img1 ** 2) - mu11
    sigma01 = filt_fn(img0 * img1) - mu01
    sigma00 = np.maximum(0.0, sigma00)
    sigma11 = np.maximum(0.0, sigma11)
    sigma01 = np.sign(sigma01) * np.minimum(
        np.sqrt(sigma00 * sigma11), np.abs(sigma01))
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    numer = (2 * mu01 + c1) * (2 * sigma01 + c2)
    denom = (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2)
    ssim_map = numer / denom
    return ssim_map if return_map else float(np.mean(ssim_map))


def normal_mae_deg(pred, gt) -> float:
    """Mean angular error in degrees."""
    dots = np.clip(np.sum(np.asarray(pred) * np.asarray(gt), axis=-1), -1, 1)
    return float(np.mean(np.arccos(dots)) * 180.0 / np.pi)


def find_lpips_weights(net_name: str):
    """A converted LPIPS weights file for ``net_name``
    ($TENSOIR_LPIPS_WEIGHTS, else ./lpips_<net>.npz; its ``net`` field, if
    any, must name the net), or None."""
    for path in (os.environ.get("TENSOIR_LPIPS_WEIGHTS", ""),
                 f"lpips_{net_name}.npz"):
        if not path or not os.path.exists(path):
            continue
        try:
            with np.load(path) as z:
                file_net = str(z["net"]) if "net" in z.files else "alex"
        except (OSError, ValueError):
            continue
        if file_net == net_name:
            return path
    return None


_LPIPS_PARAMS = {}


def rgb_lpips(gt, im, net_name="alex", device=None):
    """LPIPS v0.1 of two [H, W, 3] images in [0, 1], on ``device`` (None:
    the card). No weights ship with the repo: without a converted weights
    file (``find_lpips_weights``) this returns None, as the JAX package
    does. The parameters are loaded once per file, net and device."""
    path = find_lpips_weights(net_name)
    if path is None:
        return None
    from tensoir_tpu_torch.device import resolve_device
    from tensoir_tpu_torch.utils import lpips
    dev = resolve_device(device)
    key = (path, net_name, str(dev))
    if key not in _LPIPS_PARAMS:
        _LPIPS_PARAMS[key] = lpips.load_lpips_params(path, dev)[0]
    d = lpips.lpips_distance(_LPIPS_PARAMS[key], gt, im, net=net_name)
    return float(d[0])


def _jet_table() -> np.ndarray:
    """cv2.COLORMAP_JET as RGB uint8 [256, 3]: piecewise-linear ramps of 4
    levels per entry, and OpenCV's own value at the one entry (159) where
    its table, generated from rounded floats, has blue 1 instead of 2."""
    i = 4 * np.arange(256)
    lut = np.stack([np.minimum(i - 382, 1148 - i),
                    np.minimum(i - 128, 892 - i),
                    np.minimum(i + 128, 638 - i)], -1)
    lut = np.clip(lut, 0, 255).astype(np.uint8)
    lut[159, 2] = 1
    return lut


JET = _jet_table()


def visualize_depth(depth, minmax=None):
    """JET-coloured depth, uint8 [H, W, 3] (RGB)."""
    x = np.nan_to_num(np.asarray(depth))
    if minmax is None:
        pos = x[x > 0]
        mi = np.min(pos) if pos.size else 0.0
        ma = np.max(x)
    else:
        mi, ma = minmax
    x = (x - mi) / (ma - mi + 1e-8)
    x = (255 * np.clip(x, 0, 1)).astype(np.uint8)
    return JET[x]
