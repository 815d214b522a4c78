"""The held-out environment lights of relighting (port of
tensoir_tpu.models.env_light): per-probe importance-sampling tables and
lookups.

The tables are built in float64 numpy, as the JAX package builds them, and
cast to float32: a float32 cumulative sum over the 2,097,152 texels of a
2k probe drifts, and the drift moves the texel an inverse-CDF draw picks.
They live on the device the lights are made for (five 1024 x 2048 probes
take about 400 MB). A draw is the reference's multinomial as CDF
inversion: one uniform per (point, sample), ``searchsorted`` on the CDF.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from tensoir_tpu_torch.data.hdr import read_hdr
from tensoir_tpu_torch.device import DeviceLike, resolve_device
from tensoir_tpu_torch.models.lighting import latlong_lookup


class EnvironmentLight:
    """Every ``.hdr`` probe of ``hdr_dir`` (none when it is None), by file
    stem, on ``device`` (None: the card)."""

    def __init__(self, hdr_dir: Optional[str], device: DeviceLike = None):
        self.device = resolve_device(device)
        self.rgbs: Dict[str, torch.Tensor] = {}
        self.pdf_return: Dict[str, torch.Tensor] = {}
        self.cdf: Dict[str, torch.Tensor] = {}
        self.dirs: Dict[str, torch.Tensor] = {}
        if hdr_dir is None:
            return
        for fname in sorted(os.listdir(hdr_dir)):
            if fname.endswith(".hdr"):
                self.add_light(fname.split(".")[0],
                               read_hdr(os.path.join(hdr_dir, fname)))

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr, np.float32), device=self.device)

    def add_light(self, name: str, img: np.ndarray) -> None:
        """The tables of one probe [H, W, 3]: pdf proportional to intensity
        times sin(theta), its CDF, the pdf per solid angle each draw
        returns, and the texels' directions."""
        H, W, _ = img.shape
        intensity = img.sum(-1)                                     # [H, W]
        h_int = 1.0 / H
        sin_theta = np.sin(np.linspace(0.5 * h_int, np.pi - 0.5 * h_int, H))
        pdf = intensity * sin_theta[:, None]
        pdf_sample = pdf / pdf.sum()
        pdf_return = pdf_sample * H * W / (2 * np.pi ** 2 * sin_theta[:, None])

        lat_step = np.pi / H
        lng_step = 2 * np.pi / W
        phi = np.linspace(np.pi / 2 - 0.5 * lat_step,
                          -np.pi / 2 + 0.5 * lat_step, H)
        theta = np.linspace(np.pi - 0.5 * lng_step, -np.pi + 0.5 * lng_step, W)
        phi, theta = np.meshgrid(phi, theta, indexing="ij")
        dirs = np.stack([np.cos(theta) * np.cos(phi),
                         np.sin(theta) * np.cos(phi), np.sin(phi)], -1)

        self.rgbs[name] = self._put(img)
        self.pdf_return[name] = self._put(pdf_return.reshape(-1))
        self.cdf[name] = self._put(np.cumsum(pdf_sample.reshape(-1)))
        self.dirs[name] = self._put(dirs.reshape(-1, 3))

    @property
    def light_names(self):
        return list(self.rgbs.keys())

    def sample_light(self, name: str, bs: int, num_samples: int,
                     key: Optional[torch.Generator] = None, *,
                     draws: Optional[torch.Tensor] = None):
        """Light directions for each of ``bs`` surface points, drawn from
        the probe's importance pdf: (dir [bs, n, 3],
        rgb [bs, n, 3], pdf [bs, n, 1]). The [bs, n] uniforms come from
        ``key`` (a generator on the tables' device), or are given as
        ``draws``, so that a test can pass the JAX package's own."""
        cdf = self.cdf[name]
        n_tex = cdf.shape[0]
        if draws is None:
            u = torch.rand((bs, num_samples), generator=key,
                           device=self.device)
        else:
            if not isinstance(draws, torch.Tensor):
                draws = torch.from_numpy(np.array(draws, np.float32))
            u = draws.to(self.device, torch.float32).reshape(bs, num_samples)
        idx = torch.searchsorted(cdf, u.reshape(-1), right=True).clamp(
            0, n_tex - 1)
        light_dir = self.dirs[name][idx].reshape(bs, num_samples, 3)
        light_rgb = self.rgbs[name].reshape(-1, 3)[idx].reshape(
            bs, num_samples, 3)
        light_pdf = self.pdf_return[name][idx].reshape(bs, num_samples, 1)
        return light_dir, light_rgb, light_pdf

    def get_light(self, name: str, dirs: torch.Tensor) -> torch.Tensor:
        """The probe at directions [..., 3]: bilinear, ``align_corners``,
        zero outside the map."""
        return latlong_lookup(self.rgbs[name], dirs, align_corners=True,
                              padding="zeros")
