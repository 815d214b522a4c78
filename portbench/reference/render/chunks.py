"""Frozen copies of the port's eval chunk (``render/eval.py``), its
relight chunk (``render/relight_pipeline.py``) and the held-out light's
tables (``models/env_light.py``), without their file readers."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from portbench.reference.device import DeviceLike, resolve_device
from portbench.reference.models import field as F
from portbench.reference.models.lighting import latlong_lookup
from portbench.reference.ops.brdf import ggx_specular
from portbench.reference.ops.color import linear2srgb
from portbench.reference.ops.interp import clip, recip
from portbench.reference.ops.rays import safe_l2_normalize
from portbench.reference.render import secondary
from portbench.reference.render.primary import render_rays
from portbench.reference.render.train_render import render_train_batch

FAST_VIS = dict(window=48, window_back=16, prepass_n=12, dilate=3,
                bake_reso=128)


class EnvironmentLight:
    """Held-out probes by name, added with ``add_light``, on ``device``."""

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.rgbs: Dict[str, torch.Tensor] = {}
        self.pdf_return: Dict[str, torch.Tensor] = {}
        self.cdf: Dict[str, torch.Tensor] = {}
        self.dirs: Dict[str, torch.Tensor] = {}

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


def make_eval_chunk_fn(cfg: F.FieldConfig, *, n_samples: int, chunk: int,
                       is_relight: bool = True, white_bg: bool = True,
                       app_cap: int = 64, relight_ray_cap: int = 0,
                       second_n_sample: int = 96, second_near: float = 0.05,
                       second_far: float = 1.5, secondary_tile: int = 16384,
                       march_cap: int = 256, second_march_cap: int = 48,
                       second_window: int = 0, second_window_back: int = 0,
                       second_prepass_n: int = 18, coarse_dilate: int = 2,
                       secondary_compact_frac: float = 0.0,
                       secondary_bake_reso: int = 0, app_bake_reso: int = 0,
                       secondary_app_hoist: bool = False,
                       ndc_ray: bool = False):
    """(chunk_fn, chunk): ``chunk_fn(params, scene, rays [chunk, 6],
    light_idx [chunk])`` renders one chunk without gradients. The defaults
    are the exact full secondary march (the reference's eval protocol);
    FAST_MARCH_KNOBS switch the fast one on. ``relight_ray_cap`` 0 relights
    every ray of the chunk."""

    def chunk_fn(params, scene, rays, light_idx):
        with torch.no_grad():
            return render_train_batch(
                cfg, params, scene, rays, light_idx,
                n_samples=n_samples, key=None, is_train=False,
                is_relight=is_relight, white_bg=white_bg,
                sample_method="fixed_envirmap", app_cap=app_cap,
                march_cap=march_cap, second_march_cap=second_march_cap,
                relight_ray_cap=relight_ray_cap,
                second_window=second_window,
                second_window_back=second_window_back,
                second_prepass_n=second_prepass_n,
                coarse_dilate=coarse_dilate,
                secondary_compact_frac=secondary_compact_frac,
                secondary_bake_reso=secondary_bake_reso,
                app_bake_reso=app_bake_reso,
                secondary_app_hoist=secondary_app_hoist,
                second_n_sample=second_n_sample, second_near=second_near,
                second_far=second_far, secondary_tile=secondary_tile,
                ndc_ray=ndc_ray)

    return chunk_fn, chunk


def make_relight_chunk_fn(cfg: F.FieldConfig, env: EnvironmentLight,
                          light_name: str, *, n_samples: int,
                          n_light_samples: int = 512,
                          second_n_sample: int = 96,
                          vis_tile: int = 16384,
                          roughness_scale: float = 1.0,
                          fast_vis: bool = False):
    """One chunk relit under the held-out light ``light_name``:
    ``fn(params, scene, rays [B, 6], key, rescale3 [3], *, draws=None,
    vis_bakes=None)`` -> (relight_without_bg [B, 3], relight_with_bg
    [B, 3], acc [B], albedo [B, 3], roughness [B, 1], normal [B, 3],
    depth [B], rgb [B, 3]).

    The [B, n_light_samples] uniforms of the light draw come from ``key``
    (a generator on the field's device) or are given as ``draws``. With
    ``fast_vis`` visibility marches the window over ``vis_bakes`` =
    ``bake_visibility(...)`` (FAST_VIS), which it then needs; otherwise
    the exact VM field, on the first 48 occupied of 96 samples. As in the
    reference, the surface is where acc > 0.5 and visibility is the nerv
    transmittance of secondary rays over [0.05, 1.5].
    ``roughness_scale`` scales the decoded roughness (material editing)."""

    def chunk_fn(params, scene, rays, key, rescale3, *, draws=None,
                 vis_bakes=None):
        with torch.no_grad():
            baked = coarse = None
            if fast_vis:
                if vis_bakes is None:
                    raise ValueError("fast_vis needs vis_bakes = "
                                     "bake_visibility(cfg, params, scene)")
                baked, coarse = vis_bakes
            B = rays.shape[0]
            with record_function("primary"):
                out = render_rays(
                    cfg, params, scene, rays,
                    torch.zeros((B,), dtype=torch.int32, device=rays.device),
                    n_samples=n_samples, key=None, is_train=False,
                    is_relight=True, white_bg=True, app_cap=64,
                    march_cap=256)
            acc = out["acc_map"]
            acc_mask = acc > 0.5
            rays_o, rays_d = rays[:, :3], rays[:, 3:6]
            surface_xyz = rays_o + out["depth_map"][:, None] * rays_d
            normal = out["normal_map"]
            albedo = out["albedo_map"] * rescale3
            roughness = clip(out["roughness_map"] * roughness_scale, 0.0, 1.0)
            fresnel = out["fresnel_map"]

            surf2l, light_rgb, light_pdf = env.sample_light(
                light_name, B, n_light_samples, key, draws=draws)
            surf2c = safe_l2_normalize(-rays_d)
            cosine = clip(torch.einsum("plk,pk->pl", surf2l, normal), 0.0,
                          None)
            cosine_mask = (cosine > 1e-6) & acc_mask[:, None]

            # visibility of every (point, light sample) pair, in tiles
            p_tot = B * n_light_samples
            n_tiles = -(-p_tot // vis_tile)
            pad = n_tiles * vis_tile - p_tot
            pts = surface_xyz[:, None, :].expand(B, n_light_samples,
                                                 3).reshape(-1, 3)
            dirs = surf2l.reshape(-1, 3)
            mask = cosine_mask.reshape(-1)
            if pad:
                pts = torch.cat([pts, pts.new_zeros((pad, 3))])
                dirs = torch.cat([dirs, dirs.new_ones((pad, 3))])
                mask = torch.cat([mask, mask.new_zeros((pad,))])
            vis = []
            with record_function("visibility"):
                for t0 in range(0, n_tiles * vis_tile, vis_tile):
                    sl = slice(t0, t0 + vis_tile)
                    v, _ = secondary.compute_transmittance(
                        cfg, params, scene, pts[sl], dirs[sl],
                        n_sample=second_n_sample, vis_near=0.05,
                        vis_far=1.5, march_cap=48, baked=baked,
                        coarse=coarse,
                        window=FAST_VIS["window"] if fast_vis else 0,
                        window_back=FAST_VIS["window_back"],
                        prepass_n=FAST_VIS["prepass_n"])
                    vis.append(v * mask[sl].to(v.dtype))
                    secondary.MARCHED["pairs"] += min(vis_tile, p_tot - t0)
                    secondary.MARCHED["tiles"] += 1
            visibility = torch.cat(vis)[:p_tot].reshape(B, n_light_samples, 1)

            specular = ggx_specular(normal, surf2c, surf2l, roughness,
                                    fresnel)
            brdf = albedo[:, None, :] * recip(np.pi) + specular
            contrib = brdf * (visibility * light_rgb) * cosine[..., None] \
                / light_pdf
            rgb = contrib.sum(1) * recip(n_light_samples)
            rgb = linear2srgb(clip(rgb, 0.0, 1.0))

            without_bg = torch.where(acc_mask[:, None], rgb,
                                     torch.ones_like(rgb))
            bg = linear2srgb(clip(env.get_light(light_name, rays_d), 0.0,
                                  1.0))
            acc1 = acc[:, None]
            acc_bin = torch.where(acc1 <= 0.9, torch.zeros_like(acc1), acc1)
            with_bg = acc_bin * without_bg + (1.0 - acc_bin) * bg
            return (without_bg, with_bg, acc, albedo, roughness, normal,
                    out["depth_map"], out["rgb_map"])

    return chunk_fn
