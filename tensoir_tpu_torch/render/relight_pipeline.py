"""The relighting benchmark (port of tensoir_tpu.render.relight_pipeline).

Per view: the G-buffer forward, then for each held-out environment map:
512 importance-sampled light directions per surface point, the hemisphere
mask, visibility by a transmittance march toward each, the Monte Carlo
estimate mean(brdf * vis * L * cos / pdf), sRGB, the probe behind the
object where acc <= 0.9, and PSNR/SSIM against the ground truth.

Rays go in fixed chunks; the surface mask is dense (masked), not
compacted. A chunk is a plain closure under ``torch.no_grad()`` on the
device that holds the field: nothing is compiled, and K2 never runs. A
view's rays go to the device once; each chunk's two relit images (and,
for the first light of a saved view, its G-buffer maps) come back in one
transfer. With ``fast_vis`` the baked sigma grid and its coarse occupancy
are made once per ``relight_benchmark`` call (the parameters do not
change), where the JAX package bakes inside every jitted chunk call; the
result is the same.
"""
from __future__ import annotations

import os
from typing import Dict, Iterator, Optional

import numpy as np
import torch
from torch.profiler import record_function

from tensoir_tpu_torch.models import field as F
from tensoir_tpu_torch.models.env_light import EnvironmentLight
from tensoir_tpu_torch.ops.brdf import ggx_specular
from tensoir_tpu_torch.ops.color import linear2srgb
from tensoir_tpu_torch.ops.interp import clip, recip
from tensoir_tpu_torch.ops.rays import safe_l2_normalize
from tensoir_tpu_torch.render import secondary
from tensoir_tpu_torch.render.primary import render_rays
from tensoir_tpu_torch.utils import metrics as M
from tensoir_tpu_torch.utils.png import read_png, write_png
from tensoir_tpu_torch.utils.video import write_videos

# the fast visibility march's knobs: the 128^3 sigma bake, its coarse
# occupancy dilated by 3, and the 48/16 window after a 12-point prepass
FAST_VIS = dict(window=48, window_back=16, prepass_n=12, dilate=3,
                bake_reso=128)


def bake_visibility(cfg: F.FieldConfig, params: Dict, scene: Dict):
    """(baked sigma grid, coarse occupancy) of the fast visibility march."""
    with torch.no_grad():
        baked = F.bake_packed_sigma_grid(cfg, params, scene,
                                         max_reso=FAST_VIS["bake_reso"])
        return baked, F.bake_coarse_occupancy(baked,
                                              dilate=FAST_VIS["dilate"])


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


def _to8(x):
    return (np.clip(x, 0, 1) * 255).astype(np.uint8)


def relight_benchmark(
    cfg: F.FieldConfig,
    params: Dict,
    scene: Dict,
    dataset,
    env: EnvironmentLight,
    *,
    n_samples: int,
    save_path: Optional[str] = None,
    chunk: int = 1024,
    n_light_samples: int = 512,
    second_n_sample: int = 96,
    vis_tile: int = 16384,
    rescale3=None,
    seed: int = 20211202,
    compute_extra_metrics: bool = False,
    fast_vis: bool = False,
    draws: Optional[Iterator] = None,
) -> Dict[str, Dict[str, float]]:
    """The relighting eval of every view under each of the dataset's
    lights that ``env`` holds: {light: {psnr, ssim}}, on the
    white-background image, as the reference scores it. With
    ``save_path`` also the reference's artifact tree. The light draws come
    from a generator seeded with ``seed``, one [chunk, n_light_samples]
    draw per chunk call in the order view, light, chunk; ``draws``, an
    iterator of such uniforms, replaces them (to replay another package's
    draws)."""
    dev = scene["aabb"].device
    vis_bakes = None
    if fast_vis:
        # the window march's contract against this checkpoint's (possibly
        # shrunk) box
        F.check_march_contract(scene["aabb"].cpu().numpy(),
                               prepass_n=FAST_VIS["prepass_n"],
                               dilate=FAST_VIS["dilate"])
        vis_bakes = bake_visibility(cfg, params, scene)
    light_names = [n for n in dataset.light_names if n in env.rgbs]
    rescale3 = torch.as_tensor(
        np.ones(3) if rescale3 is None else np.asarray(rescale3),
        dtype=torch.float32, device=dev)

    chunk_fns = {
        name: make_relight_chunk_fn(
            cfg, env, name, n_samples=n_samples,
            n_light_samples=n_light_samples,
            second_n_sample=second_n_sample, vis_tile=vis_tile,
            fast_vis=fast_vis)
        for name in light_names}

    key = torch.Generator(device=dev).manual_seed(seed)
    psnrs = {n: [] for n in light_names}
    ssims = {n: [] for n in light_names}
    lpips_scores = {n: [] for n in light_names}
    split = getattr(dataset, "split", "test")
    rgb_frames, normal_frames = [], []
    albedo_frames, roughness_frames = [], []
    view_dirs = []

    for vi in range(len(dataset)):
        item = dataset[vi]
        W, H = item["img_wh"]
        rays = np.asarray(item["rays"], np.float32)
        n = rays.shape[0]
        pad = -n % chunk
        if pad:  # the last chunk repeats its last ray
            rays = np.concatenate([rays, np.repeat(rays[-1:], pad, 0)], 0)
        rays_d = torch.as_tensor(rays, device=dev)
        view_dir = (os.path.join(save_path, f"{split}_{vi:03d}")
                    if save_path else None)
        gbuf = None
        for li, name in enumerate(light_names):
            gt = np.asarray(item["rgbs"][dataset.light_names.index(name)])
            # the G-buffer maps do not depend on the held-out light: they
            # come back with the first light's chunks of a saved view
            want_gbuf = li == 0 and view_dir is not None
            parts = []
            for start in range(0, n + pad, chunk):
                u = None if draws is None else next(draws)
                outs = chunk_fns[name](params, scene,
                                       rays_d[start:start + chunk], key,
                                       rescale3, draws=u,
                                       vis_bakes=vis_bakes)
                cols = outs if want_gbuf else outs[:2]
                parts.append(torch.cat([c.reshape(chunk, -1).float()
                                        for c in cols], 1).cpu().numpy())
            flat = np.concatenate(parts, 0)[:n]
            img_wo = flat[:, 0:3].reshape(H, W, 3)
            img_with = flat[:, 3:6].reshape(H, W, 3)
            if want_gbuf:
                # acc, albedo, roughness, normal, depth, rgb
                gbuf = np.split(flat[:, 6:], [1, 4, 5, 8, 9], axis=1)
            gt_img = gt.reshape(H, W, 3)
            # the reference scores the white-background image against the
            # white-composited ground truth
            psnrs[name].append(M.psnr(img_wo, gt_img))
            ssims[name].append(M.rgb_ssim(img_wo, gt_img))
            if compute_extra_metrics:
                lp = M.rgb_lpips(gt_img, img_wo)
                if lp is not None:
                    lpips_scores[name].append(lp)
            if view_dir:
                for sub_d, img in (("relighting_with_bg", img_with),
                                   ("relighting_without_bg", img_wo)):
                    d = os.path.join(view_dir, sub_d)
                    os.makedirs(d, exist_ok=True)
                    write_png(os.path.join(d, f"{name}.png"), _to8(img))
        if view_dir:
            view_dirs.append(view_dir)
            with open(os.path.join(view_dir, "relighting_without_bg",
                                   "relight_psnr.txt"), "w") as f:
                for name in light_names:
                    f.write(f"{name}: PSNR {psnrs[name][-1]}; "
                            f"SSIM {ssims[name][-1]}\n")
            _save_gbuffer_artifacts(
                view_dir, gbuf, item, H, W,
                near_far=getattr(dataset, "near_far", None),
                rgb_frames=rgb_frames, normal_frames=normal_frames,
                albedo_frames=albedo_frames,
                roughness_frames=roughness_frames)

    results = {}
    for name in light_names:
        results[name] = {"psnr": float(np.mean(psnrs[name])),
                         "ssim": float(np.mean(ssims[name]))}
        if lpips_scores[name]:
            results[name]["lpips"] = float(np.mean(lpips_scores[name]))
    if save_path:
        with open(os.path.join(save_path, "relight_psnr.txt"), "a") as f:
            for name, r in results.items():
                f.write(f"{name}: " + ", ".join(
                    f"{k}: {v:.4f}" for k, v in r.items()) + "\n")
        write_videos(os.path.join(save_path, "video"),
                     [("rgb_video", rgb_frames),
                      ("render_normal_video", normal_frames),
                      ("aligned_albedo_video", albedo_frames),
                      ("roughness_video", roughness_frames)], tag="relight")
        # each light's relit views, read back from their PNGs
        for sub_d, out_d in (("relighting_without_bg", "video_without_bg"),
                             ("relighting_with_bg", "video_with_bg")):
            write_videos(os.path.join(save_path, out_d), [
                (f"{name}_video",
                 [read_png(os.path.join(vd, sub_d, f"{name}.png"))
                  for vd in view_dirs])
                for name in light_names], tag="relight")
    return results


def _save_gbuffer_artifacts(view_dir, gbuf, item, H, W, *, near_far,
                            rgb_frames, normal_frames, albedo_frames,
                            roughness_frames):
    """A view's G-buffer PNGs: rgb, acc, depth, the albedo rescaled by the
    per-view median ratio to the GT albedo (linear and gamma), the GT
    albedo (gamma), roughness and normals, each but rgb, acc and depth with
    the acc map as alpha; and the frames of the G-buffer videos."""
    acc, albedo, roughness, normal, depth, rgb = gbuf
    acc8 = _to8(acc.reshape(H, W, 1))

    def with_alpha(img8):
        return np.concatenate([img8, acc8], axis=2)

    rgb8 = _to8(rgb.reshape(H, W, 3))
    write_png(os.path.join(view_dir, "rgb.png"), rgb8)
    rgb_frames.append(rgb8)
    write_png(os.path.join(view_dir, "acc.png"), acc8[..., 0])
    if near_far is not None:
        write_png(os.path.join(view_dir, "depth.png"),
                  M.visualize_depth(depth.reshape(H, W), near_far))

    # per-view 3-channel median rescale against the GT albedo over the GT
    # mask
    albedo = albedo.reshape(H, W, 3).copy()
    gt_albedo = item.get("albedo")
    gt_mask = item.get("rgbs_mask")
    if gt_albedo is not None and gt_mask is not None:
        gt_albedo = np.asarray(gt_albedo).reshape(H, W, 3)
        m = np.asarray(gt_mask).reshape(H, W) > 0.5
        if m.any():
            ratio = np.median(
                gt_albedo[m] / np.clip(albedo[m], 1e-6, None), axis=0)
            albedo[m] = np.clip(ratio * albedo[m], 0.0, 1.0)
        write_png(os.path.join(view_dir, "gt_albedo_gamma_corrected.png"),
                  with_alpha(_to8(gt_albedo ** (1 / 2.2))))
    write_png(os.path.join(view_dir, "albedo.png"), with_alpha(_to8(albedo)))
    albedo_gamma8 = _to8(albedo ** (1 / 2.2))
    write_png(os.path.join(view_dir, "albedo_gamma_corrected.png"),
              with_alpha(albedo_gamma8))
    albedo_frames.append(albedo_gamma8)

    rough8 = _to8(np.broadcast_to(roughness.reshape(H, W, 1), (H, W, 3)))
    write_png(os.path.join(view_dir, "roughness.png"), with_alpha(rough8))
    roughness_frames.append(rough8)

    nrm = normal.reshape(H, W, 3)
    nrm = nrm / np.clip(np.linalg.norm(nrm, axis=-1, keepdims=True),
                        1e-12, None)
    nrm8 = _to8(nrm * 0.5 + 0.5)
    write_png(os.path.join(view_dir, "normal.png"), with_alpha(nrm8))
    # the video frame: the normals over white where acc is low
    m3 = (acc.reshape(H, W, 1) > 0.5).astype(np.float32)
    normal_frames.append((nrm8 * m3 + 255.0 * (1.0 - m3)).astype(np.uint8))
