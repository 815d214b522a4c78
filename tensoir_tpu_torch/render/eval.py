"""Evaluation (port of tensoir_tpu.render.eval): whole-image renders in
fixed-size chunks, the metrics, and the artifacts (image panels, the
environment-map strip, ``metrics_record.txt``, video frames).

A chunk renders through ``render_train_batch`` (no jitter, the fixed
lat-long light directions) under ``torch.no_grad()``, on the device that
holds the field. An image's rays go to the device once; each chunk's maps
come back in one transfer. The JAX package caches one jitted chunk
function per configuration; here the chunk function is a plain closure,
since nothing is compiled.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from tensoir_tpu_torch.models import field as F
from tensoir_tpu_torch.models import lighting
from tensoir_tpu_torch.ops.resize import resize_cubic_u8
from tensoir_tpu_torch.render.train_render import render_train_batch
from tensoir_tpu_torch.utils import metrics as M
from tensoir_tpu_torch.utils.png import write_png
from tensoir_tpu_torch.utils.video import write_videos

# the canonical fast-march knobs (bench.py's configuration): window march
# over the coarse occupancy, hemisphere-pair compaction, the 128^3 sigma
# bake and the 64^3 baked appearance
FAST_MARCH_KNOBS = dict(
    second_window=48, second_window_back=16, second_prepass_n=12,
    coarse_dilate=3, secondary_compact_frac=0.5625,
    secondary_bake_reso=128, app_bake_reso=64)


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


def render_image(chunk_fn, chunk: int, params, scene, rays: np.ndarray,
                 light_idx: np.ndarray) -> Dict[str, np.ndarray]:
    """Every map of at least one axis for rays [N, 6], in chunks of
    ``chunk``, the last one padded with copies of the last ray."""
    dev = scene["aabb"].device
    n = rays.shape[0]
    li = np.asarray(light_idx, np.int32).reshape(-1)
    pad = -n % chunk
    if pad:
        rays = np.concatenate([rays, np.repeat(rays[-1:], pad, 0)], 0)
        li = np.concatenate([li, np.repeat(li[-1:], pad, 0)], 0)
    rays_d = torch.as_tensor(np.asarray(rays, np.float32), device=dev)
    li_d = torch.as_tensor(li, device=dev)
    parts, layout = [], None
    for start in range(0, n + pad, chunk):
        out = chunk_fn(params, scene, rays_d[start:start + chunk],
                       li_d[start:start + chunk])
        maps = {k: v for k, v in out.items()
                if isinstance(v, torch.Tensor) and v.dim() >= 1}
        if layout is None:
            layout = [(k, v.shape[1:], v.dtype) for k, v in maps.items()]
        # one transfer per chunk: every map as float columns of one array
        parts.append(torch.cat([maps[k].reshape(chunk, -1).float()
                                for k, _, _ in layout], 1).cpu().numpy())
    flat = np.concatenate(parts, 0)[:n]
    merged, col = {}, 0
    for k, shape, dtype in layout:
        width = int(np.prod(shape))
        v = flat[:, col:col + width].reshape((n,) + tuple(shape))
        merged[k] = v > 0.5 if dtype == torch.bool else v
        col += width
    return merged


def compute_rescale_ratio(chunk_fn, chunk, params, scene, dataset,
                          sampled_num: int = 20):
    """Global albedo rescale ratios: the median over the masked pixels of
    sampled views of GT / prediction, of channel 0 and per channel."""
    n = len(dataset)
    sampled_num = min(sampled_num, n)
    interval = max(n // sampled_num, 1)
    gt_list, pred_list = [], []
    for i in range(sampled_num):
        item = dataset[i * interval]
        rays = np.asarray(item["rays"], np.float32)
        lidx = np.zeros((rays.shape[0], 1), np.int32)
        out = render_image(chunk_fn, chunk, params, scene, rays, lidx)
        mask = np.asarray(item["rgbs_mask"]).reshape(-1)
        gt_list.append(np.asarray(item["albedo"])[mask])
        pred_list.append(out["albedo_map"][mask])
    gt_all = np.concatenate(gt_list, 0)
    pred_all = np.concatenate(pred_list, 0)
    ratio = gt_all / np.clip(pred_all, 1e-6, None)
    return float(np.median(ratio[:, 0])), np.median(ratio, axis=0)


def _to8(x):
    return (np.clip(x, 0, 1) * 255).astype(np.uint8)


def _env_strip(cfg, params, scene, test_dataset) -> np.ndarray:
    """Every learned light at 256 x 512, gamma 2.2, stacked vertically;
    with a single light and a probe, the probe resized beside it."""
    _, strip_dirs = lighting.envmap_dirs(256, 512)
    with torch.no_grad():
        pred_envs = lighting.get_light_rgbs(
            params, cfg, torch.as_tensor(strip_dirs,
                                         device=scene["aabb"].device),
            gt_envmap=scene.get("gt_envmap"))
    pred_envs = pred_envs.cpu().numpy().reshape(-1, 256, 512, 3)
    pred_envs = np.uint8(np.clip(np.power(np.clip(pred_envs, 0, None),
                                          1 / 2.2), 0, 1) * 255)
    pred_env = pred_envs.reshape(-1, 512, 3)
    strip = [pred_env]
    probes = getattr(test_dataset, "lights_probes", None)
    if isinstance(probes, np.ndarray) and pred_envs.shape[0] == 1:
        gt_env = np.uint8(np.clip(np.power(
            np.clip(probes, 0, None), 1 / 2.2), 0, 1) * 255)
        strip = [resize_cubic_u8(gt_env, (512, 256)), pred_env]
    return np.concatenate(strip, 1)


def evaluation_iter(
    cfg: F.FieldConfig,
    params: Dict,
    scene: Dict,
    test_dataset,
    *,
    n_samples: int,
    save_path: Optional[str] = None,
    prtx: str = "",
    chunk: int = 4096,
    n_vis: int = 5,
    test_all: bool = False,
    compute_extra_metrics: bool = True,
    white_bg: bool = True,
    app_cap: int = 64,
    relight_ray_cap: int = 0,
    second_n_sample: int = 96,
    secondary_tile: int = 16384,
    light_idx_to_test: int = 0,
    ndc_ray: bool = False,
    fast_march: bool = False,
    logger=None,
    log_step: int = 0,
) -> Dict[str, float]:
    """Metrics of the field on ``test_dataset`` (psnr_nvs, psnr_nvs_brdf,
    with ``compute_extra_metrics`` the SSIMs, and where the dataset has the
    ground truth normal_mae_deg and the albedo PSNRs), on ``n_vis`` evenly
    spaced views or, with ``test_all``, on every view; with ``save_path``
    also the image panels, the environment strip, a line of
    ``metrics_record.txt`` and, with ``test_all``, the video frames.
    ``fast_march`` renders with FAST_MARCH_KNOBS, which is not
    metric-neutral: keep it off for any reported number."""
    if save_path:
        for sub in ("nvs_with_radiance_field", "nvs_with_brdf", "normal",
                    "brdf", "envir_map", "acc_map"):
            os.makedirs(os.path.join(save_path, sub), exist_ok=True)

    fast_knobs = dict(FAST_MARCH_KNOBS) if fast_march else {}
    if fast_march:
        # the window march's contract against this field's (possibly
        # shrunk) box: an explicit opt-in, so a violation raises
        F.check_march_contract(
            scene["aabb"].cpu().numpy(),
            prepass_n=FAST_MARCH_KNOBS["second_prepass_n"],
            dilate=FAST_MARCH_KNOBS["coarse_dilate"])
    chunk_fn, chunk = make_eval_chunk_fn(
        cfg, n_samples=n_samples, chunk=chunk, white_bg=white_bg,
        app_cap=app_cap, relight_ray_cap=relight_ray_cap,
        second_n_sample=second_n_sample, secondary_tile=secondary_tile,
        ndc_ray=ndc_ray, **fast_knobs)

    if save_path:
        env_panel = _env_strip(cfg, params, scene, test_dataset)
        write_png(os.path.join(save_path, "envir_map", f"{prtx}envirmap.png"),
                  env_panel)
        if logger is not None:
            logger.log_image(log_step, "eval/envmap", env_panel)

    num_test = len(test_dataset) if test_all else min(n_vis, len(test_dataset))
    test_duration = max(int(len(test_dataset) / num_test), 1)

    has_albedo = "albedo" in test_dataset[0] if len(test_dataset) else False
    global_single = global_three = None
    if test_all and has_albedo:
        # the rescale ratio reads only albedo_map, a primary-pass map: a
        # G-buffer chunk (one token ray through the BRDF integral, 8
        # secondary samples) skips the secondary march of every pixel
        gbuf_fn, gbuf_chunk = make_eval_chunk_fn(
            cfg, n_samples=n_samples, chunk=chunk, white_bg=white_bg,
            app_cap=app_cap, relight_ray_cap=1, second_n_sample=8,
            secondary_tile=1024, ndc_ray=ndc_ray)
        global_single, global_three = compute_rescale_ratio(
            gbuf_fn, gbuf_chunk, params, scene, test_dataset)

    psnrs, psnrs_brdf, ssims, ssims_brdf = [], [], [], []
    lpipss: Dict[str, list] = {}
    maes, albedo_single_sq, albedo_three_sq = [], [], []
    albedo_ssims: Dict[str, list] = {}
    n_frames = 0

    for vi in range(num_test):
        item = test_dataset[vi * test_duration]
        W, H = item["img_wh"]
        rays = np.asarray(item["rays"], np.float32)
        li = light_idx_to_test if item["rgbs"].shape[0] > light_idx_to_test else 0
        gt_rgb = np.asarray(item["rgbs"][li]).reshape(H, W, 3)
        lidx = np.asarray(item["light_idx"][li], np.int32).reshape(-1, 1)

        out = render_image(chunk_fn, chunk, params, scene, rays, lidx)
        rgb_map = np.clip(out["rgb_map"], 0, 1).reshape(H, W, 3)
        brdf_map = np.clip(out["rgb_with_brdf_map"], 0, 1).reshape(H, W, 3)
        normal_map = out["normal_map"].reshape(H, W, 3)
        albedo_map = out["albedo_map"].reshape(H, W, 3)
        roughness_map = out["roughness_map"].reshape(H, W)
        acc_map = out["acc_map"].reshape(H, W)

        psnrs.append(M.psnr(rgb_map, gt_rgb))
        psnrs_brdf.append(M.psnr(brdf_map, gt_rgb))
        if compute_extra_metrics:
            ssims.append(M.rgb_ssim(rgb_map, gt_rgb))
            ssims_brdf.append(M.rgb_ssim(brdf_map, gt_rgb))
            for net in ("alex", "vgg"):
                lp = M.rgb_lpips(gt_rgb, rgb_map, net)
                if lp is not None:
                    lpipss.setdefault(f"lpips_{net}", []).append(lp)
                lp = M.rgb_lpips(gt_rgb, brdf_map, net)
                if lp is not None:
                    lpipss.setdefault(f"lpips_{net}_brdf", []).append(lp)

        if "normals" in item:
            gt_n = np.asarray(item["normals"]).reshape(H, W, 3)
            gt_n = gt_n / np.maximum(
                np.linalg.norm(gt_n, axis=-1, keepdims=True), 1e-6)
            pred_n = normal_map / np.maximum(
                np.linalg.norm(normal_map, axis=-1, keepdims=True), 1e-6)
            maes.append(M.normal_mae_deg(pred_n, gt_n))

        if has_albedo:
            gt_albedo = np.asarray(item["albedo"]).reshape(H, W, 3)
            gt_mask = np.asarray(item["rgbs_mask"]).reshape(H, W)
            pred_m = np.clip(albedo_map[gt_mask], 1e-6, None)
            gt_m = gt_albedo[gt_mask]
            if test_all:
                r1, r3 = global_single, global_three
            else:
                ratio = gt_m / pred_m
                r1 = np.median(ratio[:, 0])
                r3 = np.median(ratio, axis=0)
            single = np.ones_like(albedo_map)
            three = np.ones_like(albedo_map)
            single[gt_mask] = np.clip(r1 * albedo_map[gt_mask], 0, 1)
            three[gt_mask] = np.clip(r3 * albedo_map[gt_mask], 0, 1)
            # PSNR on gamma-corrected maps
            albedo_single_sq.append(
                ((gt_albedo ** (1 / 2.2)) - (single ** (1 / 2.2))) ** 2)
            albedo_three_sq.append(
                ((gt_albedo ** (1 / 2.2)) - (three ** (1 / 2.2))) ** 2)
            if compute_extra_metrics:
                # SSIM and LPIPS of both alignments, on the linear maps
                for tag, aligned in (("single", single), ("three", three)):
                    albedo_ssims.setdefault(f"ssim_albedo_{tag}", []).append(
                        M.rgb_ssim(aligned, gt_albedo))
                    for net in ("alex", "vgg"):
                        lp = M.rgb_lpips(gt_albedo, aligned, net)
                        if lp is not None:
                            albedo_ssims.setdefault(
                                f"lpips_{net}_albedo_{tag}", []).append(lp)

        if save_path:
            depth_vis = M.visualize_depth(out["depth_map"].reshape(H, W),
                                          test_dataset.near_far)
            rgb8, gt8 = _to8(rgb_map), _to8(gt_rgb)
            write_png(os.path.join(save_path, "nvs_with_radiance_field",
                                   f"{prtx}{vi:03d}.png"),
                      np.concatenate([rgb8, gt8, depth_vis], 1))
            write_png(os.path.join(save_path, "nvs_with_brdf",
                                   f"{prtx}{vi:03d}.png"),
                      np.concatenate([_to8(brdf_map), gt8], 1))
            nrm8 = _to8(normal_map * 0.5 + 0.5)
            write_png(os.path.join(save_path, "normal", f"{prtx}{vi:03d}.png"),
                      nrm8)
            write_png(os.path.join(save_path, "brdf", f"{prtx}{vi:03d}.png"),
                      np.concatenate(
                          [_to8(albedo_map),
                           _to8(np.repeat(roughness_map[..., None], 3, -1))],
                          1))
            write_png(os.path.join(save_path, "acc_map", f"{prtx}{vi:03d}.png"),
                      _to8(acc_map))
            n_frames += 1
            if logger is not None and vi == 0:
                # the first view's panel: rgb | brdf | gt | normal
                logger.log_image(log_step, "eval/panel", np.concatenate(
                    [rgb8, _to8(brdf_map), gt8, nrm8], 1))

    results: Dict[str, float] = {
        "psnr_nvs": float(np.mean(psnrs)) if psnrs else float("nan"),
        "psnr_nvs_brdf": float(np.mean(psnrs_brdf)) if psnrs_brdf else float("nan"),
    }
    if ssims:
        results["ssim_nvs"] = float(np.mean(ssims))
        results["ssim_nvs_brdf"] = float(np.mean(ssims_brdf))
    for k, v in lpipss.items():
        results[k] = float(np.mean(v))
    if maes:
        results["normal_mae_deg"] = float(np.mean(maes))
    if albedo_single_sq:
        results["psnr_albedo_single"] = M.mse2psnr(
            float(np.mean(np.stack(albedo_single_sq))))
        results["psnr_albedo_three"] = M.mse2psnr(
            float(np.mean(np.stack(albedo_three_sq))))
    for k, v in albedo_ssims.items():
        results[k] = float(np.mean(v))

    if logger is not None:
        logger.log(log_step, results, prefix="eval")

    if save_path:
        with open(os.path.join(save_path, "metrics_record.txt"), "a") as f:
            f.write(f"Iteration:{prtx[:-1] if prtx else 'final'}: "
                    + ", ".join(f"{k}: {v:.4f}" for k, v in results.items())
                    + "\n")
        if test_all:
            # a note only: the frames are the panels written above
            write_videos(os.path.join(save_path, "video"),
                         [("rgb", n_frames), ("rgb_brdf", n_frames),
                          ("render_normal_video", n_frames)], tag="eval")

    return results


def evaluation_path(
    cfg: F.FieldConfig,
    params: Dict,
    scene: Dict,
    path_dataset,
    *,
    n_samples: int,
    save_path: str,
    chunk: int = 4096,
    second_n_sample: int = 96,
    secondary_tile: int = 16384,
    light_idx_to_test: int = 0,
    fast_march: bool = True,
    ndc_ray: bool = False,
) -> int:
    """Render a camera path without ground truth (an orbit): rgb, brdf and
    normal frames and their video frames, no metrics. The fast march is on
    by default; where this field's box breaks its contract, the path falls
    back to the exact march with a note. Returns the frames written."""
    for sub in ("rgb", "brdf", "normal"):
        os.makedirs(os.path.join(save_path, sub), exist_ok=True)

    if fast_march:
        try:
            F.check_march_contract(
                scene["aabb"].cpu().numpy(),
                prepass_n=FAST_MARCH_KNOBS["second_prepass_n"],
                dilate=FAST_MARCH_KNOBS["coarse_dilate"])
        except ValueError as e:
            print(f"[path] fast march contract violated ({e}); "
                  "falling back to the exact march")
            fast_march = False
    fast_knobs = dict(FAST_MARCH_KNOBS) if fast_march else {}
    chunk_fn, chunk = make_eval_chunk_fn(
        cfg, n_samples=n_samples, chunk=chunk,
        second_n_sample=second_n_sample, secondary_tile=secondary_tile,
        ndc_ray=ndc_ray, **fast_knobs)

    for vi in range(len(path_dataset)):
        item = path_dataset[vi]
        W, H = item["img_wh"]
        rays = np.asarray(item["rays"], np.float32)
        lidx = np.full((rays.shape[0], 1), light_idx_to_test, np.int32)
        out = render_image(chunk_fn, chunk, params, scene, rays, lidx)
        rgb8 = _to8(out["rgb_map"].reshape(H, W, 3))
        brdf8 = _to8(out["rgb_with_brdf_map"].reshape(H, W, 3))
        nrm8 = _to8(out["normal_map"].reshape(H, W, 3) * 0.5 + 0.5)
        write_png(os.path.join(save_path, "rgb", f"{vi:03d}.png"), rgb8)
        write_png(os.path.join(save_path, "brdf", f"{vi:03d}.png"), brdf8)
        write_png(os.path.join(save_path, "normal", f"{vi:03d}.png"), nrm8)

    n = len(path_dataset)
    write_videos(save_path, [("rgb", n), ("rgb_brdf", n), ("normal", n)],
                 tag="path")
    return n
