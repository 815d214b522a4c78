"""Procedural synthetic scene for tests and benchmarks (the port's own copy
of tensoir_tpu.data.synthetic; numpy, and torch for the lat-long lookup
and the sRGB curve of the relighting ground truth).

No TensoIR-Synthetic data ships with this repo, so tests/benchmarks use an
analytic scene: a lambertian sphere lit by a directional light on a white
background. Ground-truth renders come from closed-form ray/sphere
intersection, so the dataset satisfies the same data contract as the real
loaders (SURVEY.md §2.2: flat `all_rays [N,6]`, `all_rgbs [N,3]`,
`all_light_idx [N,1]`, `scene_bbox`, `near_far`, `white_bg`, `img_wh`).
``write_shadow_scene`` writes the shadow scene to disk in the
TensoIR-Synthetic layout, for the file loaders and the CLI;
``write_relight_test_scene`` writes it as a relighting test set.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from tensoir_tpu_torch.data.hdr import write_hdr
from tensoir_tpu_torch.data.relight_test import RELIGHT_LIGHTS
from tensoir_tpu_torch.data.ray_utils import (
    get_ray_directions_blender,
    get_rays,
    look_at,
)
from tensoir_tpu_torch.data.tensoir import _view_rays
from tensoir_tpu_torch.utils.png import write_png


def _sphere_hit(rays_o, rays_d, center, radius):
    """Closed-form ray/sphere intersection. Returns (hit_mask, t_hit)."""
    oc = rays_o - center
    a = np.sum(rays_d * rays_d, -1)
    b = 2.0 * np.sum(oc * rays_d, -1)
    c = np.sum(oc * oc, -1) - radius * radius
    disc = b * b - 4 * a * c
    hit = disc > 0
    sq = np.sqrt(np.maximum(disc, 0.0))
    t = (-b - sq) / (2 * a)
    hit = hit & (t > 0)
    return hit, t


class SyntheticSphereDataset:
    """Lambertian sphere; analytic rgb/depth/normal/albedo ground truth."""

    def __init__(self, split="train", n_views=8, img_wh=(64, 64),
                 radius=0.6, albedo=(0.8, 0.3, 0.2),
                 light_dir=(0.5, 0.3, 0.8), ambient=0.25,
                 cam_radius=4.0, light_num=1, seed=0, srgb_images=True):
        # srgb_images: emit sRGB-encoded images like the reference's PNG
        # renders (dataLoader/tensoIR*.py reads 8-bit PNGs, which are
        # sRGB-encoded radiance). The physically-based branch outputs
        # linear2srgb(radiance) (relight_utils.py:489-515), so LINEAR
        # training images would force an inverse-gamma into the learned
        # albedo — measured -14 dB albedo PSNR on the flagship demo
        # before this default was fixed (round-2 diagnosis).
        self.srgb_images = srgb_images
        self.split = split
        self.img_wh = img_wh
        self.white_bg = True
        self.near_far = [2.0, 6.0]
        self.scene_bbox = np.array([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]],
                                   np.float32)
        self.radius = radius
        self.albedo = np.asarray(albedo, np.float32)
        base_dir = np.asarray(light_dir, np.float64)
        base_dir /= np.linalg.norm(base_dir)
        self.ambient = ambient
        self.light_num = light_num
        # multi-light: azimuthal rotations of the base light, emulating the
        # rotated-lights capture setting
        self.light_dirs = []
        for li in range(light_num):
            a = 2 * np.pi * li / max(light_num, 1)
            rot = np.array([[np.cos(a), -np.sin(a), 0],
                            [np.sin(a), np.cos(a), 0], [0, 0, 1]])
            self.light_dirs.append((rot @ base_dir).astype(np.float32))
        self.light_dir = self.light_dirs[0]

        w, h = img_wh
        focal = 0.5 * w / np.tan(0.5 * 0.69)  # ~40deg fov
        directions = get_ray_directions_blender(h, w, focal)

        rng = np.random.default_rng(seed)
        phase = 0.0 if split == "train" else 0.5 * np.pi / n_views
        rays, rgbs, normals, depths, masks, lidx = [], [], [], [], [], []
        for k in range(n_views):
            ang = 2 * np.pi * k / n_views + phase
            z = 1.2 + 0.8 * np.sin(ang * 1.7)
            eye = np.array([cam_radius * np.cos(ang),
                            cam_radius * np.sin(ang), z])
            eye = eye / np.linalg.norm(eye) * cam_radius
            c2w = look_at(eye)
            o, d = get_rays(directions, c2w)
            for li in range(light_num):
                self.light_dir = self.light_dirs[li]
                rgb, nrm, dep, msk = self._render_gt(o, d)
                rays.append(np.concatenate([o, d], -1))
                rgbs.append(rgb)
                normals.append(nrm)
                depths.append(dep)
                masks.append(msk)
                lidx.append(np.full((rgb.shape[0], 1), li, np.int32))
        self.light_dir = self.light_dirs[0]

        self.all_rays = np.concatenate(rays, 0)
        self.all_rgbs = np.concatenate(rgbs, 0)
        self.all_normals = np.concatenate(normals, 0)
        self.all_depths = np.concatenate(depths, 0)
        self.all_masks = np.concatenate(masks, 0)
        self.all_light_idx = np.concatenate(lidx, 0)
        self.n_views = n_views
        self._per_view = light_num

    def _encode(self, rgb_linear):
        """sRGB transfer (reference PNG convention) when srgb_images."""
        if not self.srgb_images:
            return rgb_linear
        x = np.clip(rgb_linear, 0.0, 1.0)
        lin = x * 12.92
        nonlin = 1.055 * np.power(x + 1e-6, 1.0 / 2.4) - 0.055
        return np.where(x <= 0.0031308, lin, nonlin)

    def _render_gt(self, rays_o, rays_d):
        hit, t = _sphere_hit(rays_o, rays_d, np.zeros(3), self.radius)
        pts = rays_o + t[:, None] * rays_d
        normal = pts / np.maximum(np.linalg.norm(pts, axis=-1, keepdims=True),
                                  1e-8)
        lambert = np.clip(np.sum(normal * self.light_dir, -1), 0, None)
        shade = self.ambient + (1 - self.ambient) * lambert
        rgb = self._encode(self.albedo[None] * shade[:, None])
        rgb = np.where(hit[:, None], rgb, 1.0).astype(np.float32)
        normal = np.where(hit[:, None], normal, 0.0).astype(np.float32)
        depth = np.where(hit, t, 0.0).astype(np.float32)
        return rgb, normal, depth, hit.astype(np.float32)

    def view(self, k: int, light: int = 0):
        """Per-(view, light) slices (stacked layout for eval tests)."""
        w, h = self.img_wh
        n = w * h
        base = (k * self._per_view + light) * n
        sl = slice(base, base + n)
        return {
            "rays": self.all_rays[sl],
            "rgbs": self.all_rgbs[sl],
            "normals": self.all_normals[sl],
            "depths": self.all_depths[sl],
            "masks": self.all_masks[sl],
        }

    def __len__(self):
        return self.n_views

    def __getitem__(self, k: int):
        """Test-item dict matching the TensoIR loader contract
        (rgbs stacked per light, [light_num, H*W, 3])."""
        v = self.view(k)
        n = v["rays"].shape[0]
        rgbs = np.stack(
            [self.view(k, li)["rgbs"] for li in range(self.light_num)], 0)
        lidx = np.stack(
            [np.full((n, 1), li, np.int32)
             for li in range(self.light_num)], 0)
        albedo = np.broadcast_to(self.albedo, (n, 3)).copy()
        albedo = np.where(v["masks"][:, None] > 0, albedo, 1.0).astype(
            np.float32)
        return {
            "img_wh": self.img_wh,
            "light_idx": lidx,
            "rgbs": rgbs,
            "rgbs_mask": v["masks"].astype(bool).reshape(-1, 1),
            "albedo": albedo,
            "rays": v["rays"],
            "normals": np.where(v["masks"][:, None] > 0, v["normals"],
                                np.array([0.0, 0.0, 1.0],
                                         np.float32)).astype(np.float32),
        }


class SyntheticShadowDataset(SyntheticSphereDataset):
    """Sphere hovering over a disc — casts an analytic shadow.

    Exercises the full inverse-rendering stack (geometry + normals + albedo
    + VISIBILITY): the ground-truth shader traces a shadow ray from every
    surface point toward the light through the sphere. Serves as the
    flagship end-to-end demo in the absence of the TensoIR-Synthetic data.
    """

    SPHERE_C = np.array([0.0, 0.0, 0.1], np.float32)
    SPHERE_R = 0.45
    PLANE_Z = -0.6
    DISC_R = 1.15
    PLANE_ALBEDO = np.array([0.75, 0.75, 0.7], np.float32)

    def _render_gt(self, rays_o, rays_d):
        hit_s, t_s = _sphere_hit(rays_o, rays_d, self.SPHERE_C, self.SPHERE_R)
        # plane z = PLANE_Z within DISC_R
        dz = rays_d[:, 2]
        t_p = np.where(np.abs(dz) > 1e-8,
                       (self.PLANE_Z - rays_o[:, 2]) / dz, -1.0)
        p_pts = rays_o + t_p[:, None] * rays_d
        hit_p = (t_p > 0) & (np.linalg.norm(p_pts[:, :2], axis=-1)
                             < self.DISC_R)

        t_s = np.where(hit_s, t_s, np.inf)
        t_p = np.where(hit_p, t_p, np.inf)
        use_s = t_s < t_p
        hit = hit_s | hit_p
        t = np.where(use_s, t_s, t_p)
        t = np.where(hit, t, 0.0)

        pts = rays_o + t[:, None] * rays_d
        n_s = pts - self.SPHERE_C
        n_s = n_s / np.maximum(np.linalg.norm(n_s, axis=-1, keepdims=True),
                               1e-8)
        n_p = np.broadcast_to(np.array([0.0, 0.0, 1.0], np.float32),
                              n_s.shape)
        normal = np.where(use_s[:, None], n_s, n_p)
        albedo = np.where(use_s[:, None], self.albedo[None],
                          self.PLANE_ALBEDO[None])

        # shadow ray toward the light (only the sphere occludes)
        shadow_o = pts + normal * 1e-4
        occ, t_occ = _sphere_hit(shadow_o, np.broadcast_to(
            self.light_dir, shadow_o.shape), self.SPHERE_C, self.SPHERE_R)
        lit = ~occ

        lambert = np.clip(np.sum(normal * self.light_dir, -1), 0, None)
        shade = self.ambient + (1 - self.ambient) * lambert * lit
        rgb = self._encode(albedo * shade[:, None])
        rgb = np.where(hit[:, None], rgb, 1.0).astype(np.float32)
        normal = np.where(hit[:, None], normal, 0.0).astype(np.float32)
        depth = np.where(hit, t, 0.0).astype(np.float32)
        return rgb, normal, depth, hit.astype(np.float32)

    def render_env_gt(self, rays: np.ndarray, env_map: np.ndarray,
                      background: str = "env", srgb: bool = True
                      ) -> np.ndarray:
        """The exact relit image under a lat-long environment map [H, W, 3],
        the relighting benchmark's ground truth, float32 [N, 3].

        The scene is lambertian, so the rendering equation is albedo / pi
        times the sum over texels of L cos+ visibility d-omega, in closed
        form per pixel (visibility: a ray/sphere test from the surface).
        Linear radiance clipped to [0, 1]; behind the object the probe
        (``background`` "env", looked up as the relighting pipeline does)
        or white; ``srgb`` applies the sRGB curve to both. The integral is
        a [points x texels] product: keep the probe small."""
        from tensoir_tpu_torch.models.lighting import (envmap_dirs,
                                                       latlong_lookup)
        from tensoir_tpu_torch.ops.color import linear2srgb

        H, W, _ = env_map.shape
        _, dirs = envmap_dirs(H, W)
        dirs = dirs.astype(np.float64)          # [T, 3]
        # solid angle per texel: (2 pi / W) (pi / H) sin(colatitude)
        lat_step = np.pi / H
        lng_step = 2 * np.pi / W
        phi = np.linspace(np.pi / 2 - 0.5 * lat_step,
                          -np.pi / 2 + 0.5 * lat_step, H)
        domega = (np.cos(phi)[:, None] * lat_step * lng_step
                  ) @ np.ones((1, W))
        domega = domega.reshape(-1)             # [T]

        rays_o, rays_d = rays[:, :3], rays[:, 3:6]
        rgb, normal, depth, hit = self._render_gt(rays_o, rays_d)
        pts = rays_o + depth[:, None] * rays_d
        albedo = np.where(
            (np.linalg.norm((pts - self.SPHERE_C), axis=-1)
             < self.SPHERE_R + 1e-3)[:, None],
            self.albedo[None], self.PLANE_ALBEDO[None])

        if background == "env":
            bg = latlong_lookup(torch.as_tensor(env_map),
                                torch.as_tensor(rays_d), align_corners=True,
                                padding="zeros").numpy()
            out = np.clip(bg, 0.0, 1.0).astype(rgb.dtype)
        else:
            out = np.ones_like(rgb)
        idx = np.where(hit > 0)[0]
        for start in range(0, idx.size, 4096):   # chunks of the [P, T] product
            ii = idx[start:start + 4096]
            p = pts[ii]
            n = normal[ii]
            cos = np.clip(n @ dirs.T, 0.0, None)            # [P, T]
            occ, _ = _sphere_hit(
                np.repeat(p + n * 1e-4, dirs.shape[0], 0),
                np.tile(dirs, (p.shape[0], 1)),
                self.SPHERE_C, self.SPHERE_R)
            vis = 1.0 - occ.reshape(p.shape[0], dirs.shape[0])
            L = env_map.reshape(-1, 3)                       # [T, 3]
            integ = (cos * vis * domega[None]) @ L           # [P, 3]
            out[ii] = np.clip(albedo[ii] / np.pi * integ, 0.0, 1.0)
        if srgb:
            out = linear2srgb(torch.as_tensor(out)).numpy()
        return out.astype(np.float32)

    def albedo_gt(self, rays_o, rays_d) -> np.ndarray:
        """Per-ray GT albedo of the first surface hit (sphere or plane;
        the plane's outside the disc too), float32 [N, 3]."""
        hit_s, t_s = _sphere_hit(rays_o, rays_d, self.SPHERE_C, self.SPHERE_R)
        dz = rays_d[:, 2]
        t_p = np.where(np.abs(dz) > 1e-8,
                       (self.PLANE_Z - rays_o[:, 2]) / dz, -1.0)
        p_pts = rays_o + t_p[:, None] * rays_d
        hit_p = (t_p > 0) & (np.linalg.norm(p_pts[:, :2], axis=-1)
                             < self.DISC_R)
        t_s = np.where(hit_s, t_s, np.inf)
        t_p = np.where(hit_p, t_p, np.inf)
        use_s = t_s < t_p
        return np.where(use_s[:, None], self.albedo[None],
                        self.PLANE_ALBEDO[None]).astype(np.float32)

    def __getitem__(self, k: int):
        item = super().__getitem__(k)
        v = self.view(k)
        albedo = self.albedo_gt(v["rays"][:, :3], v["rays"][:, 3:6])
        item["albedo"] = np.where(v["masks"][:, None] > 0, albedo, 1.0)
        return item


# the PNG row filter types, taken by the rows in turn
_FILTERS = (0, 1, 2, 3, 4)


def _rgba8(x, mask, size: int) -> np.ndarray:
    """x [N, 3] in [0, 1] as an 8-bit [size, size, 4] image, alpha 255
    where ``mask``."""
    alpha = ((mask > 0)[:, None] * 255).astype(np.uint8)
    x8 = np.clip(np.rint(x * 255.0), 0, 255).astype(np.uint8)
    return np.concatenate([x8, alpha], 1).reshape(size, size, 4)


def _write_view(root, split: str, k: int, count: int, size: int):
    """View ``k`` of ``count`` of a split: its folder with metadata.json (a
    0.69 rad field of view, on a ring around the scene). Returns (folder,
    the rays the loaders compute from it)."""
    ang = 2 * np.pi * k / count + (0.0 if split == "train" else 0.4)
    z = 1.2 + 0.8 * np.sin(ang * 1.7)
    eye = np.array([np.cos(ang), np.sin(ang), z / 4.0]) * 4.0
    c2w = np.concatenate([look_at(eye / np.linalg.norm(eye) * 4.0),
                          [[0, 0, 0, 1]]], 0)
    meta = {"imw": size, "imh": size, "cam_angle_x": 0.69,
            "cam_transform_mat": ",".join(
                repr(float(x)) for x in c2w.reshape(-1))}
    rays, _, _ = _view_rays(meta, 1.0)
    view = os.path.join(root, f"{split}_{k:03d}")
    os.makedirs(view, exist_ok=True)
    with open(os.path.join(view, "metadata.json"), "w") as f:
        json.dump(meta, f)
    return view, rays


def write_shadow_scene(root, hdr_dir, *, views=(("train", 2, 800),
                                                ("test", 1, 200)),
                       env_hw=(1024, 2048)) -> None:
    """The shadow scene as a TensoIR-Synthetic scene on disk, for the
    rotated-lights loader with light ``sunset`` at rotation ``000``:
    ``<root>/<split>_NNN/`` view folders with metadata.json (a 0.69 rad
    field of view), ``rgba_sunset_000.png``, albedo.png and normal.png, and
    ``<hdr_dir>/sunset.hdr`` of ``env_hw``. ``views``: (split, count,
    square size) per split. Each image is the scene's analytic GT on the
    rays the loader computes from the view's metadata (alpha 255 on the
    sphere and the disc, 0 elsewhere); its PNG rows take the five filter
    types in turn. The probe is a smooth sky with a sun, RGBE."""
    gt = SyntheticShadowDataset(split="train", n_views=1, img_wh=(1, 1))
    for split, count, size in views:
        for k in range(count):
            view, rays = _write_view(root, split, k, count, size)
            o, d = rays[:, :3], rays[:, 3:6]
            rgb, normal, _, mask = gt._render_gt(o, d)
            albedo = np.where((mask > 0)[:, None], gt.albedo_gt(o, d), 1.0)
            write_png(os.path.join(view, "rgba_sunset_000.png"),
                      _rgba8(rgb, mask, size), _FILTERS)
            write_png(os.path.join(view, "albedo.png"),
                      _rgba8(albedo, mask, size), _FILTERS)
            write_png(os.path.join(view, "normal.png"),
                      _rgba8(normal * 0.5 + 0.5, mask, size), _FILTERS)
    h, w = env_hw
    v = np.linspace(0.0, 1.0, h)[:, None, None]
    u = np.linspace(0.0, 1.0, w)[None, :, None]
    sky = (0.3 + 0.9 * (1.0 - v)) * np.array([0.6, 0.75, 1.0])
    sun = 40.0 * np.exp(-((u - 0.3) ** 2 + (v - 0.25) ** 2) / 2e-4)
    os.makedirs(hdr_dir, exist_ok=True)
    write_hdr(os.path.join(hdr_dir, "sunset.hdr"),
              (sky + sun * np.array([1.0, 0.9, 0.7])).astype(np.float32))


def relight_probe(i: int, env_hw) -> np.ndarray:
    """Probe ``i`` of a set of distinct synthetic environment maps, float32
    [H, W, 3]: a sky graded from horizon to zenith and a sun, both placed
    and coloured by ``i``."""
    from tensoir_tpu_torch.models.lighting import envmap_dirs
    h, w = env_hw
    _, dirs = envmap_dirs(h, w)
    dirs = dirs.reshape(h, w, 3).astype(np.float64)
    a = 2.0 * np.pi * i / 5.0 + 0.3
    sun = np.array([np.cos(a), np.sin(a), 0.35 + 0.1 * i])
    sun /= np.linalg.norm(sun)
    tint = np.array([[1.0, 0.85, 0.6], [0.7, 0.8, 1.0], [1.0, 0.6, 0.35],
                     [0.6, 1.0, 0.6], [0.5, 0.55, 0.9]])[i % 5]
    sky = (0.15 + 0.5 * np.clip(dirs[..., 2:3], 0.0, None)) * tint
    lobe = np.exp(40.0 * ((dirs * sun).sum(-1, keepdims=True) - 1.0))
    return (sky + (6.0 + 2.0 * i) * lobe * tint).astype(np.float32)


def area_average(img: np.ndarray, out_hw) -> np.ndarray:
    """[H, W, C] -> [h, w, C], each texel the mean of its block (H and W
    multiples of h and w)."""
    H, W, C = img.shape
    h, w = out_hw
    return img.reshape(h, H // h, w, W // w, C).mean((1, 3)).astype(
        np.float32)


def write_relight_test_scene(root, hdr_dir, *, lights=RELIGHT_LIGHTS,
                             n_views: int = 2, size: int = 800,
                             env_hw=(1024, 2048),
                             gt_env_hw=(16, 32)) -> None:
    """The shadow scene as a relighting test set on disk, in the layout of
    TensoIR-Synthetic's: ``<root>/test_NNN/`` with metadata.json,
    ``rgba_{light}.png`` for each light, albedo.png and normal.png, and
    ``<hdr_dir>/{light}.hdr`` probes of ``env_hw`` (``relight_probe``).

    The ground truth is ``render_env_gt`` (white background, alpha 255 on
    the sphere and the disc), whose integral is a [points x texels]
    product: it is rendered under each probe as written and read back,
    area-averaged down to ``gt_env_hw``. A relit image's PSNR against it is
    therefore a sanity number, not a measure of quality."""
    from tensoir_tpu_torch.data.hdr import read_hdr
    gt = SyntheticShadowDataset(split="test", n_views=1, img_wh=(1, 1))
    os.makedirs(hdr_dir, exist_ok=True)
    small = {}
    for i, name in enumerate(lights):
        path = os.path.join(hdr_dir, f"{name}.hdr")
        write_hdr(path, relight_probe(i, env_hw))
        small[name] = area_average(read_hdr(path), gt_env_hw)
    for k in range(n_views):
        view, rays = _write_view(root, "test", k, n_views, size)
        o, d = rays[:, :3], rays[:, 3:6]
        _, normal, _, mask = gt._render_gt(o, d)
        for name in lights:
            rgb = gt.render_env_gt(rays, small[name], background="white")
            write_png(os.path.join(view, f"rgba_{name}.png"),
                      _rgba8(rgb, mask, size), _FILTERS)
        albedo = np.where((mask > 0)[:, None], gt.albedo_gt(o, d), 1.0)
        write_png(os.path.join(view, "albedo.png"),
                  _rgba8(albedo, mask, size), _FILTERS)
        write_png(os.path.join(view, "normal.png"),
                  _rgba8(normal * 0.5 + 0.5, mask, size), _FILTERS)
