"""TensoIR-Synthetic dataset loaders (the port's own copy of
tensoir_tpu.data.tensoir; numpy, on the port's PNG and RGBE readers).

* TensoIRRotatedLightsDataset: one environment map at N azimuth
  rotations; per-view directories with metadata.json,
  rgba_{light}_{rot}.png, albedo.png and normal.png.
* TensoIRGeneralMultiLightsDataset: N distinct environment maps,
  rgba_{name}.png.
* TensoIRSimpleDataset: a transforms.json loader for own captures, with
  an orbit camera path for videos without ground truth (test_new_pose).

Data contract: flat ``all_rays [N, 6]``, ``all_rgbs [N, 3]``,
``all_light_idx [N, 1]``, plus scene_bbox / near_far / white_bg / img_wh;
test items are per-view dicts.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from tensoir_tpu_torch.data.hdr import read_hdr
from tensoir_tpu_torch.data.images import (load_normal_png,
                                           load_rgba_white_composite)
from tensoir_tpu_torch.data.ray_utils import (get_ray_directions,
                                              get_ray_directions_blender,
                                              get_rays)
from tensoir_tpu_torch.utils.png import png_size

BLENDER2OPENCV = np.array(
    [[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]], np.float64)


def _view_rays(meta: Dict, downsample: float):
    """Rays of one view from its metadata.json, directions normalized:
    (rays [H*W, 6], c2w [4, 4], img_wh)."""
    img_wh = (int(meta["imw"] / downsample), int(meta["imh"] / downsample))
    focal = 0.5 * int(meta["imw"]) / np.tan(0.5 * meta["cam_angle_x"])
    focal *= img_wh[0] / meta["imw"]
    directions = get_ray_directions(img_wh[1], img_wh[0], [focal, focal])
    directions = directions / np.linalg.norm(directions, axis=-1,
                                             keepdims=True)
    cam_trans = np.array(
        list(map(float, meta["cam_transform_mat"].split(",")))).reshape(4, 4)
    c2w = (cam_trans @ BLENDER2OPENCV).astype(np.float32)
    rays_o, rays_d = get_rays(directions, c2w)
    rays = np.concatenate([rays_o, rays_d], -1)
    return rays, c2w, img_wh


class _TensoIRBase:
    """Shared machinery of the per-view-directory layouts."""

    def __init__(self, root_dir, hdr_dir=None, split="train", downsample=1.0,
                 sub=0, random_test=False):
        assert split in ("train", "test")
        self.root_dir = Path(root_dir)
        self.split = split
        self.downsample = downsample
        self.split_list = sorted(
            x for x in self.root_dir.iterdir()
            if x.is_dir() and x.stem.startswith(split))
        if sub > 0:
            self.split_list = self.split_list[:sub]
        self.img_wh = (int(800 / downsample), int(800 / downsample))
        self.white_bg = True
        self.near_far = [2.0, 6.0]
        self.scene_bbox = (np.array([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]],
                                    np.float32) * downsample)
        self.hdr_dir = Path(hdr_dir) if hdr_dir else None

    def __len__(self):
        return len(self.split_list)

    def _light_image_names(self) -> List[str]:
        """The per-light image file names of a view (subclasses)."""
        raise NotImplementedError

    def _read_all_frames(self):
        names = self._light_image_names()
        all_rays, all_rgbs, all_lidx = [], [], []
        for item_path in self.split_list:
            with open(item_path / "metadata.json") as f:
                meta = json.load(f)
            rays, _, img_wh = _view_rays(meta, self.downsample)
            self.img_wh = img_wh
            for li, name in enumerate(names):
                rgb, _ = load_rgba_white_composite(item_path / name, img_wh)
                all_rays.append(rays)
                all_rgbs.append(rgb)
                all_lidx.append(np.full((rgb.shape[0], 1), li, np.int8))
        self.all_rays = np.concatenate(all_rays, 0)
        self.all_rgbs = np.concatenate(all_rgbs, 0)
        self.all_light_idx = np.concatenate(all_lidx, 0)
        self.all_masks = None

    def __getitem__(self, idx) -> Dict:
        names = self._light_image_names()
        item_path = self.split_list[idx]
        with open(item_path / "metadata.json") as f:
            meta = json.load(f)
        rays, c2w, img_wh = _view_rays(meta, self.downsample)

        rgbs, lidx = [], []
        alpha_mask = None
        for li, name in enumerate(names):
            rgb, mask = load_rgba_white_composite(item_path / name, img_wh)
            rgbs.append(rgb)
            lidx.append(np.full((rgb.shape[0], 1), li, np.int32))
            alpha_mask = mask
        item = {
            "img_wh": img_wh,
            "light_idx": np.stack(lidx, 0),
            "rgbs": np.stack(rgbs, 0),
            "rgbs_mask": alpha_mask,
            "rays": rays,
            "c2w": c2w,
            "w2c": np.linalg.inv(c2w.astype(np.float64)).astype(np.float32),
        }
        albedo_path = item_path / "albedo.png"
        if albedo_path.exists():
            albedo, _ = load_rgba_white_composite(albedo_path, img_wh)
            item["albedo"] = albedo
        normal_path = item_path / "normal.png"
        if normal_path.exists():
            item["normals"] = load_normal_png(normal_path, img_wh)
        return item


class TensoIRRotatedLightsDataset(_TensoIRBase):
    """One environment map (``light_name``) at the azimuth rotations
    ``light_rotation``."""

    def __init__(self, root_dir, hdr_dir=None, split="train", downsample=1.0,
                 light_rotation=("000",), light_name="sunset", sub=0,
                 N_vis=-1, random_test=False, **_):
        super().__init__(root_dir, hdr_dir, split, downsample, sub)
        self.light_rotation = list(light_rotation)
        self.light_num = len(self.light_rotation)
        self.light_name = light_name
        self.lights_probes = self._read_light_probe(light_name)
        if split == "train":
            self._read_all_frames()

    def _read_light_probe(self, light_name) -> Optional[np.ndarray]:
        if self.hdr_dir is None:
            return None
        hdr_path = self.hdr_dir / f"{light_name}.hdr"
        if hdr_path.exists():
            return read_hdr(str(hdr_path))
        return None

    def _light_image_names(self):
        return [f"rgba_{self.light_name}_{rot}.png"
                for rot in self.light_rotation]


class TensoIRGeneralMultiLightsDataset(_TensoIRBase):
    """One view image per environment map of ``light_name_list``."""

    def __init__(self, root_dir, hdr_dir=None, split="train", downsample=1.0,
                 light_name_list=("sunset", "snow", "courtyard"), sub=0,
                 N_vis=-1, random_test=False, **_):
        super().__init__(root_dir, hdr_dir, split, downsample, sub)
        self.light_name_list = list(light_name_list)
        self.light_num = len(self.light_name_list)
        self.lights_probes = {}
        if self.hdr_dir is not None:
            for name in self.light_name_list:
                p = self.hdr_dir / f"{name}.hdr"
                if p.exists():
                    self.lights_probes[name] = read_hdr(str(p))
        if split == "train":
            self._read_all_frames()

    def _light_image_names(self):
        return [f"rgba_{name}.png" for name in self.light_name_list]


class TensoIRSimpleDataset:
    """transforms.json-driven loader; frames a dict (own captures, with a
    ``light_idx`` each) or a list (Blender style)."""

    def __init__(self, root_dir, hdr_dir=None, split="train", downsample=1.0,
                 light_rotation=("000",), light_name="sunset",
                 scene_bbox=((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5)),
                 sub=0, N_vis=-1, test_new_pose=False, n_orbit=150,
                 orbit_pitch_deg=30.0, orbit_center_offset=(0.0, 0.0, 0.5),
                 **_):
        self.root_dir = Path(root_dir)
        self.split = split
        self.downsample = downsample
        with open(self.root_dir / f"transforms_{split}.json") as f:
            self.transforms_json = json.load(f)
        self.light_rotation = list(light_rotation)
        self.light_num = len(self.light_rotation)
        frames = self.transforms_json["frames"]
        if isinstance(frames, dict):
            self.frame_keys = [k for k in sorted(frames.keys(), key=str)
                               if frames[k].get("light_idx", 0) < self.light_num]
        else:
            self.frame_keys = list(range(len(frames)))
        if sub > 0:
            self.frame_keys = self.frame_keys[:sub]
        self.white_bg = True
        self.near_far = [2.0, 6.0]
        self.scene_bbox = np.asarray(scene_bbox, np.float32)
        self.lights_probes = None
        if hdr_dir is not None:
            p = Path(hdr_dir) / f"{light_name}.hdr"
            if p.exists():
                self.lights_probes = read_hdr(str(p))
        if split == "train":
            self._read_all_frames()
        self.test_new_pose = bool(test_new_pose) and split == "test"
        if self.test_new_pose:
            self._make_orbit_poses(n_orbit, orbit_pitch_deg,
                                   np.asarray(orbit_center_offset, np.float64))

    def _make_orbit_poses(self, n_orbit, pitch_deg, center_offset):
        """An orbit camera path for videos without ground truth: cameras on
        a circle whose radius is the mean distance of this split's cameras
        from their centroid, pitched down ``pitch_deg``, looking at the
        centroid plus ``center_offset``, Blender-convention directions."""
        mats = np.stack([
            np.asarray(self._frame(k)["transform_matrix"], np.float64)
            for k in self.frame_keys])                       # [N, 4, 4]
        cams = mats[:, :3, 3]
        centroid = cams.mean(0) + center_offset
        radius = float(np.linalg.norm(cams - cams.mean(0), axis=-1).mean())
        tz = -radius * np.tan(np.radians(pitch_deg))
        up = np.array([0.0, 0.0, 1.0])
        poses = []
        for th in np.linspace(0.0, 2.0 * np.pi, n_orbit, endpoint=False):
            cam = np.array([radius * np.cos(th), radius * np.sin(th), 0.0])
            look = -cam.copy()
            look[2] = tz
            look /= np.linalg.norm(look)
            z_axis = -look                      # Blender: camera z backward
            x_axis = np.cross(up, z_axis)
            x_axis /= np.linalg.norm(x_axis)
            y_axis = np.cross(z_axis, x_axis)
            y_axis /= np.linalg.norm(y_axis)
            c2w = np.stack([x_axis, y_axis, z_axis, cam + centroid],
                           1).astype(np.float32)             # [3, 4]
            poses.append(c2w)
        self.orbit_poses = np.stack(poses)

    def _orbit_item(self, idx) -> Dict:
        frame0 = self._frame(self.frame_keys[0])
        _, _, img_wh, _ = self._frame_rays(frame0)
        fov = self.transforms_json["camera_angle_x"]
        focal = 0.5 * img_wh[0] / np.tan(0.5 * fov)
        directions = get_ray_directions_blender(img_wh[1], img_wh[0],
                                                [focal, focal])
        directions = directions / np.linalg.norm(directions, axis=-1,
                                                 keepdims=True)
        c2w = self.orbit_poses[idx]
        rays_o, rays_d = get_rays(directions, c2w)
        rays = np.concatenate([rays_o, rays_d], -1)
        n = rays.shape[0]
        return {
            "img_wh": img_wh,
            "light_idx": np.zeros((1, n, 1), np.int32),
            "rgbs": np.ones((1, n, 3), np.float32),   # no ground truth
            "rgbs_mask": np.ones((n,), bool),
            "rays": rays,
            "c2w": np.concatenate(
                [c2w, np.array([[0, 0, 0, 1]], np.float32)], 0),
            "synthetic_pose": True,
        }

    def _frame(self, key):
        frames = self.transforms_json["frames"]
        return frames[key] if not isinstance(frames, dict) else frames[str(key)]

    def _frame_rays(self, frame):
        fov = self.transforms_json["camera_angle_x"]
        file_path = frame["file_path"]
        img_path = self.root_dir / (
            file_path if file_path.endswith(".png") else file_path + ".png")
        w0, h0 = png_size(img_path)
        img_wh = (int(w0 / self.downsample), int(h0 / self.downsample))
        focal = 0.5 * w0 / np.tan(0.5 * fov) * img_wh[0] / w0
        directions = get_ray_directions(img_wh[1], img_wh[0], [focal, focal])
        directions = directions / np.linalg.norm(directions, axis=-1,
                                                 keepdims=True)
        c2w = (np.asarray(frame["transform_matrix"], np.float64)
               @ BLENDER2OPENCV).astype(np.float32)
        rays_o, rays_d = get_rays(directions, c2w)
        return (np.concatenate([rays_o, rays_d], -1), c2w, img_wh, img_path)

    def _read_all_frames(self):
        all_rays, all_rgbs, all_lidx, all_masks = [], [], [], []
        for key in self.frame_keys:
            frame = self._frame(key)
            rays, _, img_wh, img_path = self._frame_rays(frame)
            self.img_wh = img_wh
            rgb, mask = load_rgba_white_composite(img_path, img_wh)
            all_rays.append(rays)
            all_rgbs.append(rgb)
            all_masks.append(mask)
            all_lidx.append(np.full((rgb.shape[0], 1),
                                    frame.get("light_idx", 0), np.int8))
        self.all_rays = np.concatenate(all_rays, 0)
        self.all_rgbs = np.concatenate(all_rgbs, 0)
        self.all_masks = np.concatenate(all_masks, 0)
        self.all_light_idx = np.concatenate(all_lidx, 0)

    def __len__(self):
        if getattr(self, "test_new_pose", False):
            return len(self.orbit_poses)
        return len(self.frame_keys)

    def __getitem__(self, idx) -> Dict:
        if getattr(self, "test_new_pose", False):
            return self._orbit_item(idx)
        frame = self._frame(self.frame_keys[idx])
        rays, c2w, img_wh, img_path = self._frame_rays(frame)
        rgb, mask = load_rgba_white_composite(img_path, img_wh)
        lidx = np.full((rgb.shape[0], 1), frame.get("light_idx", 0), np.int32)
        return {
            "img_wh": img_wh,
            "light_idx": lidx[None],
            "rgbs": rgb[None],
            "rgbs_mask": mask,
            "rays": rays,
            "c2w": c2w,
        }
