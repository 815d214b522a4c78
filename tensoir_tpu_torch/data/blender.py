"""NeRF-Synthetic (Blender) loader (the port's own copy of
tensoir_tpu.data.blender)."""
from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from tensoir_tpu_torch.data.images import load_rgba_white_composite
from tensoir_tpu_torch.data.ray_utils import get_ray_directions, get_rays
from tensoir_tpu_torch.data.tensoir import BLENDER2OPENCV


class BlenderDataset:
    def __init__(self, datadir, split="train", downsample=1.0, is_stack=False,
                 N_vis=-1, **_):
        self.root_dir = datadir
        self.split = split
        self.is_stack = is_stack
        self.img_wh = (int(800 / downsample), int(800 / downsample))
        self.white_bg = True
        self.near_far = [2.0, 6.0]
        self.scene_bbox = np.array([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]],
                                   np.float32)
        self.downsample = downsample
        self._read_meta(N_vis)

    def _read_meta(self, N_vis):
        with open(os.path.join(self.root_dir,
                               f"transforms_{self.split}.json")) as f:
            meta = json.load(f)
        w, h = self.img_wh
        focal = 0.5 * 800 / np.tan(0.5 * meta["camera_angle_x"])
        focal *= w / 800
        self.focal = focal
        directions = get_ray_directions(h, w, [focal, focal])
        directions = directions / np.linalg.norm(directions, axis=-1,
                                                 keepdims=True)
        self.directions = directions
        self.intrinsics = np.array(
            [[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float32)

        frames = meta["frames"]
        interval = 1 if N_vis < 0 else max(len(frames) // N_vis, 1)
        idxs = list(range(0, len(frames), interval))

        poses, rays_l, rgbs_l, masks_l = [], [], [], []
        for i in idxs:
            frame = frames[i]
            pose = (np.asarray(frame["transform_matrix"], np.float64)
                    @ BLENDER2OPENCV).astype(np.float32)
            poses.append(pose)
            img_path = os.path.join(self.root_dir,
                                    f"{frame['file_path']}.png")
            rgb, mask = load_rgba_white_composite(img_path, self.img_wh)
            rgbs_l.append(rgb)
            masks_l.append(mask)
            rays_o, rays_d = get_rays(directions, pose)
            rays_l.append(np.concatenate([rays_o, rays_d], -1))

        self.poses = np.stack(poses, 0)
        if not self.is_stack:
            self.all_rays = np.concatenate(rays_l, 0)
            self.all_rgbs = np.concatenate(rgbs_l, 0)
            self.all_masks = np.concatenate(masks_l, 0)
        else:
            self.all_rays = np.stack(rays_l, 0)
            self.all_rgbs = np.stack(rgbs_l, 0)
            self.all_masks = np.stack(masks_l, 0)
        self.all_light_idx = np.zeros((*self.all_rays.shape[:-1], 1), np.int64)

    def __len__(self):
        return (self.all_rays.shape[0] if self.is_stack
                else len(self.poses))

    def __getitem__(self, idx) -> Dict:
        if self.split == "train" and not self.is_stack:
            return {"rays": self.all_rays[idx], "rgbs": self.all_rgbs[idx]}
        rays = self.all_rays[idx]
        return {
            "img_wh": self.img_wh,
            "light_idx": np.zeros((1, rays.shape[0], 1), np.int32),
            "rays": rays,
            "rgbs": self.all_rgbs[idx].reshape(1, -1, 3),
            "rgbs_mask": self.all_masks[idx],
        }
