"""The relighting and material-editing test sets (the port's own copy of
tensoir_tpu.data.relight_test; numpy, on the port's PNG and RGBE readers).

Test only: per-view folders with metadata.json, rgba_{light}.png for each
held-out environment map, albedo.png and normal.png. ``light_idx`` is
always 0: the model's learned light 0 conditions the intrinsics, and the
held-out light comes from its HDR probe at relighting time.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import numpy as np

from tensoir_tpu_torch.data.hdr import read_hdr
from tensoir_tpu_torch.data.images import (load_normal_png,
                                           load_rgba_white_composite)
from tensoir_tpu_torch.data.tensoir import _view_rays

# the held-out lights of TensoIR-Synthetic's relighting test set
RELIGHT_LIGHTS = ("bridge", "city", "fireplace", "forest", "night")


class TensoIRRelightingTestDataset:
    """The relighting test set: per view, its rays and the ground truth
    under each of ``light_names``; ``sub`` > 0 keeps the first views."""

    def __init__(self, root_dir, hdr_dir=None, split="test", downsample=1.0,
                 light_names=RELIGHT_LIGHTS, sub=0, N_vis=-1, **_):
        self.root_dir = Path(root_dir)
        self.split = split
        self.downsample = downsample
        self.light_names = list(light_names)
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
        # the held-out probes, by light name, where the directory has them
        self.lights_probes = {}
        if hdr_dir is not None:
            for name in self.light_names:
                p = Path(hdr_dir) / f"{name}.hdr"
                if p.exists():
                    self.lights_probes[name] = read_hdr(str(p))

    def __len__(self):
        return len(self.split_list)

    def _rgba_name(self, light_name: str) -> str:
        return f"rgba_{light_name}.png"

    def __getitem__(self, idx) -> Dict:
        item_path = self.split_list[idx]
        with open(item_path / "metadata.json") as f:
            meta = json.load(f)
        rays, c2w, img_wh = _view_rays(meta, self.downsample)

        rgbs, lidx, mask = [], [], None
        for name in self.light_names:
            rgb, mask = load_rgba_white_composite(
                item_path / self._rgba_name(name), img_wh)
            rgbs.append(rgb)
            lidx.append(np.zeros((rgb.shape[0], 1), np.int32))

        albedo, _ = load_rgba_white_composite(item_path / "albedo.png", img_wh)
        normals = load_normal_png(item_path / "normal.png", img_wh)

        return {
            "img_wh": img_wh,
            "light_idx": np.stack(lidx, 0),
            "rgbs": np.stack(rgbs, 0),
            "rgbs_mask": mask,
            "albedo": albedo,
            "rays": rays,
            "normals": normals,
            "c2w": c2w,
        }


class TensoIRMaterialEditingTestDataset(TensoIRRelightingTestDataset):
    """The relighting test set, reading the 'city'-lit image for every
    light."""

    def _rgba_name(self, light_name: str) -> str:
        return "rgba_city.png"
