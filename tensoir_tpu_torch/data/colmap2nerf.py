"""Offline capture tool: video/images -> COLMAP -> transforms.json (the
port's own copy of tensoir_tpu.data.colmap2nerf).

The own-capture pipeline of the reference's dataLoader/colmap2nerf.py:
extract frames, run the colmap binaries, convert the sparse reconstruction
into the transforms.json that TensoIRSimpleDataset reads. It needs
`colmap` (and `ffmpeg` for a video) on PATH: it is a host tool, not part of
the training path, and uses neither torch nor the card.

Usage:
  python -m tensoir_tpu_torch.data.colmap2nerf --images ./images --out transforms.json
  python -m tensoir_tpu_torch.data.colmap2nerf --video in.mp4 --video_fps 2 ...
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np


def run(cmd):
    print("+", " ".join(cmd))
    subprocess.run(cmd, check=True)


def extract_video_frames(video: str, images_dir: str, fps: float):
    os.makedirs(images_dir, exist_ok=True)
    run(["ffmpeg", "-i", video, "-qscale:v", "1", "-qmin", "1",
         "-vf", f"fps={fps}", os.path.join(images_dir, "%04d.jpg")])


def run_colmap(images_dir: str, work_dir: str, matcher: str = "sequential"):
    db = os.path.join(work_dir, "colmap.db")
    sparse = os.path.join(work_dir, "sparse")
    text = os.path.join(work_dir, "text")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(text, exist_ok=True)
    run(["colmap", "feature_extractor", "--database_path", db,
         "--image_path", images_dir,
         "--ImageReader.camera_model", "OPENCV",
         "--ImageReader.single_camera", "1"])
    run(["colmap", f"{matcher}_matcher", "--database_path", db])
    run(["colmap", "mapper", "--database_path", db,
         "--image_path", images_dir, "--output_path", sparse])
    run(["colmap", "bundle_adjuster", "--input_path", f"{sparse}/0",
         "--output_path", f"{sparse}/0",
         "--BundleAdjustment.refine_principal_point", "1"])
    run(["colmap", "model_converter", "--input_path", f"{sparse}/0",
         "--output_path", text, "--output_type", "TXT"])
    return text


def _qvec2rotmat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
    ])


def _rotmat_between(a, b):
    """Rotation matrix taking unit vector a to unit vector b (Rodrigues)."""
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if np.linalg.norm(v) < 1e-12:
        return np.eye(3) if c > 0 else -np.eye(3)
    k = np.array([[0, -v[2], v[1]],
                  [v[2], 0, -v[0]],
                  [-v[1], v[0], 0]])
    return np.eye(3) + k + k @ k * (1.0 / (1.0 + c))


def _closest_point_2_lines(oa, da, ob, db):
    """Point closest to two rays (used to find the scene center,
    reference colmap2nerf.py closest_point_2_lines)."""
    da = da / np.linalg.norm(da)
    db = db / np.linalg.norm(db)
    c = np.cross(da, db)
    denom = np.linalg.norm(c) ** 2
    t = ob - oa
    ta = np.linalg.det([t, db, c]) / (denom + 1e-10)
    tb = np.linalg.det([t, da, c]) / (denom + 1e-10)
    ta, tb = max(ta, 0), max(tb, 0)
    return (oa + ta * da + ob + tb * db) * 0.5, denom


def colmap_text_to_transforms(text_dir: str, images_dir: str, out_path: str,
                              aabb_scale: int = 4):
    with open(os.path.join(text_dir, "cameras.txt")) as f:
        for line in f:
            if line.startswith("#"):
                continue
            els = line.split()
            w, h = float(els[2]), float(els[3])
            fl_x = fl_y = float(els[4])
            cx, cy = w / 2, h / 2
            k1 = k2 = p1 = p2 = 0.0
            model = els[1]
            if model in ("OPENCV", "PINHOLE", "SIMPLE_RADIAL", "RADIAL"):
                if model == "PINHOLE":
                    fl_y, cx, cy = float(els[5]), float(els[6]), float(els[7])
                elif model == "SIMPLE_RADIAL":
                    cx, cy, k1 = float(els[5]), float(els[6]), float(els[7])
                elif model == "RADIAL":
                    cx, cy, k1, k2 = (float(els[5]), float(els[6]),
                                      float(els[7]), float(els[8]))
                elif model == "OPENCV":
                    fl_y, cx, cy = float(els[5]), float(els[6]), float(els[7])
                    k1, k2, p1, p2 = (float(els[8]), float(els[9]),
                                      float(els[10]), float(els[11]))
            break
    angle_x = math.atan(w / (fl_x * 2)) * 2

    frames = {}
    up = np.zeros(3)
    with open(os.path.join(text_dir, "images.txt")) as f:
        i = 0
        for line in f:
            if line.startswith("#"):
                continue
            i += 1
            if i % 2 == 1:
                els = line.split()
                qvec = np.array([float(v) for v in els[1:5]])
                tvec = np.array([float(v) for v in els[5:8]])
                R = _qvec2rotmat(-qvec)
                t = tvec.reshape(3, 1)
                m = np.concatenate([np.concatenate([R, t], 1),
                                    [[0, 0, 0, 1]]], 0)
                c2w = np.linalg.inv(m)
                # colmap -> nerf convention flips (reference colmap2nerf.py)
                c2w[0:3, 2] *= -1
                c2w[0:3, 1] *= -1
                c2w = c2w[[1, 0, 2, 3], :]
                c2w[2, :] *= -1
                up += c2w[0:3, 1]
                name = "_".join(els[9:])
                frames[str(len(frames))] = {
                    "file_path": os.path.join(
                        os.path.relpath(images_dir,
                                        os.path.dirname(out_path) or "."),
                        name),
                    "transform_matrix": c2w.tolist(),
                    "light_idx": 0,
                }

    # --- normalize the scene frame (reference colmap2nerf.py:268-301):
    # rotate so the average camera-up becomes +z, recenter on the point
    # the cameras look at, and rescale so cameras sit at ~4 units — this
    # is what puts a raw COLMAP reconstruction inside the trainer's
    # default bbox/near-far conventions
    mats = {k: np.array(fr["transform_matrix"]) for k, fr in frames.items()}
    if mats:
        up_n = up / (np.linalg.norm(up) + 1e-12)
        R_up = _rotmat_between(up_n, np.array([0.0, 0.0, 1.0]))
        T = np.eye(4)
        T[:3, :3] = R_up
        mats = {k: T @ m for k, m in mats.items()}

        # central point: weighted closest point of all view-ray pairs
        totw = 0.0
        totp = np.zeros(3)
        ms = list(mats.values())
        for i, ma in enumerate(ms):
            for mb in ms[i + 1:]:
                pt, wgt = _closest_point_2_lines(
                    ma[:3, 3], ma[:3, 2], mb[:3, 3], mb[:3, 2])
                if wgt > 0.01:  # reference's pair weight threshold
                    totp += pt * wgt
                    totw += wgt
        if totw > 0:
            center = totp / totw
            for m in mats.values():
                m[:3, 3] -= center

        avglen = float(np.mean([np.linalg.norm(m[:3, 3])
                                for m in mats.values()]))
        if avglen > 1e-9:
            for m in mats.values():
                m[:3, 3] *= 4.0 / avglen
        for k, m in mats.items():
            frames[k]["transform_matrix"] = m.tolist()

    out = {
        "camera_angle_x": angle_x,
        "fl_x": fl_x, "fl_y": fl_y, "cx": cx, "cy": cy, "w": w, "h": h,
        "k1": k1, "k2": k2, "p1": p1, "p2": p2,
        "aabb_scale": aabb_scale,
        "frames": frames,
    }
    with open(out_path, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {len(frames)} frames to {out_path}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--video", type=str, default=None)
    parser.add_argument("--video_fps", type=float, default=2.0)
    parser.add_argument("--images", type=str, default="./images")
    parser.add_argument("--workdir", type=str, default="./colmap_work")
    parser.add_argument("--matcher", type=str, default="sequential",
                        choices=["sequential", "exhaustive"])
    parser.add_argument("--out", type=str, default="transforms.json")
    args = parser.parse_args(argv)

    if shutil.which("colmap") is None:
        sys.exit("colmap binary not found on PATH")
    if args.video:
        if shutil.which("ffmpeg") is None:
            sys.exit("ffmpeg binary not found on PATH")
        extract_video_frames(args.video, args.images, args.video_fps)
    os.makedirs(args.workdir, exist_ok=True)
    text_dir = run_colmap(args.images, args.workdir, args.matcher)
    colmap_text_to_transforms(text_dir, args.images, args.out)


if __name__ == "__main__":
    main()
