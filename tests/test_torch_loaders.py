"""The port's dataset loaders against the JAX package's, on fixtures
written as tests/test_data_loaders.py writes them (PIL RGBA images, JAX's
RGBE writer): ``all_rays``, ``all_rgbs``, ``all_light_idx``, the probes,
every key of every item and the orbit poses must be equal, dtypes
included. The port reads PNGs with its own reader and sizes from IHDR."""
import json
import os

import numpy as np
import pytest
from PIL import Image

from tensoir_tpu.data import get_dataset as j_get
from tensoir_tpu.data.hdr import write_hdr
from tensoir_tpu.data.ray_utils import look_at

from tensoir_tpu_torch.data import get_dataset as t_get
from tensoir_tpu_torch.data.synthetic import write_relight_test_scene

from test_data_loaders import _make_tensoir_fixture, _write_rgba


def _assert_same(t_obj, j_obj, names):
    for name in names:
        a, b = getattr(t_obj, name), getattr(j_obj, name)
        if isinstance(b, dict):
            assert set(a) == set(b), name
            for k in b:
                assert np.array_equal(a[k], b[k]), (name, k)
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name


def _assert_items(t_ds, j_ds):
    assert len(t_ds) == len(j_ds) > 0
    for i in range(len(j_ds)):
        ti, ji = t_ds[i], j_ds[i]
        assert set(ti) == set(ji), i
        for k in ji:
            a, b = np.asarray(ti[k]), np.asarray(ji[k])
            assert a.dtype == b.dtype and np.array_equal(a, b), (i, k)


DATA = ("all_rays", "all_rgbs", "all_light_idx", "scene_bbox", "img_wh",
        "near_far", "white_bg")


@pytest.mark.parametrize("sub", [0, 1], ids=["all", "sub1"])
def test_rotated_lights_loader_matches_jax(tmp_path, sub):
    root, hdr_dir = str(tmp_path / "armadillo"), str(tmp_path / "hdr")
    os.makedirs(hdr_dir)
    probe = np.random.default_rng(1).random((8, 16, 3)).astype(np.float32)
    write_hdr(os.path.join(hdr_dir, "sunset.hdr"), probe * 3)
    _make_tensoir_fixture(root, n_views=3, rotations=("000", "120"))
    kw = dict(light_rotation=["000", "120"], light_name="sunset", sub=sub)
    name = "tensoIR_unknown_rotated_lights"
    t_tr = t_get(name)(root, hdr_dir, split="train", **kw)
    j_tr = j_get(name)(root, hdr_dir, split="train", **kw)
    _assert_same(t_tr, j_tr, DATA + ("lights_probes", "light_num"))
    assert t_tr.all_rays.shape == ((sub or 3) * 2 * 256, 6)
    t_te = t_get(name)(root, hdr_dir, split="test", **kw)
    j_te = j_get(name)(root, hdr_dir, split="test", **kw)
    _assert_items(t_te, j_te)
    assert {"albedo", "normals", "w2c"} <= set(t_te[0])
    # no probe directory: no probe
    assert t_get(name)(root, None, split="test", **kw).lights_probes is None


def test_general_multi_lights_loader_matches_jax(tmp_path):
    root, hdr_dir = str(tmp_path / "ficus"), str(tmp_path / "hdr")
    names = ["sunset", "snow"]
    os.makedirs(hdr_dir)
    write_hdr(os.path.join(hdr_dir, "snow.hdr"), np.ones((4, 8, 3), np.float32))
    _make_tensoir_fixture(root, general_names=names)
    cls_t = t_get("tensoIR_unknown_general_multi_lights")
    cls_j = j_get("tensoIR_unknown_general_multi_lights")
    for split in ("train", "test"):
        t_ds = cls_t(root, hdr_dir, split=split, light_name_list=names)
        j_ds = cls_j(root, hdr_dir, split=split, light_name_list=names)
        _assert_same(t_ds, j_ds, ("lights_probes", "light_num", "img_wh"))
        if split == "train":
            _assert_same(t_ds, j_ds, DATA)
        else:
            _assert_items(t_ds, j_ds)


def _blender_fixture(root):
    os.makedirs(root)
    for split in ("train", "test"):
        frames = []
        for k in range(3):
            c2w = look_at([4 * np.cos(k), 4 * np.sin(k), 1.0])
            m = np.concatenate([c2w, [[0, 0, 0, 1]]], 0).tolist()
            frames.append({"file_path": f"./{split}/r_{k}",
                           "transform_matrix": m})
            os.makedirs(os.path.join(root, split), exist_ok=True)
            _write_rgba(os.path.join(root, split, f"r_{k}.png"), seed=k)
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.69, "frames": frames}, f)


@pytest.mark.parametrize("is_stack", [False, True], ids=["flat", "stack"])
def test_blender_loader_matches_jax(tmp_path, is_stack):
    root = str(tmp_path / "lego")
    _blender_fixture(root)
    for split in ("train", "test"):
        kw = dict(split=split, downsample=50.0, is_stack=is_stack)
        t_ds, j_ds = t_get("blender")(root, **kw), j_get("blender")(root, **kw)
        _assert_same(t_ds, j_ds, DATA + ("all_masks", "poses", "intrinsics",
                                         "directions"))
        if split == "test" or is_stack:
            _assert_items(t_ds, j_ds)
        else:
            ti, ji = t_ds[5], j_ds[5]
            assert all(np.array_equal(ti[k], ji[k]) for k in ji)


def _simple_fixture(root, n=3, size=(12, 10)):
    os.makedirs(root)
    frames = {}
    for k in range(n):
        c2w = look_at([4 * np.cos(k), 4 * np.sin(k), 1.0])
        m = np.concatenate([c2w, [[0, 0, 0, 1]]], 0).tolist()
        frames[str(k)] = {"file_path": f"img_{k}", "transform_matrix": m,
                          "light_idx": k % 3}
        rng = np.random.default_rng(k)
        arr = (rng.random((size[1], size[0], 4)) * 255).astype(np.uint8)
        Image.fromarray(arr, "RGBA").save(os.path.join(root, f"img_{k}.png"))
    for split in ("train", "test"):
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.69, "frames": frames}, f)


def test_simple_loader_and_orbit_match_jax(tmp_path):
    root = str(tmp_path / "own")
    _simple_fixture(root)
    cls_t, cls_j = t_get("tensoIR_simple"), j_get("tensoIR_simple")
    kw = dict(light_rotation=["000", "120"])
    t_tr, j_tr = cls_t(root, split="train", **kw), cls_j(root, split="train",
                                                         **kw)
    _assert_same(t_tr, j_tr, DATA + ("all_masks", "frame_keys"))
    assert t_tr.img_wh == (12, 10) and set(t_tr.frame_keys) == {"0", "1"}
    t_te, j_te = cls_t(root, split="test", **kw), cls_j(root, split="test",
                                                        **kw)
    _assert_items(t_te, j_te)
    kw.update(test_new_pose=True, n_orbit=5)
    t_or, j_or = cls_t(root, split="test", **kw), cls_j(root, split="test",
                                                        **kw)
    _assert_same(t_or, j_or, ("orbit_poses",))
    _assert_items(t_or, j_or)
    assert t_or[0]["synthetic_pose"] and t_or[0]["rays"].shape == (120, 6)


def test_loader_refusals(tmp_path):
    # the relighting test sets load, as JAX's do, on a relighting scene
    relit = tmp_path / "relit"
    write_relight_test_scene(str(relit / "scene"), str(relit / "hdr"),
                             lights=("city", "night"), n_views=1, size=8,
                             env_hw=(8, 16), gt_env_hw=(4, 8))
    for name in ("tensoIR_relighting_test", "tensoIR_material_editing_test"):
        kw = dict(split="test", light_names=("city", "night"))
        tds = t_get(name)(str(relit / "scene"), str(relit / "hdr"), **kw)
        jds = j_get(name)(str(relit / "scene"), str(relit / "hdr"), **kw)
        _assert_items(tds, jds)
        _assert_same(tds, jds, ("lights_probes", "scene_bbox", "img_wh",
                                "near_far", "white_bg"))
    root = str(tmp_path / "armadillo")
    _make_tensoir_fixture(root, n_views=1, rotations=("000",))
    # a 16 x 16 file for an 8 x 8 view: JAX resizes with PIL, the port
    # refuses
    cls = t_get("tensoIR_unknown_rotated_lights")
    with pytest.raises(ValueError, match="resizing on load is not ported"):
        cls(root, None, split="train", downsample=2.0)
    assert j_get("tensoIR_unknown_rotated_lights")(
        root, None, split="train", downsample=2.0).all_rays.shape == (64, 6)
