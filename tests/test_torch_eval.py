"""The port's evaluation against the JAX package's, on the CPU, on one tiny
field (JAX's, blob seeded, carried over as numpy) and the shadow scene
written as a rotated-lights scene (two 12 x 12 test views with albedo,
normals and a sunset probe), read by each package's own loader.

Tolerances. Every map within 1e-4 absolute (the largest difference seen
is 1.4e-6, in ``depth_map``). The port's chunk equals JAX's eager render
to ~1e-6; at 48 samples per ray on this field JAX's jitted chunk was
1.04e-4 off its own eager ``acc_map`` on 23 of 144 rays (XLA's fused
arithmetic, ROADMAP queue 3), which 96 samples do not meet. The metrics:
PSNR within 0.01 dB, SSIM within 1e-4, normal MAE within 0.01 degrees.
Written PNGs: every pixel within 1 level, the depth panel's JET colours
within one level of depth.
"""
import os

import numpy as np
import pytest
import torch
from PIL import Image

from tensoir_tpu.data import get_dataset as j_get
from tensoir_tpu.render import eval as JE

from tensoir_tpu_torch.data import get_dataset as t_get
from tensoir_tpu_torch.data.synthetic import write_shadow_scene
from tensoir_tpu_torch.render import eval as TE
from tensoir_tpu_torch.utils.metrics import JET

from torch_parity import (jax_field, one_torch_thread, port_cfg,  # noqa: F401
                          port_field, small_cfg)
from test_torch_loaders import _simple_fixture

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_SAMPLES, CHUNK, TILE = 96, 64, 1024   # 96 samples > app cap 64: top-k
EXACT = dict(second_n_sample=16, secondary_tile=TILE)
FAST = dict(second_n_sample=96, secondary_tile=TILE)
MAP_ATOL = 1e-4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    write_shadow_scene(str(root / "scene"), str(root / "hdr"),
                       views=(("test", 2, 12),), env_hw=(16, 32))
    kw = dict(split="test", light_rotation=["000"], light_name="sunset")
    name = "tensoIR_unknown_rotated_lights"
    jds = j_get(name)(str(root / "scene"), str(root / "hdr"), **kw)
    tds = t_get(name)(str(root / "scene"), str(root / "hdr"), **kw)
    jcfg = small_cfg(envmap_h=4, envmap_w=8)
    jp, js = jax_field(jcfg, grid=(24, 20, 16))
    tp, ts = port_field(jp, js)
    return dict(root=root, jds=jds, tds=tds, jcfg=jcfg, tcfg=port_cfg(jcfg),
                jp=jp, js=js, tp=tp, ts=ts)


def _assert_maps(t_out, j_out, what):
    assert set(t_out) == set(j_out), what
    for k, jv in j_out.items():
        tv = t_out[k]
        assert tv.shape == jv.shape, (what, k)
        d = np.abs(tv.astype(np.float64) - jv.astype(np.float64)).max()
        assert d <= MAP_ATOL, (what, k, d)


@pytest.mark.parametrize("fast", [False, True, "hoist"],
                         ids=["exact", "fast", "fast_hoist"])
def test_eval_chunk_matches_jax(setup, fast):
    """make_eval_chunk_fn + render_image over 144 rays in chunks of 64 (the
    last padded), every ray relit under the 32 fixed directions: the exact
    full march, and FAST_MARCH_KNOBS (window 48/16 over the coarse
    occupancy, compaction, bakes) at 96 secondary samples, with the app
    stage in its tiles or hoisted out of them (``secondary_app_hoist``)."""
    s = setup
    item = s["tds"][0]
    rays = np.asarray(item["rays"], np.float32)
    lidx = np.zeros((rays.shape[0], 1), np.int32)
    knobs = (dict(FAST, **TE.FAST_MARCH_KNOBS, ndc_ray=False,
                  secondary_app_hoist=fast == "hoist") if fast else EXACT)
    assert dict(JE.FAST_MARCH_KNOBS) == dict(TE.FAST_MARCH_KNOBS)
    j_fn, c = JE.make_eval_chunk_fn(s["jcfg"], n_samples=N_SAMPLES,
                                    chunk=CHUNK, **knobs)
    t_fn, _ = TE.make_eval_chunk_fn(s["tcfg"], n_samples=N_SAMPLES,
                                    chunk=CHUNK, **knobs)
    j_out = JE.render_image(j_fn, c, s["jp"], s["js"], rays, lidx)
    t_out = TE.render_image(t_fn, c, s["tp"], s["ts"], rays, lidx)
    acc = j_out["acc_map"]
    assert (acc > 0.5).sum() > 10 and (acc < 0.5).sum() > 10
    assert j_out["acc_mask"].dtype == t_out["acc_mask"].dtype == np.bool_
    _assert_maps(t_out, j_out, str(fast))
    # one chunk, directly: the maps are torch tensors on the field's device
    out = t_fn(s["tp"], s["ts"], torch.as_tensor(rays[:CHUNK]),
               torch.zeros((CHUNK,), dtype=torch.int32))
    assert out["rgb_with_brdf_map"].shape == (CHUNK, 3)
    assert not out["rgb_map"].requires_grad


def _png(path):
    return np.asarray(Image.open(path))


def _jet_levels(img):
    """uint8 JET colours [..., 3] -> their levels."""
    lut = {tuple(c): i for i, c in enumerate(JET.tolist())}
    return np.array([lut[tuple(p)] for p in img.reshape(-1, 3).tolist()]
                    ).reshape(img.shape[:-1])


def _assert_pngs(t_dir, j_dir):
    """Every PNG JAX wrote, written by the port too and within 1 level (the
    depth third of a radiance panel within one JET level)."""
    n = 0
    for dirpath, _, files in os.walk(j_dir):
        for f in files:
            if not f.endswith(".png"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), j_dir)
            a = _png(os.path.join(t_dir, rel)).astype(int)
            b = _png(os.path.join(j_dir, rel)).astype(int)
            assert a.shape == b.shape, rel
            if rel.startswith("nvs_with_radiance_field"):
                w = a.shape[1] // 3
                da = _jet_levels(a[:, 2 * w:].astype(np.uint8))
                db = _jet_levels(b[:, 2 * w:].astype(np.uint8))
                assert np.abs(da - db).max() <= 1, rel
                a, b = a[:, :2 * w], b[:, :2 * w]
            assert np.abs(a - b).max() <= 1, rel
            n += 1
    return n


def _record_lines(path):
    with open(path) as f:
        return f.read().splitlines()


@pytest.mark.parametrize("test_all", [True, False], ids=["test_all", "n_vis"])
def test_evaluation_iter_matches_jax(setup, tmp_path, test_all):
    """evaluation_iter with and without test_all (the global albedo ratio
    from the G-buffer chunks, or per-view ratios on n_vis views): the same
    keys, the metrics within their tolerances, the same artifacts and the
    same metrics_record.txt line format."""
    s = setup
    kw = dict(n_samples=N_SAMPLES, chunk=CHUNK, test_all=test_all, n_vis=1,
              compute_extra_metrics=True, prtx="" if test_all else "000007_",
              **EXACT)
    j_res = JE.evaluation_iter(s["jcfg"], s["jp"], s["js"], s["jds"],
                               save_path=str(tmp_path / "jax"), **kw)
    t_res = TE.evaluation_iter(s["tcfg"], s["tp"], s["ts"], s["tds"],
                               save_path=str(tmp_path / "port"), **kw)
    assert list(t_res) == list(j_res)
    assert {"ssim_nvs", "normal_mae_deg", "psnr_albedo_three",
            "ssim_albedo_single"} <= set(t_res)
    for k, v in j_res.items():
        tol = (1e-4 if k.startswith("ssim") else 0.01)
        assert abs(t_res[k] - v) <= tol, (k, t_res[k], v)
    n = _assert_pngs(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert n == (11 if test_all else 6)   # 5 panels per view, the strip
    (t_line,) = _record_lines(tmp_path / "port" / "metrics_record.txt")
    (j_line,) = _record_lines(tmp_path / "jax" / "metrics_record.txt")
    head = "Iteration:final: " if test_all else "Iteration:000007: "
    assert t_line.startswith(head) and j_line.startswith(head)
    t_kv = [kv.split(": ") for kv in t_line[len(head):].split(", ")]
    j_kv = [kv.split(": ") for kv in j_line[len(head):].split(", ")]
    assert [k for k, _ in t_kv] == [k for k, _ in j_kv]
    assert all(len(v.split(".")[1]) == 4 for _, v in t_kv)
    # the strip: the probe resized beside the learned light
    strip = _png(tmp_path / "port" / "envir_map" / f"{kw['prtx']}envirmap.png")
    assert strip.shape == (256, 1024, 3)


def test_evaluation_path_matches_jax(setup, tmp_path):
    """evaluation_path on a TensoIRSimpleDataset orbit (no ground truth; the
    fast march, on by default): the same frames within 1 level."""
    s = setup
    root = str(tmp_path / "own")
    _simple_fixture(root, size=(10, 8))
    # three rotations keep all three frames (light_idx k % 3) for the orbit
    kw = dict(split="test", light_rotation=["000", "120", "240"],
              test_new_pose=True, n_orbit=2)
    j_path = j_get("tensoIR_simple")(root, **kw)
    t_path = t_get("tensoIR_simple")(root, **kw)
    args = dict(n_samples=N_SAMPLES, chunk=CHUNK, **FAST)
    assert JE.evaluation_path(s["jcfg"], s["jp"], s["js"], j_path,
                              save_path=str(tmp_path / "jax"), **args) == 2
    assert TE.evaluation_path(s["tcfg"], s["tp"], s["ts"], t_path,
                              save_path=str(tmp_path / "port"), **args) == 2
    assert _assert_pngs(str(tmp_path / "port"), str(tmp_path / "jax")) == 6


def test_fast_march_contract_is_enforced(setup, tmp_path, capsys):
    """A box too thin for the fast march's prepass: evaluation_iter raises,
    evaluation_path falls back to the exact march with a note."""
    s = setup
    scene = dict(s["ts"], aabb=torch.tensor([[-1.5, -1.5, -0.05],
                                             [1.5, 1.5, 0.05]]))
    with pytest.raises(ValueError, match="contract"):
        TE.evaluation_iter(s["tcfg"], s["tp"], scene, s["tds"],
                           n_samples=N_SAMPLES, fast_march=True, **EXACT)
    root = str(tmp_path / "own")
    _simple_fixture(root, size=(4, 4))
    path = t_get("tensoIR_simple")(root, split="test", test_new_pose=True,
                                   n_orbit=1,
                                   light_rotation=["000", "120", "240"])
    assert TE.evaluation_path(s["tcfg"], s["tp"], scene, path,
                              n_samples=N_SAMPLES, chunk=CHUNK,
                              save_path=str(tmp_path / "p"), **EXACT) == 1
    assert "falling back to the exact march" in capsys.readouterr().out
