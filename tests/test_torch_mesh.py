"""Mesh export of the port against the JAX package's, on the CPU.

- The port's host extractor (its own copy of the marching-tetrahedra
  source, built with the same g++ flags) gives exactly the JAX package's
  native vertices and faces, in order; its numpy path exactly JAX's numpy
  path. The two paths of the port agree as vertex sets to 1e-4 (the numpy
  path places a vertex in float64 and rounds once, the library in float32
  at every step) with equal counts.
- The PLY bytes equal JAX's ``write_ply`` bytes.
- ``dense_alpha`` equals JAX's to 1e-5 (both evaluate the same field; the
  port in chunks of x-slabs, JAX slice by slice under ``jit``, so the sums
  of the density components may differ in ulps).
- The export script on a checkpoint written by JAX: the same face count
  as JAX's script, every vertex within 1e-4 of one of JAX's and back
  (symmetric nearest-vertex distance): an ulp of alpha near the level
  moves a vertex along its edge by ulp / |alpha gradient|, far below 1e-4
  on these grids, and can flip no corner unless alpha sits on the level.
- The CLI's ``--export_mesh 1``, and a failed build raises (no fallback).
"""
import importlib.util
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
from scipy.spatial import cKDTree

from tensoir_tpu.models import lifecycle as JLC
from tensoir_tpu.utils import ckpt as JCK
from tensoir_tpu.utils import mesh_export as JM

from tensoir_tpu_torch import train_tensoir as TCLI
from tensoir_tpu_torch.kernels import build
from tensoir_tpu_torch.models import lifecycle as TLC
from tensoir_tpu_torch.scripts import export_mesh as TX
from tensoir_tpu_torch.utils import mesh_export as TM

from torch_parity import (jax_field, one_torch_thread,  # noqa: F401
                          port_cfg, port_field, small_cfg, to_numpy)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parent.parent


def _sphere_grid(n=32, r=0.6):
    lin = np.linspace(-1, 1, n, dtype=np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    return (r - np.sqrt(x * x + y * y + z * z)).astype(np.float32)


def _box_grid():
    """An anisotropic grid (17 x 23 x 11) of a soft box, with noise."""
    rng = np.random.default_rng(3)
    x, y, z = np.meshgrid(np.linspace(-1, 1, 17), np.linspace(-1, 1, 23),
                          np.linspace(-1, 1, 11), indexing="ij")
    d = np.maximum(np.maximum(np.abs(x) / 0.7, np.abs(y) / 0.5),
                   np.abs(z) / 0.8)
    g = 1.0 / (1.0 + np.exp(12.0 * (d - 1.0)))
    return (g + 0.01 * rng.normal(size=g.shape)).astype(np.float32)


# (grid, bbox, level)
CASES = {
    "sphere32": (_sphere_grid(), [[-1, -1, -1], [1, 1, 1]], 0.0),
    "sphere12": (_sphere_grid(12, 0.5), [[-1, -1, -1], [1, 1, 1]], 0.0),
    "box": (_box_grid(), [[-1.5, -0.5, -1.0], [1.5, 1.5, 0.2]], 0.5),
}


def _origin_spacing(grid, bbox):
    bbox = np.asarray(bbox, np.float32)
    return bbox[0], ((bbox[1] - bbox[0]) /
                     np.array(grid.shape, np.float32)).astype(np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_extractor_equals_jax_exactly(case):
    grid, bbox, level = CASES[case]
    origin, spacing = _origin_spacing(grid, bbox)
    tv, tf = TM._extract_native(grid, level, origin, spacing)
    jv, jf = JM._extract_native(grid, level, origin, spacing)
    assert len(tv) > 50 and len(tf) > 50
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    assert tv.dtype == np.float32 and tf.dtype == np.int32
    tv, tf = TM.extract_mesh(grid, bbox, level)
    jv, jf = JM.extract_mesh(grid, bbox, level)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    # the plain numpy path, against JAX's
    nv, nf = TM._extract_numpy(grid, level, origin, spacing)
    jnv, jnf = JM._extract_numpy(grid, level, origin, spacing)
    np.testing.assert_array_equal(nv, jnv)
    np.testing.assert_array_equal(nf, jnf)


def _nearest(a, b):
    """Symmetric nearest-point distance of two point sets."""
    return max(cKDTree(b).query(a)[0].max(), cKDTree(a).query(b)[0].max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_and_numpy_paths_agree(case):
    grid, bbox, level = CASES[case]
    origin, spacing = _origin_spacing(grid, bbox)
    nv, nf = TM._extract_numpy(grid, level, origin, spacing)
    tv, tf = TM._extract_native(grid, level, origin, spacing)
    assert len(nv) == len(tv) and len(nf) == len(tf)
    assert _nearest(nv, tv) < 1e-4
    # the same triangles: the numpy path's vertices snapped onto the
    # library's nearest ones (vertices clipped onto a grid corner repeat, so
    # they are matched by place, not by index), then each face as its set of
    # corners
    snapped = tv[cKDTree(tv).query(nv)[1]]

    def faces(v, f):
        return sorted(tuple(sorted(map(tuple, c))) for c in v[f].tolist())
    assert faces(snapped, nf) == faces(tv, tf)
    # watertight: every edge of the sphere shared by exactly two faces
    if case.startswith("sphere"):
        edges = np.sort(np.concatenate([tf[:, [0, 1]], tf[:, [1, 2]],
                                        tf[:, [2, 0]]]), 1)
        _, counts = np.unique(edges, axis=0, return_counts=True)
        assert (counts == 2).mean() > 0.99


def test_ply_bytes_equal_jax(tmp_path):
    grid, bbox, level = CASES["box"]
    verts, faces = TM.export_mesh_from_alpha(grid, bbox,
                                             str(tmp_path / "t.ply"), level)
    JM.write_ply(str(tmp_path / "j.ply"), verts, faces)
    data = (tmp_path / "t.ply").read_bytes()
    assert data == (tmp_path / "j.ply").read_bytes()
    assert data.startswith(b"ply\nformat binary_little_endian 1.0\n")
    assert len(data) == (data.index(b"end_header\n") + 11
                         + 12 * len(verts) + 13 * len(faces))
    empty = tmp_path / "e.ply"
    TM.write_ply(str(empty), np.zeros((0, 3)), np.zeros((0, 3)))
    JM.write_ply(str(tmp_path / "je.ply"), np.zeros((0, 3)), np.zeros((0, 3)))
    assert empty.read_bytes() == (tmp_path / "je.ply").read_bytes()


@pytest.fixture(scope="module")
def field():
    jcfg = small_cfg()
    jp, js0 = jax_field(jcfg)
    js, _ = JLC.update_alpha_mask(jcfg, jp, js0, (24, 20, 16))
    return jcfg, jp, js, js0


@pytest.mark.parametrize("masked", [False, True])
def test_dense_alpha_matches_jax(field, masked):
    jcfg, jp, js, js0 = field
    js = js if masked else js0
    tp, ts = port_field(jp, js)
    grid = (24, 20, 16)
    j = JLC.dense_alpha(jcfg, jp, js, grid)
    t = TLC.dense_alpha(port_cfg(jcfg), tp, ts, grid).numpy()
    assert t.shape == j.shape == grid
    assert 0.0 < (j > 0.005).mean() < 1.0
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-5)


def _read_ply(path):
    data = Path(path).read_bytes()
    head, body = data.split(b"end_header\n", 1)
    nv = int(head.split(b"element vertex ")[1].split(b"\n")[0])
    nf = int(head.split(b"element face ")[1].split(b"\n")[0])
    verts = np.frombuffer(body[:12 * nv], "<f4").reshape(nv, 3)
    rec = np.frombuffer(body[12 * nv:], [("n", "u1"), ("idx", "<i4", (3,))])
    assert len(rec) == nf and (rec["n"] == 3).all()
    return verts, rec["idx"]


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_export_mesh_script", ROOT / "scripts" / "export_mesh.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_export_script_on_a_jax_checkpoint_matches_jax(field, tmp_path,
                                                       capsys):
    jcfg, jp, js, _ = field
    ckpt = str(tmp_path / "ckpt_final.npz")
    JCK.save_checkpoint(ckpt, jcfg, to_numpy(jp), to_numpy(js))
    _jax_script().main(["--ckpt", ckpt])
    jv, jf = _read_ply(tmp_path / "ckpt_final.ply")
    os.remove(tmp_path / "ckpt_final.ply")
    out, tv, tf = TX.main(["--ckpt", ckpt], device="cpu")
    assert out == str(tmp_path / "ckpt_final.ply")
    assert f"{len(tv)} verts, {len(tf)} faces" in capsys.readouterr().out
    pv, pf = _read_ply(out)
    np.testing.assert_array_equal(pv, tv)
    np.testing.assert_array_equal(pf, tf)
    assert len(tf) == len(jf) > 100 and len(tv) == len(jv)
    assert _nearest(tv, jv) < 1e-4
    # a path without the .npz suffix gets .ply appended, never replaced
    assert TX.mesh_path(str(tmp_path / "ck")) == str(tmp_path / "ck.ply")


def test_cli_export_mesh(field, tmp_path):
    jcfg, jp, js, _ = field
    ckpt = str(tmp_path / "run.npz")
    JCK.save_checkpoint(ckpt, jcfg, to_numpy(jp), to_numpy(js))
    res = TCLI.main(["--config", str(ROOT / "configs" / "single_light" /
                                     "armadillo.txt"),
                     "--export_mesh", "1", "--render_test", "0",
                     "--ckpt", ckpt], device="cpu")
    assert res == {"mesh": str(tmp_path / "run.ply")}
    cli = (tmp_path / "run.ply").read_bytes()
    TX.main(["--ckpt", ckpt, "--level", "0.005"], device="cpu")
    assert (tmp_path / "run.ply").read_bytes() == cli


def test_a_failed_build_raises_and_does_not_fall_back(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    shutil.copy(build.CSRC / "mesh_extract.cpp", csrc)
    with open(csrc / "mesh_extract.cpp", "a") as f:
        f.write("\nthis does not compile;\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_loaded", {})
    grid, bbox, level = CASES["sphere12"]
    with pytest.raises(RuntimeError, match="build failed"):
        TM.extract_mesh(grid, bbox, level)
    monkeypatch.setattr(build, "GXX", "no-such-compiler")
    with pytest.raises(FileNotFoundError):
        TM.extract_mesh(grid, bbox, level)
