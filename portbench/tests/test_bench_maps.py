"""``armadillo.relight_view``'s held-out maps and normal network are data
of its traffic: two seeds relight under bit-equal maps and normal weights
drawn from the traffic's ``work_key``, another key draws others, and the
rest of the field still follows the seed. A tiny run reports the share of
pairs the chunk marched; the scan that chose the key picks the key nearest
the median."""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from portbench import scan_work_key
from portbench.harness import check, main, scene
from portbench.paths import relight_chunk
from portbench.tests.tiny import cell

CELL = "armadillo.relight_view"
ENV_MAPS = scene.env_maps


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _built(monkeypatch, seed: int, traffic: dict) -> tuple:
    """(the maps, the raw field's params) that the program's build of
    ``seed`` makes."""
    _, conf, _ = cell(CELL)
    made = []

    def spy(*a, **kw):
        out = ENV_MAPS(*a, **kw)
        made.extend(out)
        return out

    monkeypatch.setattr(scene, "env_maps", spy)
    path = relight_chunk.Path(config=conf, traffic=traffic, seed=seed,
                              device="cpu")
    params, _, _, _ = path._build(False)
    return made, params


def _same(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


def test_the_work_follows_the_traffic_key_and_the_field_the_seed(
        monkeypatch):
    _, _, traffic = cell(CELL)
    maps_a, params_a = _built(monkeypatch, 2 ** 31 + 5, traffic)
    maps_b, params_b = _built(monkeypatch, 17, traffic)
    assert len(maps_a) == traffic["lights"]
    assert all(np.array_equal(a, b) for a, b in zip(maps_a, maps_b))
    assert _same(params_a["normal_mlp"], params_b["normal_mlp"])
    for leaf in ("density_plane_0", "app_line_1", "basis_mat"):
        assert not torch.equal(params_a[leaf], params_b[leaf])
    assert not _same(params_a["brdf_mlp"], params_b["brdf_mlp"])
    other, params_c = _built(monkeypatch, 17,
                             dict(traffic, work_key=traffic["work_key"] + 1))
    assert not any(np.array_equal(a, b) for a, b in zip(maps_a, other))
    assert not _same(params_a["normal_mlp"], params_c["normal_mlp"])


def test_a_tiny_run_reports_the_kept_share():
    entry, conf, traffic = cell(CELL)
    res = main.run_cell(conf, traffic, seed=2 ** 31 + 19, seconds=0.5,
                        trace=False, device="cpu",
                        t_start=time.perf_counter(),
                        limits=check.load_limits(CELL),
                        metrics=main.metrics_of(main.load_manifest(), entry,
                                                False))
    assert res["correct"], res["numbers"]
    share = res["extra"]["kept_share"]
    assert share is not None and 0.0 <= share <= 1.0
    assert share <= res["extra"]["surface_share"]


def test_the_scan_takes_the_key_nearest_the_median():
    assert scan_work_key.choose({0: 0.1, 1: 0.3, 2: 0.2, 3: 0.5}) == 1
    # the median of four lies halfway between two means: the lower key
    assert scan_work_key.choose({5: 0.25, 2: 0.5, 7: 0.125, 9: 0.75}) == 2
    assert relight_chunk.kept_share([]) is None
    assert relight_chunk.kept_share([(1, 4), (3, 4)]) == 0.5
