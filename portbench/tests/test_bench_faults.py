"""A whole run of each cell on the CPU at tiny sizes, past the harness's
look for a card: sound, ``correct`` comes out true; with the timed path
broken underneath (a step that returns its state unchanged, half of the
batch left out, an answer altered where it is produced), false. Each
against the cell's own limits. The program and the reference are the same
arithmetic on the CPU, so the sound gaps read 0."""
from __future__ import annotations

import time

import pytest
import torch

from portbench import control
from portbench.harness import check, main
from portbench.tests.tiny import cell

CELLS = ["armadillo.relight_train", "armadillo.eval_view",
         "armadillo.relight_view"]
FAULTS = [("armadillo.relight_train", "unchanged"),
          ("armadillo.relight_train", "half_batch"),
          ("armadillo.eval_view", "altered"),
          ("armadillo.relight_view", "altered")]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    entry, conf, traffic = cell(name)
    res = main.run_cell(conf, traffic, seed=2 ** 31 + 11, seconds=0.5,
                        trace=False, device="cpu",
                        t_start=time.perf_counter(),
                        limits=check.load_limits(name),
                        metrics=main.metrics_of(main.load_manifest(), entry,
                                                False))
    assert res["correct"], res["numbers"]
    assert all(v == 0.0 for _, v, _ in res["numbers"])
    assert set(res["metrics"]) >= {"setup_s"}
    assert res["attempted"] >= 1


@pytest.mark.parametrize("name,variant", FAULTS)
def test_a_broken_timed_path_is_not_correct(name, variant):
    entry, conf, traffic = cell(name)
    out = control.read(conf, traffic, variant=variant,
                       seed=2 ** 31 + 13, seconds=0.5, device="cpu",
                       limits=check.load_limits(name))
    assert not out["correct"], out["checked"]
