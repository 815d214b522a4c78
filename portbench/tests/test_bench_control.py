"""The control and the faults on the card, at each cell's own size and
against its own limits (``limits/<cell>.json``): the plain reference in the
program's place with TF32 on, and the timed path broken underneath, each
come out not ``correct`` by the harness's verdict. Needs a card (marker
``cuda``): ``python -m pytest portbench/tests -m cuda`` on the chip."""
from __future__ import annotations

import pytest
import torch

from portbench import control
from portbench.harness import check, main

CASES = [("armadillo.relight_train", "tf32"),
         ("armadillo.relight_train", "half_batch"),
         ("armadillo.relight_train", "unchanged"),
         ("armadillo.eval_view", "tf32"),
         ("armadillo.eval_view", "altered"),
         ("armadillo.relight_view", "tf32"),
         ("armadillo.relight_view", "altered"),
         ("armadillo_cp.eval_view", "tf32"),
         ("armadillo.radiance_train", "tf32")]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is TF32, which only the "
                    "card computes, at the cells' own sizes")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name,variant", CASES)
def test_control_and_faults_are_not_correct_at_the_cells_limits(
        card, name, variant):
    entry, conf, traffic = main.cell_files(main.load_manifest(), name)
    # a render cell's window runs long enough to reach chunks that hit the
    # object, as a run's does: the check samples among those
    out = control.read(conf, traffic, variant=variant, seed=2 ** 31 + 21,
                       seconds=5.0, device=card,
                       limits=check.load_limits(name))
    print(name, variant, out["checked"])
    assert not out["correct"], out["checked"]
