"""The port's spans (``profiling.span``): free when no profiler records,
recorded at the field, its corner re-pack, the MLP inputs and the primary
pass in a relight training step and an eval chunk, never nested in
themselves, all declared in ``profiling.SPANS``, and the backward of the
corner re-pack traceable to its forward by sequence number."""
from __future__ import annotations

import re
from collections import defaultdict
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tensoir_tpu_torch import profiling
from tensoir_tpu_torch.profiling import SPANS, span
from tensoir_tpu_torch.render import eval as TE
from tensoir_tpu_torch.train import optim as TO
from tensoir_tpu_torch.train import step as TS

from torch_parity import masked_jax_field, port_cfg, port_field, rays

PKG = Path(profiling.__file__).resolve().parent
NODE = "autograd::engine::evaluate_function: "
LEAVES = ("primary", "field", "plane_pack", "mlp_inputs")


def _relight_step(cfg, tp, ts):
    opt = TO.make_optimizer(tp, 0.02, 1e-3, 0.99997, lr_light=1e-3)
    st = TS.StepStatic(n_samples=48, is_relight=True, white_bg=True,
                       app_cap=8, march_cap=24, deterministic=True,
                       relight_ray_cap=16, second_n_sample=16,
                       secondary_tile=256, second_app_cap=8)
    w = TS.LossWeights(l1=4e-5, rgb_brdf=0.2, normals_diff=5e-4,
                       normals_ori=1e-3, albedo_sm=1e-3, rough_sm=1e-3,
                       lr_factor=0.99997, n_iters=80000, relight_start=10000)
    fn = TS.make_train_step(cfg, opt, st, w, device="cpu")
    rng = np.random.default_rng(3)
    batch = {"rays": rays(48, seed=3), "light_idx": np.zeros((48,), np.int32),
             "rgbs": rng.uniform(0, 1, (48, 3)).astype(np.float32)}
    state = opt.init(tp)
    return lambda: fn(tp, state, ts, batch, None, 10000)


def _eval_chunk(cfg, tp, ts):
    fn, _ = TE.make_eval_chunk_fn(cfg, n_samples=96, chunk=64,
                                  second_n_sample=16, secondary_tile=1024)
    r = torch.as_tensor(rays(64, seed=4))
    lidx = torch.zeros((64,), dtype=torch.int32)
    return lambda: fn(tp, ts, r, lidx)


@pytest.fixture(scope="module")
def traces():
    """The profiler's events of one relight training step and of one eval
    chunk on a small masked blob field."""
    jcfg, jp, js = masked_jax_field()
    tp, ts = port_field(jp, js)
    cfg = port_cfg(jcfg)
    out = {}
    for name, make in (("train", _relight_step), ("eval", _eval_chunk)):
        run = make(cfg, tp, ts)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            run()
        out[name] = prof.events()
    return out


def _inside(outer, inner) -> bool:
    return (outer.thread == inner.thread
            and outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def test_span_is_one_shared_no_op_without_a_profiler():
    a, b = span("field"), span("primary")
    assert a is b
    with a as entered:
        assert entered is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("field"):
            torch.ones(2) + 1
    assert "field" in {e.name for e in prof.events()}


@pytest.mark.parametrize("which", ["train", "eval"])
def test_leaf_spans_are_recorded(traces, which):
    names = {e.name for e in traces[which]
             if getattr(e, "is_user_annotation", False)}
    assert set(LEAVES) <= names, set(LEAVES) - names
    assert names <= set(SPANS)


@pytest.mark.parametrize("which", ["train", "eval"])
def test_no_span_opens_inside_its_own_name(traces, which):
    by = defaultdict(list)
    for e in traces[which]:
        if e.name in SPANS:
            by[(e.name, e.thread)].append(e)
    assert set(LEAVES) <= {name for name, _ in by}
    for (name, _), evs in by.items():
        evs.sort(key=lambda e: e.time_range.start)
        for a, b in zip(evs, evs[1:]):
            assert not _inside(a, b), name


def test_every_span_name_is_declared():
    opened = set()
    for f in PKG.rglob("*.py"):
        src = f.read_text()
        opened |= set(re.findall(r"\bspan\(\s*\"([^\"]+)\"", src))
        if f.name != "profiling.py":
            assert "record_function" not in src, f
    assert opened == set(SPANS)
    assert not hasattr(profiling, "profile_trace")
    assert not hasattr(profiling, "annotate")


def test_plane_pack_cat_backward_maps_to_its_forward(traces):
    """The autograd node of a corner re-pack's ``cat`` carries the sequence
    number its forward ``cat`` recorded inside ``plane_pack``, on the
    thread the node names as its forward thread."""
    evs = traces["train"]
    packs = [e for e in evs if e.name == "plane_pack"]
    cats = [e for e in evs if e.name == "aten::cat" and e.sequence_nr >= 0
            and any(_inside(p, e) for p in packs)]
    assert cats
    fwd = {(e.thread, e.sequence_nr) for e in cats}
    nodes = [e for e in evs if e.name == NODE + "CatBackward0"]
    assert any((n.fwd_thread, n.sequence_nr) in fwd for n in nodes)
