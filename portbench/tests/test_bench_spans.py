"""The reduction of a trace by the program's spans (``harness/spans.py``):
device time per span with the backward charged through autograd's
sequence numbers, the idle time inside the march's span, and the numbers
made of them; on synthetic events and on a real CPU trace."""
from __future__ import annotations

from types import SimpleNamespace as NS

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.harness import spans
from portbench.harness.trace import reduce_events
from tensoir_tpu_torch.profiling import span

NODE = spans.NODE


def _cpu(name, t0, t1, *, thread=1, seq=-1, fwd=0, annot=False,
         kernels=()):
    """A host event; ``kernels`` lists the (name, us) it launched."""
    return NS(name=name, time_range=NS(start=t0, end=t1), thread=thread,
              sequence_nr=seq, fwd_thread=fwd, device_type="DeviceType.CPU",
              is_user_annotation=annot,
              kernels=[NS(name=k, duration=us) for k, us in kernels])


def _dev(name, t0, t1, annot=False):
    return NS(name=name, time_range=NS(start=t0, end=t1), thread=7,
              sequence_nr=-1, fwd_thread=0, device_type="DeviceType.CUDA",
              is_user_annotation=annot, kernels=[])


def _events(leaf_spans: bool = True):
    """Thread 1 runs the forward, thread 2 is autograd's. ``field`` holds
    ``plane_pack``; an inner gradient runs on thread 2 while thread 1 sits
    in ``field``; the backward's nodes point at forward operations by
    sequence number, one of them built on thread 2."""
    leaves = [
        _cpu("field", 10, 60, annot=True),
        _cpu("plane_pack", 20, 30, annot=True),
    ] if leaf_spans else []
    return [
        _cpu("portbench_span", 0, 200, annot=True),
        _cpu("primary", 0, 100, annot=True),
        *leaves,
        _cpu("aten::cat", 22, 28, seq=7, kernels=[("cat_kernel", 10)]),
        _cpu("aten::mul", 40, 45, seq=8, kernels=[("mul_kernel", 5)]),
        # the inner gradient: the node of the mul above, on thread 2,
        # building a node of its own (sequence 3 of thread 2)
        _cpu(NODE + "MulBackward0", 50, 58, thread=2, seq=8, fwd=1),
        _cpu("MulBackward0", 51, 57, thread=2, seq=8, fwd=1),
        _cpu("aten::mul", 52, 55, thread=2, seq=3,
             kernels=[("inner_grad_kernel", 2)]),
        _cpu("aten::add", 70, 72, seq=9, kernels=[("add_kernel", 10)]),
        _cpu("secondary_march", 110, 150, annot=True),
        _cpu("aten::copy_", 112, 113, kernels=[("Memcpy DtoD", 10)]),
        # the step's backward on thread 2
        _cpu(NODE + "CatBackward0", 160, 180, thread=2, seq=7, fwd=1),
        _cpu("CatBackward0", 161, 179, thread=2, seq=7, fwd=1),
        _cpu("aten::narrow", 165, 170, thread=2,
             kernels=[("narrow_kernel", 10)]),
        _cpu(NODE + "MulBackward0", 182, 190, thread=2, seq=8, fwd=1),
        _cpu("aten::mul", 183, 184, thread=2,
             kernels=[("mul_bwd_kernel", 5)]),
        _cpu(NODE + "MulBackward1", 192, 198, thread=2, seq=3, fwd=2),
        _cpu("aten::mul", 193, 194, thread=2,
             kernels=[("mul_bwd2_kernel", 2)]),
        _dev("cat_kernel", 30, 40),
        _dev("mul_kernel", 45, 50),
        _dev("inner_grad_kernel", 55, 57),
        _dev("add_kernel", 72, 82),
        _dev("Memcpy DtoD", 115, 125),
        _dev("narrow_kernel", 170, 180),
        _dev("mul_bwd_kernel", 185, 190),
        _dev("mul_bwd2_kernel", 194, 196),
        _dev("orphan_kernel", 196, 197),        # listed by no host event
        # the spans' device-side annotations: not device work
        _dev("field", 30, 57, annot=True),
        _dev("plane_pack", 30, 40, annot=True),
        _dev("primary", 30, 82, annot=True),
    ]


def test_reduce_spans_charges_the_backward_to_the_span_that_built_it():
    r = spans.reduce_spans(_events())
    # forward: cat 10 (primary, field, plane_pack), mul 5 (primary, field),
    # add 10 (primary). backward: the inner gradient's 2 and the step's
    # mul 5 to the mul (field); narrow 10 to the cat (plane_pack); the
    # second-order node's 2 to the spans thread 1 had open at its forward
    # (primary, field)
    assert r["span_ms"] == {
        "primary": {"forward": pytest.approx(0.025),
                    "backward": pytest.approx(0.019)},
        "secondary_march": {"forward": pytest.approx(0.010),
                            "backward": 0.0},
        "field": {"forward": pytest.approx(0.015),
                  "backward": pytest.approx(0.019)},
        "plane_pack": {"forward": pytest.approx(0.010),
                       "backward": pytest.approx(0.010)}}
    assert r["backward_ms"] == {"total": pytest.approx(0.019),
                                "charged": pytest.approx(0.019)}
    assert r["unlinked_ms"] == pytest.approx(0.001)
    # the march's span: 40 us of host time, the copy 10 of them
    assert r["span_idle"] == {"secondary_march": {
        "wall_ms": pytest.approx(0.040), "idle_ms": pytest.approx(0.030)}}


def test_the_spans_are_not_device_work():
    """``trace.reduce_events``'s keys read the same with and without the
    leaf spans and their device-side annotations."""
    with_leaves = _events()
    without = [e for e in _events(leaf_spans=False)
               if e.name not in ("field", "plane_pack")]
    avg = [NS(key="primary", device_type="DeviceType.CPU",
              device_time_total=25.0)]
    a, b = reduce_events(with_leaves, avg), reduce_events(without, avg)
    assert a == b
    assert a["launches"] == 8 and a["busy_s"] == pytest.approx(55e-6)


def test_a_program_without_the_leaf_spans_leaves_their_numbers_out():
    r = spans.reduce_spans(_events(leaf_spans=False))
    assert set(r["span_ms"]) == {"primary", "secondary_march"}
    r.update(units=1, rays=4096)
    m = spans.metrics(r, per_krays=False)
    assert set(m) == {"backward_ms.train", "primary_ms.train",
                      "march_idle_pct.train"}


def test_metrics_per_step_and_per_kray():
    r = spans.reduce_spans(_events())
    r.update(units=2, rays=8192)
    train = spans.metrics(r, per_krays=False)
    assert train == {
        "backward_ms.train": pytest.approx(0.019 / 2),
        "primary_ms.train": pytest.approx(0.044 / 2),
        "field_ms.train": pytest.approx(0.034 / 2),
        "plane_pack_ms.train": pytest.approx(0.020 / 2),
        "march_idle_pct.train": pytest.approx(75.0)}
    render = spans.metrics(r, per_krays=True)
    assert render["field_ms.render"] == pytest.approx(0.034 / 8.192)
    assert "backward_ms.render" not in render
    # relighting's march is its visibility span
    r["span_idle"]["visibility"] = {"wall_ms": 4.0, "idle_ms": 1.0}
    assert spans.metrics(r, per_krays=True)["march_idle_pct.render"] == \
        pytest.approx(25.0)


def test_a_real_trace_maps_the_re_pack_backward_to_plane_pack():
    """On the profiler's own CPU events, with one synthetic 1 us kernel
    per host operation: the ``cat`` of ``plane_pack`` and its backward's
    operations are charged to ``plane_pack``, and every backward kernel
    to a span."""
    x = torch.randn(8, 4, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("primary"):
            with span("field"):
                with span("plane_pack"):
                    p = torch.cat([x[:-1], x[1:]], -1).reshape(-1)
                y = (p.sin() * 2.0).sum()
            (g,) = torch.autograd.grad(y, [x])
    events = list(prof.events())
    for k, e in enumerate([e for e in events if e.name.startswith("aten::")]):
        e.append_kernel(f"k{k}", 0, 1.0)
        events.append(_dev(f"k{k}", 1e6 + k, 1e6 + k + 1))
    r = spans.reduce_spans(events)
    assert r["backward_ms"]["total"] > 0
    assert r["backward_ms"]["charged"] == r["backward_ms"]["total"]
    assert r["span_ms"]["plane_pack"]["backward"] > 0
    assert r["span_ms"]["plane_pack"]["forward"] > 0
    assert (r["span_ms"]["field"]["backward"]
            > r["span_ms"]["plane_pack"]["backward"])
    assert r["unlinked_ms"] == 0
