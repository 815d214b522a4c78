"""The yardstick at small shapes: the FLOP counter, the kernels' least
times, and the reduction of a trace (union of intervals, gaps, launches,
ranges)."""
from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace as NS

import pytest
import torch

from portbench.harness import bounds, flops, knobs, readers
from portbench.harness.trace import reduce_events

PKG = Path(__file__).resolve().parent.parent
FK = dict(density_n_comp=(1, 1, 1), app_n_comp=(1, 1, 1), app_dim=2,
          feature_c=4, view_pe=0, fea_pe=0, pos_pe=0, num_sgs=2)


def test_widths_by_hand():
    w = flops.widths(FK)
    assert w["density"] == 14 * 3
    assert w["app"] == 14 * 3 + 2 * 3 * 2
    # MLP_Fea without encodings: app_dim + 3 view dims
    assert w["render_mlp"] == 2 * ((2 + 3) * 4 + 4 * 4 + 4 * 3)
    assert w["sg_light"] == 26


def test_primary_and_secondary_by_hand():
    w = flops.widths(FK)
    per_app = (w["app"] + w["render_mlp"] + w["brdf_mlp"] + w["normal_mlp"]
               + 2 * w["density"])
    assert flops.primary(w, 3, 5, 2) == 3 * (5 * w["density"] + 2 * per_app)
    assert flops.secondary(w, marched=4, samples=6, exact=False,
                           app_points=0, app_baked=False) == 4 * 6 * 16
    assert flops.secondary(w, marched=1, samples=1, exact=True,
                           app_points=2, app_baked=True) == (
        w["density"] + 2 * (w["app_baked"] + w["render_mlp"]))


def test_step_counts_forward_three_times_and_the_secondary_once():
    c = json.loads((PKG / "configs" / "armadillo.json").read_text())["config"]
    fk = knobs.field_kwargs(c)
    w = flops.widths(fk)
    relit = 700
    step = flops.relight_step(fk, c, 4096, relit)
    pairs = relit * 512
    grad = (flops.primary(w, 4096, c["march_cap_primary"],
                          c["app_cap_per_ray"])
            + pairs * (w["sg_light"] + flops.BRDF_PER_PAIR))
    sec = flops.secondary(w, marched=pairs, samples=c["second_nSample"],
                          exact=False, app_points=pairs * c["second_app_cap"],
                          app_baked=False)
    assert step == 3 * grad + sec
    # the same work whatever implements it: a function of the config and
    # of the rays relit only
    assert step == flops.relight_step(fk, dict(c), 4096, relit)
    assert flops.relight_step(fk, c, 4096, 0) == 3 * flops.primary(
        w, 4096, c["march_cap_primary"], c["app_cap_per_ray"])


def test_render_counts_grow_with_the_surface_rays_only():
    c = json.loads((PKG / "configs" / "armadillo.json").read_text())["config"]
    fk = knobs.field_kwargs(c)
    w = flops.widths(fk)
    kw = dict(march_cap=256, app_cap=64, light_dirs=512, second_n_sample=96,
              second_app_cap=16)
    bare = flops.primary(w, 4096, 256, 64)
    assert flops.eval_chunk(fk, 4096, 0, **kw) == bare
    one = flops.eval_chunk(fk, 4096, 1, **kw) - bare
    assert flops.eval_chunk(fk, 4096, 900, **kw) == pytest.approx(
        bare + 900 * one)
    rk = dict(march_cap=256, app_cap=64, light_samples=512, vis_march_cap=48)
    assert flops.relight_chunk(fk, 800, 0, **rk) == flops.primary(
        w, 800, 256, 64)
    assert flops.relight_chunk(fk, 800, 10, **rk) == flops.primary(
        w, 800, 256, 64) + 10 * 512 * (flops.BRDF_PER_PAIR
                                       + 48 * w["density"])


def test_gather_and_scatter_bounds():
    idx = torch.tensor([0, 1, 1, 3], dtype=torch.int32)
    ms = bounds.gather_bound_ms(idx, 16)
    assert ms == pytest.approx(((4 + 16) * 4 + 16 * 3)
                               / bounds.HBM_BYTES_PER_S * 1e3)
    assert bounds.scatter_bound_ms(idx.long(), 8) == pytest.approx(
        ((8 + 8) * 4 + 8 * 3) / bounds.HBM_BYTES_PER_S * 1e3)


def _ev(name, t0, t1, device=False, annot=False):
    return NS(name=name, time_range=NS(start=t0, end=t1),
              device_type="DeviceType.CUDA" if device else "DeviceType.CPU",
              is_user_annotation=annot)


def test_reduce_events_unions_overlaps_and_names_gaps():
    events = [
        _ev("portbench_span", 0, 100, annot=True),
        _ev("aten::mm", 0, 10), _ev("aten::nonzero", 40, 70),
        _ev("secondary_march", 0, 60, annot=True),
        _ev("row_gather_kernel", 10, 30, device=True),
        _ev("gemm", 20, 40, device=True),          # overlaps the gather
        _ev("row_scatter_add_kernel", 80, 90, device=True),
        _ev("Memset (Device)", 90, 95, device=True),
        _ev("secondary_march", 10, 60, device=True, annot=True),
    ]
    avg = [NS(key="secondary_march", device_type="DeviceType.CPU",
              device_time_total=12000.0)]
    r = reduce_events(events, avg)
    assert r["busy_s"] == pytest.approx((40 - 10 + 95 - 80) / 1e6)
    assert r["wall_s"] == pytest.approx(100 / 1e6)
    assert r["launches"] == 3
    assert r["k1_ms"] == pytest.approx(0.02) and r["k2_ms"] == \
        pytest.approx(0.01)
    assert r["range_ms"] == {"secondary_march": 12.0}
    assert r["idle_gaps"][0] == ["aten::nonzero", pytest.approx(40e-6)]
    assert [g[1] for g in r["idle_gaps"]] == sorted(
        (g[1] for g in r["idle_gaps"]), reverse=True)


def test_readers_leave_out_what_they_cannot_read():
    ctx = {"span": {"units": 2, "rays": 8192, "launches": 100,
                    "busy_s": 0.5, "wall_s": 1.0, "k1_ms": 0.0,
                    "k2_ms": 2.0, "range_ms": {}},
           "bounds": {"k1_ms": 0.0, "k2_ms": 0.5, "k1_launches": 0,
                      "k2_launches": 3},
           "window": {"units": 10, "rays": 40960, "seconds": 2.5,
                      "traced_s": 0.5},
           "flops": 670e9}
    assert readers.roofline_pct(ctx, "k1") is None
    assert readers.roofline_pct(ctx, "k2") == pytest.approx(50.0)
    assert readers.range_ms(ctx, ("secondary_march",), False) is None
    assert readers.idle_pct(ctx) == pytest.approx(50.0)
    assert readers.launches(ctx, per_krays=False) == 50
    assert readers.window_rate(ctx) == 16384
    assert readers.mfu_pct(ctx) == pytest.approx(0.5)
    assert readers.busy_ms(ctx, per_krays=False) == pytest.approx(250.0)
    assert readers.busy_ms(ctx, per_krays=True) == pytest.approx(500 / 8.192)
