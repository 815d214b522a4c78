"""BENCHMARK.json against the benchmark's contract: names, units and
lengths, the files each entry names, a reader for every metric."""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parent.parent
ROOT = PKG.parent
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
METRICS = M["end_to_end"] + M["per_layer"]


def test_top_level_keys_and_size():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert 1 <= len(M["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in M["paths"])
    assert 1 <= len(M["command"]) <= 32
    assert all(TEXT.match(w) for w in M["command"])


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in M[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entries(metric):
    keys = {"name", "unit", "better", "source", "workloads"}
    if metric in M["end_to_end"]:
        keys |= {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        keys |= {"layer", "moves"}
        assert TEXT.match(metric["layer"])
        assert metric["moves"] in {m["name"] for m in M["end_to_end"]}
    assert set(metric) <= keys
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    assert (PKG / "metrics" / f"{metric['name']}.py").is_file()
    cells = {w["name"] for w in M["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells


def test_rooflines_and_mfu_are_named_for_what_they_are():
    for m in M["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
            assert re.match(r"^(k[12]_roofline|mfu)\.", m["name"])


@pytest.mark.parametrize("conf", M["configs"], ids=lambda c: c["name"])
def test_configs(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert TEXT.match(conf["source"]) and TEXT.match(conf["why"])
    path = ROOT / conf["file"]
    assert path.is_file() and conf["file"].startswith("portbench/")
    body = json.loads(path.read_text())
    assert body["name"] == conf["name"]
    assert len(conf["reduced"]) <= 16
    assert all(NAME.match(k) for k in conf["reduced"])
    # each configuration against its own sources: TensoIR's armadillo
    # file, and the keys and values that an ``assumed`` entry ending in
    # ``_source_keys`` takes from a second source (armadillo_cp's TensorCP
    # block), which the configuration has to hold as given there
    base = json.loads((PKG / "configs" / "armadillo.json").read_text())
    second = {}
    for k, v in body.get("assumed", {}).items():
        if k.endswith("_source_keys"):
            second.update(v)
    assert {k: body["config"].get(k) for k in second} == second
    changed = sorted(k for k in body["config"]
                     if body["config"][k] != base["config"].get(k)
                     and k not in second)
    assert changed == sorted(conf["reduced"])
    widths = ("n_lamb_sigma", "n_lamb_sh", "data_dim_color", "featureC",
              "numLgtSGs")
    assert not set(conf["reduced"]) & set(widths)
    assert not [k for k in conf["reduced"]
                if k.endswith(("_dim", "_rank"))]
    assert any(w["config"] == conf["name"] for w in M["workloads"])


@pytest.mark.parametrize("cell", M["workloads"], ids=lambda w: w["name"])
def test_cells(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4)
    assert TEXT.match(cell["why"]) and NAME.match(cell["traffic"])
    assert (PKG / "traffic" / f"{cell['traffic']}.json").is_file()
    assert (PKG / "limits" / f"{cell['name']}.json").is_file()
    e2e = [m for m in M["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert any(cell["name"] in m["workloads"] for m in M["per_layer"])


def test_each_pair_once_and_few_four_chip_cells():
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)


def test_a_full_check_fits():
    runs = 2 + 14 * 24
    assert (runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200) <= 43200
