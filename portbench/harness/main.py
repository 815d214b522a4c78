"""One run of one cell: set-up, the measured window, the traced span
(``--trace 1``), the check against the plain reference, the result line.

Everything that belongs to one cell is found by name from
``BENCHMARK.json``: the configuration file (``configs/<name>.json``), the
traffic mix (``traffic/<name>.json``, whose ``path`` names the module of
``paths/`` that drives the program), the limits of the check
(``limits/<cell>.json``) and one reader per metric (``metrics/<name>.py``).
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
ROOT = PKG.parent
# modules that must not be loaded in the process that prints the result,
# compared by whole top-level names (the port's name begins with the JAX
# package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "tensoir_tpu")


class Refused(RuntimeError):
    """The run cannot measure: no result line is printed."""


def forbidden_modules(modules=None) -> list:
    names = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in names}
    return sorted(t for t in tops if t in FORBIDDEN)


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_files(manifest: dict, workload: str) -> tuple:
    """(cell, configuration file, traffic file) of a workload."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads(
        (PKG / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, config, traffic


def metrics_of(manifest: dict, cell: dict, trace: bool) -> list:
    """The metric entries this cell reports in this kind of run."""
    name = cell["name"]
    e2e = [m for m in manifest["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read``."""
    path = PKG / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def smi(fields: str) -> str:
    """``nvidia-smi``'s reading of the first card (informational)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader",
             "--id=0"], capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


# the card's state beside the window: clock, temperature, power, and the
# reasons the driver gives for holding the clock down
CARD_STATE = ("clocks.sm,temperature.gpu,power.draw,"
              "clocks_throttle_reasons.active")


def run_cell(config: dict, traffic: dict, *, seed: int,
             seconds: float, trace: bool, device, t_start: float,
             limits: dict, metrics: list, sync=None) -> dict:
    """Set up, measure, check. Returns the result line's fields (without
    ``device``). ``sync`` drains the device (None on the CPU)."""
    import torch
    from portbench.harness.trace import RowBounds, profile_span
    drain = sync or (lambda: None)
    mod = importlib.import_module(f"portbench.paths.{traffic['path']}")
    path = mod.Path(config=config, traffic=traffic, seed=seed,
                    device=device)
    path.setup()
    drain()
    setup_s = time.perf_counter() - t_start
    on_card = str(device).startswith("cuda")
    card_before = smi(CARD_STATE) if on_card else None

    span = counted = None
    traced = range(0)
    span_at = traffic.get("trace_at", 2)
    units = rays = 0
    traced_s = 0.0
    t0 = time.perf_counter()
    while True:
        if trace and span is None and units == span_at:
            # the profiled span, then one unit whose kernel launches are
            # counted for the rooflines' least times: both apart from the
            # rest of the window, which the traced run's rates read
            drain()
            t_traced = time.perf_counter()
            traced_from = path.done()
            span = profile_span(path.units, traffic.get("trace_units", 1))
            units += span["units"]
            rays += span["rays"]
            with RowBounds() as counted:
                rays += path.again()
                units += 1
                drain()
            traced = range(traced_from, path.done())
            traced_s = time.perf_counter() - t_traced
        rays += path.units(1)
        units += 1
        if time.perf_counter() - t0 >= seconds:
            break
    drain()
    window_s = time.perf_counter() - t0
    card_after = smi(CARD_STATE) if on_card else None
    if trace and span is None:
        raise Refused("the window ended before the traced span")
    # the model's operations of the window but the traced units, read from
    # the outputs after the window has closed
    window_flops = path.window_flops(traced)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    path.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = path.compare(limits)
    from portbench.harness.check import verdict
    ctx = {"setup_s": setup_s,
           "window": {"units": units, "rays": rays, "seconds": window_s,
                      "traced_s": traced_s},
           "flops": window_flops, "span": span,
           "bounds": None if counted is None else {
               "k1_ms": counted.ms["row_gather"],
               "k2_ms": counted.ms["row_scatter_add"],
               "k1_launches": counted.launches["row_gather"],
               "k2_launches": counted.launches["row_scatter_add"]}}
    values = {}
    for m in metrics:
        v = reader(m["name"])(ctx)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": verdict(numbers), "attempted": units, "failed": 0,
           "metrics": values, "memory_peak_bytes": peak,
           "numbers": numbers,
           "extra": {"setup_s": setup_s, "window_s": window_s,
                     "card_before": card_before, "card_after": card_after,
                     "units": units, "rays": rays,
                     "check_s": time.perf_counter() - t_check,
                     **path.extra()}}
    if span is not None:
        out["busy_s"] = span["busy_s"]
        out["window_s"] = span["wall_s"]
        out["breakdown"] = {"device_ops": span["device_ops"],
                            "idle_gaps": span["idle_gaps"]}
    return out


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        manifest = load_manifest()
        cell, config, traffic = cell_files(manifest, args.workload)
        import torch
        if not torch.cuda.is_available():
            raise Refused("CUDA is not available: the benchmark measures "
                          "the card and does not run on the CPU")
        if torch.cuda.device_count() < cell["chips"]:
            raise Refused(f"{cell['name']} needs {cell['chips']} card(s); "
                          f"{torch.cuda.device_count()} present")
        from portbench.harness.check import load_limits
        res = run_cell(config, traffic, seed=args.seed,
                       seconds=args.seconds, trace=bool(args.trace),
                       device=torch.device("cuda", 0), t_start=t_start,
                       limits=load_limits(cell["name"]),
                       metrics=metrics_of(manifest, cell, bool(args.trace)),
                       sync=torch.cuda.synchronize)
        found = forbidden_modules()
        if found:
            raise Refused(f"modules loaded that the port must not use: "
                          f"{found}")
    except Refused as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": int(res["memory_peak_bytes"]),
              "power_limit": smi("power.limit")}
    if args.trace:
        device["busy_s"] = res["busy_s"]
        device["window_s"] = res["window_s"]
    print(json.dumps({"cell": cell["name"], "seed": args.seed,
                      **res["extra"]}), file=sys.stderr)
    checked = {n: {"value": v if math.isfinite(v) else None, "limit": lim}
               for n, v, lim in res["numbers"]}
    for n, v, lim in res["numbers"]:
        print(f"check {n} = {v!r} (limit {lim!r})", file=sys.stderr)
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checked"] = checked
    print(json.dumps(line), flush=True)
    return 0
