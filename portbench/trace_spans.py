#!/usr/bin/env python3
"""Where one cell's traced steps or chunks spend the card's time, by the
program's spans, on one H100:

    python3 portbench/trace_spans.py --workload <cell> --seed <n>

from the root of a checkout. Sets the cell up as ``run.py`` does, runs the
traffic's ``trace_at`` units, then profiles ``trace_units`` more as a
``--trace 1`` run profiles its span. Prints one JSON line:
``trace.reduce_events``'s reduction; ``spans.reduce_spans``'s (each
span's device ms, forward and backward; the backward's ms and the part
charged to a span; the idle ms inside the march's spans); the per-layer
numbers ``spans.metrics`` makes of it; the device ms of the
concatenation kernel by span; the span entries per unit; and the host's
cost of one span entry with no profiler recording.
"""
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "_portbench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))
if sys.path[1:2] == [str(Path(__file__).resolve().parent)]:
    del sys.path[1]

import argparse  # noqa: E402
import copy  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
from collections import Counter  # noqa: E402


# the kernel of torch.cat and torch.stack, the top device op of the cells
CAT = "CatArrayBatchedCopy"


def entry_cost_us(n: int = 200_000) -> dict:
    """Host µs of one ``with span(name): pass`` with no profiler recording,
    less the bare loop's, best of three."""
    from tensoir_tpu_torch.profiling import span

    def loop(enter: bool) -> float:
        t0 = time.perf_counter()
        if enter:
            for _ in range(n):
                with span("field"):
                    pass
        else:
            for _ in range(n):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    best = min(loop(True) for _ in range(3))
    bare = min(loop(False) for _ in range(3))
    return {"span_entry_us": best - bare, "bare_loop_us": bare}


def only_kernels(events, part: str) -> list:
    """The events with each host operation's kernels cut to those whose
    name holds ``part``."""
    out = []
    for e in events:
        if getattr(e, "kernels", None):
            e = copy.copy(e)
            e.kernels = [k for k in e.kernels if part in k.name]
        out.append(e)
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="portbench/trace_spans.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench.harness import spans
    from portbench.harness.main import cell_files, load_manifest
    from portbench.harness.trace import SPAN, reduce_events
    from tensoir_tpu_torch.profiling import SPANS

    cell, config, traffic = cell_files(load_manifest(), args.workload)
    dev = torch.device("cuda", 0)
    mod = importlib.import_module(f"portbench.paths.{traffic['path']}")
    path = mod.Path(config=config, traffic=traffic, seed=args.seed,
                    device=dev)
    path.setup()
    path.units(traffic.get("trace_at", 2))
    n = traffic.get("trace_units", 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(SPAN):
            rays = path.units(n)
            torch.cuda.synchronize()
    events = prof.events()
    red = reduce_events(events, prof.key_averages())
    red.update(units=n, rays=rays)
    red.update(spans.reduce_spans(events))
    per_krays = traffic["path"] != "train_step"
    entries = Counter(e.name for e in events if e.name in SPANS
                      and not str(e.device_type).endswith("CUDA"))
    print(json.dumps({
        "cell": cell["name"], "seed": args.seed,
        "card": torch.cuda.get_device_name(0), **red,
        "metrics": spans.metrics(red, per_krays),
        "cat_span_ms": spans.reduce_spans(
            only_kernels(events, CAT))["span_ms"],
        "span_entries_per_unit": {k: v / n for k, v in entries.items()},
        **entry_cost_us()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
