#!/usr/bin/env python3
"""The scan that chose ``traffic/relight_view.json``'s ``work_key``: the
share of (point, light sample) pairs that the relight chunk marches, under
the maps and the normal network of each key, on a few field seeds.

    python3 portbench/scan_work_key.py [--keys 0-15] [--seeds 1,2,3,4] \
        [--chunks 8]

For each seed and key the cell's path is set up as a run sets it up, with
that key in the traffic, and relights the window's first ``--chunks``
chunks; the kept share is the program's ``VIS_PACK`` kept pairs over
offered pairs of those chunks. One JSON line per seed and key, then one
with each key's mean over the seeds, the median of the means, and the key
whose mean lies nearest to it, the lower on a tie. The benchmark's runs
never run this.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench.paths import relight_chunk  # noqa: E402

CELL = "armadillo.relight_view"


def choose(means: dict) -> int:
    """The key whose mean lies nearest the median of ``means`` {key: mean
    share}, the lower key on a tie."""
    mid = statistics.median(means.values())
    return min(means, key=lambda k: (abs(means[k] - mid), k))


def scan(config, traffic, *, keys, seeds, chunks: int, device) -> dict:
    """{key: [kept share on each seed]}, printing a line per seed and
    key."""
    shares = {k: [] for k in keys}
    for seed in seeds:
        for k in keys:
            path = relight_chunk.Path(config=config,
                                      traffic=dict(traffic, work_key=k),
                                      seed=seed, device=device)
            path.setup()
            path.units(chunks)
            share = relight_chunk.kept_share(path.pairs)
            shares[k].append(share)
            print(json.dumps({"seed": seed, "work_key": k,
                              "kept_share": share,
                              "surface_share": sum(path.hits)
                              / (chunks * path.chunk)}), flush=True)
            path.release()
    return shares


def main(argv) -> int:
    from portbench.harness.main import cell_files, load_manifest
    ap = argparse.ArgumentParser()
    ap.add_argument("--keys", default="0-15")
    ap.add_argument("--seeds", default="1,2,3,4")
    ap.add_argument("--chunks", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("scan_work_key: CUDA is not available", file=sys.stderr)
        return 2
    lo, hi = (int(x) for x in args.keys.split("-"))
    _, config, traffic = cell_files(load_manifest(), CELL)
    shares = scan(config, traffic, keys=range(lo, hi + 1),
                  seeds=[int(s) for s in args.seeds.split(",")],
                  chunks=args.chunks, device=torch.device("cuda", 0))
    means = {k: statistics.fmean(v) for k, v in shares.items()}
    print(json.dumps({"means": means,
                      "median": statistics.median(means.values()),
                      "chosen": choose(means)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
