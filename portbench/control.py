#!/usr/bin/env python3
"""The readings that the limits of ``limits/<cell>.json`` are set from,
besides the program's own runs: the control and the faults, each put in
the program's place at the cell's own size, on the card.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --variant tf32|half_batch|unchanged|altered [--seconds 5]

- ``tf32``: the plain reference in the program's place, with TF32 on
  (the nearest precision below the configuration's float32 with TF32 off);
- ``half_batch`` (training): the program's step fed the first half of
  each batch, its mean over those rows;
- ``unchanged`` (training): a step that returns the parameters and the
  optimizer's state as it got them;
- ``altered`` (eval, relighting): one ray's first output changed where the
  chunk produces it.

Each seed's compared numbers are printed as one JSON line, each beside
the cell's limit from ``limits/<cell>.json``, with ``correct`` as the
harness's verdict gives it: the control and every fault have to come out
false. The benchmark's own runs never run this;
``tests/test_bench_control.py`` runs it on a card at the cells' own sizes
and limits, and ``tests/test_bench_faults.py`` runs the faults on the CPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench.harness.check import verdict  # noqa: E402
from portbench.paths import eval_chunk, eval_chunk_cp  # noqa: E402
from portbench.paths import radiance_step, relight_chunk, train_step  # noqa: E402


def _tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def variant_class(base, variant: str):
    """A subclass of the path ``base`` whose program side is the variant;
    its check is the path's own, against the float32 reference."""

    class Variant(base):
        def _build(self, ref: bool):
            if ref:
                return super()._build(True)
            if variant == "tf32":
                out = super()._build(True)
                _tf32(True)     # the reference's build turned it off
                return out
            out = list(super()._build(False))
            fn = out[-1]    # the step, the chunk or the chunks by light
            if variant == "half_batch":
                def broken(params, state, scn, batch, key, it):
                    half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
                    return fn(params, state, scn, half, key, it)
            elif variant == "unchanged":
                def broken(params, state, scn, batch, key, it):
                    import copy
                    _, _, m = fn(copy.deepcopy(params), copy.deepcopy(state),
                                 scn, batch, key, it)
                    return params, state, m
            elif variant == "altered" and issubclass(base, eval_chunk.Path):
                def broken(*a, **kw):
                    out = dict(fn(*a, **kw))
                    rgb = out["rgb_map"].clone()
                    rgb[0] = 1.0 - rgb[0]
                    out["rgb_map"] = rgb
                    return out
            elif variant == "altered" and issubclass(base,
                                                     relight_chunk.Path):
                def wrap(one):
                    def broken_one(*a, **kw):
                        outs = list(one(*a, **kw))
                        img = outs[0].clone()
                        img[0] = 1.0 - img[0]
                        outs[0] = img
                        return tuple(outs)
                    return broken_one
                broken = {k: wrap(f) for k, f in fn.items()}
            else:
                raise ValueError(f"no variant {variant!r} for {base}")
            out[-1] = broken
            return tuple(out)

    return Variant


PATHS = {"train_step": train_step.Path, "eval_chunk": eval_chunk.Path,
         "relight_chunk": relight_chunk.Path,
         "eval_chunk_cp": eval_chunk_cp.Path,
         "radiance_step": radiance_step.Path}


def read(config, traffic, *, variant: str, seed: int, seconds: float,
         device, limits: dict) -> dict:
    """One seed's numbers with ``variant`` in the program's place."""
    cls = variant_class(PATHS[traffic["path"]], variant)
    path = cls(config=config, traffic=traffic, seed=seed, device=device)
    path.setup()
    if not issubclass(cls, train_step.Path):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            path.units(1)
    path.release()
    _tf32(False)
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()
    numbers = path.compare(limits)
    return {"variant": variant, "seed": seed, "correct": verdict(numbers),
            "checked": {n: {"value": v, "limit": lim}
                        for n, v, lim in numbers},
            "extra": path.extra()}


def main(argv) -> int:
    from portbench.harness.check import load_limits
    from portbench.harness.main import cell_files, load_manifest
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variant", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: CUDA is not available", file=sys.stderr)
        return 2
    cell, config, traffic = cell_files(load_manifest(), args.workload)
    for s in args.seeds.split(","):
        out = read(config, traffic, variant=args.variant, seed=int(s),
                   seconds=args.seconds, device=torch.device("cuda", 0),
                   limits=load_limits(cell["name"]))
        print(json.dumps({"cell": cell["name"], **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
