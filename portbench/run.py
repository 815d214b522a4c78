#!/usr/bin/env python3
"""Run one cell of the benchmark of tensoir_tpu_torch once, on one H100:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` the per-layer metrics and ``breakdown``, and last
``checked``: each number compared with the plain reference beside its
limit). Without CUDA, or with fewer cards than the cell asks for, it
prints no result and exits with 2.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache inside the checkout, at fixed paths (the
# port's nvcc libraries go to tensoir_tpu_torch/_build/ by themselves)
CACHE = ROOT / "_portbench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))
if sys.path[1:2] == [str(Path(__file__).resolve().parent)]:
    del sys.path[1]

from portbench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
