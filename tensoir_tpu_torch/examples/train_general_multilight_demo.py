"""General multi-light demo of the port: three distinct lights, each with
its own SG set (``per_light_sg``, from ``light_name_list``), on the
analytic shadow scene; the other multi-light parameterization beside the
rotated demo's shared SG set. The flags and the configuration are those of
the JAX package's ``examples/train_general_multilight_demo.py``: the
rotated demo's, with ``--lr_light`` for the light group and the batch and
fast-march knobs fixed at their defaults. Each light is evaluated on its
own; the metrics go to ``<out>/final_metrics.json``.

Usage:  python -m tensoir_tpu_torch.examples.train_general_multilight_demo [--iters 4000] [--out DIR]

It runs on the card; ``main(argv, device="cpu")`` runs it on the CPU.
"""
from __future__ import annotations

import sys

from tensoir_tpu_torch.device import DeviceLike
from tensoir_tpu_torch.examples import train_multilight_demo as _demo


def main(argv=None, device: DeviceLike = None) -> dict:
    """Returns the metrics written to ``final_metrics.json``."""
    return _demo.run(_demo.parse_args(argv, general=True), device)


if __name__ == "__main__":
    main(sys.argv[1:])
