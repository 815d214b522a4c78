"""Profiling and observability (port of tensoir_tpu.profiling): a rays/s
meter, the metrics sink (``metrics.jsonl`` plus TensorBoard event files),
and the named spans the port opens on ``torch.profiler``'s timeline."""
from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch.profiler import record_function

from tensoir_tpu_torch.utils.tb_writer import EventWriter


@dataclass
class RayThroughputMeter:
    """Primary + visibility rays per second over a window of steps. The
    caller reads ``report`` only after something synchronised with the
    device (the loop reads it after its metrics reach the host)."""
    primary_per_step: int
    visibility_per_step: int
    _t0: Optional[float] = None
    _steps: int = 0

    def start(self):
        self._t0 = time.perf_counter()
        self._steps = 0

    def step(self, n: int = 1):
        self._steps += n

    @property
    def rays_per_step(self) -> int:
        return self.primary_per_step + self.visibility_per_step

    def report(self) -> Dict[str, float]:
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        total = self.rays_per_step * self._steps
        return {
            "steps": self._steps,
            "elapsed_s": dt,
            "steps_per_s": self._steps / dt if dt > 0 else 0.0,
            "rays_per_s": total / dt if dt > 0 else 0.0,
            "primary_rays_per_s": self.primary_per_step * self._steps / dt
            if dt > 0 else 0.0,
        }


# every name the port opens with ``span``: the step's phases
# (train/step.py), the render's layers (render/*.py), and the leaves where
# the field, its corner re-pack, its line matrices, its line taps and the
# MLP inputs are built
SPANS = ("forward", "backward", "all_reduce", "adam", "primary",
         "derived_normals", "brdf_render", "bake", "secondary_march",
         "app_stage_global", "visibility", "field", "plane_pack",
         "mlp_inputs", "line_matrix", "line_taps")
_OFF = contextlib.nullcontext()


def span(name: str):
    """Named range on the profiler's timeline while a profiler records;
    otherwise one shared no-op context, since a bare ``record_function``
    costs a dispatcher round trip per call even with no profiler."""
    if torch._C._autograd._profiler_enabled():
        return record_function(name)
    return _OFF


class MetricsLogger:
    """JSONL metrics sink + TensorBoard event files (``utils.tb_writer``)."""

    def __init__(self, log_dir: Optional[str] = None):
        self._file = None
        self._tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._file = open(f"{log_dir}/metrics.jsonl", "a")
            self._tb = EventWriter(log_dir)

    def log(self, step: int, metrics: Dict[str, float], prefix: str = "train"):
        rec = {"step": step, **{f"{prefix}/{k}": float(v)
                                for k, v in metrics.items()}}
        if self._file:
            self._file.write(json.dumps(rec) + "\n")
            self._file.flush()
        if self._tb:
            self._tb.add_scalars({k: float(v) for k, v in metrics.items()},
                                 step, prefix=f"{prefix}/")

    def log_image(self, step: int, tag: str, img) -> None:
        """An image panel (an eval render)."""
        if self._tb:
            self._tb.add_image(tag, img, step)
            self._tb.flush()

    def close(self):
        if self._file:
            self._file.close()
        if self._tb:
            self._tb.close()
