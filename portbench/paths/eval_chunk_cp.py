"""The eval chunk of a TensorCP field: ``eval_chunk``'s path, its traffic
and its check, on the CP field of ``harness/scene_cp.py``, counted by
``harness/flops_cp.py``."""
from __future__ import annotations

from portbench.harness import flops_cp, knobs, scene_cp
from portbench.paths import eval_chunk


class Path(eval_chunk.Path):
    def _build(self, ref: bool):
        field, lc, ev = eval_chunk._mods(ref)
        fcfg = field.FieldConfig(**self.fk)
        params, scn, n = scene_cp.derive_field(
            lc, fcfg, self.fk, self.c, self.recipe, self.seed, self.dev)
        fn, _ = ev.make_eval_chunk_fn(fcfg, **knobs.eval_kwargs(self.c, n))
        return params, scn, n, fn

    def window_flops(self, skip=range(0)) -> float:
        return sum(flops_cp.eval_chunk(
            self.fk, rows, hits, march_cap=self.t["march_cap"],
            app_cap=self.t["app_cap"],
            light_dirs=self.c["envmap_h"] * self.c["envmap_w"],
            second_n_sample=self.c["second_nSample"],
            second_app_cap=self.t["second_app_cap"])
            for i, (rows, hits) in enumerate(self.hits) if i not in skip)
