"""The eval chunk (``render/eval.py:make_eval_chunk_fn``) as the final
``render_test`` runs it: the chunks of one test view in order, each
brought back to the host in one transfer as ``render_image`` does, the
view started again at its end.

The check renders a sample of the chunks the window rendered, drawn from
the seed, with the plain reference from the same raw field, and compares
every map.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.harness import flops, knobs, scene
from portbench.harness.check import map_gap


def _mods(ref: bool):
    if ref:
        from portbench.reference.models import field, lifecycle
        from portbench.reference.render import chunks as ev
    else:
        from tensoir_tpu_torch.models import field, lifecycle
        from tensoir_tpu_torch.render import eval as ev
    return field, lifecycle, ev


def sample(outputs: dict, hits, k: int, seed: int) -> list:
    """``k`` of the window's chunks, drawn from the seed among those in
    which some ray hit the object (among all, where none did)."""
    done = sorted(outputs)
    pool = [i for i in done if hits(i)] or done
    rng = np.random.default_rng(seed % 2 ** 63)
    return sorted(int(i) for i in rng.choice(pool, size=min(k, len(pool)),
                                             replace=False))


def test_view_rays(t: dict, device) -> torch.Tensor:
    """[wh * wh, 6] rays of the traffic's test camera."""
    el, az = t["test_view"]
    d = torch.tensor([[np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                       np.sin(el)]], dtype=torch.float32, device=device)
    return scene.view_rays(d, t["image"], t["camera_radius"],
                           t["camera_angle_x"])


class Path:
    def __init__(self, *, config, traffic, seed, device):
        self.c = config["config"]
        self.recipe = config["scene"]
        self.t = traffic
        self.seed = seed
        self.dev = torch.device(device)
        self.fk = knobs.field_kwargs(self.c)
        self.chunk = self.c["batch_size_test"]
        self.hits = []      # (rays, surface rays) of each window chunk
        self.outputs = {}
        self.checked, self.worst_map = [], None

    def _build(self, ref: bool):
        field, lc, ev = _mods(ref)
        fcfg = field.FieldConfig(**self.fk)
        params, scn, n = scene.derive_field(lc, fcfg, self.fk, self.c,
                                            self.recipe, self.seed, self.dev)
        fn, _ = ev.make_eval_chunk_fn(fcfg, **knobs.eval_kwargs(self.c, n))
        return params, scn, n, fn

    def _rays(self):
        rays = test_view_rays(self.t, self.dev)
        self.n_rays = rays.shape[0]
        pad = -self.n_rays % self.chunk
        if pad:     # the last chunk repeats its last ray (render_image)
            rays = torch.cat([rays, rays[-1:].expand(pad, 6)], 0)
        return rays

    def _render(self, fn, params, scn, rays, i: int):
        """Chunk ``i``: its maps as float columns of one host array, and
        their layout (name, width, dtype)."""
        s = i * self.chunk
        li = torch.zeros((self.chunk,), dtype=torch.int32, device=self.dev)
        out = fn(params, scn, rays[s:s + self.chunk], li)
        maps = {k: v for k, v in out.items()
                if isinstance(v, torch.Tensor) and v.dim() >= 1}
        layout = [(k, int(np.prod(v.shape[1:])), v.dtype == torch.bool)
                  for k, v in maps.items()]
        flat = torch.cat([maps[k].reshape(self.chunk, -1).float()
                          for k, _, _ in layout], 1).cpu().numpy()
        return flat, layout

    def setup(self):
        self.params, self.scene, self.n_samples, self.fn = self._build(False)
        self.rays = self._rays()
        self.n_chunks = self.rays.shape[0] // self.chunk
        for i in self.t["warm_chunks"]:
            self._render(self.fn, self.params, self.scene, self.rays,
                         min(i, self.n_chunks - 1))
        self.next = 0

    def _chunk(self, i: int) -> int:
        """Render chunk ``i``, keep its outputs the first time; its rays."""
        flat, self.layout = self._render(self.fn, self.params, self.scene,
                                         self.rays, i)
        self.outputs.setdefault(i, flat)
        rows = min(self.chunk, self.n_rays - i * self.chunk)
        self.hits.append((rows, int(np.sum(self.split(flat, rows)["acc_map"]
                                           > 0.5))))
        return rows

    def units(self, n: int) -> int:
        """``n`` chunks; the camera rays they rendered."""
        done = 0
        stride = self.t.get("chunk_stride", 1)
        for _ in range(n):
            done += self._chunk(self.next * stride % self.n_chunks)
            self.next += 1
        return done

    def again(self) -> int:
        """The last chunk once more (its kernels' least times are counted
        on the very chunk the trace timed); no new ray is rendered."""
        self._chunk((self.next - 1) * self.t.get("chunk_stride", 1)
                    % self.n_chunks)
        return 0

    def done(self) -> int:
        """Chunks rendered so far in the window."""
        return len(self.hits)

    def window_flops(self, skip=range(0)) -> float:
        """The model's operations of the window's chunks but those at
        ``skip``."""
        return sum(flops.eval_chunk(
            self.fk, rows, hits, march_cap=self.t["march_cap"],
            app_cap=self.t["app_cap"],
            light_dirs=self.c["envmap_h"] * self.c["envmap_w"],
            second_n_sample=self.c["second_nSample"],
            second_app_cap=self.t["second_app_cap"])
            for i, (rows, hits) in enumerate(self.hits) if i not in skip)

    def extra(self) -> dict:
        return {"n_samples": self.n_samples, "chunks_rendered": self.next,
                "checked_chunks": self.checked, "worst_map": self.worst_map,
                "surface_share": (sum(h for _, h in self.hits)
                                  / max(1, sum(r for r, _ in self.hits)))}

    def release(self):
        for k in ("params", "scene", "fn"):
            setattr(self, k, None)

    def split(self, flat: np.ndarray, rows: int) -> dict:
        maps, col = {}, 0
        for k, w, is_bool in self.layout:
            v = flat[:rows, col:col + w]
            maps[k] = v > 0.5 if is_bool else v
            col += w
        return maps

    def _hits(self, i: int) -> bool:
        rows = min(self.chunk, self.n_rays - i * self.chunk)
        return bool(np.any(self.split(self.outputs[i], rows)["acc_map"]
                           > 0.5))

    def compare(self, limits: dict) -> list:
        self.checked = sample(self.outputs, lambda i: self._hits(i),
                              self.t["checked_chunks"], self.seed)
        params, scn, n, fn = self._build(True)
        rays = self._rays()
        worst, at = 0.0, None
        for i in self.checked:
            rows = min(self.chunk, self.n_rays - i * self.chunk)
            ref, _ = self._render(fn, params, scn, rays, i)
            gap, k = map_gap(self.split(self.outputs[i], rows),
                             self.split(ref, rows))
            if at is None or gap > worst:
                worst, at = gap, k
        self.worst_map = at
        return [("map_gap", worst, limits["map_gap"])]
