"""The relight chunk (``render/relight_pipeline.py:make_relight_chunk_fn``)
as ``relight_importance`` runs it: the rays of one test view in chunks,
each chunk relit under every held-out environment map, its outputs brought
back to the host in one transfer per light (every output of the first
light, the two relit images of the others). Chunk by chunk, so that a ray
is done once every light has relit it.

The chunk marches only the (point, light sample) pairs above the surface's
horizon, so the maps and the normals set its work. So the five held-out
maps and the normal network are data of the traffic, drawn from its
``work_key``, not from the run's seed; the rest of the field and the light
draws stay the seed's, so that every seed checks another field. The light draws come from one generator on the
card, whose state before each call is kept; the check relights a sample
of the window's chunks with the plain reference from the same raw field,
maps and draws, and compares every output.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.harness import flops, knobs, scene
from portbench.harness.check import map_gap
from portbench.paths.eval_chunk import sample, test_view_rays

OUTPUTS = ("relight_without_bg", "relight_with_bg", "acc", "albedo",
           "roughness", "normal", "depth", "rgb")


def _mods(ref: bool):
    if ref:
        from portbench.reference.models import field, lifecycle
        from portbench.reference.render import chunks as rp
        from portbench.reference.render.chunks import EnvironmentLight
    else:
        from tensoir_tpu_torch.models import field, lifecycle
        from tensoir_tpu_torch.models.env_light import EnvironmentLight
        from tensoir_tpu_torch.render import relight_pipeline as rp
    return field, lifecycle, rp, EnvironmentLight


def kept_share(pairs: list):
    """Kept pairs over offered pairs of ``pairs`` [(kept, offered)]; None
    where no pair was offered (or the program's counts were not read)."""
    offered = sum(o for _, o in pairs)
    return sum(k for k, _ in pairs) / offered if offered else None


class Path:
    def __init__(self, *, config, traffic, seed, device):
        self.c = config["config"]
        self.recipe = config["scene"]
        self.t = traffic
        self.seed = seed
        self.dev = torch.device(device)
        self.fk = knobs.field_kwargs(self.c)
        self.chunk = self.t["chunk"]
        self.lights = [f"held_out_{i}" for i in range(self.t["lights"])]
        self.hits = []      # surface rays of each window chunk
        self.pairs = []     # (kept, offered) pairs of each window chunk
        self.vis_pack = None    # the program's VIS_PACK counts
        self.outputs, self.states = {}, {}
        self.checked, self.worst_output = [], None

    def _build(self, ref: bool):
        field, lc, rp, env_cls = _mods(ref)
        fcfg = field.FieldConfig(**self.fk)
        params, scn, n = scene.derive_field(lc, fcfg, self.fk, self.c,
                                            self.recipe, self.seed, self.dev)
        # the normal network as the raw field of the key draws it; the
        # mask, shrink and upsample above read and change no network
        key = self.t["work_key"]
        reso = lc.n_to_reso(self.recipe["init_voxels"], knobs.AABB)
        params["normal_mlp"] = scene.raw_field(self.fk, reso, key,
                                               self.dev)["normal_mlp"]
        if ref:
            env = env_cls(device=self.dev)
        else:
            env = env_cls(None, device=self.dev)
            self.vis_pack = rp.VIS_PACK
        h, w = self.t["env_hw"]
        for name, img in zip(self.lights, scene.env_maps(
                len(self.lights), h, w, key, self.dev)):
            env.add_light(name, img)
        fns = {name: rp.make_relight_chunk_fn(
            fcfg, env, name, n_samples=n,
            n_light_samples=self.t["light_samples"],
            second_n_sample=self.c["second_nSample"],
            vis_tile=self.c["secondary_tile"]) for name in self.lights}
        return params, scn, n, fns

    def _relight(self, fns, params, scn, rays, i: int, key):
        """Chunk ``i`` under every light: a host array per light, and the
        generator's state before each light's call."""
        s = i * self.chunk
        r = rays[s:s + self.chunk]
        rescale = torch.ones((3,), device=self.dev)
        flats, states = [], []
        for li, name in enumerate(self.lights):
            states.append(key.get_state())
            outs = fns[name](params, scn, r, key, rescale)
            cols = outs if li == 0 else outs[:2]
            flats.append(torch.cat([c.reshape(self.chunk, -1).float()
                                    for c in cols], 1).cpu().numpy())
        return flats, states

    def setup(self):
        self.params, self.scene, self.n_samples, self.fns = self._build(False)
        self.rays = test_view_rays(self.t, self.dev)
        if self.rays.shape[0] % self.chunk:
            raise ValueError("the view's rays must fill whole chunks")
        self.n_chunks = self.rays.shape[0] // self.chunk
        self.key = scene.generator(self.seed, scene.LIGHT_DRAWS, self.dev)
        for i in self.t["warm_chunks"]:
            self._relight(self.fns, self.params, self.scene, self.rays,
                          min(i, self.n_chunks - 1), self.key)
        self.next = 0

    def _chunk(self, i: int) -> None:
        """Relight chunk ``i`` under every light, keep its outputs and draws
        the first time, and the pairs it offered and marched."""
        before = dict(self.vis_pack or {})
        flats, states = self._relight(self.fns, self.params, self.scene,
                                      self.rays, i, self.key)
        if i not in self.outputs:
            self.outputs[i], self.states[i] = flats, states
        # light 0 brings every output back: its acc is column 6
        self.hits.append(int(np.sum(flats[0][:, 6] > 0.5)))
        if self.vis_pack is not None:
            self.pairs.append(tuple(self.vis_pack[k] - before[k]
                                    for k in ("kept", "offered")))

    def units(self, n: int) -> int:
        """``n`` chunks under every light; the camera rays relit."""
        stride = self.t.get("chunk_stride", 1)
        for _ in range(n):
            self._chunk(self.next * stride % self.n_chunks)
            self.next += 1
        return n * self.chunk

    def again(self) -> int:
        """The last chunk once more under every light (its kernels' least
        times are counted on the very chunk the trace timed); no new ray is
        relit."""
        self._chunk((self.next - 1) * self.t.get("chunk_stride", 1)
                    % self.n_chunks)
        return 0

    def done(self) -> int:
        """Chunks relit so far in the window."""
        return len(self.hits)

    def window_flops(self, skip=range(0)) -> float:
        """The model's operations of the window's chunks but those at
        ``skip``, under every light."""
        return len(self.lights) * sum(flops.relight_chunk(
            self.fk, self.chunk, hits, march_cap=self.t["march_cap"],
            app_cap=self.t["app_cap"],
            light_samples=self.t["light_samples"],
            vis_march_cap=self.t["vis_march_cap"])
            for i, hits in enumerate(self.hits) if i not in skip)

    def extra(self) -> dict:
        return {"n_samples": self.n_samples, "chunks_relit": self.next,
                "checked_chunks": self.checked,
                "worst_output": self.worst_output,
                "surface_share": sum(self.hits) / max(
                    1, len(self.hits) * self.chunk),
                "kept_share": kept_share(self.pairs)}

    def release(self):
        for k in ("params", "scene", "fns", "key"):
            setattr(self, k, None)

    def _split(self, flats: list) -> dict:
        """Every output of the first light, the relit images of each."""
        widths = (3, 3, 1, 3, 1, 3, 1, 3)
        maps = {}
        for li, flat in enumerate(flats):
            col = 0
            for name, w in zip(OUTPUTS, widths):
                if col >= flat.shape[1]:
                    break
                maps[f"{self.lights[li]}/{name}"] = flat[:, col:col + w]
                col += w
        return maps

    def compare(self, limits: dict) -> list:
        self.checked = sample(
            self.outputs, lambda i: bool(np.any(self.outputs[i][0][:, 6]
                                                > 0.5)),
            self.t["checked_chunks"], self.seed)
        params, scn, _, fns = self._build(True)
        rays = test_view_rays(self.t, self.dev)
        worst, at = 0.0, None
        for i in self.checked:
            ref = []
            for li, name in enumerate(self.lights):
                key = torch.Generator(device=self.dev)
                key.set_state(self.states[i][li])
                outs = fns[name](params, scn,
                                 rays[i * self.chunk:(i + 1) * self.chunk],
                                 key, torch.ones((3,), device=self.dev))
                cols = outs if li == 0 else outs[:2]
                ref.append(torch.cat([c.reshape(self.chunk, -1).float()
                                      for c in cols], 1).cpu().numpy())
            gap, k = map_gap(self._split(self.outputs[i]), self._split(ref))
            if at is None or gap > worst:
                worst, at = gap, k
        self.worst_output = at
        return [("output_gap", worst, limits["output_gap"])]
