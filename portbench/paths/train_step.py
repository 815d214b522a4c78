"""The relight phase's training step (``train/step.py:make_train_step``),
fed as ``train/loop.py`` feeds it: batches of rays drawn without
replacement from a pool of every ray of the training views, one light.

Set-up builds the step, its field and its Adam state once, and drives them
through the first ``checked_steps`` steps with the window's own call and
feed; the window carries the same objects on. The check runs the plain
reference through the same steps from the same raw field, batches and
random draws, and compares each step's loss, the first gradient (read from
Adam's first moment after one step) and the change of the parameters
after the last, leaf by leaf by their norms.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.harness import flops, knobs, scene
from portbench.harness.check import moving_leaves, norm_gap

B1 = 0.9   # Adam's first-moment rate: mu after one step is (1 - B1) g


def _mods(ref: bool):
    if ref:
        from portbench.reference.models import field, lifecycle
        from portbench.reference.train import optim, step
    else:
        from tensoir_tpu_torch.models import field, lifecycle
        from tensoir_tpu_torch.train import optim, step
    return field, lifecycle, optim, step


def _norms(flat: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            flat.items()}


class Path:
    def __init__(self, *, config, traffic, seed, device):
        self.c = config["config"]
        self.recipe = config["scene"]
        self.t = traffic
        self.seed = seed
        self.dev = torch.device(device)
        self.fk = knobs.field_kwargs(self.c)
        self.overflow = None
        self.batch = self.c["batch_size"]
        self.hits = []      # each window step's surface rays, on the device
        self.surface_share = self.relit_per_step = None

    def _build(self, ref: bool):
        field, lc, optim, step = _mods(ref)
        fcfg = field.FieldConfig(**self.fk)
        params, scn, n = scene.derive_field(lc, fcfg, self.fk, self.c,
                                            self.recipe, self.seed, self.dev)
        opt = optim.make_optimizer(None, *knobs.optimizer_args(self.c))
        fn = step.make_train_step(
            fcfg, opt, step.StepStatic(**knobs.step_kwargs(self.c, n)),
            step.LossWeights(**knobs.loss_kwargs(self.c)), device=self.dev)
        return params, scn, n, opt.init(params), optim.flatten, fn

    def _checked_steps(self, params, scn, state, fn, flatten, key):
        """Run the first steps on the saved batches: (losses, first
        gradient norms, change norms)."""
        p0 = {k: v.detach().clone() for k, v in flatten(params).items()}
        losses, grads = [], None
        for i, b in enumerate(self.batches):
            b = {k: v.to(self.dev) for k, v in b.items()}
            params, state, m = fn(params, state, scn, b, key,
                                  self.t["start_iter"] + i)
            losses.append(float(m["total_loss"]))
            if i == 0:
                grads = _norms({k: v / (1.0 - B1) for k, v in
                                state["mu"].items()})
        change = _norms({k: v - p0[k] for k, v in flatten(params).items()})
        return params, state, losses, grads, change

    def setup(self):
        t = self.t
        (self.params, self.scene, self.n_samples, self.state, flatten,
         self.fn) = self._build(ref=False)
        dirs = scene.camera_dirs(t["views"], t["elev_min"], self.dev)
        self.rays = scene.view_rays(dirs, t["image"], t["camera_radius"],
                                    t["camera_angle_x"])
        self.rgbs = scene.ray_colours(self.rays)
        self.perm = torch.randperm(self.rays.shape[0], device=self.dev,
                                   generator=scene.generator(
                                       self.seed, scene.POOL_ORDER, self.dev))
        self.light = torch.full((self.batch,), t["light_idx"],
                                dtype=torch.int32, device=self.dev)
        self.pos = 0
        self.key = scene.generator(self.seed, scene.STEP_DRAWS, self.dev)
        self.key_state = self.key.get_state()
        self.batches = [{k: v.cpu() for k, v in self._next_batch().items()}
                        for _ in range(t["checked_steps"])]
        (self.params, self.state, self.losses, self.grads,
         self.change) = self._checked_steps(self.params, self.scene,
                                            self.state, self.fn, flatten,
                                            self.key)
        self.it = t["start_iter"] + t["checked_steps"]

    def _next_batch(self) -> dict:
        if self.pos + self.batch > self.perm.numel():
            self.pos = 0
        ids = self.perm[self.pos:self.pos + self.batch]
        self.pos += self.batch
        return {"rays": self.rays[ids], "rgbs": self.rgbs[ids],
                "light_idx": self.light}

    def units(self, n: int) -> int:
        """``n`` steps; the camera rays they train."""
        for _ in range(n):
            self.params, self.state, self.metrics = self.fn(
                self.params, self.state, self.scene, self._next_batch(),
                self.key, self.it)
            self.hits.append(self.metrics["n_acc_masked"])
            self.it += 1
        return n * self.batch

    def again(self) -> int:
        """One more step (each step has the same shapes)."""
        return self.units(1)

    def done(self) -> int:
        """Steps run so far in the window."""
        return len(self.hits)

    def window_flops(self, skip=range(0)) -> float:
        """The model's operations of the window's steps but those at
        ``skip``: each step's relit rays are its surface rays up to the
        cap."""
        cap = self.c["relight_ray_cap"]
        cap = min(cap, self.batch) if cap > 0 else self.batch
        hits = [round(h) for h in torch.stack(self.hits).cpu().tolist()]
        relit = [min(h, cap) for h in hits]
        self.surface_share = float(np.mean(hits)) / self.batch
        self.relit_per_step = float(np.mean(relit))
        return sum(flops.relight_step(self.fk, self.c, self.batch, r)
                   for i, r in enumerate(relit) if i not in skip)

    def extra(self) -> dict:
        return {"n_samples": self.n_samples, "losses": self.losses,
                "surface_share": self.surface_share,
                "relit_per_step": self.relit_per_step,
                "march_overflow_frac": self.overflow}

    def release(self):
        m = getattr(self, "metrics", None) or {}
        self.overflow = float(m.get("march_overflow_frac", 0.0))
        for k in ("params", "scene", "state", "fn", "rays", "rgbs", "perm",
                  "metrics", "key"):
            setattr(self, k, None)

    def compare(self, limits: dict) -> list:
        params, scn, n, state, flatten, fn = self._build(ref=True)
        if n != self.n_samples:
            raise RuntimeError(f"the reference marches {n} samples, the "
                               f"program {self.n_samples}")
        key = torch.Generator(device=self.dev)
        key.set_state(self.key_state)
        _, _, losses, grads, change = self._checked_steps(
            params, scn, state, fn, flatten, key)
        self.ref_losses = losses
        loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                       for a, b in zip(self.losses, losses))
        if not all(np.isfinite(self.losses)):
            loss_gap = float("inf")
        grad_gap, _ = norm_gap(self.grads, grads)
        change_gap, _ = norm_gap(self.change, change, moving_leaves(grads))
        return [("loss_gap", loss_gap, limits["loss_gap"]),
                ("grad_gap", grad_gap, limits["grad_gap"]),
                ("change_gap", change_gap, limits["change_gap"])]
