"""The radiance phase's training step (``train/step.py:make_train_step``),
iterations 0-10,000 of every training run: the raw VM field at
``init_voxels`` (128^3) on the scene box, no alpha mask yet, the dense
march of every sample and the radiance field's colour on the ``app_cap``
top samples a ray, the first L1 weight and both TV terms, as
``train/loop.py`` builds the step at iteration 0. No BRDF, normals or
secondary march.

Fed, set up and checked as ``train_step``: batches drawn without
replacement from every ray of the training views, three checked steps
against the plain reference from the same raw field, batches and random
draws. Its cell is ``armadillo.radiance_train``
(``traffic/radiance_train.json``, ``limits/armadillo.radiance_train.json``).
"""
from __future__ import annotations

from portbench.harness import flops, knobs, scene
from portbench.paths import train_step


def step_flops(fk: dict, batch: int, n_samples: int, app_cap: int) -> float:
    """One radiance step: per ray the density at every one of the
    ``n_samples`` samples, and the appearance and the render MLP at its
    ``app_cap`` top samples; forward and backward, three times the
    forward (``flops.py``'s conventions)."""
    w = flops.widths(fk)
    return 3 * batch * (n_samples * w["density"]
                        + app_cap * (w["app"] + w["render_mlp"]))


class Path(train_step.Path):
    def _build(self, ref: bool):
        field, lc, optim, step = train_step._mods(ref)
        c = self.c
        fcfg = field.FieldConfig(**self.fk)
        reso = lc.n_to_reso(self.recipe["init_voxels"], knobs.AABB)
        params = scene.raw_field(self.fk, reso, self.seed, self.dev)
        scn = scene.empty_scene(self.dev)
        n = min(c["nSamples"], lc.cal_n_samples(reso, c["step_ratio"]))
        opt = optim.make_optimizer(None, *knobs.optimizer_args(c))
        st = step.StepStatic(**dict(knobs.step_kwargs(c, n),
                                    is_relight=False, march_cap=0))
        w = step.LossWeights(**dict(
            knobs.loss_kwargs(c), l1=c["L1_weight_inital"],
            tv_density=c["TV_weight_density"], tv_app=c["TV_weight_app"]))
        fn = step.make_train_step(fcfg, opt, st, w, device=self.dev)
        return params, scn, int(n), opt.init(params), optim.flatten, fn

    def units(self, n: int) -> int:
        """``n`` steps; the camera rays they train. (A radiance step
        reports no surface rays: it has no relight branch.)"""
        for _ in range(n):
            self.params, self.state, self.metrics = self.fn(
                self.params, self.state, self.scene, self._next_batch(),
                self.key, self.it)
            self.hits.append(None)
            self.it += 1
        return n * self.batch

    def window_flops(self, skip=range(0)) -> float:
        """The model's operations of the window's steps but those at
        ``skip``: every step does the same work."""
        steps = sum(1 for i in range(len(self.hits)) if i not in skip)
        return steps * step_flops(self.fk, self.batch, self.n_samples,
                                  self.c["app_cap_per_ray"])
