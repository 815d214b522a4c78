"""The port stands alone: it imports nothing of JAX or of tensoir_tpu, and
runs a training step on the CPU in a process where neither can be
imported."""
import re
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = re.compile(r"^\s*(from|import)\s+(jax|tensoir_tpu)(\.|\s|$)",
                       re.MULTILINE)

STEP = textwrap.dedent("""
    import sys
    for name in ("jax", "jaxlib", "tensoir_tpu"):
        sys.modules[name] = None          # any import of them now fails
    import math
    import torch
    from tensoir_tpu_torch.models.field import FieldConfig, init_field_params
    from tensoir_tpu_torch.train.optim import make_optimizer
    from tensoir_tpu_torch.train.step import (LossWeights, StepStatic,
                                              make_train_step)
    from tensoir_tpu_torch.utils.bench_scene import bench_rays, seed_solid_blob
    cfg = FieldConfig(density_n_comp=(4, 4, 4), app_n_comp=(6, 6, 6),
                      app_dim=8, feature_c=16, num_sgs=8)
    params, scene = init_field_params(torch.Generator().manual_seed(0), cfg,
                                      (16, 16, 16), [[-1.5] * 3, [1.5] * 3],
                                      device="cpu")
    seed_solid_blob(params, amp=4.0, sharp=0.2)
    opt = make_optimizer(params, 0.02, 1e-3, 0.999)
    step = make_train_step(cfg, opt, StepStatic(n_samples=32,
                           is_relight=False, white_bg=True, app_cap=8),
                           LossWeights(l1=8e-5, tv_density=0.05), device="cpu")
    batch = {"rays": bench_rays(32, spread=0.2), "light_idx": [0] * 32,
             "rgbs": torch.full((32, 3), 0.5)}
    params, state, m = step(params, opt.init(params), scene, batch,
                            torch.Generator().manual_seed(1), 0)
    assert math.isfinite(float(m["total_loss"]))
    assert state["count"]["spatial"] == 1
    assert not any(k == "jax" or k.startswith(("jax.", "tensoir_tpu."))
                   for k, v in sys.modules.items() if v is not None)
    print("ok")
""")


def test_port_runs_a_step_with_jax_unimportable():
    out = subprocess.run([sys.executable, "-c", STEP], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_no_port_file_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "tensoir_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if FORBIDDEN.search(f.read_text())]
    assert offenders == []
