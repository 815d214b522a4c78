"""What the benchmark may load and when it refuses to run: the import
check by whole top-level names, the reference's independence from the
program, no result without CUDA or without the program."""
from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.harness.main import forbidden_modules

PKG = Path(__file__).resolve().parent.parent
ROOT = PKG.parent


def test_import_check_compares_whole_top_level_names():
    assert forbidden_modules({"tensoir_tpu_torch", "tensoir_tpu_torch.ops",
                              "jaxtyping", "flax_like", "numpy"}) == []
    assert forbidden_modules({"tensoir_tpu.models.field", "jax.numpy",
                              "jaxlib", "flax.linen"}) == [
        "flax", "jax", "jaxlib", "tensoir_tpu"]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".", 1)[0])
    return out


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "tensoir_tpu",
                                 "bench"}


@pytest.mark.parametrize("path", sorted((PKG / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_the_reference_imports_nothing_of_the_program(path):
    assert "tensoir_tpu_torch" not in _imports(path)


def test_the_reference_loads_no_program_module():
    code = ("import sys; import portbench.reference.train.step, "
            "portbench.reference.render.chunks, "
            "portbench.reference.models.lifecycle; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    tops = eval(out)    # noqa: S307  a list literal printed above
    assert not set(tops) & {"tensoir_tpu_torch", "tensoir_tpu", "jax"}


def _run(cwd: Path, env=None):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "armadillo.relight_train", "--seed", str(2 ** 31 + 7),
         "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True,
        text=True, env=env, timeout=300)


def test_no_result_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = _run(ROOT, env)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_no_result_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""
