"""The runner's refusals and the import guard: the runner loads nothing
of JAX or of the JAX package ``repro``, and the reference nothing of
the program either. Module names are compared by their top-level name,
whole (``repro_torch`` is not ``repro``), in fresh processes, since the
test workers import JAX for other tests."""
import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

from bench import manifest  # noqa: E402

ROOT = manifest.ROOT
REFERENCE = sorted((ROOT / "bench" / "reference").glob("*.py"))
FAMILIES = sorted((ROOT / "bench" / "families").glob("*.py"))


def _env(threads=2):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS=str(threads))
    env.pop("PYTHONPATH", None)
    return env


def _run(args, cwd, timeout=300):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=_env(),
                          capture_output=True, text=True, timeout=timeout)


def test_runner_without_a_card_exits_nonzero_and_prints_no_result():
    p = _run(["bench/run.py", "--workload", "olmo_1b.train", "--seed",
              str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"], ROOT)
    assert p.returncode != 0
    assert not p.stdout.strip()
    assert "CUDA" in p.stderr


def test_runner_in_a_bare_checkout_exits_nonzero(tmp_path):
    """A directory with only BENCHMARK.json and the files under paths."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for path in manifest.load()["paths"]:
        shutil.copytree(ROOT / path, tmp_path / path,
                        ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(["bench/run.py", "--workload", "olmo_1b.decode", "--seed", "3",
              "--seconds", "1", "--trace", "1"], tmp_path)
    assert p.returncode != 0 and not p.stdout.strip()


GUARD = r"""
import json, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from bench import run, harness, manifest, calibrate, faults
from bench.smoke import shrink
for wl in ("olmo_1b.train", "mamba2_780m.prefill"):
    cell = shrink(manifest.cell(wl), checked_steps=1, trace_units=1)
    for traced in (False, True):
        harness.run(cell, 2 ** 33 + 1, 0.05, traced, "cpu")
print(json.dumps(run.forbidden_modules()))
"""


def test_nothing_the_runner_loads_is_jax_or_the_jax_package():
    p = _run(["-c", GUARD.format(root=str(ROOT))], ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []


def test_the_guard_compares_whole_top_level_names():
    from bench import run
    assert run.forbidden_modules(["repro_torch", "repro_torch.models",
                                  "jax_lookalike", "torch"]) == []
    assert run.forbidden_modules(["repro.models.lm", "jax.numpy",
                                  "flax"]) == ["flax", "jax", "repro"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_files_import_only_torch_and_the_standard_library(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch",
                       "bench"}, tops


@pytest.mark.parametrize("path", FAMILIES, ids=lambda p: p.name)
def test_family_files_import_nothing_of_jax_or_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}, tops


def test_the_reference_loads_nothing_of_jax_or_the_program():
    code = (f"import sys, json; sys.path.insert(0, {str(ROOT)!r}); "
            "import bench.reference.model as m, bench.reference.optim; "
            "[m.param_layout(json.load(open(c))) for c in "
            f"{[str(p) for p in (ROOT / 'bench' / 'configs').glob('*.json')]!r}]; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'repro', 'repro_torch'}))")
    p = _run(["-c", code], ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip() == "[]"
