"""The PyTorch port's examples (``examples/torch_*.py``) at smoke size.

Each runs in a subprocess with a timeout, on the CPU, and must print
what its reference example (``examples/<name>.py``, run the same way)
prints. The mapper's examples print the same bytes, wall times aside.
The LM examples draw other random weights than JAX's, so there every
number is masked and the lines must agree in all else. The reference
``train_lm.py`` fails under this JAX (the trainer fault of ROADMAP
Queue 3), so the port's is held to the reference's print format.
"""
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUMBER = re.compile(r"-?\d+(\.\d+)?(e[-+]?\d+)?")
WALL = re.compile(r"wall_s=[\d.]+")
# the deadline-bounded request's progress depends on the host's speed
RUSH = re.compile(r"-> proposed=\d+ deadline_hit=\w+ best=\S+")

# (example, smoke arguments, the port's extra arguments, numbers masked)
EXAMPLES = [
    ("quickstart", ["--candidates", "2"], [], False),
    ("dse_sweep", ["--budget", "3", "--candidates", "2"], [], False),
    ("llm_workloads", ["--candidates", "2", "--max-steps", "256"], [],
     False),
    ("mapping_service", [], [], False),
    ("serve_lm", ["--batch", "2", "--new-tokens", "4"],
     ["--device", "cpu"], True),
    ("map_and_pipeline", [], ["--device", "cpu"], True),
]


def _run(script, args, cwd):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS=str(torch.get_num_threads()))
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", script), *args],
        capture_output=True, text=True, env=env, cwd=cwd, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _masked(text, numbers):
    text = RUSH.sub("-> ...", WALL.sub("wall_s=...", text))
    return NUMBER.sub("#", text) if numbers else text


@pytest.mark.parametrize("name,args,port_args,numbers", EXAMPLES,
                         ids=[e[0] for e in EXAMPLES])
def test_torch_example_prints_what_the_reference_prints(
        name, args, port_args, numbers, tmp_path):
    got = _run(f"torch_{name}.py", args + port_args, str(tmp_path))
    want = _run(f"{name}.py", args, str(tmp_path))
    assert got.strip() and _masked(got, numbers) == _masked(want, numbers)


def test_torch_train_lm_prints_the_reference_format(tmp_path):
    got = _run("torch_train_lm.py", ["--device", "cpu", "--steps", "12",
                                     "--batch", "2", "--seq", "32",
                                     "--ckpt", str(tmp_path / "ck")],
               str(tmp_path))
    lines = got.strip().splitlines()
    assert _masked(lines[-1], True) == \
        "first logged loss: #  ->  final loss: #"
    first, last = (float(v) for v in re.findall(r"\d+\.\d+", lines[-1]))
    assert 0 < last < first
    assert os.listdir(tmp_path / "ck")
