"""The check decides: at smoke sizes on the CPU, a whole run of each cell
(the harness's look for a chip skipped) comes out correct; with each
fault the cell can have planted in the timed path it comes out not
correct; and the control, the reference one precision below bfloat16 in
the program's place, fails the cell's limits. The same readings at the
cells' own sizes on the card come from ``bench/calibrate.py``."""
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

from bench import calibrate, faults, harness, judge, manifest  # noqa: E402
from bench.smoke import control_size, shrink  # noqa: E402

CELLS = [w["name"] for w in manifest.load()["workloads"]]
SEED = 2 ** 31 + 77


def _run(cell):
    """A whole run at a fixed amount of work: as many calls as the check
    samples."""
    calls = -(-cell.traffic.get("check_requests", 1) // cell.traffic["batch"])
    return harness.run(cell, SEED, 0.0, False, "cpu", min_units=calls)


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    res, lines = _run(shrink(manifest.cell(workload)))
    assert res["correct"], lines
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in CELLS for f in faults.of(manifest.cell(w).traffic)])
def test_a_planted_fault_is_not_correct(workload, fault):
    cell = manifest.cell(workload)
    # a stale cache shows in the served tokens at the control's size only
    cell = control_size(cell) if fault == "stale_cache" else shrink(cell)
    with faults.FAULTS[fault]():
        res, lines = _run(cell)
    assert not res["correct"], lines


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_the_limits(workload):
    cell = control_size(manifest.cell(workload))
    numbers = calibrate.readings(cell, SEED, "control", 0.0, "cpu")
    assert not judge.judge(numbers, cell.limits), numbers
