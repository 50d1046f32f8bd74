"""The readers of the program's span table (``bench/program_spans.py``
and the ``program_span`` metrics that use it): each reads the right value
from a made-up table, None from a run that was not traced or a program
without the table, and a number from a traced run of its cell on the
CPU, where the decode step's children lie inside the benchmark's own
span around it."""
import os
import sys
import types

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

from bench import harness, manifest  # noqa: E402
from bench import program  # noqa: E402,F401  (puts the program on sys.path)
from bench.smoke import shrink  # noqa: E402
from repro_torch import launch  # noqa: E402
from repro_torch.launch import spans  # noqa: E402

MAN = manifest.load()
READERS = [m for m in MAN["per_layer"] if m["source"] == "program_span"
           and m["name"] not in ("decode_step_ms.serve",
                                 "decode_step_ms.prefill")]

# a made-up traced window: 4 training steps, whose backward kernels and
# recompute ran on autograd's thread (stacks of their own)
TRAIN = {
    "trainer.step": (4, 1.6),
    "trainer.step;trainer.forward": (4, 0.4),
    "trainer.step;trainer.forward;model.attention": (64, 0.1),
    "trainer.step;trainer.forward;model.attention;kernel.flash_attn.fwd":
        (64, 0.02),
    "trainer.step;trainer.backward": (4, 0.8),
    "trainer.recompute": (64, 0.16),
    "trainer.recompute;model.mlp;kernel.fused_mlp.fwd": (64, 0.04),
    "kernel.fused_mlp.bwd": (64, 0.08),
    "kernel.fused_mlp.bwd;kernel.nested": (1, 5.0),   # counted in its parent
    "trainer.step;trainer.optimizer": (4, 0.2),
    "trainer.step;trainer.sync": (4, 0.12),
}
# two generate calls, 10 decode steps
SERVE = {
    "engine.generate": (2, 1.0),
    "engine.generate;engine.first_token": (2, 0.2),
    "engine.generate;engine.first_token;engine.prefill": (2, 0.15),
    "engine.generate;engine.first_token;engine.prefill;model.attention":
        (32, 0.05),
    "engine.generate;engine.first_token;engine.prefill;model.ssm": (4, 0.06),
    "engine.generate;engine.first_token;engine.readback": (2, 0.002),
    "engine.generate;engine.decode": (10, 0.5),
    "engine.generate;engine.decode;model.attention": (160, 0.3),
    "engine.generate;engine.decode;model.mlp": (160, 0.1),
    "engine.generate;engine.decode;model.ssm": (4, 0.02),
    "engine.generate;engine.readback": (8, 0.008),
}
WANT = {
    "forward_host_ms.train": (TRAIN, 100.0),
    "backward_host_ms.train": (TRAIN, 200.0),
    "recompute_host_ms.train": (TRAIN, 40.0),
    "kernel_host_ms.train": (TRAIN, 35.0),
    "optimizer_host_ms.train": (TRAIN, 50.0),
    "step_wait_ms.train": (TRAIN, 30.0),
    "attn_host_ms.serve": (SERVE, 30.0),
    "mlp_host_ms.serve": (SERVE, 10.0),
    "token_wait_ms.serve": (SERVE, 1.0),
    "first_token_ms.serve": (SERVE, 100.0),
    "first_token_ms.prefill": (SERVE, 100.0),
    "ssm_host_ms.prefill": (SERVE, 40.0),
}


def _ctx(traced=True):
    return types.SimpleNamespace(traced={"window_s": 1.0} if traced
                                 else None)


def test_every_program_span_metric_has_a_case():
    assert sorted(m["name"] for m in READERS) == sorted(WANT)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_a_made_up_table(name, monkeypatch):
    tab, want = WANT[name]
    taken = []
    monkeypatch.setattr(spans, "table", lambda: dict(tab))
    monkeypatch.setattr(spans, "reset", lambda: taken.append(1))
    ctx = _ctx()
    read = manifest.reader(name)
    assert read(ctx) == pytest.approx(want)
    # the window's table is taken once a run, and emptied then
    monkeypatch.setattr(spans, "table", lambda: {})
    assert read(ctx) == pytest.approx(want) and taken == [1]


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_none_untraced_or_without_the_table(name, monkeypatch):
    read = manifest.reader(name)
    assert read(_ctx(traced=False)) is None
    monkeypatch.delattr(launch, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.launch.spans", None)
    assert read(_ctx()) is None


def test_a_span_missing_from_the_window_reads_none(monkeypatch):
    monkeypatch.setattr(spans, "table",
                        lambda: {"trainer.step": (4, 1.6)})
    monkeypatch.setattr(spans, "reset", lambda: None)
    assert manifest.reader("step_wait_ms.train")(_ctx()) is None


@pytest.mark.parametrize("workload", ["olmo_1b.train", "olmo_1b.decode",
                                      "mamba2_780m.prefill"])
def test_a_traced_cpu_run_reads_its_program_span_metrics(workload):
    """Every reader of the cell reads a number, but those of what the CPU
    path has not: the kernels (the models call them on CUDA tensors) and
    the card's synchronise."""
    spans.reset()
    cell = shrink(manifest.cell(workload), checked_steps=1, trace_units=2)
    res, _ = harness.run(cell, 2 ** 33 + 3, 0.05, True, "cpu", min_units=2)
    assert res["correct"]
    got = res["metrics"]
    mine = {m["name"] for m in READERS if workload in m["workloads"]}
    assert mine
    assert mine - set(got) == ({"kernel_host_ms.train", "step_wait_ms.train"}
                               if workload.endswith("train") else set())
    if workload == "olmo_1b.decode":
        inside = (got["attn_host_ms.serve"]["value"]
                  + got["mlp_host_ms.serve"]["value"])
        assert 0 < inside <= got["decode_step_ms.serve"]["value"]
    if workload == "olmo_1b.train":
        assert got["forward_host_ms.train"]["value"] > 0
        assert got["backward_host_ms.train"]["value"] > 0


class _Ev:
    def __init__(self, name, start, end, dev="cpu"):
        self._n, self._s, self._e = name, start, end
        self._d = (torch.autograd.DeviceType.CPU if dev == "cpu"
                   else torch.autograd.DeviceType.CUDA)

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._d

    def is_user_annotation(self):
        return False


def test_span_idle_puts_each_gap_down_to_the_range_that_began_last():
    """scripts/span_idle.py: a gap goes to the open program range that
    began last, on whichever host thread (the backward's ranges overlap
    the main thread's without nesting in them)."""
    import importlib.util
    path = manifest.ROOT / "scripts" / "span_idle.py"
    spec = importlib.util.spec_from_file_location("span_idle", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ms = 1_000_000
    events = [
        _Ev("bench.window", 0, 100 * ms),
        _Ev("bench.step", 0, 100 * ms),
        _Ev("trainer.step", 1 * ms, 99 * ms),
        _Ev("trainer.backward", 10 * ms, 60 * ms),
        _Ev("kernel.fused_mlp.bwd", 12 * ms, 30 * ms),    # autograd's thread
        _Ev("trainer.sync", 70 * ms, 99 * ms),
        _Ev("k", 2 * ms, 15 * ms, "cuda"),
        _Ev("k", 25 * ms, 65 * ms, "cuda"),
        _Ev("k", 80 * ms, 90 * ms, "cuda"),
    ]
    got = mod.idle_by_range(events)
    # the gaps: 0-2, 15-25, 65-80, 90-100 ms
    assert got == {"outside": pytest.approx([1, 0.002, 0.002]),
                   "kernel.fused_mlp.bwd": pytest.approx([1, 0.01, 0.01]),
                   "trainer.step": pytest.approx([1, 0.015, 0.015]),
                   "trainer.sync": pytest.approx([1, 0.01, 0.01])}
