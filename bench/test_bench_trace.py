"""The trace's reduction on made-up events: busy time is a union, idle
gaps are labelled by the span the host was in, a span's device time is
that of the operations launched inside it, and the card-side copies of
spans are no device work."""
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

from bench import trace  # noqa: E402

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, start, end, dev=CPU, cid=0, note=False):
        self._n, self._s, self._e, self._d = name, start, end, dev
        self._c, self._a = cid, note

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        return self._d

    def is_user_annotation(self):
        return self._a

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return 0


def test_reduction_of_a_made_up_window():
    ms = 1_000_000
    events = [
        Ev("bench.window", 0, 100 * ms),
        Ev("bench.window", 0, 100 * ms, CUDA, note=True),
        Ev("bench.step", 0, 60 * ms),
        Ev("bench.adamw_update", 30 * ms, 50 * ms),
        Ev("cudaLaunchKernel", 1 * ms, 2 * ms, cid=7),
        Ev("cudaLaunchKernel", 31 * ms, 32 * ms, cid=8),
        Ev("cudaLaunchKernel", 33 * ms, 34 * ms, cid=9),
        Ev("k_a", 5 * ms, 25 * ms, CUDA, cid=7),
        Ev("k_b", 35 * ms, 45 * ms, CUDA, cid=8),
        Ev("k_b", 40 * ms, 48 * ms, CUDA, cid=9),       # overlaps the last
    ]
    s = trace.reduce_events(events)
    assert s["window_s"] == pytest.approx(0.1)
    assert s["busy_s"] == pytest.approx(0.033)        # 20 + 13, not 38
    assert s["device_ops"] == pytest.approx({"k_a": 0.02, "k_b": 0.018})
    assert s["spans"]["adamw_update"] == pytest.approx(
        {"count": 1, "host_s": 0.02, "device_s": 0.018})
    assert s["spans"]["step"]["device_s"] == pytest.approx(0.02)
    idle = s["idle"]
    # gaps 0-5 and 25-35 begin in the step only, 48-100 inside adamw
    assert idle["step"][0] == 2 and idle["step"][1] == pytest.approx(0.015)
    assert idle["adamw_update"][1] == pytest.approx(0.052)
    assert "outside spans" not in idle
    b = trace.breakdown(s)
    assert b["device_ops"][0] == ["k_a", pytest.approx(0.02)]
    assert b["idle_gaps"][0][0].startswith("adamw_update (1 gaps")


def test_spans_wrap_and_restore_attributes():
    class Owner:
        def f(self, x):
            return x + 1

    o = Owner()
    o.g = lambda x: x * 2
    with trace.Spans([(o, "g", "g"), (o, "missing", "m"),
                      (Owner, "f", "f")]):
        assert o.g(3) == 6 and o.f(1) == 2
        assert o.g.__wrapped__ is not None
    assert not hasattr(o.g, "__wrapped__") and "f" in Owner.__dict__
    assert not hasattr(Owner.f, "__wrapped__")
