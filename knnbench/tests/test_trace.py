"""The trace's reduction and the per-layer readers, on made-up events."""

from __future__ import annotations

import pytest

from knnbench import manifest, run, trace
from knnbench.trace import Event

MS = 1_000_000


def events():
    """A 10 ms window with two calls of 4 ms; each call a 2 ms kernel and a
    0.5 ms copy inside an ``aten::copy_`` that waits; a device-side
    annotation over the whole window that is not work."""
    ev = [Event("user_annotation", trace.WINDOW, 0, 10 * MS, 1),
          Event("gpu_user_annotation", trace.WINDOW, 0, 10 * MS, 7)]
    for c0 in (1 * MS, 6 * MS):
        ev += [Event("user_annotation", trace.CALL, c0, c0 + 4 * MS, 1),
               Event("cpu_op", "aten::copy_", c0 + 3 * MS, c0 + 4 * MS, 1),
               Event("kernel", "scan_kernel", c0 + MS, c0 + 3 * MS, 7),
               Event("gpu_memcpy", "Memcpy DtoH", c0 + 3 * MS,
                     c0 + 3 * MS + MS // 2, 7)]
    return ev


def test_summary_of_a_known_timeline():
    s = trace.summarize(events())
    assert s.window_s == pytest.approx(0.010)
    assert s.busy_s == pytest.approx(0.005)
    assert s.kernel_s == pytest.approx(0.004)
    assert s.kernels == 2 and s.calls == 2
    assert s.call_wall_s == pytest.approx(0.008)
    assert s.call_device_s == pytest.approx(0.005)
    assert s.device_ops[0] == ["scan_kernel", pytest.approx(0.004)]
    idle = dict((k, v) for k, v in s.idle_gaps)
    assert idle["knnbench.call"] == pytest.approx(0.002)
    assert idle["knnbench.call/aten::copy_"] == pytest.approx(0.001)
    assert idle["knnbench.window"] == pytest.approx(0.002)
    assert [v for _, v in s.idle_gaps] == sorted(idle.values(), reverse=True)
    assert sum(idle.values()) == pytest.approx(s.window_s - s.busy_s)


def test_no_window_no_summary():
    assert trace.summarize([Event("kernel", "k", 0, 5, 1)]) is None


def reading(summary):
    return run.Reading(window_s=0.01, queries=128, calls=2, setup_s=1.5,
                       bound_s=0.0015, trace=summary)


def readers():
    return {m: manifest._reader(manifest.HERE, m) for m in (
        "qps", "setup_s", "retrieval_roofline",
        "device_idle_pct", "launches_per_call", "host_ms_per_call")}


def test_readers_on_a_known_timeline():
    r, s = readers(), trace.summarize(events())
    got = {name: read(reading(s)) for name, read in r.items()}
    assert got["qps"] == pytest.approx(12_800)
    assert got["setup_s"] == 1.5
    assert got["retrieval_roofline"] == pytest.approx(75.0)
    assert got["device_idle_pct"] == pytest.approx(50.0)
    assert got["launches_per_call"] == 1
    assert got["host_ms_per_call"] == pytest.approx(1.5)


def test_per_layer_readers_give_nothing_without_device_work():
    r = readers()
    cpu_only = trace.summarize([e for e in events()
                                if e.kind not in trace.DEVICE_KINDS])
    for name in ("retrieval_roofline", "device_idle_pct", "launches_per_call",
                 "host_ms_per_call"):
        assert r[name](reading(None)) is None
        assert r[name](reading(cpu_only)) is None


def test_a_traced_cpu_run_reads_its_window(tiny_cell):
    result = run.run_cell(tiny_cell("sift128.k10.batch10k"), 3, 0.3, True,
                          device="cpu")
    assert result["correct"]
    assert result["device"]["window_s"] >= 0.3
    assert result["device"]["busy_s"] == 0.0
    assert result["metrics"] == {}  # no device work to read on the CPU
    assert result["breakdown"]["device_ops"] == []
    assert list(result)[-1] == "checks"


class OldEvent:
    """A profiler event of a PyTorch build without ``activity_type``."""

    def __init__(self, name, device, annotation):
        self._n, self._d, self._a = name, device, annotation

    def name(self):
        return self._n

    def device_type(self):
        return f"DeviceType.{self._d}"

    def is_user_annotation(self):
        return self._a


@pytest.mark.parametrize("name, device, annotation, kind", [
    ("knnbench.call", "CPU", True, "user_annotation"),
    ("aten::copy_", "CPU", False, "cpu_op"),
    ("knnbench.window", "CUDA", True, "gpu_user_annotation"),
    ("Memcpy HtoD (Pinned -> Device)", "CUDA", False, "gpu_memcpy"),
    ("Memset (Device)", "CUDA", False, "gpu_memset"),
    ("void stripe_scan_kernel<0>(...)", "CUDA", False, "kernel"),
])
def test_kinds_without_activity_type(name, device, annotation, kind):
    assert trace.kind_of(OldEvent(name, device, annotation)) == kind
