"""The reduction of a profiler trace on synthetic traces: device time by the
range that launched it, busy time as a union of intervals, idle gaps named
by the host's range, and the per-layer arithmetic over it."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench import readers
from portbench.common import Window
from portbench.reference.bounds import PEAK_BF16_FLOPS, paged_seconds, repmixer_seconds
from portbench.trace import Ranges, summarize


def ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic():
    """Host: profiled [0, 1000] us; a tower range [10, 110] launching two
    kernels, a decoder range [120, 170] launching one, a prep range [300,
    400] launching a copy. Device: kernels at [100, 300] and [200, 400]
    (overlapping streams), [500, 600]; the copy [700, 750]."""
    return {"traceEvents": [
        ev("user_annotation", "pb.profiled", 0, 1000),
        ev("user_annotation", "pb.tower", 10, 100),
        ev("user_annotation", "pb.decoder", 120, 50),
        ev("user_annotation", "pb.prep", 300, 100),
        ev("user_annotation", "pb.tick", 5, 900),
        ev("cuda_runtime", "cudaLaunchKernel", 20, 5, corr=1),
        ev("cuda_driver", "cuLaunchKernel", 30, 5, corr=2),
        ev("cuda_runtime", "cudaLaunchKernel", 130, 5, corr=3),
        ev("cuda_runtime", "cudaMemcpyAsync", 350, 5, corr=4),
        ev("kernel", "repmixer_block_fwd", 100, 200, corr=1),
        ev("kernel", "gemm", 200, 200, corr=2),
        ev("kernel", "gemm", 500, 100, corr=3),
        ev("gpu_memcpy", "Memcpy HtoD", 700, 50, corr=4),
        ev("cpu_op", "aten::mm", 20, 5),
    ]}


def test_device_time_goes_to_the_ranges_that_launched_it():
    s = summarize(synthetic())
    assert s.device_s["tower"] == pytest.approx(400e-6)
    assert s.device_s["decoder"] == pytest.approx(100e-6)
    assert s.device_s["prep"] == pytest.approx(50e-6)
    assert s.device_s["tick"] == pytest.approx(550e-6)
    assert s.device_events == 4


def test_busy_is_the_union_of_device_intervals():
    s = summarize(synthetic())
    assert s.window_s == pytest.approx(1000e-6)
    assert s.busy_s == pytest.approx((300 + 100 + 50) * 1e-6)  # [100, 400] + [500, 600] + [700, 750]
    # One profiled unit 450 us busy, in a window of 10 units of 1 ms.
    run = SimpleNamespace(summary=s, units=1, window=Window(seconds=0.01, units=10))
    assert readers.device_idle(run) == pytest.approx(55.0)
    assert readers.device_idle(SimpleNamespace(summary=s, units=2, window=Window(seconds=0.01))) is None
    assert readers.device_idle(SimpleNamespace(summary=s, units=2, window=Window(seconds=0.01, units=10))) \
        == pytest.approx(77.5)


def test_gaps_are_named_by_the_innermost_host_range():
    s = summarize(synthetic())
    gaps = sorted((n, round(d * 1e6)) for n, d in s.idle_gaps)
    # [0, 100]: its middle in the tower [10, 110] within the tick [5, 905];
    # [400, 500], [600, 700] and [750, 1000] (middle 875) in the tick alone.
    assert gaps == [("tick", 100), ("tick", 100), ("tick", 250), ("tower", 100)]
    t = synthetic()
    t["traceEvents"] = [e for e in t["traceEvents"] if e["name"] != "pb.tick"]
    assert ("outside", 250e-6) in [(n, pytest.approx(d)) for n, d in summarize(t).idle_gaps]
    assert [d for _, d in s.idle_gaps] == sorted((d for _, d in s.idle_gaps), reverse=True)
    ops = dict(s.device_ops)
    assert ops["gemm"] == pytest.approx(300e-6)


def test_device_work_outside_the_profiled_range_is_clipped():
    t = synthetic()
    t["traceEvents"].append(ev("kernel", "late", 990, 100, corr=99))
    s = summarize(t)
    assert dict(s.device_ops)["late"] == pytest.approx(10e-6)


def test_a_trace_without_the_profiled_range_is_refused():
    with pytest.raises(ValueError):
        summarize({"traceEvents": [ev("kernel", "k", 0, 1)]})


def test_roofline_is_least_time_over_device_time():
    s = summarize(synthetic())
    ranges = Ranges()
    ranges.bound_s["tower"] = 100e-6
    run = SimpleNamespace(summary=s, ranges=ranges, units=2)
    assert readers.roofline(run, "tower") == pytest.approx(25.0)
    assert readers.roofline(run, "decoder") is None  # no bound recorded: nothing to read
    assert readers.device_ms_per_unit(run, "tower") == pytest.approx(0.2)


def test_step_mfu_is_window_flops_over_window_seconds_and_peak():
    w = Window(seconds=2.0, flops=PEAK_BF16_FLOPS * 0.5)
    assert readers.step_mfu(SimpleNamespace(window=w)) == pytest.approx(25.0)
    assert readers.step_mfu(SimpleNamespace(window=Window(seconds=2.0))) is None


def test_host_median_over_the_window():
    w = Window(host_s={"decode": [0.03, 0.01, 0.02], "admit": []})
    run = SimpleNamespace(window=w)
    assert readers.host_median_ms(run, "decode") == pytest.approx(20.0)
    assert readers.host_median_ms(run, "admit") is None


def test_ranges_wrap_and_restore_and_count_nested_calls_once():
    class Obj:
        def outer(self, x):
            return self.inner(x) + 1

        def inner(self, x):
            return x * 2

    o = Obj()
    ranges = Ranges()
    ranges.wrap(o, "outer", "prep")
    ranges.wrap(o, "inner", "prep", bound=lambda a, k, out: 1.5)
    ranges.bounds_on = True
    assert o.outer(3) == 7
    assert len(ranges.host_s["prep"]) == 1
    assert ranges.bound_s["prep"] == 1.5
    ranges.restore()
    assert "outer" not in vars(o) and "inner" not in vars(o)


def test_bounds_take_the_larger_of_bytes_and_operations():
    # RepMixer at stage 0 of a 256-px batch of 128: operation-bound.
    t = repmixer_seconds(128, 64, 64, 96, 384, 2)
    flops = 128 * 64 * 64 * (2 * 96 * 58 + 4 * 96 * 384)
    assert t == pytest.approx(flops / PEAK_BF16_FLOPS)
    # A paged decode over 256 slots of 400 positions: byte-bound.
    p = paged_seconds(256, 1, 28, 4, 128, 16, 256 * 25, 256 * 400, 256 * 40, 256 * 640, 2)
    assert p == pytest.approx((2 * 256 * 25 * 4 * 16 * 128 * 2 + 2 * (256 * 28 * 128 * 2 + 256 * 4 * 128 * 2)
                               + 4 * (256 * 640 + 256 * 40)) / 3.35e12)
