"""The yardstick's arithmetic and the trace's reduction."""

import pytest

from bench_port import trace, work


@pytest.mark.parametrize("width,macs", [(256, 593_408), (1024, 9_058_304)])
def test_macs_per_point(width, macs):
    net = dict(netwidth=width, netdepth=8, multires=10, multires_views=4, skips=[4])
    assert work.macs_per_point(net) == macs


def test_peaks_and_bound():
    key, peaks = work.peaks_for("NVIDIA H100 80GB HBM3")
    assert key == "H100 SXM" and peaks == {"float32": 67e12, "bfloat16": 989e12,
                                           "bytes": 3.35e12}
    assert work.peaks_for("NVIDIA H100 PCIe")[0] == "H100 PCIe"
    net = dict(netwidth=256, netdepth=8, multires=10, multires_views=4, skips=[4])
    flop, nbytes = work.march_work(net, 8192, 192, work.weight_bytes(net, "float32"))
    assert flop == 2.0 * 593_408 * 8192 * 192
    # every call of the main path is bound by its operations
    assert work.bound_s(flop, nbytes, 67e12, 3.35e12) == flop / 67e12


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_summarize_busy_union_and_gaps():
    events = [_x(trace.STRETCH, "user_annotation", 0.0, 100.0),
              _x("stage_a", "user_annotation", 0.0, 50.0),
              _x("stage_b", "user_annotation", 50.0, 50.0),
              _x("k1", "kernel", 10.0, 20.0), _x("k2", "kernel", 20.0, 20.0),
              _x("copy", "gpu_memcpy", 70.0, 10.0),
              _x("late", "kernel", 95.0, 50.0)]
    s = trace.summarize(events)
    assert s.window_s == pytest.approx(100e-6)
    # [10, 40) + [70, 80) + [95, 100): 45 us busy
    assert s.busy_s == pytest.approx(45e-6)
    assert s.device_seconds(["k"]) == (pytest.approx(40e-6), 2)
    gaps = dict(s.idle_gaps)
    # a gap goes whole to the range open at its middle
    assert gaps["stage_a"] == pytest.approx(10e-6)      # [0, 10)
    assert gaps["stage_b"] == pytest.approx(45e-6)      # [40, 70) and [80, 95)


def test_summarize_without_marker():
    assert trace.summarize([_x("k1", "kernel", 0.0, 1.0)]) is None
