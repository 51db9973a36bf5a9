"""Device traces of a bounded stretch of the window, read from
``torch.profiler``'s Chrome trace.

``Tracer.stretch()`` profiles the CPU and the card over the stretch that an
entry marks; ``TraceSummary`` holds what the per-layer readers and the
result line read from it: the traced window's length, the union of the
device's activity in it (kernels, copies, sets), every kernel's name, start
and duration, and the host's ``record_function`` ranges that name an idle
gap. The trace file is written under the run's temporary directory and
deleted once read.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

STRETCH = "bench.stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float, float]]                  # (name, start us, dur us)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def device_seconds(self, patterns) -> Tuple[float, int]:
        """(seconds, calls) of the kernels whose name holds any pattern."""
        hits = [d for name, _, d in self.kernels if any(p in name for p in patterns)]
        return sum(hits) / 1e6, len(hits)

    def top_ops(self, n: int = 10) -> List[List]:
        totals: Dict[str, float] = defaultdict(float)
        for name, _, dur in self.kernels:
            totals[name[:120]] += dur / 1e6
        return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events: List[dict]) -> Optional[TraceSummary]:
    """The stretch's summary from Chrome-trace events, or None when the
    trace holds no stretch marker."""
    marks = [e for e in events if e.get("name") == STRETCH and e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    if not marks:
        return None
    lo = min(float(e["ts"]) for e in marks)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in marks)
    device = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e)
              for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    clipped = [(max(a, lo), min(b, hi)) for a, b, _ in device if b > lo and a < hi]
    busy = _union(clipped)
    kernels = [(e["name"], a, b - a) for a, b, e in device if e.get("cat") == "kernel"
               and lo <= a < hi]
    # idle gaps inside the stretch, each named by the innermost host range
    # (record_function) open at its middle
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
              for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and e.get("name") != STRETCH]
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps: Dict[str, float] = defaultdict(float)
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        inside = [r for r in ranges if r[0] <= mid < r[1]]
        name = min(inside, key=lambda r: r[1] - r[0])[2] if inside else "host (no range)"
        gaps[name] += (b - a) / 1e6
    top_gaps = [[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]]
    return TraceSummary(window_s=(hi - lo) / 1e6,
                        busy_s=sum(b - a for a, b in busy) / 1e6,
                        kernels=kernels, idle_gaps=top_gaps)


class Tracer:
    """Profiles the stretch an entry marks when ``on``; otherwise a no-op.
    ``summary`` holds the last stretch's TraceSummary."""

    def __init__(self, on: bool):
        self.on = on
        self.summary: Optional[TraceSummary] = None

    @contextlib.contextmanager
    def stretch(self):
        if not self.on:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
        sync()
        with profile(activities=activities) as prof:
            with torch.profiler.record_function(STRETCH):
                yield
                sync()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        self.summary = summarize(events)
