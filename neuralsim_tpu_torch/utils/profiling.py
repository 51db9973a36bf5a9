"""Per-phase timing and tracing (the port of
``neuralsim_tpu/utils/profiling.py``).

``phase_timer`` keeps structured per-phase wall times and opens a
``torch.profiler.record_function`` range, so a device trace lines up with
the host phases; ``trace_context`` wraps ``torch.profiler``;
``debug_nans`` wraps ``torch.autograd.detect_anomaly``.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


class PhaseTimes:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": self.totals[k], "count": self.counts[k],
                "mean_s": self.totals[k] / max(1, self.counts[k])}
            for k in self.totals
        }


GLOBAL_PHASES = PhaseTimes()


def _sync(device):
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def phase_timer(name: str, phases: Optional[PhaseTimes] = None, verbose: bool = False,
                device=None):
    """Time a phase on the host clock. With a CUDA ``device`` the card is
    synchronized on entry and on exit, so the time covers the phase's work
    on the card and not only its dispatch (launches return at once)."""
    target = phases or GLOBAL_PHASES
    _sync(device)
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
        _sync(device)
    dt = time.perf_counter() - t0
    target.totals[name] += dt
    target.counts[name] += 1
    if verbose:
        print(f"[phase] {name}: {dt:.3f}s")


@contextlib.contextmanager
def trace_context(logdir: Optional[str]):
    """Capture a torch.profiler trace (CPU and, when present, CUDA
    activity) into ``logdir`` when it is set; no-op otherwise."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Scoped anomaly detection: a backward that produces NaN raises, naming
    the forward op (the reference sets torch.autograd.set_detect_anomaly
    globally, run_nerf_helpers.py:2)."""
    if not enable:
        yield
        return
    with torch.autograd.detect_anomaly(check_nan=True):
        yield
