"""Spans and per-phase timing (the port of
``neuralsim_tpu/utils/profiling.py``).

``span`` marks a unit of work on the profiler's clock: with
``torch.profiler`` on it opens a ``record_function`` range, so the device's
kernels line up under it (nested under whatever span is open); with the
profiler off it costs one check. ``phase_timer`` keeps structured
per-phase wall times and opens its phase as a span. ``debug_nans`` wraps
``torch.autograd.detect_anomaly``.

Counters are attributes of the function they count, read as deltas around
a stretch of work: ``models.nerf.nerf_apply.bf16_layers`` (low-precision
layers run), ``kernels.raymarch.fused_ngp_march.calls`` / ``.points``
(hash-march launches, and the rays x samples they marched; each launch is
the span ``render.hash_march``) and
``hypergrad.influence.mixed_grad_wrt_image_batch.batches`` / ``.images``
(grad_E's double backwards, and the real images they took; each is the
span ``grad_E.batch``).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

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


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager marking one unit of work as ``name``: a
    ``torch.profiler.record_function`` range while the profiler records,
    else nothing. It never synchronises the device."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def _sync(device):
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def phase_timer(name: str, phases: PhaseTimes, device=None):
    """Time a phase on the host clock into ``phases``, as the span
    ``name``. With a CUDA ``device`` the card is synchronized on entry and
    on exit, so the time covers the phase's work on the card and not only
    its dispatch (launches return at once)."""
    _sync(device)
    t0 = time.perf_counter()
    with span(name):
        yield
        _sync(device)
    phases.totals[name] += time.perf_counter() - t0
    phases.counts[name] += 1


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
