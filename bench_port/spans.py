"""The program's spans in a traced stretch, and the kernels each one
launched.

The port opens a span (``neuralsim_tpu_torch.utils.profiling.span``, a
``torch.profiler.record_function`` range while the profiler records) per
unit of work inside its layers: ``inner_train.step``, ``grad_E.image``,
``render_grad.strip``, ``render.chunk``, ``train_nerf.step`` (with
``.forward``, ``.backward``, ``.update``) and ``kernels.pack_weights``.
``span_table`` reduces a stretch's Chrome-trace events to one row per span
name:

  count     ranges of that name in the stretch
  host_s    the sum of their durations
  busy_s    the device's busy union (kernels, copies, sets) inside the
            union of that name's intervals
  kernels   kernels whose launch lies inside one of those intervals, nested
            spans included; a kernel's launch is the ``cuda_runtime`` or
            ``cuda_driver`` event with the kernel's ``args.correlation``
  device_s  those kernels' total duration

and counts the stretch's kernels that match no launch. ``readings`` gives
the per-layer numbers the spans were placed for, each ``None`` unless the
span count is the one the traced work implies (a span missing or doubled
would give a wrong ratio) and the run was on the card.

``bench_port/trace.py`` keeps no events once it has summarised them, so a
benchmark run cannot read these yet. One traced run of a cell with the
table and the readings added to its result line, from the checkout's root:

    python3 -m bench_port.spans --workload <cell> --seed <n> --seconds <s>
"""

from __future__ import annotations

import bisect
import math
from collections import defaultdict
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Tuple

from bench_port.trace import DEVICE_CATS, STRETCH, _union

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
CASTS = ("copy_kernel",)      # ATen's direct_copy_kernel_cuda, bfloat16_copy_kernel_cuda


@dataclass
class SpanStats:
    count: int
    host_s: float
    busy_s: float
    kernels: int
    device_s: float


@dataclass
class SpanTable:
    spans: Dict[str, SpanStats]
    kernels: int                          # kernels that start in the stretch
    unmatched: int                        # of them, those with no launch event
    launched: Dict[str, List[Tuple[str, float]]] = field(default_factory=dict)

    def kernel_seconds(self, name: str, patterns) -> Tuple[float, int]:
        """(seconds, count) of the kernels launched inside ``name``'s spans
        whose kernel name holds any of ``patterns``."""
        hits = [d for k, d in self.launched.get(name, ()) if any(p in k for p in patterns)]
        return sum(hits) / 1e6, len(hits)


def _covers(merged, starts, t: float) -> bool:
    """Whether t lies in one of the merged [start, end) intervals (their
    starts given)."""
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t < merged[i][1]


def _overlap(a, b) -> float:
    """The length of the intersection of two merged interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def span_table(events: List[dict]) -> Optional[SpanTable]:
    """The stretch's span table from Chrome-trace events, or None when the
    trace holds no stretch marker (``bench_port.trace.STRETCH``)."""
    complete = [e for e in events if e.get("ph") == "X"]
    marks = [e for e in complete if e.get("name") == STRETCH
             and e.get("cat") == "user_annotation"]
    if not marks:
        return None
    lo = min(float(e["ts"]) for e in marks)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in marks)
    device = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e)
              for e in complete if e.get("cat") in DEVICE_CATS]
    busy = _union([(max(a, lo), min(b, hi)) for a, b, _ in device if b > lo and a < hi])
    launch = {e["args"]["correlation"]: float(e["ts"]) for e in complete
              if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    kernels = [(launch.get(e.get("args", {}).get("correlation")), e["name"], b - a)
               for a, b, e in device if e.get("cat") == "kernel" and lo <= a < hi]
    ranges: Dict[str, list] = defaultdict(list)
    for e in complete:
        ts = float(e["ts"])
        if e.get("cat") == "user_annotation" and e["name"] != STRETCH and lo <= ts < hi:
            ranges[e["name"]].append((ts, ts + float(e["dur"])))
    spans, launched = {}, {}
    for name, intervals in ranges.items():
        merged = _union(intervals)
        starts = [a for a, _ in merged]
        launched[name] = [(k, d) for t, k, d in kernels
                          if t is not None and _covers(merged, starts, t)]
        spans[name] = SpanStats(count=len(intervals),
                                host_s=sum(b - a for a, b in intervals) / 1e6,
                                busy_s=_overlap(busy, merged) / 1e6,
                                kernels=len(launched[name]),
                                device_s=sum(d for _, d in launched[name]) / 1e6)
    return SpanTable(spans, len(kernels), sum(1 for t, _, _ in kernels if t is None), launched)


# ---------------------------------------------------------------------- #
# the per-layer readings
# ---------------------------------------------------------------------- #

# (metric, span, how it is read) per entry; the entries' own ranges count
# the traced units (one ``inner_train`` stage an epoch, one ``render_images``
# a call, one ``train_step`` a step)
METRICS = {
    "bilevel_epoch": [("launches.inner_step", "inner_train.step", "launches"),
                      ("busy_share.inner_step", "inner_train.step", "busy_share"),
                      ("launches.grad_E_image", "grad_E.image", "launches"),
                      ("busy_share.grad_E_image", "grad_E.image", "busy_share"),
                      ("cast_share.render_grad_strip", "render_grad.strip", "cast_share")],
    "render_images": [("launches.render_chunk", "render.chunk", "launches")],
    "train_step": [("launches.train_step", "train_nerf.step", "launches"),
                   ("launches.weight_pack", "kernels.pack_weights", "launches")],
}


def expected_counts(table: SpanTable, workload: dict, config: dict) -> Dict[str, int]:
    """The span counts that the traced work implies, from the units the
    entry's own ranges count and the cell's configuration."""
    from bench_port.cells import program_config

    cfg = program_config(config, workload)

    def units(name):
        s = table.spans.get(name)
        return s.count if s else 0

    entry = workload["entry"]
    if entry == "bilevel_epoch":
        epochs = units("inner_train")
        k = min(cfg.sampler.n_samples_k, cfg.bilevel.grad_e_max_images)
        pixels = cfg.camera.height * cfg.camera.width
        strips = math.ceil(k / max(1, cfg.bilevel.strip_image_batch)) * math.ceil(
            pixels / min(cfg.bilevel.grad_ray_chunk, pixels))
        return {"inner_train.step": epochs * cfg.detector.max_iter,
                "grad_E.image": epochs * k, "render_grad.strip": epochs * strips}
    if entry == "render_images":
        rays = int(workload["traffic"]["poses"]) * cfg.camera.height * cfg.camera.width
        return {"render.chunk": units("render_images") * math.ceil(rays / cfg.render.ray_chunk),
                "kernels.pack_weights": 0}
    steps = units("train_step")
    return {"train_nerf.step": steps, "kernels.pack_weights": 2 * steps}


def _read(how: str, s: SpanStats, table: SpanTable, name: str) -> Optional[float]:
    if how == "launches":
        return s.kernels / s.count
    if how == "busy_share":
        return 100.0 * s.busy_s / s.host_s if s.host_s > 0 else None
    seconds, _ = table.kernel_seconds(name, CASTS)
    return 100.0 * seconds / s.device_s if s.device_s > 0 else None


def readings(table: Optional[SpanTable], workload: dict, config: dict,
             card: dict) -> Dict[str, Optional[float]]:
    """{metric: value or None} of the cell's entry: None without a trace,
    off the card, or where the span's count is not the one expected."""
    metrics = METRICS.get(workload["entry"], [])
    if table is None or card.get("platform") != "gpu":
        return {m: None for m, _, _ in metrics}
    want = expected_counts(table, workload, config)
    out = {}
    for metric, name, how in metrics:
        s = table.spans.get(name)
        ok = s is not None and want[name] > 0 and s.count == want[name]
        out[metric] = _read(how, s, table, name) if ok else None
    return out


def traced_run(cell: str, seed: int, seconds: float, **kw):
    """(result, span table) of one traced run of ``cell`` through the
    harness, the table built from the same events as the run's summary."""
    from unittest import mock

    from bench_port import harness, trace

    kept = {}
    summarize = trace.summarize

    def keep(events):
        kept["table"] = span_table(events)
        return summarize(events)

    with mock.patch.object(trace, "summarize", keep):
        result = harness.run_cell(cell, seed, seconds, True, **kw)
    return result, kept.get("table")


def main(argv=None) -> int:
    import argparse
    import json
    import sys

    from bench_port import harness

    p = argparse.ArgumentParser(description="One traced run of a cell, with its span table.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    harness.fixed_caches()
    try:
        result, table = traced_run(args.workload, args.seed, args.seconds)
    except harness.RunRefused as e:
        print(f"bench_port: {e}", file=sys.stderr)
        return 2
    workload = harness.workload_spec(args.workload)
    config = harness.config_spec(workload["config"])
    if table is not None:
        result["spans"] = {k: asdict(v) for k, v in sorted(table.spans.items())}
        result["span_kernels"] = {"stretch": table.kernels, "unmatched": table.unmatched}
        result["span_expected"] = expected_counts(table, workload, config)
        march = workload.get("kernels", {}).get("march")
        chunks = table.spans.get("render.chunk")
        if march and chunks:
            # kernel-1 launches per chunk (one coarse, one fine march)
            _, launches = table.kernel_seconds("render.chunk", march)
            result["march_per_chunk"] = launches / chunks.count
    result["span_metrics"] = readings(table, workload, config, result["device"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
