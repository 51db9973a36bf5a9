"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the result line.

Everything that belongs to a cell is found by name: its workload file
``workloads/<cell>.json`` names its configuration (``configs/<name>.json``),
its entry (``entries/<entry>.py``) and its limits; ``BENCHMARK.json`` at the
checkout's root says which end-to-end metrics the cell reports and which
per-layer metrics (``metrics/<metric>.py``) a traced run reads.

An entry module defines ``Cell(spec)``: its constructor is the set-up (the
weights and inputs from the seed, the warm-up of the cell's own shapes),
``window(seconds, tracer)`` measures and returns a ``Window``,
``release()`` frees the program's state, and ``check(control=False)``
returns the compared numbers ({name: value}), each against the workload's
limit. With ``control=True`` the reference in the next lower precision
stands in the program's place (the calibration's control).
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the modules that no run may load: the JAX stack and the JAX package,
# compared by whole top-level name (the port's name begins with the JAX
# package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "neuralsim_tpu")


class RunRefused(RuntimeError):
    """A run that cannot give a result: no card, too few cards, or a
    forbidden module loaded."""


@dataclass
class Spec:
    """What a cell's set-up is given."""

    name: str
    workload: dict
    config: dict
    seed: int
    device: object            # torch.device
    tmpdir: str


@dataclass
class Window:
    """What a window measured: its end-to-end metrics, the work it
    attempted and how much of it failed, and a record the per-layer
    readers read."""

    e2e: Dict[str, float]
    attempted: int
    failed: int
    record: dict = field(default_factory=dict)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def workload_spec(name: str) -> dict:
    return load_json(HERE / "workloads" / f"{name}.json")


def config_spec(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def entry_module(entry: str):
    return load_module(HERE / "entries" / f"{entry}.py", f"bench_port_entry_{entry}")


def metric_reader(name: str):
    return load_module(HERE / "metrics" / f"{name}.py",
                       "bench_port_metric_" + name.replace(".", "_").replace("-", "_"))


def cell_metrics(bench: dict, cell: str):
    """(end-to-end, per-layer) metric entries that ``cell`` reports."""
    def listed(m):
        return "workloads" not in m or cell in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if listed(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if m["moves"] in names and listed(m)]
    return e2e, layer


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_info(device) -> dict:
    """The card's name, count and power limit (``nvidia-smi``)."""
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i",
                              str(torch.cuda.current_device())],
                             capture_output=True, text=True, timeout=30)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        info["power_limit_w"] = None
    return info


def require_cards(n: int):
    import torch

    if not torch.cuda.is_available():
        raise RunRefused("no CUDA device: this benchmark runs on the card only")
    if torch.cuda.device_count() < n:
        raise RunRefused(f"the cell needs {n} cards, {torch.cuda.device_count()} present")


def quantile(values, q: float) -> float:
    """The q-quantile of values by linear interpolation (numpy's default)."""
    xs = sorted(values)
    pos = q * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device=None,
             workload: Optional[dict] = None, config: Optional[dict] = None,
             bench: Optional[dict] = None, tmpdir: Optional[str] = None) -> dict:
    """One run; returns the result object. ``device``, ``workload``,
    ``config`` and ``bench`` stand in for the card and the files only in
    the benchmark's own tests, which run a cell at a tiny size on the CPU."""
    import tempfile

    import torch

    from bench_port.trace import Tracer

    t0 = time.perf_counter()
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    workload = workload or workload_spec(cell)
    config = config or config_spec(workload["config"])
    on_card = device is None
    if on_card:
        require_cards(int(workload["chips"]))
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    device = torch.device(device)

    import neuralsim_tpu_torch
    from neuralsim_tpu_torch.kernels import build

    neuralsim_tpu_torch.set_card_numerics(device)
    if on_card:
        build.build_all(workload.get("builds", build.SOURCES))
    info = card_info(device) if on_card else {"platform": "cpu", "kind": "cpu", "count": 1}
    entry = entry_module(workload["entry"])
    with tempfile.TemporaryDirectory(dir=tmpdir) as tmp:
        spec = Spec(cell, workload, config, seed, device, tmp)
        run = entry.Cell(spec)
        if on_card:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0

        tracer = Tracer(trace)
        win = run.window(float(seconds), tracer)
        if on_card:
            torch.cuda.synchronize()
            info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
        run.release()
        values = run.check()
    # after the window and the check, which import the reference and may
    # call into the program again
    found = forbidden_modules()
    if found:
        raise RunRefused(f"modules of the JAX stack loaded in this process: {found}")
    limits = workload["limits"]
    checks = {k: {"value": float(v), "limit": float(limits[k])} for k, v in values.items()}
    correct = set(checks) == set(limits) and all(
        c["value"] == c["value"] and c["value"] <= c["limit"] for c in checks.values())

    e2e, layer = cell_metrics(bench, cell)
    metrics = {}
    if not trace:
        for m in e2e:
            value = setup_s if m["name"] == "setup_s" else win.e2e.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        ctx = {"workload": workload, "config": config, "card": info, "record": win.record,
               "trace": tracer.summary, "e2e": win.e2e}
        for m in layer:
            value = metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        summary = tracer.summary
        if summary is not None:
            info["busy_s"] = summary.busy_s
            info["window_s"] = summary.window_s
    result = {"correct": bool(correct), "attempted": int(win.attempted),
              "failed": int(win.failed), "metrics": metrics, "device": info}
    if trace and tracer.summary is not None:
        result["breakdown"] = {"device_ops": tracer.summary.top_ops(),
                               "idle_gaps": tracer.summary.idle_gaps}
    result["checks"] = checks
    return result


def fixed_caches():
    """torch's own kernel cache inside the checkout, at a fixed path."""
    path = ROOT / ".bench_cache" / "torch_kernels"
    os.environ.setdefault("PYTORCH_KERNEL_CACHE_PATH", str(path))
    os.makedirs(os.environ["PYTORCH_KERNEL_CACHE_PATH"], exist_ok=True)


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    fixed_caches()
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except RunRefused as e:
        print(f"bench_port: {e}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0

