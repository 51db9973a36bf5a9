"""The readings that a cell's limits are set from: for each seed, the
program's numbers (a short window, then the check) and the control's (the
reference in the next lower precision in the program's place), as one JSON
line per seed. Not part of a benchmark run.

    python3 bench_port/calibrate.py --workload <cell> --seeds 11,12,13 --seconds 3 \
        [--out chiprun_out/calibrate.jsonl]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cell: str, seed: int, seconds: float, device=None, workload=None, config=None):
    """{"program": {...}, "control": {...}} of one seed, and the readings
    of each fault the entry plants in the reference put in the program's
    place (``FAULTS``)."""
    import torch

    import neuralsim_tpu_torch
    from neuralsim_tpu_torch.kernels import build

    from bench_port import harness
    from bench_port.trace import Tracer

    workload = workload or harness.workload_spec(cell)
    config = config or harness.config_spec(workload["config"])
    if device is None:
        harness.require_cards(int(workload["chips"]))
        device = torch.device("cuda", 0)
        build.build_all(workload.get("builds", build.SOURCES))
    device = torch.device(device)
    neuralsim_tpu_torch.set_card_numerics(device)
    entry = harness.entry_module(workload["entry"])
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        run = entry.Cell(harness.Spec(cell, workload, config, seed, device, tmp))
        run.window(seconds, Tracer(False))
        run.release()
        out = {"seed": seed, "program": run.check(), "control": run.check(control=True)}
        for fault in getattr(run, "FAULTS", ()):
            out[fault] = run.check(fault=fault)
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    from bench_port.harness import fixed_caches

    fixed_caches()
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps(readings(args.workload, seed, args.seconds))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
