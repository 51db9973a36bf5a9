#!/usr/bin/env python3
"""Times what deterministic cuDNN algorithms (the card's numeric policy,
``set_card_numerics``) cost the outer iteration, in one process on one
NVIDIA GPU, against cuDNN's default algorithms.

    python3 chip_determinism.py [--rounds 3]

It sets up phase 10 of chip_smoke.py: ``BilevelDriver`` at the defaults on
the box-scene pair (K = 50, production float32 render, RetinaNet-R50-FPN,
50 inner steps at batch 8, influence + onestep, bf16 strips gradient),
TF32 off. It runs epochs 0 and 1 under the default algorithms, and epoch 1
once more under deterministic ones (both warm-ups), then epoch 1 again
from the same state and draws (``run_epoch``) ``rounds`` times under each
setting, in the order D N N D D N ... (D: ``cudnn.deterministic``, N: the
default algorithms; ``cudnn.benchmark`` off in both). For each run it
records the host-clock seconds of the epoch (synchronised), the seconds of
each ``phase_timer`` stage and the time of each inner train step (CUDA
events; the median over steps 2-50). The deterministic runs must repeat
grad_psi to the bit. It prints one JSON line per run, then one line
{"determinism": ...} with the median, least and greatest of each number
under each setting. Without a CUDA device it exits nonzero.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs


def timed_epoch(drv, args, draws, deterministic):
    """Epoch 1 from args and draws with cudnn.deterministic set as asked:
    (record, seconds, stage seconds, inner step ms)."""
    psi, psi_opt, det_state = args
    totals = dict(drv.phases.totals)
    torch.backends.cudnn.deterministic = deterministic
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        record, step_ms = cs.timed_steps(lambda: drv.run_epoch(
            1, psi, psi_opt, det_state, save_pngs=False, draws=draws))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = False
    stages = {k: v - totals.get(k, 0.0) for k, v in drv.phases.totals.items()
              if v != totals.get(k, 0.0)}
    return record, seconds, stages, step_ms


def spread(values):
    return {"median": statistics.median(values), "min": min(values), "max": max(values)}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()
    _, smi = cs.phase_device()
    cfg_box = cs.NeuralSimConfig()
    box = cs.box_scene_params(cfg_box.net, generator=torch.Generator().manual_seed(0),
                              device=cs.DEVICE)
    models = {"coarse": box, "fine": box}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = cs.bilevel_config(tmp)
        val = cs.val_set(cfg, models, cs.VAL_IMAGES)
        drv = cs.driver.BilevelDriver(cfg, models, val,
                                      generator=torch.Generator().manual_seed(0),
                                      object_class=1, output_dir=os.path.join(tmp, "out"),
                                      device=cs.DEVICE)
        seen = cs.instrument(drv)
        drv.run(n_epochs=2, checkpoint_dir=os.path.join(tmp, "ck"))
        epoch1, draws = seen["epochs"][1]["args"], seen["draws"][1]
        # (instrument()'s stage timer synchronises around each stage, as in phase 10)
        timed_epoch(drv, epoch1, draws, True)
        order = ([True, False, False, True] * args.rounds)[:2 * args.rounds]
        runs = []
        for deterministic in order:
            record, seconds, stages, step_ms = timed_epoch(drv, epoch1, draws, deterministic)
            run = {"deterministic": deterministic, "epoch_s": seconds, "stage_s": stages,
                   "inner_step_ms": statistics.median(step_ms[1:]),
                   "grad_psi": np.asarray(record["grad_psi"]).tolist()}
            runs.append(run)
            print(json.dumps(run), flush=True)
    summary = {"card": smi, "order": ["D" if d else "N" for d in order]}
    for name, flag in (("deterministic", True), ("default", False)):
        mine = [r for r in runs if r["deterministic"] == flag]
        summary[name] = {"epoch_s": spread([r["epoch_s"] for r in mine]),
                         "inner_step_ms": spread([r["inner_step_ms"] for r in mine])}
        for stage in mine[0]["stage_s"]:
            summary[name][stage + "_s"] = spread([r["stage_s"][stage] for r in mine])
    det = [r["grad_psi"] for r in runs if r["deterministic"]]
    summary["deterministic_grad_psi_equal"] = all(g == det[0] for g in det)
    summary["epoch_cost"] = (summary["deterministic"]["epoch_s"]["median"]
                             / summary["default"]["epoch_s"]["median"] - 1)
    summary["inner_step_cost"] = (summary["deterministic"]["inner_step_ms"]["median"]
                                  / summary["default"]["inner_step_ms"]["median"] - 1)
    print(json.dumps({"determinism": summary}), flush=True)
    if not summary["deterministic_grad_psi_equal"]:
        raise SystemExit("chip_determinism: the deterministic epochs' grad_psi differ")


if __name__ == "__main__":
    main()
