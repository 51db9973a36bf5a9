"""Experiment record: the append-only save_result.txt convention plus
config snapshots (reference ``optimization/neural_sim_main.py:851-853,
1208-1210, 96-105``) with a structured JSONL twin; a copy of
``neuralsim_tpu/utils/logging.py`` whose text lines are byte-equal to it."""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch


class ResultLog:
    """Append-only per-epoch results: text format mirrors the reference's
    save_result.txt; a sibling .jsonl carries the structured record."""

    def __init__(self, output_dir: str, name: str = "save_result"):
        os.makedirs(output_dir, exist_ok=True)
        self.txt_path = os.path.join(output_dir, f"{name}.txt")
        self.jsonl_path = os.path.join(output_dir, f"{name}.jsonl")

    def append(self, epoch: int, payload: Dict[str, Any],
               text: Optional[str] = None):
        """``text`` overrides the str(payload) part of the txt line: it
        reproduces the reference's exact line bytes (mAP dict / torch tensor
        repr) while the JSONL twin keeps the structured payload."""
        with open(self.txt_path, "a", encoding="utf-8") as f:
            f.write(f"epoch: {epoch}" + (text if text is not None
                                         else str(payload)) + "\n")
        record = {"epoch": epoch, "time": time.time(), **_jsonable(payload)}
        with open(self.jsonl_path, "a", encoding="utf-8") as f:
            f.write(json.dumps(record) + "\n")


def torch_tensor_str(vec) -> str:
    """``str(torch.tensor(vec))`` of a float32 vector: the byte format of
    the reference's psi line (``neural_sim_main.py:1208-1210`` writes
    ``str(torch_softmax(psi / gumble_T))``)."""
    if isinstance(vec, torch.Tensor):
        vec = vec.detach().cpu().numpy()
    return str(torch.from_numpy(np.asarray(vec, np.float32)))


def map_result_str(result: Dict[str, Any]) -> str:
    """The reference's mAP line payload: ``str(result['bbox'])``, a plain
    dict of python floats (``neural_sim_main.py:851-853``). The evaluator
    nests per-class values under ``AP-per-class``; they are flattened to
    the reference's ``AP-<name>`` keys."""
    out: Dict[str, float] = {}
    for k, v in result.items():
        if isinstance(v, dict):
            for cls, ap in v.items():
                out[f"AP-{cls}"] = float(ap)
        else:
            out[k] = float(v)
    return str(out)


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().tolist()
    if hasattr(obj, "tolist"):
        return obj.tolist()
    if isinstance(obj, (int, float, str, bool)) or obj is None:
        return obj
    return str(obj)


def save_args_snapshot(output_dir: str, cfg, config_path: Optional[str] = None):
    """Write args.txt (+ config.txt copy) like the reference does at the top
    of every render call (neural_sim_main.py:96-105)."""
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "args.txt"), "w") as f:
        f.write(json.dumps(dataclasses.asdict(cfg), indent=2, default=str))
    if config_path and os.path.exists(config_path):
        with open(config_path) as src, open(
            os.path.join(output_dir, "config.txt"), "w"
        ) as dst:
            dst.write(src.read())
