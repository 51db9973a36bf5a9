"""What the entries share: the configurations built from a cell's files,
seeded generators, the card's clock, and the comparisons."""

from __future__ import annotations

import dataclasses
import time
from typing import Dict

import torch

SECTIONS = ("net", "render", "camera", "sampler", "detector", "bilevel", "train")


def _sections(config: dict, workload: dict) -> Dict[str, dict]:
    """The configuration's fields per section, with the workload's
    overrides on top; lists become tuples (``skips``)."""
    out = {}
    for sec in SECTIONS:
        fields = dict(config.get(sec, {}))
        fields.update(workload.get("overrides", {}).get(sec, {}))
        out[sec] = {k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()}
    return out


def build_config(module, config: dict, workload: dict):
    """``module.NeuralSimConfig`` (the program's config module or the
    reference's copy of it) from a cell's files."""
    secs = _sections(config, workload)
    base = module.NeuralSimConfig()
    return dataclasses.replace(base, **{
        sec: dataclasses.replace(getattr(base, sec), **fields) for sec, fields in secs.items()})


def program_config(config: dict, workload: dict):
    from neuralsim_tpu_torch import config as program

    return build_config(program, config, workload)


def reference_config(config: dict, workload: dict):
    from bench_port.reference import config as reference

    return build_config(reference, config, workload)


def generator(device, seed: int, salt: int) -> torch.Generator:
    """A generator on ``device`` for one purpose (``salt``) of a run's
    seed; seeds past 64 bits wrap."""
    return torch.Generator(device=device).manual_seed((seed * 1_000_003 + salt) % (2 ** 63))


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Clock:
    """Host seconds since the window opened, the card synchronised first."""

    def __init__(self, device):
        self.device = device
        sync(device)
        self.t0 = time.perf_counter()

    def elapsed(self) -> float:
        sync(self.device)
        return time.perf_counter() - self.t0


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| over all entries."""
    a, b = a.double().flatten(), b.double().flatten()
    return float(torch.linalg.norm(a - b) / torch.clamp(torch.linalg.norm(b), min=1e-300))


def tree_rel_l2(a: dict, b: dict) -> float:
    """rel_l2 over the concatenated leaves of two dicts of tensors."""
    keys = sorted(b)
    return rel_l2(torch.cat([a[k].double().flatten() for k in keys]),
                  torch.cat([b[k].double().flatten() for k in keys]))


def worst_leaf_gap(got: dict, want: dict, skip=()) -> float:
    """The largest gap between two trees' leaf norms, | ||got_i|| -
    ||want_i|| |, over the larger of want_i's norm and the median leaf's
    norm; leaves in ``skip`` are left out (none left: 0)."""
    keys = [k for k in sorted(want) if k not in skip]
    if not keys:
        return 0.0
    norms = {k: float(torch.linalg.norm(want[k].double())) for k in keys}
    med = sorted(norms.values())[len(norms) // 2]
    worst = 0.0
    for k in keys:
        gap = abs(float(torch.linalg.norm(got[k].double())) - norms[k])
        worst = max(worst, gap / max(norms[k], med, 1e-300))
    return worst


def flat_tree(tree: dict, prefix: str = "") -> dict:
    """{"a.b": tensor} of a nested dict of tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out
