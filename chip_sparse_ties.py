#!/usr/bin/env python3
"""Why chip_smoke.py holds the data-parallel sparse fine pass on one step
from a box pair: the rays that the sparse fine pass (fine_fraction < 1)
chooses, two gloo ranks on one card against one process, per train step.

Run from the root of the repository on a machine with the card:

    python3 chip_sparse_ties.py

It builds nerf_march, renders chip_smoke.py's phase 12 box dataset, and runs
chip_smoke.MESH_TRAIN_STEPS train_nerf steps at fine_fraction 0.5, N_rand
chip_smoke.MESH_RAYS, from the seeded random init and from the box pair of
seed 1 (the dataset's box density, another rgb head), in one process and
on two ranks. For each step it prints whether the ranks chose the rays one
process chose, the largest difference between the two opacities that were
ranked (the ranks' gathered blocks against one process's whole batch), how
many of them are exactly 0, the k_sel-th opacity and its gap to the next;
then each run's losses and the largest distance of the ranks' parameters
from one process's, relative to each tensor's norm. Without a card it exits
nonzero.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs
from neuralsim_tpu_torch import train_nerf
from neuralsim_tpu_torch.config import NeRFNetConfig
from neuralsim_tpu_torch.kernels import build
from neuralsim_tpu_torch.models.box_scene import box_scene_params
from neuralsim_tpu_torch.ops import render as trender
from neuralsim_tpu_torch.parallel import launch as parallel_launch
from neuralsim_tpu_torch.parallel import mesh as parallel_mesh

# the box pair's seed of the second run (None: the seeded random init)
INITS = (None, 1)


def train(ds, device, mesh, init):
    """chip_smoke.mesh_train's steps at fine_fraction 0.5, recording every
    ranking of the sparse pass: {"params", "loss", "ranked": [(scores,
    chosen)]}."""
    ranked = []
    module = trender if mesh is None else train_nerf   # one process ranks in render_rays
    top_k = module.top_k_indices

    def recorded(scores, k):
        sel = top_k(scores, k)
        ranked.append((scores.detach().cpu().numpy(), sel.cpu().numpy()))
        return sel

    module.top_k_indices = recorded
    try:
        params, loss, _ = cs.mesh_train(ds, device, mesh, cs.MESH_TRAIN_STEPS, init,
                                        fine_fraction=0.5)
    finally:
        module.top_k_indices = top_k
    return {"params": params, "loss": loss, "ranked": ranked}


def rank(path, init, device_type):
    device = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
              else torch.device(device_type))
    ds = torch.load(path, weights_only=False)
    return train(ds, device, parallel_mesh.make_mesh(device=device), init)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_sparse_ties: torch.cuda.is_available() is false")
    t0 = time.perf_counter()
    cs.phase_device()
    build.build_all(["nerf_march"])
    torch.backends.cudnn.deterministic = True
    box = box_scene_params(NeRFNetConfig(), generator=torch.Generator().manual_seed(0),
                           device=cs.DEVICE)
    ds = cs.mesh_dataset(box)
    path = os.path.join(tempfile.mkdtemp(), "ds.pt")
    torch.save(ds, path)
    k_sel = trender.fine_ray_count(cs.MESH_RAYS, 0.5)
    for init in INITS:
        start = "the seeded random init" if init is None else f"the box pair of seed {init}"
        one = train(ds, cs.DEVICE, None, init)
        ranks = parallel_launch.launch(rank, 2, (path, init, cs.DEVICE.type),
                                       device=cs.DEVICE.type, backend="gloo", timeout=600)
        for step, ((s1, c1), (s2, c2)) in enumerate(zip(one["ranked"], ranks[0]["ranked"])):
            kth = np.sort(s1)[::-1][k_sel - 1:k_sel + 1]
            print(f"{start}, step {step}: same rays chosen {set(c1) == set(c2)}; opacities "
                  f"max |diff| {np.abs(s1 - s2).max():.3e}, {int((s1 == 0).sum())} of {s1.size} "
                  f"exactly 0, the k_sel-th ({k_sel}) {kth[0]:.8e}, gap to the next "
                  f"{kth[0] - kth[1]:.3e}", flush=True)
        rel = max(float((torch.from_numpy(ranks[0]["params"][n][k]).double()
                         - v.detach().cpu().double()).norm() / v.detach().cpu().double().norm())
                  for n in one["params"] for k, v in one["params"][n].items())
        print(f"{start}: losses one process {one['loss']}, ranks {ranks[0]['loss']}; params "
              f"at most {rel:.3e} of a tensor's norm from one process", flush=True)
    print(f"chip_sparse_ties: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    sys.exit(main())
