"""A cell's files shrunk to a size the CPU renders in seconds: a 6x32 net,
a 16x16 camera, 8 + 8 samples, K = 2-4, RetinaNet at 32x32 and 3 inner
steps. The widths are cut here only, never in a benchmarked cell."""

from __future__ import annotations

import copy

from bench_port import harness


def tiny(cell: str):
    w = copy.deepcopy(harness.workload_spec(cell))
    c = copy.deepcopy(harness.config_spec(w["config"]))
    # six layers: the kernels take no skip after the last trunk layer
    c["net"].update(netwidth=32, netwidth_fine=32, netdepth=6, netdepth_fine=6)
    for k in ("fx", "fy", "cx", "cy", "focal"):
        c["camera"][k] *= 0.16
    c["camera"].update(height=16, width=16)
    c["render"].update(n_samples=8, n_importance=8)
    w.setdefault("overrides", {}).setdefault("render", {}).update(ray_chunk=100)
    t = w["traffic"]
    if w["entry"] == "render_images":
        t["poses"] = 2
    elif w["entry"] == "train_step":
        t.update(hw=16, views=4, timing_steps=2, trace_steps=3)
    else:
        c["sampler"]["n_samples_k"] = 4
        c["detector"].update(image_size=32, max_iter=3, images_per_batch=2)
        c["bilevel"].update(grad_ray_chunk=128)
        t["val_images"] = 4
        w["check"]["images"] = 2
    return w, c


def run(cell: str, seed: int = 3, seconds: float = 0.5, trace: bool = False, tmpdir=None):
    w, c = tiny(cell)
    return harness.run_cell(cell, seed, seconds, trace, device="cpu", workload=w, config=c,
                            tmpdir=tmpdir)
