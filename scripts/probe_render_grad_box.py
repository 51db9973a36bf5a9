#!/usr/bin/env python3
"""Probe of the psi render gradient on the box scene, on the CPU, with the
PyTorch port only: the float32 and bfloat16 strips gradients (their cosine
and norm ratio) and central differences of the float32 loss on the largest
psi component, at a reduced size (4x32 box-scene pair, the 100x100
pipeline camera cut to 24x24, K = 8 poses from psi_init("5") with seed-0
noise, grad_E normal x 1e-2 from seed 1, 64 + 128 samples).

The box's density ramp is 0.02 wide, and the fine samples are detached (as
in the reference), so the autograd gradient follows where the samples land
and need not equal the loss's finite differences.

    PYTHONPATH=. python3 scripts/probe_render_grad_box.py   # ~20 s on 4 threads
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from neuralsim_tpu_torch import config as tcfg
from neuralsim_tpu_torch.bilevel.psi_init import psi_init
from neuralsim_tpu_torch.hypergrad import render_grad
from neuralsim_tpu_torch.models.box_scene import box_scene_params
from neuralsim_tpu_torch.sampler.poses import draw_pose_noise


def main():
    torch.set_num_threads(4)
    net = tcfg.NeRFNetConfig(netdepth=4, netwidth=32, netdepth_fine=4, netwidth_fine=32,
                             skips=(2,))
    cam = tcfg.CameraConfig()
    h = w = 24
    f = h / cam.height
    K = np.array([[cam.fx * f, 0, cam.cx * f], [0, cam.fy * f, cam.cy * f], [0, 0, 1]],
                 np.float32)
    box = box_scene_params(net, torch.Generator().manual_seed(0))
    models = {"coarse": box, "fine": box}
    sc = tcfg.SamplerConfig()
    noise = draw_pose_noise(torch.Generator().manual_seed(0), sc, 8)
    grad_E = torch.randn((8, h, w, 3), generator=torch.Generator().manual_seed(1)) * 1e-2
    psi = psi_init("5")
    rc = tcfg.RenderConfig(ray_chunk=8 * h * w).test_mode()

    grads = {dt: render_grad.render_grad_psi_strips(
        models, psi, noise, grad_E, h, w, K, net, rc, sc, strip=h * w, compute_dtype=dt)
        for dt in ("float32", "bfloat16")}
    g32, g16 = grads["float32"], grads["bfloat16"]
    out = {"grad_float32": g32.tolist(), "grad_bfloat16": g16.tolist(),
           "cosine": float(torch.nn.functional.cosine_similarity(g32, g16, dim=0)),
           "norm_ratio": float(g16.norm() / g32.norm())}

    rc32 = dataclasses.replace(rc, use_pallas=False, pe_projection=False)
    comp = int(g32.abs().argmax())
    out["component"], out["central_differences"] = comp, {}
    with torch.no_grad():
        for step in (1e-2, 3e-3, 1e-3):
            e = torch.zeros(8)
            e[comp] = step
            loss = [float(render_grad.psi_outer_loss(models, psi + s * e, noise, grad_E, h, w,
                                                     K, net, rc32, sc)) for s in (1, -1)]
            out["central_differences"][str(step)] = (loss[0] - loss[1]) / (2 * step)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
