"""A full-size NeRF MLP whose density is an exact solid box.

The weights are built by hand, so a render has real density without a
trained checkpoint, at the compute per ray of a real checkpoint:
``sigma = density * relu(1 - 50 * sum_axes relu(|coord - center| - half))``,
zero outside the box. PE rows 0-2 are the raw coordinates; layer 0 forms the
six half-space distances and a constant carrier, layers 1..depth-2 pass the
seven units through identity blocks, the last trunk layer computes the gate.
``box_scene_params`` is a copy of ``neuralsim_tpu_torch/models/box_scene.py``;
``textured_box_params`` fills what it leaves at zero, so that every weight
and every band of the encoding reaches the output.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from bench_port.reference.config import NeRFNetConfig
from bench_port.reference.nerf import Params, init_nerf_params


def box_scene_params(net: NeRFNetConfig,
                     generator: Optional[torch.Generator] = None,
                     half: float = 0.06, density: float = 80.0,
                     center=(0.0, 0.0, 0.0), view_gate: float = 0.0,
                     device="cpu") -> Params:
    """Box-density params for the coarse architecture of ``net``.

    The rgb head is a small random init (x0.01: a gray-ish object). With
    ``view_gate`` != 0 the rgb is view-dependent instead:
    ``sigmoid(c * relu(1 + view_gate * dir_x) - 4)``, bright from one
    azimuth side and near-black from the other.
    """
    params = init_nerf_params(net, generator=generator, device=device)
    params = {k: v * (0.01 if k.startswith(("feature", "views", "rgb")) else 0.0)
              for k, v in params.items()}
    w, depth, in_ch = net.netwidth, net.netdepth, net.input_ch
    if view_gate:
        params["feature_kernel"].zero_()
        params["feature_bias"].zero_()
        params["views_0_kernel"].zero_()
        # d_pe's first 3 rows are the raw direction: unit 0 = relu(1 + g*dir_x)
        params["views_0_kernel"][w + 0, 0] = float(view_gate)
        params["views_0_bias"].zero_()
        params["views_0_bias"][0] = 1.0
        rk = torch.zeros_like(params["rgb_kernel"])
        rk[0, 0], rk[0, 1], rk[0, 2] = 2.0, 1.7, 1.2
        params["rgb_kernel"] = rk
        params["rgb_bias"] = torch.full_like(params["rgb_bias"], -4.0)

    k0 = torch.zeros((in_ch, w), device=device)
    b0 = torch.zeros((w,), device=device)
    for axis in range(3):
        k0[axis, 2 * axis] = 1.0
        k0[axis, 2 * axis + 1] = -1.0
        b0[2 * axis] = -half - center[axis]
        b0[2 * axis + 1] = -half + center[axis]
    b0[6] = 1.0
    params["pts_0_kernel"], params["pts_0_bias"] = k0, b0

    for i in range(1, depth):
        off = in_ch if (i - 1) in net.skips else 0
        k = torch.zeros((off + w, w), device=device)
        if i == depth - 1:
            k[off:off + 6, 0] = -50.0
            k[off + 6, 0] = 1.0
        else:
            for u in range(7):
                k[off + u, u] = 1.0
        params[f"pts_{i}_kernel"] = k
        params[f"pts_{i}_bias"] = torch.zeros((w,), device=device)

    params["alpha_kernel"] = torch.zeros((w, 1), device=device)
    params["alpha_kernel"][0, 0] = density
    params["alpha_bias"] = torch.zeros((1,), device=device)
    return params


def textured_box_params(net: NeRFNetConfig,
                        generator: Optional[torch.Generator] = None,
                        wobble: float = 0.05, device="cpu") -> Params:
    """The box scene with a dense net in every unit the box leaves free.

    Trunk units 0-6 keep the box's structure (the half-space distances and
    the carrier, passed through identity blocks), so the density is still a
    solid box. Every other weight is a seeded He-scaled draw (nn.Linear's
    init times sqrt(6): variance 2 / fan-in), over every row: all bands of
    the point encoding at layer 0 and at the skip, every trunk unit, the
    view encoding. The rgb head reads them all, so the colour of each
    surface point depends on every weight of the net; the gate reads them
    with a small weight (``wobble``), so the density does too while the box
    stays its shape (its edges move by about ``wobble`` / 50).
    """
    box = box_scene_params(net, generator=generator, device=device)
    dense = init_nerf_params(net, generator=generator, device=device)
    he = math.sqrt(6.0)
    depth, in_ch = net.netdepth, net.input_ch
    params = {k: v * he for k, v in dense.items()}
    for i in range(depth):
        k, b = params[f"pts_{i}_kernel"], params[f"pts_{i}_bias"]
        off = in_ch if i > 0 and (i - 1) in net.skips else 0
        if i < depth - 1:
            k[:, :7] = box[f"pts_{i}_kernel"][:, :7]
            b[:7] = box[f"pts_{i}_bias"][:7]
        else:
            gate = k[:, 0] * (wobble / he)
            gate[:off + 7] = 0.0
            k[:, 0] = box[f"pts_{i}_kernel"][:, 0] + gate
            b[0] = 0.0
    params["alpha_kernel"] = box["alpha_kernel"]
    params["alpha_bias"] = box["alpha_bias"]
    return params
