"""A full-size NeRF MLP whose density is an exact solid box.

The weights are built by hand, so a render has real density without a
trained checkpoint, at the compute per ray of a real checkpoint:
``sigma = density * relu(1 - 50 * sum_axes relu(|coord - center| - half))``,
zero outside the box. PE rows 0-2 are the raw coordinates; layer 0 forms the
six half-space distances and a constant carrier, layers 1..depth-2 pass the
seven units through identity blocks, the last trunk layer computes the gate.
The same scene as ``box_scene_params`` in the repository's ``bench.py``.
"""

from __future__ import annotations

from typing import Optional

import torch

from neuralsim_tpu_torch.config import NeRFNetConfig
from neuralsim_tpu_torch.models.nerf import Params, init_nerf_params


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
