"""The NeRF MLP as plain functions over a param dict (a copy of the plain
path of ``neuralsim_tpu_torch/models/nerf.py``, without its kernel route).

Architecture of the reference MLP (run_nerf_helpers.py:70-122): ``netdepth``
layers of ``netwidth`` with the encoded position concatenated back in
(``[x_pe, h]``) after each layer index in ``skips``, then the viewdir head:
``alpha`` W->1, ``feature`` W->W, ``views_0`` (W+27)->W/2, ``rgb`` W/2->3.

``compute_dtype`` follows ``neuralsim_tpu/models/nerf.py:86-99``: matmul
operands are rounded to the compute dtype, products accumulate in float32,
the bias is added in float32, and each activation is cast back to the
compute dtype after its ReLU. A float32 product of two bfloat16 values is
exact, so an f32 matmul over bf16-rounded operands is that contract on any
device.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from bench_port.reference.common import draw
from bench_port.reference.config import NeRFNetConfig
from bench_port.reference.encoding import positional_encoding

Params = Dict[str, torch.Tensor]


def _dense_init(fan_in: int, fan_out: int, generator, device):
    """nn.Linear's default init: U(-1/sqrt(in), 1/sqrt(in)), [in, out] kernel."""
    bound = 1.0 / math.sqrt(fan_in)

    def uniform(shape):
        return (2.0 * draw(shape, generator, device) - 1.0) * bound

    return uniform((fan_in, fan_out)), uniform((fan_out,))


def init_nerf_params(net: NeRFNetConfig, fine: bool = False,
                     generator: Optional[torch.Generator] = None,
                     device="cpu") -> Params:
    """Random init of one NeRF MLP (coarse or fine)."""
    depth = net.netdepth_fine if fine else net.netdepth
    width = net.netwidth_fine if fine else net.netwidth
    in_ch = net.input_ch
    params: Params = {}
    fan_in = in_ch
    for i in range(depth):
        params[f"pts_{i}_kernel"], params[f"pts_{i}_bias"] = _dense_init(
            fan_in, width, generator, device)
        fan_in = width + in_ch if i in net.skips else width
    if net.use_viewdirs:
        heads = [("feature", width, width), ("alpha", width, 1),
                 ("views_0", width + net.input_ch_views, width // 2),
                 ("rgb", width // 2, 3)]
    else:
        heads = [("output", width, net.output_ch)]
    for name, fi, fo in heads:
        params[f"{name}_kernel"], params[f"{name}_bias"] = _dense_init(
            fi, fo, generator, device)
    return params


class _Float8(torch.autograd.Function):
    """x rounded to float8 e4m3 in the forward pass; the gradient passes
    in float32 (e4m3's range of 448 would turn a large gradient into NaN)."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.float8_e4m3fn).to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        return g


def round_to(x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """x rounded to compute_dtype, held in float32 (float8: the control's
    e4m3 operands, see ``_Float8``)."""
    if compute_dtype == torch.float8_e4m3fn:
        return _Float8.apply(x)
    return x.to(compute_dtype).to(torch.float32)


def _dense(h, kernel, bias, compute_dtype):
    return (round_to(h, compute_dtype) @ round_to(kernel, compute_dtype)
            + bias.to(torch.float32))


def _dense_relu(h, kernel, bias, compute_dtype, fast_epilogue: bool):
    """ReLU layer, activation rounded to compute_dtype. ``fast_epilogue``
    (the fused kernels' option) rounds the product and the bias to
    compute_dtype before adding them; in float32 it changes nothing."""
    if not fast_epilogue:
        return round_to(torch.relu(_dense(h, kernel, bias, compute_dtype)),
                        compute_dtype)
    acc = round_to(h, compute_dtype) @ round_to(kernel, compute_dtype)
    return round_to(torch.relu(round_to(acc, compute_dtype)
                               + round_to(bias, compute_dtype)), compute_dtype)


def nerf_apply(params: Params, x_pe, d_pe, net: NeRFNetConfig,
               compute_dtype=torch.float32,
               fast_epilogue: bool = False) -> torch.Tensor:
    """MLP on encoded inputs x_pe [N, input_ch], d_pe [N, input_ch_views]
    (or None). Returns raw [N, 4]: rgb logits, density."""
    depth = sum(1 for k in params if k.startswith("pts_") and k.endswith("kernel"))
    x_pe = round_to(x_pe, compute_dtype)
    h = x_pe
    for i in range(depth):
        h = _dense_relu(h, params[f"pts_{i}_kernel"], params[f"pts_{i}_bias"],
                        compute_dtype, fast_epilogue)
        if i in net.skips:
            h = torch.cat([x_pe, h], dim=-1)

    if not net.use_viewdirs:
        return _dense(h, params["output_kernel"], params["output_bias"], compute_dtype)
    if d_pe is None:
        raise ValueError("use_viewdirs=True requires encoded directions")
    alpha = _dense(h, params["alpha_kernel"], params["alpha_bias"], compute_dtype)
    feature = round_to(_dense(h, params["feature_kernel"], params["feature_bias"],
                              compute_dtype), compute_dtype)
    h = torch.cat([feature, round_to(d_pe, compute_dtype)], dim=-1)
    h = _dense_relu(h, params["views_0_kernel"], params["views_0_bias"],
                    compute_dtype, fast_epilogue)
    rgb = _dense(h, params["rgb_kernel"], params["rgb_bias"], compute_dtype)
    return torch.cat([rgb, alpha], dim=-1)


def query_points(params: Params, pts, viewdirs: Optional[torch.Tensor],
                 net: NeRFNetConfig, compute_dtype=torch.float32,
                 pe_projection: bool = True) -> torch.Tensor:
    """Encode and evaluate the field at sample points pts [N, S, 3] with
    per-ray unit view directions [N, 3] (or None). Returns raw [N, S, 4].

    The plain encoding (``pe_projection`` picks its form) and ``nerf_apply``.
    """
    n, s, _ = pts.shape
    flat = pts.reshape(n * s, 3)
    dirs = None
    if net.use_viewdirs:
        dirs = viewdirs[:, None, :].expand(n, s, 3).reshape(n * s, 3)
    x_pe = flat if net.i_embed == -1 else positional_encoding(
        flat, net.multires, projection=pe_projection)
    d_pe = None
    if net.use_viewdirs:
        d_pe = dirs if net.i_embed == -1 else positional_encoding(
            dirs, net.multires_views, projection=pe_projection)
    raw = nerf_apply(params, x_pe, d_pe, net, compute_dtype=compute_dtype)
    return raw.reshape(n, s, raw.shape[-1])
