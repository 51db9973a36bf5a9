"""The NeRF MLP as plain functions over a param dict, plus a thin
``nn.Module`` that holds one dict.

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
from torch import nn

from neuralsim_tpu_torch import draw
from neuralsim_tpu_torch.config import NeRFNetConfig
from neuralsim_tpu_torch.ops.encoding import positional_encoding

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


def init_nerf_pipeline_params(net: NeRFNetConfig, n_importance: int,
                              generator: Optional[torch.Generator] = None,
                              device="cpu") -> Dict[str, Params]:
    """Coarse (+ fine when n_importance > 0) pair (reference create_nerf)."""
    models = {"coarse": init_nerf_params(net, False, generator, device)}
    if n_importance > 0:
        models["fine"] = init_nerf_params(net, True, generator, device)
    return models


def round_to(x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """x rounded to compute_dtype, held in float32."""
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
                 use_pallas: bool = False,
                 pe_projection: bool = True) -> torch.Tensor:
    """Encode and evaluate the field at sample points pts [N, S, 3] with
    per-ray unit view directions [N, 3] (or None). Returns raw [N, S, 4].

    With ``use_pallas`` on a CUDA tensor, a net with view directions and an
    encoding goes through the point-major kernel
    (``kernels.raymarch.fused_nerf_mlp_widepe``), whose encoding is the
    projection form whatever ``pe_projection`` says, as in the JAX
    package. Otherwise the plain encoding (``pe_projection`` picks its
    form) and ``nerf_apply``.
    """
    from neuralsim_tpu_torch.kernels import raymarch

    n, s, _ = pts.shape
    flat = pts.reshape(n * s, 3)
    dirs = None
    if net.use_viewdirs:
        dirs = viewdirs[:, None, :].expand(n, s, 3).reshape(n * s, 3)
    if (use_pallas and net.use_viewdirs and net.i_embed != -1
            and raymarch.uses_kernel(flat)):
        raw = raymarch.fused_nerf_mlp_widepe(params, flat, dirs, net, compute_dtype)
        return raw.reshape(n, s, raw.shape[-1])

    x_pe = flat if net.i_embed == -1 else positional_encoding(
        flat, net.multires, projection=pe_projection)
    d_pe = None
    if net.use_viewdirs:
        d_pe = dirs if net.i_embed == -1 else positional_encoding(
            dirs, net.multires_views, projection=pe_projection)
    raw = nerf_apply(params, x_pe, d_pe, net, compute_dtype=compute_dtype)
    return raw.reshape(n, s, raw.shape[-1])


def make_sigma_fn(params: Params, net: NeRFNetConfig,
                  compute_dtype=torch.float32):
    """[N, 3] positions -> [N] raw density of one NeRF MLP. Density reads
    only the position trunk, so the rgb head runs on a zero viewdir."""

    def sigma_fn(pts):
        dirs = torch.zeros((pts.shape[0], 3), dtype=pts.dtype, device=pts.device)
        raw = query_points(params, pts[:, None, :],
                           dirs if net.use_viewdirs else None, net, compute_dtype)
        return raw[:, 0, 3]

    return sigma_fn


class NeRF(nn.Module):
    """One NeRF MLP holding its param dict (keys as in ``init_nerf_params``)."""

    def __init__(self, params: Params, net: NeRFNetConfig):
        super().__init__()
        self.net = net
        self.params = nn.ParameterDict(
            {k: nn.Parameter(torch.as_tensor(v, dtype=torch.float32))
             for k, v in params.items()})

    def param_dict(self) -> Params:
        return dict(self.params.items())

    def forward(self, pts, viewdirs=None, compute_dtype=torch.float32):
        return query_points(self.param_dict(), pts, viewdirs, self.net,
                            compute_dtype)
