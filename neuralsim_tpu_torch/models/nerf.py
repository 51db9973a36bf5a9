"""The NeRF MLP as plain functions over a param dict, plus a thin
``nn.Module`` that holds one dict.

Architecture of the reference MLP (run_nerf_helpers.py:70-122): ``netdepth``
layers of ``netwidth`` with the encoded position concatenated back in
(``[x_pe, h]``) after each layer index in ``skips``, then the viewdir head:
``alpha`` W->1, ``feature`` W->W, ``views_0`` (W+27)->W/2, ``rgb`` W/2->3.

``compute_dtype`` follows ``neuralsim_tpu/models/nerf.py:86-120``: the
activations between layers are held in the compute dtype, matmul operands
are in the compute dtype, products accumulate in float32, the bias is added
in float32, and each activation is cast back to the compute dtype after its
ReLU. The forward's products run as a float32 matmul of the upcast
operands (a float32 product of two bfloat16 values is exact); the
backward's on the card's tensor cores (``_LowPrecisionDense``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from neuralsim_tpu_torch import draw
from neuralsim_tpu_torch.config import NeRFNetConfig
from neuralsim_tpu_torch.models import ngp
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
    """Coarse (+ fine when n_importance > 0) pair (reference create_nerf);
    for a hash-grid field (``models/ngp.py``) one field for both."""
    if ngp.is_hash_field(net):
        return ngp.init_ngp_pipeline_params(net, n_importance, generator, device)
    models = {"coarse": init_nerf_params(net, False, generator, device)}
    if n_importance > 0:
        models["fine"] = init_nerf_params(net, True, generator, device)
    return models


def round_to(x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """x rounded to compute_dtype, held in float32."""
    return x.to(compute_dtype).to(torch.float32)


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of 2-D operands as a float32 matmul of the operands upcast
    (exact for bf16 operands): the forward's product, summed in the float32
    GEMM's own order."""
    return a.float() @ b.float()


def _matmul_low(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of two low-precision operands, products summed in float32,
    float32 out: on the card the tensor cores (``aten::mm.dtype``),
    elsewhere ``_matmul``, the same arithmetic in another order."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return _matmul(a, b)


class _LowPrecisionDense(torch.autograd.Function):
    """One dense layer on low-precision activations: h [N, in] @ kernel
    [in, out] (both in the compute dtype), products summed in float32, plus
    the float32 bias; then a ReLU where ``relu``, and the output cast to the
    compute dtype where ``round_out`` (a float32 head otherwise).
    ``fast_epilogue`` rounds the product and the bias to the compute dtype
    before adding them.

    The forward sums its products as a float32 GEMM does, in the order of
    the emulated formula it replaced: which bf16 step an activation rounds
    to follows that order, and the strips gradient follows those steps
    (another order moves it as far as the tensor cores do, ~1e-2 of its
    norm on the outer iteration's scene). The backward masks the cotangent
    by the ReLU and multiplies it by the kernel: a cotangent in the compute
    dtype on the tensor cores (``_matmul_low``), a float32 one (the heads')
    in float32. The input's gradient is cast to the compute dtype; the
    weights' gradients are computed only when asked for, the kernel's cast
    to the compute dtype."""

    @staticmethod
    def forward(ctx, h, kernel, bias, relu: bool, round_out: bool, fast_epilogue: bool):
        dtype = kernel.dtype
        acc = _matmul(h, kernel)
        if fast_epilogue:
            out = acc.to(dtype) + bias.to(dtype)
        elif round_out:
            out = torch.add(acc, bias, out=torch.empty_like(acc, dtype=dtype))
        else:
            out = acc.add_(bias)
        if relu:
            out.relu_()
        ctx.relu, ctx.fast_epilogue = relu, fast_epilogue
        ctx.save_for_backward(h if ctx.needs_input_grad[1] else None, kernel,
                              out if relu else None)
        return out

    @staticmethod
    def backward(ctx, g):
        h, kernel, out = ctx.saved_tensors
        if ctx.relu:
            g = torch.ops.aten.threshold_backward(g, out, 0)
        product = _matmul_low if g.dtype == kernel.dtype else _matmul
        dh = dk = db = None
        if ctx.needs_input_grad[0]:
            dh = product(g, kernel.t()).to(kernel.dtype)
        if ctx.needs_input_grad[1]:
            dk = product(h.t(), g).to(kernel.dtype)
        if ctx.needs_input_grad[2]:
            db = g.float().sum(0)
            if ctx.fast_epilogue:
                db = db.to(kernel.dtype).float()
        return dh, dk, db, None, None, None


def nerf_apply(params: Params, x_pe, d_pe, net: NeRFNetConfig,
               compute_dtype=torch.float32,
               fast_epilogue: bool = False) -> torch.Tensor:
    """MLP on encoded inputs x_pe [N, input_ch], d_pe [N, input_ch_views]
    (or None). Returns raw [N, 4]: rgb logits, density.

    In float32 each layer is a float32 matmul plus bias (and ReLU). In
    another compute dtype, as the JAX package does, the activations between
    layers are held in that dtype (the encodings and the concats included)
    and each layer is one ``_LowPrecisionDense``, on the kernels cast once
    per call; ``nerf_apply.bf16_layers`` counts those layers."""
    depth = sum(1 for k in params if k.startswith("pts_") and k.endswith("kernel"))
    if compute_dtype == torch.float32:
        def dense(h, name, relu, round_out):
            out = _matmul(h, params[f"{name}_kernel"]) + params[f"{name}_bias"]
            return torch.relu(out) if relu else out
    else:
        kernels = {k[:-len("_kernel")]: v.to(compute_dtype)
                   for k, v in params.items() if k.endswith("_kernel")}

        def dense(h, name, relu, round_out):
            nerf_apply.bf16_layers += 1
            return _LowPrecisionDense.apply(h, kernels[name], params[f"{name}_bias"], relu,
                                            round_out, fast_epilogue and relu)

    # x_pe feeds the first layer and each skip: each reads its own cast of
    # the rounded x_pe, so their cotangents sum in float32 and round once
    x_rounded = round_to(x_pe, compute_dtype)
    h = x_rounded.to(compute_dtype)
    for i in range(depth):
        h = dense(h, f"pts_{i}", True, True)
        if i in net.skips:
            h = torch.cat([x_rounded.to(compute_dtype), h], dim=-1)

    if not net.use_viewdirs:
        return dense(h, "output", False, False)
    if d_pe is None:
        raise ValueError("use_viewdirs=True requires encoded directions")
    alpha = dense(h, "alpha", False, False)
    feature = dense(h, "feature", False, True)
    h = torch.cat([feature, d_pe.to(compute_dtype)], dim=-1)
    h = dense(h, "views_0", True, True)
    rgb = dense(h, "rgb", False, False)
    return torch.cat([rgb, alpha], dim=-1)


nerf_apply.bf16_layers = 0


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
    form) and ``nerf_apply``. A hash-grid field goes to ``ngp.query_points``.
    """
    from neuralsim_tpu_torch.kernels import raymarch

    if ngp.is_hash_field(net):
        return ngp.query_points(params, pts, viewdirs, net, compute_dtype, use_pallas)

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
