"""The NeRF MLP's low-precision layers (``models/nerf.py``
``_LowPrecisionDense``) against the emulated formula they replace: every
operand rounded to bf16 and held in float32, a float32 matmul, the float32
bias, the activation rounded back (``emulated_apply`` below, the formula as
it stood).

The new layers' forward multiplies the upcast operands in float32 on any
device, and on the CPU so does their backward, so the forward must agree
to the bit and so must the gradients. Where a bf16 activation feeds two
layers (the trunk's output, read by ``alpha`` and ``feature``) autograd
adds their two bf16 cotangents in bf16, which rounds their float32 sum
once, as the emulated formula did; the encoded position, read by the first
layer and each skip, sums its cotangents in float32.
"""

import numpy as np
import pytest
import torch

from neuralsim_tpu_torch.config import NeRFNetConfig
from neuralsim_tpu_torch.models import nerf as tnerf

torch.set_num_threads(2)

BF16 = torch.bfloat16
N = 257

NETS = {
    "skip2_views": NeRFNetConfig(netdepth=4, netwidth=32, netdepth_fine=4, netwidth_fine=32,
                                 skips=(2,)),
    "skips1_3_views": NeRFNetConfig(netdepth=5, netwidth=48, netdepth_fine=5,
                                    netwidth_fine=48, skips=(1, 3), multires=6,
                                    multires_views=2),
    "skip2_no_views": NeRFNetConfig(netdepth=4, netwidth=32, netdepth_fine=4,
                                    netwidth_fine=32, skips=(2,), use_viewdirs=False),
}


def round_to(x, dtype):
    return x.to(dtype).to(torch.float32)


def emulated_apply(params, x_pe, d_pe, net, dtype, fast_epilogue=False):
    """The formula before the low-precision layers: bf16-rounded operands,
    float32 matmul, float32 bias, each activation rounded after its ReLU."""

    def dense(h, name):
        return (round_to(h, dtype) @ round_to(params[f"{name}_kernel"], dtype)
                + params[f"{name}_bias"].to(torch.float32))

    def dense_relu(h, name):
        if not fast_epilogue:
            return round_to(torch.relu(dense(h, name)), dtype)
        acc = round_to(h, dtype) @ round_to(params[f"{name}_kernel"], dtype)
        return round_to(torch.relu(round_to(acc, dtype)
                                   + round_to(params[f"{name}_bias"], dtype)), dtype)

    depth = sum(1 for k in params if k.startswith("pts_") and k.endswith("kernel"))
    x_pe = round_to(x_pe, dtype)
    h = x_pe
    for i in range(depth):
        h = dense_relu(h, f"pts_{i}")
        if i in net.skips:
            h = torch.cat([x_pe, h], dim=-1)
    if not net.use_viewdirs:
        return dense(h, "output")
    alpha = dense(h, "alpha")
    feature = round_to(dense(h, "feature"), dtype)
    h = torch.cat([feature, round_to(d_pe, dtype)], dim=-1)
    h = dense_relu(h, "views_0")
    rgb = dense(h, "rgb")
    return torch.cat([rgb, alpha], dim=-1)


def inputs(net, kind, seed=0):
    """Weights, x_pe, d_pe and a cotangent on raw. ``kind``: float32
    inputs (``raw``), float32 inputs already bf16-exact (``rounded``), or
    bf16 tensors (``bf16``)."""
    gen = torch.Generator().manual_seed(seed)
    params = tnerf.init_nerf_params(net, generator=gen)
    # biases large enough that some pre-activations sit on either side
    params = {k: v * 4.0 if k.endswith("bias") else v for k, v in params.items()}
    x = torch.randn((N, net.input_ch), generator=gen)
    d = torch.randn((N, max(net.input_ch_views, 1)), generator=gen)
    if kind == "rounded":
        x, d = round_to(x, BF16), round_to(d, BF16)
    elif kind == "bf16":
        x, d = x.to(BF16), d.to(BF16)
    cot = torch.randn((N, 4), generator=gen)
    return params, x, (d if net.use_viewdirs else None), cot


def forward_and_grads(apply, params, x, d, cot, net, fast_epilogue):
    """raw and the gradients of <raw, cot> by x_pe, d_pe and every weight."""
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    xg = x.clone().requires_grad_(True)
    dg = None if d is None else d.clone().requires_grad_(True)
    raw = apply(leaves, xg, dg, net, BF16, fast_epilogue=fast_epilogue)
    wrt = [xg] + ([dg] if dg is not None else []) + list(leaves.values())
    names = ["x_pe"] + (["d_pe"] if dg is not None else []) + list(leaves)
    grads = torch.autograd.grad((raw * cot).sum(), wrt)
    return raw.detach(), dict(zip(names, grads))


def wrapped(fn):
    return lambda p, x, d, net, dtype, fast_epilogue: fn(
        p, x, d, net, compute_dtype=dtype, fast_epilogue=fast_epilogue)


@pytest.mark.parametrize("fast_epilogue", [False, True], ids=["exact_epilogue", "fast"])
@pytest.mark.parametrize("kind", ["raw", "rounded", "bf16"])
@pytest.mark.parametrize("net_name", list(NETS))
def test_low_precision_layers_match_emulation(net_name, kind, fast_epilogue):
    net = NETS[net_name]
    params, x, d, cot = inputs(net, kind)
    got, g_got = forward_and_grads(wrapped(tnerf.nerf_apply), params, x, d, cot, net,
                                   fast_epilogue)
    want, g_want = forward_and_grads(emulated_apply, params, x, d, cot, net, fast_epilogue)
    assert got.dtype == torch.float32 and got.shape == (N, 4)
    assert torch.equal(got, want)
    assert float(got.abs().max()) > 0
    # the ReLUs cut: the test reaches both sides of the kink
    h0 = torch.relu(round_to(x, BF16) @ round_to(params["pts_0_kernel"], BF16)
                    + params["pts_0_bias"])
    assert 0.1 < float((h0 > 0).float().mean()) < 0.9

    assert set(g_got) == set(g_want)
    for name, want_g in g_want.items():
        got_g = g_got[name]
        assert got_g.dtype == want_g.dtype, name
        assert float(want_g.abs().max()) > 0, name
        assert torch.equal(got_g, want_g), name


@pytest.mark.parametrize("net_name", list(NETS))
def test_bf16_layers_counter(net_name):
    """nerf_apply.bf16_layers counts the low-precision layers: every dense
    layer of a bf16 call (12 for an 8-deep net with view directions), none
    of a float32 call."""
    net = NETS[net_name]
    params, x, d, _ = inputs(net, "raw")
    depth = net.netdepth
    per_call = depth + (4 if net.use_viewdirs else 1)
    before = tnerf.nerf_apply.bf16_layers
    tnerf.nerf_apply(params, x, d, net, compute_dtype=torch.float32)
    assert tnerf.nerf_apply.bf16_layers == before
    tnerf.nerf_apply(params, x, d, net, compute_dtype=BF16)
    tnerf.nerf_apply(params, x, d, net, compute_dtype=BF16)
    assert tnerf.nerf_apply.bf16_layers == before + 2 * per_call
    default = NeRFNetConfig()
    p8 = tnerf.init_nerf_params(default, generator=torch.Generator().manual_seed(1))
    before = tnerf.nerf_apply.bf16_layers
    tnerf.nerf_apply(p8, torch.zeros((3, default.input_ch)),
                     torch.zeros((3, default.input_ch_views)), default, compute_dtype=BF16)
    assert tnerf.nerf_apply.bf16_layers == before + 12


def test_float32_path_is_the_plain_formula():
    """In float32 nothing is rounded: the layers are float32 matmuls plus
    bias, bit for bit, forward and gradients (fast_epilogue changes nothing
    there)."""
    net = NETS["skip2_views"]
    params, x, d, cot = inputs(net, "raw")
    f32 = lambda p, x_, d_, n, dtype, fast_epilogue: tnerf.nerf_apply(  # noqa: E731
        p, x_, d_, n, compute_dtype=torch.float32, fast_epilogue=fast_epilogue)
    emu = lambda p, x_, d_, n, dtype, fast_epilogue: emulated_apply(  # noqa: E731
        p, x_, d_, n, torch.float32, fast_epilogue)
    for fast in (False, True):
        got, g_got = forward_and_grads(f32, params, x, d, cot, net, fast)
        want, g_want = forward_and_grads(emu, params, x, d, cot, net, fast)
        assert torch.equal(got, want)
        for name in g_want:
            assert torch.equal(g_got[name], g_want[name]), name


def test_activations_stay_bf16_between_layers():
    """Between layers the activations are bf16 tensors (the concats
    included): no layer is handed a float32 copy of a bf16 activation."""
    net = NETS["skip2_views"]
    params, x, d, _ = inputs(net, "raw")
    seen = []
    apply = tnerf._LowPrecisionDense.apply

    def spy(h, kernel, *rest):
        seen.append((h.dtype, kernel.dtype))
        return apply(h, kernel, *rest)

    tnerf._LowPrecisionDense.apply = spy
    try:
        tnerf.nerf_apply(params, x, d, net, compute_dtype=BF16)
    finally:
        tnerf._LowPrecisionDense.apply = apply
    assert len(seen) == net.netdepth + 4
    assert all(pair == (BF16, BF16) for pair in seen)


def test_products_forward_in_float32_backward_low(monkeypatch):
    """The forward's products go through ``_matmul`` (the float32 GEMM on
    upcast operands, whose summation order the forward keeps), the
    backward's bf16-cotangent products through ``_matmul_low`` (the tensor
    cores on the card); the heads' float32 cotangents through ``_matmul``."""
    net = NETS["skip2_views"]
    params, x, d, cot = inputs(net, "raw")
    calls = []
    matmul, low = tnerf._matmul, tnerf._matmul_low

    def spy(name, fn):
        def wrapped(a, b):
            calls.append((name, a.dtype, tuple(a.shape), tuple(b.shape)))
            return fn(a, b)
        return wrapped

    monkeypatch.setattr(tnerf, "_matmul", spy("f32", matmul))
    monkeypatch.setattr(tnerf, "_matmul_low", spy("low", low))
    xg = x.clone().requires_grad_(True)
    raw = tnerf.nerf_apply(params, xg, d, net, compute_dtype=BF16)
    forward = list(calls)
    assert [c[0] for c in forward] == ["f32"] * (net.netdepth + 4)
    assert all(c[1] == BF16 for c in forward)
    calls.clear()
    torch.autograd.grad((raw * cot).sum(), xg)
    # _matmul_low falls back to _matmul off the card, so count its calls
    low_calls = [c for c in calls if c[0] == "low"]
    f32_calls = [c for c in calls if c[0] == "f32" and c[1] == torch.float32]
    assert len(low_calls) == net.netdepth + 2          # trunk, feature, views_0
    assert all(c[1] == BF16 for c in low_calls)
    assert len(f32_calls) == 2                         # the alpha and rgb heads


def test_weights_need_no_gradient_kept():
    """Where the weights carry no gradient (the strips), a layer keeps only
    its kernel and its output for the backward, not its input."""
    net = NETS["skip2_views"]
    params, x, d, cot = inputs(net, "raw")
    xg = x.clone().requires_grad_(True)
    raw = tnerf.nerf_apply(params, xg, d, net, compute_dtype=BF16)
    fn = raw.grad_fn
    nodes, stack = [], [fn]
    while stack:
        node = stack.pop()
        if node is None or node in nodes:
            continue
        nodes.append(node)
        stack.extend(n for n, _ in node.next_functions)
    dense = [n for n in nodes if type(n).__name__ == "_LowPrecisionDenseBackward"]
    assert len(dense) == net.netdepth + 4
    for node in dense:
        h, _, _ = node.saved_tensors
        assert h is None
    g, = torch.autograd.grad((raw * cot).sum(), xg)
    assert np.isfinite(g.numpy()).all()
