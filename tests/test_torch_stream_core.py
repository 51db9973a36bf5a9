"""The streaming core (``csrc/nerf_mlp_stream.cuh``): the nets that the FP32
and wgmma cores have no room for, up to the JAX kernels' own budget.

- The route (``raymarch.core_for``) is a function of the net's shape and the
  dtype alone: the default net, 8x512, 8x1024 and every net of
  chip_smoke.py's EXTRA_NETS stay on the core they ran on before the
  streaming core existed; trunks past 1024 and encodings past a core's
  shared memory go to the streaming core, with the library's limits written
  out from the CUDA headers (``_FakeMarchLibrary``).
- The budget (``raymarch.jax_vmem_bytes``) is the sum of the blocks that
  the JAX launchers declare, held here against the JAX package's own
  weight and constant arrays (``_param_list``, ``_wide_param_list``,
  ``_wide_pe_consts``, ``_strict_upper``) for three nets: the default one,
  and 8-deep trunks of 1230 and 1234 in float32, just under and just past
  100 MiB.
- What the streaming core's launches get: the weights zero-padded to a
  multiple of 64 (exact), its table of the padded kernels, the net's
  device table; the cases that no core took before now launch on it
  (moved from test_kernels_refuse_what_the_cores_do_not_take).
- Its arithmetic, emulated from its launch arguments in its order (each
  output one float32 sum over the input rows in order, the heads summed per
  thread group and then over the groups), gives the twin.
- The twins of fused_nerf_march and fused_render_tile on a 4x1100 net
  (float32) equal the JAX kernels in interpret mode (the render tile on the
  box scene only: the interpret render tile gives NaN elsewhere).

The CUDA kernels themselves run only on the card, where chip_smoke.py holds
them against their twins on 8x1152, 8x1664, 8x256 with multires 75 and
8x1024 with multires 60 / 20.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import box_scene_params as jax_box_scene
from neuralsim_tpu.config import NeRFNetConfig as JNet
from neuralsim_tpu.kernels import raymarch as jmarch
from neuralsim_tpu_torch.config import NeRFNetConfig as TNet
from neuralsim_tpu_torch.kernels import raymarch as rm
from neuralsim_tpu_torch.models import nerf as tnerf
from neuralsim_tpu_torch.models.nerf import init_nerf_params, nerf_apply, round_to
from tests.test_torch_net_shapes import (
    _dense_in_order,
    _encoded,
    _FakeMarchLibrary,
    _he,
    stream_core_bytes,
    stream_pick_tile,
)
from tests.test_torch_wide_nets import TOL, _jax_params, _rays, _t

torch.set_num_threads(2)

# every core's net (chip_smoke.py's default net, EXTRA_NETS and the wide ones)
FIXED = {
    "8x256": dict(),
    "8x512": dict(netwidth=512, netwidth_fine=512),
    "8x1024": dict(netwidth=1024, netwidth_fine=1024),
}
# the nets the streaming core takes, and the dtypes it takes them in
STREAMED = {
    "8x1025": (dict(netwidth=1025, netwidth_fine=1025), ("float32", "bfloat16")),
    "8x1152": (dict(netwidth=1152, netwidth_fine=1152), ("float32", "bfloat16")),
    "8x1664": (dict(netwidth=1664, netwidth_fine=1664), ("bfloat16",)),
    "8x256_pe75": (dict(multires=75), ("float32",)),
    "8x1024_pe60_20": (dict(netwidth=1024, netwidth_fine=1024, multires=60, multires_views=20),
                       ("bfloat16",)),
}


def _extra_nets():
    import chip_smoke

    return dict(FIXED, **chip_smoke.EXTRA_NETS)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nets_of_the_fixed_cores_keep_their_core(dtype):
    """The default net, 8x512, 8x1024 and every net of chip_smoke.py's
    EXTRA_NETS run on the core of their dtype (FP32 in float32, wgmma in
    bf16) for every kernel, the render tile included: no net the kernels
    took before moves."""
    lib = _FakeMarchLibrary()
    lib.render_tile_max_samples = lambda core, width, in_ch, in_ch_views: 192
    bf16 = dtype == "bfloat16"
    want = rm.WGMMA_CORE if bf16 else rm.F32_CORE
    for name, kw in _extra_nets().items():
        net = TNet(**kw)
        for render_tile in (False, True):
            assert rm.core_for(net, net.netwidth, bf16, lib, render_tile) == want, name


@pytest.mark.parametrize("name", list(STREAMED))
def test_nets_past_the_fixed_cores_take_the_streaming_core(name):
    """Trunks of 1025, 1152 and 1664 (in both dtypes: past nerf_width()),
    multires 75 in float32 (464 x_pe rows: 239,904 bytes on the FP32 core's
    smallest tile) and multires 60 / 20 at 1024 in bf16 (236,544 bytes on
    the transposed wgmma core) go to the streaming core, padded to a
    multiple of 64; the same encodings in the other dtype keep their core."""
    kw, dtypes = STREAMED[name]
    net = TNet(**kw)
    lib = _FakeMarchLibrary()
    for dtype in ("float32", "bfloat16"):
        bf16 = dtype == "bfloat16"
        core = rm.core_for(net, net.netwidth, bf16, lib)
        if dtype in dtypes:
            assert core == rm.STREAM_CORE
            assert rm.padded_width(core, net.netwidth) == -(-net.netwidth // 64) * 64
        elif net.netwidth <= 1024:
            assert core == (rm.WGMMA_CORE if bf16 else rm.F32_CORE)
    if name in ("8x256_pe75", "8x1024_pe60_20"):
        bf16 = name == "8x1024_pe60_20"
        smem = lib.nerf_wgmma_smem_bytes if bf16 else lib.nerf_f32_smem_bytes
        assert smem(net.netwidth, net.input_ch, net.input_ch_views) == (
            236_544 if bf16 else 239_904)


def test_render_tile_takes_the_streaming_core_where_its_core_has_no_room_for_a_sample():
    """The render tile's route also asks for one sample beside the core:
    a core that fits but leaves no room for a sample sends the net to the
    streaming core."""
    net = TNet()
    lib = _FakeMarchLibrary()
    lib.render_tile_max_samples = lambda core, width, in_ch, in_ch_views: 0
    assert rm.core_for(net, 256, False, lib) == rm.F32_CORE
    assert rm.core_for(net, 256, False, lib, render_tile=True) == rm.STREAM_CORE


# ----------------------------------------------------------- the budget --

def _shaped_params(net):
    """Zero weights of the net's shapes (as numpy), for the JAX launchers'
    layouts."""
    return {k: np.zeros(tuple(v.shape), np.float32) for k, v in init_nerf_params(net).items()}


def _jax_blocks(kernel, net, params, bf16, s=0):
    """The bytes of the blocks that the JAX launcher of ``kernel`` declares,
    from the JAX package's own arrays, double-buffered: the weights and the
    PE constants at the compute dtype, the input and output tiles at
    theirs."""
    cd = 2 if bf16 else 4
    depth = sum(1 for k in params if k.startswith("pts_") and k.endswith("kernel"))
    wide = kernel in ("fused_nerf_march", "fused_nerf_mlp_widepe", "fused_render_tile")
    in_ch = 3 * (1 + 2 * net.multires)
    p_x, p_d = -(-in_ch // 64) * 64, -(-(3 * (1 + 2 * net.multires_views)) // 32) * 32
    if wide:
        weights = jmarch._wide_param_list(params, depth, tuple(net.skips), in_ch, p_x, p_d)
        consts = (list(jmarch._wide_pe_consts(3, net.multires, p_x))
                  + list(jmarch._wide_pe_consts(3, net.multires_views, p_d)))
    else:
        weights, consts = jmarch._param_list(params, depth), []
    if kernel == "fused_render_tile":
        consts.append(jmarch._strict_upper(s))
        r = max(8, (max(1, 4096 // s) // 8) * 8)
        tiles = 4 * (2 * (r * s * 3) + r * s + r) + 4 * (r * 3 + 3 * r + r * s)
    elif kernel == "fused_nerf_mlp":
        tiles = 2048 * (in_ch + net.input_ch_views) * cd + 2048 * 4 * 4
    else:
        t = (4096 if bf16 else 2048) if kernel == "fused_nerf_mlp_pe" else 4096
        tiles = t * 3 * 4 * 2 + t * 4 * 4
    n = sum(int(np.prod(np.shape(a))) for a in list(weights) + consts)
    return 2 * (n * cd + tiles)


KERNEL_NAMES = ("fused_nerf_march", "fused_nerf_mlp_widepe", "fused_nerf_mlp_pe",
                "fused_nerf_mlp", "fused_render_tile")


@pytest.mark.parametrize("width, taken", [(256, True), (1230, True), (1234, False)],
                         ids=["8x256", "8x1230", "8x1234"])
def test_jax_budget_is_the_launchers_blocks(width, taken):
    """jax_vmem_bytes equals the JAX launchers' blocks counted from the JAX
    package's arrays, for every kernel (the render tile at S = 64 and 192),
    in float32 and, at 256, bf16; an 8-deep trunk of 1230 stays under 100
    MiB in float32, one of 1234 passes it in the ray march (the weights
    alone: 8.5 W^2 + 142 W floats, double-buffered). By hand, the default
    net's ray march in float32: 596,996 weights and biases (x_pe rows padded
    to 64, d_pe rows to 32: 16,640 + 7 x 65,792 + 16,384 for the skip +
    65,792 + 257 + 36,992 + 387), 6 x (64 + 32) PE constants, tiles of 4096
    x (6 + 4) floats: 2 x ((596,996 + 576) x 4 + 163,840) = 5,108,256
    bytes."""
    net = TNet(netwidth=width, netwidth_fine=width)
    params = _shaped_params(net)
    for kernel in KERNEL_NAMES:
        for bf16 in ((False, True) if width == 256 else (False,)):
            for s in ((64, 192) if kernel == "fused_render_tile" else (0,)):
                want = _jax_blocks(kernel, net, params, bf16, s)
                assert rm.jax_vmem_bytes(kernel, net, width, 8, bf16, s) == want, (kernel, s)
    march = rm.jax_vmem_bytes("fused_nerf_march", net, width, 8, False)
    assert (march <= rm.JAX_VMEM_LIMIT) == taken
    if width == 256:
        assert march == 5_108_256


# ------------------------------------------------ the streaming launch --

class _FakeStreamLibrary(_FakeMarchLibrary):
    """The nerf_march and nerf_mlp libraries' entries, recorded."""

    def nerf_mlp(self, *args):
        self.calls.append(args)
        return 0

    def nerf_mlp_stream(self, *args):
        self.stream_calls.append(args)
        return 0


@pytest.fixture
def fake_stream(monkeypatch):
    lib = _FakeStreamLibrary()
    monkeypatch.setattr(rm, "uses_kernel", lambda t: True)
    monkeypatch.setattr(rm, "_library", lambda name: lib)
    monkeypatch.setattr(rm, "_run", lambda fn, device, what, *args: fn(*args, None))
    return lib


# the nets that no core took before the streaming core, and took since
# (test_kernels_refuse_what_the_cores_do_not_take's former cases)
MOVED = {
    "trunk width 1025 f32": (dict(netwidth=1025, netwidth_fine=1025), torch.float32),
    "trunk width 1025 bf16": (dict(netwidth=1025, netwidth_fine=1025), torch.bfloat16),
    "trunk width 2048 bf16": (dict(netwidth=2048, netwidth_fine=2048), torch.bfloat16),
    "multires 75 f32": (dict(multires=75), torch.float32),
    "1024 multires 130 / 130 f32": (dict(netwidth=1024, netwidth_fine=1024, multires=130,
                                         multires_views=130), torch.float32),
    "1024 multires 60 / 20 bf16": (dict(netwidth=1024, netwidth_fine=1024, multires=60,
                                        multires_views=20), torch.bfloat16),
}


@pytest.mark.parametrize("case", list(MOVED))
def test_moved_nets_launch_on_the_streaming_core(fake_stream, case):
    """A net no core took before launches on the streaming core, through
    each kernel entry (the ray march and the point-major MLP): weights
    padded to a multiple of 64 (bf16 kernels rounded), the packed pointer
    the core's table of the padded kernels' pointers, the net's device
    table, and the net's depth and encodings."""
    kw, dtype = MOVED[case]
    net = TNet(**{**dict(netdepth=4, netdepth_fine=4, skips=(2,)), **kw})
    params = init_nerf_params(net, generator=torch.Generator().manual_seed(7))
    rays = [torch.rand(3, 3), torch.rand(3, 3), torch.rand(3, 3), torch.rand(3, 4)]
    with torch.no_grad():
        rm.fused_nerf_march(params, *rays, net, compute_dtype=dtype)
        rm.fused_nerf_mlp_widepe(params, torch.rand(5, 3), torch.rand(5, 3), net,
                                 compute_dtype=dtype)
    assert fake_stream.calls == [] and len(fake_stream.stream_calls) == 2
    width = rm.stream_width(net.netwidth)
    bf16 = dtype == torch.bfloat16
    weights, table, words = rm._packed_weights(params, net, 4, bf16, fake_stream, "test",
                                               rm.STREAM_CORE)
    for args, first in zip(fake_stream.stream_calls, (6, 4)):
        ptrs, words_ptr, w, depth, _, in_ch, in_ch_views, b, packed = args[first:first + 9]
        assert (w, depth, in_ch, in_ch_views, b) == (width, 4, net.input_ch,
                                                     net.input_ch_views, int(bf16))
        assert list(ptrs) == [t.data_ptr() for t in weights]
        assert packed == table.data_ptr() and words_ptr == words.data_ptr()
    assert table.tolist() == [t.data_ptr() for t in weights[0::2]]
    padded = {k: round_to(v, dtype) if k.endswith("kernel") else v
              for k, v in rm.pad_params(params, net, width).items()}
    for key, t in zip(rm.param_keys(4), weights):
        torch.testing.assert_close(t, padded[key], rtol=0, atol=0, msg=key)


def test_stream_launch_plans_fit_shared_memory():
    """The streaming core's tile for the chip's nets (H100: 232,448 bytes a
    block): 8x1152 and 8x1024 with multires 60 / 20 on 16-point tiles,
    8x1664 on 16, 8x256 with multires 75 on 32, a 4-deep 2048 on 8; and
    its smallest tile's bytes (what the wrapper checks)."""
    lib = _FakeMarchLibrary()
    want = {"8x1152": 16, "8x1664": 16, "8x256_pe75": 32, "8x1024_pe60_20": 16}
    for name, tile in want.items():
        net = TNet(**STREAMED[name][0])
        w = rm.stream_width(net.netwidth)
        assert stream_pick_tile(w, net.input_ch, net.input_ch_views, 0) == tile, name
        assert stream_core_bytes(tile, w, net.input_ch, net.input_ch_views) <= 232_448
    assert stream_pick_tile(2048, 63, 27, 0) == 8
    assert lib.nerf_stream_smem_bytes(1152, 63, 27) == 4 * ((2 * 1152 + 100) * 4 + 1024)


# ------------------------------------------------- the core's arithmetic --

def _emulate_stream_core(weights, table, net, x_pe, d_pe, tile, bf16):
    """The streaming core's MLP in its order, from a launch's padded weights
    (found through its table of kernel pointers): every output one float32
    sum over the input rows in order ([x_pe, h] after a skip, [feature,
    d_pe] in the views layer), the bias, ReLU and the bf16 rounding; the
    heads summed per group of THREADS / tile lanes (lane t sums the rows t
    // tile, + 256 / tile, ...) and then over the groups in order."""
    by_ptr = {t.data_ptr(): t for t in weights}
    kernels = [by_ptr[p] for p in table.tolist()]
    biases = weights[1::2]
    depth = len(kernels) - 4
    cd = torch.bfloat16 if bf16 else torch.float32
    x_pe, d_pe = round_to(x_pe, cd), round_to(d_pe, cd)

    def dense(h, k, b):
        return _dense_in_order(h, k, b, torch.float32)

    def sum_in_order(h, k):
        acc = torch.zeros(h.shape[0], k.shape[1])
        for i in range(k.shape[0]):
            acc = acc + h[:, i:i + 1] * k[i]
        return acc

    def head(h, k, b):
        groups = 256 // tile
        out = sum_in_order(h[:, 0::groups], k[0::groups])
        for g in range(1, groups):
            out = out + sum_in_order(h[:, g::groups], k[g::groups])
        return out + b

    h = x_pe
    for i in range(depth):
        inp = x_pe if i == 0 else (torch.cat([x_pe, h], -1) if (i - 1) in net.skips else h)
        h = round_to(torch.relu(dense(inp, kernels[i], biases[i])), cd)
    alpha = head(h, kernels[depth + 1], biases[depth + 1])
    feature = round_to(dense(h, kernels[depth], biases[depth]), cd)
    views = round_to(torch.relu(dense(torch.cat([feature, d_pe], -1), kernels[depth + 2],
                                      biases[depth + 2])), cd)
    rgb = head(views, kernels[depth + 3], biases[depth + 3])
    return torch.cat([rgb, alpha], -1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_streaming_core_order_computes_the_twin(dtype):
    """A 3-deep net of 1100 (padded to 1152) with a skip, emulated from its
    launch's weights and table in the core's order on 16-point tiles,
    equals the twin (float32: 1e-5; bf16: the padding and the order change
    no rounding of a product, but a reordered float32 sum may land on the
    other side of a bf16 boundary, so at the bf16 tolerance 2e-2)."""
    net = TNet(netdepth=3, netwidth=1100, netdepth_fine=3, netwidth_fine=1100, skips=(0,))
    params = _he(init_nerf_params(net, generator=torch.Generator().manual_seed(11)))
    bf16 = dtype == torch.bfloat16
    weights, table, _ = rm._packed_weights(params, net, 3, bf16, _FakeMarchLibrary(), "test",
                                           rm.STREAM_CORE)
    x_pe, d_pe = _encoded(net, 8, 3)
    got = _emulate_stream_core(weights, table, net, x_pe, d_pe, 16, bf16)
    want = nerf_apply(params, x_pe, d_pe, net, compute_dtype=dtype)
    assert want.abs().max() > 0.1
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_padding_to_a_multiple_of_64_is_exact(monkeypatch, dtype):
    """The twin on the streaming core's padded weights (1100 -> 1152)
    equals the twin on the net's own to the bit with products summed in
    input order, in both dtypes."""
    net = TNet(netdepth=3, netwidth=1100, netdepth_fine=3, netwidth_fine=1100, skips=(1,))
    params = _he(init_nerf_params(net, generator=torch.Generator().manual_seed(12)))
    padded = rm.pad_params(params, net, rm.stream_width(1100))
    assert padded["pts_2_kernel"].shape == (net.input_ch + 1152, 1152)
    assert padded["views_0_kernel"].shape == (1152 + net.input_ch_views, 576)
    x_pe, d_pe = _encoded(net, 16, 5)
    monkeypatch.setattr(tnerf, "_dense", _dense_in_order)
    want = nerf_apply(params, x_pe, d_pe, net, compute_dtype=dtype)
    assert want.abs().max() > 0.1
    torch.testing.assert_close(nerf_apply(padded, x_pe, d_pe, net, compute_dtype=dtype), want,
                               rtol=0, atol=0)


# --------------------------------------------- twins against JAX (interpret) --

NET_1100 = dict(netdepth=4, netwidth=1100, netdepth_fine=4, netwidth_fine=1100, skips=(2,))


def test_march_twin_matches_pallas_interpret_on_a_1100_wide_net(rng):
    """Kernel 1's twin on a 4x1100 net (random weights, float32, 20 rays x
    16 samples) against the JAX kernel in interpret mode, at
    tests/test_torch_wide_nets.py's tolerance."""
    params = _jax_params(NET_1100, 3)
    o, d, vd, z = _rays(rng, 20, 16, far=2.0)
    want = jmarch._fused_march_channels(params, o, d, vd, z, JNet(**NET_1100),
                                        compute_dtype=jnp.float32, target_tile=128,
                                        interpret=True)
    got = rm.march_channels_ref(*_t(params, o, d, vd, z), TNet(**NET_1100))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and np.abs(w).max() > 1e-3
        np.testing.assert_allclose(g.numpy(), w, **TOL)


def test_render_tile_twin_matches_pallas_interpret_on_a_1100_wide_box(rng):
    """Kernel 3's twin on the box scene at width 1100 (ragged N): all five
    maps against the JAX kernel in interpret mode."""
    jnet = JNet(**NET_1100)
    params = {k: np.array(v) for k, v in jax_box_scene(jnet, jax.random.PRNGKey(0)).items()}
    o, d, vd, z = _rays(rng, 13, 48)
    want = jmarch.fused_render_tile(params, o, d, vd, z, jnet, compute_dtype=jnp.float32,
                                    target_tile=128, interpret=True)
    got = rm.render_tile_ref(*_t(params, o, d, vd, z), TNet(**NET_1100))
    assert float(np.asarray(want[2]).max()) > 0.5              # rays hit the box
    for name, g, w in zip(("rgb", "disp", "acc", "weights", "depth"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)
