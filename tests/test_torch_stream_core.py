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
  multiple of 128 (exact), its packed pieces of 16 KB (bf16 in the
  swizzled image of a wgmma A operand, float32 row-major), the net's
  device table; the cases that no core took before now launch on it
  (moved from test_kernels_refuse_what_the_cores_do_not_take). The pieces
  read back, in the core's order, as the padded weights (bf16-rounded in
  bf16) with zeros past every segment's rows and every layer's columns,
  in the library's byte count; the launch plans (tile, ring stages, the
  render tile's rays and segments) fit a block.
- Its arithmetic, emulated from the pieces in its order (bf16: each 64-row
  chunk's products summed in float32, chunk after chunk; float32: each
  output the sum over rows 0-15 of every 32-row chunk plus the sum over
  rows 16-31, in order; the heads summed per thread, over the lanes that
  share a point and then over the warps in order), gives the twin.
- Its ring and its clusters (of 2 on 32-point tiles, of 1 on smaller
  ones): the ring's barriers in random interleavings stream every piece to
  every block at 2, 3 and 8 stages, and the blocks of a cluster walk the
  same tile slots (the render tile's sub-tiles included).
- The twins of fused_nerf_march and fused_render_tile on a 4x1100 net
  (float32) equal the JAX kernels in interpret mode (the render tile on the
  box scene only: the interpret render tile gives NaN elsewhere).

The CUDA kernels themselves run only on the card, where chip_smoke.py holds
them against their twins on 8x1152, 8x1664, 8x256 with multires 75 and
8x1024 with multires 60 / 20.
"""

import ctypes

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
    SMEM_OPTIN,
    STREAM_PIECE,
    _encoded,
    _FakeMarchLibrary,
    _he,
    _matmul_in_order,
    stream_core_bytes,
    stream_pick,
    stream_pick_tile,
    stream_plan_bytes,
    stream_rows,
)
from tests.test_torch_wgmma_cluster import (
    POINT_BYTES,
    RAY_BYTES,
    _gcd_rays,
    block_tiles,
    cluster_grid,
    simulate_cluster_ring,
    slot_walk,
    slots,
)
from tests.test_torch_wide_nets import TOL, _jax_params, _piece_matrix, _rays, _t

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
    multiple of 128; the same encodings in the other dtype keep their core."""
    kw, dtypes = STREAMED[name]
    net = TNet(**kw)
    lib = _FakeMarchLibrary()
    for dtype in ("float32", "bfloat16"):
        bf16 = dtype == "bfloat16"
        core = rm.core_for(net, net.netwidth, bf16, lib)
        if dtype in dtypes:
            assert core == rm.STREAM_CORE
            assert rm.padded_width(core, net.netwidth) == -(-net.netwidth // 128) * 128
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
    padded to a multiple of 128 (bf16 kernels rounded), the packed pointer
    the core's pieces of the padded weights in the dtype, the net's device
    table, and the net's depth, skips and encodings."""
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
    weights, image, words = rm._packed_weights(params, net, 4, bf16, fake_stream, "test",
                                               rm.STREAM_CORE)
    for args, first in zip(fake_stream.stream_calls, (6, 4)):
        ptrs, words_ptr, w, depth, skips, in_ch, in_ch_views, b, packed = args[first:first + 9]
        assert (w, depth, skips, in_ch, in_ch_views, b) == (width, 4, 1, net.input_ch,
                                                            net.input_ch_views, int(bf16))
        assert list(ptrs) == [t.data_ptr() for t in weights]
        assert packed == image.data_ptr() and words_ptr == words.data_ptr()
    padded = {k: round_to(v, dtype) if k.endswith("kernel") else v
              for k, v in rm.pad_params(params, net, width).items()}
    for key, t in zip(rm.param_keys(4), weights):
        torch.testing.assert_close(t, padded[key], rtol=0, atol=0, msg=key)
    torch.testing.assert_close(image, rm.pack_stream_weights(padded, net, bf16), rtol=0, atol=0)


# the streaming core's launch plans on the H100 (232,448 bytes a block):
# {(net, dtype): (tile, ring stages)}
PLANS = {("8x1152", "float32"): (16, 3), ("8x1152", "bfloat16"): (32, 4),
         ("8x1664", "bfloat16"): (16, 7), ("8x256_pe75", "float32"): (32, 3),
         ("8x1024_pe60_20", "bfloat16"): (32, 3)}


def stream_tile_plan(s, width, in_ch, in_ch_views, bf16, smem=SMEM_OPTIN):
    """render_tile.cu plan_stream: (sub-tile, ring stages, rays per group,
    samples per segment, shared bytes)."""
    tile, _ = stream_pick(width, in_ch, in_ch_views, POINT_BYTES + RAY_BYTES, bf16, smem)
    room = smem - stream_core_bytes(tile, width, in_ch, in_ch_views, bf16, 2)
    rays, seg = _gcd_rays(s, tile, room), s
    if rays < 1:
        fit = 0 if room < RAY_BYTES else (room - RAY_BYTES) // POINT_BYTES
        rays, seg = 1, (fit // tile * tile if fit >= tile else fit)
    group = rays * (seg * POINT_BYTES + RAY_BYTES)
    stages = 2 + min(6, (room - group) // (STREAM_PIECE + 16))
    return tile, stages, rays, seg, stream_core_bytes(tile, width, in_ch, in_ch_views, bf16,
                                                      stages) + group


def test_stream_launch_plans_fit_shared_memory():
    """The streaming core's plans for the chip's nets (PLANS): the point
    kernels' tile and ring stages (the largest tile whose two [W][tile]
    activation tiles fit beside two stages, then up to eight stages), the
    render tile's at S = 16, 64, 192 and 2048 (its rays' raw field beside
    the core: whole rays, or one ray in segments of whole sub-tiles), every
    one within a block's shared memory; the smallest tile's bytes (what the
    wrapper checks) and the fake library's queries agree with the header's
    formula; a 2048-wide bf16 trunk takes 16-point tiles."""
    lib = _FakeMarchLibrary()
    for (name, dtype), want in PLANS.items():
        net = TNet(**STREAMED[name][0])
        bf16 = dtype == "bfloat16"
        w = rm.stream_width(net.netwidth)
        tile, stages = stream_pick(w, net.input_ch, net.input_ch_views, 0, bf16)
        assert (tile, stages) == want, (name, dtype)
        assert stream_core_bytes(tile, w, net.input_ch, net.input_ch_views, bf16,
                                 stages) <= SMEM_OPTIN
        assert stages == 8 or stream_core_bytes(tile, w, net.input_ch, net.input_ch_views, bf16,
                                                stages + 1) > SMEM_OPTIN
        ints = [ctypes.c_int() for _ in range(2)]
        assert lib.nerf_stream_launch_bytes(w, net.input_ch, net.input_ch_views, int(bf16),
                                            *map(ctypes.pointer, ints)) == stream_core_bytes(
            tile, w, net.input_ch, net.input_ch_views, bf16, stages)
        assert [i.value for i in ints] == [tile, stages]
        assert lib.nerf_stream_smem_bytes(w, net.input_ch, net.input_ch_views, int(bf16)) == \
            stream_core_bytes(8 if bf16 else 4, w, net.input_ch, net.input_ch_views, bf16, 2)
        for s in (16, 64, 192, 2048):
            t, n, rays, seg, smem = stream_tile_plan(s, w, net.input_ch, net.input_ch_views,
                                                     bf16)
            assert t == tile and 2 <= n <= stages and rays >= 1 and 1 <= seg <= s
            assert smem <= SMEM_OPTIN
            assert seg == s or seg % t == 0
    assert stream_pick_tile(2048, 63, 27, 0, True) == 16


# ------------------------------------------------------- the packed pieces --

def _pieces(image, bf16):
    """The pieces of a pack_stream_weights image in order, as [rows,
    columns] matrices: bf16 [64 inputs, 128 columns] (the swizzled [128][64]
    image undone), float32 [32 inputs, 128 columns]."""
    step = STREAM_PIECE // image.element_size()
    for off in range(0, image.numel(), step):
        if bf16:
            yield _piece_matrix(image, 2 * off, STREAM_PIECE).t()
        else:
            yield image[off:off + step].reshape(32, 128)


def _read_back(image, segments, bf16):
    """The layers' kernels as the core reads them from the pieces: for each
    layer ([K, N] segments), its column blocks of 128, each segment's rows
    in chunks (64 in bf16, 32 in float32). Returns each segment padded to
    whole chunks and column blocks, and checks that the image holds nothing
    more."""
    rows = 64 if bf16 else 32
    pieces = _pieces(image, bf16)
    out = []
    for segs in segments:
        n = -(-segs[0].shape[1] // 128) * 128
        got = [torch.zeros(-(-g.shape[0] // rows) * rows, n) for g in segs]
        for c0 in range(0, n, 128):
            for g in got:
                for k0 in range(0, g.shape[0], rows):
                    g[k0:k0 + rows, c0:c0 + 128] = next(pieces)
        out.append(got)
    assert next(pieces, None) is None
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["3x1100_skip", "8x256_pe75", "4x1088_pe60_20"])
def test_stream_pieces_read_back_as_the_padded_weights(name, dtype):
    """pack_stream_weights read back piece by piece in the core's order
    equals each layer's padded kernel (bf16-rounded in bf16), with zeros
    past every segment's rows and every layer's columns (the views layer's
    W/2 up to a whole column block), in the byte count of the library's
    plan (tile_pieces x 16 KB)."""
    kw = {"3x1100_skip": dict(netdepth=3, netwidth=1100, skips=(0,)),
          "8x256_pe75": dict(multires=75),
          "4x1088_pe60_20": dict(netdepth=4, netwidth=1088, skips=(2,), multires=60,
                                 multires_views=20)}[name]
    net = TNet(**kw)
    bf16 = dtype == torch.bfloat16
    params = init_nerf_params(net, generator=torch.Generator().manual_seed(13))
    width = rm.stream_width(net.netwidth)
    padded = {k: round_to(v, dtype) if k.endswith("kernel") else v
              for k, v in rm.pad_params(params, net, width).items()}
    image = rm.pack_stream_weights(padded, net, bf16)
    assert image.dtype == dtype
    assert image.numel() * image.element_size() == stream_plan_bytes(
        width, net.netdepth, len(set(net.skips)), net.input_ch, net.input_ch_views, bf16)
    segments = rm._layer_segments(padded, net)
    for segs, got in zip(segments, _read_back(image, segments, bf16)):
        for want, g in zip(segs, got):
            k, n = want.shape
            torch.testing.assert_close(g[:k, :n], want.to(torch.float32), rtol=0, atol=0)
            assert not g[k:].any() and not g[:, n:].any()


def _emulate_stream_core(image, padded, net, x_pe, d_pe, tile, bf16):
    """The streaming core's MLP from its pieces, in its order, on tiles of
    `tile` points: bf16, each 64-row chunk's products summed in float32 and
    added chunk after chunk; float32, each output (its sum over rows 0-15
    of every 32-row chunk, in order) + (its sum over rows 16-31); then the
    bias, ReLU and the bf16 rounding. The heads: each thread's columns in
    column-block order, then the lanes that share a point (a butterfly),
    then the warps in order (mlp_bf16 / mlp_f32)."""
    width = padded["pts_0_kernel"].shape[1]
    depth = rm._depth(padded)
    cd = torch.bfloat16 if bf16 else torch.float32
    rows = 64 if bf16 else 32
    kernels = [torch.cat(g) for g in _read_back(image, rm._layer_segments(padded, net), bf16)]
    m = x_pe.shape[0]

    def pad_rows(a):
        return torch.nn.functional.pad(a, (0, -a.shape[1] % rows))

    def products(acts, w):
        a = torch.cat([pad_rows(x) for x in acts], dim=1)
        if bf16:
            acc = torch.zeros(m, w.shape[1])
            for k0 in range(0, a.shape[1], 64):
                acc = acc + a[:, k0:k0 + 64] @ w[k0:k0 + 64]
            return acc
        halves = [torch.zeros(m, w.shape[1]), torch.zeros(m, w.shape[1])]
        for k in range(a.shape[1]):
            halves[k % 32 // 16] = halves[k % 32 // 16] + a[:, k:k + 1] * w[k]
        return halves[0] + halves[1]

    def finish(acc, bias, relu):
        v = acc + bias
        return round_to(torch.relu(v) if relu else v, cd)

    def head(v, k, b):
        """[M, n] values times the head kernel [n, c] in the core's order."""
        n = v.shape[1]
        vw = v[:, :, None] * k[None]                     # [M, n, c]
        if bf16:
            # warp 4g + q, lane 4i + r: columns 128 cb + 64 g + 16 q + i + 8 hi
            sums = torch.zeros(m, 2, 4, 8, k.shape[1])
            for c0 in range(0, n, 128):
                for g in range(2):
                    if c0 + 64 * g >= n:
                        continue
                    for hi in range(2):
                        cols = (c0 + 64 * g + 16 * torch.arange(4)[:, None]
                                + torch.arange(8)[None, :] + 8 * hi)
                        sums[:, g] = sums[:, g] + vw[:, cols]
            for step in (1, 2, 4):                       # xor 4, 8, 16 over lane / 4
                sums = sums + sums[:, :, :, torch.arange(8) ^ step]
            part = sums[:, :, :, 0].reshape(m, 8, -1)
            out = part[:, 0]
            for w in range(1, 8):
                out = out + part[:, w]
            return out + b
        pt = min(tile, 8)
        slots_ = 128 // (tile // pt)
        c = 128 // slots_
        sums = torch.zeros(m, slots_, k.shape[1])
        for c0 in range(0, n, 128):
            for j in range(c):
                cols = c0 + torch.arange(slots_) * c + j
                ok = cols < n
                sums[:, ok] = sums[:, ok] + vw[:, cols[ok]]
        lanes = sums.reshape(m, slots_ // 32, 32, -1)
        for step in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[:, :, torch.arange(32) ^ step]
        part = lanes[:, :, 0]                            # [M, warps of the point's group, c]
        out = part[:, 0]
        for w in range(1, part.shape[1]):
            out = out + part[:, w]
        return out + b

    x_pe, d_pe = round_to(x_pe, cd), round_to(d_pe, cd)
    h = None
    for i in range(depth + 1):
        with_x = i == 0 or (i < depth and (i - 1) in net.skips)
        acts = ([x_pe] if with_x else []) + ([h] if i > 0 else [])
        name = f"pts_{i}" if i < depth else "feature"
        h = finish(products(acts, kernels[i])[:, :width], padded[f"{name}_bias"], i < depth)
        if i == depth - 1:
            alpha = head(h, padded["alpha_kernel"], padded["alpha_bias"])
    views = finish(products([h, d_pe], kernels[depth + 1])[:, :width // 2],
                   padded["views_0_bias"], True)
    rgb = head(views, padded["rgb_kernel"], padded["rgb_bias"])
    return torch.cat([rgb, alpha], -1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_streaming_core_order_computes_the_twin(dtype):
    """A 3-deep net of 1100 (padded to 1152) with a skip, emulated from its
    launch's pieces in the core's order on 16-point tiles, equals the twin
    (float32: 1e-5; bf16: the padding and the order change no rounding of
    a product, but a reordered float32 sum may land on the other side of a
    bf16 boundary, so at the bf16 tolerance 2e-2)."""
    net = TNet(netdepth=3, netwidth=1100, netdepth_fine=3, netwidth_fine=1100, skips=(0,))
    params = _he(init_nerf_params(net, generator=torch.Generator().manual_seed(11)))
    bf16 = dtype == torch.bfloat16
    weights, image, _ = rm._packed_weights(params, net, 3, bf16, _FakeMarchLibrary(), "test",
                                           rm.STREAM_CORE)
    padded = dict(zip(rm.param_keys(3), weights))
    x_pe, d_pe = _encoded(net, 8, 3)
    got = _emulate_stream_core(image, padded, net, x_pe, d_pe, 16, bf16)
    want = nerf_apply(params, x_pe, d_pe, net, compute_dtype=dtype)
    assert want.abs().max() > 0.1
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


# ----------------------------------------- the ring and the clusters of 2 --

def stream_layer_pieces(width, depth, skips, in_ch, in_ch_views, bf16):
    """Pieces of each layer of a tile, in the core's order (tile_pieces of
    the header, layer by layer)."""
    k = 64 if bf16 else 32
    nx, nd = stream_rows(in_ch, bf16) // k, stream_rows(in_ch_views, bf16) // k
    nh, blocks, views = width // k, -(-width // 128), -(-width // 2 // 128)
    return ([blocks * nx] + [blocks * (nh + (nx if (i - 1) in skips else 0))
                             for i in range(1, depth)] + [blocks * nh, views * (nh + nd)])


def stream_cluster(tile):
    """cluster_for of csrc/nerf_mlp_stream.cuh: 2 blocks on 32-point tiles,
    else 1."""
    return 2 if tile == 32 else 1


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n_stages", [2, 3, 8])
@pytest.mark.parametrize("cluster", [1, 2])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_stream_ring_streams_every_piece_to_both_blocks(bf16, cluster, n_stages, seed):
    """PieceRing is McRing's protocol over 2-8 stages in clusters of 1 or 2:
    in random interleavings of the producers, the copies and the 8 consumer
    warps of each block, no block stalls for good and every warp reads every
    piece of a 2-deep 256-wide net (with its skip and views layer) in order,
    from a stage holding every part of that piece."""
    layers = stream_layer_pieces(256, 2, (0,), 63, 27, bf16)
    assert sum(layers) * STREAM_PIECE == stream_plan_bytes(256, 2, 1, 63, 27, bf16)
    tiles = 2
    reads, phases = simulate_cluster_ring(cluster, n_stages, layers, tiles, seed)
    total = sum(layers) * tiles
    for warp_reads in reads:
        assert [c for c, _ in warp_reads] == list(range(total))
        assert all(parts == (c,) * cluster for c, parts in warp_reads)
    assert all(row == phases[0] for row in phases)


@pytest.mark.parametrize("active", (66, 7, 1))
@pytest.mark.parametrize("tile", [32, 16, 8, 4])
@pytest.mark.parametrize("points", [1, 5, 31, 33, 1000, 48048, 8192 * 64 + 3])
def test_stream_point_kernels_run_each_tile_once_in_equal_slots(points, tile, active):
    """nerf_march.cu and nerf_mlp.cu on the streaming core (clusters of 2
    on 32-point tiles, of 1 on smaller ones): block b runs tiles b, b +
    grid, ... for Core::slots slots; every tile runs once, the blocks of a
    cluster take the same number of slots (so the same pieces), and a
    masked slot's first point stays below total + 2 * 32, inside the
    entries' int range."""
    cl = stream_cluster(tile)
    n_tiles = -(-points // tile)
    grid = cluster_grid(n_tiles, cl, active)
    runs = np.zeros(n_tiles, np.int32)
    for c in range(grid // cl):
        per_block = [slots(cl * c + r, n_tiles, grid, cl) for r in range(cl)]
        assert len(set(per_block)) == 1 and per_block[0] >= 1
        for r in range(cl):
            for k in range(per_block[r]):
                t = cl * c + r + k * grid
                if t < n_tiles:
                    runs[t] += 1
                else:
                    assert t * tile < points + 2 * 32
    assert (runs == 1).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [16, 64, 192, 2048])
@pytest.mark.parametrize("n_rays", [1, 3, 131, 1001])
def test_stream_render_tile_runs_each_sub_tile_once_in_equal_slots(n_rays, s, dtype):
    """render_tile.cu on the streaming core (8x1152's plan in each dtype:
    32-point sub-tiles in clusters of 2 in bf16, 16-point ones in clusters
    of 1 in float32): the blocks of a cluster walk the most sub-tiles of
    them, masked after their own; every sub-tile of every group and segment
    runs once and each segment composites once."""
    net = TNet(**STREAMED["8x1152"][0])
    tile, _, rays, seg, _ = stream_tile_plan(s, rm.stream_width(net.netwidth), net.input_ch,
                                             net.input_ch_views, dtype == "bfloat16")
    cl = stream_cluster(tile)
    groups = -(-n_rays // rays)
    grid = cluster_grid(groups, cl, 66)
    seen = {}
    for c in range(grid // cl):
        walks = [block_tiles(cl * c + r, n_rays, s, rays, seg, tile, grid) for r in range(cl)]
        most = max(len(w) for w in walks)
        for r, w in enumerate(walks):
            subtiles, composites = slot_walk(cl * c + r, most, len(w), n_rays, s, rays, seg,
                                             tile, grid)
            assert subtiles == w
            assert [(g, s0) for g, s0, _ in composites] == sorted({(g, s0) for g, s0, _ in w})
            for key in w:
                seen[key] = seen.get(key, 0) + 1
    want = sum(-(-min(rays, n_rays - g * rays) * min(seg, s - s0) // tile)
               for g in range(groups) for s0 in range(0, s, seg))
    assert len(seen) == want and set(seen.values()) == {1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_padding_to_a_multiple_of_64_is_exact(monkeypatch, dtype):
    """The twin on the streaming core's padded weights (1100 -> 1152, a
    multiple of 128 and so of 64) equals the twin on the net's own to the
    bit with products summed in input order, in both dtypes."""
    net = TNet(netdepth=3, netwidth=1100, netdepth_fine=3, netwidth_fine=1100, skips=(1,))
    params = _he(init_nerf_params(net, generator=torch.Generator().manual_seed(12)))
    padded = rm.pad_params(params, net, rm.stream_width(1100))
    assert padded["pts_2_kernel"].shape == (net.input_ch + 1152, 1152)
    assert padded["views_0_kernel"].shape == (1152 + net.input_ch_views, 576)
    x_pe, d_pe = _encoded(net, 16, 5)
    monkeypatch.setattr(tnerf, "_matmul", _matmul_in_order)
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
