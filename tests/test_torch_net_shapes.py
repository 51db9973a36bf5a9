"""Net shapes beyond the default on the port's kernel path.

- A net without view directions or without an encoding marches through the
  plain ``query_points`` + ``raw2outputs`` on the card too, as in the JAX
  package: no kernel launches, and the render equals the JAX one.
- A trunk narrower than a core width (256, 512 or 1024) is zero-padded to
  the next one (``raymarch.pad_params``, ``core_width``), which is exact;
  the cores take any depth (the net's device table of bias pointers and
  skip-mask words) and any encodings that fit in shared memory (the
  wgmma cores' x_pe and d_pe chunks: the standard core's up to four and
  two, the transposed core's as many as fit). The padded weights are
  packed into the FP32 core's float32 chunks (``pack_f32_weights``) and the
  wgmma cores' bf16 chunks;
  the FP32 core's consumption of its chunks is emulated here layer by
  layer, as ``csrc/nerf_mlp.cuh`` runs it, and the chunk plans and shared
  memory of both cores are written out here from the CUDA headers
  (``_FakeMarchLibrary``), so that what the wrappers pack and refuse is
  held to them.

The CUDA kernels themselves run only on the card, where chip_smoke.py holds
them against their twins on the same nets.
"""

import jax
import numpy as np
import pytest
import torch

from bench import box_scene_params as jax_box_scene
from neuralsim_tpu import config as jcfg
from neuralsim_tpu.ops.render import render_ray_batch as jax_render_ray_batch
from neuralsim_tpu_torch import config as tcfg
from neuralsim_tpu_torch.kernels import raymarch as rm
from neuralsim_tpu_torch.models import nerf as tnerf
from neuralsim_tpu_torch.models.convert import params_from_numpy
from neuralsim_tpu_torch.models.nerf import init_nerf_params, nerf_apply, round_to
from neuralsim_tpu_torch.ops import render as trender
from neuralsim_tpu_torch.ops.encoding import positional_encoding
from tests.test_torch_render_tile import kernel_route  # noqa: F401  (a fixture)

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
# the nets the chip check also runs: 4 x 128, and 100 wide with longer
# encodings (75 and 39 channels, past the default 64 / 32 rows)
NETS = {
    "default": dict(),
    "w128x4": dict(netdepth=4, netwidth=128, netdepth_fine=4, netwidth_fine=128, skips=(2,)),
    "w100_m12_6": dict(netdepth=4, netwidth=100, netdepth_fine=4, netwidth_fine=100, skips=(2,),
                       multires=12, multires_views=6),
    # 24 deep with two skips (the cores take up to 32 layers)
    "24x256": dict(netdepth=24, netdepth_fine=24, skips=(4, 12)),
    # the reference's --netwidth 512, and a width padded to it
    "8x512": dict(netwidth=512, netwidth_fine=512),
    "4x384": dict(netdepth=4, netwidth=384, netdepth_fine=4, netwidth_fine=384, skips=(2,)),
    # longer encodings: 147 / 75 channels (three x_pe chunks of the wgmma
    # core, two d_pe chunks) and 255 / 123, the longest of the standard core
    "8x256_pe24_12": dict(multires=24, multires_views=12),
    "8x256_pe42_20": dict(multires=42, multires_views=20),
    # the widest core width (mip-NeRF 360's 1024-wide MLP), a width padded to
    # it, and a trunk past 32 layers (skip bits above 32)
    "4x1024": dict(netdepth=4, netwidth=1024, netdepth_fine=4, netwidth_fine=1024, skips=(2,)),
    "4x768": dict(netdepth=4, netwidth=768, netdepth_fine=4, netwidth_fine=768, skips=(2,)),
    "40x256": dict(netdepth=40, netdepth_fine=40, skips=(4, 20, 36)),
    # past 64 layers: skips in both 64-bit words of the skip mask
    "72x256": dict(netdepth=72, netdepth_fine=72, skips=(4, 40, 68)),
    # encodings the standard wgmma core has no room for (the transposed core)
    "4x512_pe42_20": dict(netdepth=4, netwidth=512, netdepth_fine=4, netwidth_fine=512,
                          skips=(2,), multires=42, multires_views=20),
    "4x256_pe50_24": dict(netdepth=4, netdepth_fine=4, skips=(2,), multires=50,
                          multires_views=24),
}


def _rays(rng, n):
    rays_o = (rng.randn(n, 3) * 0.02 + np.array([0, 0, 1.01])).astype(np.float32)
    rays_d = (rng.randn(n, 3) * 0.05 + np.array([0, 0, -1.0])).astype(np.float32)
    return rays_o, rays_d


def _render_both(rng, jnet, tnet, models, **render):
    """The JAX package's render_ray_batch and the port's on the same numpy
    rays and weights (test mode; rays from the pipeline's camera sphere
    toward the box, the default near and far)."""
    render = dict(n_samples=16, n_importance=16, ray_chunk=16, **render)
    rays_o, rays_d = _rays(rng, 40)
    want = jax_render_ray_batch(models, rays_o, rays_d, None, jnet,
                                jcfg.RenderConfig(**render).test_mode())
    got = trender.render_ray_batch(params_from_numpy(models, "cpu"), torch.from_numpy(rays_o),
                                   torch.from_numpy(rays_d), tnet,
                                   tcfg.RenderConfig(**render).test_mode())
    assert set(got) == set(want)
    assert float(np.asarray(want["acc_map"]).max()) > 0.5        # rays hit the box
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)


def _no_viewdirs_box(net_kw):
    """The box scene as a net without view directions: the box trunk, and
    an output head [W, 4] whose density column is the box's alpha head and
    whose rgb columns are small random weights."""
    jnet = jcfg.NeRFNetConfig(**net_kw)
    box = {k: np.array(v) for k, v in jax_box_scene(jnet, jax.random.PRNGKey(0)).items()}
    rgb = np.random.RandomState(0).randn(jnet.netwidth, 3).astype(np.float32) * 0.3
    head = np.concatenate([rgb, box["alpha_kernel"]], axis=1)
    params = {k: v for k, v in box.items()
              if k.startswith("pts_")}
    params.update(output_kernel=head, output_bias=np.zeros(4, np.float32))
    return params


SMALL = dict(netdepth=4, netwidth=32, netdepth_fine=4, netwidth_fine=32, skips=(2,))


@pytest.mark.parametrize("which", ["no_viewdirs", "identity_embed"])
def test_plain_nets_march_without_kernels_on_the_card(rng, kernel_route, which):
    """(d) With the kernel predicate forced (the card's dispatch) and
    use_pallas, a use_viewdirs=False net and an i_embed=-1 net render
    through the plain query_points + raw2outputs: no launch of any kernel,
    and the render equals the JAX package's."""
    if which == "no_viewdirs":
        net_kw = dict(SMALL, use_viewdirs=False)
        params = _no_viewdirs_box(dict(SMALL))
    else:
        net_kw = dict(SMALL, i_embed=-1)
        params = {k: np.array(v) for k, v in jax_box_scene(
            jcfg.NeRFNetConfig(**net_kw), jax.random.PRNGKey(0)).items()}
    for fn in (rm.fused_nerf_march, rm.fused_nerf_mlp_widepe, rm.fused_render_tile):
        fn.launches = 0
    tnet = tcfg.NeRFNetConfig(**net_kw)
    for override in (dict(), dict(fuse_pointgen=False), dict(fuse_compositing=True),
                     dict(reuse_coarse=True), dict(fine_fraction=0.5)):
        _render_both(rng, jcfg.NeRFNetConfig(**net_kw), tnet,
                     {"coarse": params, "fine": params}, **override)
        assert trender._kernel_route(torch.zeros(1, 3), tnet, tcfg.RenderConfig()) is False
    assert kernel_route == []
    assert (rm.fused_nerf_march.launches, rm.fused_nerf_mlp_widepe.launches,
            rm.fused_render_tile.launches) == (0, 0, 0)


def test_view_direction_nets_still_take_the_kernel(kernel_route):
    """The predicate stays true for a net with view directions and an
    encoding: (d) adds no fallback."""
    net = tcfg.NeRFNetConfig(**SMALL)
    assert trender._kernel_route(torch.zeros(1, 3), net, tcfg.RenderConfig()) is True
    assert trender._kernel_route(torch.zeros(1, 3), net,
                                 tcfg.RenderConfig(use_pallas=False)) is False


def _matmul_in_order(a, b):
    """nerf._matmul with the products summed in input-row order, one row at
    a time, as the FP32 core sums them (BLAS may block a longer K otherwise)."""
    a, b = a.float(), b.float()
    acc = torch.zeros(a.shape[0], b.shape[1])
    for i in range(b.shape[0]):
        acc = acc + a[:, i:i + 1] * b[i]
    return acc


def _encoded(net, m, seed):
    g = torch.Generator().manual_seed(seed)
    pts, dirs = torch.rand(m, 3, generator=g) * 2 - 1, torch.randn(m, 3, generator=g)
    return (positional_encoding(pts, net.multires),
            positional_encoding(dirs / dirs.norm(dim=-1, keepdim=True), net.multires_views))


def _he(params):
    """He-scaled kernels: activations of order 1 through the chain."""
    return {k: v * (6 ** 0.5 if k.endswith("kernel") else 1.0) for k, v in params.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("width", [64, 100, 128, 256, 300, 384, 512])
def test_padded_twin_is_bit_equal(monkeypatch, width, dtype):
    """(e) The twin on the weights padded to the core width (256, or 512
    past it) equals the twin on the net's own weights to the bit, with
    products summed in input order (the FP32 core's order); with BLAS
    products, within float32 rounding."""
    net = tcfg.NeRFNetConfig(netdepth=4, netwidth=width, netdepth_fine=4,
                             netwidth_fine=width, skips=(2,))
    params = _he(init_nerf_params(net, generator=torch.Generator().manual_seed(width)))
    w = rm.core_width(width)
    assert w == (256 if width <= 256 else 512)
    padded = rm.pad_params(params, net, w)
    assert padded["pts_1_kernel"].shape == (w, w)
    assert padded["pts_3_kernel"].shape == (net.input_ch + w, w)
    assert padded["views_0_kernel"].shape == (w + net.input_ch_views, w // 2)
    assert padded["rgb_kernel"].shape == (w // 2, 3) and padded["alpha_kernel"].shape == (w, 1)
    x_pe, d_pe = _encoded(net, 64, width)
    blas = (nerf_apply(params, x_pe, d_pe, net, compute_dtype=dtype),
            nerf_apply(padded, x_pe, d_pe, net, compute_dtype=dtype))
    monkeypatch.setattr(tnerf, "_matmul", _matmul_in_order)
    got = nerf_apply(padded, x_pe, d_pe, net, compute_dtype=dtype)
    want = nerf_apply(params, x_pe, d_pe, net, compute_dtype=dtype)
    assert want.abs().max() > 0.1                             # not a vacuous zero field
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(blas[1], blas[0], rtol=1e-5, atol=1e-5)
    if width == w:
        assert padded is params


def _net(name):
    return tcfg.NeRFNetConfig(**NETS[name])


def _unpermute(chunk):
    """A packed FP32-core chunk [16, N] back in column order."""
    n = chunk.shape[1]
    pos = torch.arange(n)
    cols = (pos // 4) % 16 + 16 * (4 * (pos // 64) + pos % 4)
    out = torch.empty_like(chunk)
    out[:, cols] = chunk
    return out


class _Chunks:
    """Reads a pack_f32_weights stream chunk by chunk, as the core's ring
    delivers it."""

    def __init__(self, packed):
        self.packed, self.off = packed, 0

    def next(self, n_cols):
        size = rm.F32_CHUNK_K * n_cols
        chunk = self.packed[self.off:self.off + size].reshape(rm.F32_CHUNK_K, n_cols)
        self.off += size
        return _unpermute(chunk)


def _emulate_f32_core(packed, padded, net, x_pe, d_pe, parts=1):
    """raw [M,4] as csrc/nerf_mlp.cuh's mlp_tile computes it from the packed
    chunks: x_pe and d_pe in tiles of 16-row chunks (zero rows past the
    channels), layer i reads [x_pe chunks if i == 0 or after a skip, then 16
    h chunks], the feature layer 16 h chunks, the views layer 16 feature
    chunks then the d_pe chunks; heads from the layer outputs, each summed
    over `parts` equal column blocks in block order, then its bias (the
    core's column parts: 4 or 8 at W = 1024, else 1)."""
    def tiles(a):
        rows = -(-a.shape[1] // rm.F32_CHUNK_K) * rm.F32_CHUNK_K
        a = torch.nn.functional.pad(a, (0, rows - a.shape[1]))
        return list(a.split(rm.F32_CHUNK_K, dim=1))

    def head(v, name):
        k, cols = padded[f"{name}_kernel"], v.shape[1] // parts
        out = v[:, :cols] @ k[:cols]
        for q in range(1, parts):
            out = out + v[:, q * cols:(q + 1) * cols] @ k[q * cols:(q + 1) * cols]
        return out + padded[f"{name}_bias"]

    depth = rm._depth(padded)
    width = padded["pts_0_kernel"].shape[1]
    ring = _Chunks(packed)
    x_tiles, d_tiles = tiles(x_pe), tiles(d_pe)
    h = None
    for i in range(depth + 1):
        with_x = i == 0 or (i < depth and (i - 1) in net.skips)
        acts = (x_tiles if with_x else []) + (tiles(h) if i > 0 else [])
        acc = sum(a @ ring.next(width) for a in acts)
        name = f"pts_{i}" if i < depth else "feature"
        v = acc + padded[f"{name}_bias"]
        h = torch.relu(v) if i < depth else v
        if i == depth - 1:
            alpha = head(h, "alpha")
    acc = sum(a @ ring.next(width // 2) for a in tiles(h) + d_tiles)
    v = torch.relu(acc + padded["views_0_bias"])
    rgb = head(v, "rgb")
    assert ring.off == packed.numel()                     # every chunk consumed once
    return torch.cat([rgb, alpha], dim=-1)


@pytest.mark.parametrize("name", list(NETS))
def test_f32_chunks_read_back_as_the_padded_weights(name):
    """FP32 packing: each segment's 16-row chunks, read back through the
    core's column order, are the padded kernel (zero rows past its K); the
    byte counts of both cores' packings are their chunk plans in the CUDA
    headers."""
    net = _net(name)
    params = init_nerf_params(net, generator=torch.Generator().manual_seed(3))
    width = rm.core_width(net.netwidth)
    padded = rm.pad_params(params, net, width)
    packed = rm.pack_f32_weights(padded, net)
    assert packed.dtype == torch.float32 and packed.dim() == 1
    ring = _Chunks(packed)
    for seg in rm._segments(padded, net):
        k, n = seg.shape
        got = torch.cat([ring.next(n) for _ in range(-(-k // rm.F32_CHUNK_K))])
        torch.testing.assert_close(got[:k], seg, rtol=0, atol=0)
        assert not got[k:].any()
    plan = (width, net.netdepth, len(net.skips), net.input_ch, net.input_ch_views)
    assert ring.off * 4 == packed.numel() * 4 == rm.f32_bytes(
        net.netdepth, len(net.skips), width, net.input_ch, net.input_ch_views)
    assert packed.numel() * 4 == _FakeMarchLibrary.nerf_f32_plan_bytes(*plan)
    if name == "default":
        # 136 chunks of [16][256] and 18 of [16][128] float32
        assert packed.numel() * 4 == (136 * 256 + 18 * 128) * 16 * 4 == 2_375_680
    wgmma = rm.pack_wgmma_weights(padded, net)
    assert wgmma.numel() * 2 == rm.wgmma_bytes(net.netdepth, len(net.skips), width,
                                               net.input_ch, net.input_ch_views)
    assert wgmma.numel() * 2 == _FakeMarchLibrary.nerf_wgmma_plan_bytes(*plan)


@pytest.mark.parametrize("name", list(NETS))
def test_f32_core_order_computes_the_twin(name):
    """The chunk stream consumed in the core's order gives the twin's raw
    outputs: the packing, the plan and the layer walk of nerf_mlp.cuh agree."""
    net = _net(name)
    params = _he(init_nerf_params(net, generator=torch.Generator().manual_seed(4)))
    padded = rm.pad_params(params, net, rm.core_width(net.netwidth))
    x_pe, d_pe = _encoded(net, 40, 5)
    got = _emulate_f32_core(rm.pack_f32_weights(padded, net), padded, net, x_pe, d_pe)
    want = nerf_apply(params, x_pe, d_pe, net)
    assert want.abs().max() > 0.1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# the shared memory a block of an H100 may opt into
SMEM_OPTIN = 232_448


def transposed(width, in_ch, in_ch_views):
    """Whether a bf16 net runs on the transposed wgmma core
    (csrc/nerf_mlp_wgmma.cuh ``transposed``): every 1024-wide net, a 512-wide
    one with more than four chunks of encodings, a 256-wide one with more
    than four x_pe or two d_pe chunks."""
    nx, nd = -(-in_ch // 64), -(-in_ch_views // 64)
    return width == 1024 or (width == 512 and nx + nd > 4) or (width == 256 and (nx > 4 or nd > 2))


def f32_core_bytes(tile, width, rx, rd):
    """core_bytes of csrc/nerf_mlp.cuh: the ring's two stages (16 KB, 32 KB
    on the 32-point tiles of W = 1024), the h, x and d tiles (row stride
    tile + 4), points and raw
    outputs, the heads' partial sums where the columns are split (4 parts on
    32-point tiles, 8 on 16-point tiles at W = 1024), the ring's barriers."""
    parts = 128 // tile if width == 1024 else 1
    stage = 32768 if (width, tile) == (1024, 32) else 16384
    return (2 * stage + (width + rx + rd) * (tile + 4) * 4 + 10 * tile * 4
            + (16 * parts * tile if parts > 1 else 0) + 32)


def f32_pick_tile(width, rx, rd, extra, smem=SMEM_OPTIN):
    """pick_tile of csrc/nerf_mlp.cuh: the big tile, else half of it, else 0."""
    big = 128 * 256 // width
    return next((t for t in (big, big // 2) if f32_core_bytes(t, width, rx, rd) + extra <= smem),
                0)


def f32_rows(channels):
    return -(-channels // 16) * 16


# the streaming core's pieces (csrc/nerf_mlp_stream.cuh): bytes, and ring
# stages at least and at most
STREAM_PIECE, STREAM_STAGES = 16384, (2, 8)


def stream_rows(channels, bf16):
    """tile_rows of csrc/nerf_mlp_stream.cuh: channels rounded up to whole
    pieces (64 rows in bf16, 32 in float32)."""
    k = 64 if bf16 else 32
    return -(-channels // k) * k


def stream_core_bytes(tile, width, in_ch, in_ch_views, bf16=False, stages=2):
    """launch_bytes of csrc/nerf_mlp_stream.cuh: the ring's stages of 16 KB,
    two activation tiles [W][tile], x_pe and d_pe [rows][tile] (bf16 or
    float32), in float32 two buffers of partial sums [128][tile], points,
    raw outputs and the heads' partial sums [10 + 32][tile] float32, the
    ring's barriers and the 1024 bytes of alignment."""
    esz = 2 if bf16 else 4
    rows = 2 * width + stream_rows(in_ch, bf16) + stream_rows(in_ch_views, bf16)
    return (stages * STREAM_PIECE + rows * tile * esz + (0 if bf16 else 2 * 128 * tile * 4)
            + 42 * tile * 4 + 16 * stages + 1024)


def stream_pick(width, in_ch, in_ch_views, extra, bf16=False, smem=SMEM_OPTIN):
    """pick of csrc/nerf_mlp_stream.cuh: (tile, stages), the largest of 32,
    16, 8 (and in float32 4) points whose core fits on two stages, then as
    many more stages as the rest holds, up to eight; (0, 0) when none fits."""
    lo, hi = STREAM_STAGES
    for t in (32, 16, 8, 4)[:3 if bf16 else 4]:
        need = stream_core_bytes(t, width, in_ch, in_ch_views, bf16, lo) + extra
        if need <= smem:
            return t, lo + min(hi - lo, (smem - need) // (STREAM_PIECE + 16))
    return 0, 0


def stream_pick_tile(width, in_ch, in_ch_views, extra, bf16=False, smem=SMEM_OPTIN):
    """The tile of ``stream_pick``."""
    return stream_pick(width, in_ch, in_ch_views, extra, bf16, smem)[0]


def stream_plan_bytes(width, depth, n_skips, in_ch, in_ch_views, bf16):
    """nerf_stream_plan_bytes of csrc/nerf_mlp_stream.cuh: every layer's
    column blocks of 128 times its input chunks, 16 KB a piece."""
    k = 64 if bf16 else 32
    nx, nd = stream_rows(in_ch, bf16) // k, stream_rows(in_ch_views, bf16) // k
    nh = width // k
    blocks = -(-width // 128)
    pieces = (blocks * (nx + nh * (depth - 1) + nx * n_skips + nh)
              + -(-width // 2 // 128) * (nh + nd))
    return pieces * STREAM_PIECE


class _FakeMarchLibrary:
    """Stands in for the built nerf_march library and records each call of
    the C entry. Its limits are parameters (the defaults those of the CUDA
    headers); its chunk plans and shared-memory sizes are the formulas of
    csrc/nerf_mlp.cuh (FP32 core: ring stages of 16 KB, 32 KB on the
    32-point tiles of W = 1024, of 16, 8 and 8 rows on the big tiles; the
    plan's bytes do not depend on the stage; smallest tile 64 points at
    W = 256, 32 at 512, 16 at 1024; ``f32_core_bytes``) and
    csrc/nerf_mlp_wgmma.cuh (64-row
    chunks; the standard core: three ring stages at W = 256 with at most two
    x_pe chunks, else two; A tiles per warpgroup at W = 256, shared at 512;
    the transposed core: two rings of four pieces of min(W/2, 128) rows
    (two at W = 256), h and the encodings in [32][64] chunks of 4 KB, a
    6 KB scratch) and
    csrc/nerf_mlp_stream.cuh (``stream_core_bytes``), written out here.
    ``calls`` records the calls of the FP32 / wgmma entry,
    ``stream_calls`` those of the streaming core's."""

    def __init__(self, width=1024, smem_optin=SMEM_OPTIN):
        self.limits = (width, smem_optin)
        self.calls = []
        self.stream_calls = []

    def nerf_width(self):
        return self.limits[0]

    def nerf_smem_optin(self):
        return self.limits[1]

    @staticmethod
    def nerf_f32_plan_bytes(width, depth, n_skips, in_ch, in_ch_views):
        stage = 32768 if width == 1024 else 16384
        kc = stage // (4 * width)
        nx, nd = (f32_rows(c) // kc for c in (in_ch, in_ch_views))
        h = width // kc
        n_wide = nx + h * (depth - 1) + nx * n_skips + h
        return n_wide * stage + (h + nd) * stage // 2

    @staticmethod
    def nerf_wgmma_plan_bytes(width, depth, n_skips, in_ch, in_ch_views):
        nx, nd, h = -(-in_ch // 64), -(-in_ch_views // 64), width // 64
        n_wide = nx + h * (depth - 1) + nx * n_skips + h
        return n_wide * width * 128 + (h + nd) * (width // 2) * 128

    @staticmethod
    def nerf_f32_smem_bytes(width, in_ch, in_ch_views):
        return f32_core_bytes(128 * 256 // width // 2, width, f32_rows(in_ch),
                              f32_rows(in_ch_views))

    def nerf_f32_launch_bytes(self, width, in_ch, in_ch_views, tile):
        rx, rd = f32_rows(in_ch), f32_rows(in_ch_views)
        tile.contents.value = f32_pick_tile(width, rx, rd, 0, self.limits[1])
        return f32_core_bytes(tile.contents.value, width, rx, rd) if tile.contents.value else 0

    @staticmethod
    def nerf_wgmma_smem_bytes(width, in_ch, in_ch_views):
        nx, nd = -(-in_ch // 64), -(-in_ch_views // 64)
        if transposed(width, in_ch, in_ch_views):
            piece, stages = min(width // 2, 128) * 128, 2 if width == 256 else 4
            return 2 * stages * piece + (width // 64 + nx + nd) * 4096 + 6144 + 1024
        stages = 3 if width == 256 and nx <= 2 else 2
        tiles = (2 if width == 256 else 1) * (nx + width // 64 + nd) * 8192
        return stages * width * 128 + tiles + 2 * stages * 8 + 1024

    @staticmethod
    def nerf_wgmma_last_launch(info):
        # the 8x512 net's bf16 launch on the H100: clusters of 2 blocks of
        # 384 threads, 66 active clusters
        for i, v in enumerate((2, 132, 66, 384)):
            info[i] = v
        return 0

    @staticmethod
    def nerf_stream_plan_bytes(width, depth, n_skips, in_ch, in_ch_views, bf16):
        return stream_plan_bytes(width, depth, n_skips, in_ch, in_ch_views, bf16)

    @staticmethod
    def nerf_stream_smem_bytes(width, in_ch, in_ch_views, bf16):
        return stream_core_bytes(8 if bf16 else 4, width, in_ch, in_ch_views, bf16)

    def nerf_stream_launch_bytes(self, width, in_ch, in_ch_views, bf16, tile, stages):
        t, n = stream_pick(width, in_ch, in_ch_views, 0, bf16, self.limits[1])
        tile.contents.value, stages.contents.value = t, n
        return stream_core_bytes(t, width, in_ch, in_ch_views, bf16, n) if t else 0

    def nerf_march(self, *args):
        self.calls.append(args)
        return 0

    def nerf_march_stream(self, *args):
        self.stream_calls.append(args)
        return 0


@pytest.fixture
def fake_march(monkeypatch):
    lib = _FakeMarchLibrary()
    monkeypatch.setattr(rm, "uses_kernel", lambda t: True)
    monkeypatch.setattr(rm, "_library", lambda name: lib)
    monkeypatch.setattr(rm, "_run", lambda fn, device, what, *args: fn(*args, None))
    return lib


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["w128x4", "w100_m12_6", "24x256", "8x512", "4x384",
                                  "8x256_pe42_20", "4x1024", "4x768", "40x256", "72x256",
                                  "4x512_pe42_20", "4x256_pe50_24"])
def test_march_launch_pads_and_packs(fake_march, name, dtype):
    """(e) On the kernel route a net reaches the C entry padded to its core
    width (256, 512 or 1024): every weight pointer is the padded tensor
    (bf16 kernels rounded), the packed pointer is the chunk stream of the
    core the dtype runs, the table holds the padded biases' pointers and the
    skip mask's 64-bit words (the 40-deep net's skip after layer 36), and
    the width, depth, skip count and encodings' channel counts are the
    net's."""
    net = _net(name)
    params = init_nerf_params(net, generator=torch.Generator().manual_seed(6))
    n, s = 5, 7
    rays = [torch.rand(n, 3), torch.rand(n, 3), torch.rand(n, 3), torch.rand(n, s)]
    rm.fused_nerf_march.launches = 0
    with torch.no_grad():
        rm.fused_nerf_march(params, *rays, net, compute_dtype=dtype)
    (args,) = fake_march.calls
    assert rm.fused_nerf_march.launches == 1
    assert len(args) == len(rm._ARGTYPES["nerf_march"][1])
    ptrs, table, width, depth, n_skips, in_ch, in_ch_views, bf16, packed = args[6:15]
    assert width == rm.core_width(net.netwidth) == min(
        w for w in (256, 512, 1024) if w >= net.netwidth)
    assert (depth, n_skips, in_ch, in_ch_views) == (
        net.netdepth, len(net.skips), net.input_ch, net.input_ch_views)
    assert bf16 == int(dtype == torch.bfloat16)
    weights, image, words = rm._packed_weights(params, net, depth, bool(bf16), fake_march,
                                               "test")
    assert packed == image.data_ptr() and list(ptrs) == [w.data_ptr() for w in weights]
    assert table == words.data_ptr() and words.dtype == torch.int64
    assert words[:depth + 4].tolist() == [w.data_ptr() for w in weights[1::2]]
    mask = sum(1 << sk for sk in net.skips)
    assert [w % 2 ** 64 for w in words[depth + 4:].tolist()] == [
        (mask >> (64 * i)) % 2 ** 64 for i in range(-(-depth // 64))]
    padded = {k: round_to(v, dtype) if k.endswith("kernel") else v
              for k, v in rm.pad_params(params, net, width).items()}
    for key, w in zip(rm.param_keys(depth), weights):
        torch.testing.assert_close(w, padded[key], rtol=0, atol=0, msg=key)
    want = rm.pack_wgmma_weights(padded, net) if bf16 else rm.pack_f32_weights(padded, net)
    torch.testing.assert_close(image, want, rtol=0, atol=0)


def test_kernels_refuse_what_the_cores_do_not_take(fake_march):
    """What no core takes raises NotImplementedError, naming the limit and
    the bytes, before any launch: a net past the JAX kernel's own VMEM
    budget (a 4-deep 2048-wide trunk in float32, ~153 MB of double-buffered
    weights against 100 MiB) and a net whose smallest streaming-core tile
    does not fit the block's shared memory (multires 2400: 14,403 x_pe
    channels). The 2048-wide net in bf16 (~77 MB) launches, on the streaming
    core; so does every net the FP32 and wgmma cores have no room for
    (tests/test_torch_stream_core.py). Depth and multires themselves have no
    limit (the other tests of this file and tests/test_torch_wide_nets.py
    take 72 layers and multires 130)."""
    rays = [torch.rand(3, 3), torch.rand(3, 3), torch.rand(3, 3), torch.rand(3, 4)]
    cases = {r"declares \d+ bytes of VMEM blocks in float32 in the JAX kernel, past its "
             r"budget of 104857600 bytes": (dict(netwidth=2048, netwidth_fine=2048),
                                            torch.float32),
             "needs 278208 bytes of shared memory per block on the streaming core's smallest "
             "tile in float32": (dict(multires=2400), torch.float32)}
    for message, (kw, dtype) in cases.items():
        net = tcfg.NeRFNetConfig(**{**dict(netdepth=4, netdepth_fine=4, skips=(2,)), **kw})
        params = init_nerf_params(net, generator=torch.Generator().manual_seed(7))
        with pytest.raises(NotImplementedError, match=message):
            rm.fused_nerf_march(params, *rays, net, compute_dtype=dtype)
    assert fake_march.calls == [] and fake_march.stream_calls == []
    net = tcfg.NeRFNetConfig(netdepth=4, netdepth_fine=4, skips=(2,), netwidth=2048,
                             netwidth_fine=2048)
    params = init_nerf_params(net, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        rm.fused_nerf_march(params, *rays, net, compute_dtype=torch.bfloat16)
    assert fake_march.calls == [] and len(fake_march.stream_calls) == 1


@pytest.mark.parametrize("name", ["w128x4", "w100_m12_6", "8x512", "24x256"])
def test_plain_render_of_narrow_nets_matches_jax(rng, name):
    """The port's plain render of a 4x128 net, of a 100-wide net with
    multires 12 / multires_views 6, of an 8x512 net and of a 24-deep net
    with two skips (box scene) equals the JAX package's."""
    jnet, tnet = jcfg.NeRFNetConfig(**NETS[name]), _net(name)
    box = {k: np.array(v) for k, v in jax_box_scene(jnet, jax.random.PRNGKey(0)).items()}
    _render_both(rng, jnet, tnet, {"coarse": box, "fine": box})

