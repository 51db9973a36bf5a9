"""The net shapes of the widest cores: trunks of 1024 (and 768, padded to
it), the transposed wgmma core's piece plan, and the render tile at any
number of samples per ray.

- Each plain twin on 4x1024 and 4x768 nets is held against the JAX
  package's Pallas kernel in interpret mode (kernels 1, 2, 4 and 5 on a few
  hundred points; the render tile on the box scene, where the interpret
  kernel gives no NaN).
- Zero-padding 768 to 1024 is exact, in both dtypes, with products summed in
  input order (the FP32 core's order).
- The transposed wgmma core (``csrc/nerf_mlp_wgmma.cuh``: W = 1024, and
  W = 256 / 512 with encodings the standard core has no room for) streams
  each warpgroup's share of the packed chunks through a ring of its own
  (``Ring<2, true>``): its plan and piece offsets are written out here from
  the header, and the MLP computed from those pieces in the core's order
  gives the twin.
- The FP32 core at W = 1024 splits a layer's columns over its half-warps
  (``Split`` in ``csrc/nerf_mlp.cuh``: 4 quarters on 32-point tiles, 8
  eighths on 16-point tiles): its lane map is written out here and covers
  every (point, column) once, each part's packed positions read back as its
  block of columns, the MLP with the heads summed in the kernel's part order
  gives the twin, and its launch plans (tile, the render tile's rays and
  segments) fit a block's shared memory.
- The render tile composites a ray that does not fit its block's shared
  memory in segments, carrying the transmittance and sums across them:
  emulated here as ``csrc/render_tile.cu`` runs it, it equals raw2outputs.

The CUDA kernels themselves run only on the card, where chip_smoke.py holds
them against their twins on the same nets.
"""

import ctypes
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import box_scene_params as jax_box_scene
from neuralsim_tpu.config import NeRFNetConfig as JNet
from neuralsim_tpu.kernels import raymarch as jmarch
from neuralsim_tpu.models.nerf import init_nerf_params as jax_init
from neuralsim_tpu.ops import encoding as jenc
from neuralsim_tpu.ops.volume import stratified_z_vals
from neuralsim_tpu_torch.config import NeRFNetConfig as TNet
from neuralsim_tpu_torch.kernels import raymarch as rm
from neuralsim_tpu_torch.models import nerf as tnerf
from neuralsim_tpu_torch.models.nerf import init_nerf_params, nerf_apply, round_to
from neuralsim_tpu_torch.ops.volume import raw2outputs
from tests.test_torch_net_shapes import (
    NETS,
    SMEM_OPTIN,
    _emulate_f32_core,
    _encoded,
    _FakeMarchLibrary,
    _he,
    _matmul_in_order,
    _unpermute,
    f32_core_bytes,
    f32_pick_tile,
    f32_rows,
    transposed,
)

torch.set_num_threads(2)

# float32 on both sides: PE + a 7-matmul chain of width 1024
TOL = dict(rtol=1e-4, atol=1e-4)
WIDE = {"4x1024": NETS["4x1024"], "4x768": NETS["4x768"]}


def _jax_params(kw, seed):
    return {k: np.array(v) for k, v in jax_init(jax.random.PRNGKey(seed), JNet(**kw)).items()}


def _t(params, *arrays):
    return ({k: torch.from_numpy(v) for k, v in params.items()},
            *[torch.from_numpy(np.array(a, np.float32)) for a in arrays])


def _points(rng, m):
    pts = (0.15 * rng.randn(m, 3)).astype(np.float32)
    dirs = rng.randn(m, 3).astype(np.float32)
    return pts, dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)


def _rays(rng, n, s, far=0.6):
    rays_o = rng.randn(n, 3)
    rays_o = (0.3 * rays_o / np.linalg.norm(rays_o, axis=-1, keepdims=True)).astype(np.float32)
    rays_d = (-rays_o / 0.3 * 1.3 + 0.05 * rng.randn(n, 3)).astype(np.float32)
    vd = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    z = np.array(stratified_z_vals(None, n, s, 0.05, far, perturb=False))
    return rays_o, rays_d, vd, z


@pytest.mark.parametrize("name", list(WIDE))
@pytest.mark.parametrize("kernel", ["march", "widepe", "pe", "encoded"])
def test_twins_match_pallas_interpret_on_wide_nets(rng, name, kernel):
    """Kernels 1, 2, 5 and 4 on a 4x1024 net and on a 4x768 net (which the
    port pads to 1024), random weights, float32: the port's twin against
    the JAX kernel in interpret mode."""
    kw = WIDE[name]
    jnet, tnet = JNet(**kw), TNet(**kw)
    params = _jax_params(kw, 3)
    if kernel == "march":
        o, d, vd, z = _rays(rng, 20, 16, far=2.0)
        want = jmarch._fused_march_channels(params, o, d, vd, z, jnet,
                                            compute_dtype=jnp.float32, target_tile=128,
                                            interpret=True)
        got = rm.march_channels_ref(*_t(params, o, d, vd, z), tnet)
    else:
        pts, dirs = _points(rng, 300)
        if kernel == "widepe":
            want = jmarch._fused_forward_widepe(params, pts, dirs, jnet,
                                                compute_dtype=jnp.float32, tile=128,
                                                interpret=True)
            got = rm.mlp_widepe_ref(*_t(params, pts, dirs), tnet)
        elif kernel == "pe":
            want = jmarch._fused_forward_pe(params, pts, dirs, jnet, compute_dtype=jnp.float32,
                                            tile=64, interpret=True)
            got = rm.mlp_pe_ref(*_t(params, pts, dirs), tnet)
        else:
            x_pe = np.asarray(jenc.positional_encoding(pts, jnet.multires))
            d_pe = np.asarray(jenc.positional_encoding(dirs, jnet.multires_views))
            want = jmarch._fused_forward(params, x_pe, d_pe, jnet, compute_dtype=jnp.float32,
                                         tile=128, interpret=True)
            got = rm.fused_nerf_mlp(*_t(params, x_pe, d_pe), tnet, torch.float32)
        want, got = (want,), (got,)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and np.abs(w).max() > 1e-3      # not a vacuous field
        np.testing.assert_allclose(g.numpy(), w, **TOL)


def test_pe_twin_bf16_rounds_like_pallas_on_a_1024_wide_net(rng):
    """The true-cos kernel in bfloat16 on a 4x1024 net: the twin rounds
    where the JAX kernel rounds (the port's bf16 tolerance)."""
    kw = WIDE["4x1024"]
    params = _jax_params(kw, 4)
    pts, dirs = _points(rng, 64)
    want = np.asarray(jmarch._fused_forward_pe(params, pts, dirs, JNet(**kw),
                                               compute_dtype=jnp.bfloat16, tile=64,
                                               interpret=True))
    got = rm.mlp_pe_ref(*_t(params, pts, dirs), TNet(**kw), torch.bfloat16)
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_render_tile_twin_matches_pallas_interpret_on_a_1024_wide_box(rng, white_bkgd):
    """Kernel 3 on the box scene at width 1024, ragged N: all five maps."""
    kw = WIDE["4x1024"]
    jnet = JNet(**kw)
    params = {k: np.array(v) for k, v in jax_box_scene(jnet, jax.random.PRNGKey(0)).items()}
    o, d, vd, z = _rays(rng, 13, 48)
    want = jmarch.fused_render_tile(params, o, d, vd, z, jnet, white_bkgd=white_bkgd,
                                    compute_dtype=jnp.float32, target_tile=128,
                                    interpret=True)
    got = rm.render_tile_ref(*_t(params, o, d, vd, z), TNet(**kw), white_bkgd=white_bkgd)
    assert float(np.asarray(want[2]).max()) > 0.5              # rays hit the box
    for name, g, w in zip(("rgb", "disp", "acc", "weights", "depth"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("width", [768, 1000, 1024])
def test_padding_to_1024_is_exact(monkeypatch, width, dtype):
    """A trunk past 512 is padded to 1024: the twin on the padded weights
    equals the twin on the net's own to the bit with products summed in
    input order (the FP32 core's order), in both dtypes; with BLAS products
    within float32 rounding in float32 (in bf16 a reordered float32 sum can
    land on the other side of a bf16 rounding boundary)."""
    net = TNet(netdepth=4, netwidth=width, netdepth_fine=4, netwidth_fine=width, skips=(2,))
    params = _he(init_nerf_params(net, generator=torch.Generator().manual_seed(width)))
    assert rm.core_width(width) == 1024
    padded = rm.pad_params(params, net, 1024)
    assert padded["pts_3_kernel"].shape == (net.input_ch + 1024, 1024)
    assert padded["views_0_kernel"].shape == (1024 + net.input_ch_views, 512)
    assert (padded is params) == (width == 1024)
    x_pe, d_pe = _encoded(net, 32, width)
    if dtype == torch.float32:
        torch.testing.assert_close(nerf_apply(padded, x_pe, d_pe, net, compute_dtype=dtype),
                                   nerf_apply(params, x_pe, d_pe, net, compute_dtype=dtype),
                                   rtol=1e-5, atol=1e-5)
    monkeypatch.setattr(tnerf, "_matmul", _matmul_in_order)
    want = nerf_apply(params, x_pe, d_pe, net, compute_dtype=dtype)
    assert want.abs().max() > 0.1
    torch.testing.assert_close(nerf_apply(padded, x_pe, d_pe, net, compute_dtype=dtype), want,
                               rtol=0, atol=0)


# ------------------------------------------- the transposed core's plan --

def _transposed_plan(width, depth, n_skips, in_ch, in_ch_views):
    """make_plan_transposed of csrc/nerf_mlp_wgmma.cuh: each warpgroup's
    pieces per tile, its wide ones, their bytes and runs (trunk pieces of
    min(W/2, 128) rows, views pieces of min(W/4, 128))."""
    nx, nd, h = -(-in_ch // 64), -(-in_ch_views // 64), width // 64
    rows, views_rows = min(width // 2, 128), min(width // 4, 128)
    run, run_v = width // 2 // rows, width // 4 // views_rows
    wide = nx + h * (depth - 1) + nx * n_skips + h
    return dict(per_tile=wide * run + (h + nd) * run_v, n_wide=wide * run,
                wide_bytes=rows * 128, narrow_bytes=views_rows * 128, run=run, run_v=run_v)


def _pieces(plan, g):
    """(byte offset, bytes) of warpgroup g's pieces in order:
    Ring<STAGES, true>::issue of csrc/nerf_mlp.cuh (a section's pieces in
    runs of `run` out of every 2 * run, the two warpgroups' runs side by
    side)."""
    for q in range(plan["per_tile"]):
        wide = q < plan["n_wide"]
        run = plan["run"] if wide else plan["run_v"]
        k = q if wide else q - plan["n_wide"]
        piece = (k // run) * 2 * run + g * run + k % run
        if wide:
            yield piece * plan["wide_bytes"], plan["wide_bytes"]
        else:
            yield (2 * plan["n_wide"] * plan["wide_bytes"] + piece * plan["narrow_bytes"],
                   plan["narrow_bytes"])


def _piece_matrix(image, offset, nbytes):
    """A piece of a pack_wgmma_weights image as [rows, 64]: row n (an output
    column) holds its 64 inputs in 8 units of 8, unit u at position u ^ (n % 8)."""
    rows = nbytes // 128
    raw = image[offset // 2:(offset + nbytes) // 2].to(torch.float32).reshape(rows, 8, 8)
    logical = torch.arange(8)[None, :] ^ (torch.arange(rows)[:, None] % 8)
    out = torch.empty_like(raw)
    out[torch.arange(rows)[:, None], logical] = raw
    return out.reshape(rows, 64)


def _emulate_transposed_core(image, plan, padded, net, x_pe, d_pe):
    """raw [M,4] as mlp_transposed computes it from the pieces (float32
    activations): layer i reads [x_pe chunks if i == 0 or after a skip, h
    chunks], warpgroup g's pieces give its output columns [W/2 g, ...) of
    the trunk and [W/4 g, ...) of the views layer; heads from the outputs."""
    width = padded["pts_0_kernel"].shape[1]
    depth = rm._depth(padded)
    rings = [iter(_pieces(plan, g)) for g in range(2)]

    def chunks(a):
        a = torch.nn.functional.pad(a, (0, -a.shape[1] % 64))
        return list(a.split(64, dim=1))

    def layer(acts, cols, pieces_per_chunk):
        out = []
        for g in range(2):
            acc = torch.zeros(acts[0].shape[0], cols)
            for a in acts:
                parts = [_piece_matrix(image, *next(rings[g])) for _ in range(pieces_per_chunk)]
                acc += a @ torch.cat(parts).t()
            out.append(acc)
        return torch.cat(out, dim=1)

    x_chunks, d_chunks = chunks(x_pe), chunks(d_pe)
    h = None
    for i in range(depth + 1):
        with_x = i == 0 or (i < depth and (i - 1) in net.skips)
        acts = (x_chunks if with_x else []) + (chunks(h) if i > 0 else [])
        v = layer(acts, width // 2, plan["run"])
        name = f"pts_{i}" if i < depth else "feature"
        v = v + padded[f"{name}_bias"]
        h = torch.relu(v) if i < depth else v
        if i == depth - 1:
            alpha = h @ padded["alpha_kernel"] + padded["alpha_bias"]
    v = torch.relu(layer(chunks(h) + d_chunks, width // 4, plan["run_v"])
                   + padded["views_0_bias"])
    rgb = v @ padded["rgb_kernel"] + padded["rgb_bias"]
    for g in range(2):
        assert next(rings[g], None) is None                 # every piece consumed once
    return torch.cat([rgb, alpha], dim=-1)


@pytest.mark.parametrize("name", ["4x1024", "4x512_pe42_20", "4x256_pe50_24"])
def test_transposed_core_pieces_compute_the_twin(name):
    """The transposed core's plan (two warpgroups, each its share of every
    chunk) tiles the packed image exactly once, and the MLP computed from
    each warpgroup's pieces in the core's order is the twin on the
    bf16-rounded weights; its shared memory fits a block."""
    net = TNet(**NETS[name])
    width = rm.core_width(net.netwidth)
    assert transposed(width, net.input_ch, net.input_ch_views)
    params = _he(init_nerf_params(net, generator=torch.Generator().manual_seed(8)))
    padded = rm.pad_params(params, net, width)
    image = rm.pack_wgmma_weights(padded, net)
    plan = _transposed_plan(width, net.netdepth, len(net.skips), net.input_ch,
                            net.input_ch_views)
    spans = sorted(p for g in range(2) for p in _pieces(plan, g))
    assert spans[0][0] == 0 and all(a[0] + a[1] == b[0] for a, b in zip(spans, spans[1:]))
    total = spans[-1][0] + spans[-1][1]
    assert total == image.numel() * 2 == _FakeMarchLibrary.nerf_wgmma_plan_bytes(
        width, net.netdepth, len(net.skips), net.input_ch, net.input_ch_views)
    assert _FakeMarchLibrary.nerf_wgmma_smem_bytes(width, net.input_ch,
                                                   net.input_ch_views) <= SMEM_OPTIN
    x_pe, d_pe = _encoded(net, 24, 9)
    got = _emulate_transposed_core(image, plan, padded, net, x_pe, d_pe)
    rounded = {k: round_to(v, torch.bfloat16) if k.endswith("kernel") and not k.startswith(
        ("alpha", "rgb")) else v for k, v in params.items()}
    want = nerf_apply(rounded, x_pe, d_pe, net)
    assert want.abs().max() > 0.1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_wide_plans_and_shared_memory():
    """At W = 1024 the 8x1024 default-shaped net (the chip check's) packs to
    18.2 MB of bf16 chunks (130 of [1024][64], 17 of [512][64]) and 36.2 MB
    of float32 ones (d_pe in 16-row chunks); its cores fit a block: the
    transposed wgmma core in 211,968 B with the default encodings and
    232,448 (every byte) with seven chunks of encodings, the FP32 core's
    16-point tile in 125,088 (two 16 KB ring stages: 32 KB stages are for
    the 32-point tile; its heads' eight partial sums included). The net's
    depth and skips reach the kernels through a device table of int64 words
    (``raymarch.net_table``), so no C argument limits them: a skip after
    layer 68 of 72 sits in the table's second skip word."""
    net = TNet(netwidth=1024, netwidth_fine=1024)
    assert net.netdepth == 8 and net.skips == (4,)
    assert rm.wgmma_bytes(8, 1, 1024, net.input_ch, net.input_ch_views) == (
        130 * 1024 + 17 * 512) * 128 == 18_153_472
    assert rm.f32_bytes(8, 1, 1024, net.input_ch, net.input_ch_views) == 36_241_408
    lib = _FakeMarchLibrary()
    assert lib.nerf_wgmma_smem_bytes(1024, 63, 27) == 211_968
    assert lib.nerf_wgmma_smem_bytes(1024, 5 * 64, 2 * 64) == SMEM_OPTIN
    assert lib.nerf_wgmma_smem_bytes(1024, 5 * 64 + 1, 2 * 64) > SMEM_OPTIN
    assert lib.nerf_f32_smem_bytes(1024, 63, 27) == 125_088
    assert lib.nerf_width() == 1024
    # the table: the biases' pointers, then the skip mask's 64-bit words
    weights = [torch.zeros(2) for _ in range(2 * (72 + 4))]
    table = rm.net_table(weights, 72, (4, 40, 63, 68))
    assert table.dtype == torch.int64 and table.numel() == 72 + 4 + 2
    assert table[:76].tolist() == [w.data_ptr() for w in weights[1::2]]
    assert table[76:].tolist() == [(1 << 4) + (1 << 40) - (1 << 63), 1 << 4]
    assert rm._NET_ARGS[1] is ctypes.c_void_p and rm._NET_ARGS[4] is ctypes.c_int


# --------------------------------------------- the FP32 core's split lanes --

def _split(tile, width):
    """Split<TILE, W> of csrc/nerf_mlp.cuh: (column parts, point groups,
    points a lane, trunk columns a part)."""
    parts = 128 // tile if width == 1024 else 1
    npg = 16 // parts
    return parts, npg, tile // npg, width // parts


def _packed_column(pos):
    """The column that _f32_chunks puts at position pos of a packed row."""
    return (pos // 4) % 16 + 16 * (4 * (pos // 64) + pos % 4)


def _lane_reads(tile, width, views):
    """Yields (warp, lane, point, packed position, the column the lane takes
    it for) over one row of a layer, as mlp_tile reads it: half-warp hw =
    (32 warp + lane) >> 4 takes part hw // NPG and point group hw % NPG;
    lane cg = lane & 15 holds PT points from PT * group and, of a row of n
    columns (W, or W / 2 in the views layer), reads float4 q < n / PARTS /
    64 at position (n / PARTS) part + 64 q + 4 cg, whose element e it
    multiplies into its column (n / PARTS) part + cg + 16 (4 q + e)."""
    parts, npg, pt, _ = _split(tile, width)
    n = width // 2 if views else width
    span = n // parts
    for warp in range(8):
        for lane in range(32):
            hw = (32 * warp + lane) >> 4
            part, group, cg = hw // npg, hw % npg, lane & 15
            for q in range(span // 64):
                for e in range(4):
                    for point in range(pt * group, pt * group + pt):
                        yield (warp, lane, point, span * part + 64 * q + 4 * cg + e,
                               span * part + cg + 16 * (4 * q + e))


@pytest.mark.parametrize("views", [False, True], ids=["trunk", "views"])
@pytest.mark.parametrize("tile, width", [(32, 1024), (16, 1024), (128, 256), (64, 512)])
def test_split_lanes_cover_each_point_and_column_once(tile, width, views):
    """The lane map of the FP32 core (quarters of the columns on 32-point
    tiles and eighths on 16-point tiles at W = 1024; one part below it) reads
    every (point, packed position) of a layer's row exactly once, the
    position holds the column the lane accumulates, and the two half-warps
    of a warp share a part (their weight loads broadcast)."""
    n = width // 2 if views else width
    reads = list(_lane_reads(tile, width, views))
    cells = [(point, pos) for _, _, point, pos, _ in reads]
    assert len(cells) == len(set(cells)) == tile * n
    assert all(_packed_column(pos) == col for _, _, _, pos, col in reads)
    parts_of_warp = {}
    for warp, lane, _, pos, _ in reads:
        parts_of_warp.setdefault(warp, set()).add(pos // (n // _split(tile, width)[0]))
    assert all(len(v) == 1 for v in parts_of_warp.values())
    # a lane holds 8 points x 16 trunk columns at W = 1024 on 32-point tiles,
    # 8 x 8 on 16-point tiles: 128 and 64 accumulators
    lane0 = [r for r in reads if r[:2] == (0, 0)]
    assert len(lane0) == {(32, 1024): 128, (16, 1024): 64, (128, 256): 128,
                          (64, 512): 128}[(tile, width)] // (2 if views else 1)


@pytest.mark.parametrize("width, parts", [(1024, 4), (1024, 8), (512, 1)])
def test_split_parts_read_back_as_column_blocks(width, parts):
    """Each column part's packed positions, [n/parts * part, n/parts * (part +
    1)) of a row of n columns, read back through ``_unpermute`` (the W = 256
    order of a part of 256 columns) as that part's block of columns, for the
    trunk (n = W) and views (n = W / 2) rows: the packing needs no change for
    the split core."""
    for n in (width, width // 2):
        w = torch.arange(16 * n, dtype=torch.float32).reshape(16, n)
        packed = rm._f32_chunks(w).reshape(16, n)
        span = n // parts
        for part in range(parts):
            block = packed[:, span * part:span * (part + 1)]
            torch.testing.assert_close(_unpermute(block), w[:, span * part:span * (part + 1)],
                                       rtol=0, atol=0)


@pytest.mark.parametrize("tile", [32, 16])
@pytest.mark.parametrize("name", ["4x1024", "4x768"])
def test_f32_core_heads_in_part_order_compute_the_twin(name, tile):
    """The W = 1024 FP32 core sums the alpha and rgb heads over its column
    parts in part order (4 quarters on 32-point tiles, 8 eighths on 16-point
    tiles) after each part's half-warp sum: the MLP from the packed chunks
    with the heads so summed is the twin."""
    net = TNet(**NETS[name])
    params = _he(init_nerf_params(net, generator=torch.Generator().manual_seed(11)))
    padded = rm.pad_params(params, net, 1024)
    x_pe, d_pe = _encoded(net, 24, 12)
    parts = _split(tile, 1024)[0]
    got = _emulate_f32_core(rm.pack_f32_weights(padded, net), padded, net, x_pe, d_pe, parts)
    want = nerf_apply(params, x_pe, d_pe, net)
    assert want.abs().max() > 0.1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _group_bytes(rays, seg):
    return rays * (seg * 20 + 24)


def _render_tile_f32_plan(s, width, in_ch, in_ch_views, smem=SMEM_OPTIN):
    """pick_f32 of csrc/render_tile.cu: (tile, rays, seg) of the render
    tile's FP32 launch for S = s samples."""
    rx, rd = f32_rows(in_ch), f32_rows(in_ch_views)
    big, best, plan = 128 * 256 // width, 0.0, None
    for t in (big, big // 2):
        room = smem - f32_core_bytes(t, width, rx, rd)
        speed = 1.0 if t == big else 0.85
        candidates = [(r, s, -(-r * s // t) * t) for r in range(1, t // math.gcd(s, t) + 1)
                      if _group_bytes(r, s) <= room]
        if not candidates:
            fit = (room - 24) // 20 if room >= 24 else 0
            seg = fit // t * t if fit >= t else fit
            if seg >= t or (t == big // 2 and seg > 0):
                candidates = [(1, seg, s // seg * -(-seg // t) * t + -(-(s % seg) // t) * t)]
        for r, seg, padded in candidates:
            rate = speed * r * s / padded
            if rate > best:
                best, plan = rate, (t, r, seg)
    return plan


def test_f32_launch_plans_fit_shared_memory():
    """With the default encodings every FP32 kernel's plan fits a block's
    232,448 B: the point kernels (1, 2, 4, 5) on 128-, 64- and 32-point
    tiles at W = 256, 512 and 1024 (230,176 B at 1024: two 32 KB ring
    stages and the heads' partial sums); the render tile (3) at W = 1024 on
    the same 32-point tile, whole rays at S = 64 and two segments of 96
    samples at S = 192 (232,120 B), where whole rays would need the 16-point
    tile; at W = 256 its plans of PR 13 (128 points and 2 rays at S = 64 and
    192, 64 points and 4 rays at S = 144)."""
    lib = _FakeMarchLibrary()
    in_ch, in_ch_views = TNet().input_ch, TNet().input_ch_views
    rx, rd = f32_rows(in_ch), f32_rows(in_ch_views)
    tile = ctypes.c_int()
    for width, want in ((256, 128), (512, 64), (1024, 32)):
        smem = lib.nerf_f32_launch_bytes(width, in_ch, in_ch_views, ctypes.pointer(tile))
        assert tile.value == want == f32_pick_tile(width, rx, rd, 0)
        assert smem == f32_core_bytes(want, width, rx, rd) <= SMEM_OPTIN
    assert f32_core_bytes(32, 1024, rx, rd) == 230_176
    plans = {(w, s): _render_tile_f32_plan(s, w, in_ch, in_ch_views)
             for w in (256, 512, 1024) for s in (64, 144, 192)}
    for (w, s), (t, rays, seg) in plans.items():
        assert f32_core_bytes(t, w, rx, rd) + _group_bytes(rays, seg) <= SMEM_OPTIN
    assert plans[(1024, 64)] == (32, 1, 64) and plans[(1024, 192)] == (32, 1, 96)
    assert f32_core_bytes(32, 1024, rx, rd) + _group_bytes(1, 96) == 232_120
    assert _group_bytes(1, 192) > SMEM_OPTIN - f32_core_bytes(32, 1024, rx, rd)
    assert plans[(256, 64)] == (128, 2, 64) and plans[(256, 192)] == (128, 2, 192)
    assert plans[(256, 144)] == (64, 4, 144)


# ------------------------------------------- the render tile's segments --

def _composite_segments(raw, z_vals, rays_d, seg, white_bkgd):
    """raw2outputs as csrc/render_tile.cu's composite() runs it over
    segments of seg samples: per point alpha (a segment's last sample reads
    the next depth from z_vals) and sigmoids, then per ray the exclusive
    product and the sums in sample order from the transmittance and sums the
    earlier segments left; float32 throughout."""
    n, s = z_vals.shape
    dn = torch.sqrt(rays_d[:, 0] * rays_d[:, 0] + rays_d[:, 1] * rays_d[:, 1]
                    + rays_d[:, 2] * rays_d[:, 2])
    trans = torch.ones(n)
    rgb, dep, acc = torch.zeros(n, 3), torch.zeros(n), torch.zeros(n)
    weights = torch.empty(n, s)
    for s0 in range(0, s, seg):
        for j in range(s0, min(s, s0 + seg)):
            dist = (z_vals[:, j + 1] - z_vals[:, j] if j + 1 < s else torch.full((n,), 1e10)) * dn
            alpha = 1.0 - torch.exp(-torch.relu(raw[:, j, 3]) * dist)
            w = alpha * trans
            trans = trans * (1.0 - alpha + 1e-10)
            weights[:, j] = w
            rgb = rgb + w[:, None] * (1.0 / (1.0 + torch.exp(-raw[:, j, :3])))
            dep = dep + w * z_vals[:, j]
            acc = acc + w
    if white_bkgd:
        rgb = rgb + (1.0 - acc)[:, None]
    disp = 1.0 / torch.clamp(dep / torch.clamp(acc, min=1e-10), min=1e-10)
    return rgb, disp, acc, weights, dep


@pytest.mark.parametrize("white_bkgd", [False, True])
@pytest.mark.parametrize("s", [50, 192])
def test_segmented_compositing_matches_raw2outputs(white_bkgd, s):
    """Segments of 7 samples over S = 50 and S = 192, a field whose rays
    saturate: every map within 1e-6 of raw2outputs, and the segments sum
    exactly as one whole segment does (the carry is the running state)."""
    rng = np.random.RandomState(s)
    n = 33
    raw = torch.from_numpy((rng.randn(n, s, 4) * 2.0).astype(np.float32))
    # densities from ~1e-3 to ~10 by ray, none at the last sample of every
    # other ray (whose 1e10 distance saturates any density): acc from ~0 to 1
    raw[..., 3] = raw[..., 3].abs() * torch.logspace(-3, 1, n)[:, None]
    raw[::2, -1, 3] = -1.0
    rays_d = torch.from_numpy(rng.randn(n, 3).astype(np.float32))
    z = torch.from_numpy(np.sort(0.3 + 1.6 * rng.rand(n, s), axis=1).astype(np.float32))
    got = _composite_segments(raw, z, rays_d, 7, white_bkgd)
    whole = _composite_segments(raw, z, rays_d, s, white_bkgd)
    want = raw2outputs(raw, z, rays_d, white_bkgd=white_bkgd)
    assert float(want[2].min()) < 0.999 < float(want[2].max())  # saturated and not
    for name, g, o, w in zip(("rgb", "disp", "acc", "weights", "depth"), got, whole, want):
        torch.testing.assert_close(g, o, rtol=0, atol=0, msg=name)
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6, msg=name)


class _FakeRenderTileLibrary(_FakeMarchLibrary):
    """The render_tile library's entries and their segment query: samples per
    segment as given, ``segment`` on the FP32 and wgmma cores and
    ``stream_segment`` on the streaming core (core codes 2 and 3)."""

    def __init__(self, segment, stream_segment=0):
        super().__init__()
        self.segment, self.stream_segment = segment, stream_segment

    def render_tile_max_samples(self, core, width, in_ch, in_ch_views):
        return self.stream_segment if core >= 2 else self.segment

    def render_tile(self, *args):
        self.calls.append(args)
        return 0

    def render_tile_stream(self, *args):
        self.stream_calls.append(args)
        return 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_render_tile_takes_any_samples_per_ray(monkeypatch, dtype):
    """On the kernel route the render tile launches for S far past one
    segment (4,096 samples against 100), on the default net and at width
    1024. Where the net's FP32 or wgmma core leaves no room for one sample
    it launches on the streaming core (at S = 1,024, inside the JAX kernel's
    budget, whose [S, S] triangle grows with S); it refuses, naming the
    bytes of a sample, only when that core leaves no room for one either."""
    rays = [torch.rand(2, 3), torch.rand(2, 3), torch.rand(2, 3), torch.rand(2, 4096)]
    monkeypatch.setattr(rm, "uses_kernel", lambda t: True)
    monkeypatch.setattr(rm, "_run", lambda fn, device, what, *args: fn(*args, None))
    for kw in (dict(), dict(netwidth=1024, netwidth_fine=1024)):
        net = TNet(**kw)
        params = init_nerf_params(net, generator=torch.Generator().manual_seed(5))
        lib = _FakeRenderTileLibrary(100)
        monkeypatch.setattr(rm, "_library", lambda name: lib)
        rm.fused_render_tile.launches = 0
        with torch.no_grad():
            out = rm.fused_render_tile(params, *rays, net, compute_dtype=dtype)
        assert rm.fused_render_tile.launches == 1 and out[3].shape == (2, 4096)
        (args,) = lib.calls
        assert (args[4], args[5], args[8]) == (2, 4096, rm.core_width(net.netwidth))
        lib = _FakeRenderTileLibrary(0, 100)
        with torch.no_grad():
            out = rm.fused_render_tile(params, *rays[:3], rays[3][:, :1024], net,
                                       compute_dtype=dtype)
        assert rm.fused_render_tile.launches == 2 and out[3].shape == (2, 1024)
        assert lib.calls == [] and len(lib.stream_calls) == 1
        assert lib.stream_calls[0][8] == rm.stream_width(net.netwidth)
        lib = _FakeRenderTileLibrary(0)
        with pytest.raises(NotImplementedError, match="no room in shared memory for one "
                                                      "sample"):
            rm.fused_render_tile(params, *rays[:3], rays[3][:, :16], net, compute_dtype=dtype)
        assert lib.calls == [] and lib.stream_calls == []
