"""The standard wgmma core's clusters, tile slots and ring
(``csrc/nerf_mlp_wgmma.cuh``, W = 256 and 512 in bf16), written out here
from the header and the three kernels.

- A cluster of cluster_size(W) blocks (2 at W = 512, 1 at 256) shares each
  packed weight chunk: the producer of rank r copies part r (1/CLUSTER of
  the chunk) into the same stage of every block (``McRing::produce``). The parts of every chunk kind cover its
  bytes once, in 16-byte units, and the stages each block receives
  reassemble the packed image; the MLP computed from those stages in the
  core's order (the W = 512 warpgroups reading their halves of each chunk)
  is the twin, and the twin is the JAX package's MLP on the same numpy
  inputs.
- Every block of a cluster consumes every chunk, so the blocks of a cluster
  walk the same number of tile slots (``Core::slots``; the render tile's
  ``block_tiles`` over its groups and segments, masked sub-tiles after a
  block's own): every tile runs exactly once over the cluster grid, for any
  number of rays, odd tile counts and fewer tiles than clusters.
- The ring's barriers (full: the local producer's arrival and every
  part's bytes; empty: the 8 consumer warps of every block), run in random
  interleavings of producers, copies and warps, never stall and never let
  a chunk's part overwrite a stage a block still reads.
- The shared memory of every standard-core shape, the render tile's rays
  and segments included, fits a block.

The CUDA kernels themselves run only on the card, where chip_smoke.py holds
them against their twins, with odd tile counts, fewer tiles than clusters
and a single ray among its launches.
"""

import math

import jax
import numpy as np
import pytest
import torch

from neuralsim_tpu.config import NeRFNetConfig as JNet
from neuralsim_tpu.models.nerf import nerf_apply as jax_nerf_apply
from neuralsim_tpu_torch.config import NeRFNetConfig as TNet
from neuralsim_tpu_torch.kernels import raymarch as rm
from neuralsim_tpu_torch.models.nerf import init_nerf_params, nerf_apply, round_to
from tests.test_torch_net_shapes import (
    NETS,
    SMEM_OPTIN,
    _encoded,
    _FakeMarchLibrary,
    _he,
    transposed,
)
from tests.test_torch_wide_nets import _piece_matrix

torch.set_num_threads(2)

# ---- the header's values (nerf_mlp_wgmma.cuh, nerf_mlp.cuh) ----------------
CHUNK_K = 64            # input rows of a packed chunk
P = 64                  # points of a warpgroup's tile
A_CHUNK_BYTES = P * CHUNK_K * 2
SMEM_ALIGN = 1024
CLUSTERS = (1, 2)       # the blocks a McRing cluster may have
THREADS = 256           # consumer threads; the producer warpgroup adds 128
STD_THREADS = THREADS + 128
PRODUCER_REGS, CONSUMER_REGS = 24, 240
# the most active clusters that the H100 80GB HBM3 reported for the
# standard-core kernels (66 of 2 blocks; chip_smoke.py prints it), and
# other grids
ACTIVE = (132, 66, 64, 7, 1)
# render_tile.cu: shared bytes per point of a segment and per ray of a group
POINT_BYTES, RAY_BYTES = 5 * 4, 6 * 4


def cluster_size(width):
    """Blocks of the standard core's clusters at a trunk width."""
    return 2 if width == 512 else 1


def stages(width, nx):
    return 3 if width == 256 and nx <= 2 else 2


def chunk_bytes(width):
    return width * CHUNK_K * 2


def core_bytes(width, nx, nd):
    a = (nx + width // CHUNK_K + nd) * A_CHUNK_BYTES
    return stages(width, nx) * chunk_bytes(width) + (2 if width == 256 else 1) * a + \
        2 * stages(width, nx) * 8


def launch_bytes(width, nx, nd):
    return core_bytes(width, nx, nd) + SMEM_ALIGN


def standard_plan(width, depth, n_skips, in_ch, in_ch_views):
    """make_plan_standard: chunks per tile, the wide ones, their bytes."""
    nx, nd, h = -(-in_ch // 64), -(-in_ch_views // 64), width // 64
    n_wide = nx + h * (depth - 1) + nx * n_skips + h
    return dict(per_tile=n_wide + h + nd, n_wide=n_wide, wide_bytes=chunk_bytes(width),
                narrow_bytes=chunk_bytes(width // 2))


def multicast_parts(plan, cluster):
    """McRing::produce over one tile's chunks: per chunk q, its stage size
    and the (rank, source offset, destination offset within the stage,
    bytes) of each block's copy."""
    for q in range(plan["per_tile"]):
        wide = q < plan["n_wide"]
        nbytes = plan["wide_bytes"] if wide else plan["narrow_bytes"]
        off = (q * plan["wide_bytes"] if wide else
               plan["n_wide"] * plan["wide_bytes"] + (q - plan["n_wide"]) * plan["narrow_bytes"])
        part = nbytes // cluster
        yield q, nbytes, off, [(r, off + r * part, r * part, part) for r in range(cluster)]


# the standard core's nets: (width, in_ch, in_ch_views) with NX <= 4 and
# nd <= 2 at W = 256, NX + nd <= 4 at 512
STANDARD_SHAPES = [(256, 64 * nx, 64 * nd) for nx in (1, 2, 3, 4) for nd in (1, 2)] + [
    (512, 64 * nx, 64 * nd) for nx in (1, 2, 3) for nd in (1, 2) if nx + nd <= 4] + [
    (256, 63, 27), (512, 63, 27), (256, 147, 75), (512, 147, 27)]


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("width", [256, 512])
@pytest.mark.parametrize("kind", ["trunk", "views"])
def test_multicast_parts_cover_each_chunk_once(width, kind, cluster):
    """Each rank's part of a trunk ([W][64]) or views ([W/2][64]) chunk is
    1/CLUSTER of its bytes, a multiple of 16 at 16-byte aligned source and
    destination offsets; together the parts cover the chunk's bytes once,
    each landing at its own offset within the stage."""
    plan = standard_plan(width, 8, 1, 63, 27)
    want = plan["wide_bytes"] if kind == "trunk" else plan["narrow_bytes"]
    seen = 0
    for q, nbytes, off, parts in multicast_parts(plan, cluster):
        if (q < plan["n_wide"]) != (kind == "trunk"):
            continue
        assert nbytes == want
        cover = np.zeros(nbytes, np.int32)
        for rank, src, dst, part in parts:
            assert part * cluster == nbytes and part % 16 == 0
            assert src % 16 == 0 and dst % 16 == 0 and src - off == dst
            cover[dst:dst + part] += 1
        assert (cover == 1).all()
        seen += 1
    assert seen == (plan["n_wide"] if kind == "trunk" else plan["per_tile"] - plan["n_wide"])


def _reassembled_stages(image, plan, cluster, block):
    """The stage images block `block` of a cluster receives for one tile:
    every rank's part copied into it, as McRing::produce multicasts them."""
    raw = image.view(torch.uint8)
    for _, nbytes, _, parts in multicast_parts(plan, cluster):
        stage = torch.full((nbytes,), 0xAB, dtype=torch.uint8)   # stale bytes
        for rank, src, dst, part in parts:
            stage[dst:dst + part] = raw[src:src + part]
        yield stage.view(torch.bfloat16)


def _emulate_standard_core(stages_, width, padded, net, x_pe, d_pe):
    """raw [M,4] as mlp_core_wgmma computes it from the ring's stages in
    order (float32 products of the bf16 operands): layer 0 reads the x_pe
    chunks, layer i > 0 [x_pe after a skip, h], the feature h, the views
    [feature, d_pe]; at W = 512 warpgroup g reads rows [256 g, 256 g + 256)
    of a trunk chunk and [128 g, ...) of a views chunk (b_rows, bv_rows)."""
    depth = rm._depth(padded)
    groups = 2 if width == 512 else 1

    def chunks(a):
        a = torch.nn.functional.pad(a, (0, -a.shape[1] % 64))
        return list(a.split(64, dim=1))

    def layer(acts, cols):
        acc = torch.zeros(acts[0].shape[0], cols)
        for a in acts:
            stage = next(stages_)
            w = _piece_matrix(stage, 0, stage.numel() * 2)        # [cols][64]
            halves = w.split(cols // groups)
            acc += torch.cat([a @ half.t() for half in halves], dim=1)
        return acc

    xs, ds = chunks(x_pe), chunks(d_pe)
    h = None
    for i in range(depth + 1):
        with_x = i == 0 or (i < depth and (i - 1) in net.skips)
        acts = (xs if with_x else []) + (chunks(h) if i > 0 else [])
        v = layer(acts, width) + padded[f"pts_{i}_bias" if i < depth else "feature_bias"]
        h = torch.relu(v) if i < depth else v
        if i == depth - 1:
            alpha = h @ padded["alpha_kernel"] + padded["alpha_bias"]
    v = torch.relu(layer(chunks(h) + ds, width // 2) + padded["views_0_bias"])
    assert next(stages_, None) is None                      # every chunk consumed once
    return torch.cat([v @ padded["rgb_kernel"] + padded["rgb_bias"], alpha], dim=-1)


@pytest.mark.parametrize("block", [0, 1])
@pytest.mark.parametrize("name", ["8x512", "24x256", "w128x4", "8x256_pe42_20"])
def test_multicast_stages_compute_the_twin_and_jax(name, block):
    """The stages a block of a cluster of 2 receives (half of each chunk from
    each producer; the header's clusters at W = 512, a variant's at 256) reassemble the packed chunks, and the MLP computed from
    them in the core's order equals the twin on the bf16-rounded weights,
    which equals the JAX package's MLP on the same numpy inputs."""
    kw = NETS[name]
    net = TNet(**kw)
    width = rm.core_width(net.netwidth)
    assert not transposed(width, net.input_ch, net.input_ch_views)
    params = _he(init_nerf_params(net, generator=torch.Generator().manual_seed(11)))
    padded = rm.pad_params(params, net, width)
    rounded_padded = {k: round_to(v, torch.bfloat16) if k.endswith("kernel") else v
                      for k, v in padded.items()}
    image = rm.pack_wgmma_weights(rounded_padded, net)
    plan = standard_plan(width, net.netdepth, len(net.skips), net.input_ch, net.input_ch_views)
    assert image.numel() * 2 == _FakeMarchLibrary.nerf_wgmma_plan_bytes(
        width, net.netdepth, len(net.skips), net.input_ch, net.input_ch_views)
    x_pe, d_pe = _encoded(net, 24, 12)
    got = _emulate_standard_core(_reassembled_stages(image, plan, 2, block), width,
                                 padded, net, x_pe, d_pe)
    rounded = {k: round_to(v, torch.bfloat16) if k.endswith("kernel") and not k.startswith(
        ("alpha", "rgb")) else v for k, v in params.items()}
    want = nerf_apply(rounded, x_pe, d_pe, net)
    assert want.abs().max() > 0.1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    jax_raw = jax_nerf_apply({k: np.asarray(v.numpy()) for k, v in rounded.items()},
                             x_pe.numpy(), d_pe.numpy(), JNet(**kw))
    torch.testing.assert_close(want, torch.from_numpy(np.array(jax_raw)), rtol=1e-4,
                               atol=1e-4)


# ---- tile slots over the cluster grid ---------------------------------------

def cluster_grid(work, cluster, active):
    """launch_clusters: blocks of the grid for `work` block tiles (or ray
    groups), at most `active` clusters."""
    return min(-(-work // cluster), active) * cluster


def slots(block, n_tiles, grid, cluster):
    """Core::slots: the tiles of the first block of `block`'s cluster."""
    first = block - block % cluster
    return -(-(n_tiles - first) // grid) if n_tiles > first else 0


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("active", ACTIVE)
@pytest.mark.parametrize("width", [256, 512])
@pytest.mark.parametrize("points", [1, 2, 63, 64, 65, 127, 129, 1000, 8191, 8192 * 13 + 5,
                                    66 * 128 + 1, 2 * 66 * 128 - 1, 8192 * 192])
def test_point_kernels_run_each_tile_once_in_equal_slots(points, width, active, cluster):
    """nerf_march.cu and nerf_mlp.cu: block b runs tiles b, b + grid, ...
    for Core::slots slots; every tile below n_tiles runs once, the blocks of
    a cluster take the same number of slots (so the same chunks), a slot
    past the last tile is masked, and its first point stays below
    total + 4 P, inside the kernels' int range (total <= 2^31 - 1 - 8 P)."""
    tile = 2 * P if width == 256 else P
    n_tiles = -(-points // tile)
    grid = cluster_grid(n_tiles, cluster, active)
    assert grid % cluster == 0 and grid <= cluster * active
    runs = np.zeros(n_tiles, np.int32)
    for c in range(grid // cluster):
        per_block = [slots(c * cluster + r, n_tiles, grid, cluster) for r in range(cluster)]
        assert len(set(per_block)) == 1 and per_block[0] >= 1
        for r in range(cluster):
            for k in range(per_block[r]):
                t = c * cluster + r + k * grid
                if t < n_tiles:
                    runs[t] += 1
                else:                                           # masked slot
                    assert t * tile + P <= points + 4 * P
    assert (runs == 1).all()


def _gcd_rays(s, tile, room):
    """block_rays of render_tile.cu."""
    r = tile // math.gcd(s, tile)
    if r * (s * POINT_BYTES + RAY_BYTES) <= room:
        return r
    fill = 1 if s >= tile else -(-tile // s)
    return min(fill, room // (s * POINT_BYTES + RAY_BYTES))


def bf16_tile_plan(s, width, in_ch, in_ch_views, smem=SMEM_OPTIN):
    """render_tile()'s bf16 plan on the standard core: sub-tile points, rays
    per group, samples per segment and the launch's shared memory."""
    nx, nd = -(-in_ch // 64), -(-in_ch_views // 64)
    core = launch_bytes(width, nx, nd)
    room = smem - core
    tile = 2 * P if width == 256 else P
    rays, seg = (_gcd_rays(s, tile, room) if room >= 0 else 0), s
    if rays < 1:
        fit = 0 if room < RAY_BYTES else (room - RAY_BYTES) // POINT_BYTES
        rays, seg = 1, (fit // tile * tile if fit >= tile else fit)
    return tile, rays, seg, core + rays * (seg * POINT_BYTES + RAY_BYTES)


def block_tiles(block, n_rays, s, rays, seg, tile, grid):
    """render_tile.cu block_tiles: the sub-tiles of block `block`'s groups,
    as (group, segment start, first point)."""
    out = []
    for grp in range(block, -(-n_rays // rays), grid):
        n_here = min(rays, n_rays - grp * rays)
        for s0 in range(0, s, seg):
            length = min(seg, s - s0)
            out += [(grp, s0, t0) for t0 in range(0, n_here * length, tile)]
    return out


def slot_walk(block, slots, mine, n_rays, s, rays, seg, tile, grid):
    """render_tile_wgmma's loop over its slots: slot k is sub-tile t0 of
    segment s0 of group grp while k < mine (then masked: no points); after
    a segment's last sub-tile it composites and moves on. Returns the real
    slots as (group, segment start, first point) and the composites as
    (group, segment start, samples)."""
    grp, s0, t0 = block, 0, 0
    subtiles, composites = [], []
    for k in range(slots):
        real = k < mine
        n_here = min(rays, n_rays - grp * rays) if real else 0
        length = min(seg, s - s0)
        if real:
            subtiles.append((grp, s0, t0))
            t0 += tile
            if t0 >= n_here * length:
                composites.append((grp, s0, length))
                t0 = 0
                s0 += seg
                if s0 >= s:
                    s0, grp = 0, grp + grid
    return subtiles, composites


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("active", (66, 7))
@pytest.mark.parametrize("width", [256, 512])
@pytest.mark.parametrize("s", [16, 64, 144, 192, 2048])
@pytest.mark.parametrize("n_rays", [1, 2, 3, 65, 131, 133, 1001, 8192])
def test_render_tile_runs_each_sub_tile_once_in_equal_slots(n_rays, s, width, active, cluster):
    """render_tile.cu on the standard core: block b walks groups b, b +
    grid, ... in segments and sub-tiles, then runs masked sub-tiles up to
    the most of its cluster; every sub-tile of every group and segment runs
    once, and every block of a cluster runs the same number (so consumes the
    same chunks). The launch's shared memory fits a block."""
    tile, rays, seg, smem = bf16_tile_plan(s, width, 63, 27)
    assert rays >= 1 and seg >= 1 and smem <= SMEM_OPTIN
    groups = -(-n_rays // rays)
    grid = cluster_grid(groups, cluster, active)
    seen = {}
    for c in range(grid // cluster):
        walks = [block_tiles(c * cluster + r, n_rays, s, rays, seg, tile, grid)
                 for r in range(cluster)]
        most = max(len(w) for w in walks)
        assert most >= 1
        for r, w in enumerate(walks):
            # the kernel's one loop over `most` slots runs the block's own
            # sub-tiles in the nested loops' order, then masked ones, and
            # composites each of its segments once, after its last sub-tile
            subtiles, composites = slot_walk(c * cluster + r, most, len(w), n_rays, s, rays, seg,
                                             tile, grid)
            assert subtiles == w
            segments = sorted({(g, s0) for g, s0, _ in w})
            assert [(g, s0) for g, s0, _ in composites] == segments
            for key in w:
                seen[key] = seen.get(key, 0) + 1
    want = sum(-(-min(rays, n_rays - g * rays) * min(seg, s - s0) // tile)
               for g in range(groups) for s0 in range(0, s, seg))
    assert len(seen) == want and set(seen.values()) == {1}


@pytest.mark.parametrize("s", [16, 64, 144, 192, 2048])
def test_render_tile_plans_at_the_main_path_sample_counts(s):
    """The default net's render-tile plans: whole rays (R = 2 at S = 64 and
    192 on W = 256) where they fit beside the core, segments beyond."""
    tile, rays, seg, _ = bf16_tile_plan(s, 256, 63, 27)
    assert tile == 128
    if s in (64, 192):
        assert (rays, seg) == (2, s)
    if s == 2048:
        assert rays == 1 and seg < s and seg % tile == 0


# ---- the cluster ring's barriers ---------------------------------------------

class _Mbarrier:
    """An mbarrier: a phase completes when its arrivals are in and its
    transaction bytes (expect_tx up, complete_tx down) are back to 0;
    try_wait.parity(p) is true once the phase of parity p has completed."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.phase = count, count, 0, 0

    def _done(self):
        if self.pending == 0 and self.tx == 0:
            self.phase += 1
            self.pending = self.count

    def arrive(self, expect_tx=0):
        self.tx += expect_tx
        self.pending -= 1
        assert self.pending >= 0
        self._done()

    def complete_tx(self, nbytes):
        self.tx -= nbytes
        self._done()

    def try_wait(self, parity):
        return (self.phase & 1) != parity


def layer_sizes(width, depth, skips, nx, nd):
    """Chunks of each layer of a tile, in the core's order: trunk layers,
    feature, views."""
    h = width // CHUNK_K
    return [nx] + [h + (nx if (i - 1) in skips else 0) for i in range(1, depth)] + [h, h + nd]


def simulate_cluster_ring(cluster, n_stages, layers, tiles, seed):
    """McRing over a cluster, one step of one actor at a time in a random
    order: each block's producer (wait for empty[s] from the second round,
    arm full[s] for the chunk, issue its part to every block), the copies
    landing (each writes its part of a stage and completes its bytes on that
    block's full[s]), and each block's 8 consumer warps (layer_mma: acquire
    a chunk, free the previous one once the next is issued, the last of a
    layer at its end; a free is an arrive on every block's empty[s]). Returns
    the chunks each warp read, as (chunk, the parts its stage held)."""
    rng = np.random.default_rng(seed)
    nbytes = 16 * cluster
    total = sum(layers) * tiles
    full = [[_Mbarrier(1) for _ in range(n_stages)] for _ in range(cluster)]
    empty = [[_Mbarrier(8 * cluster) for _ in range(n_stages)] for _ in range(cluster)]
    stage_parts = [[[None] * cluster for _ in range(n_stages)] for _ in range(cluster)]
    produced = [0] * cluster
    in_flight = []                  # copies: (block, stage, rank, chunk)
    ends = np.cumsum(layers * tiles)
    last = set((ends - 1).tolist())
    firsts = set((ends - np.array(layers * tiles)).tolist())
    warps = [dict(block=b, c=0, read=0, free=0, pending_free=False, reads=[])
             for b in range(cluster) for _ in range(8)]

    def producer_step(b):
        i = produced[b]
        s, phase = i % n_stages, (i // n_stages) & 1
        if i >= total or (i >= n_stages and not empty[b][s].try_wait(phase ^ 1)):
            return False
        full[b][s].arrive(expect_tx=nbytes)
        in_flight.extend((dst, s, b, i) for dst in range(cluster))
        produced[b] += 1
        return True

    def land(k):
        dst, s, rank, chunk = in_flight.pop(k)
        stage_parts[dst][s][rank] = chunk
        full[dst][s].complete_tx(nbytes // cluster)

    def release(w):
        for dst in range(cluster):
            empty[dst][w["free"] % n_stages].arrive()
        w["free"] += 1

    def warp_step(w):
        if w["c"] == total:
            return False
        c, s = w["c"], w["c"] % n_stages
        if not full[w["block"]][s].try_wait((c // n_stages) & 1):
            return False
        w["reads"].append((c, tuple(stage_parts[w["block"]][s])))
        if c not in firsts:
            release(w)                                  # the previous chunk
        if c in last:
            release(w)                                  # the layer's last
        w["c"] += 1
        return True

    while True:
        actors = [("p", b) for b in range(cluster)] + [("w", w) for w in warps] + [
            ("l", k) for k in range(len(in_flight))]
        progressed = False
        for k in rng.permutation(len(actors)):
            kind, who = actors[k]
            if kind == "l":
                land(who)
                progressed = True
                break
            if (producer_step(who) if kind == "p" else warp_step(who)):
                progressed = True
                break
        if not progressed:
            break
    done = all(w["c"] == total for w in warps) and all(n == total for n in produced)
    assert done, "the cluster ring stopped before every warp consumed every chunk"
    return [w["reads"] for w in warps], [[e.phase for e in row] for row in empty]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cluster,n_stages", [(1, 3), (2, 3), (2, 2), (1, 2)])
@pytest.mark.parametrize("layers", [layer_sizes(256, 2, (), 1, 1), layer_sizes(512, 3, (0,), 1, 1)],
                         ids=["2x256", "3x512_skip"])
def test_cluster_ring_streams_every_chunk_to_every_block(layers, cluster, n_stages, seed):
    """The ring's barriers, run in random interleavings: no block's warps
    or producers stall for good, every consumer warp of every block reads
    every chunk in order from a stage that holds all of that chunk's parts
    (no part of a later chunk overwrote it: a stage is refilled only once
    every block's warps freed it), and every block's empty barriers end in
    the same phase."""
    tiles = 3
    reads, phases = simulate_cluster_ring(cluster, n_stages, layers, tiles, seed)
    total = sum(layers) * tiles
    for warp_reads in reads:
        assert [c for c, _ in warp_reads] == list(range(total))
        assert all(parts == (c,) * cluster for c, parts in warp_reads)
    assert all(row == phases[0] for row in phases)


# ---- shared memory and the launch -------------------------------------------

@pytest.mark.parametrize("width,in_ch,in_ch_views", STANDARD_SHAPES)
def test_standard_core_shapes_fit_a_block(width, in_ch, in_ch_views):
    """Every net the standard core takes fits a block with the render tile's
    smallest group beside it (the cluster, the producer and the skew add no
    shared memory); the fake library reports the header's bytes, and the
    default net leaves the render tile 34,768 B."""
    nx, nd = -(-in_ch // 64), -(-in_ch_views // 64)
    assert not transposed(width, in_ch, in_ch_views)
    smem = launch_bytes(width, nx, nd)
    assert _FakeMarchLibrary.nerf_wgmma_smem_bytes(width, in_ch, in_ch_views) == smem
    assert smem + POINT_BYTES + RAY_BYTES <= SMEM_OPTIN
    for s in (16, 64, 192, 2048):
        assert bf16_tile_plan(s, width, in_ch, in_ch_views)[3] <= SMEM_OPTIN
    if (width, in_ch, in_ch_views) == (256, 63, 27):
        assert core_bytes(256, 1, 1) == 196_656 and SMEM_OPTIN - smem == 34_768
    if (width, in_ch, in_ch_views) == (512, 63, 27):
        assert core_bytes(512, 1, 1) == 213_024


def test_roles_fit_the_register_file_and_the_query_is_bound():
    """Two consumer warpgroups at CONSUMER_REGS and the producer at
    PRODUCER_REGS fit the SM's 65,536 registers; every library binds the
    launch query (blocks per cluster, blocks, active clusters, threads),
    and the fake library answers it as the 8x512 net's launch on the
    card."""
    assert 2 * 128 * CONSUMER_REGS + 128 * PRODUCER_REGS <= 65536
    assert CONSUMER_REGS % 8 == 0 and PRODUCER_REGS % 8 == 0 and STD_THREADS == 384
    names = [q[0] for q in rm._QUERIES]
    assert "nerf_wgmma_last_launch" in names
    info = (rm.ctypes.c_int * 4)()
    assert _FakeMarchLibrary().nerf_wgmma_last_launch(info) == 0
    assert list(info) == [cluster_size(512), 132, 66, 384]
