"""The transposed wgmma core's rings (``csrc/nerf_mlp_wgmma.cuh``: W = 1024
in bf16, and W = 256 / 512 where the standard core has no room for the
encodings), written out here from the header and ``Ring`` of
``csrc/nerf_mlp.cuh``.

- Each warpgroup streams its share of the packed chunks through a ring of
  its own, in pieces of at most 128 rows (16 KB: four of a 1024-wide trunk
  chunk a warpgroup, two of a views chunk) on four stages at W = 512 and
  1024 (two at 256): the two warpgroups' pieces tile the packed image
  exactly once, each fits a stage, and the rings take the shared memory
  of the two 32 KB stages they replaced.
- The rings' barriers (full: the issuing thread's arrival and the piece's
  bytes; empty: the warpgroup's 4 warps), run in random interleavings of
  the warps, the copies and the block barriers between layers (the two
  warpgroups drifting apart too), never stall and never let a later piece
  overwrite a stage a warp still reads.

The products and their order are those of rings of two 32 KB stages (a
piece's m64 blocks take its chunk's k16 steps in order), so on the card
the bf16 outputs equal theirs bit for bit (``chip_compare.py``).
"""

import numpy as np
import pytest

from tests.test_torch_net_shapes import SMEM_OPTIN, _FakeMarchLibrary, transposed
from tests.test_torch_wgmma_cluster import _Mbarrier
from tests.test_torch_wide_nets import _pieces, _transposed_plan

# the transposed nets of chip_smoke.py's EXTRA_NETS: (width, depth, skips,
# in_ch, in_ch_views)
NETS = {"8x1024": (1024, 8, (4,), 63, 27), "8x512_pe42_20": (512, 8, (4,), 255, 123),
        "4x256_pe50_24": (256, 4, (2,), 303, 147)}
PIECE = 16 * 1024       # the largest piece: 128 rows of 64 bf16 inputs


def t_stages(width):
    """Ring stages of a warpgroup: four at W = 512 and 1024, two at 256."""
    return 2 if width == 256 else 4


@pytest.mark.parametrize("name", list(NETS))
def test_pieces_tile_the_image_and_fit_a_stage(name):
    """Ring::issue with HALVES: the two warpgroups' pieces (runs of 4 trunk
    pieces and 2 views pieces a chunk at W = 1024) tile the packed image
    exactly once, in 16-byte units, in the library's plan bytes; every
    piece fits a 16 KB stage; the rings' shared memory is that of the two
    32 KB stages (two 16 KB ones at W = 256) they replaced, so every net
    here still fits a block."""
    width, depth, skips, in_ch, in_ch_views = NETS[name]
    assert transposed(width, in_ch, in_ch_views)
    plan = _transposed_plan(width, depth, len(skips), in_ch, in_ch_views)
    assert (plan["run"], plan["run_v"]) == {1024: (4, 2), 512: (2, 1), 256: (1, 1)}[width]
    spans = sorted(p for g in range(2) for p in _pieces(plan, g))
    assert all(off % 16 == 0 and 0 < nbytes <= PIECE for off, nbytes in spans)
    assert spans[0][0] == 0 and all(a[0] + a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][0] + spans[-1][1] == _FakeMarchLibrary.nerf_wgmma_plan_bytes(
        width, depth, len(skips), in_ch, in_ch_views)
    rings = 2 * t_stages(width) * plan["wide_bytes"]
    assert rings == (2 * 2 * 16 * 1024 if width == 256 else 2 * 2 * 32 * 1024)
    assert _FakeMarchLibrary.nerf_wgmma_smem_bytes(width, in_ch, in_ch_views) <= SMEM_OPTIN


def _warp_program(layers, tiles):
    """One warp's steps over `tiles` tiles (layer_t of each layer, then the
    block barrier after it): ("acq", piece), ("rel",) and ("bar",)."""
    steps, piece = [], 0
    for _ in range(tiles):
        for n in layers:
            for c in range(n):
                steps.append(("acq", piece))
                piece += 1
                if c > 0:
                    steps.append(("rel",))
            steps += [("rel",), ("bar",)]
    return steps


def simulate_block(layers, tiles, n_stages, seed, speeds=None):
    """One block of two warpgroups of 4 warps, warpgroup g's ring of
    n_stages stages, its issuing thread in warp 0. Init: each issuing thread
    arms and issues the first n_stages pieces. A warp acquires a piece once
    the stage's full barrier completed (the issuing thread's arrival and the
    piece's bytes) and releases its oldest piece by arriving on the stage's
    empty barrier (4 arrivals); the issuing warp then waits for that barrier
    and issues the piece n_stages further on. A block barrier after every
    layer holds the 8 warps. `speeds`: each warpgroup's weight in the
    random order of the steps. Returns each warp's reads as (piece, what
    the stage held)."""
    rng = np.random.default_rng(seed)
    speeds = speeds or {}
    per_ring = sum(layers) * tiles
    keys = [(g, s) for g in range(2) for s in range(n_stages)]
    full = {k: _Mbarrier(1) for k in keys}
    empty = {k: _Mbarrier(4) for k in keys}
    stage = {k: None for k in keys}
    issued = {g: 0 for g in range(2)}
    in_flight = []                          # (g, stage, piece)
    program = _warp_program(layers, tiles)
    warps = [dict(g=g, lead=w == 0, pc=0, read=0, free=0, waiting=False, reads=[], bars=0)
             for g in range(2) for w in range(4)]
    at_bar = {}

    def issue(g):
        i = issued[g]
        full[(g, i % n_stages)].arrive(expect_tx=1)
        in_flight.append((g, i % n_stages, i))
        issued[g] += 1

    for g in range(2):
        for _ in range(min(n_stages, per_ring)):
            issue(g)

    def step(w):
        g = w["g"]
        if w["waiting"]:                    # the issuing thread's wait in release()
            f = w["free"] - 1
            if not empty[(g, f % n_stages)].try_wait((f // n_stages) & 1):
                return False
            issue(g)
            w["waiting"] = False
            return True
        if w["pc"] == len(program):
            return False
        op = program[w["pc"]]
        if op[0] == "acq":
            i = w["read"]
            assert op[1] == i
            if not full[(g, i % n_stages)].try_wait((i // n_stages) & 1):
                return False
            w["reads"].append((i, stage[(g, i % n_stages)]))
            w["read"] += 1
        elif op[0] == "rel":
            empty[(g, w["free"] % n_stages)].arrive()
            w["free"] += 1
            if w["lead"] and issued[g] < per_ring:
                w["waiting"] = True
        else:                               # the block barrier
            arrived = at_bar.setdefault(w["bars"], set())
            arrived.add(id(w))
            if len(arrived) < 8:
                return "hold"
            w["bars"] += 1
        w["pc"] += 1
        return True

    def land(k):
        g, s, piece = in_flight.pop(k)
        stage[(g, s)] = piece
        full[(g, s)].complete_tx(1)

    while True:
        actors = [("w", w) for w in warps] + [("l", k) for k in range(len(in_flight))]
        weight = np.array([speeds.get(a[1]["g"], 1.0) if a[0] == "w" else 1.0 for a in actors])
        progressed = False
        # a weighted random order of the actors (keys u^(1/weight), largest first)
        for k in np.argsort(-rng.random(len(actors)) ** (1.0 / weight)):
            kind, who = actors[k]
            if kind == "l":
                land(who)
                progressed = True
                break
            r = step(who)
            if r is True:
                progressed = True
                break
            if r == "hold" and len(at_bar[who["bars"]]) == 8:
                who["bars"] += 1
                who["pc"] += 1
                progressed = True
                break
        if not progressed:
            break
    assert all(w["pc"] == len(program) and not w["waiting"] for w in warps), \
        "the rings stopped before every warp read every piece"
    assert all(n == per_ring for n in issued.values())
    return [w["reads"] for w in warps]


@pytest.mark.parametrize("speeds", [None, {0: 1.0, 1: 0.02}], ids=["even", "apart"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", ["8x1024", "4x256_pe50_24"])
def test_rings_stream_every_piece_in_order(name, seed, speeds):
    """Both warpgroups' rings with the block barriers between layers, in
    random interleavings (the warpgroups at even speeds, and one fifty
    times the other): nothing stalls for good, every warp reads every piece
    of its warpgroup in order from a stage that holds that piece, and every
    issuing thread issued every piece (two tiles of a 2-deep net with the
    layer shape of `name`: four stages of 128-row pieces at W = 1024, two
    at W = 256)."""
    width, _, _, in_ch, in_ch_views = NETS[name]
    plan = _transposed_plan(width, 2, 1, in_ch, in_ch_views)
    nx, nd, h = -(-in_ch // 64), -(-in_ch_views // 64), width // 64
    run, run_v = plan["run"], plan["run_v"]
    # layer 0, the skip layer, the feature layer, the views layer
    layers = [nx * run, (h + nx) * run, h * run, (h + nd) * run_v]
    assert sum(layers) == plan["per_tile"]
    reads = simulate_block(layers, 2, t_stages(width), seed, speeds)
    total = 2 * sum(layers)
    for warp_reads in reads:
        assert [i for i, _ in warp_reads] == list(range(total))
        assert all(held == i for i, held in warp_reads)
