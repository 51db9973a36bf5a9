#!/usr/bin/env python3
"""Times fused_nerf_march built from variants of the MLP cores on one
NVIDIA GPU, in one process, so that design choices of the cores are
compared on the same card in the same call.

    python3 chip_variants.py [--rounds 3] [--nets 8x1024[,8x256,...]]
                             [--variants "committed,max as fmaxf"]
                             [--kernels fused_nerf_march,fused_render_tile,...]
                             [--s 64,192] [--dtypes bfloat16]
                             [--parent CHECKOUT]

Each variant is the repository's ``neuralsim_tpu_torch/kernels/csrc/`` with
a few text edits of its headers (VARIANTS below), or the ``csrc/`` of the
checkout that ``--parent`` names (default ``_archive/parent``, gitignored:
unpack the parent commit there with ``git archive``), built with nvcc under
``kernels/_build/variants/`` (gitignored, removed at the end). The script
prints each variant's ptxas registers, spills and warnings for the
ray-march kernels, then, in turns over the rounds, the times of
fused_nerf_march (or of the
wrappers that ``--kernels`` names) at N = 8192 rays on random weights of
the nets it lists (NETS: the default net at S = 64, 192 and 16
and an 8x512 net at S = 64 and 192, in float32 and bf16, whose kernel runs the
tensor-core core, which shares the weight ring; the 8x1024 net at S = 64
and 192, the FP32 core in float32 and the transposed wgmma core in bf16;
the streaming core's 8x1152 in both dtypes and 8x1664 in bf16 at S = 64),
each checked against the plain twin first (float32
2e-3, bf16 by the bf16 rule of chip_smoke.py) unless the variant is timed
only (its values are wrong by design), timed as single launches (median of
7) and as the mean of BATCH back-to-back launches (``_b10``, the device
time); then one JSON line: the median times of each variant, net and shape. ``--nets`` keeps the nets named,
``--variants`` the variants, ``--s`` the sample counts and ``--dtypes``
the dtypes. Without a CUDA device it exits nonzero.
"""

from __future__ import annotations

import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from neuralsim_tpu_torch.config import NeRFNetConfig
from neuralsim_tpu_torch.kernels import build
from neuralsim_tpu_torch.kernels import raymarch as rm
from neuralsim_tpu_torch.models.nerf import init_nerf_params

UNROLL = "#pragma unroll 8\n  for (int k = 0; k < KC; ++k) {"
# the ring with the refill moved to the last warp done with a chunk (a
# counter per stage in the empty barrier's place; every warp's lane 0
# follows the issue order), so that no warp waits for the others
EMPTY_INIT = """        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\\n"
                     ::"r"(smem_addr(empty + s)), "r"(WARPS));
"""
FIRST_ISSUES = """    if (leader()) {
      for (int s = 0; s < STAGES && left > 0; ++s) issue(s);
    }
"""
LANE0_FIRST_ISSUES = """    if ((threadIdx.x & 31) == 0) {
      for (int s = 0; s < STAGES && left > 0; ++s) {
        if (leader()) {
          issue(s);
        } else {
          next_q = next_q + 1 == plan.per_tile ? 0 : next_q + 1;
          --left;
        }
      }
    }
"""
RELEASE = """    if ((threadIdx.x & 31) == 0) {
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\\n"
                   ::"r"(smem_addr(empty + free_stage)) : "memory");
    }
    if (leader() && left > 0) {
      wait(empty + free_stage, free_phase);
      issue(free_stage);
    }
"""
LAST_WARP_RELEASE = """    if ((threadIdx.x & 31) == 0) {
      int* count = reinterpret_cast<int*>(empty + free_stage);
      if (atomicAdd(count, 1) == WARPS - 1) {
        atomicExch(count, 0);
        if (left > 0) issue(free_stage);
      } else if (left > 0) {
        next_q = next_q + 1 == plan.per_tile ? 0 : next_q + 1;
        --left;
      }
    }
"""
F32 = "nerf_mlp.cuh"
F32_WG = "nerf_mlp_wgmma.cuh"
FMAX_NAN = 'asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));'
LOAD2 = "return __ldg(reinterpret_cast<const float2*>(p));"
# the ring stage's bytes and the ring depth of the FP32 core
STAGE_BYTES = "return width == MAX_W && tile == big_tile(width) ? 32 * 1024 : 16 * 1024;"
STAGES = "constexpr int STAGES = 2;      // weight ring depth"
BIG_TILE = "constexpr int big_tile(int width) { return 128 * 256 / width; }"
# 16 KB (4-row) stages at W = 1024, the ring the 32 KB stages replaced
SMALL_STAGES = (F32, STAGE_BYTES,
                STAGE_BYTES.replace("width == MAX_W && tile == big_tile(width) ? 32 * 1024 : ",
                                    ""))
# the copy of a stage: a variant that skips it re-serves the stages' old
# bytes (its values are wrong), which bounds what the L2 weight stream costs
COPY = """    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\\n"
                 ::"r"(bar), "r"(bytes) : "memory");
    bulk_copy<1>(smem_addr(buf + s * plan.wide_bytes), plan.packed + off, bytes, bar);
"""
NO_COPY = """    (void)off;
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\\n" ::"r"(bar) : "memory");
"""
# the standard wgmma core's heads: a variant that skips them is timed only
# (its values are wrong) and bounds what they cost
DENSITY_HEAD = "  // ---- density head (alpha [W][1]) on the trunk output, CUDA cores -------\n  {"
RGB_HEAD = "  for (int j = 0; j < NV / 8; ++j) {\n    const int k0 = 8 * j + 2 * (lane & 3);"
# the standard wgmma core's cluster sizes (2 blocks at W = 512, 1 at 256),
# swapped by a variant
CLUSTERS = "constexpr int cluster_size(int width) { return width == 2 * N ? 2 : 1; }"
# the epilogue's stores into the A tiles: a variant without them is timed
# only (the next layer reads stale activations) and bounds what they cost
EPILOGUE_STORE = """    if (h != nullptr) {
      store_bf16x2(h, row, col0 + col, acc[4 * j], acc[4 * j + 1]);
      store_bf16x2(h, row + 8, col0 + col, acc[4 * j + 2], acc[4 * j + 3]);
    }"""
# the producer's copy of a chunk part: a variant without it arrives on the
# stage's full barrier alone (no bytes expected, none sent), so the
# consumers re-read the stages' old bytes
MC_COPY = """      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\\n"
                   ::"r"(bar), "r"(bytes) : "memory");
      bulk_copy<CLUSTER>(dst, src, part, bar);
"""
MC_NO_COPY = """      (void)dst;
      (void)src;
      (void)bytes;
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\\n" ::"r"(bar) : "memory");
"""
ALL = ("8x256", "8x512", "8x1024")
STREAM = "nerf_mlp_stream.cuh"
# the transposed wgmma core (bf16 at W = 1024): its rings (four stages of
# 16 KB pieces a warpgroup; two of 32 KB as the variant)
T_PIECE = "return width / 2 < 128 ? width / 2 : 128;"
T_VIEWS = "return width / 4 < 128 ? width / 4 : 128;"
T_STAGES = "return width == N ? 2 : 4;"
T_PARENT_RING = [(F32_WG, T_PIECE, "return width / 2 < 256 ? width / 2 : 256;"),
                 (F32_WG, T_VIEWS, "return width / 4;"), (F32_WG, T_STAGES, "return 2;")]
# the streaming core: its clusters, its ring depth and the copy of a piece
# (a variant without it arrives on the stage's full barrier alone, so the
# consumers re-read the stages' old bytes)
S_CLUSTERS = "inline int cluster_for(int tile) { return tile == MAX_TILE ? MAX_CLUSTER : 1; }"
S_STAGES = "constexpr int MAX_STAGES = 8;"
S_COPY = """      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\\n"
                   ::"r"(bar), "n"(PIECE) : "memory");
      const uint32_t dst = smem_addr(buf + s * PIECE) + rank * part;
      const unsigned char* src = packed + q * PIECE + rank * part;
      if (cluster == 1) {
        bulk_copy<1>(dst, src, part, bar);
      } else {
        bulk_copy<MAX_CLUSTER>(dst, src, part, bar);
      }
"""
S_NO_COPY = """      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\\n" ::"r"(bar) : "memory");
"""
WIDEST = ("8x1024",)
STREAMED = ("8x1152", "8x1664")
# variant -> ([(file, old text, new text)], the nets it is timed on); edits
# None: the csrc/ of the checkout that --parent names (default
# _archive/parent), built the same way
PARENT = "parent"
VARIANTS = {
    "committed": ([], ALL + STREAMED),
    "unroll 4": ([(F32, UNROLL, UNROLL.replace("unroll 8", "unroll 4"))], ALL),
    "last warp refills": ([
        (F32, EMPTY_INIT, "        *reinterpret_cast<int*>(empty + s) = 0;\n"),
        (F32, FIRST_ISSUES, LANE0_FIRST_ISSUES),
        (F32, RELEASE, LAST_WARP_RELEASE)], ALL),
    # the FP32 core at W = 512 on 32-point tiles with 16-row ring stages (32
    # KB; W = 256 then falls to 64-point tiles) instead of 64-point tiles
    # with 8-row stages: the alternative to the committed design the shared
    # memory of a 64-point tile with 16-row stages leaves (233,504 B)
    "W = 512: 32-point tiles, 16-row stages": ([
        (F32, STAGE_BYTES,
         STAGE_BYTES.replace(": 16 * 1024", ": width == 512 ? 32 * 1024 : 16 * 1024")),
        (F32, BIG_TILE,
         BIG_TILE.replace("128 * 256 / width", "width == 512 ? 32 : 128 * 256 / width"))],
        ("8x256", "8x512")),
    # the W = 1024 ring against its 2 stages of 32 KB (8 rows): 2, 3 and 4
    # stages of 16 KB (4 rows; 2 is the ring of the core before the split,
    # 4 the same shared memory as 2 x 32 KB). A ring deeper than 2 leaves
    # the W = 256 and 512 kernels their smaller tiles (not timed here)
    "W = 1024: 2 stages of 16 KB": ([SMALL_STAGES], ("8x1024",)),
    "W = 1024: 3 stages of 16 KB": ([SMALL_STAGES, (F32, STAGES, STAGES.replace("2;", "3;"))],
                                    ("8x1024",)),
    "W = 1024: 4 stages of 16 KB": ([SMALL_STAGES, (F32, STAGES, STAGES.replace("2;", "4;"))],
                                    ("8x1024",)),
    # timed only: no weight stream from L2 (the stages keep their bytes)
    "W = 1024: no copy (times only)": ([(F32, COPY, NO_COPY)], ("8x1024",)),
    # ReLU and the render tile's clamps as fmaxf (a NaN becomes 0; multires
    # past 128 then renders finite values where the JAX package's are NaN):
    # what max.NaN costs
    "max as fmaxf": ([(F32, FMAX_NAN, "r = fmaxf(a, b);")], ("8x256",)),
    # the wgmma core's biases read by plain loads, as before the net table
    "wgmma biases by plain loads": ([(F32_WG, LOAD2,
                                      "return *reinterpret_cast<const float2*>(p);")],
                                    ("8x256",)),
    # timed only, on the standard wgmma core (bf16 at W = 256 and 512): a
    # ring that issues no copies (what the L2 weight stream costs, the most
    # that sharing each chunk across a cluster can give), an epilogue that
    # stores nothing into the A tiles (what its stores cost), and no alpha
    # or rgb head (with the rgb head gone the views layer's epilogue is dead
    # code too)
    "wgmma: no copy (times only)": ([(F32, COPY, NO_COPY), (F32_WG, MC_COPY, MC_NO_COPY)],
                                    ("8x256", "8x512")),
    "wgmma: epilogue stores nothing (times only)": ([
        (F32_WG, EPILOGUE_STORE, EPILOGUE_STORE.replace("h != nullptr", "false"))],
        ("8x256", "8x512")),
    "wgmma: heads skipped (times only)": ([
        (F32_WG, DENSITY_HEAD, DENSITY_HEAD.replace("\n  {", "\n  if (false) {")),
        (F32_WG, RGB_HEAD, RGB_HEAD.replace("j < NV / 8", "j < 0"))], ("8x256", "8x512")),
    PARENT: (None, ("8x256", "8x512") + WIDEST),
    "wgmma: the other cluster size": ([(F32_WG, CLUSTERS, CLUSTERS.replace("? 2 : 1", "? 1 : 2"))],
                                      ("8x256", "8x512")),
    # the transposed core with rings of two stages of 32 KB pieces a
    # warpgroup, and (timed only) without the weight stream from L2
    "transposed: 2 stages of 32 KB": (T_PARENT_RING, WIDEST),
    "transposed: no copy (times only)": ([(F32, COPY, NO_COPY)], WIDEST),
    # the streaming core in clusters of 1 and of 2 at every tile (the
    # committed takes 2 on 32-point tiles only), on rings of at most 4 and 2
    # stages, and (timed only) without the weight stream from L2
    "stream: clusters of 1": ([(STREAM, S_CLUSTERS, S_CLUSTERS.replace(
        "tile == MAX_TILE ? MAX_CLUSTER : 1", "1"))], STREAMED),
    "stream: clusters of 2": ([(STREAM, S_CLUSTERS, S_CLUSTERS.replace(
        "tile == MAX_TILE ? MAX_CLUSTER : 1", "MAX_CLUSTER"))], STREAMED),
    "stream: 4 stages": ([(STREAM, S_STAGES, S_STAGES.replace("8;", "4;"))], STREAMED),
    "stream: 2 stages": ([(STREAM, S_STAGES, S_STAGES.replace("8;", "2;"))], STREAMED),
    "stream: no copy (times only)": ([(STREAM, S_COPY, S_NO_COPY)], STREAMED),
}
# back-to-back launches of one device-time sample
BATCH = 10
TIMED_ONLY = ("W = 1024: no copy (times only)", "wgmma: no copy (times only)",
              "wgmma: epilogue stores nothing (times only)", "wgmma: heads skipped (times only)",
              "transposed: no copy (times only)", "stream: no copy (times only)")
# the nets timed: the default, the reference's --netwidth 512 (at S = 64),
# mip-NeRF 360's 8x1024 (float32 on the FP32 core, bf16 on the transposed
# wgmma core), and the streaming core's 8x1152 (both dtypes) and 8x1664
# (bf16): (config, S values, dtypes)
BOTH = (torch.float32, torch.bfloat16)
NETS = {"8x256": (NeRFNetConfig(), (64, 192, 16), BOTH),
        "8x512": (NeRFNetConfig(netwidth=512, netwidth_fine=512), (64, 192), BOTH),
        "8x1024": (NeRFNetConfig(netwidth=1024, netwidth_fine=1024), (64, 192), BOTH),
        "8x1152": (NeRFNetConfig(netwidth=1152, netwidth_fine=1152), (64,), BOTH),
        "8x1664": (NeRFNetConfig(netwidth=1664, netwidth_fine=1664), (64,), (torch.bfloat16,))}


def batched_ms(fn):
    """ms per call of BATCH back-to-back calls of fn (CUDA events), after
    one: the kernel's device time, without the wrapper's host latency that a
    single launch's time carries."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(BATCH):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / BATCH


def build_variants(root: Path, names, sources, parent: Path):
    """{variant: (csrc, build dir)} of the variants named, each with the
    sources named built; prints their ptxas lines and warnings."""
    source, build_dir = build.CSRC, build.BUILD_DIR
    out = {}
    for name in names:
        edits = VARIANTS[name][0]
        d = root / re.sub(r"[^A-Za-z0-9]+", "_", name) / "csrc"
        shutil.copytree(source if edits is not None else parent, d)
        for file, old, new in edits or ():
            text = (d / file).read_text()
            if text.count(old) != 1:
                raise SystemExit(f"chip_variants: variant {name!r} no longer applies")
            (d / file).write_text(text.replace(old, new))
        build.CSRC, build.BUILD_DIR = d, d.parent / "_build"
        built = build.build_all(sources)
        lines, kernel = [], ""
        for src_name in sources:
            for line in built[src_name][2].splitlines():
                if "Compiling entry function" in line:
                    kernel = re.search(r"((nerf_march|render_tile)_(f32|wgmma)|stream_march)"
                                       r"I(L[ib]\d+E)+", line)
                    kernel = kernel.group(0) if kernel else ""
                elif kernel and ("Used" in line or "spill" in line or "warning" in line):
                    lines.append(f"{kernel}: {line.split('ptxas info    :')[-1].strip()}")
        seconds = max(b[1] for b in built.values())
        print(f"variant {name}: built in {seconds:.1f} s; ptxas: {lines}", flush=True)
        out[name] = (d, d.parent / "_build")
    build.CSRC, build.BUILD_DIR = source, build_dir
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_variants: torch.cuda.is_available() is false")
    rounds = int(sys.argv[sys.argv.index("--rounds") + 1]) if "--rounds" in sys.argv else 3
    nets = (sys.argv[sys.argv.index("--nets") + 1].split(",") if "--nets" in sys.argv
            else list(NETS))
    names = [name for name, (_, on) in VARIANTS.items() if set(on) & set(nets)]
    if "--variants" in sys.argv:
        keep = sys.argv[sys.argv.index("--variants") + 1].split(",")
        names = [name for name in names if name in keep]
    kernels = (sys.argv[sys.argv.index("--kernels") + 1].split(",") if "--kernels" in sys.argv
               else ["fused_nerf_march"])
    only_s = ({int(s) for s in sys.argv[sys.argv.index("--s") + 1].split(",")}
              if "--s" in sys.argv else None)
    only_dtypes = ({getattr(torch, d) for d in sys.argv[sys.argv.index("--dtypes") + 1].split(",")}
                   if "--dtypes" in sys.argv else None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    cases = []
    for net_name in nets:
        net, shapes, dtypes = NETS[net_name]
        shapes = [s for s in shapes if only_s is None or s in only_s]
        dtypes = tuple(d for d in dtypes if only_dtypes is None or d in only_dtypes)
        params = init_nerf_params(net, generator=gen, device="cuda")
        cases += [(net_name, net, params, s, cs.march_inputs(cs.N_RAYS, s, gen, "cuda"), dtypes)
                  for s in shapes]
    parent = Path(sys.argv[sys.argv.index("--parent") + 1] if "--parent" in sys.argv
                  else "_archive/parent") / "neuralsim_tpu_torch" / "kernels" / "csrc"
    root = build.BUILD_DIR / "variants"
    shutil.rmtree(root, ignore_errors=True)
    queries = list(rm._QUERIES)
    try:
        sources = sorted({cs.REPLACES[k][0][:-3] for k in kernels} | {"nerf_march"})
        libs = build_variants(root, names, sources, parent)
        times = {}
        for _ in range(rounds):
            for name, (csrc, build_dir) in libs.items():
                build.CSRC, build.BUILD_DIR = csrc, build_dir
                build.load.cache_clear()
                rm._library.cache_clear()
                # a parent's library may lack the newer queries
                lib = build.load("nerf_march")
                rm._QUERIES[:] = [q for q in queries if hasattr(lib, q[0])]
                for net_name, net, params, s, r, dtypes in cases:
                    if net_name not in VARIANTS[name][1]:
                        continue
                    for kernel, dtype in [(k, d) for k in kernels for d in dtypes]:
                        wrapper, _, inputs = cs.KERNELS[kernel]
                        args = inputs(net, r)
                        key = f"{net_name}_{str(dtype)[6:]}_S{s}"
                        if kernel != "fused_nerf_march":
                            key = f"{kernel}_{key}"
                        with torch.no_grad():
                            if name not in TIMED_ONLY:
                                cs.check(kernel, params, args, net, dtype, f"variant {name} {key}")
                            fn = lambda: wrapper(params, *args, net, compute_dtype=dtype)  # noqa: E731
                            ms = cs.time_ms(fn, reps=7 if net_name in ("8x256", "8x512")
                                            else 3 if net_name in STREAMED else 5)
                            b10 = batched_ms(fn)
                        times.setdefault(name, {}).setdefault(key, []).append(ms)
                        times[name].setdefault(f"{key}_b{BATCH}", []).append(b10)
                        print(f"variant {name} {key}: {ms:.3f} ms, mean of {BATCH} back to back "
                              f"{b10:.3f} ms", flush=True)
    finally:
        rm._QUERIES[:] = queries
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"card": smi, "rounds": rounds, "median_ms": {
        name: {k: statistics.median(v) for k, v in t.items()} for name, t in times.items()}}),
        flush=True)


if __name__ == "__main__":
    main()
