#!/usr/bin/env python3
"""Times fused_nerf_march built from variants of the MLP cores on one
NVIDIA GPU, in one process, so that design choices of the cores are
compared on the same card in the same call.

    python3 chip_variants.py [--rounds 3]

Each variant is the repository's ``neuralsim_tpu_torch/kernels/csrc/`` with
a few text edits of ``nerf_mlp.cuh`` (VARIANTS below), built with nvcc under ``kernels/_build/variants/`` (gitignored,
removed at the end). The script prints each variant's ptxas registers and
spills for the ray-march kernels, then, in turns over the rounds,
its times in float32 and bf16 (the bf16 kernel runs the tensor-core core,
which shares the weight ring) at N = 8192 rays on random weights of the
default net (S = 64, 192 and 16) and of an 8x512 net (S = 64), each
checked against the plain twin first (float32 2e-3, bf16 by the bf16 rule
of chip_smoke.py); then one JSON line: the median time of each variant,
net and shape. Without a CUDA device it exits nonzero.
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
# the FP32 core at W = 512 on 32-point tiles with 16-row ring stages (32 KB;
# W = 256 then falls to 64-point tiles) instead of 64-point tiles with
# 8-row stages: the alternative to the committed design the shared memory
# of a 64-point tile with 16-row stages leaves (233,504 B)
STAGE_BYTES = "constexpr int WIDE_BYTES = 16 * 1024;"
BIG_TILE = "constexpr int big_tile(int width) { return 128 * 256 / width; }"
F32 = "nerf_mlp.cuh"
# variant -> [(file, old text, new text)]
VARIANTS = {
    "committed": [],
    "unroll 4": [(F32, UNROLL, UNROLL.replace("unroll 8", "unroll 4"))],
    "last warp refills": [
        (F32, EMPTY_INIT, "        *reinterpret_cast<int*>(empty + s) = 0;\n"),
        (F32, FIRST_ISSUES, LANE0_FIRST_ISSUES),
        (F32, RELEASE, LAST_WARP_RELEASE)],
    "W = 512: 32-point tiles, 16-row stages": [
        (F32, STAGE_BYTES, STAGE_BYTES.replace("16 * 1024", "32 * 1024")),
        (F32, BIG_TILE,
         BIG_TILE.replace("128 * 256 / width", "width == 512 ? 32 : 128 * 256 / width"))],
}
# the nets timed: the default, and the reference's --netwidth 512 (at S = 64)
NETS = {"8x256": (NeRFNetConfig(), (64, 192, 16)),
        "8x512": (NeRFNetConfig(netwidth=512, netwidth_fine=512), (64,))}


def build_variants(root: Path):
    """{variant: (csrc, build dir)}, each built; prints ptxas lines."""
    source, build_dir = build.CSRC, build.BUILD_DIR
    out = {}
    for name, edits in VARIANTS.items():
        d = root / name.replace(" ", "_").replace(",", "") / "csrc"
        shutil.copytree(source, d)
        for file, old, new in edits:
            text = (d / file).read_text()
            if text.count(old) != 1:
                raise SystemExit(f"chip_variants: variant {name!r} no longer applies")
            (d / file).write_text(text.replace(old, new))
        build.CSRC, build.BUILD_DIR = d, d.parent / "_build"
        _, seconds, report = build.build_all(["nerf_march"])["nerf_march"]
        lines, kernel = [], ""
        for line in report.splitlines():
            if "Compiling entry function" in line:
                kernel = re.search(r"nerf_march_(f32|wgmma)ILi(\d+)ELi(\d+)", line).group(0)[11:]
            elif "Used" in line or "spill" in line:
                lines.append(f"{kernel}: {line.split('ptxas info    :')[-1].strip()}")
        print(f"variant {name}: built in {seconds:.1f} s; ptxas: {lines}", flush=True)
        out[name] = (d, d.parent / "_build")
    build.CSRC, build.BUILD_DIR = source, build_dir
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_variants: torch.cuda.is_available() is false")
    rounds = int(sys.argv[sys.argv.index("--rounds") + 1]) if "--rounds" in sys.argv else 3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    cases = [(net_name, net, init_nerf_params(net, generator=gen, device="cuda"), s,
              cs.march_inputs(cs.N_RAYS, s, gen, "cuda"))
             for net_name, (net, shapes) in NETS.items() for s in shapes]
    root = build.BUILD_DIR / "variants"
    shutil.rmtree(root, ignore_errors=True)
    try:
        libs = build_variants(root)
        times = {}
        for _ in range(rounds):
            for name, (csrc, build_dir) in libs.items():
                build.CSRC, build.BUILD_DIR = csrc, build_dir
                build.load.cache_clear()
                rm._library.cache_clear()
                for net_name, net, params, s, r in cases:
                    for dtype in (torch.float32, torch.bfloat16):
                        key = f"{net_name}_{str(dtype)[6:]}_S{s}"
                        with torch.no_grad():
                            cs.check("fused_nerf_march", params, r, net, dtype,
                                     f"variant {name} {key}")
                            ms = cs.time_ms(lambda: rm.fused_nerf_march(params, *r, net, dtype))
                        times.setdefault(name, {}).setdefault(key, []).append(ms)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"card": smi, "rounds": rounds, "median_ms": {
        name: {k: statistics.median(v) for k, v in t.items()} for name, t in times.items()}}),
        flush=True)


if __name__ == "__main__":
    main()
