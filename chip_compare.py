#!/usr/bin/env python3
"""Times the port's MLP kernels and renders (float32, and a few in bf16) of two checkouts
of this repository (or more) on one NVIDIA GPU, in turns, so that versions
of a kernel are compared on the same card in the same call.

    python3 chip_compare.py OLD_CHECKOUT NEW_CHECKOUT [MORE ...] [--rounds 2]

Each round runs the checkouts in order and then in reverse (OLD, NEW, NEW,
OLD for two); each run is a child process started in that checkout
(``neuralsim_tpu_torch`` imported from there, its kernels built there), so
the versions never share a library. A child times, on
random weights of the default net (8x256, PE 10/4) and the pipeline's ray
shapes (``chip_smoke.march_inputs``' camera sphere):
  - each of the five kernel wrappers in float32 at N = 8192 rays x S = 64
    and 192 samples (M = N*S points for the point-major ones), and
    fused_nerf_march also at S = 16 and at N = 32768, S = 16; each in bf16
    (the tensor-core core) at S = 192, and fused_nerf_march in bf16 at
    S = 64 too;
  - NeuralSimRenderer.render_images on box-scene weights, K = 8 poses at
    100x100: the exact render (64 + 128 samples, the ray march) in float32
    and bf16, and the production render (production_mode()) in float32;
with CUDA events (kernels: median of 7 single launches after 2 warm-ups,
and as KEY_b10 the median of 3 means over 10 back-to-back launches, the
kernel's device time) and the host clock around a synchronised render
(median of RENDERS). It prints one JSON line per run, then a summary line:
the median over a version's runs of each number, and each later
checkout's medians over OLD's. Without a CUDA device it exits nonzero.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

CHILD = "--child"
# back-to-back launches of one device-time sample
BATCH = 10
# synchronised renders of one render-time median (a 28 ms production render
# moves by up to 9% between renders)
RENDERS = 9


def child():
    # the checkout is the working directory; this file may lie elsewhere
    sys.path[0] = os.getcwd()
    import torch

    from neuralsim_tpu_torch.bilevel.psi_init import psi_init
    from neuralsim_tpu_torch.config import NeRFNetConfig, NeuralSimConfig
    from neuralsim_tpu_torch.kernels import build
    from neuralsim_tpu_torch.kernels import raymarch as rm
    from neuralsim_tpu_torch.models.box_scene import box_scene_params
    from neuralsim_tpu_torch.models.nerf import init_nerf_params
    from neuralsim_tpu_torch.ops.encoding import positional_encoding
    from neuralsim_tpu_torch.pipeline import NeuralSimRenderer

    if not torch.cuda.is_available():
        raise SystemExit("chip_compare: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    dev = torch.device("cuda")
    net = NeRFNetConfig()
    gen = torch.Generator().manual_seed(0)
    params = init_nerf_params(net, generator=gen, device=dev)

    def events(fn, reps=7, warmup=2, batch=1):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(batch):
                fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b) / batch)
        return statistics.median(times)

    def time_kernel(key, fn):
        # one launch between the events (what one call costs the stream, the
        # wrapper's host latency included: +-3% between identical kernels
        # of ~5 ms), and the mean over BATCH back-to-back launches (the
        # kernel's device time)
        out[key] = events(fn)
        out[f"{key}_b{BATCH}"] = events(fn, reps=3, warmup=1, batch=BATCH)

    def rays(n, s):
        o = torch.randn(n, 3, generator=gen)
        o = 1.01 * o / o.norm(dim=-1, keepdim=True)
        d = -o / 1.01 + 0.05 * torch.randn(n, 3, generator=gen)
        vd = d / d.norm(dim=-1, keepdim=True)
        z = torch.sort(0.31 + 1.62 * torch.rand(n, s, generator=gen), dim=-1).values
        return [t.to(dev) for t in (o, d, vd, z)]

    out = {"checkout": os.getcwd()}
    f32 = torch.float32
    with torch.no_grad():
        for n, s in ((8192, 64), (8192, 192), (8192, 16), (32768, 16)):
            r = rays(n, s)
            key = f"S{s}" if n == 8192 else f"N{n}_S{s}"
            time_kernel(f"fused_nerf_march_f32_{key}",
                        lambda: rm.fused_nerf_march(params, *r, net, f32))
            if n != 8192 or s == 16:
                continue
            time_kernel(f"fused_nerf_march_bf16_{key}",
                        lambda: rm.fused_nerf_march(params, *r, net, torch.bfloat16))
            time_kernel(f"fused_render_tile_f32_{key}",
                        lambda: rm.fused_render_tile(params, *r, net, compute_dtype=f32))
            pts, dirs = rm.ray_points(*r)
            x_pe, d_pe = (positional_encoding(pts, net.multires),
                          positional_encoding(dirs, net.multires_views))
            for name, fn, a, b in (("fused_nerf_mlp_widepe", rm.fused_nerf_mlp_widepe, pts, dirs),
                                   ("fused_nerf_mlp_pe", rm.fused_nerf_mlp_pe, pts, dirs),
                                   ("fused_nerf_mlp", rm.fused_nerf_mlp, x_pe, d_pe)):
                time_kernel(f"{name}_f32_{key}", lambda: fn(params, a, b, net, f32))
            if s == 192:
                time_kernel("fused_render_tile_bf16_S192",
                            lambda: rm.fused_render_tile(params, *r, net,
                                                         compute_dtype=torch.bfloat16))
                for name, fn, a, b in (
                        ("fused_nerf_mlp_widepe", rm.fused_nerf_mlp_widepe, pts, dirs),
                        ("fused_nerf_mlp_pe", rm.fused_nerf_mlp_pe, pts, dirs),
                        ("fused_nerf_mlp", rm.fused_nerf_mlp, x_pe, d_pe)):
                    time_kernel(f"{name}_bf16_S192",
                                lambda: fn(params, a, b, net, torch.bfloat16))
            del r, pts, dirs, x_pe, d_pe
            torch.cuda.empty_cache()

        box = box_scene_params(net, generator=torch.Generator().manual_seed(0), device=dev)
        models = {"coarse": box, "fine": box}
        psi = psi_init("5")
        for tag, production, dtype in (("exact_f32", False, "float32"),
                                       ("exact_bf16", False, "bfloat16"),
                                       ("production_f32", True, "float32")):
            cfg = NeuralSimConfig()
            rc = dataclasses.replace(cfg.render, compute_dtype=dtype)
            cfg = cfg.replace(render=rc.production_mode() if production else rc)
            renderer = NeuralSimRenderer(cfg, models=models, device=dev)
            noise = renderer.render_images(psi, torch.Generator().manual_seed(0), num_k=8)[1]
            seconds = []
            for _ in range(RENDERS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                renderer._render_impl(psi, noise)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
            out[f"render_{tag}_s"] = statistics.median(seconds)
            out[f"render_{tag}_budget"] = renderer.rc.hit_budget
    print("RESULT " + json.dumps(out), flush=True)


def main():
    args = [a for a in sys.argv[1:] if a != CHILD]
    rounds = 1
    if "--rounds" in args:
        i = args.index("--rounds")
        rounds = int(args[i + 1])
        del args[i:i + 2]
    if len(args) < 2:
        raise SystemExit(__doc__)
    checkouts = [os.path.abspath(a) for a in args]
    labels = ["old", "new"] + [f"new{i}" for i in range(2, len(checkouts))]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    runs = {checkout: [] for checkout in checkouts}
    for _ in range(rounds):
        for checkout in checkouts + checkouts[::-1]:
            proc = subprocess.run([sys.executable, "-u", os.path.abspath(__file__), CHILD],
                                  cwd=checkout, capture_output=True, text=True, timeout=1200)
            lines = [l for l in proc.stdout.splitlines() if l.startswith("RESULT ")]
            if proc.returncode != 0 or not lines:
                sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
                raise SystemExit(f"chip_compare: the run in {checkout} failed")
            result = json.loads(lines[-1][len("RESULT "):])
            runs[checkout].append(result)
            print(json.dumps(result), flush=True)
    summary = {}
    for label, checkout in zip(labels, checkouts):
        keys = [k for k in runs[checkout][0] if k != "checkout"]
        summary[label] = {k: statistics.median(r[k] for r in runs[checkout]) for k in keys}
    for label in labels[1:]:
        summary[f"{label}_over_old"] = {k: v / summary["old"][k]
                                        for k, v in summary[label].items() if summary["old"].get(k)}
    print(json.dumps({"card": smi, "summary": summary}), flush=True)


if __name__ == "__main__":
    if CHILD in sys.argv:
        child()
    else:
        main()
