#!/usr/bin/env python3
"""Times the port's MLP kernels and renders (float32, and a few in bf16) of two checkouts
of this repository (or more) on one NVIDIA GPU, in turns, so that versions
of a kernel are compared on the same card in the same call.

    python3 chip_compare.py OLD_CHECKOUT NEW_CHECKOUT [MORE ...] [--rounds 2]
                            [--net 8x1024[,8x1152,...]] [--dtypes bfloat16]

Each round runs the checkouts in order and then in reverse (OLD, NEW, NEW,
OLD for two); each run is a child process started in that checkout
(``neuralsim_tpu_torch`` imported from there, its kernels built there), so
the versions never share a library. A child times, on
random weights of the default net (8x256, PE 10/4) and the pipeline's ray
shapes (``chip_smoke.march_inputs``' camera sphere):
  - each of the five kernel wrappers in float32 and in bf16 (the tensor-core
    core) at N = 8192 rays x S = 64 and 192 samples (M = N*S points for the
    point-major ones), and fused_nerf_march in float32 also at S = 16 and at
    N = 32768, S = 16;
  - each of the five in bf16 on random weights of the 8x512 net at S = 64
    and 192 (the standard wgmma core's other width), and fused_nerf_march in
    bf16 on the 8x1024 net at S = 64 (the transposed wgmma core);
  - NeuralSimRenderer.render_images on box-scene weights, K = 8 poses at
    100x100: the exact render (64 + 128 samples, the ray march) in float32
    and bf16, and the production render (production_mode()) in float32;
with CUDA events (kernels: median of 7 single launches after 2 warm-ups,
and as KEY_b10 the median of 3 means over 10 back-to-back launches, the
kernel's device time) and the host clock around a synchronised render
(median of RENDERS). With ``--net 8x1024`` a child times instead, on random
weights of the 8x1024 net (mip-NeRF 360's width; PE 10/4):
  - each of the five kernel wrappers in float32 at N = 8192 rays x S = 64
    and 192 (median of 3 single launches after a warm-up, and as KEY_b10
    the mean over 10 back-to-back launches), beside the same shapes' plain
    twin (median of 3) and chain_ms (the MLP as one torch.matmul per layer
    on encodings computed beforehand, TF32 off; median of 3);
  - the same five in bf16 (the transposed wgmma core) at S = 64 and 192,
    and chain_ms in bf16;
  - NeuralSimRenderer.render_images on 8x1024 box-scene weights, K = 8
    poses at 100x100, the exact render in float32 through each of the three
    march routes (median of WIDE_RENDERS after one untimed render).
With ``--net`` naming a net of chip_smoke.py's STREAM_NETS (8x1152,
8x1664, 8x256_pe75, 8x1024_pe60_20: the streaming core) a child times, on
its random weights, in each dtype the net runs, every kernel at N = 8192 x
S = 64 and the ray march and the render tile at S = 192: the device time
(KEY_dev: one timed launch, then the mean of as many back-to-back launches
as fill about 1.5 s, 2 to 10: a slow checkout's launches cost seconds)
and chain_ms in the same dtype (median of 3). ``--net`` takes a comma
list (each child times every net listed), and ``--dtypes`` keeps the
dtypes named (the float32 renders run only with float32).
It prints one JSON line per run, then a summary line: the median over a
version's runs of each number, and each later checkout's medians over
OLD's; and, for the default net, each checkout's bf16 outputs of the five
kernels at S = 192, the 8x512 net's at S = 64 and the 8x1024 net's at S =
64 on random and on He-scaled weights (the same weights and rays in every
checkout) against OLD's: bit-equal, or the largest difference; and the
8x1024 bf16 render tile on SMOKE_DRAWS' inputs (smoke_draws), each
checkout's against the twin by the bf16 rule, beside the twin against its
float64 and chunk-order sums (smoke_draws_witness). Without a CUDA device
it exits nonzero.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

CHILD = "--child"
# back-to-back launches of one device-time sample
BATCH = 10
# synchronised renders of one render-time median (a 28 ms production render
# moves by up to 9% between renders)
RENDERS = 9
# the same for the 8x1024 renders (~10 s each in float32)
WIDE_RENDERS = 2
# the nets a child times: the default (every kernel, both dtypes, three
# renders), the 8x1024 net (kernels in both dtypes, float32 twins, chain_ms,
# float32 renders) or the streaming core's nets (chip_smoke.STREAM_NETS)
NETS = ("default", "8x1024")
STREAM = ("8x1152", "8x1664", "8x256_pe75", "8x1024_pe60_20")
# the streaming core's device time: back-to-back launches filling about
# DEVICE_WINDOW ms, at least 2 and at most BATCH
DEVICE_WINDOW = 1500.0
# the transposed core's other nets, whose bf16 outputs the default run
# saves on ragged rays (chip_smoke.EXTRA_NETS)
TRANSPOSED_OTHERS = ("8x512_pe42_20", "4x256_pe50_24")
# the environment variable naming the file where a child saves its bf16
# outputs (the first run of each checkout)
OUTPUTS = "CHIP_COMPARE_OUTPUTS"
# the environment variable naming the file of SMOKE_DRAWS' inputs
DRAWS = "CHIP_COMPARE_DRAWS"


def events(fn, reps=7, warmup=2, batch=1):
    """Median ms of reps timings (CUDA events) of `batch` back-to-back calls
    of fn, per call, after `warmup` calls."""
    import torch

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


def device_time(fn):
    """(ms per call, calls): one timed call, then the mean of back-to-back
    calls filling about DEVICE_WINDOW ms (2 to BATCH of them)."""
    import torch

    first = events(fn, reps=1, warmup=0)
    n = max(2, min(BATCH, int(DEVICE_WINDOW / max(first, 1e-3))))
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n, n


def child_stream(out, rays, name, dtypes):
    """A streaming-core net's numbers into out: each kernel's device time
    in each dtype the net runs at S = 64 (the ray march and the render tile
    also at 192) and chain_ms."""
    import torch

    import chip_smoke as cs
    from neuralsim_tpu_torch.config import NeRFNetConfig
    from neuralsim_tpu_torch.models.nerf import init_nerf_params

    kw, runs = cs.STREAM_NETS[name]
    net = NeRFNetConfig(**kw)
    params = init_nerf_params(net, generator=torch.Generator().manual_seed(0), device="cuda")
    with torch.no_grad():
        for s in (64, 192):
            r = rays(8192, s)
            for dtype in [d for d in runs if d in dtypes]:
                cd, dt = getattr(torch, dtype), "f32" if dtype == "float32" else "bf16"
                out[f"{name}_chain_{dt}_S{s}"] = cs.time_chain(params, net, r, cd, reps=3,
                                                               warmup=1)
                for kernel, (wrapper, _, inputs) in cs.KERNELS.items():
                    if s != 64 and kernel not in cs.STREAM_S192:
                        continue
                    args = inputs(net, r)
                    key = f"{name}_{kernel}_{dt}_S{s}"
                    out[f"{key}_dev"], out[f"{key}_calls"] = device_time(
                        lambda: wrapper(params, *args, net, compute_dtype=cd))
                    del args
            del r
            torch.cuda.empty_cache()


def child_widest(out, rays, dtypes):
    """The --net 8x1024 numbers into out (rays(n, s): a ray batch on the
    card), in the dtypes named."""
    import torch

    from chip_smoke import chain_mlp
    from neuralsim_tpu_torch.bilevel.psi_init import psi_init
    from neuralsim_tpu_torch.config import NeRFNetConfig, NeuralSimConfig
    from neuralsim_tpu_torch.kernels import raymarch as rm
    from neuralsim_tpu_torch.models.box_scene import box_scene_params
    from neuralsim_tpu_torch.models.nerf import init_nerf_params, nerf_apply
    from neuralsim_tpu_torch.ops.encoding import positional_encoding
    from neuralsim_tpu_torch.pipeline import NeuralSimRenderer

    dev = torch.device("cuda")
    f32 = torch.float32
    net = NeRFNetConfig(netwidth=1024, netwidth_fine=1024)
    params = init_nerf_params(net, generator=torch.Generator().manual_seed(0), device=dev)
    bf16 = torch.bfloat16
    with torch.no_grad():
        for s in (64, 192):
            r = rays(8192, s)
            pts, dirs = rm.ray_points(*r)
            x_pe, d_pe = (positional_encoding(pts, net.multires),
                          positional_encoding(dirs, net.multires_views))
            kernels = (("fused_nerf_march", rm.fused_nerf_march, rm.march_channels_ref, r),
                       ("fused_nerf_mlp_widepe", rm.fused_nerf_mlp_widepe, rm.mlp_widepe_ref,
                        (pts, dirs)),
                       ("fused_render_tile", rm.fused_render_tile, rm.render_tile_ref, r),
                       ("fused_nerf_mlp", rm.fused_nerf_mlp, nerf_apply, (x_pe, d_pe)),
                       ("fused_nerf_mlp_pe", rm.fused_nerf_mlp_pe, rm.mlp_pe_ref, (pts, dirs)))
            for name, fn, twin, args in kernels:
                if "float32" in dtypes:
                    key = f"{name}_f32_S{s}"
                    out[key] = events(lambda: fn(params, *args, net, compute_dtype=f32), 3, 1)
                    out[f"{key}_b{BATCH}"] = events(
                        lambda: fn(params, *args, net, compute_dtype=f32), 1, 0, BATCH)
                    out[f"{key}_twin"] = events(
                        lambda: twin(params, *args, net, compute_dtype=f32), 3, 1)
                if "bfloat16" in dtypes:
                    key = f"{name}_bf16_S{s}"
                    out[key] = events(lambda: fn(params, *args, net, compute_dtype=bf16), 3, 1)
                    out[f"{key}_b{BATCH}"] = events(
                        lambda: fn(params, *args, net, compute_dtype=bf16), 3, 1, BATCH)
            for dtype, dt in ((f32, "float32"), (bf16, "bfloat16")):
                if dt in dtypes:
                    p = {k: v.to(dtype) for k, v in params.items()}
                    a, b = x_pe.to(dtype), d_pe.to(dtype)
                    out[f"chain_{'f32' if dtype == f32 else 'bf16'}_S{s}"] = events(
                        lambda: chain_mlp(p, a, b, net), 3, 1)
                    del p, a, b
            del r, pts, dirs, x_pe, d_pe
            torch.cuda.empty_cache()
        if "float32" not in dtypes:
            return
        box = box_scene_params(net, generator=torch.Generator().manual_seed(3), device=dev)
        psi = psi_init("5")
        routes = {"fused_nerf_march": {}, "fused_nerf_mlp_widepe": dict(fuse_pointgen=False),
                  "fused_render_tile": dict(fuse_compositing=True)}
        for route, opts in routes.items():
            cfg = NeuralSimConfig().replace(net=net)
            cfg = cfg.replace(render=dataclasses.replace(cfg.render, compute_dtype="float32",
                                                         **opts))
            renderer = NeuralSimRenderer(cfg, models={"coarse": box, "fine": box}, device=dev)
            noise = renderer.render_images(psi, torch.Generator().manual_seed(0), num_k=8)[1]
            seconds = []
            for _ in range(WIDE_RENDERS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                renderer._render_impl(psi, noise)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
            out[f"render_{route}_f32_s"] = statistics.median(seconds)


def child(net_names, dtypes):
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
    outputs = {}
    if net_names != ["default"]:
        for name in net_names:
            if name == "8x1024":
                child_widest(out, rays, dtypes)
            else:
                child_stream(out, rays, name, dtypes)
        print("RESULT " + json.dumps(out), flush=True)
        return
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
            time_kernel(f"fused_render_tile_bf16_{key}",
                        lambda: rm.fused_render_tile(params, *r, net,
                                                     compute_dtype=torch.bfloat16))
            for name, fn, a, b in (
                    ("fused_nerf_mlp_widepe", rm.fused_nerf_mlp_widepe, pts, dirs),
                    ("fused_nerf_mlp_pe", rm.fused_nerf_mlp_pe, pts, dirs),
                    ("fused_nerf_mlp", rm.fused_nerf_mlp, x_pe, d_pe)):
                time_kernel(f"{name}_bf16_{key}", lambda: fn(params, a, b, net, torch.bfloat16))
            if s == 192:
                bf16_outputs(outputs, "default", params, net, r, pts, dirs, x_pe, d_pe)
            del r, pts, dirs, x_pe, d_pe
            torch.cuda.empty_cache()
        wide_bf16(out, outputs, rays)

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
    save = os.environ.get(OUTPUTS)
    if save and not os.path.exists(save):
        torch.save(outputs, save)
    print("RESULT " + json.dumps(out), flush=True)


def bf16_outputs(outputs, net_name, params, net, r, pts, dirs, x_pe, d_pe):
    """The five kernels' bf16 outputs on one ray batch, on the CPU, into
    outputs[net_name]."""
    import torch

    from neuralsim_tpu_torch.kernels import raymarch as rm

    bf16 = torch.bfloat16
    with torch.no_grad():
        got = {"fused_nerf_march": rm.fused_nerf_march(params, *r, net, bf16),
               "fused_render_tile": rm.fused_render_tile(params, *r, net, compute_dtype=bf16),
               "fused_nerf_mlp_widepe": rm.fused_nerf_mlp_widepe(params, pts, dirs, net, bf16),
               "fused_nerf_mlp_pe": rm.fused_nerf_mlp_pe(params, pts, dirs, net, bf16),
               "fused_nerf_mlp": rm.fused_nerf_mlp(params, x_pe, d_pe, net, bf16)}
    outputs[net_name] = {k: [t.cpu() for t in (v if isinstance(v, tuple) else (v,))]
                         for k, v in got.items()}


def he_scaled(params):
    """chip_smoke.py's He-scaled weights: every kernel times sqrt(6)."""
    return {k: v * (6 ** 0.5 if k.endswith("kernel") else 1.0) for k, v in params.items()}


def wide_bf16(out, outputs, rays):
    """The five kernels in bf16 on the 8x512 net at S = 64 and 192 (their
    outputs at S = 64 into outputs["8x512"]), and fused_nerf_march in bf16
    on the 8x1024 net at S = 64, into out; the five's outputs on the 8x1024
    net at S = 64 on its random and He-scaled weights into
    outputs["8x1024"] and ["8x1024_he"], on the other transposed-core nets
    (TRANSPOSED_OTHERS) at the ragged 1001 x 48 into outputs[name] and
    [name + "_he"], and the render tile's on the SMOKE_DRAWS inputs (the
    file DRAWS names) into ["smoke_draws"]."""
    import torch

    from neuralsim_tpu_torch.config import NeRFNetConfig
    from neuralsim_tpu_torch.kernels import raymarch as rm
    from neuralsim_tpu_torch.models.nerf import init_nerf_params
    from neuralsim_tpu_torch.ops.encoding import positional_encoding

    bf16 = torch.bfloat16
    for width in (512, 1024):
        net = NeRFNetConfig(netwidth=width, netwidth_fine=width)
        params = init_nerf_params(net, generator=torch.Generator().manual_seed(width),
                                  device="cuda")
        with torch.no_grad():
            for s in ((64, 192) if width == 512 else (64,)):
                r = rays(8192, s)
                pts, dirs = rm.ray_points(*r)
                x_pe, d_pe = (positional_encoding(pts, net.multires),
                              positional_encoding(dirs, net.multires_views))
                kernels = (("fused_nerf_march", lambda: rm.fused_nerf_march(params, *r, net, bf16)),
                           ("fused_render_tile", lambda: rm.fused_render_tile(
                               params, *r, net, compute_dtype=bf16)),
                           ("fused_nerf_mlp_widepe", lambda: rm.fused_nerf_mlp_widepe(
                               params, pts, dirs, net, bf16)),
                           ("fused_nerf_mlp_pe", lambda: rm.fused_nerf_mlp_pe(
                               params, pts, dirs, net, bf16)),
                           ("fused_nerf_mlp", lambda: rm.fused_nerf_mlp(
                               params, x_pe, d_pe, net, bf16)))
                for name, fn in kernels[:1 if width == 1024 else 5]:
                    key = f"{name}_bf16_8x{width}_S{s}"
                    out[key] = events(fn, reps=3, warmup=1)
                    out[f"{key}_b{BATCH}"] = events(fn, reps=3, warmup=1, batch=BATCH)
                if s == 64:
                    bf16_outputs(outputs, f"8x{width}", params, net, r, pts, dirs, x_pe, d_pe)
                if width == 1024:
                    bf16_outputs(outputs, "8x1024_he", he_scaled(params), net, r, pts, dirs,
                                 x_pe, d_pe)
                del r, pts, dirs, x_pe, d_pe
                torch.cuda.empty_cache()
    import chip_smoke as cs

    for name in TRANSPOSED_OTHERS:
        net = NeRFNetConfig(**cs.EXTRA_NETS[name])
        params = init_nerf_params(net, generator=torch.Generator().manual_seed(17),
                                  device="cuda")
        r = rays(*cs.RAGGED)
        pts, dirs = rm.ray_points(*r)
        x_pe, d_pe = (positional_encoding(pts, net.multires),
                      positional_encoding(dirs, net.multires_views))
        bf16_outputs(outputs, name, params, net, r, pts, dirs, x_pe, d_pe)
        bf16_outputs(outputs, f"{name}_he", he_scaled(params), net, r, pts, dirs, x_pe, d_pe)
        del r, pts, dirs, x_pe, d_pe
    net = NeRFNetConfig(netwidth=1024, netwidth_fine=1024)
    if os.environ.get(DRAWS):
        params, r = torch.load(os.environ[DRAWS])
        got = rm.fused_render_tile({k: v.cuda() for k, v in params.items()},
                                   *[t.cuda() for t in r], net, compute_dtype=bf16)
        outputs["smoke_draws"] = {"fused_render_tile": [t.cpu() for t in got]}


def smoke_draws(path):
    """SMOKE_DRAWS: the inputs that chip_smoke.py's phase 3 gave the 8x1024
    net's He-scaled check at its ragged shape (1,001 rays x 48 samples)
    while its cluster walks still drew from the phase's generator, made on
    the CPU and saved to path: (He-scaled params, rays). There the bf16
    render tile moved the depth of 2 of the 1,001 rays past the bf16 rule."""
    import torch

    import chip_smoke as cs
    from neuralsim_tpu_torch.config import NeRFNetConfig
    from neuralsim_tpu_torch.models.box_scene import box_scene_params
    from neuralsim_tpu_torch.models.nerf import init_nerf_params

    gen, cpu = torch.Generator().manual_seed(0), "cpu"
    init_nerf_params(NeRFNetConfig(), generator=gen, device=cpu)
    box_scene_params(NeRFNetConfig(), generator=gen, device=cpu)
    for n, s, _ in cs.RAY_SHAPES:
        cs.march_inputs(n, s, gen, cpu)
    for net in (NeRFNetConfig(), NeRFNetConfig(**cs.EXTRA_NETS[cs.WIDE])):
        init_nerf_params(net, generator=gen, device=cpu)
        for n, s in cs.CLUSTER_SHAPES + ((cs.N_RAYS, 192),):
            cs.march_inputs(n, s, gen, cpu)
    for name, kw in cs.EXTRA_NETS.items():
        params = init_nerf_params(NeRFNetConfig(**kw), generator=gen, device=cpu)
        shapes = [sh for sh in cs.EXTRA_SHAPES if name not in cs.RAGGED_ONLY or sh[0] != cs.N_RAYS]
        rays = {sh: cs.march_inputs(*sh, gen, cpu) for sh in shapes}
        if name == "8x1024":
            torch.save((he_scaled(params), rays[cs.RAGGED]), path)
            return


def smoke_draws_witness(path, outputs, labels):
    """On SMOKE_DRAWS' inputs, the bf16 rule's share of values past it and
    the largest difference, per output (rgb, disp, acc, weights, depth):
    each checkout's render tile against the twin, and the twin against
    itself with float64 sums and with each layer's products summed in
    float32 over 64-row chunks one after another (the cores' order)."""
    import torch

    import chip_smoke as cs
    import neuralsim_tpu_torch.models.nerf as tn
    from neuralsim_tpu_torch.config import NeRFNetConfig
    from neuralsim_tpu_torch.kernels import raymarch as rm

    torch.backends.cuda.matmul.allow_tf32 = False
    net = NeRFNetConfig(**cs.EXTRA_NETS["8x1024"])
    params, r = torch.load(path)
    params, r = {k: v.cuda() for k, v in params.items()}, [t.cuda() for t in r]

    def twin(p, rays):
        with torch.no_grad():
            return rm.render_tile_ref(p, *rays, net, compute_dtype=torch.bfloat16)

    def chunked(h, kernel, bias, compute_dtype):
        a, w = tn.round_to(h, compute_dtype), tn.round_to(kernel, compute_dtype)
        acc = torch.zeros(a.shape[0], w.shape[1], dtype=a.dtype, device=a.device)
        for k0 in range(0, a.shape[1], 64):
            acc = acc + a[:, k0:k0 + 64] @ w[k0:k0 + 64]
        return acc + bias.to(a.dtype)

    def rule(got, want):
        return [(cs.bf16_rule(g.double().cuda(), w.double())[1],
                 float((g.double().cuda() - w.double()).abs().max())) for g, w in zip(got, want)]

    want = twin(params, r)
    out = {label: rule(o["smoke_draws"]["fused_render_tile"], want)
           for label, o in zip(labels, outputs)}
    out["twin_float64"] = rule(twin({k: v.double() for k, v in params.items()},
                                    [t.double() for t in r]), want)
    plain, tn._dense = tn._dense, chunked
    try:
        out["twin_chunk_order"] = rule(twin(params, r), want)
    finally:
        tn._dense = plain
    return out


def compare_outputs(paths, labels):
    """Each later checkout's saved bf16 outputs against OLD's: {label:
    {net: {kernel: "bit-equal" or the largest difference}}}."""
    import torch

    saved = [torch.load(path) for path in paths]
    old = saved[0]
    out = {}
    for label, new in zip(labels[1:], saved[1:]):
        out[label] = {
            net: {k: ("bit-equal" if all(torch.equal(a, b) for a, b in zip(v, new[net][k]))
                      else max(float((a - b).abs().max()) for a, b in zip(v, new[net][k])))
                  for k, v in kernels.items()}
            for net, kernels in old.items()}
    return out, saved


def option(args, flag, default):
    """The value after flag in args (removed from them), else default."""
    if flag not in args:
        return default
    i = args.index(flag)
    value = args[i + 1]
    del args[i:i + 2]
    return value


def main():
    args = [a for a in sys.argv[1:] if a != CHILD]
    rounds = int(option(args, "--rounds", 1))
    net_name = option(args, "--net", "default")
    dtypes = option(args, "--dtypes", "float32,bfloat16")
    if len(args) < 2 or not set(net_name.split(",")) <= set(NETS + STREAM):
        raise SystemExit(__doc__)
    checkouts = [os.path.abspath(a) for a in args]
    labels = ["old", "new"] + [f"new{i}" for i in range(2, len(checkouts))]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    runs = {checkout: [] for checkout in checkouts}
    saved = tempfile.mkdtemp()
    paths = [os.path.join(saved, f"{i}.pt") for i in range(len(checkouts))]
    draws = os.path.join(saved, "draws.pt")
    if net_name == "default":
        smoke_draws(draws)
    for _ in range(rounds):
        for checkout in checkouts + checkouts[::-1]:
            env = dict(os.environ, **{OUTPUTS: paths[checkouts.index(checkout)]})
            if net_name == "default":
                env[DRAWS] = draws
            proc = subprocess.run([sys.executable, "-u", os.path.abspath(__file__), CHILD,
                                   "--net", net_name, "--dtypes", dtypes],
                                  cwd=checkout, capture_output=True, text=True, timeout=1200,
                                  env=env)
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
    if net_name == "default":
        summary["bf16_outputs_vs_old"], outputs = compare_outputs(paths, labels)
        summary["smoke_draws_bf16_rule"] = smoke_draws_witness(draws, outputs, labels)
    shutil.rmtree(saved, ignore_errors=True)
    print(json.dumps({"card": smi, "net": net_name, "summary": summary}), flush=True)


if __name__ == "__main__":
    if CHILD in sys.argv:
        child(option(sys.argv, "--net", "default").split(","),
              option(sys.argv, "--dtypes", "float32,bfloat16").split(","))
    else:
        main()
