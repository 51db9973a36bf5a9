#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (``neuralsim_tpu_torch``) on one
NVIDIA GPU.

Run from the root of the repository on a machine with the card:

    python3 chip_smoke.py

Phases, each of which exits nonzero when it fails:
  1. device: the card's name and power limit, torch/CUDA versions, TF32 off;
  2. build: nvcc builds kernels/csrc/nerf_march.cu for sm_90a;
  3. kernel vs plain twin at full width (8x256 NeRF, PE 10/4), N=8192 rays,
     S=64 and S=192, plus two ragged shapes, in float32 and bfloat16 on
     random-init (default and He-scaled) and box-scene weights; one
     backward through the autograd.Function; the times of kernel and twin
     at the main path's shapes (CUDA events, median of 7 after warm-up);
  4. main path: NeuralSimRenderer.render_images at the default config
     (64+128 samples, 100x100 camera, test mode, float32) on box-scene
     weights, K=8 poses from psi_init("5"); the kernel's launch counter
     must rise by 2 per ray chunk, the images must be finite, in [0, 1]
     and not empty, and equal the same render through the twin;
  5. a JSON line of the kernels' numbers, then the last line
     {"ok": true, "device": {...}}.

Without a CUDA device, or without the rest of the repository beside it,
it exits nonzero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

import torch

from neuralsim_tpu_torch.bilevel.psi_init import psi_init
from neuralsim_tpu_torch.config import NeRFNetConfig, NeuralSimConfig
from neuralsim_tpu_torch.kernels import build
from neuralsim_tpu_torch.kernels.raymarch import fused_nerf_march, march_channels_ref
from neuralsim_tpu_torch.models.box_scene import box_scene_params
from neuralsim_tpu_torch.models.nerf import init_nerf_params
from neuralsim_tpu_torch.pipeline import NeuralSimRenderer

N_RAYS = 8192          # one ray_chunk
F32_TOL = 2e-3         # tests_tpu/test_kernels_tpu.py:55-58
K_POSES = 8

# Published peaks (NVIDIA data sheets, dense): FP32 CUDA cores, bf16 tensor
# cores, memory bytes/s. The variant is picked from the card's name.
PEAKS = {
    "H100 SXM": (67e12, 989e12, 3.35e12),
    "H100 PCIe": (51e12, 756e12, 2.0e12),
    "H100 NVL": (60e12, 835e12, 3.9e12),
}


def log(*args):
    print(*args, flush=True)


def peaks_for(name: str):
    key = "H100 PCIe" if "PCIe" in name else "H100 NVL" if "NVL" in name else "H100 SXM"
    return key, PEAKS[key]


def macs_per_point(net: NeRFNetConfig) -> int:
    w, d = net.netwidth, net.netdepth
    macs = net.input_ch * w + (d - 1) * w * w + len(net.skips) * net.input_ch * w
    return macs + w * w + w + (w + net.input_ch_views) * (w // 2) + (w // 2) * 3


def bound_ms(net, n, s, weight_bytes, peak_flops, peak_bytes):
    flops = 2.0 * macs_per_point(net) * n * s
    nbytes = 3 * n * 3 * 4 + n * s * 4 + weight_bytes + 4 * n * s * 4
    ops_ms, bytes_ms = 1e3 * flops / peak_flops, 1e3 * nbytes / peak_bytes
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def time_ms(fn, reps=7, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bf16_rule(got, want):
    """tests_tpu/test_kernels_tpu.py:79-86."""
    err = (got - want).abs()
    bad = (err > 0.5 + 0.05 * want.abs()).float().mean().item()
    return bad <= 1e-3 and err.max().item() < 4.0, bad


def march_inputs(n, s, gen, device):
    """Rays from the pipeline's camera sphere (radius 1.01) toward the
    origin, depths in the pipeline's [near, far], sorted per ray."""
    o = torch.randn(n, 3, generator=gen)
    o = 1.01 * o / o.norm(dim=-1, keepdim=True)
    d = -o / 1.01 + 0.05 * torch.randn(n, 3, generator=gen)
    vd = d / d.norm(dim=-1, keepdim=True)
    z = torch.sort(0.31 + 1.62 * torch.rand(n, s, generator=gen), dim=-1).values
    return [t.to(device).contiguous() for t in (o, d, vd, z)]


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name} "
        f"count {torch.cuda.device_count()} python {sys.version.split()[0]}")
    log(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn {torch.backends.cudnn.allow_tf32} "
        f"float32_matmul_precision {torch.get_float32_matmul_precision()}")
    return name, smi


def phase_build():
    path, seconds, report = build.build("nerf_march")
    log(f"build nerf_march.cu: {seconds:.1f} s -> {path.name}")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())


def check_kernel(params, args, net, dtype, tag):
    """Kernel vs twin on the same inputs; returns the max abs error."""
    with torch.no_grad():
        got = fused_nerf_march(params, *args, net, dtype)
        want = march_channels_ref(params, *args, net, dtype)
    torch.cuda.synchronize()
    if not all(torch.isfinite(g).all() for g in got):
        raise AssertionError(f"kernel output not finite: {tag}")
    if dtype == torch.float32:
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=F32_TOL, atol=F32_TOL,
                                       msg=lambda m: f"{tag}: {m}")
    else:
        rules = [bf16_rule(g, w) for g, w in zip(got, want)]
        if not all(ok for ok, _ in rules):
            raise AssertionError(f"bf16 rule fails: {tag} {rules}")
    e = max((g - w).abs().max().item() for g, w in zip(got, want))
    log(f"kernel vs twin {tag}: max abs err {e:.3e} (sigma max {got[0].max().item():.2f})")
    return e


def phase_kernel(net, peaks):
    """Kernel vs twin at the main path's shapes (timed) and at ragged ones
    (N*S not a multiple of the kernel's 64-point tile)."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    random = init_nerf_params(net, generator=gen, device=dev)
    weights = {
        "random": random,
        # the default init shrinks activations layer by layer (sigma ~0.02);
        # sqrt(6)-scaled kernels (He's ReLU init) keep them O(1) through the
        # chain, so the float32 comparison is held at working magnitudes
        "random_he": {k: v * (6 ** 0.5 if k.endswith("kernel") else 1.0)
                      for k, v in random.items()},
        "box": box_scene_params(net, generator=gen, device=dev),
    }
    weight_bytes = sum(t.numel() * 4 for t in weights["random"].values())
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    kernel_ms, plain_ms, bounds = {}, {}, {}
    for n, s, timed in ((N_RAYS, 64, True), (N_RAYS, 192, True), (1001, 48, False),
                        (3, 5, False)):
        args = march_inputs(n, s, gen, dev)
        for scene, params in weights.items():
            for dtype in err:
                tag = f"{scene} N={n} S={s} {str(dtype)[6:]}"
                err[dtype] = max(err[dtype], check_kernel(params, args, net, dtype, tag))
        if not timed:
            continue
        params = weights["random"]
        for dtype in err:
            key = f"{str(dtype)[6:]}_S{s}"
            with torch.no_grad():
                kernel_ms[key] = time_ms(lambda: fused_nerf_march(params, *args, net, dtype))
                plain_ms[key] = time_ms(lambda: march_channels_ref(params, *args, net, dtype))
            peak = peaks[0] if dtype == torch.float32 else peaks[1]
            bounds[key], bound_by = bound_ms(net, n, s, weight_bytes, peak, peaks[2])
            log(f"time {key} N={n}: kernel {kernel_ms[key]:.3f} ms, twin "
                f"{plain_ms[key]:.3f} ms, bound {bounds[key]:.3f} ms ({bound_by})")
    return err[torch.float32], err[torch.bfloat16], kernel_ms, plain_ms, bounds


def phase_backward(net):
    """One backward through the autograd.Function (kernel forward, twin
    recompute) against plain autograd through the twin."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    params = box_scene_params(net, generator=gen, device=dev)
    o, d, vd, z = march_inputs(64, 16, gen, dev)
    ct = torch.randn(64, 16, generator=gen).to(dev)

    def grads(fn):
        leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        zz, oo = z.clone().requires_grad_(True), o.clone().requires_grad_(True)
        sigma, rgb = fn(leaves, oo, d, vd, zz, net, torch.float32)
        ((sigma * ct).sum() + rgb.square().sum()).backward()
        return [leaves[k].grad for k in sorted(leaves)] + [zz.grad, oo.grad]

    got, want = grads(fused_nerf_march), grads(march_channels_ref)
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=F32_TOL, atol=F32_TOL)
    log(f"backward through autograd.Function vs plain autograd: max abs err {err:.3e}")


def phase_main_path():
    cfg = NeuralSimConfig()
    gen = torch.Generator().manual_seed(0)
    box = box_scene_params(cfg.net, generator=gen, device="cuda")
    models = {"coarse": box, "fine": box}
    renderer = NeuralSimRenderer(cfg, models=models)
    psi = psi_init("5")
    n_rays = K_POSES * renderer.H * renderer.W
    expect = 2 * math.ceil(n_rays / renderer.rc.ray_chunk)

    torch.cuda.synchronize()
    fused_nerf_march.launches = 0
    t0 = time.perf_counter()
    rgb, noise = renderer.render_images(psi, torch.Generator().manual_seed(0), num_k=K_POSES)
    torch.cuda.synchronize()
    seconds = [time.perf_counter() - t0]
    launches = fused_nerf_march.launches
    log(f"main path: K={K_POSES} {renderer.H}x{renderer.W} images, {n_rays} rays, "
        f"kernel launches {launches} (expected {expect})")
    if launches != expect:
        raise AssertionError(f"main path launched the kernel {launches} times, "
                             f"expected {expect}")

    # two more timed runs of the same render, and its maps
    with torch.no_grad():
        for _ in range(2):
            t0 = time.perf_counter()
            rgb2, disp, acc = renderer._render_impl(psi, noise)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
    if not (torch.isfinite(rgb).all() and rgb.min() >= 0 and rgb.max() <= 1):
        raise AssertionError("main-path images not finite or outside [0, 1]")
    if rgb.shape != (K_POSES, renderer.H, renderer.W, 3):
        raise AssertionError(f"main-path images have shape {tuple(rgb.shape)}")
    hit = (acc > 0.5).float().mean().item()
    if hit == 0.0:
        raise AssertionError("main-path render is empty: acc <= 0.5 everywhere")
    torch.testing.assert_close(rgb2, rgb, rtol=0, atol=1e-5)

    twin_cfg = cfg.replace(render=dataclasses.replace(cfg.render, use_pallas=False))
    twin = NeuralSimRenderer(twin_cfg, models=models)
    with torch.no_grad():
        t0 = time.perf_counter()
        rgb_twin, _, acc_twin = twin._render_impl(psi, noise)
        torch.cuda.synchronize()
        twin_s = time.perf_counter() - t0
    err = (rgb - rgb_twin).abs().max().item()
    torch.testing.assert_close(rgb, rgb_twin, rtol=F32_TOL, atol=F32_TOL)
    best = statistics.median(seconds)
    log(f"main path: {hit:.3%} of pixels with acc > 0.5; rgb vs twin render "
        f"max abs err {err:.3e}")
    log(f"main path times (s): {[round(t, 4) for t in seconds]}; median {best:.4f} s = "
        f"{n_rays / best:.0f} rays/s, {1e3 * best / K_POSES:.2f} ms/image; "
        f"twin render {twin_s:.4f} s = {n_rays / twin_s:.0f} rays/s")
    return launches, err


def main():
    name, smi = phase_device()
    peak_key, peaks = peaks_for(name)
    log(f"peaks ({peak_key}): fp32 {peaks[0] / 1e12:.0f} TFLOP/s, bf16 "
        f"{peaks[1] / 1e12:.0f} TFLOP/s, memory {peaks[2] / 1e12:.2f} TB/s")
    phase_build()
    net = NeRFNetConfig()
    err_f32, err_bf16, kernel_ms, plain_ms, bounds = phase_kernel(net, peaks)
    phase_backward(net)
    launches, main_err = phase_main_path()
    record = {
        "name": "fused_nerf_march",
        "route": "cuda",
        "source": "neuralsim_tpu_torch/kernels/csrc/nerf_march.cu",
        "replaces": "neuralsim_tpu/kernels/raymarch.py:857",
        "launches": launches,
        "max_abs_err": err_f32,
        "ms": kernel_ms["float32_S192"],
        "plain_ms": plain_ms["float32_S192"],
        "bound_ms": bounds["float32_S192"],
        "bound_by": "operations",
        "library_ms": None,
        "max_err_f32": err_f32,
        "max_err_bf16": err_bf16,
        "main_path_rgb_err": main_err,
        "kernel_ms": kernel_ms,
        "plain_ms_by_shape": plain_ms,
        "bound_ms_by_shape": bounds,
        "shape": f"N={N_RAYS} rays x S samples; ms/plain_ms/bound_ms at float32 S=192",
        "card": smi,
    }
    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
