#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (``neuralsim_tpu_torch``) on one
NVIDIA GPU.

Run from the root of the repository on a machine with the card:

    python3 chip_smoke.py

Phases, each of which exits nonzero when it fails:
  1. device: the card's name and power limit, torch/CUDA versions, TF32 off;
  2. build: nvcc builds every kernels/csrc/*.cu for sm_90a, one process per
     source, all started together; ptxas registers and spills of each
     instantiation, and a list of those that spill (with their bytes);
  3. every kernel vs its plain twin at full width (8x256 NeRF, PE 10/4) in
     float32 and bfloat16, on random-init (default and He-scaled) and
     box-scene weights:
       - fused_nerf_march and fused_render_tile at N=8192 rays x S=64 and
         S=192 samples (the exact render), S=16 (the production single
         pass, also at N=32768, bench.py's ray chunk) and S=144 (the
         hierarchical culled fine march), plus the ragged N x S = 1001x48
         and 3x5;
       - fused_nerf_mlp_widepe, fused_nerf_mlp_pe and fused_nerf_mlp at
         M = 8192*S points for the same S, plus the ragged M = 1001*48 and
         15 (neither a multiple of the kernels' 128-point tile);
     and the times of kernel and twin at the main path's shapes (CUDA
     events, median of 7 after warm-up) beside each kernel's bound, and
     beside them the time of the same MLP as a chain of per-layer
     torch.matmul + bias + ReLU on encodings computed beforehand, in bf16
     and in float32 with TF32 off (chain_ms, yardsticks of the unfused
     library path that the port never calls); the most samples per ray the
     render tile takes at each core width (256, 512) in each dtype (at
     least 192); then every kernel vs its twin in both dtypes on the nets of
     EXTRA_NETS, which the kernels take zero-padded to the next core width:
     4x128, 8x100 with multires 12 / multires_views 6, 8x512, 4x384 (padded
     to 512), 24x256 with skips (4, 12), and 8x256 with multires 24 /
     multires_views 12 and 42 / 20 (the longest encodings, at the ragged
     shapes only); then the five kernels on the 8x512 net at N=8192 x
     S=64 and 192 in both dtypes: kernel, twin and bound ms (the bound from
     the net's own work) and the share of the bound;
  4. backward: one backward through each differentiable wrapper's
     autograd.Function against plain autograd through the recompute it
     stands for; the render tile refuses a gradient on the card;
  5. main path: NeuralSimRenderer.render_images at the default config
     (64+128 samples, 100x100 camera, test mode, float32) on box-scene
     weights, K=8 poses from psi_init("5"), through each march route: the
     ray march (default), fuse_pointgen=False (point-major MLP kernel) and
     fuse_compositing=True (fused march + compositing kernel). Each route's
     kernel counter must read 2 per ray chunk and every other counter 0;
     the images must be finite, in [0, 1], not empty, and within 2e-3 of
     the ray-march route's and of the plain twin's render. Then the same
     render in bfloat16 through all three routes (each on a tensor-core
     kernel): the same launch and image checks, rgb within
     BF16_RENDER_TOL of the bf16 twin render, and at most
     BF16_VS_F32_FRAC of it beyond that of the float32 render (none
     beyond BF16_VS_F32_MAX);
  5b. a net without view directions (use_viewdirs=False; the box trunk with
     an output head): its K=8 render on the card must launch no kernel (it
     takes the plain query_points + raw2outputs, as the JAX package does)
     and equal the same rays' render on the CPU within 2e-3;
  5c. the default-route render of phase 5 (K=8, 100x100, test mode) on
     8x512 box-scene weights in float32 and bfloat16: 20 launches of
     fused_nerf_march and 0 of the others, rgb within 2e-3 / BF16_RENDER_TOL
     of the twin's render, rays/s beside the card's name and power limit;
  6. entry points: the exported fused_nerf_mlp (pre-encoded inputs) and
     fused_nerf_mlp_pe on the coarse sample points of the same K=8 render,
     one launch each, held against the ray-march kernel's raw field there
     (float32, 2e-3); then fused_nerf_mlp in bfloat16, one launch, held to
     the bf16 ray-march kernel's raw field by the bf16 rule;
  7. production: NeuralSimRenderer with production_mode() at the same
     config, float32 and bfloat16 (grid built and budget calibrated in the
     constructor, both timed on the host clock): the effective hit_budget
     must be below 1, fused_nerf_march must launch once per chunk of routed
     rays (every other counter 0), rgb within 2e-3 (f32) / 2e-2 (bf16) of
     the twin's production render and > 40 dB from the exact render of the
     same poses (and not equal to it); the same in float32 through the
     grid scorer (cull_mode="grid", its own calibrated budget), the
     point-major kernel (fuse_pointgen=False) and the fused march +
     compositing kernel (fuse_compositing=True), each kernel once per
     chunk of routed rays; then through render_poses in
     float32 the hierarchical culled render (n_importance_culled=None),
     reuse_coarse and fine_fraction=0.25 (two launches per chunk, rgb
     within 2e-3 of the twin's); then bench.py's production shape, 16 poses
     x 400^2 in bfloat16 with ray_chunk 32768 (grid from build_scene_grid,
     budget from calibrate_hit_budget): exact and production rays/s and
     PSNR > 40 dB;
  8. the psi render gradient (hypergrad/render_grad.py) of the K=8
     box-scene render at the default config with a seeded grad_E (normal x
     1e-2), plain torch as in the JAX package: no kernel may launch during
     a gradient. render_images_grad's strips (grad_ray_chunk 5000), rev (a
     checkpoint per ray tile) and fwd (8 JVPs) in float32 agree within
     GRAD_REL of the norm; strips on the card equal strips on the CPU at
     K=2, 25x25, and in bf16 lie nearer the CPU's bf16 strips than the
     CPU's float32 strips do; culled strips (the production renderer's grid and
     calibrated budget, strip CULL_STRIP; the selection must run for every
     image) equal dense strips; bf16 strips (grad_compute_dtype) have a
     cosine >= GRAD_BF16_COS to float32; a Gaussian-psi strips gradient
     equals its fwd; one momentum psi step. Seconds per image (host clock)
     and peak memory of each mode go to a JSON line {"render_grad": ...};
  9. the detector slice (phase_detector): K = 50 renders from psi_init("5")
     through NeuralSimRenderer.render_images on phase 7's float32 production
     renderer (fused_nerf_march must launch), annotated on the card by
     build_detector_batches_device (slot 0 of every image bit-equal to the
     host auto_annotate of to8b of the same render), RetinaNet-R50-FPN at
     DetectorConfig's defaults (6 classes, 128^2, batch 8, frozen backbone)
     from a seeded init_detector, fine-tuned by inner_train for 50 steps with
     cycle_indices under cuDNN's default algorithms (the first 3 losses
     within DET_REL of the same steps on the CPU, all 50 finite, no kernel
     launched; the first 3 steps again under cudnn.deterministic, within
     DET_REL of the CPU too and timed), the host annotator's C++ library
     against its numpy twin on the same masks (equal stats, both timed), the
     trained logits and deltas on 8 val images within DET_REL of the CPU's,
     and COCO mAP (retinanet_inference in batches of 8, detections_to_eval,
     coco_map) over VAL_IMAGES renders at poses from a second psi, each AP
     finite where its area range has ground truth; render, annotation,
     train-step (CUDA events, median over steps 2-50) and eval times, peak
     memory, and a torch.profiler trace of PROFILE_STEPS more steps (device
     busy share, launches per step, the top kernels) go to a JSON line
     {"detector": ...};
 10. the bilevel outer loop (phase_bilevel): BilevelDriver.run for 2
     epochs (checkpointed) at the defaults on the box-scene pair with the
     production float32 render (budget must be < 1): K = 50 renders from
     psi_init("5"), annotation, 50 inner steps, mAP on 16 val renders from
     psi_init("1"), v, the onestep inverse HVP, grad_E of the 50 renders,
     the bf16 strips gradient, the psi step; grad_psi finite and nonzero,
     psi moved, the probabilities sum to 1, every AP finite where its area
     range has ground truth, 4 save_result lines; fused_nerf_march launched
     in each epoch's render and in the first epoch's cull guard, no kernel
     in any other stage; seconds per epoch and per stage (phase_timer,
     synchronized) and peak GB per stage. Then: one epoch at K = 2, 25x25,
     2 inner steps, float32, on the card and on the CPU from the same
     weights, state and draws under cudnn.deterministic (v, inverse HVP,
     grad_E, grad_psi within BILEVEL_REL of the norm); epoch 1 again from
     the epoch-0 checkpoint in a new driver under cudnn.deterministic
     (restored state and draws bit-equal, renders equal, loss, grad_psi
     and psi step within RESUME_REL of the uninterrupted epoch 1); one
     unrolled epoch from epoch 0's state and draws (seconds, peak GB, the
     cosine of its grad_E with the influence grad_E, reported); cg_normal
     and auto-scaled LiSSA on the trained state (ms per HVP, finite; one
     HVP on the card and on the CPU within HVP_REL of each other and of
     the card's float64 HVP); epoch 1 of the resume timed under
     deterministic cuDNN beside the uninterrupted (default algorithms)
     epoch 1; the CLI (cli.main with --ft_path to a .tar written by
     save_nerf_tar_compatible, production render, K = CLI_K, one epoch, val
     and background classes read from PNG trees written by write_png,
     both TF32 switches on before it and the card policy asserted after
     it: TF32 off, deterministic cuDNN; PNGs written), twice from one seed,
     psi and grad_psi equal to the bit. A JSON line {"bilevel": ...};
 11. the NeRF trainer (phase_train_nerf): the box scene rendered at 400^2
     (22 views) and written as a LINEMOD-layout directory (RGBA PNGs by
     write_png, transforms_{train,val,test}.json), then train_cli.main on
     it from random init: the default 8x256 pair, 64 + 128 samples,
     N_rand 1024, float32, half_res 200^2, TRAIN_ITERS steps (the first
     TRAIN_PRECROP in the central crop, as the reference's Blender
     recipe). Every step
     launches fused_nerf_march twice in its forward and nothing in its
     backward; the loss falls; the test PSNR at the end is PSNR_RISE_DB
     above that of the init; .tar and checkpoint written; the spiral is
     PNG frames where imageio is missing (a video where it is installed);
     render_only --render_test from the .tar gives the loop's test PSNR
     within 1e-3 dB. Then TRAIN_CPU_STEPS steps from one init on the card
     and on the CPU (perturb off, the same ray picks; losses within
     TRAIN_REL), the kernel on the updated weights against its twin
     (F32_TOL), the time to prepare a weight set (2 per step) and a
     torch.profiler trace of PROFILE_STEPS steps. s/iteration (median,
     synchronised), peak GB, launches of the test-set and spiral renders.
     A JSON line {"train_nerf": ...};
 12. the run's total seconds; a JSON line of the kernels' numbers (float32 times under the
     contract's keys, bf16 times, chain_ms and each dtype's MLP core
     beside them, the 8x512 times, the production runs' launches, and the
     production and 8x512 render numbers in fused_nerf_march's record),
     after checking that each kernel's bf16 time (tensor cores) is at most
     WGMMA_FRACTION of its own float32 time at S=192 on the default net,
     and fused_nerf_march's also on 8x512 at S=64; then the last line
     {"ok": true, "device": {...}}.

Without a CUDA device, or without the rest of the repository beside it,
it exits nonzero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from neuralsim_tpu_torch import cli, config, kernels, native, train_cli, train_nerf
from neuralsim_tpu_torch.bilevel import driver
from neuralsim_tpu_torch.bilevel.psi_init import psi_init
from neuralsim_tpu_torch.bilevel.psi_opt import psi_optimizer_init, psi_optimizer_update
from neuralsim_tpu_torch.hypergrad import influence, render_grad
from neuralsim_tpu_torch.config import NeRFNetConfig, NeuralSimConfig
from neuralsim_tpu_torch.data import load_linemod_data
from neuralsim_tpu_torch.detector import dataset as detector_dataset
from neuralsim_tpu_torch.detector import evaluator, trainer
from neuralsim_tpu_torch.kernels import build
from neuralsim_tpu_torch.kernels import raymarch as rm
from neuralsim_tpu_torch.models import retinanet
from neuralsim_tpu_torch.models.box_scene import box_scene_params
from neuralsim_tpu_torch.models.nerf import init_nerf_params, make_sigma_fn, nerf_apply
from neuralsim_tpu_torch.models.retinanet import DetBatch
from neuralsim_tpu_torch.ops.encoding import positional_encoding
from neuralsim_tpu_torch.ops.occupancy import (
    build_scene_grid,
    calibrate_hit_budget,
    scene_half_extent,
)
from neuralsim_tpu_torch.ops.rays import get_rays
from neuralsim_tpu_torch.ops.render import render_poses, render_ray_batch
from neuralsim_tpu_torch.ops.volume import stratified_z_vals
from neuralsim_tpu_torch.pipeline import NeuralSimRenderer
from neuralsim_tpu_torch.utils.checkpoint import save_nerf_tar_compatible
from neuralsim_tpu_torch.utils.png import write_png
from neuralsim_tpu_torch.sampler.poses import (
    draw_pose_noise,
    draw_pose_noise_gaussian,
    pose_spherical,
    poses_from_noise,
    psi_to_probs,
)

DEVICE = torch.device("cuda")
N_RAYS = 8192          # one ray_chunk
F32_TOL = 2e-3         # tests_tpu/test_kernels_tpu.py:55-58
# bf16 render vs the bf16 twin render: the two round at the same places
# and sum in other orders, so an activation can land one bf16 step apart;
# the port's bf16 tolerance (tests/test_torch_mlp_kernels.py)
BF16_RENDER_TOL = 2e-2
# bf16 render vs the float32 render: every activation is rounded to 8
# mantissa bits through 13 layers, and the fine samples follow the coarse
# weights, so a pixel at the box's edge can move by a few 1e-2 (6.6e-2 at
# a mean of 1.8e-4 measured on an NVIDIA H100 80GB HBM3). The looser
# rule, in the manner of the bf16 rule: at most BF16_VS_F32_FRAC of the rgb
# values beyond BF16_RENDER_TOL of the float32 render, none beyond
# BF16_VS_F32_MAX
BF16_VS_F32_FRAC = 1e-3
BF16_VS_F32_MAX = 0.25
K_POSES = 8
ACC_FLOOR = 1e-3       # disparity is compared where acc reaches it
RAGGED = (1001, 48)
# (N, S, timed): the exact render's coarse and fine marches (64, 192), the
# production single pass (16; also in bench.py's 32768-ray chunks) and the
# hierarchical culled fine march (16 + 128), and ragged shapes
RAY_SHAPES = ((N_RAYS, 64, True), (N_RAYS, 192, True), (N_RAYS, 16, True),
              (32768, 16, True), (N_RAYS, 144, True), RAGGED + (False,), (3, 5, False))
# nets beyond the default, checked at these (N, S): the kernels take a trunk
# zero-padded to the next core width (256 or 512), up to 32 layers deep, and
# encodings up to multires 42 / multires_views 20
EXTRA_NETS = {
    "4x128": dict(netdepth=4, netwidth=128, netdepth_fine=4, netwidth_fine=128, skips=(2,)),
    "8x100_pe12_6": dict(netwidth=100, netwidth_fine=100, multires=12, multires_views=6),
    # the reference's --netwidth / --netwidth_fine 512, and a width padded to it
    "8x512": dict(netwidth=512, netwidth_fine=512),
    "4x384": dict(netdepth=4, netwidth=384, netdepth_fine=4, netwidth_fine=384, skips=(2,)),
    # 24 trunk layers with two skips
    "24x256": dict(netdepth=24, netdepth_fine=24, skips=(4, 12)),
    # longer encodings: 147 / 75 channels (three x_pe and two d_pe chunks of
    # the wgmma core), and the longest the cores take, 255 / 123
    "8x256_pe24_12": dict(multires=24, multires_views=12),
    "8x256_pe42_20": dict(multires=42, multires_views=20),
}
EXTRA_SHAPES = ((N_RAYS, 64), RAGGED, (3, 5))
# nets checked at the ragged shapes only
RAGGED_ONLY = ("8x256_pe42_20",)
# the wide net whose kernels are timed (N_RAYS x WIDE_S) and rendered on the
# main path
WIDE = "8x512"
WIDE_S = (64, 192)
# bench.py's production cell (bench.py:139-194): 16 poses x 400^2, its camera
BENCH_POSES, BENCH_HW = 16, 400
BENCH_K = [[1333.3334, 0.0, 195.42932], [0.0, 1334.2196, 200.6318], [0.0, 0.0, 1.0]]
# compositing per sample: distance, exp, alpha, weight, transmittance,
# three sigmoids and five running sums, in FLOP
COMPOSITE_FLOP = 28
# the render gradient on the card vs the same function on the CPU, and its
# modes against each other: the CPU tests' tolerance, max abs difference
# over the reference's norm (tests/test_torch_render_grad.py)
GRAD_REL = 1e-4
# bf16 strips gradient vs float32: the least cosine
GRAD_BF16_COS = 0.999
# the culled gradient's strip: the budget rounds up to a multiple of it, and
# at the default 5000 a 100x100 image's budget (0.65) rounds up to every pixel
CULL_STRIP = 1000
# the detector on the card vs the same computation on the CPU (float32, TF32
# off): max abs difference over the CPU's max |x| (tests/test_torch_retinanet.py)
DET_REL = 1e-4
# the detector's val set: renders at poses from a second psi
VAL_IMAGES, VAL_PSI = 16, "1"
# detector steps traced by torch.profiler after the main path's run
PROFILE_STEPS = 5
# phase 10: the card-against-CPU epoch (K poses at SIDE x SIDE) and its
# tolerance (of the norm, tests/test_torch_driver.py's); a resumed epoch
# against the same epoch in memory, both under cudnn.deterministic (the
# render gradient's scatter-adds may still sum in another order); the
# CLI's K
BILEVEL_SMALL_K, BILEVEL_SMALL_SIDE = 2, 25
BILEVEL_REL = 1e-4
# one HVP at full width on the trained detector (batch 8 at 128^2, 12.8 M
# trainable parameters), card and CPU in float32 each against the card's
# float64: a second derivative through R50-FPN whose float32 sums the two
# devices order differently
HVP_REL = 1e-3
RESUME_REL = 1e-5
CLI_K = 8
# the CLI's val / background PNG trees: classes (the object "2" and two
# background classes), images per directory and their side (the renders')
CLI_CLASSES = ("1", "2", "10")
CLI_TREE_IMAGES, CLI_TREE_HW = 4, 100
# phase 11: the box scene's LINEMOD directory (train, val, test views at
# TRAIN_HW^2, half_res to TRAIN_HW / 2), the run (steps, rays per step),
# card against CPU over the first TRAIN_CPU_STEPS steps (losses, relative),
# and the least rise of the test PSNR over that of the init, in dB (set
# before the first run on the card)
TRAIN_VIEWS = (16, 2, 4)
TRAIN_HW = 400
TRAIN_ITERS, TRAIN_RAYS = 1000, 1024
# the first TRAIN_PRECROP steps pick their rays in the central half of the
# image (the reference's precrop_iters / precrop_frac, as its Blender
# recipe): trained on whole images from the start, the pair collapsed to
# the empty scene on the black background (no density, so no gradient to
# bring it back; the loss stuck at that of an all-black render)
TRAIN_PRECROP = 300
TRAIN_CPU_STEPS, TRAIN_REL = 3, 1e-4
PSNR_RISE_DB = 5.0
COUNTED = (rm.fused_nerf_march, rm.fused_nerf_mlp_widepe, rm.fused_nerf_mlp_pe,
           rm.fused_nerf_mlp, rm.fused_render_tile)

# Published peaks (NVIDIA data sheets, dense): FP32 CUDA cores, bf16 tensor
# cores, memory bytes/s. The variant is picked from the card's name.
PEAKS = {
    "H100 SXM": (67e12, 989e12, 3.35e12),
    "H100 PCIe": (51e12, 756e12, 2.0e12),
    "H100 NVL": (60e12, 835e12, 3.9e12),
}
SOURCE = "neuralsim_tpu_torch/kernels/csrc/"
# the MLP core each kernel's dtypes run: the FP32 CUDA cores of
# nerf_mlp.cuh or wgmma on the tensor cores (nerf_mlp_wgmma.cuh)
CORES = {k: {"float32": "fp32", "bfloat16": "wgmma"}
         for k in ("fused_nerf_march", "fused_nerf_mlp_widepe", "fused_render_tile",
                   "fused_nerf_mlp", "fused_nerf_mlp_pe")}
# a kernel's bf16 time (tensor cores) is at most this fraction of its own
# float32 time (FP32 core) at S = 192 on the default net, and kernel 1's on
# the wide net at S = 64: a kernel that misses it did not run on the tensor
# cores
WGMMA_FRACTION = 0.25
REPLACES = {
    "fused_nerf_march": ("nerf_march.cu", "neuralsim_tpu/kernels/raymarch.py:857"),
    "fused_nerf_mlp_widepe": ("nerf_mlp.cu", "neuralsim_tpu/kernels/raymarch.py:469"),
    "fused_render_tile": ("render_tile.cu", "neuralsim_tpu/kernels/raymarch.py:621"),
    "fused_nerf_mlp": ("nerf_mlp.cu", "neuralsim_tpu/kernels/raymarch.py:162"),
    "fused_nerf_mlp_pe": ("nerf_mlp.cu", "neuralsim_tpu/kernels/raymarch.py:107"),
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


def bound(flop, nbytes, peak_flops, peak_bytes):
    """(least ms, what bounds it) for the work on this card."""
    ops_ms, bytes_ms = 1e3 * flop / peak_flops, 1e3 * nbytes / peak_bytes
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def work(kernel, net, n, s, weight_bytes):
    """FLOP and bytes (each input read once, each output written once) of
    one call on n rays x s samples (m = n*s points)."""
    m = n * s
    flop = 2.0 * macs_per_point(net) * m
    if kernel == "fused_nerf_march":
        nbytes = 3 * n * 3 * 4 + m * 4 + 4 * m * 4
    elif kernel == "fused_render_tile":
        flop += COMPOSITE_FLOP * m
        nbytes = 3 * n * 3 * 4 + m * 4 + m * 4 + n * 6 * 4
    elif kernel == "fused_nerf_mlp":
        nbytes = m * (net.input_ch + net.input_ch_views) * 4 + m * 4 * 4
    else:
        nbytes = m * 6 * 4 + m * 4 * 4
    return flop, nbytes + weight_bytes


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


def shape_key(dtype: str, n: int, s: int) -> str:
    """Key of a timed shape: dtype_S{s} at N_RAYS rays, dtype_N{n}_S{s}
    otherwise."""
    return f"{dtype}_S{s}" if n == N_RAYS else f"{dtype}_N{n}_S{s}"


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


def point_inputs(kernel, net, rays):
    """The point-major kernels' inputs for the sample points of rays:
    points and view directions [M,3], or their encodings."""
    pts, dirs = rm.ray_points(*rays)
    if kernel == "fused_nerf_mlp":
        return (positional_encoding(pts, net.multires),
                positional_encoding(dirs, net.multires_views))
    return pts, dirs


def chain_mlp(params, x_pe, d_pe, net):
    """The NeRF MLP as one torch.matmul per layer plus bias, ReLU and the
    two concats, in the type of its inputs: the unfused library path (bf16
    on the tensor cores, float32 SGEMM with TF32 off), timed as a yardstick
    only (raw [M,4])."""
    h = x_pe
    for i in range(net.netdepth):
        h = torch.relu(h @ params[f"pts_{i}_kernel"] + params[f"pts_{i}_bias"])
        if i in net.skips:
            h = torch.cat([x_pe, h], dim=-1)
    alpha = h @ params["alpha_kernel"] + params["alpha_bias"]
    feature = h @ params["feature_kernel"] + params["feature_bias"]
    h = torch.relu(torch.cat([feature, d_pe], dim=-1) @ params["views_0_kernel"]
                   + params["views_0_bias"])
    return torch.cat([h @ params["rgb_kernel"] + params["rgb_bias"], alpha], dim=-1)


def time_chain(params, net, rays, dtype):
    """chain_mlp's time in dtype on the sample points of rays (encodings
    computed beforehand, outside the timing)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the float32 chain must run with TF32 off")
    p = {k: v.to(dtype) for k, v in params.items()}
    x_pe, d_pe = (t.to(dtype) for t in point_inputs("fused_nerf_mlp", net, rays))
    with torch.no_grad():
        raw = chain_mlp(p, x_pe, d_pe, net)
        if not torch.isfinite(raw).all():
            raise AssertionError("chain yardstick output not finite")
        ms = time_ms(lambda: chain_mlp(p, x_pe, d_pe, net))
    del x_pe, d_pe
    torch.cuda.empty_cache()
    return ms


# kernel name -> (wrapper, twin, inputs from a ray bundle)
KERNELS = {
    "fused_nerf_march": (rm.fused_nerf_march, rm.march_channels_ref, lambda net, r: r),
    "fused_render_tile": (rm.fused_render_tile, rm.render_tile_ref, lambda net, r: r),
    "fused_nerf_mlp_widepe": (rm.fused_nerf_mlp_widepe, rm.mlp_widepe_ref,
                              lambda net, r: point_inputs("fused_nerf_mlp_widepe", net, r)),
    "fused_nerf_mlp_pe": (rm.fused_nerf_mlp_pe, rm.mlp_pe_ref,
                          lambda net, r: point_inputs("fused_nerf_mlp_pe", net, r)),
    "fused_nerf_mlp": (rm.fused_nerf_mlp, nerf_apply,
                       lambda net, r: point_inputs("fused_nerf_mlp", net, r)),
}


def zero_counts():
    for fn in COUNTED:
        fn.launches = 0


def counts():
    return {fn.__name__: fn.launches for fn in COUNTED}


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
    t0 = time.perf_counter()
    built = build.build_all()
    log(f"build: {len(built)} sources in {time.perf_counter() - t0:.1f} s (parallel nvcc)")
    spills = []
    for name, (path, seconds, report) in built.items():
        log(f"build {name}.cu: {seconds:.1f} s -> {path.name}")
        kernel = None
        for line in report.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1] if "'" in line else line.strip()
            if "registers" in line or "spill" in line:
                log(f"  ptxas {kernel}: {line.strip()}")
            spilled = [int(b) for b in re.findall(r"(\d+) bytes spill", line)]
            if any(spilled):
                spills.append(f"{name}.cu {kernel}: {sum(spilled)} bytes spill (stores + loads)")
    log("build spills: " + ("; ".join(spills) if spills else "none"))
    return spills


def check(kernel, params, args, net, dtype, tag):
    """Kernel vs twin on the same inputs; returns the max abs error."""
    wrapper, twin = KERNELS[kernel][:2]
    with torch.no_grad():
        got = wrapper(params, *args, net, compute_dtype=dtype)
        want = twin(params, *args, net, compute_dtype=dtype)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if not all(torch.isfinite(g).all() for g in got):
        raise AssertionError(f"kernel output not finite: {tag}")
    if kernel == "fused_render_tile":
        # disparity = acc / depth: on a ray whose weights sum to more than
        # 0 but below ACC_FLOOR every alpha = 1 - exp(-x) has x ~ 1e-8, a
        # float32 quantisation step on either side, and the ratio is of
        # that noise (an empty ray gives 1e10 on both). So disparity is
        # compared where both sides are lit or both empty: in bf16 a ray
        # that one side leaves empty (sigma <= 0 at every sample) can get
        # a density of one bf16 step on the other, and 1e10 meets ~1.
        lit = (((want[2] >= ACC_FLOOR) & (got[2] >= ACC_FLOOR))
               | ((want[2] == 0) & (got[2] == 0)))
        got, want = list(got), list(want)
        got[1], want[1] = got[1][lit], want[1][lit]
        if not lit.all():
            log(f"  {tag}: disp compared on {int(lit.sum())} of {lit.numel()} rays "
                f"(acc 0 or >= {ACC_FLOOR:g})")
    names = ("rgb", "disp", "acc", "weights", "depth") if len(got) == 5 else (
        ("sigma", "rgb3") if len(got) == 2 else ("raw",))
    if dtype == torch.float32:
        for g, w, name in zip(got, want, names):
            torch.testing.assert_close(g, w, rtol=F32_TOL, atol=F32_TOL,
                                       msg=lambda m: f"{tag} {name}: {m}")
    else:
        rules = [bf16_rule(g, w) for g, w in zip(got, want)]
        if not all(ok for ok, _ in rules):
            raise AssertionError(f"bf16 rule fails: {tag} {list(zip(names, rules))}")
    return max((g - w).abs().max().item() for g, w in zip(got, want) if g.numel())


def check_render_tile_options(params, args, net):
    """The render tile's white background (float32) and fast epilogue
    (bfloat16) against the twin with the same options."""
    for dtype, opts in ((torch.float32, dict(white_bkgd=True)),
                        (torch.bfloat16, dict(fast_epilogue=True))):
        with torch.no_grad():
            got = rm.fused_render_tile(params, *args, net, compute_dtype=dtype, **opts)
            want = rm.render_tile_ref(params, *args, net, compute_dtype=dtype, **opts)
        for g, w in zip(got, want):
            if dtype == torch.float32:
                torch.testing.assert_close(g, w, rtol=F32_TOL, atol=F32_TOL)
            elif not bf16_rule(g, w)[0]:
                raise AssertionError(f"bf16 rule fails: fused_render_tile {opts}")
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        log(f"kernel vs twin fused_render_tile box {opts} {str(dtype)[6:]}: "
            f"max abs err {err:.2e}")


def phase_kernels(net, peaks):
    """Every kernel vs its twin at the main path's shapes (timed) and at
    ragged ones (not a multiple of the kernels' 64-point tile)."""
    dev = DEVICE
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
    rec = {k: {"err_f32": 0.0, "err_bf16": 0.0, "ms": {}, "plain_ms": {}, "bound_ms": {},
               "bound_by": {}} for k in KERNELS}
    chain = {}
    for n, s, timed in RAY_SHAPES:
        rays = march_inputs(n, s, gen, dev)
        if timed:
            for dtype in (torch.bfloat16, torch.float32):
                key = shape_key(str(dtype)[6:], n, s)
                chain[key] = time_chain(weights["random"], net, rays, dtype)
                log(f"time chain yardstick ({str(dtype)[6:]} torch.matmul per layer) S{s} N={n}: "
                    f"{chain[key]:.3f} ms")
        for kernel, (wrapper, twin, inputs) in KERNELS.items():
            args = inputs(net, rays)
            errs = {}
            for scene, params in weights.items():
                for dtype in (torch.float32, torch.bfloat16):
                    key = "err_f32" if dtype == torch.float32 else "err_bf16"
                    e = check(kernel, params, args, net, dtype, f"{kernel} {scene} "
                              f"N={n} S={s} {str(dtype)[6:]}")
                    errs[(scene, key)] = e
                    rec[kernel][key] = max(rec[kernel][key], e)
            log(f"kernel vs twin {kernel} N={n} S={s}: max abs err "
                + ", ".join(f"{sc} {k[4:]} {e:.2e}" for (sc, k), e in errs.items()))
            if kernel == "fused_render_tile" and (n, s) == RAGGED:
                check_render_tile_options(weights["box"], args, net)
            if not timed:
                continue
            params = weights["random"]
            for dtype in (torch.float32, torch.bfloat16):
                key = shape_key(str(dtype)[6:], n, s)
                with torch.no_grad():
                    ms = time_ms(lambda: wrapper(params, *args, net, compute_dtype=dtype))
                    plain = time_ms(lambda: twin(params, *args, net, compute_dtype=dtype))
                peak = peaks[0] if dtype == torch.float32 else peaks[1]
                b, by = bound(*work(kernel, net, n, s, weight_bytes), peak, peaks[2])
                rec[kernel]["ms"][key], rec[kernel]["plain_ms"][key] = ms, plain
                rec[kernel]["bound_ms"][key], rec[kernel]["bound_by"][key] = b, by
                log(f"time {kernel} {key} N={n} ({CORES[kernel][str(dtype)[6:]]} core): "
                    f"kernel {ms:.3f} ms, twin {plain:.3f} ms, bound {b:.3f} ms ({by})")
        del rays
        torch.cuda.empty_cache()
    rec["fused_render_tile"]["max_samples"] = render_tile_maxima(net)
    for name, kw in EXTRA_NETS.items():
        rec_net = check_net(NeRFNetConfig(**kw), name, gen)
        for kernel, errs in rec_net.items():
            rec[kernel].setdefault("err_nets", {})[name] = errs
    wide = time_wide_net(gen, peaks)
    for kernel, times in wide.items():
        rec[kernel]["wide"] = times
    return rec, chain


def render_tile_maxima(net):
    """The most samples per ray that fused_render_tile takes (one ray per
    group) for the encodings of net, at each core width in each dtype, from
    the device's shared memory; each must hold the exact fine pass's 192."""
    lib = rm._library("render_tile")
    with torch.cuda.device(DEVICE):
        out = {f"{dtype}_W{w}": lib.render_tile_max_samples(
            int(dtype == "bfloat16"), w, net.input_ch, net.input_ch_views)
            for dtype in ("float32", "bfloat16") for w in rm.CORE_WIDTHS}
    log("render tile: most samples per ray (PE "
        f"{net.multires}/{net.multires_views}) " + ", ".join(f"{k} {v}" for k, v in out.items()))
    if min(out.values()) < 192:
        raise AssertionError(f"fused_render_tile takes fewer than 192 samples per ray: {out}")
    return out


def time_wide_net(gen, peaks):
    """The five kernels on the WIDE net at N_RAYS x WIDE_S samples in both
    dtypes (random weights): kernel, twin and bound ms, the bound from the
    net's own work (not the zero-padded work), and the kernel's share of
    its bound: {kernel: {shape key: {...}}}."""
    net = NeRFNetConfig(**EXTRA_NETS[WIDE])
    params = init_nerf_params(net, generator=gen, device=DEVICE)
    weight_bytes = sum(t.numel() * 4 for t in params.values())
    out = {kernel: {} for kernel in KERNELS}
    for s in WIDE_S:
        rays = march_inputs(N_RAYS, s, gen, DEVICE)
        for kernel, (wrapper, twin, inputs) in KERNELS.items():
            args = inputs(net, rays)
            for dtype in (torch.float32, torch.bfloat16):
                key = shape_key(str(dtype)[6:], N_RAYS, s)
                with torch.no_grad():
                    ms = time_ms(lambda: wrapper(params, *args, net, compute_dtype=dtype),
                                 reps=5, warmup=1)
                    plain = time_ms(lambda: twin(params, *args, net, compute_dtype=dtype),
                                    reps=5, warmup=1)
                peak = peaks[0] if dtype == torch.float32 else peaks[1]
                b, by = bound(*work(kernel, net, N_RAYS, s, weight_bytes), peak, peaks[2])
                out[kernel][key] = dict(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                                        share=b / ms)
                log(f"time {WIDE} {kernel} {key} N={N_RAYS} ({CORES[kernel][str(dtype)[6:]]} "
                    f"core): kernel {ms:.3f} ms, twin {plain:.3f} ms, bound {b:.3f} ms ({by}), "
                    f"{b / ms:.1%} of the bound")
        del rays, args
        torch.cuda.empty_cache()
    return out


def check_net(net, name, gen):
    """Every kernel vs its twin on one more net (random and He-scaled
    weights, both dtypes) at EXTRA_SHAPES (the ragged ones for RAGGED_ONLY):
    {kernel: {dtype: max abs err}}."""
    random = init_nerf_params(net, generator=gen, device=DEVICE)
    weights = {"random": random,
               "random_he": {k: v * (6 ** 0.5 if k.endswith("kernel") else 1.0)
                             for k, v in random.items()}}
    out = {kernel: {"float32": 0.0, "bfloat16": 0.0} for kernel in KERNELS}
    shapes = [sh for sh in EXTRA_SHAPES if name not in RAGGED_ONLY or sh[0] != N_RAYS]
    for n, s in shapes:
        rays = march_inputs(n, s, gen, DEVICE)
        for kernel, (_, _, inputs) in KERNELS.items():
            args = inputs(net, rays)
            for scene, params in weights.items():
                for dtype in (torch.float32, torch.bfloat16):
                    e = check(kernel, params, args, net, dtype,
                              f"{kernel} net {name} {scene} N={n} S={s} {str(dtype)[6:]}")
                    out[kernel][str(dtype)[6:]] = max(out[kernel][str(dtype)[6:]], e)
    log(f"kernel vs twin on net {name} ({net.netdepth}x{net.netwidth}, multires "
        f"{net.multires}/{net.multires_views}): max abs err "
        + ", ".join(f"{k} f32 {v['float32']:.2e} bf16 {v['bfloat16']:.2e}"
                    for k, v in out.items()))
    return out


def phase_backward(net):
    """One backward through each differentiable wrapper (kernel forward,
    float32 recompute) against plain autograd through that recompute; the
    render tile refuses a gradient on the card."""
    dev = DEVICE
    gen = torch.Generator().manual_seed(1)
    params = box_scene_params(net, generator=gen, device=dev)
    rays = march_inputs(64, 16, gen, dev)
    recompute = {
        "fused_nerf_march": lambda p, o, d, v, z: rm.march_channels_ref(p, o, d, v, z, net),
        "fused_nerf_mlp_widepe": lambda p, x, d: rm.mlp_widepe_ref(p, x, d, net),
        # the JAX package's _pe_bwd recomputes through the projection form
        "fused_nerf_mlp_pe": lambda p, x, d: rm.mlp_widepe_ref(p, x, d, net),
        "fused_nerf_mlp": lambda p, x, d: nerf_apply(p, x, d, net),
    }
    for kernel, ref in recompute.items():
        args = KERNELS[kernel][2](net, rays)
        wrapper = KERNELS[kernel][0]

        def grads(fn):
            leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
            ins = [a.clone().requires_grad_(True) for a in args]
            out = fn(leaves, *ins)
            out = out if isinstance(out, tuple) else (out,)
            # randn, not randn_like: the twin's rgb3 is a permuted view, and
            # randn_like would lay its draws out in that view's memory order
            torch.manual_seed(0)
            sum((o * torch.randn(o.shape, device=o.device)).sum() for o in out).backward()
            return [leaves[k].grad for k in sorted(leaves)] + [a.grad for a in ins]

        got = grads(lambda p, *a: wrapper(p, *a, net, compute_dtype=torch.float32))
        want = grads(ref)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=F32_TOL, atol=F32_TOL)
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        log(f"backward {kernel} through autograd.Function vs plain autograd: "
            f"max abs err {err:.3e}")
    leaf = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    try:
        rm.fused_render_tile(leaf, *rays, net, compute_dtype=torch.float32)
    except RuntimeError as e:
        log(f"backward fused_render_tile: refused on the card ({str(e)[:40]}...)")
    else:
        raise AssertionError("fused_render_tile returned outputs to a gradient request")


def routed_rays(rc, n):
    """The rays a render of n rays marches: all of them, or k_sel of
    ops/render.py's culled route when rc.hit_budget < 1 (with a grid)."""
    if rc.hit_budget >= 1.0:
        return n
    k = int(round(n * rc.hit_budget))
    return max(8, min(n, -(-k // 8) * 8))


def psnr(a, b):
    return -10.0 * math.log10(max(((a - b) ** 2).mean().item(), 1e-12))


def drive_route(models, psi, kernel, per_chunk=2, production=False, cfg=None, **render):
    """render_images at the default config (or cfg) through one march route:
    the kernel's counter must read per_chunk per chunk of marched rays and
    the others 0. production: the config's production_mode(), whose renderer
    builds the grid and calibrates the budget (timed as setup_s)."""
    cfg = cfg or NeuralSimConfig()
    rc = dataclasses.replace(cfg.render, **render)
    cfg = cfg.replace(render=rc.production_mode() if production else rc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    renderer = NeuralSimRenderer(cfg, models=models, device=DEVICE)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_rays = K_POSES * renderer.H * renderer.W
    n_routed = routed_rays(renderer.rc, n_rays)
    expect = per_chunk * math.ceil(n_routed / renderer.rc.ray_chunk)

    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    rgb, noise = renderer.render_images(psi, torch.Generator().manual_seed(0), num_k=K_POSES)
    torch.cuda.synchronize()
    seconds = [time.perf_counter() - t0]
    launched = counts()
    dtype = renderer.rc.compute_dtype
    tag = f"{kernel}, {dtype}" + (", production" if production else "")
    if cfg.net != NeRFNetConfig():
        tag += f", {cfg.net.netdepth}x{cfg.net.netwidth} net"
    log(f"main path [{tag}]: K={K_POSES} {renderer.H}x{renderer.W} images, "
        f"{n_rays} rays ({n_routed} marched), launches {launched} (expected {expect} of "
        f"{kernel})")
    if launched != {k: (expect if k == kernel else 0) for k in launched}:
        raise AssertionError(f"route {render} launched {launched}, expected {expect} "
                             f"of {kernel} and no other kernel")
    with torch.no_grad():
        for _ in range(2):
            t0 = time.perf_counter()
            rgb2, _, acc = renderer._render_impl(psi, noise)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
    if not (torch.isfinite(rgb).all() and rgb.min() >= 0 and rgb.max() <= 1):
        raise AssertionError(f"[{tag}] images not finite or outside [0, 1]")
    if rgb.shape != (K_POSES, renderer.H, renderer.W, 3):
        raise AssertionError(f"[{tag}] images have shape {tuple(rgb.shape)}")
    hit = (acc > 0.5).float().mean().item()
    if hit == 0.0:
        raise AssertionError(f"[{tag}] render is empty: acc <= 0.5 everywhere")
    torch.testing.assert_close(rgb2, rgb, rtol=0, atol=1e-5)
    best = statistics.median(seconds)
    log(f"main path [{tag}]: {hit:.3%} of pixels with acc > 0.5; render times (s) "
        f"{[round(t, 4) for t in seconds]}; median {best:.4f} s = {n_rays / best:.0f} "
        f"rays/s, {1e3 * best / K_POSES:.2f} ms/image")
    return dict(rgb=rgb, noise=noise, launches=launched[kernel], renderer=renderer,
                rays_per_s=n_rays / best, ms_per_image=1e3 * best / K_POSES,
                setup_s=setup_s, launched=launched)


def phase_main_path():
    cfg = NeuralSimConfig()
    gen = torch.Generator().manual_seed(0)
    box = box_scene_params(cfg.net, generator=gen, device=DEVICE)
    models = {"coarse": box, "fine": box}
    psi = psi_init("5")
    routes = {
        "fused_nerf_march": drive_route(models, psi, "fused_nerf_march"),
        "fused_nerf_mlp_widepe": drive_route(models, psi, "fused_nerf_mlp_widepe",
                                             fuse_pointgen=False),
        "fused_render_tile": drive_route(models, psi, "fused_render_tile",
                                         fuse_compositing=True),
    }
    exact = routes["fused_nerf_march"]
    twin_cfg = cfg.replace(render=dataclasses.replace(cfg.render, use_pallas=False))
    twin = NeuralSimRenderer(twin_cfg, models=models, device=DEVICE)
    with torch.no_grad():
        t0 = time.perf_counter()
        rgb_twin = twin._render_impl(psi, exact["noise"])[0]
        torch.cuda.synchronize()
        twin_s = time.perf_counter() - t0
    n_rays = K_POSES * twin.H * twin.W
    log(f"main path twin render (use_pallas=False): {twin_s:.4f} s = "
        f"{n_rays / twin_s:.0f} rays/s")
    for kernel, route in routes.items():
        for a, b in zip(route["noise"], exact["noise"]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        e_exact = (route["rgb"] - exact["rgb"]).abs().max().item()
        e_twin = (route["rgb"] - rgb_twin).abs().max().item()
        torch.testing.assert_close(route["rgb"], exact["rgb"], rtol=F32_TOL, atol=F32_TOL)
        torch.testing.assert_close(route["rgb"], rgb_twin, rtol=F32_TOL, atol=F32_TOL)
        route["err_vs_exact"], route["err_vs_twin"] = e_exact, e_twin
        log(f"main path [{kernel}]: rgb vs ray-march route max abs err {e_exact:.3e}, "
            f"vs twin render {e_twin:.3e}")

    # bf16: the tensor-core kernels of the three routes
    bf16 = {
        "fused_nerf_march": drive_route(models, psi, "fused_nerf_march",
                                        compute_dtype="bfloat16"),
        "fused_nerf_mlp_widepe": drive_route(models, psi, "fused_nerf_mlp_widepe",
                                             fuse_pointgen=False, compute_dtype="bfloat16"),
        "fused_render_tile": drive_route(models, psi, "fused_render_tile",
                                         fuse_compositing=True, compute_dtype="bfloat16"),
    }
    twin16 = NeuralSimRenderer(cfg.replace(render=dataclasses.replace(
        cfg.render, use_pallas=False, compute_dtype="bfloat16")), models=models, device=DEVICE)
    with torch.no_grad():
        t0 = time.perf_counter()
        rgb_twin16 = twin16._render_impl(psi, exact["noise"])[0]
        torch.cuda.synchronize()
        twin16_s = time.perf_counter() - t0
    log(f"main path bf16 twin render (use_pallas=False): {twin16_s:.4f} s = "
        f"{n_rays / twin16_s:.0f} rays/s")
    for kernel, route in bf16.items():
        for a, b in zip(route["noise"], exact["noise"]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        off = (route["rgb"] - exact["rgb"]).abs()
        route["err_vs_twin"] = (route["rgb"] - rgb_twin16).abs().max().item()
        route["err_vs_f32"] = off.max().item()
        route["frac_off_f32"] = (off > BF16_RENDER_TOL).float().mean().item()
        log(f"main path [{kernel}, bfloat16]: rgb vs bf16 twin render max abs err "
            f"{route['err_vs_twin']:.3e} (limit {BF16_RENDER_TOL:g}); vs float32 render max "
            f"abs err {route['err_vs_f32']:.3e} (limit {BF16_VS_F32_MAX:g}), mean "
            f"{off.mean().item():.3e}, {route['frac_off_f32']:.2e} of values beyond "
            f"{BF16_RENDER_TOL:g} (limit {BF16_VS_F32_FRAC:g})")
        torch.testing.assert_close(route["rgb"], rgb_twin16, rtol=0, atol=BF16_RENDER_TOL)
        if route["err_vs_f32"] > BF16_VS_F32_MAX or route["frac_off_f32"] > BF16_VS_F32_FRAC:
            raise AssertionError(f"[{kernel}, bfloat16] rgb too far from the float32 render")
    return routes, bf16, box, cfg


def phase_wide_main_path(psi, smi):
    """5c: render_images at the default config on the WIDE net's box-scene
    weights, float32 and bfloat16, default route (the ray march): 2 launches
    of fused_nerf_march per ray chunk and no other kernel, rgb within 2e-3
    (float32) or BF16_RENDER_TOL (bfloat16) of the twin's render."""
    net = NeRFNetConfig(**EXTRA_NETS[WIDE])
    cfg = NeuralSimConfig().replace(net=net)
    box = box_scene_params(net, generator=torch.Generator().manual_seed(3), device=DEVICE)
    models = {"coarse": box, "fine": box}
    out = {}
    for dtype, tol in (("float32", F32_TOL), ("bfloat16", BF16_RENDER_TOL)):
        run = drive_route(models, psi, "fused_nerf_march", cfg=cfg, compute_dtype=dtype)
        twin = NeuralSimRenderer(cfg.replace(render=dataclasses.replace(
            run["renderer"].rc, use_pallas=False)), models=models, device=DEVICE)
        with torch.no_grad():
            rgb_twin = twin._render_impl(psi, run["noise"])[0]
        err = (run["rgb"] - rgb_twin).abs().max().item()
        log(f"main path [{WIDE}, fused_nerf_march, {dtype}]: rgb vs twin render max abs err "
            f"{err:.3e} (limit {tol:g}); {run['rays_per_s']:.0f} rays/s on {smi}")
        torch.testing.assert_close(run["rgb"], rgb_twin, rtol=0, atol=tol)
        out[dtype] = dict(launches=run["launches"], err_vs_twin=err,
                          rays_per_s=run["rays_per_s"], ms_per_image=run["ms_per_image"])
    return out


def phase_plain_net(psi):
    """5b: the K=8 render of a net without view directions launches no
    kernel on the card and equals the same rays' render on the CPU."""
    net = NeRFNetConfig(use_viewdirs=False)
    gen = torch.Generator().manual_seed(2)
    box = box_scene_params(NeRFNetConfig(), generator=gen, device=DEVICE)
    params = {k: v for k, v in box.items() if k.startswith("pts_")}
    rgb_head = 0.3 * torch.randn(net.netwidth, 3, generator=gen).to(DEVICE)
    params["output_kernel"] = torch.cat([rgb_head, box["alpha_kernel"]], dim=1)
    params["output_bias"] = torch.zeros(4, device=DEVICE)
    models = {"coarse": params, "fine": params}
    cfg = NeuralSimConfig().replace(net=net)
    renderer = NeuralSimRenderer(cfg, models=models, device=DEVICE)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    rgb, noise = renderer.render_images(psi, torch.Generator().manual_seed(0), num_k=K_POSES)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launched = counts()
    if any(launched.values()):
        raise AssertionError(f"use_viewdirs=False render launched {launched}")
    if not (torch.isfinite(rgb).all() and rgb.min() >= 0 and rgb.max() <= 1):
        raise AssertionError("use_viewdirs=False render: images not finite or outside [0, 1]")
    # the same rays on the CPU: every 5th ray of the first image
    pose = poses_of(cfg, noise, psi)[:1]
    o, d = (t.reshape(-1, 3)[::5] for t in get_rays(renderer.H, renderer.W, renderer.K, pose))
    with torch.no_grad():
        got = render_ray_batch(models, o, d, net, renderer.rc)["rgb_map"]
        cpu = {k: {n: v.cpu() for n, v in p.items()} for k, p in models.items()}
        want = render_ray_batch(cpu, o.cpu(), d.cpu(), net, renderer.rc)["rgb_map"]
    torch.testing.assert_close(got.cpu(), want, rtol=F32_TOL, atol=F32_TOL)
    torch.testing.assert_close(got, rgb[0].reshape(-1, 3)[::5], rtol=0, atol=1e-5)
    err = (got.cpu() - want).abs().max().item()
    hit = (rgb.amax(-1) > 0.05).float().mean().item()
    log(f"plain net [use_viewdirs=False]: K={K_POSES} render {secs:.4f} s (host clock, first "
        f"call), launches {launched}; {hit:.3%} of pixels lit; {o.shape[0]} rays vs the CPU "
        f"render max abs err {err:.3e} (limit {F32_TOL:g})")
    if hit == 0.0:
        raise AssertionError("use_viewdirs=False render is empty")
    return dict(launches=sum(launched.values()), err_vs_cpu=err, seconds=secs)


def raw_field(sigma, rgb3):
    """The march kernel's planes as raw [M,4]."""
    return torch.cat([torch.movedim(rgb3, 0, -1), sigma[..., None]], -1).reshape(-1, 4)


def phase_entry_points(box, cfg, routes):
    """The exported point-major entries on the coarse sample points of the
    K=8 render (80,000 rays x 64 samples): one launch each, against the
    ray-march kernel's raw field at the same points; fused_nerf_mlp also
    in bf16 (tensor cores), against the bf16 ray-march kernel's."""
    exact = routes["fused_nerf_march"]
    r = exact["renderer"]
    dev = DEVICE
    psi = torch.as_tensor(psi_init("5"), dtype=torch.float32, device=dev)
    probs = psi_to_probs(psi, cfg.sampler)
    poses = poses_from_noise(probs, exact["noise"].to(dev), cfg.sampler)
    o, d = (t.reshape(-1, 3) for t in get_rays(r.H, r.W, r.K, poses))
    vd = d / d.norm(dim=-1, keepdim=True)
    z = stratified_z_vals(o.shape[0], r.rc.n_samples, r.rc.near, r.rc.far,
                          perturb=False, device=dev)
    x_pe, d_pe = point_inputs("fused_nerf_mlp", cfg.net, (o, d, vd, z))
    pts, dirs = point_inputs("fused_nerf_mlp_pe", cfg.net, (o, d, vd, z))
    out = {}
    with torch.no_grad():
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        raw_enc = kernels.fused_nerf_mlp(box, x_pe, d_pe, cfg.net, torch.float32)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        raw_pe = rm.fused_nerf_mlp_pe(box, pts, dirs, cfg.net, torch.float32)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launched = counts()
        want = raw_field(*rm.fused_nerf_march(box, o, d, vd, z, cfg.net, torch.float32))
        torch.cuda.synchronize()  # the march must not run into the timed launch
        zero_counts()
        t3 = time.perf_counter()
        raw16 = kernels.fused_nerf_mlp(box, x_pe, d_pe, cfg.net, torch.bfloat16)
        torch.cuda.synchronize()
        secs16 = time.perf_counter() - t3
        launched16 = counts()
        want16 = raw_field(*rm.fused_nerf_march(box, o, d, vd, z, cfg.net, torch.bfloat16))
    for kernel, raw, secs in (("fused_nerf_mlp", raw_enc, t1 - t0),
                              ("fused_nerf_mlp_pe", raw_pe, t2 - t1)):
        if launched[kernel] != 1 or sum(launched.values()) != 2:
            raise AssertionError(f"entry points launched {launched}")
        torch.testing.assert_close(raw, want, rtol=F32_TOL, atol=F32_TOL)
        err = (raw - want).abs().max().item()
        out[kernel] = dict(launches=launched[kernel], err_vs_march=err, host_ms=1e3 * secs)
        log(f"entry point {kernel}: {raw.shape[0]} points, launches {launched[kernel]}, "
            f"{1e3 * secs:.3f} ms (host clock), raw vs ray-march kernel max abs err "
            f"{err:.3e}, sigma max {raw[:, 3].max().item():.2f}")
    if launched16 != {k: int(k == "fused_nerf_mlp") for k in launched16}:
        raise AssertionError(f"bf16 entry point launched {launched16}")
    if not torch.isfinite(raw16).all():
        raise AssertionError("bf16 entry point fused_nerf_mlp: raw not finite")
    ok, bad = bf16_rule(raw16, want16)
    err = (raw16 - want16).abs().max().item()
    log(f"entry point fused_nerf_mlp, bfloat16: {raw16.shape[0]} points, launches "
        f"{launched16['fused_nerf_mlp']}, {1e3 * secs16:.3f} ms (host clock), raw vs bf16 "
        f"ray-march kernel max abs err {err:.3e}, {bad:.2e} of values beyond the bf16 rule")
    if not ok:
        raise AssertionError("bf16 entry point fused_nerf_mlp fails the bf16 rule against "
                             "the bf16 ray-march kernel")
    out16 = {"fused_nerf_mlp": dict(launches=launched16["fused_nerf_mlp"], err_vs_march=err,
                                    host_ms=1e3 * secs16)}
    return out, out16


def poses_of(cfg, noise, psi):
    """The K poses that render_images draws from psi and noise."""
    psi = torch.as_tensor(psi, dtype=torch.float32, device=DEVICE)
    return poses_from_noise(psi_to_probs(psi, cfg.sampler), noise.to(DEVICE), cfg.sampler)


def production_pipeline(models, psi, exact, dtype, kernel="fused_nerf_march", **render):
    """(a) NeuralSimRenderer(production_mode()) in one dtype through one
    route (render: the route's RenderConfig options): budget below 1, one
    launch of the route's kernel per chunk of routed rays, rgb within the
    dtype's tolerance of the twin's production render and > 40 dB from the
    exact render of the same poses (exact: phase 5's route in the same
    dtype)."""
    run = drive_route(models, psi, kernel, per_chunk=1, production=True,
                      compute_dtype=dtype, **render)
    r = run["renderer"]
    budget = r.rc.hit_budget
    if render:
        dtype = f"{dtype}, " + ", ".join(f"{k}={v}" for k, v in render.items())
    if not budget < 1.0:
        raise AssertionError(f"[production, {dtype}] calibrated budget {budget}: the "
                             "production render would be the exact one")
    for a, b in zip(run["noise"], exact["noise"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    cfg = r.cfg
    # grid build and calibration on their own (the constructor's run above
    # includes first-call set-up), and the render's diagnostics
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grid = r.occupancy_grid()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        measured = calibrate_hit_budget(grid, r.calibration_poses(), r.H, r.W, r.K, r.rc)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = render_poses(r.models, poses_of(cfg, run["noise"], psi), r.H, r.W, r.K,
                           cfg.net, r.rc, grid=r.grid, device=DEVICE)
    if not all(torch.equal(a, b) for a, b in zip(grid, r.grid)):
        raise AssertionError(f"[production, {dtype}] the grid differs between two builds")
    if max(cfg.render.hit_budget, measured) != budget:
        raise AssertionError(f"[production, {dtype}] calibration gave {measured}, the "
                             f"renderer holds {budget}")
    hits, k_sel = int(out["occ_hit_count"]), int(out["occ_budget"])
    n_rays = K_POSES * r.H * r.W
    if k_sel != routed_rays(r.rc, n_rays) or hits > k_sel:
        raise AssertionError(f"[production, {dtype}] occ_hit_count {hits}, occ_budget {k_sel}")
    torch.testing.assert_close(out["rgb_map"], run["rgb"], rtol=0, atol=1e-5)

    twin_cfg = cfg.replace(render=dataclasses.replace(cfg.render, use_pallas=False))
    twin = NeuralSimRenderer(twin_cfg, models=models, device=DEVICE)
    with torch.no_grad():
        rgb_twin = twin._render_impl(psi, run["noise"])[0]
    tol = F32_TOL if r.rc.compute_dtype == "float32" else BF16_RENDER_TOL
    err_twin = (run["rgb"] - rgb_twin).abs().max().item()
    diff = (run["rgb"] - exact["rgb"]).abs().max().item()
    run.update(budget=budget, hits=hits, k_sel=k_sel, grid_s=t1 - t0, calibrate_s=t2 - t1,
               err_vs_twin=err_twin, psnr_vs_exact=psnr(run["rgb"], exact["rgb"]),
               max_diff_vs_exact=diff, exact_rays_per_s=exact["rays_per_s"])
    occ = grid[0]
    log(f"production [{dtype}]: grid {tuple(occ.shape)} over {grid[1].tolist()}..."
        f"{grid[2].tolist()}, {occ.mean().item():.4f} occupied; grid build "
        f"{run['grid_s']:.4f} s, calibration {run['calibrate_s']:.4f} s, renderer set-up "
        f"{run['setup_s']:.4f} s (host clock)")
    log(f"production [{dtype}]: effective hit_budget {budget} (floor "
        f"{cfg.render.hit_budget}), occ_hit_count {hits} / occ_budget {k_sel} of {n_rays} "
        f"rays; {run['rays_per_s']:.0f} rays/s vs exact {exact['rays_per_s']:.0f}; rgb vs "
        f"twin max abs err {err_twin:.3e} (limit {tol:g}); vs exact PSNR "
        f"{run['psnr_vs_exact']:.2f} dB (limit 40), max abs diff {diff:.3e}")
    if twin.rc.hit_budget != budget:
        raise AssertionError(f"[production, {dtype}] twin budget {twin.rc.hit_budget}")
    torch.testing.assert_close(run["rgb"], rgb_twin, rtol=0, atol=tol)
    if not run["psnr_vs_exact"] > 40.0 or diff == 0.0:
        raise AssertionError(f"[production, {dtype}] PSNR vs exact {run['psnr_vs_exact']:.2f}"
                             f" dB, max diff {diff}: must be > 40 dB and not exact")
    return run


def production_route(name, r, rc, poses, exact_rgb, per_chunk, grid=None):
    """(b) one more production route through render_poses (float32) at the
    K=8 pipeline shape: its launches of the march kernel, its rgb against
    the twin's (2e-3), its PSNR against the exact render."""
    kernel = "fused_nerf_march"
    n_rays = K_POSES * r.H * r.W
    with torch.no_grad():
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        out = render_poses(r.models, poses, r.H, r.W, r.K, r.cfg.net, rc, grid=grid,
                           device=DEVICE)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = counts()
        twin = render_poses(r.models, poses, r.H, r.W, r.K, r.cfg.net,
                            dataclasses.replace(rc, use_pallas=False), grid=grid,
                            device=DEVICE)
    n_routed = routed_rays(rc, n_rays) if grid is not None else n_rays
    expect = per_chunk * math.ceil(n_routed / rc.ray_chunk)
    rgb = out["rgb_map"]
    err = (rgb - twin["rgb_map"]).abs().max().item()
    quality = psnr(rgb, exact_rgb)
    log(f"production route [{name}]: {n_routed} of {n_rays} rays marched, launches "
        f"{launched} (expected {expect} of {kernel}); {secs:.4f} s = {n_rays / secs:.0f} "
        f"rays/s (host clock, first call); rgb vs twin max abs err {err:.3e} (limit "
        f"{F32_TOL:g}); vs exact PSNR {quality:.2f} dB")
    if launched != {k: (expect if k == kernel else 0) for k in launched}:
        raise AssertionError(f"production route {name} launched {launched}")
    # the culled route scatters into the empty outputs: hit rays are in the budget
    if grid is not None and int(out["occ_hit_count"]) > int(out["occ_budget"]):
        raise AssertionError(f"production route {name}: {int(out['occ_hit_count'])} hit "
                             f"rays, budget {int(out['occ_budget'])}")
    if not (torch.isfinite(rgb).all() and rgb.min() >= 0 and rgb.max() <= 1):
        raise AssertionError(f"production route {name}: images not finite or outside [0, 1]")
    torch.testing.assert_close(rgb, twin["rgb_map"], rtol=F32_TOL, atol=F32_TOL)
    return dict(launches=launched[kernel], launched=launched, err_vs_twin=err,
                psnr_vs_exact=quality, rays_per_s=n_rays / secs, routed=n_routed)


def production_bench_shape(box):
    """(c) bench.py's production cell on the port: BENCH_POSES poses x
    BENCH_HW^2 from pose_spherical(linspace(0, 300), -30, 1.01), bfloat16,
    ray_chunk 32768, the grid of build_scene_grid, the budget of
    calibrate_hit_budget on the same poses, the single pass of
    production_mode(); exact and production rays/s, PSNR > 40 dB."""
    net = NeRFNetConfig()
    rc = dataclasses.replace(NeuralSimConfig().render, ray_chunk=32768,
                             compute_dtype="bfloat16").test_mode()
    h = w = BENCH_HW
    k = BENCH_K
    models = {"coarse": box, "fine": box}
    poses = pose_spherical(torch.linspace(0.0, 300.0, BENCH_POSES, device=DEVICE),
                           torch.full((BENCH_POSES,), -30.0, device=DEVICE), 1.01)
    n_rays = BENCH_POSES * h * w
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grid = build_scene_grid(make_sigma_fn(box, net), scene_half_extent(1.01, rc.far, h, w, k),
                                resolution=96, threshold=1e-2, dilate=2, device=DEVICE)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        budget = calibrate_hit_budget(grid, poses, h, w, k, rc)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    rc_prod = dataclasses.replace(rc.production_mode(), hit_budget=budget)
    if not (rc_prod.tighten_bounds and rc_prod.n_importance_culled == 0
            and rc_prod.n_samples_culled == 16 and budget < 1.0):
        raise AssertionError(f"bench shape: production config {rc_prod}, budget {budget}")

    def timed(rc_, grid_, reps):
        outs, seconds = None, []
        for _ in range(reps):
            torch.cuda.synchronize()
            zero_counts()
            t = time.perf_counter()
            with torch.no_grad():
                outs = render_poses(models, poses, h, w, k, net, rc_, grid=grid_, device=DEVICE)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t)
        return outs, seconds, counts()

    exact, exact_s, exact_launched = timed(rc, None, 2)
    prod, prod_s, prod_launched = timed(rc_prod, grid, 4)
    k_sel = routed_rays(rc_prod, n_rays)
    expect = {"exact": 2 * math.ceil(n_rays / rc.ray_chunk),
              "production": math.ceil(k_sel / rc.ray_chunk)}
    for name, launched in (("exact", exact_launched), ("production", prod_launched)):
        if launched != {kk: (expect[name] if kk == "fused_nerf_march" else 0) for kk in launched}:
            raise AssertionError(f"bench shape {name}: launched {launched}, expected "
                                 f"{expect[name]} of fused_nerf_march")
    rgb, rgb_exact = prod["rgb_map"], exact["rgb_map"]
    if not (torch.isfinite(rgb).all() and torch.isfinite(rgb_exact).all()):
        raise AssertionError("bench shape: images not finite")
    quality = psnr(rgb, rgb_exact)
    # the first of each set of renders runs cold (allocations, first packing)
    exact_t, prod_t = min(exact_s[1:]), statistics.median(prod_s[1:])
    rec = dict(poses=BENCH_POSES, hw=h, n_rays=n_rays, budget=budget,
               hits=int(prod["occ_hit_count"]), k_sel=int(prod["occ_budget"]),
               grid_s=t1 - t0, calibrate_s=t2 - t1, exact_s=exact_s, production_s=prod_s,
               exact_rays_per_s=n_rays / exact_t, production_rays_per_s=n_rays / prod_t,
               psnr_vs_exact=quality, launched=dict(exact=exact_launched,
                                                    production=prod_launched))
    log(f"bench shape ({BENCH_POSES} x {h}x{w}, bfloat16, ray_chunk {rc.ray_chunk}): grid "
        f"{rec['grid_s']:.4f} s, calibration {rec['calibrate_s']:.4f} s; hit_budget {budget}, "
        f"occ_hit_count {rec['hits']} / occ_budget {rec['k_sel']} of {n_rays} rays; exact "
        f"{[round(t, 4) for t in exact_s]} s -> {rec['exact_rays_per_s']:.0f} rays/s, "
        f"{expect['exact']} launches; production {[round(t, 4) for t in prod_s]} s -> "
        f"{rec['production_rays_per_s']:.0f} rays/s, {expect['production']} launches; PSNR vs "
        f"exact {quality:.2f} dB (limit 40)")
    if not quality > 40.0 or rec["hits"] > rec["k_sel"]:
        raise AssertionError(f"bench shape: PSNR {quality:.2f} dB, hits {rec['hits']} of "
                             f"budget {rec['k_sel']}")
    return rec


def phase_production(box, routes, routes16):
    """Phase 7: the production render of the K=8 pipeline shape in float32
    and bfloat16, in float32 also through the grid scorer and the two other
    march routes, three more production routes, and bench.py's shape."""
    models = {"coarse": box, "fine": box}
    psi = psi_init("5")
    pipeline = {dtype: production_pipeline(models, psi, exact, dtype)
                for dtype, exact in (("float32", routes["fused_nerf_march"]),
                                     ("bfloat16", routes16["fused_nerf_march"]))}
    exact32 = routes["fused_nerf_march"]
    for name, kernel, render in (
            ("float32_cull_grid", "fused_nerf_march", dict(cull_mode="grid")),
            ("float32_fuse_pointgen_false", "fused_nerf_mlp_widepe",
             dict(fuse_pointgen=False)),
            ("float32_fuse_compositing", "fused_render_tile", dict(fuse_compositing=True))):
        pipeline[name] = production_pipeline(models, psi, exact32, "float32", kernel, **render)
    run = pipeline["float32"]
    r = run["renderer"]
    poses = poses_of(r.cfg, run["noise"], psi)
    exact_rgb = routes["fused_nerf_march"]["rgb"]
    exact_rc = NeuralSimConfig().render.test_mode()
    others = {
        "hierarchical": production_route(
            "hierarchical culled, n_importance_culled=None", r,
            dataclasses.replace(r.rc, n_importance_culled=None), poses, exact_rgb, 2,
            grid=r.grid),
        "reuse_coarse": production_route(
            "reuse_coarse", r, dataclasses.replace(exact_rc, reuse_coarse=True), poses,
            exact_rgb, 2),
        "fine_fraction": production_route(
            "fine_fraction=0.25", r, dataclasses.replace(exact_rc, fine_fraction=0.25), poses,
            exact_rgb, 2),
    }
    bench = production_bench_shape(box)
    return pipeline, others, bench


def grad_close(name, got, want, rel=GRAD_REL):
    """got within rel * |want| of want (max abs difference); returns the
    relative difference. Both nonzero and finite."""
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"render gradient [{name}]: not finite")
    norm = float(torch.linalg.norm(want.double()))
    if not norm > 0 or not float(torch.linalg.norm(got.double())) > 0:
        raise AssertionError(f"render gradient [{name}]: zero gradient")
    diff = float((got.double() - want.double().to(got.device)).abs().max()) / norm
    log(f"render gradient [{name}]: max abs difference {diff:.3e} of the reference's norm "
        f"{norm:.4e} (limit {rel:g})")
    if not diff <= rel:
        raise AssertionError(f"render gradient [{name}]: {diff:.3e} > {rel:g}")
    return diff


def timed_grad(name, fn, n_img):
    """fn() on the card with every kernel counter at 0 before and after it
    (the gradient runs plain torch, as the JAX package's runs off Pallas):
    (gradient, record of seconds per image and peak memory)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    start_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    g = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = counts()
    peak = torch.cuda.max_memory_allocated()
    rec = dict(seconds=seconds, s_per_image=seconds / n_img, images=n_img,
               peak_gb=peak / 1e9, peak_over_start_gb=(peak - start_bytes) / 1e9,
               launches=launched, grad=g.tolist())
    log(f"render gradient [{name}]: {seconds:.3f} s for {n_img} images = "
        f"{rec['s_per_image']:.4f} s/image (host clock, first call); peak memory "
        f"{rec['peak_gb']:.2f} GB ({rec['peak_over_start_gb']:.2f} GB above the start); "
        f"launches {launched}; dL/dpsi {[float(f'{x:.4e}') for x in g.tolist()]}")
    if any(launched.values()):
        raise AssertionError(f"render gradient [{name}] launched a kernel: {launched}")
    return g, rec


def phase_render_grad(box, smi):
    """Phase 8: the psi render gradient (hypergrad/render_grad.py) of the
    K=8 box-scene render at the default config (100x100, 64 + 128 samples,
    ray_chunk 8192) with a seeded grad_E (normal x 1e-2): strips at
    grad_ray_chunk 5000, rev (a checkpoint per ray tile) and fwd (8 JVPs)
    in float32 against each other; strips on the card against the CPU at
    K=2 and render_factor 4 (25x25), in float32 and in bf16; culled strips against dense on the
    production renderer's grid and budget; bf16 strips against float32 by
    cosine; a Gaussian-psi strips gradient against its fwd; one momentum psi
    step. No kernel may launch during a gradient."""
    cfg = NeuralSimConfig()
    bc = cfg.bilevel
    models = {"coarse": box, "fine": box}
    renderer = NeuralSimRenderer(cfg, models=models, device=DEVICE)
    H, W, K, net, rc, sc = (renderer.H, renderer.W, renderer.K, cfg.net, renderer.rc,
                            cfg.sampler)
    psi = psi_init(bc.psi_pose_cats_mode).to(DEVICE)
    noise = draw_pose_noise(torch.Generator().manual_seed(0), sc, K_POSES, DEVICE)
    grad_E = (torch.randn((K_POSES, H, W, 3), generator=torch.Generator().manual_seed(1))
              * 1e-2).to(DEVICE)
    rec = {"config": f"K={K_POSES} {H}x{W}, {net.netdepth}x{net.netwidth} box-scene pair, "
                     f"{rc.n_samples}+{rc.n_importance} samples, ray_chunk {rc.ray_chunk}, "
                     f"grad_ray_chunk {bc.grad_ray_chunk}", "card": smi}

    def strips(strip=bc.grad_ray_chunk, **kw):
        return lambda: render_grad.render_grad_psi_strips(
            renderer.models, psi, noise, grad_E, H, W, K, net, rc, sc, strip=strip, **kw)

    # the first gradient of the process pays the backward's first-call set-up
    timed_grad("strips, float32, warm-up on one image",
               lambda: renderer.render_images_grad(psi, noise, grad_E[:1]), 1)
    g32, rec["strips_float32"] = timed_grad(
        "strips, float32", lambda: renderer.render_images_grad(psi, noise, grad_E), K_POSES)
    g_rev, rec["rev_float32"] = timed_grad(
        "rev, float32", lambda: renderer.render_images_grad(psi, noise, grad_E, mode="rev"),
        K_POSES)
    g_fwd, rec["fwd_float32"] = timed_grad(
        "fwd, float32", lambda: renderer.render_images_grad(psi, noise, grad_E, mode="fwd"),
        K_POSES)
    rec["rev_vs_strips"] = grad_close("rev vs strips", g_rev, g32)
    rec["fwd_vs_strips"] = grad_close("fwd vs strips", g_fwd, g32)

    # the card against the CPU on the same function at K=2, 25x25 (the two
    # least saturated poses of the draw: their soft bin samples are farthest
    # from one-hot)
    small = cfg.replace(data=dataclasses.replace(cfg.data, render_factor=4))
    cpu_models = {k: {n: v.cpu() for n, v in p.items()} for k, p in models.items()}
    on_card = NeuralSimRenderer(small, models=models, device=DEVICE)
    on_cpu = NeuralSimRenderer(small, models=cpu_models, device="cpu")
    rows = slice(3, 5)
    noise_2 = type(noise)(*(x[rows] for x in noise))
    ge_2 = (torch.randn((2, on_card.H, on_card.W, 3), generator=torch.Generator().manual_seed(2))
            * 1e-2)
    g_card, rec["strips_float32_k2_25x25"] = timed_grad(
        "strips, float32, K=2 25x25", lambda: on_card.render_images_grad(
            psi, noise_2, ge_2.to(DEVICE)), 2)
    t0 = time.perf_counter()
    g_cpu = on_cpu.render_images_grad(psi.cpu(), noise_2.to("cpu"), ge_2)
    rec["cpu_k2_25x25_s"] = time.perf_counter() - t0
    rec["card_vs_cpu"] = grad_close("card vs CPU, K=2 25x25", g_card.cpu(), g_cpu)

    # the same in bf16 (grad_compute_dtype's default), whose CPU gradient
    # the CPU tests hold to the JAX package's bf16 gradient: the card's
    # must lie nearer the CPU's bf16 gradient than the CPU's float32 one does
    def small_bf16(r, dev):
        return lambda: render_grad.render_grad_psi_strips(
            r.models, psi.to(dev), noise_2.to(dev), ge_2.to(dev), r.H, r.W, r.K, net, r.rc,
            sc, strip=bc.grad_ray_chunk, compute_dtype=bc.grad_compute_dtype)

    g16_card, rec["strips_bfloat16_k2_25x25"] = timed_grad(
        "strips, bfloat16, K=2 25x25", small_bf16(on_card, DEVICE), 2)
    g16_cpu = small_bf16(on_cpu, "cpu")()
    norm16 = float(g16_cpu.double().norm())
    rec["card_vs_cpu_bfloat16"] = float((g16_card.cpu() - g16_cpu).abs().max()) / norm16
    rec["cpu_float32_vs_bfloat16"] = float((g_cpu - g16_cpu).abs().max()) / norm16
    rec["card_vs_cpu_bfloat16_norm_ratio"] = float(g16_card.double().norm()) / norm16
    log(f"render gradient [card vs CPU, bfloat16, K=2 25x25]: max abs difference "
        f"{rec['card_vs_cpu_bfloat16']:.3e} of the CPU bf16 norm {norm16:.4e} (norm ratio "
        f"{rec['card_vs_cpu_bfloat16_norm_ratio']:.6f}); the CPU's float32 gradient is "
        f"{rec['cpu_float32_vs_bfloat16']:.3e} away")
    if not (torch.isfinite(g16_card).all() and norm16 > 0
            and rec["card_vs_cpu_bfloat16"] < rec["cpu_float32_vs_bfloat16"]):
        raise AssertionError("bf16 gradient: the card's is no nearer the CPU's bf16 gradient "
                             "than the CPU's float32 one")

    # culled strips on the production renderer's grid and calibrated budget
    # (grad_hit_budget < 0 tracks it), against dense strips of the same length
    prod = NeuralSimRenderer(cfg.replace(render=cfg.render.production_mode()), models=models,
                             device=DEVICE)
    budget = prod.rc.hit_budget if bc.grad_hit_budget < 0 else bc.grad_hit_budget
    n_pix = H * W
    k_sel = -(-max(1, int(round(n_pix * budget))) // CULL_STRIP) * CULL_STRIP
    if not (budget < 1.0 and k_sel < n_pix):
        raise AssertionError(f"culled gradient: budget {budget}, k_sel {k_sel} of {n_pix}: "
                             "the selection would not run")
    calls = {"psi_gather_loss": 0}
    gather = render_grad.psi_gather_loss

    def counted(*a, **kw):
        calls["psi_gather_loss"] += 1
        return gather(*a, **kw)

    warned = []
    handler = logging.Handler()
    handler.emit = lambda record: warned.append(record.getMessage())
    render_grad.logger.addHandler(handler)
    render_grad.psi_gather_loss = counted
    try:
        g_cull, rec["strips_culled_float32"] = timed_grad(
            f"culled strips, float32, strip {CULL_STRIP}", strips(
                strip=CULL_STRIP, grid=prod.grid, hit_budget=budget), K_POSES)
    finally:
        render_grad.psi_gather_loss = gather
        render_grad.logger.removeHandler(handler)
    expect_calls = K_POSES * k_sel // CULL_STRIP
    log(f"culled gradient: hit_budget {budget} (calibrated by the production renderer), "
        f"k_sel {k_sel} of {n_pix} pixels per image, {calls['psi_gather_loss']} gathered "
        f"chunks (expected {expect_calls}), overflow warnings {warned}")
    if warned or calls["psi_gather_loss"] != expect_calls:
        raise AssertionError("culled gradient: the selection did not run for every image")
    g_dense1k, rec["strips_dense_float32_strip1000"] = timed_grad(
        f"dense strips, float32, strip {CULL_STRIP}", strips(strip=CULL_STRIP), K_POSES)
    rec["culled_vs_dense"] = grad_close("culled vs dense", g_cull, g_dense1k)
    rec["culled_budget"], rec["culled_k_sel"] = budget, k_sel

    # bf16 strips (grad_compute_dtype's default) against float32
    g16, rec["strips_bfloat16"] = timed_grad(
        "strips, bfloat16", strips(compute_dtype=bc.grad_compute_dtype), K_POSES)
    cosine = float(torch.nn.functional.cosine_similarity(g16.double(), g32.double(), dim=0))
    rec["bf16_vs_f32_cosine"] = cosine
    rec["bf16_vs_f32_norm_ratio"] = float(g16.norm() / g32.norm())
    log(f"render gradient [strips, bfloat16 vs float32]: cosine {cosine:.8f} "
        f"(limit {GRAD_BF16_COS}, checked at the end of the phase), norm ratio "
        f"{rec['bf16_vs_f32_norm_ratio']:.4f}")

    # Gaussian psi: strips against fwd
    psi_g = torch.tensor([bc.gauss_mean_init, bc.gauss_std_init], device=DEVICE)
    noise_g = draw_pose_noise_gaussian(torch.Generator().manual_seed(3), sc, K_POSES, DEVICE)
    gg, rec["strips_gaussian_float32"] = timed_grad(
        "strips, gaussian psi, float32", lambda: render_grad.render_grad_psi_strips(
            renderer.models, psi_g, noise_g, grad_E, H, W, K, net, rc, sc, psi_mode="gaussian",
            strip=bc.grad_ray_chunk), K_POSES)
    gg_fwd, rec["fwd_gaussian_float32"] = timed_grad(
        "fwd, gaussian psi, float32", lambda: render_grad.render_grad_psi_fwd(
            renderer.models, psi_g, noise_g, grad_E, H, W, K, net, rc, sc,
            psi_mode="gaussian"), K_POSES)
    rec["gaussian_strips_vs_fwd"] = grad_close("gaussian strips vs fwd", gg, gg_fwd)

    # one psi step of the bilevel loop's optimizer (bilevel/driver.py) from
    # the float32 gradient
    opt = psi_optimizer_init(bc.opt_method, bc.opt_lr)
    opt, psi_next = psi_optimizer_update(opt, psi, g32)
    step = psi_next - psi
    log(f"psi step ({bc.opt_method}, lr {bc.opt_lr}): psi {psi.tolist()} -> "
        f"{psi_next.tolist()}")
    if bc.opt_method in ("sgd", "momentum"):       # the first step is psi - lr * grad
        torch.testing.assert_close(psi_next, psi - bc.opt_lr * g32, rtol=0, atol=0)
    if not (torch.isfinite(psi_next).all() and step.abs().max() > 0):
        raise AssertionError("psi step: not finite or no move")
    rec["psi_step"] = dict(method=bc.opt_method, lr=bc.opt_lr, psi=psi.tolist(),
                           psi_next=psi_next.tolist())
    log("render gradient: " + json.dumps(rec))
    if not cosine >= GRAD_BF16_COS:
        raise AssertionError(f"bf16 strips gradient cosine {cosine} < {GRAD_BF16_COS}")
    return rec


def detector_rel(name, got, want, rel=DET_REL):
    """max |got - want| over max |want| (want on the CPU); raises above rel."""
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"detector [{name}]: not finite")
    err = float((got - want).abs().max() / want.abs().max())
    log(f"detector [{name}]: card vs CPU {err:.3e} of max |x| (limit {rel:g})")
    if not err <= rel:
        raise AssertionError(f"detector [{name}]: {err:.3e} > {rel:g}")
    return err


def timed_steps(fn):
    """fn() with a CUDA event pair around every detector train_step it
    makes (inner_train calls trainer.train_step once per step): (fn's
    result, ms of each step)."""
    step = trainer.train_step
    events = []

    def timed(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(*args, **kwargs)
        end.record()
        events.append((start, end))
        return out

    trainer.train_step = timed
    try:
        out = fn()
    finally:
        trainer.train_step = step
    torch.cuda.synchronize()
    return out, [s.elapsed_time(e) for s, e in events]


def profile_steps(fn, n_steps):
    """fn() (n_steps detector steps) under torch.profiler: wall ms per step
    (host clock, profiler on), device ms per step (the CUDA kernels' self
    time), their ratio (the device's busy share), kernel launches per step
    and the five kernels of most device time. None when the trace holds no
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    if not device_us > 0:
        return None
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return {"steps": n_steps, "wall_ms_per_step": 1e3 * wall / n_steps,
            "device_ms_per_step": device_us / 1e3 / n_steps,
            "device_busy_share": device_us / 1e6 / wall,
            "kernel_launches_per_step": sum(e.count for e in kernels) / n_steps,
            "top_kernels_ms_per_step": {e.key[:80]: e.self_device_time_total / 1e3 / n_steps
                                        for e in top}}


def check_map(tag, result, gt_boxes):
    """Every AP of a coco_map result finite where its area range holds
    ground truth (NaN where it holds none), every per-class AP finite."""
    areas = np.concatenate([(b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]) for b in gt_boxes])
    ranges = {"AP": (0, 1e10), "AP50": (0, 1e10), "AP75": (0, 1e10), "APs": (0, 32 ** 2),
              "APm": (32 ** 2, 96 ** 2), "APl": (96 ** 2, 1e10)}
    for key, (lo, hi) in ranges.items():
        present = bool(((areas >= lo) & (areas <= hi)).any())
        # COCO gives an area range without ground truth no AP (-1 in
        # pycocotools; NaN in this evaluator)
        if not (math.isfinite(result[key]) if present else math.isnan(result[key])):
            raise AssertionError(f"{tag}: {key} = {result[key]} with ground truth "
                                 f"{'in' if present else 'outside'} its range")
    if not all(math.isfinite(v) for v in result["AP-per-class"].values()):
        raise AssertionError(f"{tag}: a per-class AP is not finite")


def phase_detector(renderer, smi):
    """Phase 9: the detector slice on the card. Render K = n_samples_k poses
    from psi_init("5") with NeuralSimRenderer.render_images on the phase-7
    production renderer (float32; fused_nerf_march must launch), annotate
    them on the card (slot 0 bit-equal to the host annotator on to8b of the
    same render), fine-tune RetinaNet-R50-FPN from a seeded init for
    max_iter steps at images_per_batch with cycle_indices (the first 3 step
    losses within DET_REL of the same steps on the CPU, every loss finite),
    hold the trained logits and deltas on 8 val images to the CPU's, and
    compute COCO mAP over a val set of VAL_IMAGES renders at poses from a
    second psi. Times: render, annotation (card, and the host annotator's
    library and numpy twin), train steps (cuDNN's default algorithms, as a
    run of the outer loop takes them, and the first steps again under
    cudnn.deterministic), eval; peak memory."""
    dc = renderer.cfg.detector
    k = renderer.cfg.sampler.n_samples_k
    label = 1
    rec = {"config": f"RetinaNet-R50-FPN ResNet-50 (3, 4, 6, 3), FPN 256, 4-conv heads, "
                     f"{dc.num_classes} classes, {dc.image_size}^2 input, batch "
                     f"{dc.images_per_batch}, {dc.max_iter} steps, lr {dc.base_lr}, warmup "
                     f"{dc.warmup_iters}, freeze_backbone {dc.freeze_backbone}, float32 (TF32 "
                     f"off, cuDNN's default algorithms); renders {renderer.H}x{renderer.W} production "
                     f"float32 (hit_budget {renderer.rc.hit_budget})", "card": smi}

    # the val set: renders from a second psi with a generator of their own
    with torch.no_grad():
        val_rgb, _ = renderer.render_images(psi_init(VAL_PSI), torch.Generator().manual_seed(9),
                                            num_k=VAL_IMAGES)
    val = detector_dataset.build_detector_batches_device(val_rgb, [label] * VAL_IMAGES, dc)

    # the main path of the slice: render -> annotate -> inner train -> mAP
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    rgb, _ = renderer.render_images(psi_init("5"), torch.Generator().manual_seed(0), num_k=k)
    torch.cuda.synchronize()
    rec["render_s"] = time.perf_counter() - t0
    rec["render_launches"] = counts()
    log(f"detector: K={k} renders {tuple(rgb.shape)} in {rec['render_s']:.4f} s (host clock), "
        f"launches {rec['render_launches']}")
    if not rec["render_launches"]["fused_nerf_march"] > 0:
        raise AssertionError("detector: the K-pose render did not launch fused_nerf_march")
    if not (torch.isfinite(rgb).all() and rgb.min() >= 0 and rgb.max() <= 1):
        raise AssertionError("detector: renders not finite or outside [0, 1]")

    zero_counts()
    labels = [label] * k
    t0 = time.perf_counter()
    train = detector_dataset.build_detector_batches_device(rgb, labels, dc)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = detector_dataset.build_detector_batches_device(rgb, labels, dc)
    torch.cuda.synchronize()
    rec["annotate_ms_per_image"] = 1e3 * (time.perf_counter() - t0) / k
    rec["annotate_first_call_ms_per_image"] = 1e3 * first / k
    for a, b in zip(train, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    boxes, valid = train[1].cpu().numpy(), train[3].cpu().numpy()
    to8b = [(np.clip(img, 0, 1) * 255).astype(np.uint8) for img in rgb.cpu().numpy()]
    t0 = time.perf_counter()
    native._load_lib()
    rec["host_annotator_build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = [detector_dataset.auto_annotate(img) for img in to8b]
    rec["host_annotate_ms_per_image"] = 1e3 * (time.perf_counter() - t0) / k
    # the host annotator's C++ library against its numpy twin on the same
    # masks: what the library saves on the host path
    masks = [detector_dataset.annotation_mask(img) for img in to8b]
    t0 = time.perf_counter()
    library = [native.connected_components(m) for m in masks]
    rec["host_components_library_ms_per_image"] = 1e3 * (time.perf_counter() - t0) / k
    t0 = time.perf_counter()
    twin = [native._connected_components_np(m) for m in masks]
    rec["host_components_numpy_ms_per_image"] = 1e3 * (time.perf_counter() - t0) / k
    if library != twin:
        raise AssertionError("detector: the host annotator's library and numpy twin differ")
    log(f"detector: host auto_annotate {rec['host_annotate_ms_per_image']:.3f} ms/image "
        f"(library built in {rec['host_annotator_build_s']:.2f} s); connected components "
        f"{rec['host_components_library_ms_per_image']:.4f} ms/image in the C++ library, "
        f"{rec['host_components_numpy_ms_per_image']:.3f} in its numpy twin (equal stats)")
    for i, bbox in enumerate(host):
        want = None if bbox is None else [bbox[0], bbox[1], bbox[0] + bbox[2],
                                          bbox[1] + bbox[3]]
        got = boxes[i, 0].tolist() if valid[i, 0] else None
        if got != want:
            raise AssertionError(f"detector: image {i} slot 0 {got} != host {want}")
    rec["annotated"] = int(valid[:, 0].sum())
    log(f"detector: annotation {rec['annotate_ms_per_image']:.3f} ms/image (first call "
        f"{rec['annotate_first_call_ms_per_image']:.3f}); slot 0 of all {k} images equals the "
        f"host auto_annotate of to8b (boxes in {rec['annotated']}); "
        f"{int(valid.sum())} components in all")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state0 = trainer.init_detector(torch.Generator().manual_seed(0), dc, device=DEVICE)
    idx = trainer.cycle_indices(k, dc.max_iter, dc.images_per_batch,
                                torch.Generator().manual_seed(1), device=DEVICE)
    data = DetBatch(*train)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (state, metrics), step_ms = timed_steps(lambda: trainer.inner_train(state0, (data, idx), dc))
    rec["train_s"] = time.perf_counter() - t0
    rec["train_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["train_step_ms"] = step_ms
    rec["train_s_per_step_median_2_on"] = statistics.median(step_ms[1:]) / 1e3
    losses = metrics["loss"].cpu()
    rec["losses"] = losses.tolist()
    log(f"detector: inner train {dc.max_iter} steps in {rec['train_s']:.3f} s; step median "
        f"(steps 2-{dc.max_iter}) {rec['train_s_per_step_median_2_on']:.5f} s, first "
        f"{step_ms[0] / 1e3:.4f} s; peak memory {rec['train_peak_gb']:.2f} GB; losses "
        f"{[round(x, 4) for x in rec['losses'][:3]]} ... {rec['losses'][-1]:.4f}")
    if not torch.isfinite(losses).all():
        raise AssertionError("detector: a training loss is not finite")
    if any(counts().values()):
        raise AssertionError(f"detector: a render kernel launched in training: {counts()}")
    # where a step's time goes: PROFILE_STEPS more steps from the trained
    # state under the profiler (not part of the main path's run)
    rec["train_profile"] = profile_steps(
        lambda: trainer.inner_train(state, (data, idx[:PROFILE_STEPS]), dc), PROFILE_STEPS)
    log(f"detector: train steps under the profiler: {json.dumps(rec['train_profile'])}")

    # the same first steps on the CPU, from the same weights and indices
    cpu = lambda t: t.detach().cpu()                                 # noqa: E731
    state_cpu = trainer.DetectorState(
        {n: cpu(v) for n, v in state0.params.items()},
        {"trace": {n: cpu(v) for n, v in state0.opt_state["trace"].items()},
         "count": cpu(state0.opt_state["count"])}, cpu(state0.step))
    t0 = time.perf_counter()
    _, metrics_cpu = trainer.inner_train(state_cpu, (DetBatch(*map(cpu, train)), cpu(idx[:3])),
                                         dc)
    rec["cpu_3_steps_s"] = time.perf_counter() - t0
    rec["loss_vs_cpu"] = detector_rel("first 3 losses (main path, cuDNN's default "
                                      "algorithms)", losses[:3], metrics_cpu["loss"])
    # the same 3 steps on the card under deterministic algorithms (conv
    # backward without atomics), timed: what determinism costs
    torch.backends.cudnn.deterministic = True
    try:
        torch.cuda.synchronize()
        (_, metrics_det), det_ms = timed_steps(
            lambda: trainer.inner_train(state0, (data, idx[:3]), dc))
    finally:
        torch.backends.cudnn.deterministic = False
    rec["deterministic_step_ms"] = det_ms
    rec["loss_vs_cpu_deterministic"] = detector_rel(
        "first 3 losses (cudnn.deterministic)", metrics_det["loss"], metrics_cpu["loss"])
    log(f"detector: steps 2-3 under cudnn.deterministic {det_ms[1]:.3f}, {det_ms[2]:.3f} ms; "
        f"under the default algorithms {step_ms[1]:.3f}, {step_ms[2]:.3f} ms")

    # the trained weights on 8 val images, card and CPU
    _, apply_fn = trainer.make_detector_apply(dc)
    with torch.no_grad():
        logits, deltas = apply_fn(state.params, val[0][:8])
        params_cpu = {n: cpu(v) for n, v in state.params.items()}
        logits_cpu, deltas_cpu = apply_fn(params_cpu, cpu(val[0][:8]))
    rec["logits_vs_cpu"] = detector_rel("trained logits, 8 val images", logits, logits_cpu)
    rec["deltas_vs_cpu"] = detector_rel("trained deltas, 8 val images", deltas, deltas_cpu)

    # COCO mAP over the val set, in batches of images_per_batch
    anchors = retinanet.generate_anchors(dc.image_size, DEVICE)
    vb = dc.images_per_batch
    seconds = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            dets = [evaluator.detections_to_eval(retinanet.retinanet_inference(
                apply_fn, state.params, val[0][i:i + vb], anchors, dc))
                for i in range(0, VAL_IMAGES, vb)]
        seconds.append(time.perf_counter() - t0)
    dets = [d for batch in dets for d in batch]
    rec["eval_images_per_s"] = VAL_IMAGES / seconds[1]
    rec["eval_first_call_images_per_s"] = VAL_IMAGES / seconds[0]
    gt_boxes, gt_valid = val[1].cpu().numpy(), val[3].cpu().numpy()
    truth = [{"boxes": b[v], "labels": np.full(int(v.sum()), label)}
             for b, v in zip(gt_boxes, gt_valid)]
    result = evaluator.coco_map(dets, truth)
    # NaN (an area range without ground truth) prints as null
    rec["map"] = json.loads(json.dumps(result).replace("NaN", "null"))
    rec["detections"] = sum(len(d["scores"]) for d in dets)
    log(f"detector: eval {rec['eval_images_per_s']:.1f} images/s (first call "
        f"{rec['eval_first_call_images_per_s']:.1f}); {rec['detections']} detections on "
        f"{VAL_IMAGES} val images; mAP {json.dumps(result)}")
    check_map("detector", result, [t["boxes"] for t in truth])
    log("detector: " + json.dumps({k: v for k, v in rec.items()
                                   if k not in ("train_step_ms", "losses",
                                                "deterministic_step_ms")}))
    return rec


# --------------------------------------------------------------------------- #
# phase 10: the bilevel outer loop
# --------------------------------------------------------------------------- #


def flat_tree(tree) -> torch.Tensor:
    """A dict of tensors (or a tensor) as one float64 CPU vector, names in
    sorted order."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().double().reshape(-1)
    return torch.cat([tree[k].detach().cpu().double().reshape(-1) for k in sorted(tree)])


def rel_norm(tag, got, want, rel):
    """||got - want|| / ||want|| (flattened, want on the CPU or the
    reference run); raises above rel or when either is not finite."""
    g, w = flat_tree(got), flat_tree(want)
    if not (torch.isfinite(g).all() and torch.isfinite(w).all()):
        raise AssertionError(f"bilevel [{tag}]: not finite")
    err = float((g - w).norm() / w.norm())
    log(f"bilevel [{tag}]: {err:.3e} of the norm (limit {rel:g})")
    if not err <= rel:
        raise AssertionError(f"bilevel [{tag}]: {err:.3e} > {rel:g}")
    return err


def bilevel_config(basedir: str) -> NeuralSimConfig:
    """Phase 10's configuration: the defaults (100x100 camera, K = 50,
    RetinaNet-R50-FPN at 128^2, 50 inner steps at batch 8, influence +
    onestep, strips at 5000 px in bf16) with the production f32 forward
    render, the experiment under basedir."""
    cfg = NeuralSimConfig()
    return cfg.replace(render=cfg.render.production_mode(),
                       data=dataclasses.replace(cfg.data, basedir=basedir, expname="bilevel"))


def bilevel_small_config() -> NeuralSimConfig:
    """The card-against-CPU check's configuration: K = 2 at 25x25 (the
    100x100 camera scaled), the exact render, RetinaNet-R50-FPN at 32^2,
    2 inner steps at batch 2, float32 gradient."""
    cfg = NeuralSimConfig()
    s = BILEVEL_SMALL_SIDE / cfg.camera.height
    cam = dataclasses.replace(cfg.camera, height=BILEVEL_SMALL_SIDE, width=BILEVEL_SMALL_SIDE,
                              fx=cfg.camera.fx * s, fy=cfg.camera.fy * s,
                              cx=cfg.camera.cx * s, cy=cfg.camera.cy * s)
    return cfg.replace(
        camera=cam,
        sampler=dataclasses.replace(cfg.sampler, n_samples_k=BILEVEL_SMALL_K),
        detector=dataclasses.replace(cfg.detector, image_size=32, max_iter=2,
                                     images_per_batch=2, warmup_iters=1),
        bilevel=dataclasses.replace(cfg.bilevel, grad_compute_dtype="float32"),
        data=dataclasses.replace(cfg.data, save_pngs=False))


def cli_argv(tar: str, basedir: str, path_info: str):
    """Phase 10's command line: the box scene from tar, production
    render, K = CLI_K, one epoch, the val and background trees of
    path_info, on the card."""
    return ["--ft_path", tar, "--basedir", basedir, "--expname", "cli", "--production_render",
            "--n_samples_K", str(CLI_K), "--n_epochs", "1", "--train_val_path_info", path_info,
            "--device", str(DEVICE)]


def write_cli_tree(tmp):
    """The reference's directory layout for the CLI (configs/
    ycb_synthetic_train_val_path_info.json): per class a train directory
    (the background classes' images) and a directory of the val
    distribution "one_1", CLI_TREE_IMAGES PNGs of CLI_TREE_HW^2 each (one
    box of a random colour on black), written by write_png; returns the
    path-info JSON's path."""
    rng = np.random.RandomState(0)
    info = {"dataset_name": "chip_smoke", "train_info": {}, "test_info": {"one_1": {}}}
    for cate in CLI_CLASSES:
        for kind, where in (("train", info["train_info"]), ("val", info["test_info"]["one_1"])):
            d = os.path.join(tmp, "cli_tree", kind, cate)
            os.makedirs(d)
            for i in range(CLI_TREE_IMAGES):
                img = np.zeros((CLI_TREE_HW, CLI_TREE_HW, 3), np.uint8)
                y, x = rng.randint(CLI_TREE_HW // 20, CLI_TREE_HW // 2, 2)
                h, w = rng.randint(CLI_TREE_HW // 5, CLI_TREE_HW // 2, 2)
                img[y:y + h, x:x + w] = rng.randint(80, 256, 3)
                write_png(os.path.join(d, f"{i:06d}.png"), img)
            where[cate] = d
    path = os.path.join(tmp, "cli_tree", "path_info.json")
    with open(path, "w") as f:
        json.dump(info, f)
    return path


def instrument(drv):
    """Record, on drv: each epoch's draws, arguments, record, host-clock
    seconds and stage seconds; each stage's kernel launches and peak
    memory (the counters and the allocator's peak read around every
    phase_timer); the cull guard's launches; the outputs of the render,
    _val_grad, _ihvp, _grad_e and _unrolled."""
    log_ = {"draws": [], "epochs": [], "stage_launches": [], "stage_peak_gb": {},
            "guard_launches": {}, "out": {}}
    timer, draw_epoch, run_epoch, guard = (drv._timer, drv.draw_epoch, drv.run_epoch,
                                           drv._first_epoch_cull_guard)

    @contextlib.contextmanager
    def counted_timer(name):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = counts()
        with timer(name):
            yield
        after = counts()
        launched = log_["stage_launches"][-1].setdefault(name, {k: 0 for k in after})
        for k in after:
            launched[k] += after[k] - before[k]
        peak = torch.cuda.max_memory_allocated() / 1e9
        log_["stage_peak_gb"][name] = max(log_["stage_peak_gb"].get(name, 0.0), peak)

    def counted_draws():
        draws = draw_epoch()
        log_["draws"].append(draws)
        return draws

    def timed_epoch(epoch, psi, psi_opt, det_state, **kw):
        log_["stage_launches"].append({})
        totals = dict(drv.phases.totals)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        record = run_epoch(epoch, psi, psi_opt, det_state, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        stages = {k: v - totals.get(k, 0.0) for k, v in drv.phases.totals.items()
                  if v != totals.get(k, 0.0)}
        log_["epochs"].append({"epoch": epoch, "args": (psi, psi_opt, det_state),
                               "record": record, "seconds": seconds, "stage_s": stages,
                               "out": dict(log_["out"])})
        return record

    def counted_guard(*args):
        before = counts()
        guard(*args)
        log_["guard_launches"] = {k: v - before[k] for k, v in counts().items()}

    drv._timer, drv.draw_epoch, drv.run_epoch = counted_timer, counted_draws, timed_epoch
    drv._first_epoch_cull_guard = counted_guard
    keep_outputs(drv, log_["out"])
    return log_


def keep_outputs(drv, store):
    """Keep the last output of drv's stages _render, _val_grad, _ihvp,
    _grad_e and _unrolled in store."""
    def keep(name, fn):
        def wrapped(*args):
            store[name] = fn(*args)
            return store[name]
        return wrapped

    for name in ("_render", "_val_grad", "_ihvp", "_grad_e", "_unrolled"):
        setattr(drv, name, keep(name, getattr(drv, name)))


def to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_cpu(v) for v in tree))
    return tree


def val_set(cfg, models, n):
    """n renders at poses from psi_init(VAL_PSI) (a generator of their own)
    through the configuration's renderer, annotated on the device."""
    renderer = NeuralSimRenderer(cfg, models=models, device=DEVICE)
    with torch.no_grad():
        rgb, _ = renderer.render_images(psi_init(VAL_PSI), torch.Generator().manual_seed(9),
                                        num_k=n)
    return driver.ValData(*detector_dataset.build_detector_batches_device(
        rgb, [1] * n, cfg.detector))


def phase_bilevel(box, smi):
    """Phase 10: one outer iteration through BilevelDriver.run, twice (the
    second epoch from the driver's state after the first, checkpointed),
    then its checks: card against CPU at a reduced size, resume from the
    epoch-0 checkpoint, one unrolled epoch, the cg_normal and auto-scaled
    LiSSA solvers, and the CLI."""
    models = {"coarse": box, "fine": box}
    rec = {"card": smi}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = bilevel_config(tmp)
        dc, bc = cfg.detector, cfg.bilevel
        val = val_set(cfg, models, VAL_IMAGES)
        drv = driver.BilevelDriver(cfg, models, val, generator=torch.Generator().manual_seed(0),
                                   object_class=1, output_dir=os.path.join(tmp, "out"),
                                   device=DEVICE)
        budget = drv.rc_test.hit_budget
        rec["config"] = (
            f"K={cfg.sampler.n_samples_k} {cfg.camera.height}x{cfg.camera.width}, "
            f"{cfg.net.netdepth}x{cfg.net.netwidth} box-scene pair, production f32 render "
            f"(hit_budget {budget}), RetinaNet-R50-FPN {dc.num_classes} classes "
            f"{dc.image_size}^2, {dc.max_iter} inner steps at batch {dc.images_per_batch}, "
            f"{VAL_IMAGES} val renders, {bc.hypergrad_mode} + {bc.ihvp_solver}, "
            f"{bc.grad_mode} {bc.grad_ray_chunk} px in {bc.grad_compute_dtype}, "
            f"grad_e_max_images {bc.grad_e_max_images}, float32 (TF32 off, cuDNN's "
            "default algorithms)")
        log(f"bilevel: {rec['config']}")
        if not budget < 1.0:
            raise AssertionError(f"bilevel: calibrated budget {budget}: the production "
                                 "render would be the exact one")
        seen = instrument(drv)
        ckdir = os.path.join(tmp, "ck")
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        result = drv.run(n_epochs=2, checkpoint_dir=ckdir)
        torch.cuda.synchronize()
        rec["run_s"] = time.perf_counter() - t0
        rec["launches"] = counts()
        epochs = seen["epochs"]
        rec["epoch_s"] = [e["seconds"] for e in epochs]
        rec["stage_s"] = [e["stage_s"] for e in epochs]
        rec["stage_peak_gb"] = seen["stage_peak_gb"]
        rec["stage_launches"] = seen["stage_launches"]
        rec["guard_launches"] = seen["guard_launches"]
        rec["cull_guard_psnr"] = drv.last_cull_psnr
        log(f"bilevel: 2 epochs in {rec['run_s']:.3f} s (host clock), per epoch "
            f"{[round(x, 3) for x in rec['epoch_s']]} s; launches {rec['launches']}")
        for i, e in enumerate(epochs):
            log(f"bilevel: epoch {i} stages (s): "
                + ", ".join(f"{k} {v:.4f}" for k, v in e["stage_s"].items()))
        log(f"bilevel: peak GB per stage: "
            + ", ".join(f"{k} {v:.2f}" for k, v in seen["stage_peak_gb"].items()))
        log(f"bilevel: launches per stage {json.dumps(seen['stage_launches'])}; cull guard "
            f"{seen['guard_launches']} ({drv.last_cull_psnr:.2f} dB)")
        if [h["epoch"] for h in result["history"]] != [0, 1]:
            raise AssertionError(f"bilevel: history {result['history']}")
        for i, st in enumerate(seen["stage_launches"]):
            if not st["render"]["fused_nerf_march"] > 0:
                raise AssertionError(f"bilevel: epoch {i}'s render launched no kernel")
            for stage in ("build_dataset", "inner_train", "inference", "inverse_hvp", "grad_E",
                          "render_grad"):
                if any(st[stage].values()):
                    raise AssertionError(f"bilevel: epoch {i} stage {stage} launched "
                                         f"{st[stage]}")
        if not seen["guard_launches"]["fused_nerf_march"] > 0:
            raise AssertionError("bilevel: the first epoch's cull guard launched no kernel")
        psi0 = epochs[0]["args"][0].detach().cpu()
        for i, e in enumerate(epochs):
            r = e["record"]
            g = r["grad_psi"]
            if not (np.isfinite(g).all() and np.abs(g).max() > 0):
                raise AssertionError(f"bilevel: epoch {i} grad_psi {g}")
            if not abs(float(r["psi_probs"].sum()) - 1.0) < 1e-5:
                raise AssertionError(f"bilevel: epoch {i} probabilities sum to "
                                     f"{r['psi_probs'].sum()}")
            check_map(f"bilevel epoch {i}", r["map"],
                      [b[v] for b, v in zip(val.gt_boxes.cpu().numpy(),
                                            val.gt_valid.cpu().numpy())])
        psi = result["psi"].detach().cpu()
        if torch.equal(psi, psi0):
            raise AssertionError("bilevel: psi did not move")
        with open(drv.log.txt_path) as f:
            lines = f.read().splitlines()
        # (a psi tensor's repr may wrap onto a second line, as the reference's)
        heads = [ln[:9] for ln in lines if ln.startswith("epoch: ")]
        if heads != ["epoch: 0{", "epoch: 0t", "epoch: 1{", "epoch: 1t"]:
            raise AssertionError(f"bilevel: save_result.txt holds {lines}")
        rec.update(grad_psi=[e["record"]["grad_psi"].tolist() for e in epochs],
                   inner_loss=[e["record"]["inner_loss"] for e in epochs],
                   psi_probs=[e["record"]["psi_probs"].tolist() for e in epochs],
                   map=[json.loads(json.dumps(e["record"]["map"]).replace("NaN", "null"))
                        for e in epochs],
                   log_lines=lines)
        log(f"bilevel: grad_psi {rec['grad_psi']}; psi {psi.tolist()}; mAP "
            f"{[m['AP'] for m in rec['map']]}; {len(lines)} save_result lines")

        rec["resume"] = bilevel_resume(cfg, models, val, ckdir, tmp, epochs[1], seen)
        rec["card_vs_cpu"] = bilevel_card_vs_cpu(models)
        rec["unrolled"] = bilevel_unrolled(cfg, models, val, tmp, epochs[0], seen)
        rec["solvers"] = bilevel_solvers(drv, val, result["detector_state"])
        rec["cli"] = bilevel_cli(models, tmp)
    log("bilevel: " + json.dumps({k: v for k, v in rec.items()
                                  if k not in ("log_lines", "psi_probs", "map",
                                               "stage_launches")}))
    return rec


def bilevel_resume(cfg, models, val, ckdir, tmp, epoch1, seen):
    """Epoch 1 again, under cudnn.deterministic, twice: in a new driver
    (another generator) resumed from the epoch-0 checkpoint, and in
    memory from the uninterrupted run's state after epoch 0 with its
    epoch-1 draws. The restored state and the draws equal the
    uninterrupted run's to the bit, so do the renders; the resumed epoch's
    loss, grad_psi and psi step lie within RESUME_REL of the in-memory
    one's. The uninterrupted epoch 1 itself (cuDNN's default algorithms)
    is reported beside them."""
    resume_dir = os.path.join(tmp, "ck0")
    os.makedirs(resume_dir)
    shutil.copy(os.path.join(ckdir, "ckpt_00000000.pt"), resume_dir)
    drv = driver.BilevelDriver(cfg, models, val, generator=torch.Generator().manual_seed(123),
                               object_class=1, output_dir=os.path.join(tmp, "out_resume"),
                               device=DEVICE)
    mine = instrument(drv)
    ref_drv = driver.BilevelDriver(cfg, models, val, object_class=1,
                                   output_dir=os.path.join(tmp, "out_ref"), device=DEVICE)
    ref_out = {}
    keep_outputs(ref_drv, ref_out)
    ref_psi, ref_opt, ref_det = epoch1["args"]
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        out = drv.run(n_epochs=2, checkpoint_dir=resume_dir)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        ref = ref_drv.run_epoch(1, ref_psi, ref_opt, ref_det, save_pngs=False,
                                draws=seen["draws"][1])
    finally:
        torch.backends.cudnn.deterministic = False
    if [h["epoch"] for h in out["history"]] != [1]:
        raise AssertionError(f"bilevel resume: ran epochs {out['history']}")
    # the restored state and the epoch's draws are the uninterrupted run's,
    # to the bit; so are the renders, made before any cuDNN call
    psi, _, det = mine["epochs"][0]["args"]
    a, b = mine["draws"][0], seen["draws"][1]
    exact = [torch.equal(psi, ref_psi), torch.equal(det.step, ref_det.step)]
    exact += [torch.equal(det.params[k], ref_det.params[k]) for k in ref_det.params]
    exact += [torch.equal(det.opt_state["trace"][k], ref_det.opt_state["trace"][k])
              for k in ref_det.opt_state["trace"]]
    exact += [torch.equal(x.cpu(), y.cpu()) for x, y in
              zip((*a.noise, a.batch_idx, a.hvp_idx), (*b.noise, b.batch_idx, b.hvp_idx))]
    if not all(exact):
        raise AssertionError("bilevel resume: the restored state or the epoch's draws differ")
    got = mine["epochs"][0]["record"]
    # the cost of deterministic cuDNN algorithms on the outer iteration: this
    # epoch 1 against the uninterrupted epoch 1 (default algorithms)
    res = {"seconds": seconds, "deterministic_epoch_s": mine["epochs"][0]["seconds"],
           "deterministic_stage_s": mine["epochs"][0]["stage_s"],
           "default_epoch_s": epoch1["seconds"], "default_stage_s": epoch1["stage_s"]}
    log(f"bilevel resume: epoch 1 under deterministic cuDNN {res['deterministic_epoch_s']:.3f} "
        f"s, under the default algorithms {res['default_epoch_s']:.3f} s; stages (s) "
        + ", ".join(f"{k} {v:.4f} / {epoch1['stage_s'].get(k, float('nan')):.4f}"
                    for k, v in res["deterministic_stage_s"].items()))
    res["renders_max_abs"] = max(
        float((mine["out"]["_render"][0] - epoch1["out"]["_render"][0]).abs().max()),
        float((ref_out["_render"][0] - epoch1["out"]["_render"][0]).abs().max()))
    log(f"bilevel resume: state and draws bit-equal; renders max |diff| "
        f"{res['renders_max_abs']:.3e}")
    if not res["renders_max_abs"] == 0.0:
        raise AssertionError("bilevel resume: the epoch's renders differ")
    res["inner_loss_rel"] = abs(got["inner_loss"] - ref["inner_loss"]) / abs(ref["inner_loss"])
    log(f"bilevel resume: last inner loss {got['inner_loss']:.7f} vs {ref['inner_loss']:.7f} "
        f"in memory (cuDNN's default algorithms: {epoch1['record']['inner_loss']:.7f})")
    if not res["inner_loss_rel"] <= RESUME_REL:
        raise AssertionError(f"bilevel resume: inner loss {res['inner_loss_rel']:.3e}")
    res["grad_psi_rel"] = rel_norm("resume grad_psi", torch.from_numpy(got["grad_psi"]),
                                   torch.from_numpy(ref["grad_psi"]), RESUME_REL)
    res["psi_rel"] = rel_norm("resume psi step", got["psi"] - ref_psi, ref["psi"] - ref_psi,
                              RESUME_REL)
    # reported: how far cuDNN's default algorithms move the epoch
    default = epoch1["record"]
    g, w = torch.from_numpy(default["grad_psi"]).double(), torch.from_numpy(ref["grad_psi"])
    res["default_vs_deterministic"] = {
        "inner_loss_rel": abs(default["inner_loss"] - ref["inner_loss"]) / abs(ref["inner_loss"]),
        "grad_E_rel": float((flat_tree(epoch1["out"]["_grad_e"]) - flat_tree(ref_out["_grad_e"]))
                            .norm() / flat_tree(ref_out["_grad_e"]).norm()),
        "grad_psi_rel": float((g - w.double()).norm() / w.double().norm()),
        "grad_psi_cosine": float(g @ w.double() / (g.norm() * w.double().norm()))}
    log(f"bilevel resume: the uninterrupted epoch 1 (default algorithms) against the "
        f"deterministic one: {json.dumps(res['default_vs_deterministic'])}")
    return res


def bilevel_card_vs_cpu(models):
    """One epoch at bilevel_small_config() on the card and on the CPU from
    the same weights, state and draws, under cudnn.deterministic: v, the
    inverse HVP, grad_E and grad_psi within BILEVEL_REL of the norm."""
    cfg = bilevel_small_config()
    cpu = torch.device("cpu")
    val = val_set(cfg, models, 4)
    out = {}
    runs = {}
    torch.backends.cudnn.deterministic = True
    try:
        det0 = trainer.init_detector(torch.Generator().manual_seed(0), cfg.detector,
                                     device=cpu)
        for where, dev in (("card", DEVICE), ("cpu", cpu)):
            drv = driver.BilevelDriver(cfg, models, driver.ValData(*(x.to(dev) for x in val)),
                                       generator=torch.Generator().manual_seed(0),
                                       object_class=1, output_dir=tempfile.mkdtemp(),
                                       device=dev)
            outputs = {}
            keep_outputs(drv, outputs)
            draws = runs["card"]["draws"] if where == "cpu" else drv.draw_epoch()
            state = trainer.DetectorState(
                {k: v.to(dev) for k, v in det0.params.items()},
                {"trace": {k: v.to(dev) for k, v in det0.opt_state["trace"].items()},
                 "count": det0.opt_state["count"].to(dev)}, det0.step.to(dev))
            t0 = time.perf_counter()
            record = drv.run_epoch(0, psi_init("5"), psi_optimizer_init("momentum", 5e-5),
                                   state, draws=draws)
            runs[where] = {"draws": to_cpu(draws), "record": record, "out": outputs,
                         "seconds": time.perf_counter() - t0}
    finally:
        torch.backends.cudnn.deterministic = False
    card, host = runs["card"], runs["cpu"]
    out["epoch_s"] = {"card": card["seconds"], "cpu": host["seconds"]}
    out["v"] = rel_norm("card vs CPU: v = dL_val/dtheta", card["out"]["_val_grad"],
                        host["out"]["_val_grad"], BILEVEL_REL)
    out["ihvp"] = rel_norm("card vs CPU: inverse HVP", card["out"]["_ihvp"],
                           host["out"]["_ihvp"], BILEVEL_REL)
    out["grad_E"] = rel_norm("card vs CPU: grad_E", card["out"]["_grad_e"],
                             host["out"]["_grad_e"], BILEVEL_REL)
    out["grad_psi"] = rel_norm("card vs CPU: grad_psi",
                               torch.from_numpy(card["record"]["grad_psi"]),
                               torch.from_numpy(host["record"]["grad_psi"]), BILEVEL_REL)
    return out


def bilevel_unrolled(cfg, models, val, tmp, epoch0, seen):
    """One unrolled epoch at full width from phase 10's epoch-0 state and
    draws: seconds, peak memory, and the cosine of its grad_E with the
    influence grad_E (reported, not checked)."""
    ucfg = cfg.replace(bilevel=dataclasses.replace(cfg.bilevel, hypergrad_mode="unrolled"))
    drv = driver.BilevelDriver(ucfg, models, val, object_class=1,
                               output_dir=os.path.join(tmp, "out_unrolled"), device=DEVICE)
    mine = instrument(drv)
    psi, psi_opt, det = epoch0["args"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    record = drv.run_epoch(0, psi, psi_opt, det, save_pngs=False, draws=seen["draws"][0])
    torch.cuda.synchronize()
    res = {"epoch_s": time.perf_counter() - t0,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "stage_s": mine["epochs"][0]["stage_s"],
           "stage_peak_gb": mine["stage_peak_gb"],
           "stage_launches": mine["stage_launches"][0]}
    g = record["grad_psi"]
    if not np.isfinite(g).all():
        raise AssertionError(f"bilevel unrolled: grad_psi {g}")
    if any(res["stage_launches"]["unrolled_grad_E"].values()):
        raise AssertionError(f"bilevel unrolled: launches {res['stage_launches']}")
    unrolled = flat_tree(mine["out"]["_unrolled"][:cfg.bilevel.grad_e_max_images])
    influence = flat_tree(cfg.bilevel.influence_sign * epoch0["out"]["_grad_e"])
    res["grad_E_cosine_vs_influence"] = float(unrolled @ influence
                                              / (unrolled.norm() * influence.norm()))
    res["grad_psi"] = g.tolist()
    log(f"bilevel unrolled: epoch {res['epoch_s']:.3f} s, peak {res['peak_gb']:.2f} GB "
        f"(its grad_E stage {res['stage_peak_gb']['unrolled_grad_E']:.2f}), "
        f"grad_E cosine vs influence {res['grad_E_cosine_vs_influence']:.4f}; stages "
        + ", ".join(f"{k} {v:.3f}" for k, v in res["stage_s"].items()))
    return res


def bilevel_solvers(drv, val, det_state):
    """cg_normal and the auto-scaled LiSSA on the trained state, v the
    driver's val gradient, the HVP batch the first images_per_batch val
    images: HVPs counted, ms per HVP (host clock), a finite result; one HVP
    on the card, on the CPU and on the card in float64 (cudnn.deterministic),
    the float32 ones within HVP_REL of each other and of the float64 one."""
    bc, dc = drv.cfg.bilevel, drv.cfg.detector
    trainable, frozen = trainer.split_trainable(det_state.params, dc)
    batch = DetBatch(*(x[:dc.images_per_batch] for x in val))
    v = drv._val_grad(det_state.params)

    def loss_fn(tp, b):
        return drv._det_loss_trainable(tp, frozen, b)

    calls = [0]
    hvp = influence.hvp

    def counted(*args):
        calls[0] += 1
        return hvp(*args)

    res = {}
    influence.hvp = counted
    try:
        for method, kw in (("cg_normal", {}), ("lissa", {"lissa_scale": -1.0})):
            calls[0] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x = influence.inverse_hvp(loss_fn, trainable, batch, v, method=method,
                                      damping=bc.ihvp_damping, cg_iters=bc.cg_iters,
                                      lissa_iters=bc.lissa_iters, **kw)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            norm = float(flat_tree(x).norm())
            if not math.isfinite(norm):
                raise AssertionError(f"bilevel solvers: {method} is not finite")
            res[method] = {"hvps": calls[0], "seconds": seconds,
                           "ms_per_hvp": 1e3 * seconds / calls[0], "norm": norm}
            log(f"bilevel solvers: {method} {calls[0]} HVPs in {seconds:.3f} s = "
                f"{res[method]['ms_per_hvp']:.2f} ms/HVP, |x| {norm:.4e}")
    finally:
        influence.hvp = hvp
    def hvp_on(device, dtype):
        """The same HVP with every tensor on device in dtype."""
        def cast(t):
            return {k: x.detach().to(device=device, dtype=dtype) for k, x in t.items()}

        frozen_c, anchors = cast(frozen), drv.anchors_cat.to(device=device, dtype=dtype)
        batch_c = DetBatch(*(x.to(device=device, dtype=dtype) if x.is_floating_point()
                             else x.to(device) for x in batch))
        return influence.hvp(
            lambda tp, b: retinanet.retinanet_loss(
                drv.det_apply, trainer.merge_params(tp, frozen_c), b, anchors, dc)[0],
            cast(trainable), batch_c, cast(v))

    torch.backends.cudnn.deterministic = True
    try:
        hv = influence.hvp(loss_fn, trainable, batch, v)
        hv_cpu = hvp_on(torch.device("cpu"), torch.float32)
        hv64 = hvp_on(DEVICE, torch.float64)
    finally:
        torch.backends.cudnn.deterministic = False
    res["hvp_vs_cpu"] = rel_norm("solvers: one HVP, card vs CPU", hv, hv_cpu, HVP_REL)
    res["hvp_vs_float64"] = rel_norm("solvers: one HVP, card vs the card's float64", hv, hv64,
                                     HVP_REL)
    res["cpu_hvp_vs_float64"] = rel_norm("solvers: one HVP, CPU vs the card's float64", hv_cpu,
                                         hv64, HVP_REL)
    return res


def cli_run(argv):
    """cli.main(argv) on the card with both TF32 switches turned on before
    it (the CLI must turn them off): (result, the epoch's record, seconds,
    launches)."""
    records = []
    run_epoch = driver.BilevelDriver.run_epoch

    def recorded(self, *args, **kwargs):
        records.append(run_epoch(self, *args, **kwargs))
        return records[-1]

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    driver.BilevelDriver.run_epoch = recorded
    torch.cuda.synchronize()
    zero_counts()
    try:
        t0 = time.perf_counter()
        result = cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        driver.BilevelDriver.run_epoch = run_epoch
    policy = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
              torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    if policy != (False, False, True, False):
        raise AssertionError(f"bilevel cli: after cli.main TF32 matmul / cuDNN, cuDNN "
                             f"deterministic / benchmark are {policy}, not the card policy")
    if len(result["history"]) != 1 or len(records) != 1 or not torch.isfinite(
            result["psi"]).all():
        raise AssertionError(f"bilevel cli: {result['history']}")
    return result, records[0], seconds, counts()


def bilevel_cli(models, tmp):
    """python -m neuralsim_tpu_torch.cli's main on the card: the box scene
    from a reference .tar (save_nerf_tar_compatible), production render,
    K = CLI_K, one epoch, the val and background classes read from PNG
    trees (utils/png.py: no imageio); PNGs written; fused_nerf_march
    launched; TF32 off after it. Twice from one seed: psi and grad_psi
    must be equal to the bit."""
    tar = os.path.join(tmp, "box.tar")
    save_nerf_tar_compatible(tar, models)
    path_info = write_cli_tree(tmp)
    runs = []
    for run in range(2):
        basedir = os.path.join(tmp, f"cli{run}")
        result, record, seconds, launches = cli_run(cli_argv(tar, basedir, path_info))
        runs.append((result, record))
        if run == 0:
            res = {"seconds": seconds, "launches": launches, "policy_after": "tf32 off, "
                   "cudnn deterministic, benchmark off"}
            if not launches["fused_nerf_march"] > 0:
                raise AssertionError("bilevel cli: the render launched no kernel")
            with open(os.path.join(basedir, "cli", "detectron_output",
                                   "save_result.txt")) as f:
                lines = [ln for ln in f.read().splitlines() if ln.startswith("epoch: ")]
            pngs = os.path.join(basedir, "cli", "renderonly_path", "2")
            res["pngs"] = (len(os.listdir(pngs)) - 1
                           + len(os.listdir(os.path.join(pngs, "withgrad"))))
            if len(lines) != 2 or res["pngs"] != 2 * CLI_K:
                raise AssertionError(f"bilevel cli: {len(lines)} log lines, {res['pngs']} PNGs")
        else:
            res["second_run_seconds"] = seconds
    n_val = len(CLI_CLASSES) * CLI_TREE_IMAGES
    res["val_images"], res["background_images"] = n_val, n_val - CLI_TREE_IMAGES
    (r0, e0), (r1, e1) = runs
    res["repeat"] = {
        "psi_max_abs": float((r0["psi"] - r1["psi"]).abs().max()),
        "grad_psi_max_abs": float(np.abs(e0["grad_psi"] - e1["grad_psi"]).max()),
        "grad_psi_rel": float(np.linalg.norm(e0["grad_psi"] - e1["grad_psi"])
                              / np.linalg.norm(e0["grad_psi"])),
        "inner_loss": [e0["inner_loss"], e1["inner_loss"]]}
    res["repeat"]["equal"] = (torch.equal(r0["psi"], r1["psi"])
                              and np.array_equal(e0["grad_psi"], e1["grad_psi"]))
    log(f"bilevel cli: one epoch at K={CLI_K} in {res['seconds']:.3f} s (construction "
        f"included; again {res['second_run_seconds']:.3f} s), launches {res['launches']}, "
        f"{res['pngs']} PNGs, {n_val} val and {res['background_images']} background PNGs "
        f"read; two runs from one seed: {json.dumps(res['repeat'])}")
    if not res["repeat"]["equal"]:
        raise AssertionError("bilevel cli: two runs from one seed differ (psi or grad_psi); "
                             "torch.use_deterministic_algorithms(True, warn_only=True) "
                             "around cli.main names the ops without a deterministic form")
    return res


# --------------------------------------------------------------------------- #
# phase 11: the NeRF trainer
# --------------------------------------------------------------------------- #


def write_box_dataset(box, datadir):
    """The box scene's renders as a LINEMOD-layout directory: TRAIN_VIEWS
    (train, val, test) views at TRAIN_HW^2 with bench.py's camera, from
    poses around the box at radius 1.01 (azimuths spread, elevations -20 and
    -45 alternating, the test and val views interleaved with the train
    ones), RGBA PNGs written by write_png (alpha = acc),
    transforms_{split}.json with absolute file_path, transform_matrix,
    intrinsic_matrix and the object's near / far (distance -/+ its
    half-diagonal and 0.05). Rendered in bfloat16 (the exact render, test
    mode). Returns (seconds, the camera distance)."""
    t0 = time.perf_counter()
    n = sum(TRAIN_VIEWS)
    theta = torch.linspace(-180.0, 180.0, n + 1)[:-1] + 7.0
    phi = torch.where(torch.arange(n) % 2 == 0, -20.0, -45.0)
    poses = pose_spherical(theta, phi, 1.01)
    net = NeRFNetConfig()
    rc = dataclasses.replace(NeuralSimConfig().render, near=0.5, far=1.5,
                             compute_dtype="bfloat16").test_mode()
    frames = []
    with torch.no_grad():
        for i in range(0, n, 4):
            out = render_poses({"coarse": box, "fine": box}, poses[i:i + 4], TRAIN_HW, TRAIN_HW,
                               BENCH_K, net, rc, device=DEVICE)
            frames.append(torch.cat([out["rgb_map"], out["acc_map"][..., None]], -1).cpu())
    frames = torch.cat(frames).clamp(0, 1)
    test = list(range(2, n, n // TRAIN_VIEWS[2]))[:TRAIN_VIEWS[2]]
    val = [i + 3 for i in test][:TRAIN_VIEWS[1]]
    train = [i for i in range(n) if i not in test + val]
    radius = 0.06 * math.sqrt(3.0)
    os.makedirs(datadir, exist_ok=True)
    for split, ids in (("train", train), ("val", val), ("test", test)):
        metas = []
        for i in ids:
            path = os.path.join(datadir, f"{split}_{i:03d}.png")
            write_png(path, (255 * frames[i].numpy()).astype(np.uint8))
            metas.append({"file_path": path, "transform_matrix": poses[i].tolist(),
                          "intrinsic_matrix": BENCH_K})
        with open(os.path.join(datadir, f"transforms_{split}.json"), "w") as f:
            json.dump({"near": 1.01 - radius - 0.05, "far": 1.01 + radius + 0.05,
                       "frames": metas}, f)
    return time.perf_counter() - t0


def train_argv(datadir, basedir):
    """Phase 11's command line: the default net (8x256 coarse and fine, PE
    10 / 4), 64 + 128 samples, perturbed, N_rand TRAIN_RAYS, float32,
    half_res (200^2), TRAIN_ITERS steps (the first TRAIN_PRECROP in the
    central crop) with the .tar and checkpoint at the end, on the card."""
    return ["--datadir", datadir, "--basedir", basedir, "--expname", "nerf", "--n_iters",
            str(TRAIN_ITERS), "--N_rand", str(TRAIN_RAYS), "--precrop_iters",
            str(TRAIN_PRECROP), "--precrop_frac", "0.5", "--i_weights", str(TRAIN_ITERS),
            "--i_video", "0", "--i_testset", "0", "--i_print", str(TRAIN_ITERS // 5),
            "--device", str(DEVICE)]


@contextlib.contextmanager
def trainer_instruments():
    """Record, while inside: each train step's loss, synchronized host-clock
    iteration time and kernel launches (all, and those of its forward);
    each test-set and spiral render's result, seconds and launches."""
    rec = {"loss": [], "iter_s": [], "step_launches": [], "forward_launches": [],
           "testset": [], "spiral": []}
    step, loss_fn = train_nerf.train_step, train_nerf.nerf_loss
    testset, spiral = train_cli.render_testset, train_cli.render_spiral_video
    last = [None]

    def since_step():
        return {k: v - last[0][1][k] for k, v in counts().items()}

    def counted_loss(*args, **kwargs):
        out = loss_fn(*args, **kwargs)
        rec["forward_launches"].append(since_step())
        return out

    def timed_step(*args, **kwargs):
        if last[0] is None:
            torch.cuda.synchronize()
            last[0] = (time.perf_counter(), counts())
        out = step(*args, **kwargs)
        torch.cuda.synchronize()
        now = time.perf_counter()
        rec["iter_s"].append(now - last[0][0])
        rec["step_launches"].append(since_step())
        rec["loss"].append(float(out[1]["loss"]))
        last[0] = (now, counts())
        return out

    def render(name, fn):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            before, t0 = counts(), time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            rec[name].append({"result": out, "seconds": time.perf_counter() - t0,
                              "launches": {k: v - before[k] for k, v in counts().items()}})
            last[0] = None
            return out
        return wrapped

    train_nerf.train_step, train_nerf.nerf_loss = timed_step, counted_loss
    train_cli.render_testset = render("testset", testset)
    train_cli.render_spiral_video = render("spiral", spiral)
    try:
        yield rec
    finally:
        train_nerf.train_step, train_nerf.nerf_loss = step, loss_fn
        train_cli.render_testset, train_cli.render_spiral_video = testset, spiral


def train_card_vs_cpu(ds, net, rc, tc):
    """TRAIN_CPU_STEPS train steps (perturb off, so the render draws
    nothing) from one init on the same ray batches (picked on the card,
    copied to the CPU), on the card and on the CPU: losses within
    TRAIN_REL; after them the march kernel on the updated weights against
    its twin (F32_TOL). Returns the record and the card state."""
    rc0 = dataclasses.replace(rc, perturb=False)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    state = train_nerf.init_train_state(net, rc0, tc, gen, DEVICE)
    images = torch.as_tensor(ds.images, device=DEVICE)
    poses = torch.as_tensor(ds.poses, device=DEVICE)
    cam = ds.camera
    batches = [train_nerf.sample_image_rays(images[i], poses[i], cam.height, cam.width, cam.K,
                                            tc.n_rand, generator=gen)
               for i in ds.i_split[0][:TRAIN_CPU_STEPS]]
    card, cpu = state, to_cpu(state)
    card_loss, cpu_loss = [], []
    t0 = time.perf_counter()
    for batch in batches:
        card, m = train_nerf.train_step(card, *batch, net, rc0, tc)
        card_loss.append(float(m["loss"]))
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for batch in batches:
        cpu, m = train_nerf.train_step(cpu, *(b.cpu() for b in batch), net, rc0, tc)
        cpu_loss.append(float(m["loss"]))
    cpu_s = time.perf_counter() - t0
    rel = [abs(a - b) / abs(b) for a, b in zip(card_loss, cpu_loss)]
    got, want = (torch.cat([flat_tree(p[name]) for name in sorted(p)])
                 for p in (card.params, cpu.params))
    res = {"card_loss": card_loss, "cpu_loss": cpu_loss, "loss_rel": rel,
           "card_s": card_s, "cpu_s": cpu_s,
           "params_rel": float((got - want).norm() / want.norm())}
    log(f"train: {TRAIN_CPU_STEPS} steps card vs CPU (perturb off, the same picks): losses "
        f"{card_loss} / {cpu_loss}, rel {rel} (limit {TRAIN_REL:g}); params after them "
        f"{res['params_rel']:.3e} of the norm (reported); CPU {cpu_s:.1f} s")
    if not max(rel) <= TRAIN_REL:
        raise AssertionError(f"train: card vs CPU losses {rel}")
    # the kernel forward after the steps equals the twin's on the new weights
    ro, rd, _ = batches[0]
    vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    z = stratified_z_vals(ro.shape[0], rc0.n_samples, rc0.near, rc0.far, perturb=False,
                          device=DEVICE)
    res["kernel_vs_twin_after_steps"] = {}
    with torch.no_grad():
        for name, params in card.params.items():
            got = rm.fused_nerf_march(params, ro, rd, vd, z, net, torch.float32)
            want = rm.march_channels_ref(params, ro, rd, vd, z, net, torch.float32)
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            res["kernel_vs_twin_after_steps"][name] = err
            if not err <= F32_TOL:
                raise AssertionError(f"train: after {TRAIN_CPU_STEPS} steps the {name} "
                                     f"kernel is {err:.3e} from its twin")
    log(f"train: the kernel on the updated weights vs its twin: "
        f"{res['kernel_vs_twin_after_steps']} (limit {F32_TOL:g})")
    return res, card, batches


def packing_ms(params, net, reps=5):
    """ms (host clock, synchronized) to prepare one weight set's padded
    float32 weights and chunks (kernels.raymarch._packed_weights) that no
    cache entry holds: what every train step pays twice."""
    lib = rm._library("nerf_march")
    depth = rm._depth(params)
    times = []
    for _ in range(reps):
        fresh = {k: v.clone() for k, v in params.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rm._packed_weights(fresh, net, depth, False, lib, "packing")
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def phase_train_nerf(box, smi):
    """Phase 11: the NeRF trainer. The box scene's renders as a LINEMOD
    directory; train_cli.main trains the default pair from random init
    on the card (the main path: 2 launches of fused_nerf_march per step,
    none in the backward; the loss falls; the test PSNR at the end at least
    PSNR_RISE_DB above that of the init; .tar and checkpoint written; the
    spiral's PNG frames where imageio is missing); render_only
    --render_test from the .tar reproduces the test PSNR; then card vs CPU
    steps, the kernel on the updated weights, the packing share and a
    torch.profiler trace of PROFILE_STEPS steps."""
    import importlib.util

    net = NeRFNetConfig()
    rec = {"card": smi}
    with tempfile.TemporaryDirectory() as tmp:
        datadir, basedir = os.path.join(tmp, "box_linemod"), os.path.join(tmp, "logs")
        rec["dataset_s"] = write_box_dataset(box, datadir)
        argv = train_argv(datadir, basedir)
        cfg = config.parse_cli(argv[:-2])
        ds = load_linemod_data(datadir, cfg.data.half_res, cfg.data.testskip)
        cam = ds.camera
        rc = dataclasses.replace(cfg.render, near=cam.near, far=cam.far)
        tc = cfg.train
        rec["config"] = (
            f"{cfg.net.netdepth}x{cfg.net.netwidth} coarse and fine, PE {cfg.net.multires} / "
            f"{cfg.net.multires_views}, {rc.n_samples} + {rc.n_importance} samples, "
            f"N_rand {tc.n_rand}, {rc.compute_dtype}, perturb {rc.perturb}, lr {tc.lrate} "
            f"decay {tc.lrate_decay}k, {TRAIN_ITERS} steps (precrop {tc.precrop_frac} for "
            f"{tc.precrop_iters}); box-scene LINEMOD directory "
            f"{TRAIN_VIEWS} views at {TRAIN_HW}^2 -> {cam.height}x{cam.width} (half_res), "
            f"near/far {cam.near:.3f}/{cam.far:.3f}")
        log(f"train: {rec['config']}; dataset written in {rec['dataset_s']:.2f} s")
        init = train_nerf.init_train_state(cfg.net, rc, tc, torch.Generator(
            device=DEVICE).manual_seed(cfg.seed), DEVICE)
        rec["init_test_psnr"] = train_cli.render_testset(init.params, ds, cfg.net, rc,
                                                         os.path.join(tmp, "init"), DEVICE)
        del init

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        with trainer_instruments() as seen:
            state = train_cli.main(argv)
        torch.cuda.synchronize()
        rec["main_s"] = time.perf_counter() - t0
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        rec["launches"] = counts()
        steps = len(seen["loss"])
        rec["steps"] = steps
        rec["s_per_iter_median"] = statistics.median(seen["iter_s"][1:])
        rec["s_per_iter_first"] = seen["iter_s"][0]
        rec["train_s"] = sum(seen["iter_s"])
        per_step = {k: sorted({st[k] for st in seen["step_launches"]})
                    for k in seen["step_launches"][0]}
        forward = sorted({st["fused_nerf_march"] for st in seen["forward_launches"]})
        rec["launches_per_step"] = per_step
        rec["train_launches"] = {k: sum(st[k] for st in seen["step_launches"])
                                 for k in seen["step_launches"][0]}
        log(f"train: {steps} steps in {rec['train_s']:.2f} s; s/iteration median "
            f"{rec['s_per_iter_median']:.5f} (first {rec['s_per_iter_first']:.3f}); launches "
            f"per step {per_step}, in its forward {forward}; peak {rec['peak_gb']:.2f} GB")
        if steps != TRAIN_ITERS or int(state.step) != TRAIN_ITERS:
            raise AssertionError(f"train: {steps} steps, state at {int(state.step)}")
        if per_step["fused_nerf_march"] != [2] or forward != [2] or any(
                v != [0] for k, v in per_step.items() if k != "fused_nerf_march"):
            raise AssertionError(f"train: launches per step {per_step}, forward {forward}: "
                                 "not 2 of fused_nerf_march in the forward, 0 in the backward")
        k = min(50, steps // 4)
        rec["loss_first"], rec["loss_last"] = (statistics.mean(seen["loss"][:k]),
                                               statistics.mean(seen["loss"][-k:]))
        rec["loss_every_100"] = seen["loss"][::100]
        if not (all(math.isfinite(x) for x in seen["loss"])
                and rec["loss_last"] < rec["loss_first"]):
            raise AssertionError(f"train: loss {rec['loss_first']} -> {rec['loss_last']}")
        (final,) = seen["testset"]
        rec["test_psnr"] = final["result"]
        rec["testset_launches"] = final["launches"]
        rec["testset_s"] = final["seconds"]
        log(f"train: loss {rec['loss_first']:.5f} -> {rec['loss_last']:.5f} (means of {k} "
            f"steps); test PSNR {rec['init_test_psnr']:.3f} dB at init -> "
            f"{rec['test_psnr']:.3f} dB (need +{PSNR_RISE_DB:g}); test-set render "
            f"{final['seconds']:.3f} s, launches {final['launches']}")
        if not rec["test_psnr"] >= rec["init_test_psnr"] + PSNR_RISE_DB:
            raise AssertionError("train: the test PSNR did not rise by the margin")
        expdir = os.path.join(basedir, "nerf")
        tar = os.path.join(expdir, f"{TRAIN_ITERS:06d}.tar")
        ckpt = os.path.join(expdir, "checkpoints", f"ckpt_{TRAIN_ITERS:08d}.pt")
        if not (os.path.exists(tar) and os.path.exists(ckpt)):
            raise AssertionError(f"train: {tar} or {ckpt} missing")
        (sp,) = seen["spiral"]
        spiral = sp["result"]
        rec["spiral"] = {"path": os.path.relpath(spiral.path, tmp), "video": spiral.video,
                         "seconds": sp["seconds"], "launches": sp["launches"]}
        has_imageio = importlib.util.find_spec("imageio") is not None
        if has_imageio:
            ok = spiral.video and os.path.isfile(spiral.path)
        else:
            ok = (not spiral.video and os.path.isdir(spiral.path)
                  and len(os.listdir(spiral.path)) == len(ds.render_poses))
        log(f"train: spiral {rec['spiral']} (imageio installed: {has_imageio})")
        if not ok:
            raise AssertionError(f"train: spiral {spiral}")

        # render_only from the .tar reproduces the in-loop test PSNR
        with trainer_instruments() as again:
            out = train_cli.main(argv + ["--render_only", "--render_test", "--ft_path", tar])
        (ro,) = again["testset"]
        rec["render_only_psnr"] = ro["result"]
        log(f"train: render_only --render_test from the .tar: {ro['result']:.5f} dB against "
            f"{rec['test_psnr']:.5f} in the loop")
        if out is not None or not abs(ro["result"] - rec["test_psnr"]) <= 1e-3:
            raise AssertionError("train: render_only did not reproduce the test PSNR")

        rec["card_vs_cpu"], card, batches = train_card_vs_cpu(ds, cfg.net, rc, tc)
        rec["packing_ms"] = packing_ms(card.params["coarse"], cfg.net)
        rec["packing_share"] = 2 * rec["packing_ms"] / (1e3 * rec["s_per_iter_median"])
        log(f"train: preparing one weight set {rec['packing_ms']:.3f} ms, 2 per step: "
            f"{rec['packing_share']:.4f} of a step")

        def steps_fn():
            s = card
            for i in range(PROFILE_STEPS):
                s, _ = train_nerf.train_step(s, *batches[i % len(batches)], cfg.net, rc, tc,
                                             torch.Generator(device=DEVICE).manual_seed(i))

        rec["profile"] = profile_steps(steps_fn, PROFILE_STEPS)
        log(f"train: {PROFILE_STEPS} steps under torch.profiler: {json.dumps(rec['profile'])}")
    return rec


def main():
    t_start = time.perf_counter()
    name, smi = phase_device()
    peak_key, peaks = peaks_for(name)
    log(f"peaks ({peak_key}): fp32 {peaks[0] / 1e12:.0f} TFLOP/s, bf16 "
        f"{peaks[1] / 1e12:.0f} TFLOP/s, memory {peaks[2] / 1e12:.2f} TB/s")
    spills = phase_build()
    net = NeRFNetConfig()
    rec, chain = phase_kernels(net, peaks)
    phase_backward(net)
    routes, routes16, box, cfg = phase_main_path()
    plain_net = phase_plain_net(psi_init("5"))
    wide_main = phase_wide_main_path(psi_init("5"), smi)
    entries, entries16 = phase_entry_points(box, cfg, routes)
    pipeline, others, bench = phase_production(box, routes, routes16)
    grad = phase_render_grad(box, smi)
    detector = phase_detector(pipeline["float32"]["renderer"], smi)
    bilevel = phase_bilevel(box, smi)
    train = phase_train_nerf(box, smi)
    production_launched = {f"pipeline_{name}": run["launched"] for name, run in pipeline.items()}
    production_launched.update({name: run["launched"] for name, run in others.items()})
    production_launched.update({f"bench_{k}": v for k, v in bench["launched"].items()})
    production = {
        "pipeline": {name: {k: run[k] for k in (
            "budget", "hits", "k_sel", "grid_s", "calibrate_s", "setup_s", "rays_per_s",
            "exact_rays_per_s", "psnr_vs_exact", "err_vs_twin", "max_diff_vs_exact")}
            for name, run in pipeline.items()},
        "routes": {name: {k: v for k, v in run.items() if k != "launched"}
                   for name, run in others.items()},
        "bench_shape": {k: v for k, v in bench.items() if k != "launched"},
    }
    wgmma_checks = [(kernel, "default", rec[kernel]["ms"]["bfloat16_S192"],
                     rec[kernel]["ms"]["float32_S192"]) for kernel in KERNELS]
    wide_march = rec["fused_nerf_march"]["wide"]
    s0 = WIDE_S[0]
    wgmma_checks.append(("fused_nerf_march", f"{WIDE} S{s0}",
                         wide_march[shape_key("bfloat16", N_RAYS, s0)]["ms"],
                         wide_march[shape_key("float32", N_RAYS, s0)]["ms"]))
    for kernel, where, ms16, ms32 in wgmma_checks:
        log(f"bf16 vs float32 {kernel} ({where}{', S192' if where == 'default' else ''}): "
            f"{ms16:.3f} ms = {ms16 / ms32:.3f} of its float32 {ms32:.3f} ms "
            f"(limit {WGMMA_FRACTION:g})")
        if ms16 > WGMMA_FRACTION * ms32:
            raise AssertionError(f"{kernel} in bf16 ({where}) is not on the tensor cores' time")
    records = []
    for kernel in KERNELS:
        src, replaces = REPLACES[kernel]
        r = rec[kernel]
        main = routes.get(kernel) or entries[kernel]
        main16 = routes16.get(kernel) or entries16.get(kernel)
        records.append({
            "name": kernel,
            "route": "cuda",
            "source": SOURCE + src,
            "replaces": replaces,
            "launches": main["launches"],
            "max_abs_err": r["err_f32"],
            "ms": r["ms"]["float32_S192"],
            "plain_ms": r["plain_ms"]["float32_S192"],
            "bound_ms": r["bound_ms"]["float32_S192"],
            "bound_by": r["bound_by"]["float32_S192"],
            "library_ms": None,
            "core": CORES[kernel],
            "ms_bf16": r["ms"]["bfloat16_S192"],
            "plain_ms_bf16": r["plain_ms"]["bfloat16_S192"],
            "bound_ms_bf16": r["bound_ms"]["bfloat16_S192"],
            "chain_ms": chain,
            "max_err_f32": r["err_f32"],
            "max_err_bf16": r["err_bf16"],
            "kernel_ms": r["ms"],
            "plain_ms_by_shape": r["plain_ms"],
            "bound_ms_by_shape": r["bound_ms"],
            "main_path": {k: v for k, v in main.items()
                          if k not in ("rgb", "noise", "renderer")},
            "main_path_bf16": main16 and {k: v for k, v in main16.items()
                                          if k not in ("rgb", "noise", "renderer")},
            "production_launches": {run: launched[kernel]
                                    for run, launched in production_launched.items()},
            "production": production if kernel == "fused_nerf_march" else None,
            "detector_render_launches": detector["render_launches"][kernel],
            "bilevel_launches": {"per_epoch": [st["render"][kernel] for st in
                                               bilevel["stage_launches"]],
                                 "cull_guard": bilevel["guard_launches"][kernel],
                                 "run": bilevel["launches"][kernel]},
            "train_launches": {"run": train["launches"][kernel],
                               "train_steps": train["train_launches"][kernel],
                               "per_step": train["launches_per_step"][kernel],
                               "testset": train["testset_launches"][kernel],
                               "spiral": train["spiral"]["launches"][kernel]},
            "plain_net": plain_net if kernel == "fused_nerf_march" else None,
            "max_err_nets": r["err_nets"],
            "wide": r["wide"],
            "main_path_wide": wide_main if kernel == "fused_nerf_march" else None,
            "max_samples": r.get("max_samples"),
            "build_spills": spills,
            "shape": f"N={N_RAYS} rays x S samples (M = N*S points); "
                     "ms/plain_ms/bound_ms at float32 S=192, *_bf16 at bfloat16 S=192; "
                     "kernel_ms etc. by dtype and S (S=16: the production single pass); "
                     "chain_ms: the same MLP as torch.matmul per layer (bf16; float32 "
                     "with TF32 off); max_err_nets: twin checks on the nets of "
                     f"EXTRA_NETS; wide: times on the {WIDE} net (bound from its own work); "
                     f"main_path_wide: the K=8 render on {WIDE} box-scene weights",
            "card": smi,
        })
    print(json.dumps({"render_grad": grad}), flush=True)
    print(json.dumps({"detector": detector}), flush=True)
    print(json.dumps({"bilevel": bilevel}), flush=True)
    print(json.dumps({"train_nerf": train}), flush=True)
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
