"""Standalone NeRF training (the port of ``neuralsim_tpu/train_nerf.py``;
reference trainer ``optimization/utils/run_nerf_noscale.py:503-791``: N_rand
sampled rays per step, coarse + fine MSE, Adam with exponential decay,
periodic artifacts through a hook).

The step differentiates ``render_rays``: on the card each march of the
forward is the ray-march kernel (``kernels.raymarch.fused_nerf_march``),
whose backward recomputes through its plain twin in float32, as the JAX
``custom_vjp`` does (``kernels/raymarch.py:1070-1083``). Parameters are
nested dicts of tensors and the optimizer is tensor arithmetic on them
(optax's adam with the reference's schedule, step for step), so a step
returns new tensors and never updates in place.

Draws come from one ``torch.Generator``: the image and pixel picks of the
per-image path, the pool permutation of ``use_batching`` and the render's
jitter. ``StepDraws`` injects any of them (the tests feed the JAX draws).
``train_nerf(mesh=)`` of the JAX package is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from neuralsim_tpu_torch import resolve_device
from neuralsim_tpu_torch.config import NeRFNetConfig, RenderConfig, TrainConfig
from neuralsim_tpu_torch.detector.trainer import Optimizer
from neuralsim_tpu_torch.models.nerf import init_nerf_pipeline_params
from neuralsim_tpu_torch.ops.rays import get_rays, ndc_rays
from neuralsim_tpu_torch.ops.render import img2mse, mse2psnr, render_rays

Models = Dict[str, Dict[str, torch.Tensor]]


class TrainState(NamedTuple):
    params: Models        # {"coarse": ..., "fine": ...}
    opt_state: dict       # {"mu": Models, "nu": Models, "count": int32} (optax ScaleByAdamState)
    step: torch.Tensor    # int32


def _map(fn, *trees):
    """fn over the leaves of nested dicts of tensors of one structure."""
    return {name: {k: fn(*(t[name][k] for t in trees)) for k in trees[0][name]}
            for name in trees[0]}


def make_optimizer(tc: TrainConfig, b1: float = 0.9, b2: float = 0.999,
                   eps: float = 1e-8) -> Optimizer:
    """Adam with the reference's exponential decay, lr * 0.1^(step / (decay *
    1000)) (run_nerf_noscale.py:711-715): optax.adam(schedule, b1, b2) of
    the JAX package in its order of operations (moments, bias correction at
    the incremented count, eps outside the root, eps_root 0, the schedule
    at the count before the increment). ``update`` returns (new params, new
    state)."""
    decay_steps = tc.lrate_decay * 1000

    def schedule(count: torch.Tensor) -> torch.Tensor:
        base = torch.tensor(0.1, dtype=torch.float32, device=count.device)
        return tc.lrate * torch.pow(base, count.to(torch.float32) / decay_steps)

    def init(params: Models) -> dict:
        device = next(iter(params["coarse"].values())).device
        return {"mu": _map(torch.zeros_like, params), "nu": _map(torch.zeros_like, params),
                "count": torch.zeros((), dtype=torch.int32, device=device)}

    def update(grads: Models, state: dict, params: Models):
        count = state["count"]
        count_inc = count + 1
        mu = _map(lambda g, m: (1 - b1) * g + b1 * m, grads, state["mu"])
        nu = _map(lambda g, v: (1 - b2) * g ** 2 + b2 * v, grads, state["nu"])
        steps = count_inc.to(torch.float32)
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=count.device) ** steps
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=count.device) ** steps
        step_size = -schedule(count)
        new = _map(lambda p, m, v: p + step_size * ((m / bc1) / (torch.sqrt(v / bc2) + eps)),
                   params, mu, nu)
        return new, {"mu": mu, "nu": nu, "count": count_inc}

    return Optimizer(init, update)


def init_train_state(net: NeRFNetConfig, rc: RenderConfig, tc: TrainConfig,
                     generator: Optional[torch.Generator] = None, device=None) -> TrainState:
    """Fresh coarse (+ fine) params drawn from ``generator``, zero moments,
    step 0, on ``device`` (``cuda`` unless the caller asks for the CPU)."""
    device = resolve_device(device)
    params = init_nerf_pipeline_params(net, rc.n_importance, generator, device)
    return TrainState(params, make_optimizer(tc).init(params),
                      torch.zeros((), dtype=torch.int32, device=device))


def train_state_from_jax(params, opt_state, step, device="cpu") -> TrainState:
    """A JAX ``TrainState`` as numpy (params {"coarse", "fine"}; optax's
    chain state, whose first entry is the ``ScaleByAdamState`` with mu, nu
    and count) -> the port's TrainState on ``device``: a JAX-trained or
    half-trained NeRF resumes in the port."""
    from neuralsim_tpu_torch.models.convert import params_from_numpy

    adam = opt_state[0]
    return TrainState(
        params_from_numpy(params, device),
        {"mu": params_from_numpy(adam.mu, device), "nu": params_from_numpy(adam.nu, device),
         "count": torch.as_tensor(np.asarray(adam.count), dtype=torch.int32, device=device)},
        torch.as_tensor(np.asarray(step), dtype=torch.int32, device=device))


def nerf_loss(params: Models, rays_o, rays_d, target_rgb, net: NeRFNetConfig,
              rc: RenderConfig, generator: Optional[torch.Generator] = None,
              uniforms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Coarse + fine MSE (reference :696-704); returns (loss, render)."""
    viewdirs = None
    if net.use_viewdirs:
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    out = render_rays(params, rays_o, rays_d, viewdirs, net, rc, generator,
                      uniforms=uniforms)
    loss = img2mse(out["rgb_map"], target_rgb)
    if "rgb0" in out:
        loss = loss + img2mse(out["rgb0"], target_rgb)
    return loss, out


def train_step(state: TrainState, rays_o, rays_d, target_rgb, net: NeRFNetConfig,
               rc: RenderConfig, tc: TrainConfig,
               generator: Optional[torch.Generator] = None,
               uniforms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """One optimizer step on a ray batch: (new state, {"loss", "psnr"}).
    The state passed in is left as it was. ``uniforms`` as in
    ``render_rays``."""
    leaves = _map(lambda p: p.detach().requires_grad_(), state.params)
    loss, out = nerf_loss(leaves, rays_o, rays_d, target_rgb, net, rc, generator, uniforms)
    keys = [(name, k) for name in leaves for k in leaves[name]]
    grads = iter(torch.autograd.grad(loss, [leaves[name][k] for name, k in keys]))
    grad_tree = _map(lambda _: next(grads), leaves)
    with torch.no_grad():
        params, opt_state = make_optimizer(tc).update(grad_tree, state.opt_state, state.params)
        psnr = mse2psnr(torch.clamp(img2mse(out["rgb_map"], target_rgb), min=1e-10))
    metrics = {"loss": loss.detach(), "psnr": psnr}
    return TrainState(params, opt_state, state.step + 1), metrics


class RayPool(NamedTuple):
    """All train-image rays flattened: the reference's use_batching pool
    (run_nerf_noscale.py:604-621), built once on the device."""

    rays_o: torch.Tensor   # [M, 3]
    rays_d: torch.Tensor   # [M, 3]
    rgb: torch.Tensor      # [M, 3]


def build_ray_pool(images, poses, i_train, H: int, W: int, K, device=None) -> RayPool:
    """Flatten every training image's rays into one pool on ``device``."""
    device = resolve_device(device)
    idx = torch.as_tensor(np.asarray(i_train), dtype=torch.int64)
    p = torch.as_tensor(np.asarray(poses), dtype=torch.float32)[idx].to(device)
    ro, rd = get_rays(H, W, K, p[:, :3, :4])
    rgb = torch.as_tensor(np.asarray(images), dtype=torch.float32)[idx][..., :3].to(device)
    return RayPool(ro.reshape(-1, 3), rd.reshape(-1, 3), rgb.reshape(-1, 3))


def make_pool_sampler(n_rand: int):
    """(pool, perm, start) -> the next n_rand rays of the permutation: the
    device-side replacement for the reference's host-tensor slicing
    (run_nerf_noscale.py:644-655)."""

    def take(pool: RayPool, perm: torch.Tensor, start: int):
        idx = perm[start:start + n_rand]
        return pool.rays_o[idx], pool.rays_d[idx], pool.rgb[idx]

    return take


def _pixel_coords(H: int, W: int, precrop_frac: Optional[float], device) -> torch.Tensor:
    """The (row, col) of every pixel the step may pick, [n, 2]: the whole
    image, or its central crop of precrop_frac."""
    if precrop_frac:
        dh = int(H // 2 * precrop_frac)
        dw = int(W // 2 * precrop_frac)
        ys = torch.arange(H // 2 - dh, H // 2 + dh, device=device)
        xs = torch.arange(W // 2 - dw, W // 2 + dw, device=device)
    else:
        ys, xs = torch.arange(H, device=device), torch.arange(W, device=device)
    return torch.stack(torch.meshgrid(ys, xs, indexing="ij"), -1).reshape(-1, 2)


def sample_image_rays(image, pose, H: int, W: int, K, n_rand: int,
                      precrop_frac: Optional[float] = None,
                      generator: Optional[torch.Generator] = None,
                      pixels: Optional[torch.Tensor] = None):
    """n_rand pixel rays of one image (the reference's no_batching path with
    its optional central precrop, run_nerf_noscale.py:664-688), picked
    without replacement: ``pixels`` (indices into the candidate pixels in
    row-major order) when given, else drawn from ``generator``. image
    [H, W, C] and pose [4, 4] are tensors on the device the rays go to."""
    rays_o, rays_d = get_rays(H, W, K, pose[:3, :4])
    coords = _pixel_coords(H, W, precrop_frac, image.device)
    if pixels is None:
        gen_device = generator.device if generator is not None else "cpu"
        pixels = torch.randperm(coords.shape[0], generator=generator,
                                device=gen_device)[:n_rand]
    picked = coords[pixels.to(image.device)]
    ro = rays_o[picked[:, 0], picked[:, 1]]
    rd = rays_d[picked[:, 0], picked[:, 1]]
    tgt = image[picked[:, 0], picked[:, 1], :3]
    return ro, rd, tgt


class StepDraws(NamedTuple):
    """Draws for one iteration of ``train_nerf``; None leaves a draw to the
    generator. ``image``: the train image (a dataset index); ``pixels``: the
    pixel picks of ``sample_image_rays``; ``perm``: the pool permutation,
    used where the loop takes a new one in this iteration (the first at
    iteration 0, then at each reshuffle); ``uniforms``: the render's
    (u_z, u_pdf) of ``render_rays``."""

    image: Optional[int] = None
    pixels: Optional[torch.Tensor] = None
    perm: Optional[torch.Tensor] = None
    uniforms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


def train_nerf(dataset, net: NeRFNetConfig, rc: RenderConfig, tc: TrainConfig,
               generator: Optional[torch.Generator] = None, n_iters: Optional[int] = None,
               log_every: Optional[int] = None, hook=None,
               state: Optional[TrainState] = None, device=None,
               draws: Optional[Callable[[int], StepDraws]] = None):
    """Training loop over a LinemodDataset on ``device`` (``cuda`` unless
    the caller asks for the CPU). Returns (final TrainState, last metrics).

    ``hook(i, state)`` is called after every step with the 1-based GLOBAL
    step (``state.step``: a resumed run continues the restored numbering,
    so periodic artifact names never collide with earlier checkpoints); it
    carries the reference's periodic artifacts (run_nerf_noscale.py:
    723-756). ``state`` warm-starts from a restored checkpoint instead of a
    fresh init drawn from ``generator`` (a generator seeded 0 on the device
    by default). ``draws(it)`` injects the draws of iteration ``it``.
    """
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    cam = dataset.camera
    rc_train = dataclasses.replace(rc, near=cam.near, far=cam.far)
    if rc_train.ndc:
        # NDC projection happens at ray-sampling time (the reference applies
        # it inside render(), run_nerf_noscale.py:105-112); the march then
        # runs over the NDC z range [0, 1]
        rc_train = dataclasses.replace(rc_train, near=0.0, far=1.0)
    if state is None:
        state = init_train_state(net, rc_train, tc, generator, device)

    i_train = np.asarray(dataset.i_split[0])
    n_iters = n_iters if n_iters is not None else tc.n_iters
    images = torch.as_tensor(np.asarray(dataset.images), dtype=torch.float32, device=device)
    poses = torch.as_tensor(np.asarray(dataset.poses), dtype=torch.float32, device=device)
    gen_device = generator.device

    use_batching = not tc.no_batching
    if use_batching:
        # cross-image ray shuffle (reference use_batching, :604-621,
        # 644-655): every train ray in one device pool, a device-side
        # permutation consumed n_rand at a time and redrawn each epoch.
        # As in the JAX package: where the reference feeds one partial batch
        # at an epoch boundary, this reshuffles, so every batch is full
        pool = build_ray_pool(dataset.images, dataset.poses, i_train,
                              cam.height, cam.width, cam.K, device)
        m = pool.rays_o.shape[0]
        n_take = min(tc.n_rand, m)
        take_fn = make_pool_sampler(n_take)
        perm, i_batch = None, 0

    start_step = int(state.step)
    metrics = {}
    for it in range(n_iters):
        d = draws(it) if draws is not None else StepDraws()
        if use_batching:
            if perm is None or i_batch + n_take > m:
                perm = (d.perm if d.perm is not None else
                        torch.randperm(m, generator=generator, device=gen_device)).to(device)
                i_batch = 0
            ro, rd, tgt = take_fn(pool, perm, i_batch)
            i_batch += n_take
        else:
            if d.image is not None:
                img_idx = int(d.image)
            else:
                pick = torch.randint(len(i_train), (1,), generator=generator,
                                     device=gen_device)
                img_idx = int(i_train[int(pick)])
            precrop = tc.precrop_frac if it < tc.precrop_iters else None
            ro, rd, tgt = sample_image_rays(images[img_idx], poses[img_idx], cam.height,
                                            cam.width, cam.K, tc.n_rand, precrop,
                                            generator, d.pixels)
        if rc_train.ndc:
            ro, rd = ndc_rays(cam.height, cam.width, float(cam.K[0][0]), 1.0, ro, rd)
        state, metrics = train_step(state, ro, rd, tgt, net, rc_train, tc, generator,
                                    d.uniforms)
        if log_every and (it % log_every == 0):
            print(f"[train] iter {it} loss {float(metrics['loss']):.5f} "
                  f"psnr {float(metrics['psnr']):.2f}")
        if hook is not None:
            hook(start_step + it + 1, state)
    return state, metrics

