"""One NeRF train step in plain PyTorch: the reference of
``neuralsim_tpu_torch/train_nerf.py``'s ``train_step`` (the reference's
run_nerf_noscale.py:664-715 at no_batching): N_rand pixel rays of one
image, the coarse + fine MSE of the plain render, its gradient by autograd
(the program marches forward with its kernel and differentiates a plain
twin), and Adam with the exponential decay lr * 0.1^(step / (decay * 1000))
in optax's order of operations (bias correction at the incremented count,
eps outside the root).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from bench_port.reference.config import NeRFNetConfig, RenderConfig, TrainConfig
from bench_port.reference.rays import get_rays
from bench_port.reference.render import render_rays, viewdirs_of

Models = Dict[str, Dict[str, torch.Tensor]]


def _map(fn, *trees):
    return {name: {k: fn(*(t[name][k] for t in trees)) for k in trees[0][name]}
            for name in trees[0]}


def adam_init(params: Models) -> dict:
    device = next(iter(params["coarse"].values())).device
    return {"mu": _map(torch.zeros_like, params), "nu": _map(torch.zeros_like, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def adam_update(grads: Models, state: dict, params: Models, tc: TrainConfig,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    count = state["count"]
    mu = _map(lambda g, m: (1 - b1) * g + b1 * m, grads, state["mu"])
    nu = _map(lambda g, v: (1 - b2) * g ** 2 + b2 * v, grads, state["nu"])
    steps = (count + 1).to(torch.float32)
    bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=count.device) ** steps
    bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=count.device) ** steps
    base = torch.tensor(0.1, dtype=torch.float32, device=count.device)
    lr = tc.lrate * torch.pow(base, count.to(torch.float32) / (tc.lrate_decay * 1000))
    new = _map(lambda p, m, v: p - lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps)),
               params, mu, nu)
    return new, {"mu": mu, "nu": nu, "count": count + 1}


def pixel_rays(image, pose, H: int, W: int, K, n_rand: int, generator: torch.Generator):
    """n_rand pixels of the whole image, picked without replacement by a
    permutation drawn from ``generator``: (rays_o, rays_d, target rgb)."""
    rays_o, rays_d = get_rays(H, W, K, pose[:3, :4])
    pick = torch.randperm(H * W, generator=generator, device=generator.device)[:n_rand]
    pick = pick.to(image.device)
    rows, cols = pick // W, pick % W
    return rays_o[rows, cols], rays_d[rows, cols], image[rows, cols, :3]


def step(params: Models, opt_state: dict, rays_o, rays_d, target, net: NeRFNetConfig,
         rc: RenderConfig, tc: TrainConfig, generator: Optional[torch.Generator] = None):
    """One Adam step: (new params, new state, loss, grads). The jitter is
    drawn from ``generator`` as the program's render draws it (u_z
    [N, n_samples], then u_pdf [N, n_importance])."""
    leaves = _map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        out = render_rays(leaves, rays_o, rays_d, viewdirs_of(rays_d), net, rc,
                          generator=generator)
        loss = torch.mean((out["rgb_map"] - target) ** 2)
        if "rgb0" in out:
            loss = loss + torch.mean((out["rgb0"] - target) ** 2)
        keys = [(m, k) for m in leaves for k in leaves[m]]
        flat = torch.autograd.grad(loss, [leaves[m][k] for m, k in keys])
    grads = {m: {} for m in leaves}
    for (m, k), g in zip(keys, flat):
        grads[m][k] = g
    with torch.no_grad():
        new, state = adam_update(grads, opt_state, params, tc)
    return new, state, loss.detach(), grads
