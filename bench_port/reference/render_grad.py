"""dL/dpsi through pose sampling and rendering, by strips: a copy of the
dense strips mode of ``neuralsim_tpu_torch/hypergrad/render_grad.py``
(``render_grad_psi_strips``, one image per tile), the mode the outer loop
runs at its defaults. It leaves out the culled strips, the image batches,
the mesh and the fwd / rev modes.

psi -> poses -> rays -> rgb -> <rgb, grad_E> is one differentiable
function; the loss is linear in pixels, so an image's gradient is the sum
of its strips' and the gradient over images their mean. The render is the
plain one with a true cos in the encoding and ``compute_dtype`` operands.
"""

from __future__ import annotations

import dataclasses

import torch

from bench_port.reference.config import NeRFNetConfig, RenderConfig, SamplerConfig
from bench_port.reference.poses import PoseNoise, poses_from_noise, psi_to_probs
from bench_port.reference.rays import get_rays
from bench_port.reference.render import render_ray_batch


def _grad(loss_fn, psi):
    with torch.enable_grad():
        p = psi.detach().requires_grad_(True)
        return torch.autograd.grad(loss_fn(p), p)[0]


def psi_strip_loss(models, psi, noise_1: PoseNoise, grad_E_strip, start: int, H: int,
                   W: int, K, net: NeRFNetConfig, rc: RenderConfig, sc: SamplerConfig):
    """<render(rays[start : start + S]), grad_E_strip> for one image."""
    poses = poses_from_noise(psi_to_probs(psi, sc), noise_1, sc)
    rays_o, rays_d = get_rays(H, W, K, poses[:, :3, :4])
    s = grad_E_strip.shape[0]
    out = render_ray_batch(models, rays_o.reshape(-1, 3)[start:start + s],
                           rays_d.reshape(-1, 3)[start:start + s], net, rc, block=s)
    return torch.sum(out["rgb_map"] * grad_E_strip)


def image_grads(models, psi, noise: PoseNoise, grad_E, H: int, W: int, K,
                net: NeRFNetConfig, rc: RenderConfig, sc: SamplerConfig, strip: int,
                compute_dtype: str = "float32") -> torch.Tensor:
    """[P, len(psi)]: each image's dL/dpsi (the sum of its strips'); their
    mean is the strips gradient."""
    rc = dataclasses.replace(rc, pe_projection=False, compute_dtype=compute_dtype)
    n_pix = H * W
    strip = min(strip, n_pix)
    ge_flat = grad_E.reshape(grad_E.shape[0], n_pix, 3)
    rows = []
    for i in range(ge_flat.shape[0]):
        noise_1 = type(noise)(*(x[i:i + 1] for x in noise))
        total = torch.zeros_like(psi)
        for start in range(0, n_pix, strip):
            ge = ge_flat[i, start:start + strip]
            total += _grad(lambda p: psi_strip_loss(models, p, noise_1, ge, start, H, W, K,
                                                    net, rc, sc), psi)
        rows.append(total)
    return torch.stack(rows)
