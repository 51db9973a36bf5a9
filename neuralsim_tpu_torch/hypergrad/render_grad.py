"""dL_val/dpsi through pose sampling and rendering (JAX counterpart
``neuralsim_tpu/hypergrad/render_grad.py``).

The reference computes it with a render-twice replay and a per-chunk
double-VJP loop (``render_path_grad``,
``optimization/utils/run_nerf_noscale.py:126-210``). Here the map
psi -> poses -> rays -> rgb -> <rgb, grad_E> is one differentiable
function, in three modes:

  - ``render_grad_psi_strips`` (the default): a loop over image batches and
    pixel strips, one reverse-mode render of one ray tile each; exact,
    since the loss is linear in pixels. With an occupancy grid and a budget
    below 1 only the rays that can hit the occupied box are rendered
    (``_render_grad_strips_culled``);
  - ``render_grad_psi_fwd``: one forward-mode JVP per psi component
    (``torch.func.jvp``), no stored activations;
  - ``render_grad_psi_rev``: reverse mode with per-tile rematerialization
    (``rc.remat``: ``torch.utils.checkpoint`` around each ray tile).

Every mode renders with the plain torch path, in float32 (``compute_dtype``
for strips) and a true cos in the encoding (``use_pallas=False``,
``pe_projection=False``), as the JAX package renders its gradients off
Pallas; no kernel of ``kernels.raymarch`` runs. The functions run on the
device of the models they are given.

grad_E is the detector-side cotangent on the rendered rgb
(``neural_sim_main.py:855-911``). Two deliberate deviations from the
reference, as in the JAX package (PARITY.md): the gradient is chained
through softmax(psi / T) to psi, and the loss is a mean over images.

``render_grad_psi_strips(mesh=)`` splits the images over the mesh's data
axis, as the JAX package's ``shard_map`` does: each rank differentiates its
block of every image batch and psi's gradient is summed over the data group
(``parallel.mesh``). Two arguments of the JAX functions shape only XLA
compilation and have no counterpart here: ``jit_cache`` (compiled programs
kept across calls) and ``dynamic_start`` (a traced strip offset, the same
math; ``BilevelConfig`` has no ``grad_dynamic_start`` either). For the same
reason nothing is padded to a fixed tile: the last strip or index chunk is
shorter, and so is the last image batch without a mesh.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from neuralsim_tpu_torch.config import NeRFNetConfig, RenderConfig, SamplerConfig
from neuralsim_tpu_torch.ops.occupancy import ray_aabb_bounds
from neuralsim_tpu_torch.ops.rays import get_rays
from neuralsim_tpu_torch.ops.render import render_poses, render_ray_batch, top_k_indices
from neuralsim_tpu_torch.parallel.mesh import all_sum, pad_rows, pad_to_multiple, shard_batch
from neuralsim_tpu_torch.sampler.poses import (
    PoseNoise,
    poses_from_noise,
    poses_from_noise_gaussian,
    psi_to_probs,
)
from neuralsim_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)


def psi_poses(psi, noise, sc: SamplerConfig, psi_mode: str = "categorical"):
    """Differentiable psi -> poses map for either parameterization:
    categorical 8-bin logits (the reference's live mode) or gaussian
    (mean, std) over azimuth."""
    if psi_mode == "gaussian":
        return poses_from_noise_gaussian(psi, noise, sc)
    return poses_from_noise(psi_to_probs(psi, sc), noise, sc)


def _on_models_device(models, psi, noise, grad_E):
    """psi, noise and grad_E as float32 tensors on the models' device."""
    device = next(iter(models["coarse"].values())).device
    return (torch.as_tensor(psi, dtype=torch.float32, device=device), noise.to(device),
            torch.as_tensor(grad_E, dtype=torch.float32, device=device))


def _grad(loss_fn, psi):
    """d loss_fn(psi) / d psi by reverse mode."""
    with torch.enable_grad():
        p = psi.detach().requires_grad_(True)
        return torch.autograd.grad(loss_fn(p), p)[0]


def _strip_grad(loss_fn, psi):
    """``_grad`` of one strip tile's loss, as the span ``render_grad.strip``."""
    with span("render_grad.strip"):
        return _grad(loss_fn, psi)


def _rows(noise, index):
    """The noise rows ``index`` (a slice or an index tensor)."""
    return type(noise)(*(x[index] for x in noise))


def _local_images(mesh, n: int, noise, grad_e, *rows):
    """This rank's block of an image batch padded to ``n`` images: the
    noise (and any index rows) repeat their last row, grad_E pads with
    zeros, a zero cotangent that adds exactly nothing."""
    padded = (type(noise)(*(pad_rows(x, n) for x in noise)), pad_rows(grad_e, n, zero=True),
              *(pad_rows(x, n) for x in rows))
    return shard_batch(padded, mesh)


def _image_rays(psi, noise, H: int, W: int, K, sc: SamplerConfig, psi_mode: str):
    """Ray origins and directions [B, H*W, 3] of the B poses of noise."""
    poses = psi_poses(psi, noise, sc, psi_mode)
    rays_o, rays_d = get_rays(H, W, K, poses[:, :3, :4])
    b = poses.shape[0]
    return rays_o.reshape(b, -1, 3), rays_d.reshape(b, -1, 3)


def psi_outer_loss(models, psi, noise: PoseNoise, grad_E,
                   H: int, W: int, K, net: NeRFNetConfig, rc: RenderConfig,
                   sc: SamplerConfig, psi_mode: str = "categorical"):
    """L(psi) = mean over images of <render(pose_i(psi)), grad_E_i>.

    grad_E [P, H, W, 3] is the cotangent on the rendered rgb, P <= K (the
    reference caps the pose loop at len(grad_E)); pass noise sliced to the
    same P."""
    poses = psi_poses(psi, noise, sc, psi_mode)
    out = render_poses(models, poses, H, W, K, net, rc, device=poses.device)
    return torch.mean(torch.sum(out["rgb_map"] * grad_E, dim=(1, 2, 3)))


def _plain_rc(rc: RenderConfig, **kw) -> RenderConfig:
    """The render of a gradient: plain torch, true cos."""
    return dataclasses.replace(rc, pe_projection=False, use_pallas=False, **kw)


def render_grad_psi_fwd(models, psi, noise: PoseNoise, grad_E,
                        H: int, W: int, K, net: NeRFNetConfig,
                        rc: RenderConfig, sc: SamplerConfig,
                        psi_mode: str = "categorical"):
    """Forward-mode dL/dpsi: one JVP per psi component, serially (the JAX
    package's lax.map), so peak memory is one forward render's."""
    rc = _plain_rc(rc, remat=False, compute_dtype="float32")
    psi, noise, grad_E = _on_models_device(models, psi, noise, grad_E)

    def loss(p):
        return psi_outer_loss(models, p, noise, grad_E, H, W, K, net, rc, sc, psi_mode)

    basis = torch.eye(psi.shape[0], dtype=psi.dtype, device=psi.device)
    return torch.stack([torch.func.jvp(loss, (psi,), (v,))[1] for v in basis])


def render_grad_psi_rev(models, psi, noise: PoseNoise, grad_E,
                        H: int, W: int, K, net: NeRFNetConfig,
                        rc: RenderConfig, sc: SamplerConfig,
                        psi_mode: str = "categorical"):
    """Reverse-mode dL/dpsi with per-tile rematerialization (the backward
    keeps one ray tile's activations at a time)."""
    rc = _plain_rc(rc, remat=True, compute_dtype="float32")
    psi, noise, grad_E = _on_models_device(models, psi, noise, grad_E)
    return _grad(lambda p: psi_outer_loss(models, p, noise, grad_E, H, W, K, net, rc, sc,
                                          psi_mode), psi)


def psi_strip_loss(models, psi, noise_1: PoseNoise, grad_E_strip, start: int,
                   H: int, W: int, K, net: NeRFNetConfig, rc: RenderConfig,
                   sc: SamplerConfig, psi_mode: str = "categorical"):
    """<render(rays[start : start + S]), grad_E_strip> for one image: the
    loss is linear in pixels, so an image's dL/dpsi is the sum of these
    per-strip terms."""
    rays_o, rays_d = _image_rays(psi, noise_1, H, W, K, sc, psi_mode)
    s = grad_E_strip.shape[0]
    out = render_ray_batch(models, rays_o[0, start:start + s], rays_d[0, start:start + s],
                           net, rc)
    return torch.sum(out["rgb_map"] * grad_E_strip)


def psi_strips_batch_loss(models, psi, noise_b: PoseNoise, grad_E_strips, start: int,
                          H: int, W: int, K, net: NeRFNetConfig, rc: RenderConfig,
                          sc: SamplerConfig, psi_mode: str = "categorical"):
    """Sum over a batch of B images of one pixel strip's <render, grad_E>:
    grad_E_strips [B, S, 3], the B strips flattened into one ray tile (the
    caller sets rc.ray_chunk = B * S and divides by the image count)."""
    rays_o, rays_d = _image_rays(psi, noise_b, H, W, K, sc, psi_mode)
    s = grad_E_strips.shape[1]
    out = render_ray_batch(models, rays_o[:, start:start + s].reshape(-1, 3),
                           rays_d[:, start:start + s].reshape(-1, 3), net, rc)
    return torch.sum(out["rgb_map"] * grad_E_strips.reshape(-1, 3))


def psi_gather_loss(models, psi, noise_1: PoseNoise, grad_E_sel, idx,
                    H: int, W: int, K, net: NeRFNetConfig, rc: RenderConfig,
                    sc: SamplerConfig, psi_mode: str = "categorical"):
    """<render(rays[idx]), grad_E_sel> for one image: the rays are an index
    vector instead of a contiguous strip (the culled gradient's term; the
    gather's backward is a scatter-add into the image's rays)."""
    rays_o, rays_d = _image_rays(psi, noise_1, H, W, K, sc, psi_mode)
    out = render_ray_batch(models, rays_o[0, idx], rays_d[0, idx], net, rc)
    return torch.sum(out["rgb_map"] * grad_E_sel)


def psi_gather_batch_loss(models, psi, noise_b: PoseNoise, grad_E_sel, idx,
                          H: int, W: int, K, net: NeRFNetConfig,
                          rc: RenderConfig, sc: SamplerConfig,
                          psi_mode: str = "categorical"):
    """psi_gather_loss over B images flattened into one tile (idx [B, S],
    grad_E_sel [B, S, 3])."""
    rays_o, rays_d = _image_rays(psi, noise_b, H, W, K, sc, psi_mode)
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    out = render_ray_batch(models, rays_o[rows, idx].reshape(-1, 3),
                           rays_d[rows, idx].reshape(-1, 3), net, rc)
    return torch.sum(out["rgb_map"] * grad_E_sel.reshape(-1, 3))


def render_grad_psi_strips(models, psi, noise: PoseNoise, grad_E,
                           H: int, W: int, K, net: NeRFNetConfig,
                           rc: RenderConfig, sc: SamplerConfig,
                           psi_mode: str = "categorical",
                           strip: int | None = None,
                           image_batch: int = 1,
                           compute_dtype: str = "float32",
                           grid=None,
                           hit_budget: float = 1.0,
                           mesh=None):
    """dL/dpsi = mean over images of the sum over pixel strips of the strip
    gradients (exact: the loss is linear in pixels; the mean over images is
    the reference's normalization, neural_sim_main.py:191).

    ``strip``: pixels per strip (default rc.ray_chunk), each strip one ray
    tile whose backward keeps the strip's activations. ``image_batch`` > 1
    folds that many images' strips into one tile. ``compute_dtype``: the MLP's
    matmul dtype inside the render.

    ``grid`` with ``hit_budget`` < 1: the culled gradient. A selection
    without gradient scores every ray of every image against the occupied
    box (``ray_aabb_bounds``) and keeps the top hit_budget fraction per
    image; the strips then gather-render only those rays. Rays that miss
    every occupied voxel see zero density along their whole length, so
    their psi-gradient is identically zero and the culled gradient is exact
    up to the grid's conservativeness. An image whose hit count overflows
    the budget renders all of its pixels (with a warning); the others keep
    their selection.

    ``mesh``: image_batch rounds up to a multiple of the data axis; each
    rank differentiates its block of every batch (a short batch padded
    with repeated noise rows and zero grad_E) and psi's gradient is summed
    over the data group. Every rank returns the whole gradient.
    """
    psi, noise, grad_E = _on_models_device(models, psi, noise, grad_E)
    n_img, n_pix = grad_E.shape[0], H * W
    strip = min(strip or rc.ray_chunk, n_pix)
    ge_flat = grad_E.reshape(n_img, n_pix, 3)
    ib = max(1, int(image_batch))
    if mesh is not None:
        ib = pad_to_multiple(ib, mesh.shape["data"])
    rc = _plain_rc(rc, compute_dtype=compute_dtype)

    if grid is not None and hit_budget < 1.0:
        return _render_grad_strips_culled(models, psi, noise, ge_flat, H, W, K, net, rc, sc,
                                          psi_mode, strip, ib, grid, hit_budget, mesh)

    total = torch.zeros_like(psi)
    if ib == 1:
        for i in range(n_img):
            noise_1 = _rows(noise, slice(i, i + 1))
            for start in range(0, n_pix, strip):
                ge = ge_flat[i, start:start + strip]
                rc_s = dataclasses.replace(rc, remat=False, ray_chunk=ge.shape[0])
                total += _strip_grad(lambda p: psi_strip_loss(models, p, noise_1, ge, start,
                                                              H, W, K, net, rc_s, sc, psi_mode),
                                     psi)
        return total / n_img

    for lo in range(0, n_img, ib):
        nz, ge_b = _rows(noise, slice(lo, lo + ib)), ge_flat[lo:lo + ib]
        if mesh is not None:
            nz, ge_b = _local_images(mesh, ib, nz, ge_b)
        for start in range(0, n_pix, strip):
            ge = ge_b[:, start:start + strip]
            rc_b = dataclasses.replace(rc, ray_chunk=ge.shape[0] * ge.shape[1])
            total += _strip_grad(lambda p: psi_strips_batch_loss(models, p, nz, ge, start, H, W,
                                                                 K, net, rc_b, sc, psi_mode), psi)
    if mesh is not None:
        total = all_sum(total, mesh.data_group)
    return total / n_img


def _render_grad_strips_culled(models, psi, noise, ge_flat, H: int, W: int, K,
                               net: NeRFNetConfig, rc: RenderConfig, sc: SamplerConfig,
                               psi_mode: str, strip: int, ib: int, grid,
                               hit_budget: float, mesh=None):
    """The occupancy-culled strips gradient (see render_grad_psi_strips):
    one selection over all images, then gather-rendered index chunks of
    ``strip`` rays. The per-image hit counts are read on the host once, to
    split the images into those within the budget and those that overflow
    it."""
    n_img, n_pix = ge_flat.shape[0], H * W
    device = ge_flat.device
    k_sel = -(-max(1, int(round(n_pix * hit_budget))) // strip) * strip
    full = k_sel >= n_pix          # the budget covers every pixel: no selection
    overflow = np.zeros((n_img,), bool)
    if not full:
        with torch.no_grad():
            rays_o, rays_d = _image_rays(psi, noise, H, W, K, sc, psi_mode)
            hit, _, _ = ray_aabb_bounds(grid, rays_o, rays_d, rc.near, rc.far)
            idx_all = top_k_indices(hit.to(torch.float32), k_sel)
            hits = hit.sum(dim=-1).cpu().numpy()
        overflow = hits > k_sel
        if overflow.any():
            # the overflowing images render every pixel (never a truncated
            # gradient); the images within budget keep their selection
            logger.warning(
                "culled strips gradient: %d/%d images exceed budget %d "
                "(max hit count %d, hit_budget=%.3f); falling back to all "
                "%d pixels for those images this call",
                int(overflow.sum()), n_img, k_sel, int(hits.max()), hit_budget, n_pix)
            full = bool(overflow.all())

    every_pixel = torch.arange(n_pix, device=device)
    if full:
        groups = [(np.arange(n_img), every_pixel.expand(n_img, -1))]
    elif overflow.any():
        ok, ov = np.nonzero(~overflow)[0], np.nonzero(overflow)[0]
        groups = [(ok, idx_all[torch.as_tensor(ok, device=device)]),
                  (ov, every_pixel.expand(ov.size, -1))]
    else:
        groups = [(np.arange(n_img), idx_all)]

    total = torch.zeros_like(psi)
    for rows, idx in groups:
        rows, n_sel = torch.as_tensor(rows, device=device), idx.shape[1]
        nz_g = _rows(noise, rows)
        ge_g = torch.gather(ge_flat[rows], 1, idx[..., None].expand(-1, -1, 3))
        if ib == 1:
            rc_s = dataclasses.replace(rc, remat=False, ray_chunk=strip)
            for i in range(rows.shape[0]):
                noise_1 = _rows(nz_g, slice(i, i + 1))
                for j0 in range(0, n_sel, strip):
                    ge, ix = ge_g[i, j0:j0 + strip], idx[i, j0:j0 + strip]
                    total += _strip_grad(lambda p: psi_gather_loss(models, p, noise_1, ge, ix,
                                                                   H, W, K, net, rc_s, sc,
                                                                   psi_mode), psi)
            continue
        n_local = ib if mesh is None else ib // mesh.shape["data"]
        rc_b = dataclasses.replace(rc, ray_chunk=n_local * strip)
        for lo in range(0, rows.shape[0], ib):
            nz, ge_r, ix_r = _rows(nz_g, slice(lo, lo + ib)), ge_g[lo:lo + ib], idx[lo:lo + ib]
            if mesh is not None:
                nz, ge_r, ix_r = _local_images(mesh, ib, nz, ge_r, ix_r)
            for j0 in range(0, n_sel, strip):
                ge, ix = ge_r[:, j0:j0 + strip], ix_r[:, j0:j0 + strip]
                total += _strip_grad(lambda p: psi_gather_batch_loss(models, p, nz, ge, ix, H,
                                                                     W, K, net, rc_b, sc,
                                                                     psi_mode), psi)
    if mesh is not None:
        total = all_sum(total, mesh.data_group)
    return total / n_img
