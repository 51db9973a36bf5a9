"""Hierarchical volume renderer: coarse march, importance sampling, fine
march (reference render / batchify_rays / render_rays,
run_nerf_noscale.py:43-123, 390-501; JAX counterpart
``neuralsim_tpu/ops/render.py``).

Routes of one march, as in the JAX package's ``_march``. On a CUDA tensor
with ``rc.use_pallas``:

- ``rc.fuse_compositing`` with ``raw_noise_std == 0``: the fused
  march + compositing kernel (``kernels.raymarch.fused_render_tile``);
- else ``rc.fuse_pointgen`` (the default): the ray-march kernel
  (``fused_nerf_march``) and the plain compositing of
  ``raw2outputs_channels``;
- else the point-major kernel (``fused_nerf_mlp_widepe``, through
  ``query_points``) and ``raw2outputs``.

On a CPU tensor, or with ``rc.use_pallas=False``, every route takes the
plain ``query_points`` (encoding form from ``rc.pe_projection``) plus
``raw2outputs``, as the JAX package does off the TPU.

Routes the port has not reached yet raise NotImplementedError naming the
route: occupancy-grid culling, coarse-raw reuse and the sparse fine pass.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from neuralsim_tpu_torch import resolve_device
from neuralsim_tpu_torch.config import NeRFNetConfig, RenderConfig
from neuralsim_tpu_torch.kernels import raymarch
from neuralsim_tpu_torch.kernels.raymarch import as_dtype
from neuralsim_tpu_torch.models.nerf import query_points
from neuralsim_tpu_torch.ops.rays import get_rays, ndc_rays
from neuralsim_tpu_torch.ops.volume import (
    raw2outputs,
    raw2outputs_channels,
    sample_pdf,
    stratified_z_vals,
)


def _check_slice(rc: RenderConfig):
    if rc.reuse_coarse and rc.n_importance > 0:
        raise NotImplementedError("reuse_coarse (coarse-raw reuse fine pass): later slice")
    if rc.fine_fraction < 1.0:
        raise NotImplementedError("fine_fraction < 1 (sparse fine pass): later slice")


def render_rays(models, rays_o, rays_d, viewdirs, net: NeRFNetConfig,
                rc: RenderConfig, generator: Optional[torch.Generator] = None,
                near=None, far=None) -> Dict[str, torch.Tensor]:
    """Render rays [N,3] with the coarse(+fine) pair.

    viewdirs: [N,3] unit directions (None when use_viewdirs=False).
    generator: draws the stratified jitter, the importance-sampling
    uniforms and the density noise when rc asks for them.
    near, far: optional per-ray [N] overrides of rc.near / rc.far.

    Returns rgb_map/disp_map/acc_map/depth_map, plus rgb0/disp0/acc0 and
    z_std when n_importance > 0.
    """
    _check_slice(rc)
    compute_dtype = as_dtype(rc.compute_dtype)
    z_vals = stratified_z_vals(
        rays_o.shape[0], rc.n_samples,
        rc.near if near is None else near, rc.far if far is None else far,
        perturb=rc.perturb, lindisp=rc.lindisp, generator=generator,
        device=rays_o.device)
    rgb_map, disp_map, acc_map, weights, depth_map = _march(
        models["coarse"], rays_o, rays_d, viewdirs, z_vals, net, rc,
        compute_dtype, generator)

    out = {}
    if rc.n_importance > 0:
        out["rgb0"], out["disp0"], out["acc0"] = rgb_map, disp_map, acc_map
        f_out = _fine_pass(models, rays_o, rays_d, viewdirs, z_vals, weights,
                           net, rc, compute_dtype, generator)
        rgb_map, disp_map, acc_map, depth_map = (
            f_out["rgb_map"], f_out["disp_map"], f_out["acc_map"], f_out["depth_map"])
        out["z_std"] = f_out["z_std"]
    out.update(rgb_map=rgb_map, disp_map=disp_map, acc_map=acc_map,
               depth_map=depth_map)
    return out


def _kernel_route(rays_o, net: NeRFNetConfig, rc: RenderConfig) -> bool:
    """Whether a march goes through a CUDA kernel; raises for a net the
    port's kernel routes do not cover on the card."""
    if not (raymarch.uses_kernel(rays_o) and rc.use_pallas):
        return False
    if not (net.use_viewdirs and net.i_embed != -1):
        raise NotImplementedError(
            "march without view directions or encoding on the card: later slice")
    return True


def _plain_raw(params, rays_o, rays_d, viewdirs, z_vals, net: NeRFNetConfig,
               rc: RenderConfig, compute_dtype):
    """raw [N,S,4] through query_points: the point-major kernel on the
    card (rc.use_pallas), the plain encoding and MLP otherwise."""
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
    return query_points(params, pts, viewdirs, net, compute_dtype,
                        use_pallas=rc.use_pallas, pe_projection=rc.pe_projection)


def _march(params, rays_o, rays_d, viewdirs, z_vals, net: NeRFNetConfig,
           rc: RenderConfig, compute_dtype, generator=None):
    """One network march + compositing; returns the raw2outputs tuple."""
    if _kernel_route(rays_o, net, rc):
        if rc.fuse_compositing and rc.raw_noise_std == 0.0:
            return raymarch.fused_render_tile(
                params, rays_o, rays_d, viewdirs, z_vals, net,
                white_bkgd=rc.white_bkgd, compute_dtype=compute_dtype)
        if rc.fuse_pointgen:
            sigma, rgb3 = raymarch.fused_nerf_march(
                params, rays_o, rays_d, viewdirs, z_vals, net, compute_dtype)
            return raw2outputs_channels(
                sigma, rgb3, z_vals, rays_d, raw_noise_std=rc.raw_noise_std,
                white_bkgd=rc.white_bkgd, generator=generator)
    raw = _plain_raw(params, rays_o, rays_d, viewdirs, z_vals, net, rc, compute_dtype)
    return raw2outputs(raw, z_vals, rays_d, raw_noise_std=rc.raw_noise_std,
                       white_bkgd=rc.white_bkgd, generator=generator)


def _march_raw(params, rays_o, rays_d, viewdirs, z_vals, net: NeRFNetConfig,
               rc: RenderConfig, compute_dtype):
    """Channel-separated raw field along rays without compositing:
    (sigma [N,S], rgb3 [3,N,S]); the march kernel when _march would take
    it, else query_points."""
    if _kernel_route(rays_o, net, rc) and rc.fuse_pointgen:
        return raymarch.fused_nerf_march(params, rays_o, rays_d, viewdirs,
                                         z_vals, net, compute_dtype)
    raw = _plain_raw(params, rays_o, rays_d, viewdirs, z_vals, net, rc, compute_dtype)
    return raw[..., 3], torch.movedim(raw[..., :3], -1, 0)


def _fine_pass(models, rays_o, rays_d, viewdirs, z_vals, weights,
               net: NeRFNetConfig, rc: RenderConfig, compute_dtype,
               generator=None):
    """Importance sampling + fine-network march + compositing."""
    z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    z_samples = sample_pdf(z_mid, weights[..., 1:-1], rc.n_importance,
                           det=not rc.perturb, generator=generator).detach()
    z_all = torch.sort(torch.cat([z_vals, z_samples], dim=-1), dim=-1).values
    fine_params = models.get("fine") or models["coarse"]
    rgb_map, disp_map, acc_map, _, depth_map = _march(
        fine_params, rays_o, rays_d, viewdirs, z_all, net, rc, compute_dtype,
        generator)
    return {"rgb_map": rgb_map, "disp_map": disp_map, "acc_map": acc_map,
            "depth_map": depth_map,
            "z_std": torch.std(z_samples, dim=-1, correction=0)}


def render_ray_batch(models, rays_o, rays_d, net: NeRFNetConfig,
                     rc: RenderConfig, generator: Optional[torch.Generator] = None,
                     grid=None) -> Dict[str, torch.Tensor]:
    """Render a flat ray batch [N,3] in tiles of rc.ray_chunk rays.

    A Python loop over tiles replaces the JAX package's lax.map. The last
    tile is simply shorter: rays are independent, so no padding is needed
    and the N outputs are those of the padded JAX version.
    """
    if grid is not None:
        raise NotImplementedError(
            "occupancy-grid culling (hit_budget < 1, ops/occupancy.py): later slice")
    n = rays_o.shape[0]
    viewdirs = None
    if net.use_viewdirs:
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    chunks = []
    for start in range(0, n, rc.ray_chunk):
        sl = slice(start, start + rc.ray_chunk)
        chunks.append(render_rays(models, rays_o[sl], rays_d[sl],
                                  None if viewdirs is None else viewdirs[sl],
                                  net, rc, generator))
    return {k: torch.cat([c[k] for c in chunks], dim=0) for k in chunks[0]}


def _reshape_maps(out: Dict[str, torch.Tensor], lead) -> Dict[str, torch.Tensor]:
    return {k: v.reshape(tuple(lead) + tuple(v.shape[1:])) for k, v in out.items()}


def apply_ndc(rays_o, rays_d, H: int, W: int, K, rc: RenderConfig, grid=None):
    """rc.ndc at the image/pose entry points: project rays to NDC and set
    the z range to [0, 1]. Returns (rays_o, rays_d, rc')."""
    if not rc.ndc:
        return rays_o, rays_d, rc
    if grid is not None:
        raise ValueError("rc.ndc and occupancy culling cannot combine: the "
                         "grid is in world space, NDC rays are not")
    rays_o, rays_d = ndc_rays(H, W, float(K[0][0]), 1.0, rays_o, rays_d)
    return rays_o, rays_d, dataclasses.replace(rc, near=0.0, far=1.0)


def render_image(models, c2w, H: int, W: int, K, net: NeRFNetConfig,
                 rc: RenderConfig, generator=None, grid=None, device=None):
    """Render one image from a camera-to-world matrix; maps are [H, W, ...]."""
    return _render(models, torch.as_tensor(c2w), (H, W), H, W, K, net, rc,
                   generator, grid, device)


def render_poses(models, c2ws, H: int, W: int, K, net: NeRFNetConfig,
                 rc: RenderConfig, generator=None, grid=None, device=None):
    """Render a [P,4,4] (or [P,3,4]) stack of poses as one flat ray batch;
    maps are [P, H, W, ...]."""
    c2ws = torch.as_tensor(c2ws)
    return _render(models, c2ws, (c2ws.shape[0], H, W), H, W, K, net, rc,
                   generator, grid, device)


def _render(models, c2ws, lead, H, W, K, net, rc, generator, grid, device):
    device = resolve_device(device)
    c2ws = c2ws.to(device=device, dtype=torch.float32)
    rays_o, rays_d = get_rays(H, W, K, c2ws)
    rays_o, rays_d, rc = apply_ndc(rays_o, rays_d, H, W, K, rc, grid)
    out = render_ray_batch(models, rays_o.reshape(-1, 3), rays_d.reshape(-1, 3),
                           net, rc, generator, grid=grid)
    return _reshape_maps(out, lead)


def to8b(x) -> np.ndarray:
    """float [0,1] -> uint8 (reference run_nerf_helpers.py:14)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return (255 * np.clip(np.asarray(x), 0, 1)).astype(np.uint8)
