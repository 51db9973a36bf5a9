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

On a CPU tensor, with ``rc.use_pallas=False``, or for a net without view
directions or without an encoding, every route takes the plain
``query_points`` (encoding form from ``rc.pe_projection``) plus
``raw2outputs``, as the JAX package does off the TPU (and for such nets on
it).

A hash-grid field (``models/ngp.py``, ``i_embed = 1``) on the card with
``rc.use_pallas`` takes one route, the hash-grid ray march
(``fused_ngp_march``) and ``raw2outputs_channels``; every other route
(``fuse_compositing``, ``fuse_pointgen=False``, the occupancy-culled
production render) raises, naming itself. Off that route it runs its
plain twin through ``query_points``.

Production routes, as in the JAX package: with an occupancy grid and
``rc.hit_budget < 1`` only a top-k budget of rays is rendered
(``_render_ray_batch_culled``, optionally in a tightened z interval and as
one single-pass march); ``rc.reuse_coarse`` merges the coarse raws into the
fine composite; ``rc.fine_fraction < 1`` runs the fine pass on the rays of
highest coarse opacity only.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from neuralsim_tpu_torch import resolve_device
from neuralsim_tpu_torch.config import NeRFNetConfig, RenderConfig
from neuralsim_tpu_torch.kernels import raymarch
from neuralsim_tpu_torch.kernels.raymarch import as_dtype
from neuralsim_tpu_torch.models.nerf import query_points
from neuralsim_tpu_torch.models.ngp import is_hash_field
from neuralsim_tpu_torch.ops.occupancy import (
    empty_ray_outputs,
    ray_aabb_bounds,
    ray_hit_scores,
    ray_z_bounds,
)
from neuralsim_tpu_torch.ops.rays import get_rays, ndc_rays
from neuralsim_tpu_torch.ops.volume import (
    raw2outputs,
    raw2outputs_channels,
    sample_pdf,
    stratified_z_vals,
)
from neuralsim_tpu_torch.parallel.distributed import ModelShards
from neuralsim_tpu_torch.utils.profiling import span


def top_k_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores over the last axis, ties in
    ascending index order: the order of ``jax.lax.top_k``. A stable
    descending sort gives it on any device; ``torch.topk`` promises no
    order among equal values, and the cull scores are mostly ties (0/1
    floats, zero opacities)."""
    return torch.sort(scores, descending=True, stable=True).indices[..., :k]


def fine_ray_count(n_rays: int, fine_fraction: float) -> int:
    """The rays of the sparse fine pass (fine_fraction < 1) over a batch of
    n_rays: max(8, round(n_rays * fine_fraction)) rounded up to a multiple
    of 8, at most n_rays (neuralsim_tpu/ops/render.py)."""
    k_sel = max(8, int(round(n_rays * fine_fraction)))
    return min(n_rays, -(-k_sel // 8) * 8)


def render_rays(models, rays_o, rays_d, viewdirs, net: NeRFNetConfig,
                rc: RenderConfig, generator: Optional[torch.Generator] = None,
                near=None, far=None,
                uniforms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                pick_fine: Optional[Callable[[torch.Tensor], Tuple]] = None
                ) -> Dict[str, torch.Tensor]:
    """Render rays [N,3] with the coarse(+fine) pair.

    viewdirs: [N,3] unit directions (None when use_viewdirs=False).
    generator: draws the stratified jitter, the importance-sampling
    uniforms and the density noise when rc asks for them, in that order of
    use: u_z, the coarse noise, u_pdf, the fine noise.
    near, far: optional per-ray [N] overrides of rc.near / rc.far.
    uniforms: optional (u_z [N, n_samples], u_pdf [F, n_importance]), the
    stratified jitter and importance-sampling draws to use in place of the
    generator's (the JAX package's k_strat and k_pdf uniforms, in tests).
    noise: optional (coarse [N, n_samples], fine [F, n_samples +
    n_importance]) standard-normal density noise (rc.raw_noise_std > 0) in
    place of the generator's.
    F is the number of rays of the fine pass: N, or with rc.fine_fraction <
    1 the chosen rays, row j of a fine draw being the j-th chosen ray's (the
    shape and order in which the generator draws them, and the JAX package
    its k_pdf and k_noise1 draws).
    pick_fine: acc_map [N] -> (sel, rows), the rays of the sparse fine pass
    and the rows of the fine draws they take (None: all rows, in order). By
    default the ``fine_ray_count`` rays of highest coarse opacity (ties in
    index order); a data-parallel train step ranks the whole batch
    (``train_nerf.train_step``).

    Returns rgb_map/disp_map/acc_map/depth_map, plus rgb0/disp0/acc0 and
    z_std when n_importance > 0.

    ``rc.reuse_coarse`` keeps the coarse raws and marches the fine net on
    the importance depths only (``_fine_pass_reuse``); ``rc.fine_fraction
    < 1`` gives the fine pass to the rays of highest coarse opacity only,
    the others keep their coarse maps (and z_std 0).
    """
    n_rays = rays_o.shape[0]
    compute_dtype = as_dtype(rc.compute_dtype)
    u_z, u_pdf = uniforms if uniforms is not None else (None, None)
    noise_c, noise_f = noise if noise is not None else (None, None)
    z_vals = stratified_z_vals(
        n_rays, rc.n_samples,
        rc.near if near is None else near, rc.far if far is None else far,
        perturb=rc.perturb, lindisp=rc.lindisp, u=u_z, generator=generator,
        device=rays_o.device)
    use_reuse = rc.reuse_coarse and rc.n_importance > 0 and rc.fine_fraction >= 1.0
    if use_reuse:
        sigma_c, rgb3_c = _march_raw(models["coarse"], rays_o, rays_d, viewdirs,
                                     z_vals, net, rc, compute_dtype)
        rgb_map, disp_map, acc_map, weights, depth_map = raw2outputs_channels(
            sigma_c, rgb3_c, z_vals, rays_d, raw_noise_std=rc.raw_noise_std,
            white_bkgd=rc.white_bkgd, noise=noise_c, generator=generator)
    else:
        rgb_map, disp_map, acc_map, weights, depth_map = _march(
            models["coarse"], rays_o, rays_d, viewdirs, z_vals, net, rc,
            compute_dtype, generator, noise_c)

    out = {}
    if rc.n_importance > 0:
        out["rgb0"], out["disp0"], out["acc0"] = rgb_map, disp_map, acc_map
        if use_reuse:
            f_out = _fine_pass_reuse(models, rays_o, rays_d, viewdirs, z_vals,
                                     sigma_c, rgb3_c, weights, net, rc,
                                     compute_dtype, generator, u_pdf, noise_f)
        elif rc.fine_fraction < 1.0:
            if pick_fine is None:
                sel = top_k_indices(acc_map.detach(), fine_ray_count(n_rays, rc.fine_fraction))
                rows = None
            else:
                sel, rows = pick_fine(acc_map.detach())
            take = (lambda d: d) if rows is None else (lambda d: None if d is None else d[rows])
            f_sel = _fine_pass(models, rays_o[sel], rays_d[sel],
                               None if viewdirs is None else viewdirs[sel],
                               z_vals[sel], weights[sel], net, rc, compute_dtype,
                               generator, take(u_pdf), take(noise_f))
            f_out = {k: base.index_copy(0, sel, f_sel[k]) for k, base in (
                ("rgb_map", rgb_map), ("disp_map", disp_map), ("acc_map", acc_map),
                ("depth_map", depth_map), ("z_std", torch.zeros_like(acc_map)))}
        else:
            f_out = _fine_pass(models, rays_o, rays_d, viewdirs, z_vals, weights,
                               net, rc, compute_dtype, generator, u_pdf, noise_f)
        rgb_map, disp_map, acc_map, depth_map = (
            f_out["rgb_map"], f_out["disp_map"], f_out["acc_map"], f_out["depth_map"])
        out["z_std"] = f_out["z_std"]
    out.update(rgb_map=rgb_map, disp_map=disp_map, acc_map=acc_map,
               depth_map=depth_map)
    return out


def _kernel_route(rays_o, net: NeRFNetConfig, rc: RenderConfig) -> bool:
    """Whether a march goes through a CUDA kernel: on the card with
    ``rc.use_pallas``, for a net with view directions and an encoding. A net
    without either marches through the plain ``query_points`` +
    ``raw2outputs`` on any device, as the JAX package's ``_march`` does."""
    return (raymarch.uses_kernel(rays_o) and rc.use_pallas and net.use_viewdirs
            and net.i_embed != -1)


def _plain_raw(params, rays_o, rays_d, viewdirs, z_vals, net: NeRFNetConfig,
               rc: RenderConfig, compute_dtype):
    """raw [N,S,4] through query_points: the point-major kernel on the
    card (rc.use_pallas), the plain encoding and MLP otherwise."""
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
    return query_points(params, pts, viewdirs, net, compute_dtype,
                        use_pallas=rc.use_pallas, pe_projection=rc.pe_projection)


def _hash_march(params, rays_o, rays_d, viewdirs, z_vals, net: NeRFNetConfig,
                rc: RenderConfig, compute_dtype, fused: bool):
    """The hash-grid ray march of a kernel-route march: (sigma, rgb3).
    ``fused``: whether the march would composite in the render tile."""
    for route, taken in (("fuse_compositing=True (fused_render_tile)", fused),
                         ("fuse_pointgen=False (the point-major kernels)",
                          not rc.fuse_pointgen)):
        if taken:
            raise NotImplementedError(f"render: the route {route} takes no hash-grid field; "
                                      "it marches through fused_ngp_march only")
    return raymarch.fused_ngp_march(params, rays_o, rays_d, viewdirs, z_vals, net,
                                    compute_dtype)


def _march(params, rays_o, rays_d, viewdirs, z_vals, net: NeRFNetConfig,
           rc: RenderConfig, compute_dtype, generator=None, noise=None):
    """One network march + compositing; returns the raw2outputs tuple.
    ``noise``: the density noise [N,S] to use in place of the generator's."""
    if _kernel_route(rays_o, net, rc):
        if is_hash_field(net):
            sigma, rgb3 = _hash_march(params, rays_o, rays_d, viewdirs, z_vals, net, rc,
                                      compute_dtype,
                                      rc.fuse_compositing and rc.raw_noise_std == 0.0)
            return raw2outputs_channels(
                sigma, rgb3, z_vals, rays_d, raw_noise_std=rc.raw_noise_std,
                white_bkgd=rc.white_bkgd, noise=noise, generator=generator)
        if rc.fuse_compositing and rc.raw_noise_std == 0.0:
            return raymarch.fused_render_tile(
                params, rays_o, rays_d, viewdirs, z_vals, net,
                white_bkgd=rc.white_bkgd, compute_dtype=compute_dtype)
        if rc.fuse_pointgen:
            sigma, rgb3 = raymarch.fused_nerf_march(
                params, rays_o, rays_d, viewdirs, z_vals, net, compute_dtype)
            return raw2outputs_channels(
                sigma, rgb3, z_vals, rays_d, raw_noise_std=rc.raw_noise_std,
                white_bkgd=rc.white_bkgd, noise=noise, generator=generator)
    raw = _plain_raw(params, rays_o, rays_d, viewdirs, z_vals, net, rc, compute_dtype)
    return raw2outputs(raw, z_vals, rays_d, raw_noise_std=rc.raw_noise_std,
                       white_bkgd=rc.white_bkgd, noise=noise, generator=generator)


def _march_raw(params, rays_o, rays_d, viewdirs, z_vals, net: NeRFNetConfig,
               rc: RenderConfig, compute_dtype):
    """Channel-separated raw field along rays without compositing:
    (sigma [N,S], rgb3 [3,N,S]); the march kernel when _march would take
    it, else query_points."""
    if _kernel_route(rays_o, net, rc) and is_hash_field(net):
        return _hash_march(params, rays_o, rays_d, viewdirs, z_vals, net, rc, compute_dtype,
                           False)
    if _kernel_route(rays_o, net, rc) and rc.fuse_pointgen:
        return raymarch.fused_nerf_march(params, rays_o, rays_d, viewdirs,
                                         z_vals, net, compute_dtype)
    raw = _plain_raw(params, rays_o, rays_d, viewdirs, z_vals, net, rc, compute_dtype)
    return raw[..., 3], torch.movedim(raw[..., :3], -1, 0)


def _fine_pass(models, rays_o, rays_d, viewdirs, z_vals, weights,
               net: NeRFNetConfig, rc: RenderConfig, compute_dtype,
               generator=None, u_pdf=None, noise=None):
    """Importance sampling (draws ``u_pdf`` when given) + fine-network
    march + compositing (density ``noise`` when given)."""
    z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    z_samples = sample_pdf(z_mid, weights[..., 1:-1], rc.n_importance,
                           det=not rc.perturb, u=u_pdf, generator=generator).detach()
    z_all = torch.sort(torch.cat([z_vals, z_samples], dim=-1), dim=-1).values
    fine_params = models.get("fine") or models["coarse"]
    rgb_map, disp_map, acc_map, _, depth_map = _march(
        fine_params, rays_o, rays_d, viewdirs, z_all, net, rc, compute_dtype,
        generator, noise)
    return {"rgb_map": rgb_map, "disp_map": disp_map, "acc_map": acc_map,
            "depth_map": depth_map,
            "z_std": torch.std(z_samples, dim=-1, correction=0)}


def _fine_pass_reuse(models, rays_o, rays_d, viewdirs, z_vals, sigma_c, rgb3_c,
                     weights, net: NeRFNetConfig, rc: RenderConfig, compute_dtype,
                     generator=None, u_pdf=None, noise=None):
    """Fine pass that reuses the coarse raws (rc.reuse_coarse): the fine
    net marches the importance depths only, and the composite runs over
    the depth-sorted union of (coarse z, coarse raw) and (fine z, fine
    raw). The JAX package's lax.sort with the raws as payload becomes a
    stable sort of the depths and a gather of each payload."""
    z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    z_samples = sample_pdf(z_mid, weights[..., 1:-1], rc.n_importance,
                           det=not rc.perturb, u=u_pdf, generator=generator).detach()
    fine_params = models.get("fine") or models["coarse"]
    sigma_f, rgb3_f = _march_raw(fine_params, rays_o, rays_d, viewdirs, z_samples,
                                 net, rc, compute_dtype)
    z_all, order = torch.sort(torch.cat([z_vals, z_samples], dim=-1), dim=-1, stable=True)
    sig_all = torch.gather(torch.cat([sigma_c, sigma_f], dim=-1), -1, order)
    rgb_all = torch.gather(torch.cat([rgb3_c, rgb3_f], dim=-1), -1,
                           order.expand(3, *order.shape))
    rgb_map, disp_map, acc_map, _, depth_map = raw2outputs_channels(
        sig_all, rgb_all, z_all, rays_d, raw_noise_std=rc.raw_noise_std,
        white_bkgd=rc.white_bkgd, noise=noise, generator=generator)
    return {"rgb_map": rgb_map, "disp_map": disp_map, "acc_map": acc_map,
            "depth_map": depth_map,
            "z_std": torch.std(z_samples, dim=-1, correction=0)}


def render_ray_batch(models, rays_o, rays_d, net: NeRFNetConfig,
                     rc: RenderConfig, generator: Optional[torch.Generator] = None,
                     grid=None) -> Dict[str, torch.Tensor]:
    """Render a flat ray batch [N,3] in tiles of rc.ray_chunk rays.

    With an OccupancyGrid and rc.hit_budget < 1 the rays are culled first
    (``_render_ray_batch_culled``): only a top-k budget of rays, ranked by
    their grid score, is rendered, and the others get the analytic empty
    outputs; the output then also holds the scalars ``occ_hit_count`` (rays
    that hit the grid) and ``occ_budget`` (rays rendered).

    Tensor-parallel params (``parallel.distributed.nerf_param_sharding``)
    are all-gathered into whole layers first: the kernels take whole
    layers.
    """
    if isinstance(models, ModelShards):
        models = models.whole_layers()
    if grid is not None and rc.hit_budget < 1.0:
        if is_hash_field(net) and _kernel_route(rays_o, net, rc):
            raise NotImplementedError("render: the occupancy-culled production route takes no "
                                      "hash-grid field; render it exact (test_mode())")
        return _render_ray_batch_culled(models, grid, rays_o, rays_d, net, rc, generator)
    return _render_ray_batch_dense(models, rays_o, rays_d, net, rc, generator)


def _render_ray_batch_culled(models, grid, rays_o, rays_d, net: NeRFNetConfig,
                             rc: RenderConfig, generator=None):
    """Score, select the top k_sel rays (ties in index order, as
    jax.lax.top_k), render them, scatter into the empty outputs. With
    rc.tighten_bounds the routed rays sample their occupied z interval at
    rc.n_samples_culled coarse samples, and rc.n_importance_culled sets
    their fine count (0: one single-pass march, None: rc.n_importance)."""
    n = rays_o.shape[0]
    if rc.cull_mode == "aabb":
        # closed-form slab test against the occupied box, intervals widened
        # by 2 probe steps like the grid prober's margin_samples
        z_margin = 2.0 * (rc.far - rc.near) / rc.n_samples
        hit, near_all, far_all = ray_aabb_bounds(grid, rays_o, rays_d, rc.near, rc.far,
                                                 z_margin=z_margin)
        scores = hit.to(torch.float32)
    else:
        # deterministic per-sample voxel probes; stratified jitter is
        # covered by the grid's dilation
        z_probe = stratified_z_vals(n, rc.n_samples, rc.near, rc.far, perturb=False,
                                    lindisp=rc.lindisp, device=rays_o.device)
        scores = ray_hit_scores(grid, rays_o, rays_d, z_probe)
    k_sel = int(round(n * rc.hit_budget))
    k_sel = max(8, min(n, -(-k_sel // 8) * 8))
    sel = top_k_indices(scores.detach(), k_sel)

    near = far = None
    rc_sel = rc
    if rc.tighten_bounds:
        if rc.cull_mode != "aabb":
            near_all, far_all = ray_z_bounds(grid, rays_o, rays_d, z_probe)
        near, far = near_all[sel], far_all[sel]
        overrides = {}
        if rc.n_samples_culled:
            overrides["n_samples"] = rc.n_samples_culled
        if rc.n_importance_culled is not None and rc.n_importance > 0:
            overrides["n_importance"] = rc.n_importance_culled
        rc_sel = dataclasses.replace(rc, **overrides)

    out_sel = _render_ray_batch_dense(models, rays_o[sel], rays_d[sel], net, rc_sel,
                                      generator, near=near, far=far)
    # only the keys the routed render has: a single pass has no coarse maps
    empty = empty_ray_outputs(n, rc, device=rays_o.device)
    out = {k: empty[k].index_copy(0, sel, v) for k, v in out_sel.items()}
    out["occ_hit_count"] = (scores > 0).sum().to(torch.int32)
    out["occ_budget"] = torch.tensor(k_sel, dtype=torch.int32, device=rays_o.device)
    return out


def _pad_rows(x: torch.Tensor, n_target: int) -> torch.Tensor:
    """x [m, ...] padded to n_target rows by repeating its last row."""
    pad = n_target - x.shape[0]
    if pad == 0:
        return x
    return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])], dim=0)


def _checkpointed(fn, generator, *args):
    """``fn(*args)`` under torch.utils.checkpoint: its activations are
    recomputed in the backward instead of kept. The recompute draws what
    the first run drew: checkpoint restores only torch's default
    generators, so the state of ``generator`` is captured here and set for
    the recompute (and restored after it)."""
    if generator is None:
        return checkpoint(fn, *args, use_reentrant=False)
    state = generator.get_state()
    first = [True]

    def run(*a):
        if first[0]:
            first[0] = False
            return fn(*a)
        after = generator.get_state()
        generator.set_state(state)
        try:
            return fn(*a)
        finally:
            generator.set_state(after)

    return checkpoint(run, *args, use_reentrant=False)


def _render_ray_batch_dense(models, rays_o, rays_d, net: NeRFNetConfig,
                            rc: RenderConfig, generator=None, near=None, far=None):
    """The chunk loop: a Python loop over tiles of rc.ray_chunk rays
    replaces the JAX package's lax.map. near, far: optional per-ray [N]
    bounds.

    The last tile is simply shorter where rays are independent, and the N
    outputs are those of the padded JAX version. The sparse fine pass ranks
    rays within a tile, so with fine_fraction < 1 the last tile is padded
    as the JAX package pads it, by repeating its last ray.

    ``rc.remat`` with autograd recording wraps each tile in a checkpoint
    (the JAX package's jax.checkpoint per tile): a backward keeps one
    tile's activations at a time. Under no_grad it changes nothing."""
    n = rays_o.shape[0]
    chunk = min(rc.ray_chunk, n) if n > 0 else rc.ray_chunk
    pad_tail = rc.fine_fraction < 1.0 and rc.n_importance > 0
    remat = rc.remat and torch.is_grad_enabled()
    viewdirs = None
    if net.use_viewdirs:
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    chunks = []
    for start in range(0, n, chunk):
        sl = slice(start, start + chunk)
        tile = [None if t is None else t[sl] for t in (rays_o, rays_d, viewdirs, near, far)]
        m = tile[0].shape[0]
        if pad_tail:
            tile = [None if t is None else _pad_rows(t, chunk) for t in tile]
        with span("render.chunk"):
            if remat:
                out = _checkpointed(
                    lambda o, d, vd, nr, fr: render_rays(models, o, d, vd, net, rc, generator,
                                                         near=nr, far=fr),
                    generator, *tile)
            else:
                out = render_rays(models, tile[0], tile[1], tile[2], net, rc, generator,
                                  near=tile[3], far=tile[4])
        chunks.append({k: v[:m] for k, v in out.items()})
    return {k: torch.cat([c[k] for c in chunks], dim=0) for k in chunks[0]}


def _reshape_maps(out: Dict[str, torch.Tensor], lead) -> Dict[str, torch.Tensor]:
    """Maps to [*lead, ...]; the occ_* diagnostics stay scalars."""
    return {k: v if k.startswith("occ_") else v.reshape(tuple(lead) + tuple(v.shape[1:]))
            for k, v in out.items()}


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


def img2mse(x, y) -> torch.Tensor:
    """Mean squared error (reference run_nerf_helpers.py:10)."""
    return torch.mean((x - y) ** 2)


def mse2psnr(x) -> torch.Tensor:
    """PSNR in dB of a mean squared error (reference run_nerf_helpers.py:11)."""
    x = torch.as_tensor(x)
    return -10.0 * torch.log(x) / torch.log(torch.tensor(10.0, dtype=x.dtype))


def to8b(x) -> np.ndarray:
    """float [0,1] -> uint8 (reference run_nerf_helpers.py:14)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return (255 * np.clip(np.asarray(x), 0, 1)).astype(np.uint8)
