"""Occupancy-grid empty-space skipping (JAX counterpart
``neuralsim_tpu/ops/occupancy.py``).

A conservative binary occupancy grid is built once per scene from the
coarse density field. Rays are scored against it, either by a closed-form
slab test against the occupied voxels' box (``cull_mode="aabb"``) or by
counting their coarse sample points in occupied voxels (``"grid"``); only a
top-k budget of rays goes through the renderer, the rest get the analytic
all-empty compositing outputs (``ops/render.py:_render_ray_batch_culled``).

Everything here is plain PyTorch, as it is plain XLA in the JAX package:
the density probes run ``make_sigma_fn`` (``query_points`` without the
kernels). A grid lives on the device it was built for, and the scoring
functions run on the device of the tensors they are given.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from neuralsim_tpu_torch import resolve_device
from neuralsim_tpu_torch.ops.rays import get_rays
from neuralsim_tpu_torch.ops.volume import stratified_z_vals


class OccupancyGrid(NamedTuple):
    occ: torch.Tensor        # [R, R, R] float32 in {0, 1}
    bbox_min: torch.Tensor   # [3]
    bbox_max: torch.Tensor   # [3]


def _probe(sigma_fn: Callable, pts: torch.Tensor, chunk: int) -> torch.Tensor:
    """sigma_fn over [M, 3] points in chunks of ``chunk``: [M] densities."""
    with torch.no_grad():
        return torch.cat([sigma_fn(pts[i:i + chunk]) for i in range(0, pts.shape[0], chunk)])


def _meshgrid_points(xs, ys, zs) -> torch.Tensor:
    return torch.stack(torch.meshgrid(xs, ys, zs, indexing="ij"), -1).reshape(-1, 3)


def build_occupancy_grid(sigma_fn: Callable, bbox_min, bbox_max,
                         resolution: int = 96, threshold: float = 1e-2,
                         dilate: int = 2, subsamples: int = 2,
                         chunk: int = 131072, device=None) -> OccupancyGrid:
    """Conservative occupancy from a density field.

    sigma_fn: [N, 3] positions -> [N] raw density (the coarse NeRF's alpha
    head, ``models.nerf.make_sigma_fn``). A voxel is occupied when any of
    its ``subsamples``^3 cell-centred probes has sigma > threshold; the
    grid is then dilated ``dilate`` times by a 6-neighbour max. The grid is
    built on ``device`` (``cuda`` when None).
    """
    device = resolve_device(device)
    bbox_min = torch.as_tensor(bbox_min, dtype=torch.float32).to(device)
    bbox_max = torch.as_tensor(bbox_max, dtype=torch.float32).to(device)
    r = resolution
    vox = (bbox_max - bbox_min) / r

    # probe lattice: subsamples^3 offsets per voxel, cell-centred
    ax = (torch.arange(r, device=device)[:, None]
          + (torch.arange(subsamples, device=device) + 0.5) / subsamples).reshape(-1)
    n_ax = r * subsamples
    pts = _meshgrid_points(bbox_min[0] + ax * vox[0], bbox_min[1] + ax * vox[1],
                           bbox_min[2] + ax * vox[2])
    sig = _probe(sigma_fn, pts, chunk).reshape(n_ax, n_ax, n_ax)

    occ = sig.reshape(r, subsamples, r, subsamples, r, subsamples)
    occ = (occ.amax(dim=(1, 3, 5)) > threshold).to(torch.float32)
    for _ in range(dilate):
        # torch.roll wraps around at the faces, which only adds occupancy
        occ = torch.maximum(occ, torch.maximum(
            torch.maximum(torch.roll(occ, 1, 0), torch.roll(occ, -1, 0)),
            torch.maximum(
                torch.maximum(torch.roll(occ, 1, 1), torch.roll(occ, -1, 1)),
                torch.maximum(torch.roll(occ, 1, 2), torch.roll(occ, -1, 2)))))
    return OccupancyGrid(occ, bbox_min, bbox_max)


def scene_half_extent(radius: float, far: float,
                      H: int = None, W: int = None, K=None) -> float:
    """Half extent of a probe cube that holds every sample point of a
    look-at-origin rig at ``radius``: a sample at depth t through pixel
    tangents (u, v) lies at dist^2 = (radius - t)^2 + t^2 (u^2 + v^2) from
    the origin, convex in t, so t = far and t = 0 bound it. With
    intrinsics, u and v come from the sensor corners; without, u = v = 1."""
    if K is not None and H is not None and W is not None:
        K = [[float(v) for v in row] for row in torch.as_tensor(K).tolist()]
        u = max(K[0][2], (W - 1) - K[0][2]) / K[0][0]
        v = max(K[1][2], (H - 1) - K[1][2]) / K[1][1]
        m = u * u + v * v
    else:
        m = 2.0
    return math.sqrt(max((radius - far) ** 2 + far * far * m, radius * radius))


def derive_scene_bbox(sigma_fn: Callable, half_extent: float,
                      resolution: int = 96, threshold: float = 1e-2,
                      margin_voxels: int = 2, chunk: int = 131072, device=None):
    """The box of the voxels with sigma > threshold on a ``resolution``^3
    lattice over [-half_extent, half_extent]^3, widened by
    ``margin_voxels``; the whole cube when no voxel passes. Returns
    (bbox_min [3], bbox_max [3]) float32 on ``device`` (``cuda`` when None).
    """
    device = resolve_device(device)
    he = float(half_extent)
    r = resolution
    ax = (torch.arange(r, dtype=torch.float32, device=device) + 0.5) / r * (2 * he) - he
    occ = _probe(sigma_fn, _meshgrid_points(ax, ax, ax), chunk).reshape(r, r, r) > threshold

    vox = 2 * he / r
    if not bool(occ.any()):
        full = torch.full((3,), -he, dtype=torch.float32, device=device)
        return full, -full
    idx = torch.arange(r, device=device)
    los, his = [], []
    for axis in range(3):
        proj = occ.any(dim=tuple(i for i in range(3) if i != axis))
        los.append(idx[proj].min())
        his.append(idx[proj].max())
    lo = torch.stack(los) - margin_voxels
    hi = torch.stack(his) + 1 + margin_voxels
    bbox_min = -he + torch.clamp(lo, 0, r).to(torch.float32) * vox
    bbox_max = -he + torch.clamp(hi, 0, r).to(torch.float32) * vox
    return bbox_min, bbox_max


def build_scene_grid(sigma_fn: Callable, half_extent: float,
                     resolution: int = 96, threshold: float = 1e-2,
                     dilate: int = 2, device=None) -> OccupancyGrid:
    """derive_scene_bbox, then build_occupancy_grid over that box: the one
    grid-construction path of the renderer and the benchmarks."""
    bbox_min, bbox_max = derive_scene_bbox(sigma_fn, half_extent, threshold=threshold,
                                           device=device)
    return build_occupancy_grid(sigma_fn, bbox_min, bbox_max, resolution=resolution,
                                threshold=threshold, dilate=dilate, device=device)


def grid_lookup(grid: OccupancyGrid, pts: torch.Tensor) -> torch.Tensor:
    """Occupancy at [..., 3] positions; 0 outside [bbox_min, bbox_max)."""
    r = grid.occ.shape[0]
    vox = (grid.bbox_max - grid.bbox_min) / r
    rel = (pts - grid.bbox_min) / vox
    # clamping before the cast equals clipping the cast index, and keeps
    # far-away points inside the integer range
    idx = torch.clamp(torch.floor(rel), 0, r - 1).to(torch.long)
    inside = ((pts >= grid.bbox_min) & (pts < grid.bbox_max)).all(dim=-1)
    flat = (idx[..., 0] * r + idx[..., 1]) * r + idx[..., 2]
    vals = grid.occ.reshape(-1)[flat]
    return vals * inside.to(vals.dtype)


def _sample_points(rays_o, rays_d, z_vals):
    return rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]


def ray_hit_scores(grid: OccupancyGrid, rays_o, rays_d, z_vals) -> torch.Tensor:
    """Per-ray count [N] of the sample points at depths z_vals [N, S] that
    lie in occupied voxels; 0 means the ray hits nothing the grid holds."""
    return grid_lookup(grid, _sample_points(rays_o, rays_d, z_vals)).sum(dim=-1)


def ray_z_bounds(grid: OccupancyGrid, rays_o, rays_d, z_vals,
                 margin_samples: int = 2):
    """Per-ray (near [N], far [N]): the depths of the first and last probe
    in an occupied voxel, widened by ``margin_samples`` probe steps; rays
    with no occupied probe keep [z_0, z_-1]."""
    hit = grid_lookup(grid, _sample_points(rays_o, rays_d, z_vals)) > 0   # [N, S]
    s = z_vals.shape[-1]
    idx = torch.arange(s, device=z_vals.device)
    any_hit = hit.any(dim=-1)
    first = torch.where(hit, idx, s - 1).amin(dim=-1)
    last = torch.where(hit, idx, 0).amax(dim=-1)
    first = torch.clamp(first - margin_samples, min=0)
    last = torch.clamp(last + margin_samples, max=s - 1)

    def take(i):
        return torch.gather(z_vals, -1, i[:, None])[:, 0]

    near = torch.where(any_hit, take(first), z_vals[:, 0])
    far = torch.where(any_hit, take(last), z_vals[:, -1])
    return near, far


def occupied_aabb(grid: OccupancyGrid):
    """The voxel-aligned box of the occupied voxels (not the grid's
    domain). An all-empty grid gives a zero-volume box at the domain
    corner, which no generic ray hits; an inverted box would not do, since
    the slab test treats each pair of planes as unordered."""
    r = grid.occ.shape[0]
    vox = (grid.bbox_max - grid.bbox_min) / r
    occ_any = grid.occ > 0
    idx = torch.arange(r, device=grid.occ.device)
    los, his = [], []
    for axis in range(3):
        proj = occ_any.any(dim=tuple(i for i in range(3) if i != axis))
        los.append(torch.where(proj, idx, r).amin())
        his.append(torch.where(proj, idx, -1).amax() + 1)
    lo = torch.stack(los).to(torch.float32)
    hi = torch.stack(his).to(torch.float32)
    # all-empty: lo = r, hi = 0 -> the point box [min, min]
    lo = torch.minimum(lo, hi)
    return grid.bbox_min + lo * vox, grid.bbox_min + hi * vox


def ray_aabb_bounds(grid: OccupancyGrid, rays_o, rays_d,
                    near: float, far: float, z_margin: float = 0.0):
    """Slab test of each ray against ``occupied_aabb(grid)``:
    (hit [N] bool, t_near [N], t_far [N]).

    Conservative: every occupied voxel lies in the box, so a ray that meets
    density hits it. The interval is widened by ``z_margin`` and clipped to
    [near, far]; misses keep (near, far).
    """
    bmin, bmax = occupied_aabb(grid)
    eps = 1e-12
    d = torch.where(rays_d.abs() < eps,
                    torch.where(rays_d < 0, -eps, eps).to(rays_d.dtype), rays_d)
    inv = 1.0 / d
    t0 = (bmin - rays_o) * inv
    t1 = (bmax - rays_o) * inv
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    hit = (tmax >= tmin) & (tmax > near) & (tmin < far)
    t_near = torch.clamp(tmin - z_margin, near, far)
    t_far = torch.clamp(tmax + z_margin, near, far)
    t_near = torch.where(hit, t_near, torch.full_like(t_near, near))
    t_far = torch.where(hit, t_far, torch.full_like(t_far, far))
    return hit, t_near, t_far


def calibrate_hit_budget(grid: OccupancyGrid, poses, H: int, W: int, K,
                         rc, margin: float = 1.25,
                         quantum: float = 0.05) -> float:
    """A hit budget that covers the worst-case fraction of rays hitting the
    grid over the poses [P, 4, 4], times ``margin``, rounded up to
    ``quantum`` and at most 1. Scores with the scorer the render uses
    (rc.cull_mode). Runs on the grid's device."""
    poses = torch.as_tensor(poses, dtype=torch.float32).to(grid.occ.device)
    mode = getattr(rc, "cull_mode", "aabb")

    def frac_one(c2w):
        ro, rd = (t.reshape(-1, 3) for t in get_rays(H, W, K, c2w[:3, :4]))
        if mode == "aabb":
            hit = ray_aabb_bounds(grid, ro, rd, rc.near, rc.far)[0]
        else:
            z = stratified_z_vals(ro.shape[0], rc.n_samples, rc.near, rc.far,
                                  perturb=False, lindisp=rc.lindisp, device=ro.device)
            hit = ray_hit_scores(grid, ro, rd, z) > 0
        return float(hit.to(torch.float32).mean())

    with torch.no_grad():
        worst = max(frac_one(poses[i]) for i in range(poses.shape[0]))
    budget = min(1.0, worst * margin)
    return min(1.0, -(-budget // quantum) * quantum)


def empty_ray_outputs(n: int, rc, device=None) -> dict:
    """What raw2outputs gives a ray with zero density everywhere: rgb 0 (1
    with a white background), depth 0, acc 0, disp 1/max(1e-10, 0) = 1e10;
    plus the coarse maps and z_std when n_importance > 0."""
    f32 = dict(dtype=torch.float32, device=device)
    rgb = torch.ones((n, 3), **f32) if rc.white_bkgd else torch.zeros((n, 3), **f32)
    zero = torch.zeros((n,), **f32)
    out = {"rgb_map": rgb, "disp_map": torch.full((n,), 1e10, **f32),
           "acc_map": zero, "depth_map": zero}
    if rc.n_importance > 0:
        out.update(rgb0=rgb, disp0=torch.full((n,), 1e10, **f32), acc0=zero, z_std=zero)
    return out
