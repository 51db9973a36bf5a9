"""Instant-NGP's NeRF field (Müller, Evans, Schied, Keller, SIGGRAPH 2022,
arXiv 2201.05989; NVlabs instant-ngp ``configs/nerf/base.json``) and its
exact hierarchical render, in plain float32 PyTorch: the reference of the
cell ``render.ngp.exact_f32.k50``. It imports nothing of the program; the
sampling and compositing are ``volume.py``'s, the rays ``rays.py``'s.

The field, per point x (``HashGrid`` holds the settings):

- u = (x - lo) / (hi - lo) in the box; outside [0, 1]^3 the density is 0
  and the colour is computed from u clamped into the box;
- L levels at N_l = floor(N_min (N_max / N_min)^(l / (L - 1))) (float64;
  16, 22, ..., 1482, 2048); at each, the cell i = min(floor(u N_l), N_l - 1)
  and f = u N_l - i, and the F-vectors of its 8 corners weighted
  trilinearly and summed, corner k at i + (bits 0, 1, 2 of k). A level
  whose (N_l + 1)^3 corners fit T = 2^log2_hashmap_size entries is dense
  (row x + y (N_l + 1) + z (N_l + 1)^2); the others hash, (x * 1 xor y *
  2654435761 xor z * 805459861) mod 2^32 mod T. The levels' features,
  level 0 first, are the encoding;
- degree-4 real spherical harmonics of the unit view direction, with
  tiny-cuda-nn's constants, each coefficient one formula of x, y, z
  (tiny-cuda-nn writes the last of degree 2 as C xx - C yy, here
  C (xx - yy));
- density MLP enc -> 64 (ReLU) -> 16, sigma = exp(out_0); colour MLP
  [out, sh] -> 64 (ReLU) -> 64 (ReLU) -> 3 logits; no biases.

Departures from the published method: the render samples 64 stratified
and 128 importance depths a ray (Neural-Sim's exact pass) where
Instant-NGP marches an occupancy grid; one field serves both passes, as
Instant-NGP has one field; everything runs in float32 where Instant-NGP
trains and renders in half precision. ``arithmetic("tf32")`` is the
control one precision below.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from bench_port.reference.common import draw
from bench_port.reference.rays import get_rays
from bench_port.reference.volume import raw2outputs, sample_pdf, stratified_z_vals

Params = Dict[str, torch.Tensor]

HASH_PRIMES = (1, 2654435761, 805459861)
SH_C0 = 0.28209479177387814
SH_C1 = 0.48860251190291987
SH_C2 = (1.0925484305920792, 0.94617469575755997, 0.31539156525251999, 0.54627421529603959)
SH_C3 = (0.59004358992664352, 2.8906114426405538, 0.45704579946446572, 0.3731763325901154,
         1.4453057213202769)


@dataclass(frozen=True)
class HashGrid:
    """The field's settings (the configuration file's ``hash`` section)."""

    hash_levels: int = 16
    hash_features: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    finest_resolution: int = 2048
    hash_aabb: Tuple[float, float] = (-1.0, 1.0)
    density_width: int = 64
    density_out: int = 16
    color_width: int = 64
    color_depth: int = 2
    sh_degree: int = 4


def grid_of(section: dict) -> HashGrid:
    return HashGrid(**{k: tuple(v) if isinstance(v, list) else v for k, v in section.items()})


def level_resolutions(g: HashGrid) -> List[int]:
    if g.hash_levels == 1:
        return [g.base_resolution]
    ratio = g.finest_resolution / g.base_resolution
    return [math.floor(g.base_resolution * ratio ** (lv / (g.hash_levels - 1)))
            for lv in range(g.hash_levels)]


def levels(g: HashGrid) -> List[Tuple[int, int, int, bool]]:
    """(resolution, first row, rows, dense) of each level."""
    t = 1 << g.log2_hashmap_size
    out, first = [], 0
    for n in level_resolutions(g):
        dense = (n + 1) ** 3 <= t
        rows = (n + 1) ** 3 if dense else t
        out.append((n, first, rows, dense))
        first += rows
    return out


def rows_of(g: HashGrid) -> int:
    n, first, rows, _ = levels(g)[-1]
    return first + rows


def kernel_shapes(g: HashGrid) -> Dict[str, Tuple[int, int]]:
    shapes = {"density_0_kernel": (g.hash_levels * g.hash_features, g.density_width),
              "density_1_kernel": (g.density_width, g.density_out)}
    width = g.density_out + g.sh_degree ** 2
    for i in range(g.color_depth):
        shapes[f"color_{i}_kernel"] = (width, g.color_width)
        width = g.color_width
    shapes[f"color_{g.color_depth}_kernel"] = (width, 3)
    return shapes


def _rows(corner: torch.Tensor, n: int, rows: int, dense: bool) -> torch.Tensor:
    """Rows of integer corners [M, 3] (int64) within one level."""
    x, y, z = corner.unbind(-1)
    if dense:
        return x + (n + 1) * (y + (n + 1) * z)
    mixed = (x * HASH_PRIMES[0]) ^ (y * HASH_PRIMES[1]) ^ (z * HASH_PRIMES[2])
    return torch.remainder(mixed, 1 << 32) % rows


def encode(table: torch.Tensor, u: torch.Tensor, g: HashGrid) -> torch.Tensor:
    """[M, L F] features of unit coordinates u [M, 3]."""
    out = []
    for n, first, rows, dense in levels(g):
        scaled = u * n
        cell = torch.minimum(torch.floor(scaled), torch.full_like(scaled, n - 1)).detach()
        frac = scaled - cell
        lower = cell.to(torch.int64)
        level = torch.zeros((u.shape[0], g.hash_features), dtype=u.dtype, device=u.device)
        for k in range(8):
            bits = torch.tensor([k & 1, (k >> 1) & 1, (k >> 2) & 1], device=u.device)
            weight = torch.where(bits.bool(), frac, 1.0 - frac)
            weight = weight[:, 0] * weight[:, 1] * weight[:, 2]
            level = level + weight[:, None] * table[first + _rows(lower + bits, n, rows, dense)]
        out.append(level)
    return torch.cat(out, dim=-1)


def spherical_harmonics(d: torch.Tensor, degree: int) -> torch.Tensor:
    """[M, degree^2] real SH of unit directions d [M, 3], degree <= 4."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    xx, yy, zz = x * x, y * y, z * z
    coeffs = [torch.full_like(x, SH_C0),
              -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
              SH_C2[0] * x * y, -SH_C2[0] * y * z, SH_C2[1] * zz - SH_C2[2],
              -SH_C2[0] * x * z, SH_C2[3] * (xx - yy),
              SH_C3[0] * y * (yy - 3.0 * xx), SH_C3[1] * x * y * z,
              SH_C3[2] * y * (1.0 - 5.0 * zz), SH_C3[3] * z * (5.0 * zz - 3.0),
              SH_C3[2] * x * (1.0 - 5.0 * zz), SH_C3[4] * z * (xx - yy),
              SH_C3[0] * x * (3.0 * yy - xx)]
    return torch.stack(coeffs[:degree * degree], dim=-1)


def field(params: Params, x: torch.Tensor, d: torch.Tensor, g: HashGrid) -> torch.Tensor:
    """raw [M, 4] (rgb logits, sigma) at points x [M, 3] from unit
    directions d [M, 3]."""
    lo, hi = g.hash_aabb
    u = (x - lo) / (hi - lo)
    inside = torch.logical_and(u >= 0.0, u <= 1.0).all(dim=-1)
    enc = encode(params["hash_table"], torch.clamp(u, 0.0, 1.0), g)
    hidden = torch.relu(torch.matmul(enc, params["density_0_kernel"]))
    out = torch.matmul(hidden, params["density_1_kernel"])
    sigma = torch.where(inside, torch.exp(out[:, 0]), torch.zeros_like(out[:, 0]))
    h = torch.cat([out, spherical_harmonics(d, g.sh_degree)], dim=-1)
    for i in range(g.color_depth):
        h = torch.relu(torch.matmul(h, params[f"color_{i}_kernel"]))
    rgb = torch.matmul(h, params[f"color_{g.color_depth}_kernel"])
    return torch.cat([rgb, sigma[:, None]], dim=-1)


def bench_params(g: HashGrid, table_scale: float, generator: Optional[torch.Generator] = None,
                 device="cpu") -> Params:
    """The benchmark's seeded weights: the table U(-table_scale,
    table_scale) on every level alike, each kernel He-scaled, U(+-sqrt(6 /
    in)) (variance 2 / in)."""
    params = {"hash_table": (2.0 * draw((rows_of(g), g.hash_features), generator, device)
                             - 1.0) * table_scale}
    for key, (fan_in, fan_out) in kernel_shapes(g).items():
        params[key] = (2.0 * draw((fan_in, fan_out), generator, device) - 1.0) \
            * math.sqrt(6.0 / fan_in)
    return params


def _march(params, rays_o, rays_d, viewdirs, z_vals, g: HashGrid):
    n, s = z_vals.shape
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    dirs = viewdirs[:, None, :].expand(n, s, 3)
    raw = field(params, pts.reshape(-1, 3), dirs.reshape(-1, 3), g).reshape(n, s, 4)
    return raw2outputs(raw, z_vals, rays_d)


def render_rays(params: Params, rays_o, rays_d, viewdirs, g: HashGrid, rc):
    """The exact render of rays [N,3] (rc: the reference's RenderConfig,
    without jitter or noise): the coarse march at rc.n_samples depths,
    rc.n_importance depths drawn from its weights, the fine march of the
    same field at all of them. rgb_map/disp_map/acc_map/depth_map, and
    rgb0 with importance samples."""
    z_vals = stratified_z_vals(rays_o.shape[0], rc.n_samples, rc.near, rc.far, perturb=False,
                               lindisp=rc.lindisp, device=rays_o.device)
    rgb, disp, acc, weights, depth = _march(params, rays_o, rays_d, viewdirs, z_vals, g)
    out = {}
    if rc.n_importance > 0:
        out["rgb0"] = rgb
        z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        z_fine = sample_pdf(z_mid, weights[..., 1:-1], rc.n_importance, det=True)
        z_all = torch.sort(torch.cat([z_vals, z_fine], dim=-1), dim=-1).values
        rgb, disp, acc, _, depth = _march(params, rays_o, rays_d, viewdirs, z_all, g)
    out.update(rgb_map=rgb, disp_map=disp, acc_map=acc, depth_map=depth)
    return out


def render_poses(params: Params, c2ws, H: int, W: int, K, g: HashGrid, rc, block: int):
    """Poses [P,4,4] as one flat ray batch in blocks of ``block`` rays;
    maps [P, H, W, ...]."""
    rays_o, rays_d = get_rays(H, W, K, c2ws)
    rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    parts = [render_rays(params, rays_o[lo:lo + block], rays_d[lo:lo + block],
                         viewdirs[lo:lo + block], g, rc)
             for lo in range(0, rays_o.shape[0], block)]
    lead = (c2ws.shape[0], H, W)
    return {k: torch.cat([p[k] for p in parts]).reshape(lead + tuple(parts[0][k].shape[1:]))
            for k in parts[0]}
