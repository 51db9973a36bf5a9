"""Instant-NGP's NeRF field (Müller, Evans, Schied, Keller, "Instant Neural
Graphics Primitives with a Multiresolution Hash Encoding", SIGGRAPH 2022;
NVlabs instant-ngp ``configs/nerf/base.json``) as plain functions over a
param dict: the plain twin of the kernel ``csrc/ngp_march.cu``.

Per point x (``HashNetConfig`` holds the settings):

- u = (x - lo) / (hi - lo) over the box ``hash_aabb``; a point outside
  [0, 1]^3 gets sigma = 0, and its colour is computed from u clamped into
  the box;
- level l of ``hash_levels``, at resolution N_l = floor(N_min (N_max /
  N_min)^(l / (L - 1))) in float64 (``resolutions``): u_l = u N_l, the cell
  i = min(floor(u_l), N_l - 1) (the clamp moves only u = 1, whose upper
  corner then takes weight 1, the same value), f = u_l - i; the 8 corners
  c = i + delta, delta in {0,1}^3 (corner k: delta = bits 0, 1, 2 of k),
  weighted by (wx wy) wz, w = f where delta is 1 and 1 - f where it is 0,
  summed in corner order;
- corner index (``corner_index``): a dense level, (N_l + 1)^3 <= T =
  2^``log2_hashmap_size``, c_x + c_y (N_l + 1) + c_z (N_l + 1)^2; a hashed
  one (c_x * 1 xor c_y * 2654435761 xor c_z * 805459861) mod T in uint32
  arithmetic, the products wrapping. One table [entries, F] holds the
  levels one after another (``level_layout``);
- the encoding: the levels' F features, level 0 first;
- spherical harmonics of degree 4 of the unit view direction
  (``sh_encode``), with tiny-cuda-nn's real-SH constants, each written as
  one formula of x, y, z (``SH_FORMULAS``; tiny-cuda-nn writes l = 2's last
  as C xx - C yy, here C (xx - yy));
- h = relu(enc W_d0); out = h W_d1; sigma = exp(out_0); g = relu(relu([out,
  sh] W_c0) W_c1); rgb logits = g W_c2. No biases.

The widths are the published ones and fixed, as in the kernel: F = 2
features a level, the density MLP L F -> 64 -> 16, the colour MLP 16 + 16
-> 64 -> 64 -> 3.

The raw field is [rgb logits, sigma], as the NeRF MLP's, so
``raw2outputs`` applies its sigmoid and its ReLU (a no-op on sigma). One
field serves both passes of the hierarchical render
(``init_ngp_pipeline_params``: ``fine`` is ``coarse``). The field runs in
float32 only (``check_float32``).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

import torch

from neuralsim_tpu_torch import draw
from neuralsim_tpu_torch.config import HASH_EMBED, NeRFNetConfig

Params = Dict[str, torch.Tensor]

# the spatial hash's primes, x first (tiny-cuda-nn's grid encoding)
PRIMES = (1, 2654435761, 805459861)
_UINT32 = 0xFFFFFFFF

# the published widths (csrc/ngp_march.cu's constexprs F, DW, DO, CW, CD, SH)
FEATURES = 2                     # features a level
DENSITY_WIDTH, DENSITY_OUT = 64, 16
COLOR_WIDTH, COLOR_DEPTH = 64, 2  # hidden width, hidden layers
SH_DEGREE = 4

# real spherical harmonics of a unit direction, degree by degree
# (tiny-cuda-nn's constants)
SH_FORMULAS = (
    lambda x, y, z: torch.full_like(x, 0.28209479177387814),
    lambda x, y, z: -0.48860251190291987 * y,
    lambda x, y, z: 0.48860251190291987 * z,
    lambda x, y, z: -0.48860251190291987 * x,
    lambda x, y, z: 1.0925484305920792 * x * y,
    lambda x, y, z: -1.0925484305920792 * y * z,
    lambda x, y, z: 0.94617469575755997 * (z * z) - 0.31539156525251999,
    lambda x, y, z: -1.0925484305920792 * x * z,
    lambda x, y, z: 0.54627421529603959 * (x * x - y * y),
    lambda x, y, z: 0.59004358992664352 * y * (y * y - 3.0 * (x * x)),
    lambda x, y, z: 2.8906114426405538 * x * y * z,
    lambda x, y, z: 0.45704579946446572 * y * (1.0 - 5.0 * (z * z)),
    lambda x, y, z: 0.3731763325901154 * z * (5.0 * (z * z) - 3.0),
    lambda x, y, z: 0.45704579946446572 * x * (1.0 - 5.0 * (z * z)),
    lambda x, y, z: 1.4453057213202769 * z * (x * x - y * y),
    lambda x, y, z: 0.59004358992664352 * x * (3.0 * (y * y) - x * x),
)


class Level(NamedTuple):
    resolution: int
    offset: int          # first row of the level in the table
    size: int            # rows: (N + 1)^3 dense, T hashed
    dense: bool


def is_hash_field(net: NeRFNetConfig) -> bool:
    return net.i_embed == HASH_EMBED


def resolutions(net) -> List[int]:
    """N_l = floor(N_min (N_max / N_min)^(l / (L - 1))) in float64: the
    published list (16, 22, ..., 1482, 2048), N_{L-1} = N_max exactly."""
    n_min, n_max, levels = net.base_resolution, net.finest_resolution, net.hash_levels
    if levels == 1:
        return [n_min]
    return [math.floor(n_min * (n_max / n_min) ** (lv / (levels - 1))) for lv in range(levels)]


def level_layout(net) -> List[Level]:
    """Each level's resolution, first row, rows and storage: a level whose
    (N + 1)^3 corners fit T = 2^log2_hashmap_size rows is dense."""
    t = 2 ** net.log2_hashmap_size
    out, offset = [], 0
    for res in resolutions(net):
        dense = (res + 1) ** 3 <= t
        size = (res + 1) ** 3 if dense else t
        out.append(Level(res, offset, size, dense))
        offset += size
    return out


def table_rows(net) -> int:
    last = level_layout(net)[-1]
    return last.offset + last.size


def corner_index(c: torch.Tensor, level: Level) -> torch.Tensor:
    """Rows within a level of integer corners c [..., 3] (int64)."""
    if level.dense:
        side = level.resolution + 1
        return c[..., 0] + c[..., 1] * side + c[..., 2] * (side * side)
    # int64 holds each product (c < 2^12, primes < 2^32) whole; its low 32
    # bits are the uint32 product's, and xor keeps bits apart
    h = (c[..., 0] * PRIMES[0]) ^ (c[..., 1] * PRIMES[1]) ^ (c[..., 2] * PRIMES[2])
    return (h & _UINT32) % level.size


def unit_coords(x: torch.Tensor, net):
    """(u clamped into [0, 1]^3, inside) of points x [M, 3] in the box."""
    lo, hi = net.hash_aabb
    u = (x - lo) / (hi - lo)
    inside = ((u >= 0.0) & (u <= 1.0)).all(dim=-1)
    return u.clamp(0.0, 1.0), inside


def hash_encode(table: torch.Tensor, u: torch.Tensor, net) -> torch.Tensor:
    """The multiresolution encoding [M, L F] of unit coordinates u [M, 3]."""
    feats = []
    for level in level_layout(net):
        ul = u * level.resolution
        cell = torch.clamp(torch.floor(ul), max=level.resolution - 1).detach()
        f = ul - cell
        base = cell.long()
        acc = None
        for k in range(8):
            delta = [(k >> a) & 1 for a in range(3)]
            w = [f[:, a] if delta[a] else 1.0 - f[:, a] for a in range(3)]
            c = base + torch.tensor(delta, dtype=torch.long, device=u.device)
            rows = level.offset + corner_index(c, level)
            term = (w[0] * w[1] * w[2])[:, None] * table[rows]
            acc = term if acc is None else acc + term
        feats.append(acc)
    return torch.cat(feats, dim=-1)


def sh_encode(d: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics [M, 16] of degree 4 of unit directions d
    [M, 3]."""
    x, y, z = d.unbind(-1)
    return torch.stack([fn(x, y, z) for fn in SH_FORMULAS], dim=-1)


def param_keys(net) -> List[str]:
    """The table, then the MLP kernels in the order the kernel reads them."""
    return (["hash_table", "density_0_kernel", "density_1_kernel"]
            + [f"color_{i}_kernel" for i in range(COLOR_DEPTH + 1)])


def kernel_shapes(net) -> Dict[str, tuple]:
    """Each MLP kernel's [in, out]."""
    shapes = {"density_0_kernel": (net.hash_levels * FEATURES, DENSITY_WIDTH),
              "density_1_kernel": (DENSITY_WIDTH, DENSITY_OUT)}
    fan_in = DENSITY_OUT + SH_DEGREE ** 2
    for i in range(COLOR_DEPTH):
        shapes[f"color_{i}_kernel"] = (fan_in, COLOR_WIDTH)
        fan_in = COLOR_WIDTH
    shapes[f"color_{COLOR_DEPTH}_kernel"] = (fan_in, 3)
    return shapes


def ngp_apply(params: Params, x: torch.Tensor, d: torch.Tensor, net) -> torch.Tensor:
    """The field at points x [M, 3] seen from unit directions d [M, 3]:
    raw [M, 4] (rgb logits, sigma), in the dtype of the inputs."""
    u, inside = unit_coords(x, net)
    enc = hash_encode(params["hash_table"], u, net)
    out = torch.relu(enc @ params["density_0_kernel"]) @ params["density_1_kernel"]
    sigma = torch.where(inside, torch.exp(out[:, 0]), torch.zeros_like(out[:, 0]))
    h = torch.cat([out, sh_encode(d)], dim=-1)
    for i in range(COLOR_DEPTH):
        h = torch.relu(h @ params[f"color_{i}_kernel"])
    rgb = h @ params[f"color_{COLOR_DEPTH}_kernel"]
    return torch.cat([rgb, sigma[:, None]], dim=-1)


def check_float32(net, what: str, **dtypes):
    """Raise ValueError, naming ``what`` and the setting, where a hash
    field is asked for a dtype other than float32 (its configuration
    states float32, and its kernel computes nothing else)."""
    if not is_hash_field(net):
        return
    for name, dtype in dtypes.items():
        if dtype not in ("float32", torch.float32):
            raise ValueError(f"{what}: {name}={dtype}, but the hash-grid field "
                             "(i_embed=1) runs in float32 only")


def query_points(params: Params, pts, viewdirs: Optional[torch.Tensor], net,
                 compute_dtype=torch.float32, use_pallas: bool = False) -> torch.Tensor:
    """The field at sample points pts [N, S, 3] with per-ray unit view
    directions [N, 3]: raw [N, S, 4]. Plain PyTorch on any device; on the
    card with ``use_pallas`` it raises, as the point-major kernels take no
    hash field (the ray march, ``fused_ngp_march``, does)."""
    from neuralsim_tpu_torch.kernels import raymarch

    check_float32(net, "query_points", compute_dtype=compute_dtype)
    if use_pallas and raymarch.uses_kernel(pts):
        raise NotImplementedError(
            "query_points: the point-major kernels (fused_nerf_mlp_widepe, fused_nerf_mlp, "
            "fused_nerf_mlp_pe) take no hash-grid field; march it with fused_ngp_march "
            "(fuse_pointgen=True)")
    n, s, _ = pts.shape
    dirs = viewdirs[:, None, :].expand(n, s, 3).reshape(n * s, 3)
    return ngp_apply(params, pts.reshape(n * s, 3), dirs, net).reshape(n, s, 4)


def init_ngp_params(net, generator: Optional[torch.Generator] = None, device="cpu",
                    table_scale: float = 1e-4) -> Params:
    """Instant-NGP's init: the table U(-table_scale, table_scale) (1e-4 in
    the paper), each kernel Xavier-uniform, U(+-sqrt(6 / (in + out)))."""
    params = {"hash_table": (2.0 * draw((table_rows(net), FEATURES), generator, device)
                             - 1.0) * table_scale}
    for key, (fan_in, fan_out) in kernel_shapes(net).items():
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        params[key] = (2.0 * draw((fan_in, fan_out), generator, device) - 1.0) * bound
    return params


def init_ngp_pipeline_params(net, n_importance: int,
                             generator: Optional[torch.Generator] = None,
                             device="cpu") -> Dict[str, Params]:
    """One field for both passes: {"coarse": p} and, with importance
    samples, "fine" the same dict."""
    params = init_ngp_params(net, generator, device)
    return {"coarse": params, "fine": params} if n_importance > 0 else {"coarse": params}
