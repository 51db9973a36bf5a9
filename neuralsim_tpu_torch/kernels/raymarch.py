"""The NeRF kernels: the port of every Pallas kernel of
``neuralsim_tpu/kernels/raymarch.py`` as a CUDA kernel for Hopper.

| wrapper                 | JAX kernel body          | CUDA source          | plain twin           |
|-------------------------|--------------------------|----------------------|----------------------|
| ``fused_nerf_march``    | ``_march_channels_kernel`` | ``nerf_march.cu``  | ``march_channels_ref`` |
| ``fused_nerf_mlp_widepe`` | ``_mlp_widepe_kernel`` | ``nerf_mlp.cu``      | ``mlp_widepe_ref``   |
| ``fused_nerf_mlp_pe``   | ``_mlp_pe_kernel``       | ``nerf_mlp.cu``      | ``mlp_pe_ref``       |
| ``fused_nerf_mlp``      | ``_mlp_kernel``          | ``nerf_mlp.cu``      | ``nerf_apply``       |
| ``fused_render_tile``   | ``_render_tile_kernel``  | ``render_tile.cu``   | ``render_tile_ref``  |
| ``fused_ngp_march``     | (none: the port's own)   | ``ngp_march.cu``     | ``ngp_march_ref``    |

On a tensor for which ``uses_kernel`` is true (a CUDA tensor) a wrapper
launches its kernel or raises; on a CPU tensor it computes its plain
PyTorch twin. Every wrapper computes in bfloat16 unless asked for float32,
as the JAX package's wrappers do. ``core_for`` picks the MLP core of a net
from its shape and the dtype, before any launch:

- in bfloat16 the tensor cores (``nerf_mlp_wgmma.cuh``) from the chunks of
  ``pack_wgmma_weights``; in float32 the FP32 core (``nerf_mlp.cuh``) from
  the chunks of ``pack_f32_weights``. Both take a trunk of 256, 512 or 1024
  (a narrower net is zero-padded to the next of the three by
  ``pad_params``, which is exact), any depth and the encodings that fit
  beside them in a block's shared memory;
- every other net, in either dtype, the streaming core
  (``nerf_mlp_stream.cuh``): a trunk padded to a multiple of 128, its
  weights streamed as the pieces of ``pack_stream_weights`` (bf16 for the
  tensor cores in bf16, float32 in float32), up to the JAX kernels' own
  budget (``jax_vmem_bytes``); ``_check_supported`` raises, naming the
  bytes, for a net past it or whose smallest tile does not fit.

The render tile takes any number of samples per ray. The padded weights,
their chunks or table and the net's device table (bias pointers and
skip-mask words) are prepared once per weight set, dtype and core
(``_packed_weights``).
Gradients of the first four
recompute through a twin in float32, as the JAX custom_vjp backwards do;
``fused_render_tile`` is forward only, as in JAX, and raises when asked for
a gradient on the card.

Each wrapper's ``launches`` counts its kernel's launches, so a run can show
that its render went through the kernel.

``fused_ngp_march`` marches Instant-NGP's hash-grid field
(``models/ngp.py``) in float32 only, with its gradient recomputed through
its twin as the others'. Its counters ``calls`` and ``points`` (rays x
samples) count its kernel's launches and the points they marched, and each
launch is the span ``render.hash_march``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from collections import OrderedDict
from typing import Dict, List, Optional

import torch

from neuralsim_tpu_torch.config import NeRFNetConfig
from neuralsim_tpu_torch.kernels import build
from neuralsim_tpu_torch.models import ngp
from neuralsim_tpu_torch.models.nerf import nerf_apply, round_to
from neuralsim_tpu_torch.ops.encoding import positional_encoding
from neuralsim_tpu_torch.ops.volume import raw2outputs
from neuralsim_tpu_torch.utils.profiling import span

# nerf_mlp.cu input stages
_KINDS = {"widepe": 0, "pe": 1, "encoded": 2}


def as_dtype(compute_dtype) -> torch.dtype:
    return getattr(torch, compute_dtype) if isinstance(compute_dtype, str) else compute_dtype


def uses_kernel(t: torch.Tensor) -> bool:
    """Whether a wrapper given ``t`` launches its CUDA kernel (else it
    computes its plain twin): exactly when ``t`` lies on a CUDA device."""
    return t.is_cuda


# ---------------------------------------------------------------- twins --

def ray_points(rays_o, rays_d, viewdirs, z_vals):
    """The sample points x = o + d*z of rays [N,3] at depths [N,S] and
    their view directions, flattened point-major: (pts, dirs) [N*S,3]."""
    n, s = z_vals.shape
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    return pts.reshape(-1, 3), viewdirs[:, None, :].expand(n, s, 3).reshape(-1, 3)


def march_channels_ref(params: Dict[str, torch.Tensor], rays_o, rays_d,
                       viewdirs, z_vals, net: NeRFNetConfig,
                       compute_dtype=torch.float32):
    """Plain PyTorch march: (sigma [N,S] raw density, rgb3 [3,N,S] logits)."""
    raw = mlp_widepe_ref(params, *ray_points(rays_o, rays_d, viewdirs, z_vals), net,
                         compute_dtype).reshape(*z_vals.shape, 4)
    return raw[..., 3], torch.movedim(raw[..., :3], -1, 0)


def ngp_march_ref(params: Dict[str, torch.Tensor], rays_o, rays_d, viewdirs, z_vals,
                  net: NeRFNetConfig):
    """Plain march of a hash-grid field: (sigma [N,S], rgb3 [3,N,S] logits)."""
    raw = ngp.ngp_apply(params, *ray_points(rays_o, rays_d, viewdirs, z_vals),
                        net).reshape(*z_vals.shape, 4)
    return raw[..., 3], torch.movedim(raw[..., :3], -1, 0)


def mlp_widepe_ref(params, pts, dirs, net: NeRFNetConfig,
                   compute_dtype=torch.float32):
    """Plain PE (projection form) + MLP: pts, dirs [M,3] -> raw [M,4]."""
    return nerf_apply(params, positional_encoding(pts, net.multires),
                      positional_encoding(dirs, net.multires_views), net,
                      compute_dtype=as_dtype(compute_dtype))


def mlp_pe_ref(params, pts, dirs, net: NeRFNetConfig,
               compute_dtype=torch.float32):
    """Plain PE with a true cos + MLP: pts, dirs [M,3] -> raw [M,4]."""
    return nerf_apply(
        params, positional_encoding(pts, net.multires, projection=False),
        positional_encoding(dirs, net.multires_views, projection=False), net,
        compute_dtype=as_dtype(compute_dtype))


def render_tile_ref(params, rays_o, rays_d, viewdirs, z_vals,
                    net: NeRFNetConfig, white_bkgd: bool = False,
                    compute_dtype=torch.float32, fast_epilogue: bool = False):
    """Plain march + raw2outputs: the tuple (rgb [N,3], disp [N], acc [N],
    weights [N,S], depth [N])."""
    pts, dirs = ray_points(rays_o, rays_d, viewdirs, z_vals)
    raw = nerf_apply(params, positional_encoding(pts, net.multires),
                     positional_encoding(dirs, net.multires_views), net,
                     compute_dtype=as_dtype(compute_dtype),
                     fast_epilogue=fast_epilogue)
    return raw2outputs(raw.reshape(*z_vals.shape, 4), z_vals, rays_d,
                       white_bkgd=white_bkgd)


# ------------------------------------------------------------- launches --

def param_keys(depth: int) -> List[str]:
    """Kernel-then-bias keys in the order the CUDA kernels take them."""
    names = [f"pts_{i}" for i in range(depth)] + ["feature", "alpha", "views_0", "rgb"]
    return [f"{n}_{kind}" for n in names for kind in ("kernel", "bias")]


def _depth(params) -> int:
    return sum(1 for k in params if k.startswith("pts_") and k.endswith("kernel"))


# ------------------------------------------------------ weight layouts --

def _pad_kernel(k: torch.Tensor, blocks, cols: int) -> torch.Tensor:
    """k [sum n, c] as [sum m, cols]: for each (n, m) of ``blocks`` the next
    n rows of k, then m - n zero rows; zero columns past c."""
    out = k.new_zeros((sum(m for _, m in blocks), cols))
    src = dst = 0
    for n, m in blocks:
        out[dst:dst + n, :k.shape[1]] = k[src:src + n]
        src, dst = src + n, dst + m
    return out


def pad_params(params: Dict[str, torch.Tensor], net: NeRFNetConfig,
               width: int) -> Dict[str, torch.Tensor]:
    """A view-direction net's kernels and biases zero-padded to a trunk of
    ``width`` (views layer ``width // 2``), the shapes the CUDA cores take.

    Exact: a pad column has zero weights and a zero bias, so it holds +0
    after its ReLU (and after the feature layer's plain bias); the pad rows
    of the next layer and of the alpha, views and rgb heads are zero and
    multiply those zeros; adding +0 to a float32 (or bf16) sum leaves it as
    it was. Returns ``params`` itself when it has that width already."""
    depth = _depth(params)
    w = params["pts_0_kernel"].shape[1]
    w2 = params["views_0_kernel"].shape[1]
    if w == width and w2 == width // 2:
        return params
    x, v = net.input_ch, params["views_0_kernel"].shape[0] - w
    layers = {f"pts_{i}": ([(x, x)] if i == 0 else
                           [(x, x), (w, width)] if (i - 1) in net.skips else [(w, width)], width)
              for i in range(depth)}
    layers.update(feature=([(w, width)], width), alpha=([(w, width)], 1),
                  views_0=([(w, width), (v, v)], width // 2), rgb=([(w2, width // 2)], 3))
    out = {}
    for name, (blocks, cols) in layers.items():
        out[f"{name}_kernel"] = _pad_kernel(params[f"{name}_kernel"], blocks, cols)
        bias = params[f"{name}_bias"]
        out[f"{name}_bias"] = bias.new_zeros(cols)
        out[f"{name}_bias"][:bias.shape[0]] = bias
    return out


def _layer_segments(params, net: NeRFNetConfig) -> List[List[torch.Tensor]]:
    """The [K, N] kernel slices that the trunk, feature and views layers
    multiply, layer by layer in the order the cores consume them: layer 0
    (x_pe), each later trunk layer (its x_pe rows first after a skip), the
    feature layer, then the views layer (feature rows, then d_pe rows)."""
    depth = _depth(params)
    layers = [[params["pts_0_kernel"]]]
    for i in range(1, depth):
        k = params[f"pts_{i}_kernel"]
        layers.append([k[:net.input_ch], k[net.input_ch:]] if (i - 1) in net.skips else [k])
    views = params["views_0_kernel"]
    n_feature = views.shape[0] - net.input_ch_views
    return layers + [[params["feature_kernel"]], [views[:n_feature], views[n_feature:]]]


def _segments(params, net: NeRFNetConfig) -> List[torch.Tensor]:
    """``_layer_segments`` one after another."""
    return [seg for layer in _layer_segments(params, net) for seg in layer]


# trunk widths the FP32 and wgmma cores are built for: a net is padded to
# the next one
CORE_WIDTHS = (256, 512, 1024)
# the streaming core's trunks: multiples of this (so the views layer's
# W/2 is whole m64 blocks of its bf16 products)
STREAM_ALIGN = 128
# the cores (core_for) and the code of each in the render tile's queries
# (the streaming core's in float32; in bf16 one more)
F32_CORE, WGMMA_CORE, STREAM_CORE = "fp32", "wgmma", "stream"
CORE_CODES = {F32_CORE: 0, WGMMA_CORE: 1, STREAM_CORE: 2}
# the streaming core's pieces (nerf_mlp_stream.cuh): output columns of a
# column block, and input rows in bf16 and float32
STREAM_NB = 128
STREAM_ROWS = {True: 64, False: 32}
# wgmma weight chunks (nerf_mlp_wgmma.cuh): 64 input rows each
CHUNK_K = 64
# FP32-core weight chunks (nerf_mlp.cuh): 16 input rows each
F32_CHUNK_K = 16


def _swizzled_chunks(w: torch.Tensor) -> torch.Tensor:
    """A kernel [K, N] as flat bf16 chunks of CHUNK_K input rows (K padded
    with zero rows), each chunk the shared-memory image that a K-major
    wgmma B descriptor with 128-byte swizzle reads: row n (one output
    column) holds its 64 inputs in 8 units of 8, and unit u sits at
    position u ^ (n % 8)."""
    k, n = w.shape
    kp = -(-k // CHUNK_K) * CHUNK_K
    wt = torch.zeros((n, kp), dtype=torch.bfloat16, device=w.device)
    wt[:, :k] = w.detach().t().to(torch.bfloat16)
    units = wt.reshape(n, kp // CHUNK_K, 8, 8).transpose(0, 1)   # [chunk, n, unit, 8]
    rows = torch.arange(n, device=w.device)[:, None]
    logical = torch.arange(8, device=w.device)[None, :] ^ (rows % 8)
    return units[:, rows, logical].reshape(-1)


def _f32_chunks(w: torch.Tensor) -> torch.Tensor:
    """A kernel [K, N] (N a multiple of 64) as flat float32 chunks of
    F32_CHUNK_K input rows (K padded with zero rows), each row's columns in
    the order the FP32 core's threads read them: position 64q + 4cg + e of
    a row holds column cg + 16 (4q + e), so column group cg's four float4
    lie beside its neighbours'."""
    k, n = w.shape
    kp = -(-k // F32_CHUNK_K) * F32_CHUNK_K
    rows = torch.zeros((kp, n), dtype=torch.float32, device=w.device)
    rows[:k] = w.detach().to(torch.float32)
    pos = torch.arange(n, device=w.device)
    return rows[:, (pos // 4) % 16 + 16 * (4 * (pos // 64) + pos % 4)].reshape(-1)


def pack_wgmma_weights(params: Dict[str, torch.Tensor], net: NeRFNetConfig) -> torch.Tensor:
    """The trunk, feature and views kernels as the flat bf16 chunks that
    the bf16 kernels stream, in the order they consume them (``_segments``).
    1.196 MB for the default 8x256 net."""
    return torch.cat([_swizzled_chunks(w) for w in _segments(params, net)])


def pack_f32_weights(params: Dict[str, torch.Tensor], net: NeRFNetConfig) -> torch.Tensor:
    """The trunk, feature and views kernels as the flat float32 chunks that
    the FP32 core streams, in the order it consumes them (``_segments``).
    2.376 MB for the default 8x256 net."""
    return torch.cat([_f32_chunks(w) for w in _segments(params, net)])


def pack_stream_weights(params: Dict[str, torch.Tensor], net: NeRFNetConfig,
                        bf16: bool) -> torch.Tensor:
    """The trunk, feature and views kernels as the flat pieces of 16 KB that
    the streaming core streams, in the order it consumes them: layer by
    layer (``_layer_segments``), each layer's output columns in blocks of
    STREAM_NB (zero columns past the layer's own), and for each column
    block every segment's rows in chunks of STREAM_ROWS (zero rows past the
    segment's own). A bf16 piece is [STREAM_NB columns][64 inputs], the
    swizzled image of ``_swizzled_chunks`` (the A operand of the core's
    products); a float32 piece [32 inputs][STREAM_NB columns], row-major.
    22.9 MB in bf16 for the 8x1152 net."""
    rows = STREAM_ROWS[bf16]
    pieces = []
    for segs in _layer_segments(params, net):
        n = segs[0].shape[1]
        for c0 in range(0, n, STREAM_NB):
            for seg in segs:
                k = seg.shape[0]
                block = torch.zeros((-(-k // rows) * rows, STREAM_NB), dtype=torch.float32,
                                    device=seg.device)
                w = seg.detach()[:, c0:c0 + STREAM_NB]
                block[:k, :w.shape[1]] = w
                pieces.append(_swizzled_chunks(block) if bf16 else block.reshape(-1))
    return torch.cat(pieces)


def stream_width(width: int) -> int:
    """The trunk width a net runs at on the streaming core: the next
    multiple of STREAM_ALIGN (its column blocks take 128 columns, and the
    views layer's W/2 whole m64 blocks)."""
    return -(-width // STREAM_ALIGN) * STREAM_ALIGN


def core_width(width: int) -> int:
    """The trunk width a net of ``width`` runs at on the cores: the
    narrowest of CORE_WIDTHS that holds it (the widest past them, which the
    kernels refuse)."""
    return next((w for w in CORE_WIDTHS if w >= width), CORE_WIDTHS[-1])


def wgmma_bytes(depth: int, n_skips: int, width: int, in_ch: int = CHUNK_K,
                in_ch_views: int = CHUNK_K) -> int:
    """Bytes of ``pack_wgmma_weights`` for a net of trunk ``width`` whose
    x_pe has ``in_ch`` channels and d_pe ``in_ch_views``: the chunk plan of
    nerf_mlp_wgmma.cuh (width 256, encodings 63 / 27: 34 chunks of
    [256][64] and 5 of [128][64])."""
    h, nx, nd = (-(-c // CHUNK_K) for c in (width, in_ch, in_ch_views))
    n_wide = nx + h * (depth - 1) + nx * n_skips + h
    return (n_wide * width + (h + nd) * (width // 2)) * CHUNK_K * 2


def f32_bytes(depth: int, n_skips: int, width: int, in_ch: int, in_ch_views: int) -> int:
    """Bytes of ``pack_f32_weights`` for a net of trunk ``width``: the chunk
    plan of nerf_mlp.cuh (width 256, encodings 63 / 27: 136 chunks of
    [16][256] and 18 of [16][128])."""
    h, nx, nd = (-(-c // F32_CHUNK_K) for c in (width, in_ch, in_ch_views))
    n_wide = nx + h * (depth - 1) + nx * n_skips + h
    return (n_wide * width + (h + nd) * (width // 2)) * F32_CHUNK_K * 4


# the JAX launchers' compiler_params: vmem_limit_bytes=100 * 1024 * 1024
JAX_VMEM_LIMIT = 100 * 1024 * 1024
# the JAX launchers' default point tiles (neuralsim_tpu/kernels/raymarch.py:
# _fused_forward, _fused_forward_pe, _fused_forward_widepe,
# _fused_march_channels) and the render tile's target points a grid step
_JAX_TILES = {"fused_nerf_mlp": 2048, "fused_nerf_mlp_widepe": 4096,
              "fused_nerf_march": 4096}
_JAX_RENDER_TARGET = 4096


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


def jax_vmem_bytes(kernel: str, net: NeRFNetConfig, width: int, depth: int, bf16: bool,
                   n_samples: int = 0) -> int:
    """The VMEM that the JAX kernel ``kernel`` (a wrapper's name) declares
    for a net of trunk ``width`` and ``depth`` (the port's copy of the
    rule of neuralsim_tpu/kernels/raymarch.py, which it does not import):
    every block of its pallas_call double-buffered, the weights and the PE
    constants at the compute dtype, the input and output tiles at theirs
    (``n_samples``: the render tile's S, which sets its tiles and its
    [S, S] triangle).

    Each weight and bias is a whole-array block: ``_param_list`` (kernels
    4 and 5: the kernels as they are, each bias [1, out]) or
    ``_wide_param_list`` (kernels 1-3: x_pe rows padded to p_x =
    round_up(in_ch, 64), d_pe rows to p_d = round_up(in_ch_views, 32)); the
    wide kernels add six PE constants of p_x and of p_d values. Mosaic's
    own scratch for the kernel's intermediates and its (8, 128) tile
    padding cannot be reckoned without a TPU and are left out, so the sum
    is at most what the JAX kernel needs: a net it takes is never refused
    here (the rule errs toward taking more than JAX, never less)."""
    cd = 2 if bf16 else 4
    wide = kernel in ("fused_nerf_march", "fused_nerf_mlp_widepe", "fused_render_tile")
    x = _round_up(net.input_ch, 64) if wide else net.input_ch
    v = _round_up(net.input_ch_views, 32) if wide else net.input_ch_views
    skips = set(net.skips)
    weights = 0
    for i in range(depth):
        rows = x if i == 0 else width + (x if (i - 1) in skips else 0)
        weights += rows * width + width
    weights += (width * width + width) + (width + 1) + ((width + v) * (width // 2) + width // 2)
    weights += (width // 2) * 3 + 3
    consts = 6 * (x + v) if wide else 0
    if kernel == "fused_render_tile":
        s = n_samples
        r = max(8, (max(1, _JAX_RENDER_TARGET // s) // 8) * 8)
        consts += s * s                                   # the strict upper triangle
        tiles = 4 * (2 * r * s * 3 + r * s + r) + 4 * (r * 3 + 3 * r + r * s)
    elif kernel == "fused_nerf_mlp":
        t = _JAX_TILES[kernel]
        tiles = t * (net.input_ch + net.input_ch_views) * cd + t * 4 * 4
    else:
        t = (4096 if bf16 else 2048) if kernel == "fused_nerf_mlp_pe" else _JAX_TILES[kernel]
        tiles = t * 6 * 4 + t * 4 * 4          # points and directions in, raw out
    return 2 * ((weights + consts) * cd + tiles)


def core_for(net: NeRFNetConfig, width: int, bf16: bool, lib, render_tile: bool = False) -> str:
    """The MLP core that runs a net of trunk ``width`` in a dtype: the one
    place the route is chosen, from the net's shape alone, before any
    launch. The FP32 core in float32 and the wgmma core in bf16 for every
    net they take (a trunk up to the library's ``nerf_width()``, padded to
    ``core_width``, whose core fits the device's shared memory, and in the
    render tile leaves room for one sample); the streaming core for every
    other net. Reads the current device's shared memory: callers run it
    under ``_on(device)``."""
    if width <= lib.nerf_width():
        padded = core_width(width)
        smem = lib.nerf_wgmma_smem_bytes if bf16 else lib.nerf_f32_smem_bytes
        if smem(padded, net.input_ch, net.input_ch_views) <= lib.nerf_smem_optin() and (
                not render_tile or lib.render_tile_max_samples(
                    int(bf16), padded, net.input_ch, net.input_ch_views) >= 1):
            return WGMMA_CORE if bf16 else F32_CORE
    return STREAM_CORE


def core_code(core: str, bf16: bool) -> int:
    """A core's code in the render tile's queries (``CORE_CODES``; the
    streaming core's in bf16 one more than in float32)."""
    return CORE_CODES[core] + int(bf16 and core == STREAM_CORE)


def padded_width(core: str, width: int) -> int:
    """The trunk width a net of ``width`` takes on ``core``."""
    return stream_width(width) if core == STREAM_CORE else core_width(width)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def net_table(weights: List[torch.Tensor], depth: int, skips) -> torch.Tensor:
    """The kernels' device table of a net (``Net`` in csrc/nerf_mlp.cuh):
    the bias pointers of ``weights`` (``param_keys`` order: pts_0 ..
    pts_{depth-1}, feature, alpha, views_0, rgb), then the skip mask in
    64-bit words (bit i % 64 of word i // 64: layer i's output is
    concatenated with x_pe), as int64 on the weights' device."""
    words = [sum(1 << (sk % 64) for sk in skips if sk // 64 == i) for i in range(-(-depth // 64))]
    return _int64([w.data_ptr() for w in weights[1::2]] + words, weights[0].device)


def _int64(values: List[int], device) -> torch.Tensor:
    """Unsigned 64-bit values (pointers, mask words) as an int64 tensor."""
    return torch.tensor([v - (1 << 64) if v >= 1 << 63 else v for v in values],
                        dtype=torch.int64).to(device)


# prepared weights of the last few (weight set, dtype, core), keyed by the
# tensors' ids and versions; the entry holds the tensors, so an id is not
# reused while cached
_PACKED: "OrderedDict[tuple, tuple]" = OrderedDict()
_PACKED_SETS = 8


def _packed_weights(params, net: NeRFNetConfig, depth: int, bf16: bool, lib, what: str,
                    core: Optional[str] = None):
    """(padded weights in ``param_keys`` order, what the core reads, device
    table) of one weight set for a launch on ``core`` (by default the
    dtype's: wgmma in bf16, the FP32 core in float32): every weight
    zero-padded to the core's width of its trunk (``pad_params``,
    ``padded_width``) and each kernel rounded to bf16 in bf16; from them the
    chunks of the FP32 and wgmma cores (``pack_f32_weights``,
    ``pack_wgmma_weights``) or the streaming core's pieces
    (``pack_stream_weights``), each checked against the library's plan;
    and ``net_table``. Once per weight set, dtype and core; an in-place
    update of a weight prepares again. Each preparation is the span
    ``kernels.pack_weights``; a cached set opens none."""
    core = core or (WGMMA_CORE if bf16 else F32_CORE)
    keys = param_keys(depth)
    tensors = tuple(params[k] for k in keys)
    key = (tuple((id(t), t._version) for t in tensors), net.input_ch, net.input_ch_views,
           tuple(net.skips), bf16, core)
    if key in _PACKED:
        _PACKED.move_to_end(key)
        return _PACKED[key][1:]
    with span("kernels.pack_weights"):
        width = padded_width(core, params["pts_0_kernel"].shape[1])
        padded = pad_params({k: t.detach().to(torch.float32) for k, t in zip(keys, tensors)},
                            net, width)
        if bf16:
            padded = {k: round_to(t, torch.bfloat16) if k.endswith("kernel") else t
                      for k, t in padded.items()}
        weights = [_aligned(padded[k]) for k in keys]
        table = net_table(weights, depth, net.skips)
        plan = (width, depth, len(set(net.skips)), net.input_ch, net.input_ch_views)
        if core == STREAM_CORE:
            packed = pack_stream_weights(padded, net, bf16)
            want = lib.nerf_stream_plan_bytes(*plan, int(bf16))
        elif bf16:
            packed = pack_wgmma_weights(padded, net)
            want = lib.nerf_wgmma_plan_bytes(*plan)
        else:
            packed = pack_f32_weights(padded, net)
            want = lib.nerf_f32_plan_bytes(*plan)
        nbytes = packed.numel() * packed.element_size()
        if nbytes != want or packed.data_ptr() % 16:
            raise ValueError(f"{what}: packed weights of {nbytes} bytes at "
                             f"{packed.data_ptr():#x} do not match the kernel's chunk plan "
                             f"({want} bytes)")
    _PACKED[key] = (tensors, weights, packed, table)
    if len(_PACKED) > _PACKED_SETS:
        _PACKED.popitem(last=False)
    return weights, packed, table


# weights (host array of device pointers), the net's device table, width,
# depth, number of skips, in_ch, in_ch_views, bf16
_NET_ARGS = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p] + [ctypes.c_int] * 6
# (each library's entry; its argtypes, which its streaming core's entry,
# ``{entry}_stream``, shares)
_ARGTYPES = {
    "nerf_march": ("nerf_march", [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int]
                   + _NET_ARGS + [ctypes.c_void_p] * 4),
    "nerf_mlp": ("nerf_mlp", [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int]
                 + _NET_ARGS + [ctypes.c_void_p] * 3),
    "render_tile": ("render_tile", [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int]
                    + _NET_ARGS + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                    + [ctypes.c_void_p] * 6),
}
_INT_OUT = ctypes.POINTER(ctypes.c_int)
# every library's queries: (name, argtypes, restype)
_QUERIES = [(fn, [], ctypes.c_int) for fn in ("nerf_width", "nerf_smem_optin")] + [
    (fn, [ctypes.c_int] * 5, ctypes.c_longlong)
    for fn in ("nerf_f32_plan_bytes", "nerf_wgmma_plan_bytes")] + [
    (fn, [ctypes.c_int] * 3, ctypes.c_int)
    for fn in ("nerf_f32_smem_bytes", "nerf_wgmma_smem_bytes")] + [
    ("nerf_f32_launch_bytes", [ctypes.c_int] * 3 + [_INT_OUT], ctypes.c_int),
    ("nerf_wgmma_last_launch", [_INT_OUT], ctypes.c_int),
    ("nerf_stream_plan_bytes", [ctypes.c_int] * 6, ctypes.c_longlong),
    ("nerf_stream_smem_bytes", [ctypes.c_int] * 4, ctypes.c_longlong),
    ("nerf_stream_launch_bytes", [ctypes.c_int] * 4 + [_INT_OUT] * 2, ctypes.c_longlong)]
# the render tile's own: (name, argtypes, restype)
_RENDER_TILE_QUERIES = [
    ("render_tile_max_samples", [ctypes.c_int] * 4, ctypes.c_int),
    ("render_tile_f32_plan", [ctypes.c_int] * 4 + [_INT_OUT] * 3, ctypes.c_int),
    ("render_tile_stream_plan", [ctypes.c_int] * 5 + [_INT_OUT] * 4, ctypes.c_longlong)]


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    lib = build.load(name)
    fn_name, argtypes = _ARGTYPES[name]
    queries = _QUERIES + (_RENDER_TILE_QUERIES if name == "render_tile" else [])
    entries = [(fn, argtypes, ctypes.c_int) for fn in (fn_name, f"{fn_name}_stream")]
    for fn, args, res in entries + queries:
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = res
    return lib


def _on(device):
    """The device a library query reads (a CUDA device's context)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _check_supported(params, net: NeRFNetConfig, lib, what: str, bf16: bool, device,
                     n_samples: int = 0):
    """Raise NotImplementedError, naming the limit, for a net the kernels do
    not take: a net past the JAX kernel's own budget (``jax_vmem_bytes``
    over JAX_VMEM_LIMIT) or whose smallest streaming-core tile does not fit
    the device's shared memory, where ``core_for`` sends it to that core;
    ``n_samples``: the render tile's S. Returns (the trunk depth, its core)."""
    depth = _depth(params)
    if not net.use_viewdirs or net.i_embed != 0:
        raise NotImplementedError(f"{what} kernel: needs use_viewdirs=True and i_embed=0")
    if any(s >= depth - 1 for s in net.skips):
        raise NotImplementedError(f"{what} kernel: a skip after the last "
                                  "trunk layer is not supported")
    width = params["pts_0_kernel"].shape[1]
    expect = {"pts_0_kernel": (net.input_ch, width),
              "feature_kernel": (width, width), "alpha_kernel": (width, 1),
              "views_0_kernel": (width + net.input_ch_views, width // 2),
              "rgb_kernel": (width // 2, 3)}
    for i in range(1, depth):
        expect[f"pts_{i}_kernel"] = (
            (net.input_ch if (i - 1) in net.skips else 0) + width, width)
    for key, shape in expect.items():
        if tuple(params[key].shape) != shape:
            raise NotImplementedError(
                f"{what} kernel: {key} is {tuple(params[key].shape)}, "
                f"expected {shape} for trunk width {width}")
    with _on(device):
        core = core_for(net, width, bf16, lib, render_tile=what == "fused_render_tile")
        if core != STREAM_CORE:
            return depth, core
        need = lib.nerf_stream_smem_bytes(stream_width(width), net.input_ch,
                                          net.input_ch_views, int(bf16))
        have = lib.nerf_smem_optin()
    dtype = "bfloat16" if bf16 else "float32"
    budget = jax_vmem_bytes(what, net, width, depth, bf16, n_samples)
    if budget > JAX_VMEM_LIMIT:
        raise NotImplementedError(
            f"{what} kernel: a {depth}x{width} trunk with {net.input_ch} x_pe and "
            f"{net.input_ch_views} d_pe channels declares {budget} bytes of VMEM blocks in "
            f"{dtype} in the JAX kernel, past its budget of {JAX_VMEM_LIMIT} bytes "
            "(vmem_limit_bytes, 100 MiB)")
    if need > have:
        raise NotImplementedError(
            f"{what} kernel: a {stream_width(width)}-wide trunk with {net.input_ch} x_pe and "
            f"{net.input_ch_views} d_pe channels needs {need} bytes of shared memory per block "
            f"on the streaming core's smallest tile in {dtype}; the device gives {have}")
    return depth, core


def _is_bf16(compute_dtype: torch.dtype, what: str) -> bool:
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: compute_dtype {compute_dtype} is neither "
                         "float32 nor bfloat16")
    return compute_dtype == torch.bfloat16


def _inputs(what: str, device, *specs):
    """(label, tensor, shape) -> float32 contiguous tensors, checked."""
    out = []
    for label, t, shape in specs:
        if t.device != device or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {label} must be {tuple(shape)} on {device}, "
                             f"got {tuple(t.shape)} on {t.device}")
        out.append(t.detach().to(torch.float32).contiguous())
    return out


def _net_args(params, net: NeRFNetConfig, device, bf16: bool, lib, what: str,
              n_samples: int = 0):
    """The net's core (``core_for``), the C interface's net arguments (the
    core's padded width and what it reads: the packed chunks of the wgmma
    core in bf16 and of the FP32 core in float32, the streaming core's
    pieces), and the tensors to keep alive until the launch has been
    queued."""
    depth, core = _check_supported(params, net, lib, what, bf16, device, n_samples)
    for key in param_keys(depth):
        if params[key].device != device:
            raise ValueError(f"{what}: {key} is on {params[key].device}, the inputs on {device}")
    weights, packed, table = _packed_weights(params, net, depth, bf16, lib, what, core)
    ptrs = (ctypes.c_void_p * len(weights))(*[w.data_ptr() for w in weights])
    width = padded_width(core, params["pts_0_kernel"].shape[1])
    return core, [ptrs, table.data_ptr(), width, depth, len(set(net.skips)), net.input_ch,
                  net.input_ch_views, int(bf16), packed.data_ptr()], weights + [packed, table]


def _entry(lib, name: str, core: str):
    """A library's C entry for a core: ``name``, or ``{name}_stream`` on the
    streaming core."""
    return getattr(lib, f"{name}_stream" if core == STREAM_CORE else name)


def _run(fn, device, what: str, *args):
    """Call a kernel's C entry on the device's current stream; raise on a
    launch it refused."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def _launch(params, rays_o, rays_d, viewdirs, z_vals, net: NeRFNetConfig,
            compute_dtype: torch.dtype):
    """nerf_march.cu on CUDA tensors: (sigma [N,S], rgb3 [3,N,S])."""
    what = "fused_nerf_march"
    lib = _library("nerf_march")
    device = z_vals.device
    n, s = z_vals.shape
    ins = _inputs(what, device, ("rays_o", rays_o, (n, 3)), ("rays_d", rays_d, (n, 3)),
                  ("viewdirs", viewdirs, (n, 3)), ("z_vals", z_vals, (n, s)))
    bf16 = _is_bf16(compute_dtype, what)
    core, net_args, _weights = _net_args(params, net, device, bf16, lib, what)
    sigma = torch.empty((n, s), dtype=torch.float32, device=device)
    rgb = torch.empty((3, n, s), dtype=torch.float32, device=device)
    if n * s == 0:
        return sigma, rgb
    if n * s >= 2 ** 31:
        raise ValueError(f"{what}: {n}x{s} samples exceed the kernel's 32-bit grid")
    _run(_entry(lib, "nerf_march", core), device, what, *[t.data_ptr() for t in ins], n, s,
         *net_args, sigma.data_ptr(), rgb.data_ptr())
    fused_nerf_march.launches += 1
    return sigma, rgb


def _launch_mlp(kind: str, params, a, b, net: NeRFNetConfig,
                compute_dtype: torch.dtype):
    """nerf_mlp.cu on CUDA tensors, input stage ``kind``: raw [M,4]."""
    wrapper = {"widepe": fused_nerf_mlp_widepe, "pe": fused_nerf_mlp_pe,
               "encoded": fused_nerf_mlp}[kind]
    what = wrapper.__name__
    lib = _library("nerf_mlp")
    device = a.device
    m = a.shape[0]
    widths = ((net.input_ch, net.input_ch_views) if kind == "encoded" else (3, 3))
    ins = _inputs(what, device, ("first input", a, (m, widths[0])),
                  ("second input", b, (m, widths[1])))
    bf16 = _is_bf16(compute_dtype, what)
    core, net_args, _weights = _net_args(params, net, device, bf16, lib, what)
    raw = torch.empty((m, 4), dtype=torch.float32, device=device)
    if m == 0:
        return raw
    if m >= 2 ** 31:
        raise ValueError(f"{what}: {m} points exceed the kernel's 32-bit grid")
    _run(_entry(lib, "nerf_mlp", core), device, what, *[t.data_ptr() for t in ins], m,
         _KINDS[kind], *net_args, raw.data_ptr())
    wrapper.launches += 1
    return raw


# shared bytes of one render-tile sample beside its core: raw [4] and z,
# and its ray's carried transmittance and five sums (render_tile.cu)
_SAMPLE_BYTES = 5 * 4 + 6 * 4


def _launch_render_tile(params, rays_o, rays_d, viewdirs, z_vals,
                        net: NeRFNetConfig, white_bkgd: bool,
                        compute_dtype: torch.dtype, fast_epilogue: bool):
    """render_tile.cu on CUDA tensors: the raw2outputs tuple."""
    what = "fused_render_tile"
    lib = _library("render_tile")
    device = z_vals.device
    n, s = z_vals.shape
    bf16 = _is_bf16(compute_dtype, what)
    ins = _inputs(what, device, ("rays_o", rays_o, (n, 3)), ("rays_d", rays_d, (n, 3)),
                  ("viewdirs", viewdirs, (n, 3)), ("z_vals", z_vals, (n, s)))
    core, net_args, _weights = _net_args(params, net, device, bf16, lib, what, s)
    # a block keeps a segment of its rays' raw field in shared memory beside
    # its MLP core: a ray of more samples than one segment holds runs in
    # segments, but one sample and its ray's carried sums must fit
    with _on(device):
        segment = lib.render_tile_max_samples(core_code(core, bf16), net_args[2],
                                              net.input_ch, net.input_ch_views)
    if segment < 1:
        raise NotImplementedError(
            f"{what} kernel: the {net_args[2]}-wide {core} core leaves no room in shared memory "
            f"for one sample ({_SAMPLE_BYTES} bytes) in {compute_dtype}")
    f32 = dict(dtype=torch.float32, device=device)
    rgb, disp, acc = torch.empty((n, 3), **f32), torch.empty(n, **f32), torch.empty(n, **f32)
    weights, depth = torch.empty((n, s), **f32), torch.empty(n, **f32)
    if n * s == 0:
        return rgb, disp, acc, weights, depth
    if n * s >= 2 ** 31:
        raise ValueError(f"{what}: {n}x{s} samples exceed the kernel's 32-bit index range")
    _run(_entry(lib, "render_tile", core), device, what, *[t.data_ptr() for t in ins], n, s,
         *net_args, int(fast_epilogue), int(white_bkgd),
         *[t.data_ptr() for t in (rgb, disp, acc, weights, depth)])
    fused_render_tile.launches += 1
    return rgb, disp, acc, weights, depth


# ngp_march.cu: rays o, d, viewdirs, z, N, S, table, five kernels, levels,
# their four int arrays, lo, extent, sigma, rgb, stream
_NGP_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int] + [ctypes.c_void_p] * 6
             + [ctypes.c_int, _INT_OUT, _INT_OUT, ctypes.POINTER(ctypes.c_uint), _INT_OUT]
             + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 3)
_NGP_MAX_LEVELS = 16   # ngp_march.cu's MAX_LEVELS


@functools.lru_cache(maxsize=None)
def _ngp_library() -> ctypes.CDLL:
    lib = build.load("ngp_march")
    lib.ngp_march.argtypes, lib.ngp_march.restype = _NGP_ARGS, ctypes.c_int
    return lib


def _check_ngp(params, net, what: str):
    """Raise NotImplementedError, naming the setting, for a hash-grid field
    the kernel is not built for; ValueError for params of other shapes."""
    if net.hash_levels > _NGP_MAX_LEVELS:
        raise NotImplementedError(f"{what} kernel: hash_levels={net.hash_levels}; the kernel "
                                  f"is built for at most {_NGP_MAX_LEVELS}")
    if net.log2_hashmap_size > 30:
        raise NotImplementedError(f"{what} kernel: log2_hashmap_size={net.log2_hashmap_size} "
                                  "past the kernel's 32-bit rows")
    shapes = dict(ngp.kernel_shapes(net), hash_table=(ngp.table_rows(net), ngp.FEATURES))
    for key, shape in shapes.items():
        if tuple(params[key].shape) != shape:
            raise ValueError(f"{what}: {key} is {tuple(params[key].shape)}, expected {shape}")


@functools.lru_cache(maxsize=8)
def _grid_args(net):
    """The kernel's level arrays of a net (ctypes), and its box."""
    layout = ngp.level_layout(net)
    n = len(layout)
    res = (ctypes.c_int * n)(*[lv.resolution for lv in layout])
    offset = (ctypes.c_int * n)(*[lv.offset for lv in layout])
    side = (ctypes.c_uint * n)(*[lv.resolution + 1 if lv.dense else lv.size - 1
                                 for lv in layout])
    dense = (ctypes.c_int * n)(*[int(lv.dense) for lv in layout])
    lo, hi = net.hash_aabb
    return [n, res, offset, side, dense, float(lo), float(hi - lo)]


def _launch_ngp(params, rays_o, rays_d, viewdirs, z_vals, net):
    """ngp_march.cu on CUDA tensors: (sigma [N,S], rgb3 [3,N,S])."""
    what = "fused_ngp_march"
    lib = _ngp_library()
    device = z_vals.device
    n, s = z_vals.shape
    ins = _inputs(what, device, ("rays_o", rays_o, (n, 3)), ("rays_d", rays_d, (n, 3)),
                  ("viewdirs", viewdirs, (n, 3)), ("z_vals", z_vals, (n, s)))
    _check_ngp(params, net, what)
    weights = []
    for key in ngp.param_keys(net):
        t = params[key]
        if t.device != device or t.dtype != torch.float32:
            raise ValueError(f"{what}: {key} is {t.dtype} on {t.device}, the kernel takes "
                             f"float32 on {device}")
        weights.append(_aligned(t.detach()))
    sigma = torch.empty((n, s), dtype=torch.float32, device=device)
    rgb = torch.empty((3, n, s), dtype=torch.float32, device=device)
    if n * s == 0:
        return sigma, rgb
    if n * s >= 2 ** 31:
        raise ValueError(f"{what}: {n}x{s} samples exceed the kernel's 32-bit grid")
    with span("render.hash_march"):
        _run(lib.ngp_march, device, what, *[t.data_ptr() for t in ins], n, s,
             *[w.data_ptr() for w in weights], *_grid_args(net), sigma.data_ptr(),
             rgb.data_ptr())
    fused_ngp_march.calls += 1
    fused_ngp_march.points += n * s
    return sigma, rgb


class _Recompute(torch.autograd.Function):
    """Kernel forward; backward recomputes ``ref`` in float32 through plain
    autograd (the JAX package's custom_vjp backwards)."""

    @staticmethod
    def forward(ctx, launch, ref, keys, n_in, *tensors):
        ctx.ref, ctx.keys, ctx.n_in = ref, keys, n_in
        ctx.save_for_backward(*tensors)
        return launch(dict(zip(keys, tensors[n_in:])), *tensors[:n_in])

    @staticmethod
    def backward(ctx, *grads):
        needs = ctx.needs_input_grad[4:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, needs)]
            outs = ctx.ref(dict(zip(ctx.keys, leaves[ctx.n_in:])), *leaves[:ctx.n_in])
            outs = outs if isinstance(outs, tuple) else (outs,)
            wanted = [t for t in leaves if t.requires_grad]
            got = iter(torch.autograd.grad(outs, wanted, grads, allow_unused=True))
        return (None, None, None, None, *[next(got) if need else None for need in needs])


def _apply(launch, ref, params, inputs, keys=None):
    keys = tuple(keys or param_keys(_depth(params)))
    return _Recompute.apply(launch, ref, keys, len(inputs), *inputs,
                            *[params[k] for k in keys])


# ------------------------------------------------------------- wrappers --

def fused_nerf_march(params: Dict[str, torch.Tensor], rays_o, rays_d,
                     viewdirs, z_vals, net: NeRFNetConfig,
                     compute_dtype=torch.bfloat16):
    """Ray march: rays o, d, unit viewdirs [N,3] and depths z [N,S] ->
    (sigma [N,S] raw density, rgb3 [3,N,S] logits).

    Gradients recompute through ``march_channels_ref`` in float32 (JAX
    ``_march_bwd``)."""
    compute_dtype = as_dtype(compute_dtype)
    if not uses_kernel(z_vals):
        return march_channels_ref(params, rays_o, rays_d, viewdirs, z_vals,
                                  net, compute_dtype)
    return _apply(
        lambda p, o, d, v, z: _launch(p, o, d, v, z, net, compute_dtype),
        lambda p, o, d, v, z: march_channels_ref(p, o, d, v, z, net, torch.float32),
        params, (rays_o, rays_d, viewdirs, z_vals))


def fused_nerf_mlp_widepe(params: Dict[str, torch.Tensor], pts, dirs,
                          net: NeRFNetConfig, compute_dtype=torch.bfloat16):
    """PE (projection form) + MLP, point-major: pts, dirs [M,3] -> raw
    [M,4] (rgb logits, density).

    Gradients recompute through ``mlp_widepe_ref`` in float32 (JAX
    ``_pe_bwd``)."""
    compute_dtype = as_dtype(compute_dtype)
    if not uses_kernel(pts):
        return mlp_widepe_ref(params, pts, dirs, net, compute_dtype)
    return _apply(
        lambda p, x, d: _launch_mlp("widepe", p, x, d, net, compute_dtype),
        lambda p, x, d: mlp_widepe_ref(p, x, d, net, torch.float32),
        params, (pts, dirs))


def fused_nerf_mlp_pe(params: Dict[str, torch.Tensor], pts, dirs,
                      net: NeRFNetConfig, compute_dtype=torch.bfloat16):
    """PE with a true cos + MLP, point-major: pts, dirs [M,3] -> raw [M,4].

    Gradients recompute through the projection form (``mlp_widepe_ref``)
    in float32, exactly as JAX ``_pe_bwd`` does."""
    compute_dtype = as_dtype(compute_dtype)
    if not uses_kernel(pts):
        return mlp_pe_ref(params, pts, dirs, net, compute_dtype)
    return _apply(
        lambda p, x, d: _launch_mlp("pe", p, x, d, net, compute_dtype),
        lambda p, x, d: mlp_widepe_ref(p, x, d, net, torch.float32),
        params, (pts, dirs))


def fused_nerf_mlp(params: Dict[str, torch.Tensor], x_pe, d_pe,
                   net: NeRFNetConfig, compute_dtype=torch.bfloat16):
    """The MLP on pre-encoded inputs x_pe [M, input_ch], d_pe [M,
    input_ch_views] -> raw [M,4]: ``nerf_apply`` for view-direction nets.

    Gradients recompute through ``nerf_apply`` in float32 (JAX ``_bwd``)."""
    compute_dtype = as_dtype(compute_dtype)
    if not uses_kernel(x_pe):
        return nerf_apply(params, x_pe, d_pe, net, compute_dtype=compute_dtype)
    return _apply(
        lambda p, x, d: _launch_mlp("encoded", p, x, d, net, compute_dtype),
        lambda p, x, d: nerf_apply(p, x, d, net, compute_dtype=torch.float32),
        params, (x_pe, d_pe))


def fused_render_tile(params: Dict[str, torch.Tensor], rays_o, rays_d,
                      viewdirs, z_vals, net: NeRFNetConfig,
                      white_bkgd: bool = False, compute_dtype=torch.bfloat16,
                      fast_epilogue: bool = False):
    """March and composite whole rays: rays o, d, unit viewdirs [N,3] and
    depths z [N,S] -> (rgb [N,3], disp [N], acc [N], weights [N,S],
    depth [N]), the raw2outputs tuple without density noise.

    ``fast_epilogue`` rounds each ReLU layer's product and bias to bf16
    before the add (no change in float32). Forward only, as in JAX: on the
    card it raises when grad mode is on and an input requires grad."""
    compute_dtype = as_dtype(compute_dtype)
    if not uses_kernel(z_vals):
        return render_tile_ref(params, rays_o, rays_d, viewdirs, z_vals, net,
                               white_bkgd, compute_dtype, fast_epilogue)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (rays_o, rays_d, viewdirs, z_vals, *params.values())):
        raise RuntimeError(
            "fused_render_tile is forward only: an input requires grad. Use "
            "fuse_compositing=False (the march kernel, whose gradient "
            "recomputes through its twin) or torch.no_grad()")
    return _launch_render_tile(params, rays_o, rays_d, viewdirs, z_vals, net,
                               white_bkgd, compute_dtype, fast_epilogue)


def fused_ngp_march(params: Dict[str, torch.Tensor], rays_o, rays_d, viewdirs, z_vals,
                    net: NeRFNetConfig, compute_dtype=torch.float32):
    """Ray march of a hash-grid field (``models/ngp.py``): rays o, d, unit
    viewdirs [N,3] and depths z [N,S] -> (sigma [N,S], rgb3 [3,N,S]
    logits), in float32 only.

    Gradients recompute through ``ngp_march_ref`` in float32; the table's
    is a scatter-add of the corners' weights."""
    if not ngp.is_hash_field(net):
        raise ValueError(f"fused_ngp_march: a hash-grid field (i_embed={ngp.HASH_EMBED}), "
                         f"not i_embed={net.i_embed}")
    ngp.check_float32(net, "fused_ngp_march", compute_dtype=compute_dtype)
    if not uses_kernel(z_vals):
        return ngp_march_ref(params, rays_o, rays_d, viewdirs, z_vals, net)
    return _apply(
        lambda p, o, d, v, z: _launch_ngp(p, o, d, v, z, net),
        lambda p, o, d, v, z: ngp_march_ref(p, o, d, v, z, net),
        params, (rays_o, rays_d, viewdirs, z_vals), keys=ngp.param_keys(net))


for _fn in (fused_nerf_march, fused_nerf_mlp_widepe, fused_nerf_mlp_pe,
            fused_nerf_mlp, fused_render_tile):
    _fn.launches = 0
fused_ngp_march.calls = fused_ngp_march.points = 0
