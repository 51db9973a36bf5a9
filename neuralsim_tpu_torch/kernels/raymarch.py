"""The NeRF kernels: the port of every Pallas kernel of
``neuralsim_tpu/kernels/raymarch.py`` as a CUDA kernel for Hopper.

| wrapper                 | JAX kernel body          | CUDA source          | plain twin           |
|-------------------------|--------------------------|----------------------|----------------------|
| ``fused_nerf_march``    | ``_march_channels_kernel`` | ``nerf_march.cu``  | ``march_channels_ref`` |
| ``fused_nerf_mlp_widepe`` | ``_mlp_widepe_kernel`` | ``nerf_mlp.cu``      | ``mlp_widepe_ref``   |
| ``fused_nerf_mlp_pe``   | ``_mlp_pe_kernel``       | ``nerf_mlp.cu``      | ``mlp_pe_ref``       |
| ``fused_nerf_mlp``      | ``_mlp_kernel``          | ``nerf_mlp.cu``      | ``nerf_apply``       |
| ``fused_render_tile``   | ``_render_tile_kernel``  | ``render_tile.cu``   | ``render_tile_ref``  |

On a tensor for which ``uses_kernel`` is true (a CUDA tensor) a wrapper
launches its kernel or raises; on a CPU tensor it computes its plain
PyTorch twin. Every wrapper computes in bfloat16 unless asked for float32,
as the JAX package's wrappers do. In bfloat16, ``nerf_march.cu``,
``render_tile.cu`` and ``nerf_mlp.cu``'s projection and encoded stages
(``fused_nerf_mlp_widepe``, ``fused_nerf_mlp``) multiply on the tensor
cores (``nerf_mlp_wgmma.cuh``) from weights that ``pack_wgmma_weights``
lays out once per weight set; float32, and ``fused_nerf_mlp_pe`` in both
types, run the FP32 core (``nerf_mlp.cuh``). Gradients of the first four
recompute through a twin in float32, as the JAX custom_vjp backwards do;
``fused_render_tile`` is forward only, as in JAX, and raises when asked for
a gradient on the card.

Each wrapper's ``launches`` counts its kernel's launches, so a run can show
that its render went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from collections import OrderedDict
from typing import Dict, List

import torch

from neuralsim_tpu_torch.config import NeRFNetConfig
from neuralsim_tpu_torch.kernels import build
from neuralsim_tpu_torch.models.nerf import nerf_apply, round_to
from neuralsim_tpu_torch.ops.encoding import positional_encoding
from neuralsim_tpu_torch.ops.volume import raw2outputs

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


# wgmma weight chunks (nerf_mlp_wgmma.cuh): 64 input rows each
CHUNK_K = 64


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


def pack_wgmma_weights(params: Dict[str, torch.Tensor], net: NeRFNetConfig) -> torch.Tensor:
    """The trunk, feature and views kernels as the flat bf16 chunks that
    the bf16 kernels stream, in the order they consume them: layer 0
    (x_pe), each later trunk layer (its x_pe rows first after a skip), the
    feature layer, then the views layer (feature rows, then d_pe rows).
    1.196 MB for the default 8x256 net."""
    depth = _depth(params)
    parts = [_swizzled_chunks(params["pts_0_kernel"])]
    for i in range(1, depth):
        k = params[f"pts_{i}_kernel"]
        if (i - 1) in net.skips:
            parts += [_swizzled_chunks(k[:net.input_ch]), _swizzled_chunks(k[net.input_ch:])]
        else:
            parts.append(_swizzled_chunks(k))
    views = params["views_0_kernel"]
    n_feature = views.shape[0] - net.input_ch_views
    parts += [_swizzled_chunks(params["feature_kernel"]),
              _swizzled_chunks(views[:n_feature]), _swizzled_chunks(views[n_feature:])]
    return torch.cat(parts)


def wgmma_bytes(depth: int, n_skips: int, width: int) -> int:
    """Bytes of ``pack_wgmma_weights`` for a net whose x_pe and d_pe fit one
    chunk each: the chunk plan of nerf_mlp_wgmma.cuh (width 256: 34 chunks
    of [256][64] and 5 of [128][64])."""
    h = -(-width // CHUNK_K)                      # chunks of a width-wide input
    n_wide = 1 + h * (depth - 1) + n_skips + h
    return (n_wide * width + (h + 1) * (width // 2)) * CHUNK_K * 2


# packed weights of the last few weight sets, keyed by the tensors' ids and
# versions; the entry holds the tensors, so an id is not reused while cached
_PACKED: "OrderedDict[tuple, tuple]" = OrderedDict()


def _packed_weights(params, net: NeRFNetConfig, depth: int, what: str) -> torch.Tensor:
    """pack_wgmma_weights, once per weight set (an in-place update of a
    weight packs again); checked against the kernels' chunk plan."""
    tensors = tuple(params[k] for k in param_keys(depth))
    key = (tuple((id(t), t._version) for t in tensors), net.input_ch, net.input_ch_views,
           tuple(net.skips))
    if key in _PACKED:
        _PACKED.move_to_end(key)
        return _PACKED[key][1]
    packed = pack_wgmma_weights(params, net)
    width = params["pts_0_kernel"].shape[1]
    if packed.numel() * 2 != wgmma_bytes(depth, len(net.skips), width) or packed.data_ptr() % 16:
        raise ValueError(f"{what}: packed weights of {packed.numel() * 2} bytes at "
                         f"{packed.data_ptr():#x} do not match the kernel's chunk plan")
    _PACKED[key] = (tensors, packed)
    if len(_PACKED) > 4:
        _PACKED.popitem(last=False)
    return packed


_NET_ARGS = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_uint,
             ctypes.c_int, ctypes.c_int, ctypes.c_int]
_ARGTYPES = {
    "nerf_march": ("nerf_march", [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int]
                   + _NET_ARGS + [ctypes.c_void_p] * 4),
    "nerf_mlp": ("nerf_mlp", [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int]
                 + _NET_ARGS + [ctypes.c_void_p] * 3),
    "render_tile": ("render_tile", [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int]
                    + _NET_ARGS + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                    + [ctypes.c_void_p] * 6),
}


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    lib = build.load(name)
    fn_name, argtypes = _ARGTYPES[name]
    getattr(lib, fn_name).argtypes = argtypes
    getattr(lib, fn_name).restype = ctypes.c_int
    for fn in ("nerf_width", "nerf_max_layers", "nerf_max_in_ch", "nerf_max_in_ch_views"):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _check_supported(params, net: NeRFNetConfig, lib, what: str) -> int:
    """Raise NotImplementedError for a net the kernels were not written
    for; returns the trunk depth."""
    depth = _depth(params)
    width = lib.nerf_width()
    if not net.use_viewdirs or net.i_embed != 0:
        raise NotImplementedError(f"{what} kernel: needs use_viewdirs=True and i_embed=0")
    if (net.input_ch > lib.nerf_max_in_ch()
            or net.input_ch_views > lib.nerf_max_in_ch_views()
            or depth + 4 > lib.nerf_max_layers()):
        raise NotImplementedError(
            f"{what} kernel: multires<=10, multires_views<=4 and "
            f"depth<={lib.nerf_max_layers() - 4} only, got {net}")
    if any(s >= depth - 1 for s in net.skips):
        raise NotImplementedError(f"{what} kernel: a skip after the last "
                                  "trunk layer is not supported")
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
                f"the kernel takes {shape} (trunk width {width})")
    return depth


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


def _net_args(params, net: NeRFNetConfig, device, bf16: bool, lib, what: str):
    """The C interface's net arguments, and the weight tensors to keep
    alive until the launch has been queued."""
    depth = _check_supported(params, net, lib, what)
    weights = []
    for key in param_keys(depth):
        w = params[key].detach()
        if w.device != device:
            raise ValueError(f"{what}: {key} is on {w.device}, the inputs on {device}")
        w = w.to(torch.float32)
        if bf16 and key.endswith("kernel"):
            w = round_to(w, torch.bfloat16)
        w = w.contiguous()
        if w.data_ptr() % 16:
            w = w.clone()
        weights.append(w)
    ptrs = (ctypes.c_void_p * len(weights))(*[w.data_ptr() for w in weights])
    skip_mask = sum(1 << sk for sk in net.skips)
    return [ptrs, depth, skip_mask, net.input_ch, net.input_ch_views, int(bf16)], weights


def _wgmma_args(params, net: NeRFNetConfig, device, bf16: bool, lib, what: str):
    """_net_args plus the packed bf16 weights (None in float32) of the
    sources with a wgmma core."""
    net_args, weights = _net_args(params, net, device, bf16, lib, what)
    if not bf16:
        return net_args + [None], weights
    packed = _packed_weights(params, net, net_args[1], what)
    return net_args + [packed.data_ptr()], weights + [packed]


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
    net_args, _weights = _wgmma_args(params, net, device, _is_bf16(compute_dtype, what), lib,
                                     what)
    sigma = torch.empty((n, s), dtype=torch.float32, device=device)
    rgb = torch.empty((3, n, s), dtype=torch.float32, device=device)
    if n * s == 0:
        return sigma, rgb
    if n * s >= 2 ** 31:
        raise ValueError(f"{what}: {n}x{s} samples exceed the kernel's 32-bit grid")
    _run(lib.nerf_march, device, what, *[t.data_ptr() for t in ins], n, s,
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
    if kind == "pe":  # the true-cos stage runs the FP32 core in both types
        net_args, _weights = _net_args(params, net, device, bf16, lib, what)
        net_args.append(None)
    else:
        net_args, _weights = _wgmma_args(params, net, device, bf16, lib, what)
    raw = torch.empty((m, 4), dtype=torch.float32, device=device)
    if m == 0:
        return raw
    if m >= 2 ** 31:
        raise ValueError(f"{what}: {m} points exceed the kernel's 32-bit grid")
    _run(lib.nerf_mlp, device, what, *[t.data_ptr() for t in ins], m, _KINDS[kind],
         *net_args, raw.data_ptr())
    wrapper.launches += 1
    return raw


def _launch_render_tile(params, rays_o, rays_d, viewdirs, z_vals,
                        net: NeRFNetConfig, white_bkgd: bool,
                        compute_dtype: torch.dtype, fast_epilogue: bool):
    """render_tile.cu on CUDA tensors: the raw2outputs tuple."""
    what = "fused_render_tile"
    lib = _library("render_tile")
    device = z_vals.device
    n, s = z_vals.shape
    bf16 = _is_bf16(compute_dtype, what)
    # a block keeps its rays' raw field in shared memory beside its MLP core
    max_samples = 1024 if bf16 else 2048
    if s > max_samples:
        raise NotImplementedError(f"{what} kernel: at most {max_samples} samples per ray in "
                                  f"{compute_dtype}, got {s}")
    ins = _inputs(what, device, ("rays_o", rays_o, (n, 3)), ("rays_d", rays_d, (n, 3)),
                  ("viewdirs", viewdirs, (n, 3)), ("z_vals", z_vals, (n, s)))
    net_args, _weights = _wgmma_args(params, net, device, bf16, lib, what)
    f32 = dict(dtype=torch.float32, device=device)
    rgb, disp, acc = torch.empty((n, 3), **f32), torch.empty(n, **f32), torch.empty(n, **f32)
    weights, depth = torch.empty((n, s), **f32), torch.empty(n, **f32)
    if n * s == 0:
        return rgb, disp, acc, weights, depth
    if n * s >= 2 ** 31:
        raise ValueError(f"{what}: {n}x{s} samples exceed the kernel's 32-bit index range")
    _run(lib.render_tile, device, what, *[t.data_ptr() for t in ins], n, s, *net_args,
         int(fast_epilogue), int(white_bkgd),
         *[t.data_ptr() for t in (rgb, disp, acc, weights, depth)])
    fused_render_tile.launches += 1
    return rgb, disp, acc, weights, depth


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


def _apply(launch, ref, params, inputs):
    keys = tuple(param_keys(_depth(params)))
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


for _fn in (fused_nerf_march, fused_nerf_mlp_widepe, fused_nerf_mlp_pe,
            fused_nerf_mlp, fused_render_tile):
    _fn.launches = 0
