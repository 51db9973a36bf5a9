"""The NeRF ray march: point generation, positional encoding and the whole
MLP for every sample of a ray bundle, channel-separated raw outputs.

``fused_nerf_march`` is the port of ``neuralsim_tpu/kernels/raymarch.py``'s
``fused_nerf_march`` (Pallas body ``_march_channels_kernel``). On a CUDA
tensor it launches the Hopper kernel of ``csrc/nerf_march.cu`` or raises;
on a CPU tensor it computes the plain PyTorch version
``march_channels_ref``. Its gradient recomputes through that plain version,
as the JAX custom_vjp does (``raymarch.py:1077-1083``).

``fused_nerf_march.launches`` counts kernel launches, so a run can show
that its render went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List

import torch

from neuralsim_tpu_torch.config import NeRFNetConfig
from neuralsim_tpu_torch.kernels import build
from neuralsim_tpu_torch.models.nerf import nerf_apply, round_to
from neuralsim_tpu_torch.ops.encoding import positional_encoding


def as_dtype(compute_dtype) -> torch.dtype:
    return getattr(torch, compute_dtype) if isinstance(compute_dtype, str) else compute_dtype


def march_channels_ref(params: Dict[str, torch.Tensor], rays_o, rays_d,
                       viewdirs, z_vals, net: NeRFNetConfig,
                       compute_dtype=torch.float32):
    """Plain PyTorch march: (sigma [N,S] raw density, rgb3 [3,N,S] logits)."""
    n, s = z_vals.shape
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    dirs = viewdirs[:, None, :].expand(n, s, 3)
    raw = nerf_apply(
        params,
        positional_encoding(pts.reshape(-1, 3), net.multires),
        positional_encoding(dirs.reshape(-1, 3), net.multires_views),
        net, compute_dtype=as_dtype(compute_dtype),
    ).reshape(n, s, 4)
    return raw[..., 3], torch.movedim(raw[..., :3], -1, 0)


def param_keys(depth: int) -> List[str]:
    """Kernel-then-bias keys in the order the CUDA kernel takes them."""
    names = [f"pts_{i}" for i in range(depth)] + ["feature", "alpha", "views_0", "rgb"]
    return [f"{n}_{kind}" for n in names for kind in ("kernel", "bias")]


def _depth(params) -> int:
    return sum(1 for k in params if k.startswith("pts_") and k.endswith("kernel"))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("nerf_march")
    vp = ctypes.c_void_p
    lib.nerf_march.argtypes = [
        vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_int,
        ctypes.POINTER(vp), ctypes.c_int, ctypes.c_uint, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, vp, vp, vp,
    ]
    lib.nerf_march.restype = ctypes.c_int
    for fn in ("nerf_march_width", "nerf_march_max_layers",
               "nerf_march_max_in_ch", "nerf_march_max_in_ch_views"):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _check_supported(params, net: NeRFNetConfig, lib) -> int:
    """Raise NotImplementedError for a net the kernel was not written for;
    returns the trunk depth."""
    depth = _depth(params)
    width = lib.nerf_march_width()
    if not net.use_viewdirs or net.i_embed != 0:
        raise NotImplementedError(
            "fused_nerf_march kernel: needs use_viewdirs=True and i_embed=0")
    if (net.input_ch > lib.nerf_march_max_in_ch()
            or net.input_ch_views > lib.nerf_march_max_in_ch_views()
            or depth + 4 > lib.nerf_march_max_layers()):
        raise NotImplementedError(
            f"fused_nerf_march kernel: multires<=10, multires_views<=4 and "
            f"depth<={lib.nerf_march_max_layers() - 4} only, got {net}")
    if any(s >= depth - 1 for s in net.skips):
        raise NotImplementedError("fused_nerf_march kernel: a skip after the "
                                  "last trunk layer is not supported")
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
                f"fused_nerf_march kernel: {key} is {tuple(params[key].shape)}, "
                f"the kernel takes {shape} (trunk width {width})")
    return depth


def _launch(params, rays_o, rays_d, viewdirs, z_vals, net: NeRFNetConfig,
            compute_dtype: torch.dtype):
    lib = _library()
    depth = _check_supported(params, net, lib)
    device = z_vals.device
    n, s = z_vals.shape
    ins = []
    for name, t, shape in (("rays_o", rays_o, (n, 3)), ("rays_d", rays_d, (n, 3)),
                           ("viewdirs", viewdirs, (n, 3)), ("z_vals", z_vals, (n, s))):
        if t.device != device or tuple(t.shape) != shape:
            raise ValueError(f"fused_nerf_march: {name} must be {shape} on "
                             f"{device}, got {tuple(t.shape)} on {t.device}")
        ins.append(t.detach().to(torch.float32).contiguous())
    bf16 = compute_dtype == torch.bfloat16
    if not bf16 and compute_dtype != torch.float32:
        raise ValueError(f"fused_nerf_march: compute_dtype {compute_dtype} "
                         "is neither float32 nor bfloat16")
    weights = []
    for key in param_keys(depth):
        w = params[key].detach()
        if w.device != device:
            raise ValueError(f"fused_nerf_march: {key} is on {w.device}, "
                             f"the rays on {device}")
        w = w.to(torch.float32)
        if bf16 and key.endswith("kernel"):
            w = round_to(w, torch.bfloat16)
        w = w.contiguous()
        if w.data_ptr() % 16:
            w = w.clone()
        weights.append(w)

    sigma = torch.empty((n, s), dtype=torch.float32, device=device)
    rgb = torch.empty((3, n, s), dtype=torch.float32, device=device)
    if n * s == 0:
        return sigma, rgb
    if n * s >= 2 ** 31:
        raise ValueError(f"fused_nerf_march: {n}x{s} samples exceed the "
                         "kernel's 32-bit block index range")
    ptrs = (ctypes.c_void_p * len(weights))(*[w.data_ptr() for w in weights])
    skip_mask = sum(1 << sk for sk in net.skips)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.nerf_march(
            *[t.data_ptr() for t in ins], n, s, ptrs, depth, skip_mask,
            net.input_ch, net.input_ch_views, int(bf16),
            sigma.data_ptr(), rgb.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"nerf_march kernel launch failed: cudaError {err}")
    fused_nerf_march.launches += 1
    return sigma, rgb


class _FusedMarch(torch.autograd.Function):
    """Kernel forward; backward recomputes through march_channels_ref in
    float32 (the JAX package's _march_bwd)."""

    @staticmethod
    def forward(ctx, net, compute_dtype, keys, rays_o, rays_d, viewdirs,
                z_vals, *weights):
        ctx.net, ctx.keys = net, keys
        ctx.save_for_backward(rays_o, rays_d, viewdirs, z_vals, *weights)
        return _launch(dict(zip(keys, weights)), rays_o, rays_d, viewdirs,
                       z_vals, net, compute_dtype)

    @staticmethod
    def backward(ctx, g_sigma, g_rgb):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need) for t, need in zip(saved, needs)]
            o, d, v, z, *weights = inputs
            sigma, rgb = march_channels_ref(dict(zip(ctx.keys, weights)), o, d, v, z,
                                            ctx.net, torch.float32)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad((sigma, rgb), wanted, (g_sigma, g_rgb),
                                             allow_unused=True))
        return (None, None, None, *[next(grads) if need else None for need in needs])


def fused_nerf_march(params: Dict[str, torch.Tensor], rays_o, rays_d,
                     viewdirs, z_vals, net: NeRFNetConfig,
                     compute_dtype=torch.float32):
    """Ray march: rays o, d, unit viewdirs [N,3] and depths z [N,S] ->
    (sigma [N,S] raw density, rgb3 [3,N,S] logits).

    CUDA tensors launch the kernel (or raise); CPU tensors take
    ``march_channels_ref``."""
    compute_dtype = as_dtype(compute_dtype)
    if not z_vals.is_cuda:
        return march_channels_ref(params, rays_o, rays_d, viewdirs, z_vals,
                                  net, compute_dtype)
    keys = tuple(param_keys(_depth(params)))
    return _FusedMarch.apply(net, compute_dtype, keys, rays_o, rays_d,
                             viewdirs, z_vals, *[params[k] for k in keys])


fused_nerf_march.launches = 0
