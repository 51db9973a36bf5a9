"""Volume-rendering primitives: stratified sampling, alpha compositing,
inverse-CDF importance sampling.

Parity targets (reference ``optimization/utils/``):
  - stratified z-vals + jitter:    run_nerf_noscale.py:439-461
  - raw2outputs compositing:       run_nerf_noscale.py:343-387
  - sample_pdf inverse CDF:        run_nerf_helpers.py:199-243

Randomness comes in as explicit uniform draws ``u`` (or a
``torch.Generator`` that draws them), so a test can feed the JAX package
and the port the same numbers. Disparity is NaN-free: the denominator
``sum(weights)`` is clamped, as in ``neuralsim_tpu/ops/volume.py:84-86``.
"""

from __future__ import annotations

from typing import Optional

import torch

from bench_port.reference.common import draw


def linspace01(n: int, device=None) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` to the bit: i * float32(1 / (n - 1)) with
    the last value exactly 1. ``torch.linspace`` steps from both ends and
    differs in the last ulp, which can move a ``sample_pdf`` draw across a
    CDF step."""
    if n == 1:
        return torch.zeros(1, device=device)
    step = torch.tensor(1.0, dtype=torch.float32) / (n - 1)
    t = torch.arange(n, dtype=torch.float32, device=device) * step.to(device)
    t[-1] = 1.0
    return t


# sample_pdf sums in the order XLA gives jnp.sum / jnp.cumsum, not just to
# the same value: when the tail of a ray's PDF is empty, the last CDF entry
# is 1 give or take an ulp, and the side of 1 it lands on moves the u=1
# draw by a whole bin (the denom < 1e-5 guard). Matching the order keeps
# the port's depths equal to the JAX package's on the same inputs.


def _cumsum_sequential(x: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(x)
    acc = torch.zeros_like(x[..., 0])
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
        out[..., i] = acc
    return out


def sum_blocked(x: torch.Tensor, window: int = 32) -> torch.Tensor:
    """float32 sum over the last axis in XLA's order: sequential sums over
    windows of ``window`` (the row centred in zero padding), then the same
    over the window sums."""
    n = x.shape[-1]
    if n <= window:
        return _cumsum_sequential(x)[..., -1]
    pad = -(-n // window) * window - n
    padded = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
    parts = _cumsum_sequential(padded.reshape(*x.shape[:-1], -1, window))[..., -1]
    return sum_blocked(parts, window)


def cumsum_blocked(x: torch.Tensor, base: int = 16) -> torch.Tensor:
    """Inclusive float32 cumsum over the last axis in XLA's order:
    sequential sums inside blocks of ``base``, plus the running total of
    the earlier blocks (itself a blocked cumsum)."""
    n = x.shape[-1]
    if n <= base:
        return _cumsum_sequential(x)
    nb = -(-n // base)
    blocks = torch.nn.functional.pad(x, (0, nb * base - n)).reshape(
        *x.shape[:-1], nb, base)
    inner = _cumsum_sequential(blocks)
    totals = cumsum_blocked(inner[..., -1], base)
    before = torch.cat([torch.zeros_like(totals[..., :1]), totals[..., :-1]], -1)
    return (inner + before[..., None]).reshape(*x.shape[:-1], nb * base)[..., :n]


def _as_column(v, n_rays: int, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device).reshape(-1, 1).expand(n_rays, 1)


def stratified_z_vals(n_rays: int, n_samples: int, near, far,
                      perturb: bool, lindisp: bool = False,
                      u: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      device=None) -> torch.Tensor:
    """Coarse sample depths [n_rays, n_samples] between near and far.

    near/far are scalars or [n_rays] / [n_rays, 1] tensors. With perturb,
    the jitter draws are ``u`` [n_rays, n_samples] when given, else drawn
    from ``generator``.
    """
    t_vals = linspace01(n_samples, device)
    near = _as_column(near, n_rays, device)
    far = _as_column(far, n_rays, device)
    if lindisp:
        z_vals = 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)
    else:
        z_vals = near * (1.0 - t_vals) + far * t_vals
    z_vals = z_vals.expand(n_rays, n_samples)
    if perturb:
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], -1)
        lower = torch.cat([z_vals[..., :1], mids], -1)
        if u is None:
            u = draw(z_vals.shape, generator, z_vals.device)
        z_vals = lower + (upper - lower) * u
    return z_vals


def _composite(sigma, rgb_of_channel, z_vals, rays_d, noise, raw_noise_std,
               white_bkgd):
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)

    if raw_noise_std > 0.0:
        if noise is None:
            raise ValueError("raw_noise_std > 0 requires noise draws or a generator")
        sigma = sigma + noise * raw_noise_std

    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    # exclusive cumprod of transmittance
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], dim=-1),
        dim=-1,
    )[..., :-1]
    weights = alpha * trans

    rgb_map = torch.stack(
        [torch.sum(weights * rgb_of_channel(c), dim=-1) for c in range(3)], dim=-1)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    disp_map = 1.0 / torch.clamp(
        depth_map / torch.clamp(acc_map, min=1e-10), min=1e-10)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return rgb_map, disp_map, acc_map, weights, depth_map


def _density_noise(shape, noise, raw_noise_std, generator, device):
    if raw_noise_std > 0.0 and noise is None and generator is not None:
        noise = draw(shape, generator, device, normal=True)
    return noise


def raw2outputs(raw, z_vals, rays_d, raw_noise_std: float = 0.0,
                white_bkgd: bool = False, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
    """Alpha-composite raw network outputs [N, S, 4] (rgb logits, density)
    along each ray. ``noise`` [N, S] standard-normal draws (or a generator)
    feed the density regularizer when raw_noise_std > 0.

    Returns rgb_map [N,3], disp_map [N], acc_map [N], weights [N,S],
    depth_map [N].
    """
    noise = _density_noise(raw.shape[:-1], noise, raw_noise_std, generator,
                           raw.device)
    rgb = torch.sigmoid(raw[..., :3])
    return _composite(raw[..., 3], lambda c: rgb[..., c], z_vals, rays_d,
                      noise, raw_noise_std, white_bkgd)


def sample_pdf(bins, weights, n_samples: int, det: bool,
               u: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverse-transform sample n_samples depths from the piecewise-constant
    PDF ``weights`` [N, B-1] over the bin edges ``bins`` [N, B].

    det=True takes linspace draws (test mode); otherwise ``u``
    [N, n_samples] uniform draws, or draws from ``generator``.
    Returns [N, n_samples] depths.
    """
    weights = weights + 1e-5
    pdf = weights / sum_blocked(weights)[..., None]
    cdf = cumsum_blocked(pdf)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)   # [N, B]

    shape = cdf.shape[:-1] + (n_samples,)
    if det:
        u = linspace01(n_samples, cdf.device).expand(shape)
    elif u is None:
        u = draw(shape, generator, cdf.device)
    u = u.contiguous()

    b = cdf.shape[-1]
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=b - 1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)
