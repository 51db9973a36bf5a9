"""Frequency positional encoding gamma(x).

Channel order of the reference Embedder (run_nerf_helpers.py:18-66):
``[x, sin(x*2^0), cos(x*2^0), ..., sin(x*2^{L-1}), cos(x*2^{L-1})]``,
each sin/cos block over the D input dims. Two formulations, as in the JAX
package (``neuralsim_tpu/ops/encoding.py:45-78``):

- ``projection=True``: every trig channel is ``sin(x * 2^k + phase)`` with
  phase 0 or pi/2, the arithmetic of the JAX projection form and of the
  CUDA kernels that encode in place;
- ``projection=False``: explicit ``sin`` and ``cos`` of ``x * 2^k``. In
  float32 the two differ by up to a few 1e-5 at the 2^9 frequency, where
  the argument is hundreds of radians and ``+ pi/2`` rounds.
"""

from __future__ import annotations

import math

import torch


def positional_encoding(x: torch.Tensor, num_freqs: int,
                        include_input: bool = True,
                        projection: bool = True) -> torch.Tensor:
    """gamma(x) for x[..., D] -> [..., D*(include + 2*num_freqs)]."""
    if num_freqs == 0:
        return x
    d = x.shape[-1]
    freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    # [..., L, 2, D]: frequency k, (sin, cos), input dim
    xb = x[..., None, None, :] * freqs[:, None, None]
    if projection:
        phase = torch.tensor([0.0, math.pi / 2.0], dtype=x.dtype, device=x.device)
        enc = torch.sin(xb + phase[:, None])
    else:
        enc = torch.cat([torch.sin(xb), torch.cos(xb)], dim=-2)
    enc = enc.reshape(*x.shape[:-1], 2 * num_freqs * d)
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc
