"""Gumbel-softmax relaxation of categorical sampling (reference
gumble.py:57-70): a soft sample is ``sum(softmax((logits + g)/T) * values)``
with g ~ Gumbel(0, 1). The noise is an explicit input, so the same draws
can be replayed."""

from __future__ import annotations

from typing import Optional

import torch

from bench_port.reference.common import draw


def gumbel_noise(shape, generator: Optional[torch.Generator] = None,
                 device="cpu") -> torch.Tensor:
    """g ~ Gumbel(0, 1) via -log(-log(U)), U ~ U[1e-20, 1)."""
    u = 1e-20 + (1.0 - 1e-20) * draw(shape, generator)
    return (-torch.log(-torch.log(u))).to(device)


def gumbel_softmax_expectation(logits, values, noise, temperature: float):
    """E_{softmax((logits + noise)/T)}[values] over the last axis."""
    y = torch.softmax((logits + noise) / temperature, dim=-1)
    return torch.sum(y * values, dim=-1)
