"""Sampler diagnostics (the port of ``neuralsim_tpu/sampler/diagnostics.py``;
the reference's gumble.py __main__ demo, ``optimization/utils/gumble.py:85-134``):
draw many soft samples at several temperatures, histogram them against the
target categorical, optionally draw a figure (matplotlib optional)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from neuralsim_tpu_torch import draw, resolve_device
from neuralsim_tpu_torch.config import SamplerConfig
from neuralsim_tpu_torch.sampler.gumbel import gumbel_noise, gumbel_softmax_expectation
from neuralsim_tpu_torch.sampler.poses import bin_centers


def sample_histogram(probs, temperature: float, n_samples: int = 1000,
                     generator: Optional[torch.Generator] = None,
                     sc: Optional[SamplerConfig] = None, device=None,
                     gumbel=None, uniform=None) -> np.ndarray:
    """Empirical bin frequencies of gumbel-softmax(+uniform-in-bin) samples,
    computed on ``device`` (``cuda`` unless the caller asks for the CPU).
    The Gumbel noise [n_samples, n_bins] and the in-bin uniforms
    [n_samples] are drawn from ``generator`` (a fresh one on ``device``,
    seeded 0, by default) unless both are given."""
    sc = sc or SamplerConfig()
    device = resolve_device(device)
    if gumbel is None or uniform is None:
        generator = (generator if generator is not None
                     else torch.Generator(device=device).manual_seed(0))
        gumbel = gumbel_noise((n_samples, sc.n_bins), generator, device)
        uniform = draw((n_samples,), generator, device)
    gumbel = torch.as_tensor(gumbel, dtype=torch.float32, device=device)
    uniform = torch.as_tensor(uniform, dtype=torch.float32, device=device)
    logits = torch.log(torch.as_tensor(np.asarray(probs), dtype=torch.float32,
                                       device=device) + 1e-12)
    soft = gumbel_softmax_expectation(logits, bin_centers(sc, device), gumbel, temperature)
    samples = soft - sc.bin_width_deg / 2 + sc.bin_width_deg * uniform
    bins = np.floor_divide(samples.cpu().numpy(), sc.bin_width_deg).astype(int)
    bins = np.mod(bins, sc.n_bins)
    return np.bincount(bins, minlength=sc.n_bins) / len(bins)


def temperature_sweep(probs, temperatures: Sequence[float] = (0.01, 0.1, 5.0),
                      n_samples: int = 1000, generator: Optional[torch.Generator] = None,
                      device=None) -> Dict[float, np.ndarray]:
    """The reference demo's comparison: how the soft-sample histogram tracks
    the target distribution as T varies (low T -> faithful, high T ->
    uniform). The temperatures draw one after another from ``generator``
    (a fresh one on ``device``, seeded 0, by default)."""
    device = resolve_device(device)
    generator = (generator if generator is not None
                 else torch.Generator(device=device).manual_seed(0))
    return {t: sample_histogram(probs, t, n_samples, generator, device=device)
            for t in temperatures}


def plot_temperature_sweep(probs, out_path: str, **kw) -> Optional[str]:
    """Write the histogram figure if matplotlib is available (the reference
    saves 'gumbel.png'); returns the path or None. ``kw`` goes to
    ``temperature_sweep`` (``device`` among them)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    sweep = temperature_sweep(probs, **kw)
    fig, axes = plt.subplots(1, len(sweep) + 1, figsize=(4 * (len(sweep) + 1), 3))
    axes[0].bar(range(len(probs)), np.asarray(probs))
    axes[0].set_title("target")
    for ax, (t, freq) in zip(axes[1:], sweep.items()):
        ax.bar(range(len(freq)), freq)
        ax.set_title(f"T={t}")
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path
