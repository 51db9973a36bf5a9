"""psi initialization presets (reference neural_sim_main.py:1153-1165)."""

from __future__ import annotations

import torch

_PRESETS = {
    "uniform": [0.125] * 8,
    "two_13": [0.44, 0.02, 0.44, 0.02, 0.02, 0.02, 0.02, 0.02],
    "two_27": [0.02, 0.44, 0.02, 0.02, 0.02, 0.02, 0.44, 0.02],
    "three_123": [0.3, 0.3, 0.3, 0.02, 0.02, 0.02, 0.02, 0.02],
    "three_147": [0.3, 0.02, 0.02, 0.3, 0.02, 0.02, 0.3, 0.02],
}


def psi_init(mode: str) -> torch.Tensor:
    """Initial psi [8] for a named preset or a 1-based dominant-bin index."""
    if mode in _PRESETS:
        return torch.tensor(_PRESETS[mode], dtype=torch.float32)
    idx = int(mode)
    if not 1 <= idx <= 8:
        raise ValueError(f"psi_pose_cats_mode must be 1..8 or a preset, got {mode!r}")
    psi = torch.full((8,), 0.02, dtype=torch.float32)
    psi[idx - 1] = 0.86
    return psi
