"""The pose sampler (the names of ``neuralsim_tpu.sampler`` that the port
has; the Gaussian sampler is not ported yet)."""

from neuralsim_tpu_torch.sampler.gumbel import (
    gumbel_noise,
    gumbel_softmax_expectation,
)
from neuralsim_tpu_torch.sampler.poses import (
    PoseNoise,
    draw_pose_noise,
    pose_spherical,
    poses_from_noise,
    explore_mix_psi,
    psi_to_probs,
)

__all__ = [
    "gumbel_noise",
    "gumbel_softmax_expectation",
    "PoseNoise",
    "draw_pose_noise",
    "pose_spherical",
    "poses_from_noise",
    "explore_mix_psi",
    "psi_to_probs",
]
