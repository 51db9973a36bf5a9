"""The pose sampler: the categorical (Gumbel-softmax) and Gaussian
variants of ``neuralsim_tpu.sampler``."""

from neuralsim_tpu_torch.sampler.gumbel import (
    gumbel_noise,
    gumbel_softmax_expectation,
)
from neuralsim_tpu_torch.sampler.poses import (
    GaussianPoseNoise,
    PoseNoise,
    draw_pose_noise,
    draw_pose_noise_gaussian,
    pose_spherical,
    poses_from_noise,
    poses_from_noise_gaussian,
    sample_poses,
    sample_poses_gaussian,
    explore_mix_psi,
    psi_to_probs,
)

__all__ = [
    "gumbel_noise",
    "gumbel_softmax_expectation",
    "GaussianPoseNoise",
    "PoseNoise",
    "draw_pose_noise",
    "draw_pose_noise_gaussian",
    "pose_spherical",
    "poses_from_noise",
    "poses_from_noise_gaussian",
    "sample_poses",
    "sample_poses_gaussian",
    "explore_mix_psi",
    "psi_to_probs",
]
