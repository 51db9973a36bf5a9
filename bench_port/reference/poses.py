"""Differentiable camera-pose sampling from the psi categorical distribution
(reference load_LINEMOD_noscale.py:202-328).

  - 8 azimuth bins with centers [0, 45, ..., 315] + 22.5 degrees
  - phi = gumbel-softmax soft bin center, then uniform-within-bin
    reparameterization ``phi = s - width/2 + width * U(0,1)``
  - theta ~ U(85, 95) degrees, radius fixed at 1.01
  - spherical c2w: flip @ rot_theta @ rot_phi @ trans_r

``draw_pose_noise`` draws every stochastic input from a torch.Generator;
``poses_from_noise`` is a pure differentiable function of (probs, noise),
so feeding it the same ``PoseNoise`` replays the same poses. The Gaussian
variant (psi = (mean, std) of the azimuth) has the same split:
``draw_pose_noise_gaussian`` and ``poses_from_noise_gaussian``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from bench_port.reference.common import draw
from bench_port.reference.config import SamplerConfig
from bench_port.reference.gumbel import gumbel_noise, gumbel_softmax_expectation


class PoseNoise(NamedTuple):
    """The reference's ``sample_log``: every random input of K poses."""

    gumbel: torch.Tensor   # [K, n_bins]
    uniform: torch.Tensor  # [K]
    theta: torch.Tensor    # [K] degrees

    def to(self, device) -> "PoseNoise":
        return PoseNoise(*(torch.as_tensor(x, dtype=torch.float32, device=device)
                           for x in self))


def _rot_phi(phi):
    """Rotation about x by phi (radians), [..., 4, 4]."""
    c, s = torch.cos(phi), torch.sin(phi)
    z, o = torch.zeros_like(phi), torch.ones_like(phi)
    return torch.stack([
        torch.stack([o, z, z, z], -1),
        torch.stack([z, c, -s, z], -1),
        torch.stack([z, s, c, z], -1),
        torch.stack([z, z, z, o], -1),
    ], -2)


def _rot_theta(th):
    """Rotation about y by theta (radians); the reference's sign convention."""
    c, s = torch.cos(th), torch.sin(th)
    z, o = torch.zeros_like(th), torch.ones_like(th)
    return torch.stack([
        torch.stack([c, z, -s, z], -1),
        torch.stack([z, o, z, z], -1),
        torch.stack([s, z, c, z], -1),
        torch.stack([z, z, z, o], -1),
    ], -2)


_FLIP = ((-1.0, 0.0, 0.0, 0.0), (0.0, 0.0, 1.0, 0.0),
         (0.0, 1.0, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0))


def pose_spherical(theta_deg, phi_deg, radius):
    """c2w = flip @ R_theta @ R_phi @ T_r for scalar or batched [K] angles
    in degrees. Returns [..., 4, 4]; differentiable in all arguments."""
    theta = torch.as_tensor(theta_deg, dtype=torch.float32) * (math.pi / 180.0)
    phi = torch.as_tensor(phi_deg, dtype=torch.float32,
                          device=theta.device) * (math.pi / 180.0)
    radius = torch.as_tensor(radius, dtype=torch.float32,
                             device=theta.device).expand(theta.shape)
    trans = torch.eye(4, device=theta.device).expand(theta.shape + (4, 4)).clone()
    trans[..., 2, 3] = radius
    flip = torch.tensor(_FLIP, device=theta.device)
    c2w = _rot_phi(phi) @ trans
    c2w = _rot_theta(theta) @ c2w
    return flip @ c2w


def psi_to_probs(psi, sc: SamplerConfig):
    """psi logits -> categorical probs at the fixed softmax temperature
    (reference neural_sim_main.py:85-86)."""
    return torch.softmax(psi / sc.softmax_temperature, dim=-1)


def bin_centers(sc: SamplerConfig, device="cpu"):
    return (torch.arange(sc.n_bins, dtype=torch.float32, device=device)
            * sc.bin_width_deg + sc.bin_offset_deg)


def _draw_theta(k: int, generator, sc: SamplerConfig) -> torch.Tensor:
    return sc.theta_low_deg + (sc.theta_high_deg - sc.theta_low_deg) * draw((k,), generator)


def draw_pose_noise(generator: Optional[torch.Generator], sc: SamplerConfig,
                    num_k: Optional[int] = None, device="cpu") -> PoseNoise:
    """Draw all stochastic inputs for K pose samples."""
    k = num_k if num_k is not None else sc.n_samples_k
    gumbel = gumbel_noise((k, sc.n_bins), generator)
    uniform = draw((k,), generator)
    return PoseNoise(gumbel, uniform, _draw_theta(k, generator, sc)).to(device)


def poses_from_noise(probs, noise: PoseNoise, sc: SamplerConfig):
    """(probs, noise) -> c2w poses [K, 4, 4].

    phi = gumbel-softmax expectation of the bin centers, then the
    uniform-within-bin offset; the azimuth goes to pose_spherical shifted
    by -180 (reference convention, load_LINEMOD_noscale.py:244). probs are
    clamped at 1e-30 before the log so an underflowed bin gets a finite
    logit instead of -inf (which would make every gradient NaN).
    """
    logits = torch.log(torch.clamp(probs, min=1e-30))
    centers = bin_centers(sc, probs.device)
    phi_soft = gumbel_softmax_expectation(
        logits[None, :], centers, noise.gumbel, sc.gumbel_temperature)
    phi = phi_soft - sc.bin_width_deg / 2.0 + sc.bin_width_deg * noise.uniform
    return pose_spherical(noise.theta, phi - 180.0, sc.radius)
