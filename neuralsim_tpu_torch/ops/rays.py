"""Camera-ray generation (reference run_nerf_helpers.py:156-195)."""

from __future__ import annotations

import torch


def get_rays(H: int, W: int, K, c2w: torch.Tensor):
    """Rays through every pixel of an H x W pinhole camera.

    Args:
      K: [3,3] intrinsics (array or tensor); fx, fy, cx, cy are read
        separately.
      c2w: [..., 3 or 4, 4] camera-to-world (OpenGL convention: x right,
        y up, camera looks down -z). Leading dims batch poses.

    Returns rays_o, rays_d: each [..., H, W, 3]; directions unnormalized.
    """
    K = torch.as_tensor(K, dtype=torch.float32, device=c2w.device)
    i = torch.arange(W, dtype=torch.float32, device=c2w.device)[None, :]
    j = torch.arange(H, dtype=torch.float32, device=c2w.device)[:, None]
    dirs = torch.stack(
        [
            ((i - K[0, 2]) / K[0, 0]).expand(H, W),
            (-(j - K[1, 2]) / K[1, 1]).expand(H, W),
            -torch.ones((H, W), dtype=torch.float32, device=c2w.device),
        ],
        dim=-1,
    )
    rot = c2w[..., :3, :3]
    # d_world = R @ d_cam for every pixel
    rays_d = torch.einsum("hwc,...rc->...hwr", dirs, rot)
    rays_o = c2w[..., None, None, :3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def ndc_rays(H: int, W: int, focal: float, near: float, rays_o, rays_d):
    """Shift to the near plane and project to NDC (LLFF forward-facing
    scenes; reference run_nerf_helpers.py:178-195)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (W / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (W / (2.0 * focal)) * (
        rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2]
    )
    d1 = -1.0 / (H / (2.0 * focal)) * (
        rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2]
    )
    d2 = -2.0 * near / rays_o[..., 2]

    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)
