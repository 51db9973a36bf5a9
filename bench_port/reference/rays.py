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
