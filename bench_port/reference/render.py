"""The plain hierarchical render: coarse march, importance sampling, fine
march, in blocks of rays (the exact path of the reference's ``render_rays``,
run_nerf_noscale.py:390-501).

A copy of the plain route of ``neuralsim_tpu_torch/ops/render.py``. It
leaves out what no benchmarked cell renders: the kernels, occupancy culling,
z tightening, coarse-raw reuse, the sparse fine pass, NDC and density noise.
The MLP's operand rounding is rc.compute_dtype ("float8" is the control's
e4m3) and its encoding form rc.pe_projection.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from bench_port.reference.common import as_dtype
from bench_port.reference.config import NeRFNetConfig, RenderConfig
from bench_port.reference.nerf import query_points
from bench_port.reference.rays import get_rays
from bench_port.reference.volume import raw2outputs, sample_pdf, stratified_z_vals


def top_k_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores over the last axis, ties in
    ascending index order."""
    return torch.sort(scores, descending=True, stable=True).indices[..., :k]


def _march(params, rays_o, rays_d, viewdirs, z_vals, net, rc: RenderConfig):
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
    raw = query_points(params, pts, viewdirs, net, as_dtype(rc.compute_dtype),
                       pe_projection=rc.pe_projection)
    return raw2outputs(raw, z_vals, rays_d)


def render_rays(models, rays_o, rays_d, viewdirs, net: NeRFNetConfig, rc: RenderConfig,
                generator: Optional[torch.Generator] = None,
                uniforms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
    """Render rays [N,3]: rgb_map/disp_map/acc_map/depth_map, and rgb0 (the
    coarse map) when n_importance > 0. With rc.perturb the jitter is
    ``uniforms`` (u_z [N, n_samples], u_pdf [N, n_importance]) or drawn from
    ``generator`` in that order."""
    u_z, u_pdf = uniforms if uniforms is not None else (None, None)
    z_vals = stratified_z_vals(rays_o.shape[0], rc.n_samples, rc.near, rc.far,
                               perturb=rc.perturb, lindisp=rc.lindisp, u=u_z,
                               generator=generator, device=rays_o.device)
    rgb, disp, acc, weights, depth = _march(models["coarse"], rays_o, rays_d, viewdirs,
                                            z_vals, net, rc)
    out = {}
    if rc.n_importance > 0:
        out["rgb0"] = rgb
        z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        z_samples = sample_pdf(z_mid, weights[..., 1:-1], rc.n_importance,
                               det=not rc.perturb, u=u_pdf, generator=generator).detach()
        z_all = torch.sort(torch.cat([z_vals, z_samples], dim=-1), dim=-1).values
        fine = models.get("fine") or models["coarse"]
        rgb, disp, acc, _, depth = _march(fine, rays_o, rays_d, viewdirs, z_all, net, rc)
    out.update(rgb_map=rgb, disp_map=disp, acc_map=acc, depth_map=depth)
    return out


def viewdirs_of(rays_d: torch.Tensor) -> torch.Tensor:
    return rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)


def render_ray_batch(models, rays_o, rays_d, net: NeRFNetConfig, rc: RenderConfig,
                     block: Optional[int] = None):
    """A flat ray batch [N,3] in blocks of ``block`` rays (rc.ray_chunk)."""
    n = rays_o.shape[0]
    block = block or rc.ray_chunk
    viewdirs = viewdirs_of(rays_d) if net.use_viewdirs else None
    parts = []
    for lo in range(0, n, block):
        sl = slice(lo, lo + block)
        parts.append(render_rays(models, rays_o[sl], rays_d[sl],
                                 None if viewdirs is None else viewdirs[sl], net, rc))
    return {k: torch.cat([p[k] for p in parts], dim=0) for k in parts[0]}


def render_poses(models, c2ws, H: int, W: int, K, net: NeRFNetConfig, rc: RenderConfig,
                 block: Optional[int] = None):
    """A [P,4,4] stack of poses as one flat ray batch; maps are [P, H, W, ...]."""
    rays_o, rays_d = get_rays(H, W, K, c2ws)
    out = render_ray_batch(models, rays_o.reshape(-1, 3), rays_d.reshape(-1, 3), net, rc,
                           block)
    lead = (c2ws.shape[0], H, W)
    return {k: v.reshape(lead + tuple(v.shape[1:])) for k, v in out.items()}
