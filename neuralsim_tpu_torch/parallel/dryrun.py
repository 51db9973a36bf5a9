"""``dryrun_multichip``: one run of every mesh path on N ranks of one host
(the counterpart of ``dryrun_multichip`` in the repository's
``__graft_entry__.py``, which the JAX package runs on N virtual devices).

    python -m neuralsim_tpu_torch.parallel.dryrun 4 cpu

On N ranks (``launch.launch``): one data-parallel NeRF train step, a
multi-pose render with one pose per rank, a tensor-parallel render on a
(N/2, 2) mesh at full width, one data-parallel inner-train step of the
detector, and the strips psi gradient with the images split over the data
axis, dense and occupancy-culled. Every rank must end with the same loss,
render and gradient.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from neuralsim_tpu_torch.parallel.launch import launch


def _dryrun_rank(n: int, device: str) -> dict:
    from neuralsim_tpu_torch import draw
    from neuralsim_tpu_torch.config import (
        DetectorConfig,
        NeRFNetConfig,
        RenderConfig,
        SamplerConfig,
        TrainConfig,
    )
    from neuralsim_tpu_torch.detector.trainer import cycle_indices, init_detector, inner_train
    from neuralsim_tpu_torch.hypergrad.render_grad import render_grad_psi_strips
    from neuralsim_tpu_torch.models.box_scene import box_scene_params
    from neuralsim_tpu_torch.models.nerf import init_nerf_pipeline_params, make_sigma_fn
    from neuralsim_tpu_torch.models.retinanet import DetBatch
    from neuralsim_tpu_torch.ops.occupancy import build_scene_grid
    from neuralsim_tpu_torch.ops.render import render_poses, render_ray_batch
    from neuralsim_tpu_torch.parallel.distributed import nerf_param_sharding
    from neuralsim_tpu_torch.parallel.mesh import (
        make_mesh,
        replicate,
        shard_batch,
        shard_map_compat,
        shard_rays,
    )
    from neuralsim_tpu_torch.sampler.poses import draw_pose_noise, pose_spherical
    from neuralsim_tpu_torch.train_nerf import init_train_state, train_step

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    mesh = make_mesh(data=n, model=1, device=device)
    tp_mesh = make_mesh(data=n // 2, model=2, device=device) if n >= 2 else None
    dev = mesh.device
    out = {}

    # data-parallel NeRF train step: rays split over the ranks
    net = NeRFNetConfig(netdepth=2, netwidth=32, netdepth_fine=2, netwidth_fine=32,
                        skips=(0,), multires=4, multires_views=2)
    rc = RenderConfig(n_samples=8, n_importance=8, ray_chunk=64, near=0.5, far=2.0,
                      perturb=True)
    tc = TrainConfig(n_rand=16 * n)
    state = replicate(init_train_state(net, rc, tc, gen(0), dev), mesh)
    rays_d = draw((tc.n_rand, 3), gen(1), dev, normal=True) * 0.1 + torch.tensor(
        [0.0, 0.0, -1.0], device=dev)
    rays_o = torch.tensor([[0.0, 0.0, 1.01]], device=dev).expand(tc.n_rand, 3)
    target = torch.full((tc.n_rand, 3), 0.5, device=dev)
    state, metrics = train_step(state, rays_o, rays_d, target, net, rc, tc, gen(2), mesh=mesh)
    out["loss"] = float(metrics["loss"])
    out["local_rays"] = int(shard_rays(rays_o, mesh).shape[0])
    if not np.isfinite(out["loss"]):
        raise AssertionError("non-finite training loss")

    # data-parallel render across poses, one per rank, all-gathered
    K = [[30.0, 0.0, 8.0], [0.0, 30.0, 8.0], [0.0, 0.0, 1.0]]
    poses = pose_spherical(torch.linspace(0.0, 270.0, n), torch.full((n,), -30.0), 1.01)
    render = shard_map_compat(
        lambda p: render_poses(state.params, p, 16, 16, K, net, rc.test_mode(),
                               device=dev)["rgb_map"],
        mesh, ("data",), "data")
    rgb = render(poses)
    out["local_poses"] = int(shard_batch(poses, mesh).shape[0])
    if tuple(rgb.shape) != (n, 16, 16, 3) or not torch.isfinite(rgb).all():
        raise AssertionError(f"multi-pose render: {tuple(rgb.shape)}")
    out["rgb"] = rgb

    # tensor-parallel render: the full-width MLP's wide layers split by
    # columns over the model axis of a (n/2, 2) mesh
    if tp_mesh is not None and tp_mesh.coords is not None:
        full = NeRFNetConfig()
        tp_rc = RenderConfig(n_samples=4, n_importance=4, ray_chunk=32, near=0.5, far=2.0,
                             perturb=False)
        tp = nerf_param_sharding(init_nerf_pipeline_params(full, 4, gen(3), dev), tp_mesh,
                                 tensor_parallel=True)
        out["tp_local_width"] = int(tp["coarse"]["pts_1_kernel"].shape[1])
        rd = draw((32, 3), gen(4), dev, normal=True) * 0.1 + torch.tensor(
            [0.0, 0.0, -1.0], device=dev)
        tp_rgb = render_ray_batch(tp, torch.zeros_like(rd), rd, full, tp_rc)["rgb_map"]
        if not torch.isfinite(tp_rgb).all():
            raise AssertionError("tensor-parallel render is not finite")
        out["tp_rgb"] = tp_rgb

    # data-parallel inner train: each step's batch split over the ranks
    dc = DetectorConfig(num_classes=2, image_size=32, max_iter=2, images_per_batch=n,
                        warmup_iters=1)
    det = replicate(init_detector(gen(5), dc, device=dev), mesh)
    imgs = torch.zeros((4, 32, 32, 3), device=dev)
    imgs[:, 8:20, 8:20] = 0.8
    data = DetBatch(imgs, torch.tensor([[[8.0, 8.0, 20.0, 20.0]]], device=dev).expand(4, 1, 4),
                    torch.zeros((4, 1), dtype=torch.int64, device=dev),
                    torch.ones((4, 1), dtype=torch.bool, device=dev))
    idx = cycle_indices(4, dc.max_iter, dc.images_per_batch, gen(6), dev)
    det, det_metrics = inner_train(det, (data, shard_batch(idx.T, mesh).T), dc,
                                   group=mesh.data_group)
    out["det_loss"] = det_metrics["loss"]
    if not torch.isfinite(det_metrics["loss"]).all():
        raise AssertionError("non-finite inner-train loss")

    # the strips psi gradient with the images split over the data axis,
    # dense and culled on a compact box (so the selection runs)
    sc = SamplerConfig()
    gK = [[30.0, 0.0, 4.0], [0.0, 30.0, 4.0], [0.0, 0.0, 1.0]]
    psi = torch.zeros(8, device=dev)
    noise = draw_pose_noise(gen(9), sc, num_k=n, device=dev)
    grad_E = draw((n, 8, 8, 3), gen(10), dev, normal=True) * 1e-2
    out["g_psi"] = render_grad_psi_strips(state.params, psi, noise, grad_E, 8, 8, gK, net,
                                          rc.test_mode(), sc, strip=64, image_batch=n,
                                          mesh=mesh)
    box = box_scene_params(net, gen(11), half=0.12, device=dev)
    grid = build_scene_grid(make_sigma_fn(box, net), 1.2, resolution=32, device=dev)
    out["g_psi_culled"] = render_grad_psi_strips(
        {"coarse": box, "fine": box}, psi, noise, grad_E, 8, 8, gK, net, rc.test_mode(), sc,
        strip=64, image_batch=n, mesh=mesh, grid=grid, hit_budget=0.6)
    for k in ("g_psi", "g_psi_culled"):
        if out[k].shape != (8,) or not torch.isfinite(out[k]).all():
            raise AssertionError(f"{k}: {out[k]}")
    return out


def dryrun_multichip(n_ranks: int, device: str = "cuda", backend=None,
                     timeout: float = 900.0) -> list:
    """Every mesh path once on ``n_ranks`` ranks of this host (see the
    module docstring); raises when a rank fails or the ranks disagree.
    Returns the ranks' results."""
    results = launch(_dryrun_rank, n_ranks, (n_ranks, device), device=device, backend=backend,
                     timeout=timeout, threads=1 if device == "cpu" else None)
    first = results[0]
    for r, res in enumerate(results[1:], 1):
        for k in ("loss", "rgb", "det_loss", "g_psi", "g_psi_culled"):
            if not np.array_equal(np.asarray(res[k]), np.asarray(first[k])):
                raise AssertionError(f"dryrun_multichip: rank {r}'s {k} differs from rank 0's")
    print(f"dryrun_multichip: OK on {n_ranks} ranks ({device}; dp train + dp render + "
          f"tp render + dp detector inner-train + mesh strips grad + culled strips grad; "
          f"loss={first['loss']:.4f})")
    return results


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]), sys.argv[2] if len(sys.argv) > 2 else "cuda")
