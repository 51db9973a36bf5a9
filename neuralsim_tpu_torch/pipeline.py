"""Pipeline facade of the render slice: the reference's application-level
``NeRF`` class (optimization/neural_sim_main.py:41-191), ported from
``neuralsim_tpu/pipeline.py``.

``NeuralSimRenderer`` loads the camera from ``nerf_traindata_info.json``
(with the pipeline's half_res /4), loads or initializes the NeRF pair
(reference ``.tar`` or ``.npz``), and renders K images from poses sampled
from psi (``render_images``), in ``test_mode()``: exact, or, with
``cfg.render.production_mode()`` (``hit_budget < 1``), the occupancy-culled
production render, whose grid is built and budget calibrated once in
``__init__``; and the psi render gradient of those images
(``render_images_grad``, ``hypergrad/render_grad.py``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch

from neuralsim_tpu_torch import resolve_device
from neuralsim_tpu_torch.config import NeuralSimConfig
from neuralsim_tpu_torch.data.blender import load_data_param
from neuralsim_tpu_torch.hypergrad.render_grad import (
    render_grad_psi_fwd,
    render_grad_psi_rev,
    render_grad_psi_strips,
)
from neuralsim_tpu_torch.models.convert import (
    load_nerf_checkpoint,
    load_params_npz,
    params_from_numpy,
)
from neuralsim_tpu_torch.models.nerf import init_nerf_pipeline_params, make_sigma_fn
from neuralsim_tpu_torch.models.ngp import check_float32
from neuralsim_tpu_torch.ops.occupancy import (
    OccupancyGrid,
    build_occupancy_grid,
    build_scene_grid,
    calibrate_hit_budget,
    scene_half_extent,
)
from neuralsim_tpu_torch.ops.render import render_poses, to8b
from neuralsim_tpu_torch.sampler.poses import (
    PoseNoise,
    draw_pose_noise,
    poses_from_noise,
    psi_to_probs,
)
from neuralsim_tpu_torch.utils.png import write_png


class NeuralSimRenderer:
    """Renders the K images of an outer iteration.

    Args:
      models: optional {"coarse": params, "fine": params} of numpy arrays
        or tensors; otherwise loaded from the configured checkpoint, else
        randomly initialized from ``generator``.
      device: where the render runs; ``cuda`` when None (raises without
        a GPU), ``"cpu"`` only when asked for.
    """

    def __init__(self, cfg: NeuralSimConfig, models=None,
                 generator: Optional[torch.Generator] = None, device=None):
        check_float32(cfg.net, "NeuralSimRenderer", compute_dtype=cfg.render.compute_dtype)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.rc = cfg.render.test_mode()

        info = os.path.join(cfg.data.datadir, "nerf_traindata_info.json")
        if os.path.exists(info):
            cam = load_data_param(cfg.data.datadir, cfg.data.half_res)
            self.H, self.W, self.K = cam.height, cam.width, cam.K
            self.rc = dataclasses.replace(self.rc, near=cam.near, far=cam.far)
        else:
            self.H, self.W, self.K = cfg.camera.height, cfg.camera.width, cfg.camera.K

        rf = cfg.data.render_factor
        if rf and rf > 0:
            self.H //= rf
            self.W //= rf
            self.K = self.K / rf
            self.K[2, 2] = 1.0

        if models is None:
            if generator is None:
                generator = torch.Generator().manual_seed(cfg.seed)
            models = self._load_models(generator)
        self.models = params_from_numpy(models, self.device)

        # production empty-space skipping: the grid is built once per scene
        # from the coarse density, then the budget is raised to the measured
        # worst-case hit fraction over the calibration poses (a budget below
        # it drops visible rays)
        self.grid = None
        if self.rc.hit_budget < 1.0:
            self.grid = self.occupancy_grid()
            budget = calibrate_hit_budget(self.grid, self.calibration_poses(), self.H,
                                          self.W, self.K, self.rc)
            self.rc = dataclasses.replace(self.rc,
                                          hit_budget=max(self.rc.hit_budget, budget))

    def calibration_poses(self) -> torch.Tensor:
        """The 8 poses [8, 4, 4] the budget is calibrated on, drawn over all
        bins alike from a generator of their own seeded with cfg.seed, so
        calibration draws nothing from a caller's generator."""
        noise = draw_pose_noise(torch.Generator().manual_seed(self.cfg.seed),
                                self.cfg.sampler, num_k=8, device=self.device)
        return poses_from_noise(torch.full((8,), 0.125, device=self.device), noise,
                                self.cfg.sampler)

    def occupancy_grid(self, resolution: int = 96, threshold: float = 1e-2,
                       dilate: int = 2, bbox_half: float = None) -> OccupancyGrid:
        """Conservative occupancy grid from the coarse model's density, on
        the renderer's device (the constructor keeps one when
        hit_budget < 1). The box is derived from the density over the cube
        every frustum sample can reach (``build_scene_grid``); pass
        ``bbox_half`` for the fixed cube [-bbox_half, bbox_half]^3."""
        sigma_fn = make_sigma_fn(self.models["coarse"], self.cfg.net)
        if bbox_half is None:
            return build_scene_grid(
                sigma_fn, scene_half_extent(self.cfg.sampler.radius, self.rc.far,
                                            self.H, self.W, self.K),
                resolution=resolution, threshold=threshold, dilate=dilate,
                device=self.device)
        return build_occupancy_grid(
            sigma_fn, bbox_min=(-bbox_half,) * 3, bbox_max=(bbox_half,) * 3,
            resolution=resolution, threshold=threshold, dilate=dilate, device=self.device)

    def _load_models(self, generator: torch.Generator):
        cfg = self.cfg
        # the reference pins ft_path to logs/nerf_models/ycbvid{id}.tar
        candidates = [cfg.data.ft_path] if cfg.data.ft_path else []
        for ext in ("tar", "npz"):
            candidates.append(os.path.join(
                cfg.data.basedir, "nerf_models", f"ycbvid{cfg.data.object_id}.{ext}"))
        for path in candidates:
            if os.path.exists(path):
                if path.endswith(".npz"):
                    return load_params_npz(path)
                return load_nerf_checkpoint(path)[0]
        # no checkpoint: random init (tests / from-scratch training)
        return init_nerf_pipeline_params(cfg.net, cfg.render.n_importance,
                                         generator)

    def _render_impl(self, psi, noise: PoseNoise):
        psi = torch.as_tensor(psi, dtype=torch.float32, device=self.device)
        probs = psi_to_probs(psi, self.cfg.sampler)
        poses = poses_from_noise(probs, noise.to(self.device), self.cfg.sampler)
        out = render_poses(self.models, poses, self.H, self.W, self.K,
                           self.cfg.net, self.rc, grid=self.grid, device=self.device)
        return out["rgb_map"], out["disp_map"], out["acc_map"]

    def render_images(self, psi, generator: Optional[torch.Generator] = None,
                      num_k: Optional[int] = None,
                      savedir: Optional[str] = None) -> Tuple[torch.Tensor, PoseNoise]:
        """Sample K poses from psi and render them: (rgb [K,H,W,3], noise).
        Optionally writes PNGs under ``savedir/{object_id}/{i:03d}.png``."""
        noise = draw_pose_noise(generator, self.cfg.sampler, num_k, self.device)
        with torch.no_grad():
            rgb, _, _ = self._render_impl(psi, noise)
        if savedir:
            out = os.path.join(savedir, str(self.cfg.data.object_id))
            os.makedirs(out, exist_ok=True)
            arr = to8b(rgb)
            for i in range(arr.shape[0]):
                write_png(os.path.join(out, f"{i:03d}.png"), arr[i])
        return rgb, noise

    def render_images_grad(self, psi, noise: PoseNoise, grad_E,
                           mode: str = "strips") -> torch.Tensor:
        """Mean dL/dpsi with grad_E [P, H, W, 3] as the rgb cotangent (the
        reference returns the mean of per-chunk dL/dpsi,
        neural_sim_main.py:191), on the renderer's device. The noise is cut
        to grad_E's P poses.

        mode: "strips" (the default: strips of cfg.bilevel.grad_ray_chunk
        pixels) | "rev" | "fwd" (see hypergrad.render_grad)."""
        n = grad_E.shape[0]
        noise_n = type(noise)(*(x[:n] for x in noise))
        args = (self.models, psi, noise_n, grad_E, self.H, self.W, self.K,
                self.cfg.net, self.rc, self.cfg.sampler)
        if mode == "strips":
            return render_grad_psi_strips(*args, strip=self.cfg.bilevel.grad_ray_chunk)
        if mode == "rev":
            return render_grad_psi_rev(*args)
        if mode == "fwd":
            return render_grad_psi_fwd(*args)
        raise ValueError(f"render_images_grad: unknown mode {mode!r}")
