"""Bilevel outer loop: render -> build dataset -> inner-train -> eval ->
hypergradient -> psi update (the port of ``neuralsim_tpu/bilevel/driver.py``).

The reference's ``bilevel_optimization``
(``optimization/neural_sim_main.py:1144-1212``), step by step:

  [1] sample K poses from psi and render them (the production render runs
      the ray-march kernel on the card)
  [2] annotate the renders on the device and assemble the detector's
      training set (+ optional background classes); optionally dump PNGs
  [2.2] inner fine-tune: max_iter steps, warm-started across epochs
  [2.3] inference + COCO mAP -> save_result log
  [3.1] v = dL_val/dtheta; inverse HVP
  [3.2] grad_E = d/dI <dL_train/dtheta, v> per rendered image, taken with
        respect to the rendered rgb (the normalize/pad is part of the
        differentiated function, there is no 8-bit PNG round trip)
  [3.3] dL/dpsi through sample -> render (strips, reverse or forward mode)
  [3.4] psi optimizer step + warmup/decay schedule

Random streams: the driver owns one ``torch.Generator``. ``run`` draws the
detector's initial weights from it, then each epoch draws, in this order,
the pose noise, the inner-train schedule and the HVP batch
(``draw_epoch``); ``run_epoch`` also takes those draws explicitly
(``EpochDraws``), which is how a test hands it the JAX driver's. The grid's
budget calibration draws from a generator of its own (or takes
``calibration_noise``), never from the training stream.

``BilevelDriver(mesh=)`` runs the loop on a ('data', 'model') mesh of
processes (``parallel.mesh``), one driver per rank, as the JAX driver runs
it on its device mesh: the NeRF pair and the val set are replicated, each
rank renders its block of the K poses (K padded to a multiple of the data
axis by repeating the last pose) and the renders are all-gathered; the
inner train is data-parallel when images_per_batch divides over the data
axis (each rank trains on its columns of every step's batch, gradients
summed over the data group); the strips gradient splits its images over the
data axis; the other stages run whole on every rank. Only the mesh's first
rank writes save_result.txt, checkpoints and PNGs. The JAX driver's
``_mesh_barrier`` works around the rendezvous of XLA:CPU's thread pool
and has no counterpart. Left out: the ``jit_cache`` / ``dynamic_start``
arguments of its strips call, which shape only XLA programs.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from neuralsim_tpu_torch import resolve_device
from neuralsim_tpu_torch.bilevel.psi_init import psi_init
from neuralsim_tpu_torch.bilevel.psi_opt import (
    PsiOptState,
    adjust_learning_rate,
    psi_optimizer_init,
    psi_optimizer_update,
)
from neuralsim_tpu_torch.config import NeuralSimConfig
from neuralsim_tpu_torch.detector.dataset import (
    build_detector_batches,
    build_detector_batches_device,
    prepare_images,
)
from neuralsim_tpu_torch.detector.evaluator import coco_map, detections_to_eval
from neuralsim_tpu_torch.detector.trainer import (
    DetectorState,
    cycle_indices,
    init_detector,
    inner_train,
    make_detector_apply,
    merge_params,
    split_trainable,
)
from neuralsim_tpu_torch.hypergrad.influence import (
    grad_loss,
    inverse_hvp,
    mixed_grad_wrt_image_batch,
)
from neuralsim_tpu_torch.hypergrad.render_grad import (
    psi_poses,
    render_grad_psi_fwd,
    render_grad_psi_rev,
    render_grad_psi_strips,
)
from neuralsim_tpu_torch.hypergrad.unrolled import unrolled_grad_images
from neuralsim_tpu_torch.models.convert import params_from_numpy
from neuralsim_tpu_torch.models.convert_retinanet import params_from_flax, params_to_flax
from neuralsim_tpu_torch.models.nerf import make_sigma_fn
from neuralsim_tpu_torch.models.ngp import check_float32
from neuralsim_tpu_torch.models.retinanet import (
    DetBatch,
    Detections,
    generate_anchors,
    retinanet_inference,
    retinanet_loss,
)
from neuralsim_tpu_torch.ops.occupancy import (
    build_scene_grid,
    calibrate_hit_budget,
    scene_half_extent,
)
from neuralsim_tpu_torch.ops.render import render_poses, to8b
from neuralsim_tpu_torch.parallel.mesh import (
    all_gather,
    barrier,
    pad_rows,
    pad_to_multiple,
    replicate,
    shard_batch,
)
from neuralsim_tpu_torch.sampler.poses import (
    PoseNoise,
    draw_pose_noise,
    draw_pose_noise_gaussian,
    explore_mix_psi,
    poses_from_noise,
    psi_to_probs,
)
from neuralsim_tpu_torch.utils.checkpoint import CheckpointManager
from neuralsim_tpu_torch.utils.logging import ResultLog, map_result_str, torch_tensor_str
from neuralsim_tpu_torch.utils.png import write_png
from neuralsim_tpu_torch.utils.profiling import PhaseTimes, phase_timer

logger = logging.getLogger(__name__)

# the salt of the calibration generator's seed (the JAX driver folds
# 0xCA1 into its key)
CALIBRATION_SALT = 0xCA1


class ValData(NamedTuple):
    """Fixed validation set (images already model-ready, GT padded)."""

    images: torch.Tensor
    gt_boxes: torch.Tensor
    gt_labels: torch.Tensor
    gt_valid: torch.Tensor


class BilevelState(NamedTuple):
    psi: torch.Tensor
    psi_opt: PsiOptState
    detector: DetectorState
    epoch: int


class EpochDraws(NamedTuple):
    """Every random input of one epoch: the K poses' noise, the inner
    train's schedule [max_iter, images_per_batch] and the HVP batch's
    indices [images_per_batch] (both over the renders + backgrounds)."""

    noise: object            # PoseNoise | GaussianPoseNoise
    batch_idx: torch.Tensor
    hvp_idx: torch.Tensor


def _flax_names(tree, prefix: str = ""):
    """The port's parameter names of a Flax-layout tree, in JAX's flatten
    order (dict keys sorted at every level)."""
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            yield from _flax_names(value, f"{prefix}{key}.")
        else:
            yield prefix + ("weight" if key == "kernel" else key)


def jax_checkpoint_layout(psi, det_params) -> Dict:
    """The structure of the JAX driver's ``_ckpt_state`` (driver.py:536-550)
    for a state like (psi, det_params), with placeholder leaves: what
    ``CheckpointManager.restore`` unflattens a JAX npz checkpoint into."""
    flax = params_to_flax(det_params)
    n_trainable = sum(1 for name in _flax_names(flax) if not name.startswith("backbone."))
    return {
        "psi": 0,
        "psi_opt": {"lr": 0, "step": 0, "m": 0, "v": 0},
        "detector": {"params": flax, "step": 0, "opt_leaves": [0] * (n_trainable + 1)},
        "key": 0,
        "epoch": 0,
    }


def bilevel_state_from_jax(tree: Dict, opt_method: str = "momentum", device="cpu"):
    """The JAX driver's checkpoint state (the ``_ckpt_state`` layout of
    driver.py:536-550, as numpy) -> the port's (psi, PsiOptState,
    DetectorState, epoch) on ``device``.

    The detector's Flax params go through ``params_from_flax``; the optax
    leaves of add_decayed_weights + sgd(momentum) are the momentum trace
    of each trainable tensor, in JAX's flatten order, then the schedule's
    count: they become the port's ``{"trace": {name: buffer}, "count"}``.
    The trainable set is the whole tree or the tree without the backbone,
    whichever the number of leaves says."""
    def tensor(x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    psi = tensor(tree["psi"], torch.float32)
    po = tree["psi_opt"]
    psi_opt = psi_optimizer_init(opt_method, float(np.asarray(po["lr"])), dim=psi.shape[0])
    psi_opt = psi_opt._replace(lr=tensor(po["lr"], torch.float32),
                               step=tensor(po["step"], torch.int32),
                               m=tensor(po["m"], torch.float32),
                               v=tensor(po["v"], torch.float32))
    det = tree["detector"]
    params = params_from_flax(det["params"], device)
    names = list(_flax_names(det["params"]))
    leaves = list(det["opt_leaves"])
    if len(leaves) - 1 != len(names):
        names = [n for n in names if not n.startswith("backbone.")]
    if len(leaves) - 1 != len(names):
        raise ValueError(f"{len(leaves)} optimizer leaves do not fit {len(names)} "
                         "trainable tensors + the step count")
    trace = {}
    for name, leaf in zip(names, leaves[:-1]):
        leaf = np.asarray(leaf)
        if leaf.ndim == 4:                  # a Flax conv kernel [kh, kw, in, out]
            leaf = leaf.transpose(3, 2, 0, 1)
        trace[name] = tensor(np.ascontiguousarray(leaf), torch.float32)
    opt_state = {"trace": trace, "count": tensor(leaves[-1], torch.int32)}
    det_state = DetectorState(params, opt_state, tensor(det["step"], torch.int32))
    return psi, psi_opt, det_state, int(np.asarray(tree["epoch"]))


class BilevelDriver:
    """The outer loop on one device.

    Args:
      nerf_models: {"coarse": params, "fine": params} of arrays or tensors.
      val_data: the fixed val set; on the device, or kept on the host when
        ``cfg.detector.eval_stream_images > 0`` (then streamed in chunks).
      generator: the training stream (default: seeded with cfg.seed).
      calibration_noise: the 8 poses' noise the production grid's budget
        is calibrated on (default: drawn from a generator of its own).
      device: ``cuda`` when None (raises without a GPU); ``"cpu"`` only
        when asked for.
      mesh: a ``parallel.mesh.Mesh``: the loop on a mesh of processes (see
        the module docstring), on the mesh's device. Every rank of the
        mesh runs its own driver with the same arguments and draws.
    """

    def __init__(self, cfg: NeuralSimConfig, nerf_models, val_data: ValData,
                 generator: Optional[torch.Generator] = None, object_class: int = 1,
                 background_images: Optional[np.ndarray] = None,
                 background_labels: Optional[np.ndarray] = None,
                 output_dir: Optional[str] = None,
                 calibration_noise: Optional[PoseNoise] = None, device=None, mesh=None):
        check_float32(cfg.net, "BilevelDriver", compute_dtype=cfg.render.compute_dtype,
                      grad_compute_dtype=cfg.bilevel.grad_compute_dtype)
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.nerf_models = params_from_numpy(nerf_models, self.device)
        # the streamed val set is single-device only, as in the JAX driver
        self.streaming = cfg.detector.eval_stream_images > 0 and mesh is None
        if self.streaming:
            self.val_data = ValData(*(torch.as_tensor(np.asarray(_host(x))) for x in val_data))
        else:
            self.val_data = ValData(*(torch.as_tensor(x).to(self.device) for x in val_data))
        if mesh is not None:
            self.nerf_models = replicate(self.nerf_models, mesh)
            self.val_data = ValData(*replicate(tuple(self.val_data), mesh))
        # the one rank that writes files
        self.writes = mesh is None or mesh.is_first
        self.object_class = object_class
        self.background_images = background_images
        self.background_labels = background_labels
        self.generator = (generator if generator is not None
                          else torch.Generator().manual_seed(cfg.seed))
        self.output_dir = output_dir or os.path.join(
            cfg.data.basedir, cfg.data.expname, "detectron_output")
        self.log = ResultLog(self.output_dir) if self.writes else _NoLog(self.output_dir)
        self.phases = PhaseTimes()
        self.anchors_per_level = generate_anchors(cfg.detector.image_size, self.device)
        self.anchors_cat = torch.cat(self.anchors_per_level, dim=0)
        self.rc_test = cfg.render.test_mode()
        _, self.det_apply = make_detector_apply(cfg.detector)

        # production empty-space skipping for the K-pose forward render
        # (hit_budget < 1). The gradient render keeps exact sampling; the
        # grid may still select which rays the strips differentiate
        # (bc.grad_hit_budget)
        self.grid = None
        if self.rc_test.hit_budget < 1.0:
            cam = cfg.camera
            sigma_fn = make_sigma_fn(self.nerf_models["coarse"], cfg.net)
            self.grid = build_scene_grid(
                sigma_fn, scene_half_extent(cfg.sampler.radius, self.rc_test.far,
                                            cam.height, cam.width, cam.K),
                device=self.device)
            # the configured budget is a floor: raise it to the measured hit
            # fraction over poses spanning all azimuth bins (+25% margin)
            if calibration_noise is None:
                calibration_noise = draw_pose_noise(
                    torch.Generator().manual_seed(cfg.seed + CALIBRATION_SALT),
                    cfg.sampler, num_k=8)
            cal_poses = poses_from_noise(torch.full((8,), 0.125, device=self.device),
                                         calibration_noise.to(self.device), cfg.sampler)
            budget = calibrate_hit_budget(self.grid, cal_poses, cam.height, cam.width,
                                          cam.K, self.rc_test)
            self.rc_test = dataclasses.replace(
                self.rc_test, hit_budget=max(self.rc_test.hit_budget, budget))

    # ------------------------------------------------------------------ #
    # random draws
    # ------------------------------------------------------------------ #

    def n_train_images(self) -> int:
        n_bg = 0 if self.background_images is None else len(self.background_images)
        return self.cfg.sampler.n_samples_k + n_bg

    def draw_epoch(self) -> EpochDraws:
        """One epoch's draws from the driver's generator, in a fixed
        order: pose noise, inner-train schedule, HVP batch."""
        sc, dc, gen = self.cfg.sampler, self.cfg.detector, self.generator
        noise = (draw_pose_noise_gaussian(gen, sc, device=self.device)
                 if self.cfg.bilevel.psi_mode == "gaussian"
                 else draw_pose_noise(gen, sc, device=self.device))
        n = self.n_train_images()
        batch_idx = cycle_indices(n, dc.max_iter, dc.images_per_batch, gen, self.device)
        hvp_idx = cycle_indices(n, 1, dc.images_per_batch, gen, self.device)[0]
        return EpochDraws(noise, batch_idx, hvp_idx)

    # ------------------------------------------------------------------ #
    # stages
    # ------------------------------------------------------------------ #

    def _timer(self, name: str):
        return phase_timer(name, self.phases, device=self.device)

    def _render(self, psi, noise):
        """[1]: the K-pose render -> (rgb [K, H, W, 3], the occupancy pair
        (hit rays, budget) as one int64 tensor, or None without a grid).

        On a mesh, K pads up to a multiple of the data axis by repeating
        the last pose; each rank renders its block, the blocks are
        all-gathered and cut back to K, and the pairs stack to [n_data, 2]
        (JAX stacks them on its data axis; the budget check sums them)."""
        cam = self.cfg.camera
        k = int(noise[0].shape[0])
        if self.mesh is not None:
            n = pad_to_multiple(k, self.mesh.shape["data"])
            noise = shard_batch(type(noise)(*(pad_rows(x, n) for x in noise)), self.mesh)
        with torch.no_grad():
            poses = psi_poses(psi, noise, self.cfg.sampler, self.cfg.bilevel.psi_mode)
            out = render_poses(self.nerf_models, poses, cam.height, cam.width, cam.K,
                               self.cfg.net, self.rc_test, grid=self.grid, device=self.device)
        rgb, occ = out["rgb_map"], None
        if self.grid is not None:
            occ = torch.stack([out["occ_hit_count"], out["occ_budget"]]).to(torch.int64)
        if self.mesh is not None:
            group = self.mesh.data_group
            rgb = all_gather(rgb, group)[:k]
            occ = None if occ is None else all_gather(occ[None], group)
        return rgb, occ

    def _first_epoch_cull_guard(self, psi, noise, renders):
        """PSNR probe on the first epoch: re-render 2 poses exactly (no
        cull, no tightening) and compare with the culled renders; a wrong
        box or budget shows as a large divergence instead of silently
        feeding empty images to the detector. Stores self.last_cull_psnr;
        warns below 40 dB."""
        if self.grid is None:
            return
        n_probe = min(2, int(renders.shape[0]))
        noise_p = type(noise)(*(x[:n_probe] for x in noise))
        rc_exact = dataclasses.replace(self.rc_test, hit_budget=1.0, tighten_bounds=False)
        cam = self.cfg.camera
        with torch.no_grad():
            poses = psi_poses(psi, noise_p, self.cfg.sampler, self.cfg.bilevel.psi_mode)
            exact = render_poses(self.nerf_models, poses, cam.height, cam.width, cam.K,
                                 self.cfg.net, rc_exact, device=self.device)["rgb_map"]
            mse = float(torch.mean((exact - renders[:n_probe]) ** 2))
        psnr = -10.0 * np.log10(max(mse, 1e-12))
        self.last_cull_psnr = psnr
        if psnr < 40.0:
            logger.warning(
                "culled render diverges from exact on the first epoch: %.1f dB (<40); "
                "the occupancy box or budget is dropping visible content", psnr)

    def _check_occ_budget(self, occ_hit: int, occ_budget: int) -> bool:
        """Budget-overflow guard: with culling on, a hit ray beyond the
        budget is dropped from the render. When tripped, warn and raise
        the budget to cover the measured hit count (+ the calibration
        margin). Returns True iff the budget was raised: run_epoch then
        renders the epoch again before the detector sees it."""
        if self.grid is None or occ_hit <= occ_budget:
            return False
        # budget ~= n_rays * hit_budget, so the measured hit fraction is
        # occ_hit / occ_budget * hit_budget
        frac = occ_hit / max(1, occ_budget) * self.rc_test.hit_budget
        new_budget = min(1.0, -(-(frac * 1.25) // 0.05) * 0.05)
        logger.warning(
            "occupancy budget overflow: %d hit rays > budget %d; raising hit_budget "
            "%.2f -> %.2f and rendering the epoch again",
            occ_hit, occ_budget, self.rc_test.hit_budget, new_budget)
        if new_budget > self.rc_test.hit_budget:
            self.rc_test = dataclasses.replace(self.rc_test, hit_budget=new_budget)
            return True
        return False

    def _det_loss_trainable(self, trainable, frozen, batch: DetBatch, image_weight=None,
                            per_image_norm: bool = False):
        """The detector loss as a function of the trainable parameters (the
        theta of every hypergradient quantity: the reference optimizer's
        param_groups, frozen backbone excluded; gradients still flow
        through its activations to the image)."""
        total, _ = retinanet_loss(self.det_apply, merge_params(trainable, frozen), batch,
                                  self.anchors_cat, self.cfg.detector,
                                  image_weight=image_weight, per_image_norm=per_image_norm)
        return total

    def _val_grad(self, params):
        """[3.1] v = dL_val/dtheta over the whole val set (the reference
        accumulates .grad over the entire val loader,
        neural_sim_main.py:948-969), in batches of images_per_batch; a tail
        smaller than a batch is zero-padded and masked out of the loss sums
        and the fg normalizer, so it contributes what a smaller final batch
        would. With eval_stream_images > 0 the val set streams from the
        host (``_val_grad_streamed``, the same terms)."""
        if self.streaming:
            return self._val_grad_streamed(params)
        dc = self.cfg.detector
        v = self.val_data
        trainable, frozen = split_trainable(params, dc)
        n = v.images.shape[0]
        bs = min(dc.images_per_batch, n)
        n_batches = -(-n // bs)
        if n_batches <= 1:
            return grad_loss(lambda tp, b: self._det_loss_trainable(tp, frozen, b),
                             trainable, [DetBatch(*v)])
        n_pad = n_batches * bs
        mask = (torch.arange(n_pad, device=self.device) < n).to(torch.float32)

        def stack(x):
            if n_pad != n:
                x = torch.cat([x, torch.zeros((n_pad - n,) + tuple(x.shape[1:]),
                                              dtype=x.dtype, device=x.device)], 0)
            return x.reshape((n_batches, bs) + tuple(x.shape[1:]))

        stacked = (DetBatch(*(stack(x) for x in v)), mask.reshape(n_batches, bs))
        return grad_loss(
            lambda tp, bw: self._det_loss_trainable(tp, frozen, bw[0], image_weight=bw[1]),
            trainable, stacked)

    def _val_grad_streamed(self, params):
        """_val_grad over a host-resident val set: one padded, masked batch
        at a time moves to the device."""
        dc = self.cfg.detector
        imgs, boxes, labels, valid = self._val_host_arrays()
        n = imgs.shape[0]
        bs = min(dc.images_per_batch, n)
        trainable, frozen = split_trainable(params, dc)
        total = None
        for lo in range(0, n, bs):
            hi = min(lo + bs, n)
            pad = bs - (hi - lo)

            def padded(x):
                b = x[lo:hi]
                if pad:
                    b = np.concatenate([b, np.zeros((pad,) + b.shape[1:], b.dtype)], 0)
                return torch.as_tensor(b, device=self.device)

            batch = DetBatch(padded(imgs), padded(boxes), padded(labels), padded(valid))
            mask = torch.as_tensor((np.arange(bs) < (hi - lo)).astype(np.float32),
                                   device=self.device)
            g = grad_loss(lambda tp, b: self._det_loss_trainable(tp, frozen, b,
                                                                 image_weight=mask),
                          trainable, [batch])
            total = g if total is None else {k: total[k] + g[k] for k in total}
        return total

    def _ihvp(self, params, batch: DetBatch, v):
        """[3.1] the inverse HVP of v on the HVP batch, over the trainable
        parameters."""
        bc = self.cfg.bilevel
        trainable, frozen = split_trainable(params, self.cfg.detector)
        return inverse_hvp(
            lambda tp, b: self._det_loss_trainable(tp, frozen, b), trainable, batch, v,
            method=bc.ihvp_solver, damping=bc.ihvp_damping, cg_iters=bc.cg_iters,
            lissa_iters=bc.lissa_iters, lissa_scale=bc.lissa_scale)

    def _grad_e(self, params, renders, gt_boxes, gt_labels, gt_valid, v):
        """[3.2] grad_E per rendered image, with respect to the raw render:
        the normalization and padding (prepare_images) are differentiated
        through. One double backward per batch of images_per_batch images,
        each image over its own foreground count (``per_image_norm``), so
        its row is its batch-1 grad_E; a tail batch is padded with
        zero-weight images, whose rows are dropped, so every batch has one
        shape."""
        dc = self.cfg.detector
        trainable, frozen = split_trainable(params, dc)
        n = renders.shape[0]
        bs = min(dc.images_per_batch, n)
        out = []
        for lo in range(0, n, bs):
            hi = min(lo + bs, n)

            def padded(x):
                return torch.cat([x[lo:hi], x.new_zeros((bs - (hi - lo),) + x.shape[1:])])

            boxes, labels, valid = padded(gt_boxes), padded(gt_labels), padded(gt_valid)
            weight = (torch.arange(bs, device=renders.device) < hi - lo).to(torch.float32)

            def loss_batch(tp, r):
                batch = DetBatch(prepare_images(r, dc), boxes, labels, valid)
                return self._det_loss_trainable(tp, frozen, batch, image_weight=weight,
                                                per_image_norm=True)

            out.append(mixed_grad_wrt_image_batch(loss_batch, trainable, padded(renders), v,
                                                  n_images=hi - lo))
        return torch.cat(out)

    def _render_grad(self, psi, noise_g, grad_E_g):
        """[3.3] in the fwd / rev modes: dL/dpsi of one group of images."""
        cfg = self.cfg
        bc, cam = cfg.bilevel, cfg.camera
        rc_grad = dataclasses.replace(self.rc_test, ray_chunk=bc.grad_ray_chunk,
                                      fine_fraction=1.0)
        grad_fn = render_grad_psi_rev if bc.grad_mode == "rev" else render_grad_psi_fwd
        return grad_fn(self.nerf_models, psi, noise_g, grad_E_g, cam.height, cam.width,
                       cam.K, cfg.net, rc_grad, cfg.sampler, psi_mode=bc.psi_mode)

    def _unrolled(self, det_state0, renders, labels, batch_idx):
        """The true dL_val/dI (hypergrad_mode "unrolled"): backgrounds ride
        along as constant entries after the renders, on the schedule the
        inner train used."""
        return unrolled_grad_images(
            self.det_apply, det_state0, renders, labels, self._val_on_device(),
            self.cfg.detector, self.anchors_cat, batch_idx,
            background_images=self.background_images,
            background_labels=self.background_labels)

    # ------------------------------------------------------------------ #
    # outer loop
    # ------------------------------------------------------------------ #

    def run(self, n_epochs: Optional[int] = None,
            detector_state: Optional[DetectorState] = None,
            psi=None, save_pngs: Optional[bool] = None,
            checkpoint_dir: Optional[str] = None, checkpoint_every: int = 1,
            resume: bool = True) -> Dict:
        """The outer loop, with exact checkpoint/resume (the reference
        restarts a crashed outer loop from scratch and never saves psi).
        A checkpoint holds psi and its optimizer, the detector's parameters
        and optimizer state, the generator's state and the epoch; a JAX
        driver's npz checkpoint resumes too (without its PRNG key: the
        port's generator carries on from where it stands)."""
        cfg = self.cfg
        bc = cfg.bilevel
        n_epochs = n_epochs if n_epochs is not None else bc.n_epochs
        save_pngs = cfg.data.save_pngs if save_pngs is None else save_pngs

        if psi is None:
            psi = (torch.tensor([bc.gauss_mean_init, bc.gauss_std_init], dtype=torch.float32)
                   if bc.psi_mode == "gaussian" else psi_init(bc.psi_pose_cats_mode))
        psi = torch.as_tensor(psi, dtype=torch.float32).to(self.device)
        psi_opt = psi_optimizer_init(bc.opt_method, bc.opt_lr, dim=psi.shape[0])
        det_state = detector_state or init_detector(self.generator, cfg.detector,
                                                    device=self.device)
        start_epoch = 0

        ckpt_mgr = None
        if checkpoint_dir:
            ckpt_mgr = CheckpointManager(checkpoint_dir)
            step = ckpt_mgr.latest_step() if resume else None
            if step is not None and ckpt_mgr.is_jax_layout(step):
                tree = ckpt_mgr.restore(step, like=jax_checkpoint_layout(psi, det_state.params))
                psi, psi_opt, det_state, epoch = bilevel_state_from_jax(
                    tree, bc.opt_method, self.device)
                start_epoch = epoch + 1
            elif step is not None:
                like = self._ckpt_state(psi, psi_opt, det_state, 0)
                restored = ckpt_mgr.restore(step, like=like)
                psi = restored["psi"]
                po = restored["psi_opt"]
                psi_opt = psi_opt._replace(lr=po["lr"], step=po["step"], m=po["m"],
                                           v=po["v"])
                det = restored["detector"]
                det_state = DetectorState(det["params"], det["opt_state"], det["step"])
                self.generator.set_state(restored["generator"])
                start_epoch = int(restored["epoch"]) + 1
        if self.mesh is not None:
            psi, det_state = replicate((psi, det_state), self.mesh)

        history = []
        for epoch in range(start_epoch, n_epochs):
            record = self.run_epoch(epoch, psi, psi_opt, det_state, save_pngs=save_pngs)
            psi, psi_opt, det_state = (record["psi"], record["psi_opt"],
                                       record["detector_state"])
            history.append({k: record[k] for k in ("epoch", "map", "psi_probs")})
            if ckpt_mgr and (epoch % checkpoint_every == 0):
                if self.writes:
                    ckpt_mgr.save(epoch, self._ckpt_state(psi, psi_opt, det_state, epoch))
                if self.mesh is not None:
                    barrier(self.mesh)
        return {"psi": psi, "psi_opt": psi_opt, "detector_state": det_state,
                "history": history}

    def _ckpt_state(self, psi, psi_opt: PsiOptState, det_state: DetectorState, epoch: int):
        return {
            "psi": psi,
            "psi_opt": {"lr": psi_opt.lr, "step": psi_opt.step,
                        "m": psi_opt.m, "v": psi_opt.v},
            "detector": {"params": det_state.params, "step": det_state.step,
                         "opt_state": det_state.opt_state},
            "generator": self.generator.get_state(),
            "epoch": epoch,
        }

    def run_epoch(self, epoch: int, psi, psi_opt: PsiOptState, det_state: DetectorState,
                  save_pngs: bool = False, draws: Optional[EpochDraws] = None) -> Dict:
        """One outer iteration. ``draws``: the epoch's random inputs (by
        default ``draw_epoch()``, from the driver's generator)."""
        cfg = self.cfg
        bc, sc, dc = cfg.bilevel, cfg.sampler, cfg.detector
        dev = self.device
        if draws is None:
            draws = self.draw_epoch()
        noise = draws.noise.to(dev)
        psi = torch.as_tensor(psi, dtype=torch.float32).to(dev)

        # [1] render K images. With an exploration floor every psi-consuming
        # step (sampling, render, cull guard, strips gradient) sees psi_eff,
        # the logits of the eps-mixed distribution; the [3.3] gradient is
        # chained back to raw psi before [3.4]
        psi_eff = psi
        if bc.psi_mode == "categorical" and bc.explore_eps > 0.0:
            psi_eff = explore_mix_psi(psi, sc, bc.explore_eps)
        with self._timer("render"):
            renders, occ = self._render(psi_eff, noise)
        if self.grid is not None:
            # one small transfer per render; an overflow means this epoch's
            # renders dropped visible rays: render again with the raised
            # budget (monotone, capped at 1) before the detector sees them
            for _ in range(4):
                hit, budget = occ.reshape(-1, 2).sum(dim=0).tolist()
                if not self._check_occ_budget(hit, budget):
                    break
                with self._timer("render"):
                    renders, occ = self._render(psi_eff, noise)
            if epoch == 0:
                self._first_epoch_cull_guard(psi_eff, noise, renders)

        if save_pngs:
            self._save_renders(renders, epoch)

        # [2] annotate + build the inner training set (renders + backgrounds)
        n_render = int(renders.shape[0])
        labels = [self.object_class] * n_render
        with self._timer("build_dataset"):
            if self.background_images is None:
                inputs, gt_boxes, gt_labels, gt_valid = build_detector_batches_device(
                    renders, labels, dc)
            else:
                images_np = np.concatenate([renders.cpu().numpy(),
                                            np.asarray(self.background_images, np.float32)], 0)
                inputs, gt_boxes, gt_labels, gt_valid = build_detector_batches(
                    images_np, labels + list(self.background_labels), dc, device=dev)

        # [2.2] inner fine-tune (warm start: the incoming state), each step
        # gathering its batch from the dataset by index. On a mesh whose
        # data axis divides the batch, data-parallel: each rank takes its
        # columns of every step's indices (the images JAX's sharded batches
        # hold) and the gradients are summed over the data group
        batch_idx = draws.batch_idx.to(dev)
        det_state_in = det_state
        step_idx, group = batch_idx, None
        if self.mesh is not None and dc.images_per_batch % self.mesh.shape["data"] == 0:
            step_idx, group = shard_batch(batch_idx.T, self.mesh).T, self.mesh.data_group
        with self._timer("inner_train"):
            det_state, metrics = inner_train(
                det_state, (DetBatch(inputs, gt_boxes, gt_labels, gt_valid), step_idx),
                dc, self.anchors_cat, group=group)

        # [2.3] mAP on the fixed val set; the txt line's bytes are the
        # reference's `'epoch: {}' + str(result['bbox'])` (:851-853)
        with self._timer("inference"):
            map_result = self.evaluate(det_state)
        self.log.append(epoch, map_result, text=map_result_str(map_result))

        psi_probs_dev = psi if bc.psi_mode == "gaussian" else psi_to_probs(psi, sc)
        loss_dev = metrics["loss"][-1]
        record = {"epoch": epoch, "map": map_result, "detector_state": det_state}

        if not bc.optimization:
            host = torch.cat([psi_probs_dev.reshape(-1), loss_dev.reshape(1)]).cpu().numpy()
            record.update(psi=psi, psi_opt=psi_opt, psi_probs=host[:-1],
                          inner_loss=float(host[-1]))
            return record

        n_ge = min(n_render, bc.grad_e_max_images)
        if bc.hypergrad_mode == "unrolled":
            # the true dL_val/dI through the whole inner train, from the
            # pre-train state on the same schedule: replaces [3.1] + [3.2]
            with self._timer("unrolled_grad_E"):
                grad_E = self._unrolled(det_state_in, renders, labels, batch_idx)[:n_ge]
        else:
            # [3.1] v and the inverse HVP on a dedicated draw from the train
            # set (the reference builds a fresh loader, :995-1018)
            with self._timer("inverse_hvp"):
                v = self._val_grad(det_state.params)
                hvp_idx = draws.hvp_idx.to(dev)
                hvp_batch = DetBatch(inputs[hvp_idx], gt_boxes[hvp_idx],
                                     gt_labels[hvp_idx], gt_valid[hvp_idx])
                ihvp = self._ihvp(det_state.params, hvp_batch, v)
            # [3.2] grad_E on the rendered images (reference cap :876);
            # influence_sign (-1) applies the implicit-function-theorem minus
            # the reference omits
            with self._timer("grad_E"):
                grad_E = bc.influence_sign * self._grad_e(
                    det_state.params, renders[:n_ge], gt_boxes[:n_ge], gt_labels[:n_ge],
                    gt_valid[:n_ge], ihvp)

        # [3.3] dL/dpsi through sampling + render, noise cut to n_ge (the
        # reference's pose-loop truncation); the exact fine pass
        cam = cfg.camera
        noise_ge = type(noise)(*(x[:n_ge] for x in noise))
        with self._timer("render_grad"):
            if bc.grad_mode == "strips":
                rc_grad = dataclasses.replace(self.rc_test, fine_fraction=1.0)
                # bc.grad_hit_budget != 0: the grid selects which rays the
                # strips differentiate (rays missing the occupied box have
                # zero psi-gradient); < 0 tracks the calibrated budget
                ghb = bc.grad_hit_budget
                if ghb < 0:
                    ghb = self.rc_test.hit_budget
                grad_psi = render_grad_psi_strips(
                    self.nerf_models, psi_eff, noise_ge, grad_E[:n_ge], cam.height,
                    cam.width, cam.K, cfg.net, rc_grad, sc, psi_mode=bc.psi_mode,
                    strip=bc.grad_ray_chunk, image_batch=bc.strip_image_batch,
                    compute_dtype=bc.grad_compute_dtype,
                    grid=self.grid if ghb else None, hit_budget=ghb if ghb else 1.0,
                    mesh=self.mesh)
            else:
                # groups of grad_image_batch images: the gradient over all
                # images is the weighted mean of the groups' (the loss is a
                # mean over images)
                gb = max(1, bc.grad_image_batch)
                grad_psi = torch.zeros_like(psi_eff)
                for start in range(0, n_ge, gb):
                    stop = min(start + gb, n_ge)
                    noise_g = type(noise)(*(x[start:stop] for x in noise_ge))
                    g = self._render_grad(psi_eff, noise_g, grad_E[start:stop])
                    grad_psi = grad_psi + g * ((stop - start) / n_ge)

        if psi_eff is not psi:
            # chain d psi_eff / d psi: a vjp of the mix map
            with torch.enable_grad():
                p = psi.detach().requires_grad_()
                grad_psi = torch.autograd.grad(explore_mix_psi(p, sc, bc.explore_eps), p,
                                               grad_outputs=grad_psi)[0]

        # [3.4] psi update + schedule. A nonfinite gradient (a diverged
        # solver on an indefinite Hessian) is dropped and logged: psi and
        # the optimizer state carry over unchanged
        grad_finite = bool(torch.isfinite(grad_psi).all())
        if not grad_finite:
            self.log.append(epoch, {"grad_psi_nonfinite": True},
                            text=f"epoch {epoch}: nonfinite grad_psi "
                                 f"dropped (ihvp_solver={bc.ihvp_solver})")
        else:
            psi_opt, psi = psi_optimizer_update(psi_opt, psi, grad_psi)
        lr = adjust_learning_rate(epoch, bc.opt_lr, bc.n_epochs)
        psi_opt = psi_opt._replace(lr=torch.tensor(lr, dtype=torch.float32, device=dev))

        # the txt line's bytes are the reference's
        # `'epoch: {}' + str(torch_softmax(psi / gumble_T))` (:1208-1210);
        # a gaussian psi logs its raw (mean, std)
        psi_soft_dev = (psi if bc.psi_mode == "gaussian"
                        else torch.softmax(psi / sc.gumbel_temperature, dim=-1))
        parts = (psi_probs_dev.reshape(-1), loss_dev.reshape(1), psi_soft_dev.reshape(-1),
                 grad_psi.reshape(-1))
        host = torch.cat([x.detach().to(torch.float32) for x in parts]).cpu().numpy()
        sizes = np.cumsum([x.numel() for x in parts])
        psi_probs, loss, psi_soft, grad_psi_np = np.split(host, sizes[:-1])
        self.log.append(epoch, {"psi_softmax_T": psi_soft}, text=torch_tensor_str(psi_soft))

        if save_pngs:
            # grad-pass dumps (reference run_nerf_noscale.py:200-206): the
            # forward and gradient passes share the poses' noise
            self._save_renders(renders[:n_ge], epoch, subdir="withgrad")
        record.update(psi=psi, psi_opt=psi_opt, psi_probs=psi_probs,
                      inner_loss=float(loss[0]), grad_psi=grad_psi_np)
        return record

    # ------------------------------------------------------------------ #

    def evaluate(self, det_state: DetectorState) -> Dict:
        """mAP of the detector on the val set: inference in batches of
        images_per_batch, one host transfer of the detections. With
        eval_stream_images > 0 the val images stream from the host in
        chunks (``_evaluate_streamed``)."""
        dc = self.cfg.detector
        n = self.val_data.images.shape[0]
        bs = min(dc.images_per_batch, n)
        if self.streaming:
            return coco_map(self._evaluate_streamed(det_state, bs), self._val_gt_list())
        with torch.no_grad():
            parts = [retinanet_inference(self.det_apply, det_state.params,
                                         self.val_data.images[lo:lo + bs],
                                         self.anchors_per_level, dc)
                     for lo in range(0, n, bs)]
        dets = Detections(*(torch.cat(x, dim=0) for x in zip(*parts)))
        return coco_map(detections_to_eval(dets), self._val_gt_list())

    def _val_gt_list(self):
        # the val set is fixed for the driver's lifetime: one transfer
        if not hasattr(self, "_gt_list"):
            _, gt_boxes, gt_labels, gt_valid = self._val_host_arrays()
            self._gt_list = [{"boxes": gt_boxes[i][gt_valid[i]],
                              "labels": gt_labels[i][gt_valid[i]]}
                             for i in range(gt_valid.shape[0])]
        return self._gt_list

    def _val_host_arrays(self):
        """Numpy copies of the val set (images, boxes, labels, valid)."""
        if not hasattr(self, "_val_host"):
            self._val_host = tuple(_host(x) for x in self.val_data)
        return self._val_host

    def _val_on_device(self) -> ValData:
        return ValData(*(torch.as_tensor(x).to(self.device) for x in self.val_data))

    def _evaluate_streamed(self, det_state: DetectorState, bs: int):
        """Inference over a host-resident val set, one chunk of about
        eval_stream_images images on the device at a time."""
        dc = self.cfg.detector
        imgs = self._val_host_arrays()[0]
        n = imgs.shape[0]
        chunk = max(1, min(dc.eval_stream_images, n) // bs) * bs
        det_list = []
        for lo in range(0, n, chunk):
            block = torch.as_tensor(imgs[lo:lo + chunk], device=self.device)
            with torch.no_grad():
                parts = [retinanet_inference(self.det_apply, det_state.params,
                                             block[i:i + bs], self.anchors_per_level, dc)
                         for i in range(0, block.shape[0], bs)]
            det_list.extend(detections_to_eval(
                Detections(*(torch.cat(x, dim=0) for x in zip(*parts)))))
        return det_list

    def _save_renders(self, renders, epoch: int, subdir: str = ""):
        """PNGs under basedir/expname/renderonly_path/{object_id}/[subdir]
        (the reference's layout, run_nerf_noscale.py:245-250), written by
        the mesh's first rank while the others wait."""
        if self.writes:
            out = os.path.join(self.cfg.data.basedir, self.cfg.data.expname,
                               "renderonly_path", str(self.cfg.data.object_id), subdir)
            os.makedirs(out, exist_ok=True)
            arr = to8b(renders)
            for i in range(arr.shape[0]):
                write_png(os.path.join(out, f"{i:03d}.png"), arr[i])
        if self.mesh is not None:
            barrier(self.mesh)


class _NoLog(ResultLog):
    """The result log of a rank that does not write: the first rank's
    paths, nothing appended."""

    def __init__(self, output_dir: str):
        self.txt_path = os.path.join(output_dir, "save_result.txt")
        self.jsonl_path = os.path.join(output_dir, "save_result.jsonl")

    def append(self, epoch: int, payload, text=None):
        pass


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
