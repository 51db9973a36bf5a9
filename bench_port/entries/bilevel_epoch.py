"""Entry ``bilevel_epoch``: whole outer iterations through
``BilevelDriver.run_epoch``: render K poses from psi, annotate, fine-tune
RetinaNet, mAP on the val set, v and the inverse HVP, grad_E, the strips
gradient through the renderer, the psi step.

Set-up: textured box-scene weights from the seed; the val set
(``traffic.val_images`` renders at psi_init(``traffic.val_psi``)) rendered
and annotated by the plain reference; the driver, with its result log under the run's
temporary directory; the initial detector drawn from the seed by the
reference's copy of the init; then the warm-up, epoch 0, from psi_init of
the configuration. Every epoch's draws (pose noise, the inner train's
batches, the HVP batch) come from a generator of the epoch's own, seeded
from the run's seed, and are handed to ``run_epoch``.

The window runs epochs from the state epoch 0 left; it starts another only
while one more, at the length of its epochs so far, fits in its seconds,
and always runs one. ``epoch_s`` is its host time over its epochs; the stage seconds
are the driver's own ``phase_timer`` spans. With a trace, one more epoch
follows the measured ones under the profiler.

The check follows epoch 0, stage by stage, each stage from the program's
own output of the stage before (see ``check``): one rounding in the inner
train can move grad_psi far (PERF.md), so an end-to-end comparison would
judge the conditioning and not the program. It also checks the window's
first epoch: its renders, and its inner train's change of the detector.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bench_port.cells import (
    Clock, generator, program_config, reference_config, rel_l2, tree_rel_l2)
from bench_port.harness import Window

STAGES = ("_render", "_ihvp", "_grad_e")


class Cell:
    def __init__(self, spec):
        from neuralsim_tpu_torch.bilevel.driver import BilevelDriver, ValData
        from neuralsim_tpu_torch.bilevel.psi_opt import psi_optimizer_init
        from neuralsim_tpu_torch.detector.trainer import (
            DetectorState, make_detector_optimizer, split_trainable)

        from bench_port.reference.box_scene import textured_box_params
        from bench_port.reference.detector import init_detector
        from bench_port.reference.psi_init import psi_init

        self.spec = spec
        self.traffic = spec.workload["traffic"]
        self.device = dev = spec.device
        cfg = program_config(spec.config, spec.workload)
        self.cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, basedir=spec.tmpdir, expname="bench", save_pngs=False))
        self.rcfg = reference_config(spec.config, spec.workload)
        box = textured_box_params(self.rcfg.net, generator=generator(dev, spec.seed, 1),
                               device=dev)
        self.models = {"coarse": box, "fine": box}
        self.val = self._val_set()
        dc = self.cfg.detector
        self.det0 = init_detector(generator(dev, spec.seed, 2), self.rcfg.detector,
                                  device=dev).params
        params = {k: v.clone() for k, v in self.det0.items()}
        trainable, _ = split_trainable(params, dc)
        det_state = DetectorState(params, make_detector_optimizer(dc).init(trainable),
                                  torch.zeros((), dtype=torch.int32, device=dev))
        bc = self.cfg.bilevel
        self.psi0 = psi_init(bc.psi_pose_cats_mode).to(dev)
        self.psi_opt0 = psi_optimizer_init(bc.opt_method, bc.opt_lr, dim=self.psi0.shape[0])
        self.driver = BilevelDriver(self.cfg, self.models, ValData(*self.val),
                                    generator=torch.Generator().manual_seed(0),
                                    output_dir=spec.tmpdir, device=dev)

        # epoch 0, the warm-up, and the window's first epoch keep their
        # stages' outputs for the check ({epoch: {stage: output}})
        self.kept = {0: {}, 1: {}}
        self.epochs = 0
        for name in STAGES:
            setattr(self.driver, name, self._keep(name, getattr(self.driver, name)))
        self.draws0 = self._draws(0)
        record = self.driver.run_epoch(0, self.psi0, self.psi_opt0, det_state,
                                       draws=self.draws0)
        self.epoch0 = record
        self.state = (record["psi"], record["psi_opt"], record["detector_state"])
        self.epochs = 1
        self.draws1 = self._draws(1)
        self.epoch1 = None

    def _keep(self, name, fn):
        def kept(*args):
            out = fn(*args)
            self.kept[self.epochs][name] = out
            return out
        return kept

    def _val_set(self):
        """The val set: renders at psi_init(val_psi) by the plain reference,
        annotated on the device by the reference's copy of the annotator."""
        from bench_port.reference.common import arithmetic
        from bench_port.reference.dataset import build_detector_batches_device
        from bench_port.reference.poses import draw_pose_noise, poses_from_noise, psi_to_probs
        from bench_port.reference.psi_init import psi_init
        from bench_port.reference.render import render_poses

        n, sc, cam = int(self.traffic["val_images"]), self.rcfg.sampler, self.rcfg.camera
        noise = draw_pose_noise(generator("cpu", self.spec.seed, 4), sc, n, self.device)
        psi = psi_init(self.traffic["val_psi"]).to(self.device)
        poses = poses_from_noise(psi_to_probs(psi, sc), noise, sc)
        rc = dataclasses.replace(self.rcfg.render, perturb=False, compute_dtype="float32")
        with torch.no_grad(), arithmetic("float32"):
            rgb = render_poses(self.models, poses, cam.height, cam.width, cam.K,
                               self.rcfg.net, rc)["rgb_map"]
        return build_detector_batches_device(rgb, [1] * n, self.rcfg.detector)

    def _draws(self, epoch: int):
        """Epoch ``epoch``'s draws, made by the reference's copies of the
        samplers and handed to the program as its EpochDraws."""
        from neuralsim_tpu_torch.bilevel.driver import EpochDraws
        from neuralsim_tpu_torch.sampler.poses import PoseNoise

        from bench_port.reference.detector import cycle_indices
        from bench_port.reference.poses import draw_pose_noise

        g = generator("cpu", self.spec.seed, 100 + epoch)
        sc, dc = self.rcfg.sampler, self.rcfg.detector
        noise = draw_pose_noise(g, sc)
        n = sc.n_samples_k
        batch_idx = cycle_indices(n, dc.max_iter, dc.images_per_batch, g)
        hvp_idx = cycle_indices(n, 1, dc.images_per_batch, g)[0]
        return EpochDraws(PoseNoise(*noise), batch_idx, hvp_idx)

    def window(self, seconds: float, tracer) -> Window:
        phases = self.driver.phases
        before = dict(phases.totals)
        grads = []
        clock = Clock(self.device)
        # another epoch only while one more, at the mean of the window's
        # epochs so far, fits
        while not grads or clock.elapsed() * (1 + 1 / len(grads)) <= seconds:
            grads.append(self._epoch())
        elapsed = clock.elapsed()
        n = len(grads)
        stage_s = {k: (v - before.get(k, 0.0)) / n for k, v in phases.totals.items()}
        if tracer.on:
            with tracer.stretch():
                grads.append(self._epoch())
        failed = sum(int(not np.isfinite(g).all()) for g in grads)
        return Window({"epoch_s": elapsed / n}, len(grads), failed,
                      {"stage_s": stage_s, "epochs": n})

    def _epoch(self):
        """One more epoch from the state the last one left; its grad_psi."""
        psi, psi_opt, det = self.state
        draws = self.draws1 if self.epochs == 1 else self._draws(self.epochs)
        record = self.driver.run_epoch(self.epochs, psi, psi_opt, det, draws=draws)
        self.state = (record["psi"], record["psi_opt"], record["detector_state"])
        if self.epochs == 1:
            self.epoch1 = record
            for name in STAGES:
                delattr(self.driver, name)
        self.epochs += 1
        return record["grad_psi"]

    def release(self):
        self.driver = None
        self.state = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------ #
    # the check: epoch 0, stage by stage, and the window's first epoch
    # ------------------------------------------------------------------ #

    def check(self, control: bool = False) -> dict:
        """Each stage's output of epoch 0 against the reference's, the
        reference computing each stage from the program's output of the
        stage before (its renders, its trained detector, its inverse HVP,
        its grad_E, its grad_psi), on a sample of images drawn from the
        seed where the stage is one image at a time:

          render_rgb_max_abs   the renders of the sampled poses, from psi0
                               and the epoch's noise;
          det_change_rel       the inner train's change of the detector,
                               from the initial weights on the program's
                               renders and the epoch's batches;
          ihvp_rel             v over the val set and (H + damping I) v on
                               the HVP batch, at the program's trained
                               detector;
          grad_e_rel           grad_E of the sampled images, from the
                               program's inverse HVP;
          grad_psi_rel         the strips gradient of every image, from the
                               program's grad_E, its MLP's operands in the
                               dtype the configuration states (bfloat16);
          psi_step_rel         psi's step against the reference's step
                               from the reference's grad_psi;
          win_render_rgb_max_abs  the window's first epoch: the renders
                               of its sampled poses, from the psi that
                               epoch 0 left (psi_step_rel checks it) and
                               the epoch's noise;
          win_det_change_rel   the window's first epoch: its inner train's
                               change of the detector, the reference
                               following both inner trains from the
                               initial weights on the program's renders
                               of each epoch.

        ``control``: each stage in the next lower precision (TF32 for the
        float32 stages, float8 operands for the bfloat16 strips) in the
        program's place."""
        w = self.spec.workload
        lower, dtype = ("tf32", "float8") if control else (None, None)
        k0 = self.kept[0]
        renders = k0["_render"][0]
        count = int(w["check"]["images"])
        sample = self._sample(renders.shape[0], count)
        out = {"render_rgb_max_abs": self._render_gap(renders, sample, self.psi0,
                                                      self.draws0, lower)}

        state_ref, data = self._ref_inner_train(None, renders, self.draws0, "float32")
        det_ref = state_ref.params
        state_low = self._ref_inner_train(None, renders, self.draws0, lower)[0] if control else None
        det_got = state_low.params if control else self.epoch0["detector_state"].params
        trainable = sorted(k for k in det_ref if not k.startswith("backbone."))
        change = {k: det_ref[k] - self.det0[k] for k in trainable}
        out["det_change_rel"] = tree_rel_l2({k: det_got[k] - self.det0[k] for k in trainable},
                                            change)

        # the window's first epoch, from the state epoch 0 left
        renders1 = self.kept[1]["_render"][0]
        psi1 = torch.as_tensor(self.epoch0["psi"], device=self.device)
        out["win_render_rgb_max_abs"] = self._render_gap(
            renders1, self._sample(renders1.shape[0], count, salt=1), psi1, self.draws1, lower)
        ref1 = self._ref_inner_train(state_ref, renders1, self.draws1, "float32")[0].params
        if control:
            got0 = det_got
            got1 = self._ref_inner_train(state_low, renders1, self.draws1, lower)[0].params
        else:
            got0, got1 = det_got, self.epoch1["detector_state"].params
        out["win_det_change_rel"] = tree_rel_l2(
            {k: got1[k] - got0[k] for k in trainable},
            {k: ref1[k] - det_ref[k] for k in trainable})

        theta = self.epoch0["detector_state"].params
        ihvp_ref = self._ref_ihvp(theta, data, "float32")
        ihvp_got = self._ref_ihvp(theta, data, lower) if control else k0["_ihvp"]
        out["ihvp_rel"] = tree_rel_l2(ihvp_got, ihvp_ref)

        ihvp = k0["_ihvp"]
        ge_ref = self._ref_grad_e(theta, data, ihvp, sample, "float32")
        ge_got = (self._ref_grad_e(theta, data, ihvp, sample, lower) if control
                  else k0["_grad_e"][sample])
        out["grad_e_rel"] = rel_l2(ge_got, ge_ref)

        grad_e = self.rcfg.bilevel.influence_sign * k0["_grad_e"]
        stated = self.rcfg.bilevel.grad_compute_dtype
        gp_ref = self._ref_strips(grad_e, stated)
        gp_got = (self._ref_strips(grad_e, dtype) if control
                  else torch.as_tensor(self.epoch0["grad_psi"], device=self.device))
        out["grad_psi_rel"] = rel_l2(gp_got, gp_ref)

        step_ref = self._ref_psi_step(gp_ref)
        step_got = self._ref_psi_step(gp_got) if control else self.epoch0["psi"] - self.psi0
        out["psi_step_rel"] = rel_l2(step_got, step_ref)
        return out

    def _ref_psi_step(self, grad_psi):
        """psi1 - psi0 of the reference's optimizer at epoch 0."""
        from bench_port.reference.psi_opt import psi_optimizer_init, psi_optimizer_update

        bc = self.rcfg.bilevel
        opt = psi_optimizer_init(bc.opt_method, bc.opt_lr, dim=self.psi0.shape[0])
        _, psi1 = psi_optimizer_update(opt, self.psi0, grad_psi)
        return psi1 - self.psi0

    def _sample(self, n: int, count: int, salt: int = 0):
        g = torch.Generator().manual_seed((self.spec.seed + 7919 * salt) % (2 ** 63))
        return sorted(int(i) for i in torch.randperm(n, generator=g)[:min(count, n)])

    def _render_gap(self, renders, sample, psi, draws, lower):
        """The widest gap between the sampled renders (the program's, or
        with ``lower`` the reference's in that precision) and the
        reference's float32 renders from ``psi`` and the epoch's noise."""
        want = self._ref_render(sample, psi, draws, "float32")
        got = (self._ref_render(sample, psi, draws, lower) if lower
               else [renders[i] for i in sample])
        return max(float((a - b).abs().max()) for a, b in zip(got, want))

    def _ref_render(self, sample, psi, draws, mode):
        from bench_port.reference.common import arithmetic
        from bench_port.reference.poses import poses_from_noise, psi_to_probs
        from bench_port.reference.render import render_poses

        sc, cam = self.rcfg.sampler, self.rcfg.camera
        noise = draws.noise
        rc = dataclasses.replace(self.rcfg.render, perturb=False, raw_noise_std=0.0,
                                 compute_dtype="float32")
        out = []
        with torch.no_grad(), arithmetic(mode):
            for i in sample:
                nz = type(noise)(*(x[i:i + 1].to(self.device) for x in noise))
                poses = poses_from_noise(psi_to_probs(psi, sc), nz, sc)
                out.append(render_poses(self.models, poses, cam.height, cam.width, cam.K,
                                        self.rcfg.net, rc)["rgb_map"][0])
        return out

    def _ref_inner_train(self, state, renders, draws, mode):
        """(trained state, the detector's inputs) of the reference's inner
        train on ``renders`` with the epoch's batches, from ``state`` (None:
        the initial weights)."""
        from bench_port.reference.common import arithmetic
        from bench_port.reference.dataset import build_detector_batches_device
        from bench_port.reference.detector import (
            DetectorState, inner_train, make_detector_optimizer, split_trainable)
        from bench_port.reference.retinanet import DetBatch, generate_anchors

        dc = self.rcfg.detector
        data = DetBatch(*build_detector_batches_device(renders, [1] * renders.shape[0], dc))
        anchors = torch.cat(generate_anchors(dc.image_size, self.device), dim=0)
        if state is None:
            params = dict(self.det0)
            trainable, _ = split_trainable(params, dc)
            state = DetectorState(params, make_detector_optimizer(dc).init(trainable),
                                  torch.zeros((), dtype=torch.int32, device=self.device))
        with arithmetic(mode):
            state, _ = inner_train(state, data, draws.batch_idx.to(self.device), dc, anchors)
        return state, data

    def _loss_fn(self, theta):
        from bench_port.reference.detector import (
            make_detector_apply, merge_params, split_trainable)
        from bench_port.reference.retinanet import generate_anchors, retinanet_loss

        dc = self.rcfg.detector
        _, apply = make_detector_apply(dc)
        anchors = torch.cat(generate_anchors(dc.image_size, self.device), dim=0)
        trainable, frozen = split_trainable(theta, dc)

        def loss(tp, batch, image_weight=None):
            return retinanet_loss(apply, merge_params(tp, frozen), batch, anchors, dc,
                                  image_weight=image_weight)[0]

        return trainable, loss

    def _ref_ihvp(self, theta, data, mode):
        """v over the val set in batches (a short last batch masked), then
        (H + damping I) v on the epoch's HVP batch."""
        from bench_port.reference.common import arithmetic
        from bench_port.reference.influence import grad_loss, inverse_hvp_onestep
        from bench_port.reference.retinanet import DetBatch

        dc, bc = self.rcfg.detector, self.rcfg.bilevel
        trainable, loss = self._loss_fn(theta)
        val = DetBatch(*self.val)
        n = val.images.shape[0]
        bs = min(dc.images_per_batch, n)
        if n % bs:
            raise ValueError("the val set's size must be a multiple of the batch")
        batches = [DetBatch(*(x[lo:lo + bs] for x in val)) for lo in range(0, n, bs)]
        idx = self.draws0.hvp_idx.to(self.device)
        with arithmetic(mode):
            v = grad_loss(lambda tp, b: loss(tp, b), trainable, batches)
            return inverse_hvp_onestep(lambda tp, b: loss(tp, b), trainable,
                                       DetBatch(*(x[idx] for x in data)), v,
                                       damping=bc.ihvp_damping)

    def _ref_grad_e(self, theta, data, ihvp, sample, mode):
        from bench_port.reference.common import arithmetic
        from bench_port.reference.dataset import prepare_images
        from bench_port.reference.influence import mixed_grad_wrt_images
        from bench_port.reference.retinanet import DetBatch

        dc = self.rcfg.detector
        trainable, loss = self._loss_fn(theta)
        renders = self.kept[0]["_render"][0]
        rows = []
        with arithmetic(mode):
            for i in sample:
                def loss_img(tp, r, i=i):
                    return loss(tp, DetBatch(prepare_images(r[None], dc), data.gt_boxes[i:i + 1],
                                             data.gt_labels[i:i + 1], data.gt_valid[i:i + 1]))
                rows.append(mixed_grad_wrt_images(loss_img, trainable, renders[i:i + 1],
                                                  ihvp)[0])
        return torch.stack(rows)

    def _ref_strips(self, grad_e, dtype):
        from bench_port.reference.common import arithmetic
        from bench_port.reference.render_grad import image_grads

        bc, cam = self.rcfg.bilevel, self.rcfg.camera
        noise = self.draws0.noise
        n = grad_e.shape[0]
        nz = type(noise)(*(x[:n].to(self.device) for x in noise))
        rc = dataclasses.replace(self.rcfg.render, perturb=False, raw_noise_std=0.0)
        with arithmetic("float32"):
            rows = image_grads(self.models, self.psi0, nz, grad_e, cam.height, cam.width,
                               cam.K, self.rcfg.net, rc, self.rcfg.sampler,
                               strip=bc.grad_ray_chunk, compute_dtype=dtype)
        return rows.mean(dim=0)
