"""Entry ``train_step``: NeRF training steps through
``train_nerf.sample_image_rays`` and ``train_nerf.train_step`` (kernel 1
forward, the plain twin's backward, Adam), as ``train_nerf`` drives them
at no_batching: each step takes N_rand pixel rays of one training view.

Set-up: textured box-scene weights from the seed; the training views rendered from
them by the plain reference (targets are inputs, so the program does not
make them); the initial NeRF pair drawn from the seed by the reference's
copy of the init (a draw whose density is nowhere positive is drawn again,
``_live_init``) and handed to the program as its TrainState; then the
first three steps, which the check follows, and more whose median time
sets the window's step count. Every step draws its view from a host generator
and its pixels and jitter from one generator on the card, in the order
``train_nerf`` draws them.

The window runs that many steps back to back with no synchronisation
between them; a CUDA event is recorded on the stream at each step's start
and after the last, and read once the window has closed. With a trace,
``trace_steps`` more steps follow the measured ones under the profiler.

The check (training): the reference replays the first three steps from the
same initial weights and draws, and compares each step's loss, the first
gradient as Adam's state holds it after step 1 (mu / (1 - b1)), and the
parameters' change after step 3, leaf by leaf. It also replays one step of
the window, drawn from the seed, from the state the program held before it
and the same draws: its loss and the parameters' change. (Its gradient, as
(mu_after - b1 mu_before) / (1 - b1), is not compared: a gradient far
below mu's rounding cancels out of that difference.) Where the nets have
stopped rendering anything by that step (density nowhere positive, no
gradient), the step moves nothing on either side and both read 0.
"""

from __future__ import annotations

import dataclasses
import math
import statistics

import torch

from bench_port.cells import (
    Clock, flat_tree, generator, program_config, reference_config, worst_leaf_gap)
from bench_port.harness import Window, quantile

CHECKED = 3


class Cell:
    # the faults whose readings the calibration takes: half of each step's
    # rays left out, the mean taken over the rest (a state left unchanged
    # reads 1 by construction)
    FAULTS = ("half_batch",)

    def __init__(self, spec):
        from neuralsim_tpu_torch.train_nerf import TrainState, make_optimizer

        from bench_port.reference.box_scene import textured_box_params

        self.spec = spec
        self.traffic = t = spec.workload["traffic"]
        self.cfg = program_config(spec.config, spec.workload)
        self.rcfg = reference_config(spec.config, spec.workload)
        self.device = dev = spec.device
        self.hw = int(t["hw"])
        scale = self.hw / self.rcfg.camera.height
        cam = self.rcfg.camera
        self.K = torch.tensor([[cam.fx * scale, 0.0, cam.cx * scale],
                               [0.0, cam.fy * scale, cam.cy * scale],
                               [0.0, 0.0, 1.0]], dtype=torch.float32)
        self.views, self.poses = self._views(textured_box_params(
            self.rcfg.net, generator=generator(dev, spec.seed, 1), device=dev))
        self.init = self._live_init(generator(dev, spec.seed, 2))
        self.rc = dataclasses.replace(self.cfg.render, perturb=True, raw_noise_std=0.0,
                                      compute_dtype="float32")
        self.pick = torch.Generator().manual_seed(spec.seed % (2 ** 63))
        self.draws = generator(dev, spec.seed, 3)
        params = {m: {k: v.clone() for k, v in p.items()} for m, p in self.init.items()}
        self.state = TrainState(params, make_optimizer(self.cfg.train).init(params),
                                torch.zeros((), dtype=torch.int32, device=dev))
        self.replay = []              # (view, generator state) of the checked steps
        self.states = []
        self.losses = []
        for _ in range(CHECKED):
            self.replay.append((self._view(), self.draws.get_state()))
            self.state, metrics = self._step(self.replay[-1][0])
            self.states.append(self.state)
            self.losses.append(metrics["loss"])
        # the window's step count: seconds over the median of synchronised
        # set-up steps (the first ones after the checked three run slow)
        clock, times = Clock(dev), []
        for _ in range(int(t["timing_steps"])):
            start = clock.elapsed()
            self.state, _ = self._step(self._view())
            times.append(clock.elapsed() - start)
        self.step_s = statistics.median(times)

    def _live_init(self, g):
        """The initial NeRF pair: PyTorch's default init (the reference's
        copy), drawn again from ``g`` while either net's density is nowhere
        positive along a grid of the first view's rays. At this depth the
        trunk's output is nearly its last bias, so about half of the draws
        give a net that renders nothing and gets no gradient (PERF.md): a
        check of such a step would compare zeros."""
        from bench_port.reference.nerf import init_nerf_params, query_points
        from bench_port.reference.rays import get_rays
        from bench_port.reference.render import viewdirs_of
        from bench_port.reference.volume import stratified_z_vals

        rc = self.rcfg.render
        ro, rd = get_rays(self.hw, self.hw, self.K, self.poses[0][:3, :4])
        step = max(1, self.hw // 32)
        ro, rd = ro[::step, ::step].reshape(-1, 3), rd[::step, ::step].reshape(-1, 3)
        z = stratified_z_vals(ro.shape[0], rc.n_samples, rc.near, rc.far, perturb=False,
                              device=self.device)
        pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
        for _ in range(64):
            init = {"coarse": init_nerf_params(self.rcfg.net, False, g, self.device),
                    "fine": init_nerf_params(self.rcfg.net, True, g, self.device)}
            with torch.no_grad():
                live = all(float(query_points(p, pts, viewdirs_of(rd), self.rcfg.net)
                                 [..., 3].max()) > 0 for p in init.values())
            if live:
                return init
        raise RuntimeError("no live NeRF init in 64 draws")

    def _views(self, box):
        """The training views [V, hw, hw, 3] and their poses [V, 4, 4]: the
        plain reference's exact render of the box scene from V azimuths
        around the object."""
        from bench_port.reference.common import arithmetic
        from bench_port.reference.poses import pose_spherical
        from bench_port.reference.render import render_poses

        v = int(self.traffic["views"])
        sc = self.rcfg.sampler
        phi = torch.arange(v, dtype=torch.float32) * (360.0 / v)
        theta = torch.full((v,), 0.5 * (sc.theta_low_deg + sc.theta_high_deg))
        poses = pose_spherical(theta, phi - 180.0, sc.radius).to(self.device)
        rc = dataclasses.replace(self.rcfg.render, perturb=False, raw_noise_std=0.0,
                                 compute_dtype="float32")
        with torch.no_grad(), arithmetic("float32"):
            rgb = torch.cat([render_poses({"coarse": box, "fine": box}, poses[i:i + 1],
                                          self.hw, self.hw, self.K, self.rcfg.net, rc,
                                          block=int(self.spec.workload["check"]["block"]))
                             ["rgb_map"] for i in range(v)])
        return rgb, poses

    def _view(self) -> int:
        return int(torch.randint(self.views.shape[0], (1,), generator=self.pick))

    def _step(self, view: int):
        from neuralsim_tpu_torch.train_nerf import sample_image_rays, train_step

        with torch.profiler.record_function("sample_image_rays"):
            ro, rd, tgt = sample_image_rays(self.views[view], self.poses[view], self.hw,
                                            self.hw, self.K, self.cfg.train.n_rand,
                                            generator=self.draws)
        with torch.profiler.record_function("train_step"):
            return train_step(self.state, ro, rd, tgt, self.cfg.net, self.rc, self.cfg.train,
                              generator=self.draws)

    def window(self, seconds: float, tracer) -> Window:
        n = max(1, math.floor(seconds / self.step_s))
        views = [self._view() for _ in range(n)]
        # the window's step that the check replays, drawn from the seed
        pick = torch.Generator().manual_seed((self.spec.seed * 31 + 7) % (2 ** 63))
        checked = int(torch.randint(n, (1,), generator=pick))
        on_card = self.device.type == "cuda"
        starts, losses = [], []

        def mark():
            if on_card:
                starts.append(torch.cuda.Event(enable_timing=True))
                starts[-1].record()

        clock = Clock(self.device)
        for i, view in enumerate(views):
            mark()
            if i == checked:
                before = (self.state, view, self.draws.get_state())
            self.state, metrics = self._step(view)
            losses.append(metrics["loss"])
            if i == checked:
                self.win = before + (self.state, metrics["loss"])
        mark()
        elapsed = clock.elapsed()
        n_traced = int(self.traffic["trace_steps"]) if tracer.on else 0
        if n_traced:
            with tracer.stretch():
                for _ in range(n_traced):
                    self.state, _ = self._step(self._view())
        e2e = {"train_step_ms": 1e3 * elapsed / n}
        if on_card:
            ms = [a.elapsed_time(b) for a, b in zip(starts, starts[1:])]
            e2e["train_step_p95_ms"] = quantile(ms, 0.95)
        record = {"steps": n, "net": dict(self.spec.config["net"]),
                  "n_rand": self.cfg.train.n_rand,
                  "samples": self.rc.n_samples + (self.rc.n_samples + self.rc.n_importance
                                                  if self.rc.n_importance else 0)}
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        return Window(e2e, n, failed, record)

    def release(self):
        self.state = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_steps(self, mode: str = "float32", half: bool = False):
        """The reference's first three steps from the same weights and
        draws: (losses, first gradient, parameters after step 3)."""
        from bench_port.reference.common import arithmetic
        from bench_port.reference.train import adam_init, pixel_rays, step

        params = self.init
        opt = adam_init(params)
        g = torch.Generator(device=self.device)
        losses, first = [], None
        with arithmetic(mode):
            for view, state in self.replay:
                g.set_state(state)
                ro, rd, tgt = pixel_rays(self.views[view], self.poses[view], self.hw, self.hw,
                                         self.K, self.rcfg.train.n_rand, g)
                if half:
                    ro, rd, tgt = (x[:x.shape[0] // 2] for x in (ro, rd, tgt))
                params, opt, loss, grads = step(params, opt, ro, rd, tgt, self.rcfg.net,
                                                self.rc, self.rcfg.train, generator=g)
                losses.append(loss)
                first = grads if first is None else first
        return losses, first, params

    def reference_window_step(self, mode: str = "float32", half: bool = False):
        """The reference's replay of the window's checked step from the
        program's state before it: (loss, gradient, parameters after)."""
        from bench_port.reference.common import arithmetic
        from bench_port.reference.train import pixel_rays, step

        state, view, draws = self.win[:3]
        g = torch.Generator(device=self.device)
        g.set_state(draws)
        with arithmetic(mode):
            ro, rd, tgt = pixel_rays(self.views[view], self.poses[view], self.hw, self.hw,
                                     self.K, self.rcfg.train.n_rand, g)
            if half:
                ro, rd, tgt = (x[:x.shape[0] // 2] for x in (ro, rd, tgt))
            params, _, loss, grads = step(state.params, state.opt_state, ro, rd, tgt,
                                          self.rcfg.net, self.rc, self.rcfg.train, generator=g)
        return [loss], grads, params

    def check(self, control: bool = False, fault=None) -> dict:
        """The first three steps (``loss_gap``, ``grad_gap``, ``change_gap``)
        and the window's replayed step (``win_loss_gap``, ``win_change_gap``)."""
        before, _, _, after, win_loss = self.win
        first = self.reference_steps()
        step = self.reference_window_step()
        if control:
            got_first = self.reference_steps("tf32")
            got_step = self.reference_window_step("tf32")
        elif fault == "half_batch":
            got_first = self.reference_steps(half=True)
            got_step = self.reference_window_step(half=True)
        else:
            got_first = (self.losses, _adam_grad(self.states[0].opt_state["mu"]),
                         self.states[-1].params)
            got_step = ([win_loss], None, after.params)
        out = _gaps(got_first, first, self.init)
        win = _gaps(got_step, step, before.params)
        out.update(win_loss_gap=win["loss_gap"], win_change_gap=win["change_gap"])
        return out


def _adam_grad(mu, b1: float = 0.9):
    """The first step's gradient as Adam's first moment holds it."""
    return {m: {k: v / (1 - b1) for k, v in p.items()} for m, p in mu.items()}


def _gaps(got, want, start) -> dict:
    """loss_gap, grad_gap and change_gap of (losses, gradient, parameters
    after) against the reference's, the change taken from ``start`` (no
    grad_gap where ``got`` has no gradient); leaves whose reference
    gradient is under a thousandth of the median leaf's with a gradient
    are left out of the change (Adam moves them by round-off)."""
    got_losses, got_grad, got_params = got
    losses, grad, params = want
    want_g = flat_tree(grad)
    base = flat_tree(start)
    norms = {k: float(torch.linalg.norm(v.double())) for k, v in want_g.items()}
    live = sorted(v for v in norms.values() if v > 0)
    med = live[len(live) // 2] if live else 0.0
    still = {k for k, v in norms.items() if v < 1e-3 * med or v == 0}
    want_d = {k: v - base[k] for k, v in flat_tree(params).items()}
    got_d = {k: v - base[k] for k, v in flat_tree(got_params).items()}
    out = {
        "loss_gap": max(abs(float(a) - float(b)) / abs(float(b))
                        for a, b in zip(got_losses, losses)),
        "change_gap": worst_leaf_gap(got_d, want_d, skip=still),
    }
    if got_grad is not None:
        out["grad_gap"] = worst_leaf_gap(flat_tree(got_grad), want_g)
    return out
