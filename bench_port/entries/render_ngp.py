"""Entry ``render_ngp``: ``NeuralSimRenderer.render_images`` of K poses
sampled from psi through Instant-NGP's hash-grid field, the exact render
(``test_mode()``), called whole and synchronised after each call.

Set-up: the field's seeded weights made on the card from the seed
(``reference/ngp.py`` ``bench_params`` at the configuration's
``assumed.table_scale``; one field for both passes), the renderer, and
two warm-up calls at the cell's shapes, the second timed (the first loads
the kernel: a call of the cell is short beside that). The program's
configuration is the cell's sections with the net made a hash-grid field
from the ``hash`` section's settings that ``HashNetConfig`` takes (the
widths the program fixes are left to the check); the reference's is its
own copy of the render, camera and sampler sections and
``reference/ngp.py``'s ``HashGrid``. Call i of a run draws its poses from a generator of its own,
seeded from the run's seed and i. The window starts another call only
while one more, at the warm-up's length, fits in its seconds, and always
makes one. With a trace, calls that fill the workload's ``trace_seconds``
follow the measured ones under the profiler, and the record keeps the
deltas of the kernel's counters (``fused_ngp_march.calls``, ``.points``)
over them.

The check: a sample of the window's images, drawn from the seed, rendered
again by the plain reference (``reference/ngp.py``, float32, TF32 off)
from psi and the same draws; the widest and the mean gap of their rgb.
The control: the reference with TF32 on.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from bench_port.cells import Clock, generator, program_config, reference_config, sync
from bench_port.harness import Window


def _counters():
    """(calls, points) of the hash march kernel so far; None where the
    program has no such counters."""
    from neuralsim_tpu_torch.kernels import raymarch

    fn = getattr(raymarch, "fused_ngp_march", None)
    if fn is None or not hasattr(fn, "calls"):
        return None
    return fn.calls, fn.points


class Cell:
    def __init__(self, spec):
        from neuralsim_tpu_torch.config import HashNetConfig, hash_net
        from neuralsim_tpu_torch.pipeline import NeuralSimRenderer

        from bench_port.reference.ngp import bench_params, grid_of
        from bench_port.reference.psi_init import psi_init

        self.spec = spec
        self.traffic = spec.workload["traffic"]
        settable = {f.name for f in dataclasses.fields(HashNetConfig)}
        hashed = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in spec.config["hash"].items() if k in settable}
        cfg = program_config(spec.config, spec.workload)
        self.cfg = dataclasses.replace(cfg, net=hash_net(cfg.net, **hashed))
        self.rcfg = reference_config(spec.config, spec.workload)
        self.grid = grid_of(spec.config["hash"])
        self.device = spec.device
        self.k = int(self.traffic["poses"])
        params = bench_params(self.grid, float(spec.config["assumed"]["table_scale"]),
                              generator(self.device, spec.seed, 1), self.device)
        self.models = {"coarse": params, "fine": params}
        self.psi = psi_init(self.traffic["psi"])
        self.renderer = NeuralSimRenderer(self.cfg, models=self.models, device=self.device)
        # the first call loads the kernel and makes the first allocations;
        # the second is timed, the length the window and the trace plan by
        self._call(-1)
        clock = Clock(self.device)
        self._call(-1)
        self.call_s = clock.elapsed()
        self.outputs = []

    def _noise_generator(self, i: int) -> torch.Generator:
        return torch.Generator().manual_seed((self.spec.seed * 7919 + 104729 * (i + 2))
                                             % (2 ** 63))

    def _call(self, i: int) -> torch.Tensor:
        with torch.profiler.record_function("render_images"):
            rgb, _ = self.renderer.render_images(self.psi, generator=self._noise_generator(i),
                                                 num_k=self.k)
            sync(self.device)
        return rgb

    def window(self, seconds: float, tracer) -> Window:
        calls = []
        clock = Clock(self.device)
        while not calls or clock.elapsed() + self.call_s <= seconds:
            t = clock.elapsed()
            self.outputs.append(self._call(len(calls)))
            calls.append((clock.elapsed() - t, False))
        window_s = clock.elapsed()
        counted = None
        if tracer.on:
            before = _counters()
            with tracer.stretch():
                for _ in range(max(1, math.ceil(float(self.traffic["trace_seconds"])
                                                / self.call_s))):
                    t = clock.elapsed()
                    self.outputs.append(self._call(len(calls)))
                    calls.append((clock.elapsed() - t, True))
            after = _counters()
            if before is not None and after is not None:
                counted = {"calls": after[0] - before[0], "points": after[1] - before[1]}
        measured = [d for d, traced in calls if not traced]
        images = len(calls) * self.k
        rays = len(measured) * self.k * self.cfg.camera.height * self.cfg.camera.width
        failed = sum(int(not torch.isfinite(o[j]).all()) for o in self.outputs
                     for j in range(o.shape[0]))
        rc = self.cfg.render
        per_call = self.k * self.cfg.camera.height * self.cfg.camera.width
        record = {"calls": calls, "rays_per_call": per_call,
                  "chunks": [min(rc.ray_chunk, per_call - lo)
                             for lo in range(0, per_call, rc.ray_chunk)],
                  "samples": (rc.n_samples, rc.n_samples + rc.n_importance),
                  "hash": dict(self.spec.config["hash"]), "counters": counted,
                  "kernels": self.spec.workload["kernels"]}
        return Window({"render_rays_per_s": rays / window_s}, images, failed, record)

    def release(self):
        self.renderer = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self):
        """(call, image) pairs of the check, drawn from the seed."""
        g = torch.Generator().manual_seed(self.spec.seed % (2 ** 63))
        n = len(self.outputs) * self.k
        count = min(int(self.spec.workload["check"]["images"]), n)
        return [(int(i) // self.k, int(i) % self.k) for i in torch.randperm(n, generator=g)[:count]]

    def reference_rgb(self, pairs, arithmetic_mode="float32"):
        from bench_port.reference.common import arithmetic
        from bench_port.reference.ngp import render_poses
        from bench_port.reference.poses import draw_pose_noise, poses_from_noise, psi_to_probs

        rc = dataclasses.replace(self.rcfg.render, perturb=False, raw_noise_std=0.0)
        cam, sc = self.rcfg.camera, self.rcfg.sampler
        block = int(self.spec.workload["check"]["block"])
        psi = self.psi.to(self.device)
        params = self.models["coarse"]
        out = []
        with torch.no_grad(), arithmetic(arithmetic_mode):
            for call, j in pairs:
                noise = draw_pose_noise(self._noise_generator(call), sc, self.k, self.device)
                noise = type(noise)(*(x[j:j + 1] for x in noise))
                poses = poses_from_noise(psi_to_probs(psi, sc), noise, sc)
                out.append(render_poses(params, poses, cam.height, cam.width, cam.K, self.grid,
                                        rc, block)["rgb_map"][0])
        return out

    def check(self, control: bool = False) -> dict:
        pairs = self.sample()
        want = self.reference_rgb(pairs)
        if control:
            got = self.reference_rgb(pairs, **self.spec.workload["control"])
        else:
            got = [self.outputs[c][j] for c, j in pairs]
        gaps = [(g.float() - w.float()).abs() for g, w in zip(got, want)]
        return {"rgb_max_abs": max(float(x.max()) for x in gaps),
                "rgb_mean_abs": float(torch.stack([x.mean() for x in gaps]).mean())}
