"""Entry ``render_images``: ``NeuralSimRenderer.render_images`` of K poses
sampled from psi, the exact render (``test_mode()``), called whole and
synchronised after each call.

Set-up: textured box-scene weights made on the card from the seed
(``reference/box_scene.py``; coarse and fine alike), the renderer, and one
warm-up call at the cell's shapes. Call i of a run draws its poses from a
generator of its own, seeded from the run's seed and i. The window starts
another call only while one more, at the warm-up's length, fits in its
seconds, and always makes one. With a trace, calls that fill the workload's
``trace_seconds`` follow the measured ones under the profiler.

The check: a sample of the window's images, drawn from the seed, rendered
again by the plain reference from psi and the same draws, its MLP's
operands rounded to the dtype the configuration states and everything
else in float32 (TF32 off); the widest and the mean gap of their rgb.
"""

from __future__ import annotations

import math

import torch

from bench_port.cells import Clock, generator, program_config, reference_config, sync
from bench_port.harness import Window


class Cell:
    def __init__(self, spec):
        from neuralsim_tpu_torch.pipeline import NeuralSimRenderer

        from bench_port.reference.box_scene import textured_box_params
        from bench_port.reference.psi_init import psi_init

        self.spec = spec
        self.traffic = spec.workload["traffic"]
        self.cfg = program_config(spec.config, spec.workload)
        self.rcfg = reference_config(spec.config, spec.workload)
        self.device = spec.device
        self.k = int(self.traffic["poses"])
        box = textured_box_params(self.rcfg.net, generator=generator(self.device, spec.seed, 1),
                               device=self.device)
        self.models = {"coarse": box, "fine": box}
        self.psi = psi_init(self.traffic["psi"])
        self.renderer = NeuralSimRenderer(self.cfg, models=self.models, device=self.device)
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
        if tracer.on:
            with tracer.stretch():
                for _ in range(max(1, math.ceil(float(self.traffic["trace_seconds"])
                                                / self.call_s))):
                    t = clock.elapsed()
                    self.outputs.append(self._call(len(calls)))
                    calls.append((clock.elapsed() - t, True))
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
                  "dtype": rc.compute_dtype, "net": dict(self.spec.config["net"]),
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

    def reference_rgb(self, pairs, arithmetic_mode="float32", compute_dtype=None):
        import dataclasses

        from bench_port.reference.common import arithmetic
        from bench_port.reference.poses import draw_pose_noise, poses_from_noise, psi_to_probs
        from bench_port.reference.render import render_poses

        rc = dataclasses.replace(self.rcfg.render, perturb=False, raw_noise_std=0.0,
                                 compute_dtype=compute_dtype or self.rcfg.render.compute_dtype)
        cam, sc = self.rcfg.camera, self.rcfg.sampler
        block = int(self.spec.workload["check"]["block"])
        psi = self.psi.to(self.device)
        out = []
        with torch.no_grad(), arithmetic(arithmetic_mode):
            for call, j in pairs:
                noise = draw_pose_noise(self._noise_generator(call), sc, self.k, self.device)
                noise = type(noise)(*(x[j:j + 1] for x in noise))
                poses = poses_from_noise(psi_to_probs(psi, sc), noise, sc)
                out.append(render_poses(self.models, poses, cam.height, cam.width, cam.K,
                                        self.rcfg.net, rc, block=block)["rgb_map"][0])
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
