"""The port's spans (``neuralsim_tpu_torch.utils.profiling.span``) where
the work happens, read from ``torch.profiler``'s Chrome trace on the CPU as
the benchmark reads them on the card (``user_annotation`` ranges): one
span per unit of work, nested under the span open around it.

  inner_train.step      detector/trainer.py inner_train, per step (outside
                        the step's checkpoint: a recompute opens none)
  grad_E.image          hypergrad/influence.py mixed_grad_wrt_images, per image
  grad_E.batch          hypergrad/influence.py mixed_grad_wrt_image_batch, per
                        double backward (the driver's grad_E)
  render_grad.strip     hypergrad/render_grad.py render_grad_psi_strips, per
                        strip tile
  render.chunk          ops/render.py's dense chunk loop, per ray chunk
  train_nerf.step       train_nerf.train_step, with train_nerf.forward,
                        .backward and .update inside it in that order
  kernels.pack_weights  kernels/raymarch.py, per weight set prepared again

With the profiler off a span opens no ``record_function`` at all."""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from neuralsim_tpu_torch.config import (
    DetectorConfig,
    NeRFNetConfig,
    RenderConfig,
    SamplerConfig,
    TrainConfig,
)
from neuralsim_tpu_torch.detector import trainer as tt
from neuralsim_tpu_torch.hypergrad.influence import (
    mixed_grad_wrt_image_batch,
    mixed_grad_wrt_images,
)
from neuralsim_tpu_torch.hypergrad.render_grad import render_grad_psi_strips
from neuralsim_tpu_torch.kernels import raymarch as rm
from neuralsim_tpu_torch.models.nerf import init_nerf_params, init_nerf_pipeline_params
from neuralsim_tpu_torch.models.retinanet import DetBatch
from neuralsim_tpu_torch.ops.render import render_ray_batch
from neuralsim_tpu_torch.sampler.poses import PoseNoise
from neuralsim_tpu_torch.train_nerf import init_train_state, train_step
from neuralsim_tpu_torch.utils import profiling
from neuralsim_tpu_torch.utils.profiling import PhaseTimes, phase_timer, span
from tests.test_torch_net_shapes import _FakeMarchLibrary

torch.set_num_threads(2)

NET = NeRFNetConfig(netdepth=2, netwidth=16, netdepth_fine=2, netwidth_fine=16, skips=(0,),
                    multires=2, multires_views=1)
RC = RenderConfig(n_samples=4, n_importance=4, ray_chunk=4096, near=0.5, far=2.0).test_mode()
H = W = 12
K = np.array([[15.0, 0, 6.0], [0, 15.0, 6.0], [0, 0, 1.0]], np.float32)


def traced(fn, tmp_path):
    """(fn's result, {span name: [(start, end)] in start order}) of the
    ``user_annotation`` ranges that fn opened under the CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            spans.setdefault(e["name"], []).append((float(e["ts"]), float(e["ts"] + e["dur"])))
    return out, {k: sorted(v) for k, v in spans.items()}


def inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def disjoint(intervals) -> bool:
    return all(a[1] <= b[0] for a, b in zip(intervals, intervals[1:]))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_inner_train_opens_one_span_per_step(tmp_path, remat):
    dc = DetectorConfig(num_classes=2, image_size=32, images_per_batch=2, warmup_iters=1)
    rng = np.random.RandomState(0)
    xy = rng.uniform(0, 16, (4, 2, 2))
    data = DetBatch(torch.as_tensor(rng.randn(4, 32, 32, 3).astype(np.float32)),
                    torch.as_tensor(np.concatenate([xy, xy + 10.0], -1).astype(np.float32)),
                    torch.zeros((4, 2), dtype=torch.int32), torch.ones((4, 2), dtype=bool))
    images = data.images.clone().requires_grad_(remat)
    state = tt.init_detector(torch.Generator().manual_seed(0), dc, device="cpu")
    idx = torch.tensor([[0, 1], [2, 3], [3, 0]])
    phases = PhaseTimes()

    def run():
        with phase_timer("inner_train", phases):
            final, metrics = tt.inner_train(state, (DetBatch(images, *data[1:]), idx), dc,
                                            remat=remat)
        if remat:
            # the backward recomputes every checkpointed step
            metrics["loss"].sum().backward()
        return final

    final, spans = traced(run, tmp_path)
    assert int(final.step) == 3
    assert remat == (images.grad is not None and bool(images.grad.abs().sum() > 0))
    steps = spans["inner_train.step"]
    assert len(steps) == 3 and disjoint(steps)
    assert all(inside(s, spans["inner_train"][0]) for s in steps)


def test_grad_e_opens_one_span_per_image(tmp_path):
    g = torch.Generator().manual_seed(1)
    params = {"w": torch.randn(6, generator=g), "b": torch.randn(1, generator=g)}
    v = {"w": torch.randn(6, generator=g), "b": torch.randn(1, generator=g)}
    images = torch.randn(2, 6, generator=g)

    def loss_img(p, img):
        return torch.sum(torch.tanh(p["w"] * img + p["b"]) ** 2)

    def run():
        with phase_timer("grad_E", PhaseTimes()):
            return mixed_grad_wrt_images(loss_img, params, images, v)

    out, spans = traced(run, tmp_path)
    assert out.shape == images.shape and bool(out.abs().sum() > 0)
    per_image = spans["grad_E.image"]
    assert len(per_image) == 2 and disjoint(per_image)
    assert all(inside(s, spans["grad_E"][0]) for s in per_image)


def test_grad_e_batch_opens_one_span_per_batch(tmp_path):
    """5 images in batches of 2, the tail padded with a zero-weight row:
    one span and one ``.batches`` a double backward, ``.images`` counts the
    real images; the rows are the serial form's."""
    g = torch.Generator().manual_seed(1)
    params = {"w": torch.randn(6, generator=g), "b": torch.randn(1, generator=g)}
    v = {"w": torch.randn(6, generator=g), "b": torch.randn(1, generator=g)}
    images = torch.randn(5, 6, generator=g)

    def loss_img(p, img):
        return torch.sum(torch.tanh(p["w"] * img + p["b"]) ** 2)

    def run():
        out = []
        with phase_timer("grad_E", PhaseTimes()):
            for lo in range(0, 5, 2):
                n = min(2, 5 - lo)
                rows = torch.cat([images[lo:lo + n], torch.zeros(2 - n, 6)])
                weight = (torch.arange(2) < n).to(torch.float32)

                def loss_batch(p, imgs, weight=weight):
                    return sum(wi * loss_img(p, im) for wi, im in zip(weight, imgs))

                out.append(mixed_grad_wrt_image_batch(loss_batch, params, rows, v, n_images=n))
        return torch.cat(out)

    fn = mixed_grad_wrt_image_batch
    batches, counted = fn.batches, fn.images
    out, spans = traced(run, tmp_path)
    assert (fn.batches - batches, fn.images - counted) == (3, 5)
    torch.testing.assert_close(out, mixed_grad_wrt_images(loss_img, params, images, v))
    per_batch = spans["grad_E.batch"]
    assert len(per_batch) == 3 and disjoint(per_batch)
    assert all(inside(s, spans["grad_E"][0]) for s in per_batch)
    assert "grad_E.image" not in spans


def _nerf_models(seed: int):
    models = init_nerf_pipeline_params(NET, RC.n_importance, torch.Generator().manual_seed(seed),
                                       "cpu")
    # a raised density bias: every ray sees density, so every strip has a gradient
    for p in models.values():
        p["alpha_bias"] = p["alpha_bias"] + 1.0
    return models


@pytest.mark.parametrize("image_batch", [1, 2])
def test_strips_open_one_span_per_strip_tile(tmp_path, image_batch):
    rng = np.random.RandomState(2)
    noise = PoseNoise(torch.as_tensor(rng.gumbel(size=(2, 8)).astype(np.float32)),
                      torch.as_tensor(rng.rand(2).astype(np.float32)),
                      torch.as_tensor((85 + 10 * rng.rand(2)).astype(np.float32)))
    grad_e = torch.as_tensor((rng.randn(2, H, W, 3) * 1e-2).astype(np.float32))
    psi = torch.eye(8)[4]

    def run():
        return render_grad_psi_strips(_nerf_models(0), psi, noise, grad_e, H, W, K, NET, RC,
                                      SamplerConfig(), strip=H * W // 2,
                                      image_batch=image_batch)

    grad, spans = traced(run, tmp_path)
    assert grad.shape == psi.shape and bool(grad.abs().sum() > 0)
    strips = spans["render_grad.strip"]
    # 2 images x 2 strips, or 2 strips of both images together
    assert len(strips) == 4 // image_batch and disjoint(strips)
    # each strip renders its tile as one chunk
    chunks = spans["render.chunk"]
    assert len(chunks) == len(strips)
    assert all(inside(c, s) for c, s in zip(chunks, strips))


def test_dense_render_opens_one_span_per_chunk(tmp_path):
    g = torch.Generator().manual_seed(3)
    rays_o = torch.randn(40, 3, generator=g) * 0.1 + torch.tensor([0.0, 0.0, -1.2])
    rays_d = torch.nn.functional.normalize(
        torch.randn(40, 3, generator=g) * 0.1 + torch.tensor([0.0, 0.0, 1.0]), dim=-1)
    rc = dataclasses.replace(RC, ray_chunk=16)

    def run():
        with torch.no_grad():
            return render_ray_batch(_nerf_models(4), rays_o, rays_d, NET, rc)

    out, spans = traced(run, tmp_path)
    assert out["rgb_map"].shape == (40, 3)
    # 16 + 16 + 8 rays
    assert len(spans["render.chunk"]) == 3 and disjoint(spans["render.chunk"])


def test_train_step_opens_its_span_and_three_children(tmp_path):
    rc = dataclasses.replace(RC, perturb=True)
    state = init_train_state(NET, rc, TrainConfig(), torch.Generator().manual_seed(5), "cpu")
    g = torch.Generator().manual_seed(6)
    rays_o = torch.randn(32, 3, generator=g) * 0.1 + torch.tensor([0.0, 0.0, -1.2])
    rays_d = torch.nn.functional.normalize(
        torch.randn(32, 3, generator=g) * 0.1 + torch.tensor([0.0, 0.0, 1.0]), dim=-1)
    target = torch.rand(32, 3, generator=g)

    def run():
        return train_step(state, rays_o, rays_d, target, NET, rc, TrainConfig(),
                          generator=torch.Generator().manual_seed(7))

    (new, metrics), spans = traced(run, tmp_path)
    assert int(new.step) == 1 and torch.isfinite(metrics["loss"])
    (step,) = spans["train_nerf.step"]
    children = [spans[f"train_nerf.{k}"] for k in ("forward", "backward", "update")]
    assert all(len(c) == 1 and inside(c[0], step) for c in children)
    (fwd,), (bwd,), (upd,) = children
    assert fwd[1] <= bwd[0] and bwd[1] <= upd[0]


def test_pack_weights_opens_a_span_per_preparation(tmp_path):
    net = NeRFNetConfig(netdepth=4, netwidth=32, netdepth_fine=4, netwidth_fine=32, skips=(2,))
    params = init_nerf_params(net, generator=torch.Generator().manual_seed(8))
    depth = rm._depth(params)
    lib = _FakeMarchLibrary()
    rm._PACKED.clear()

    def pack():
        return rm._packed_weights(params, net, depth, False, lib, "test")

    _, spans = traced(pack, tmp_path)
    assert len(spans["kernels.pack_weights"]) == 1
    # the same weight set again: a cache hit opens nothing
    _, spans = traced(pack, tmp_path)
    assert "kernels.pack_weights" not in spans
    params["pts_1_kernel"].mul_(2.0)                # an in-place update prepares again
    _, spans = traced(pack, tmp_path)
    assert len(spans["kernels.pack_weights"]) == 1


def test_span_opens_no_range_with_the_profiler_off(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            entered.append(self.name)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    phases = PhaseTimes()
    assert not torch.autograd._profiler_enabled()
    with span("render.chunk"), phase_timer("render", phases):
        torch.ones(4).sum()
    assert entered == [] and phases.counts["render"] == 1
    # the same calls under the profiler open both ranges, nested
    with profile(activities=[ProfilerActivity.CPU]):
        with span("render.chunk"), phase_timer("render", phases):
            torch.ones(4).sum()
    assert entered == ["render.chunk", "render"] and phases.counts["render"] == 2
    assert profiling.span("x") is profiling.span("y")     # the one shared no-op
