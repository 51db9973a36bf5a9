"""Port parity for ``NeuralSimRenderer`` with ``RenderConfig.production_mode()``
against the JAX renderer on the CPU: the grid built once per scene, the
calibrated budget (below 1), the culled single-pass render, and its route
through the march kernel (stood in by its twin).

The two sides draw their calibration poses from their own streams (JAX
threefry, torch Philox), so the render comparison sets the port's budget to
the JAX renderer's; ``tests/test_torch_occupancy.py`` holds
``calibrate_hit_budget`` itself to the JAX package on identical poses.
"""

import dataclasses

import numpy as np
import pytest
import torch

from neuralsim_tpu import config as jcfg
from neuralsim_tpu.pipeline import NeuralSimRenderer as JaxRenderer
from neuralsim_tpu.sampler.poses import PoseNoise as JaxNoise
from neuralsim_tpu_torch import config as tcfg
from neuralsim_tpu_torch.models.nerf import init_nerf_pipeline_params
from neuralsim_tpu_torch.pipeline import NeuralSimRenderer
from neuralsim_tpu_torch.sampler.poses import PoseNoise
from tests.test_torch_production import (
    CAMERA,
    H,
    JNET,
    RENDER,
    TNET,
    W,
    _assert_maps_close,
    _models,
)
from tests.test_torch_render_tile import kernel_route  # noqa: F401  (a fixture)

torch.set_num_threads(2)


def _noise(rng, k=2):
    g = (-np.log(-np.log(rng.rand(k, 8)))).astype(np.float32)
    u = rng.rand(k).astype(np.float32)
    th = (85 + 10 * rng.rand(k)).astype(np.float32)
    return g, u, th


def _configs(**render):
    render = {**RENDER, **render}
    j = jcfg.NeuralSimConfig(net=JNET, render=jcfg.RenderConfig(**render).production_mode(),
                             camera=jcfg.CameraConfig(**CAMERA))
    t = tcfg.NeuralSimConfig(net=TNET, render=tcfg.RenderConfig(**render).production_mode(),
                             camera=tcfg.CameraConfig(**CAMERA))
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_renderer_production_matches_jax(rng, dtype):
    """NeuralSimRenderer(production_mode()) against the JAX renderer: the
    same grid, a budget below 1, the same render once the budget is the
    JAX renderer's (calibration poses come from each side's own stream),
    and a render that differs from the exact one."""
    jc, tc = _configs(compute_dtype=dtype)
    models = _models("box")
    ref = JaxRenderer(jc, models=models)
    port = NeuralSimRenderer(tc, models=models, device="cpu")
    for g, w in zip(port.grid, ref.grid):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 0.25 <= port.rc.hit_budget < 1.0 and 0.25 <= ref.rc.hit_budget < 1.0
    port.rc = dataclasses.replace(port.rc, hit_budget=ref.rc.hit_budget)

    g, u, th = _noise(rng)
    psi = np.full(8, 0.125, np.float32)
    want = ref._render_fn(psi, JaxNoise(g, u, th))
    got = port._render_impl(torch.from_numpy(psi), PoseNoise(*map(torch.from_numpy, (g, u, th))))
    assert float(np.asarray(want[2]).max()) > 0.5                  # the box is hit
    _assert_maps_close(dict(zip(("rgb_map", "disp_map", "acc_map"), got)),
                       dict(zip(("rgb_map", "disp_map", "acc_map"), want)))
    exact = NeuralSimRenderer(tc.replace(render=tcfg.RenderConfig(
        **RENDER, compute_dtype=dtype)), models=models, device="cpu")
    rgb_exact = exact._render_impl(torch.from_numpy(psi),
                                   PoseNoise(*map(torch.from_numpy, (g, u, th))))[0]
    assert exact.grid is None and exact.rc.hit_budget == 1.0
    assert float((got[0] - rgb_exact).abs().max()) > 1e-3


def test_renderer_production_routes_through_the_march_kernel(rng, kernel_route):
    """K=2 production images: the single-pass march runs once per chunk of
    routed rays and no other kernel runs."""
    _, tc = _configs(ray_chunk=64)
    port = NeuralSimRenderer(tc, models=_models("box"), device="cpu")
    assert not kernel_route                   # grid and calibration launch nothing
    g, u, th = _noise(rng)
    port._render_impl(torch.full((8,), 0.125), PoseNoise(*map(torch.from_numpy, (g, u, th))))
    n = 2 * H * W
    k_sel = max(8, min(n, -(-int(round(n * port.rc.hit_budget)) // 8) * 8))
    assert [name for name, _ in kernel_route] == ["fused_nerf_march"] * -(-k_sel // 64)


def test_calibration_draws_from_its_own_generator():
    """Calibration poses come from a generator seeded with cfg.seed: the
    caller's generator advances by the model init only, and torch's global
    generator not at all."""
    _, tc = _configs()
    g_prod, g_init = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    before = torch.get_rng_state()
    prod = NeuralSimRenderer(tc, generator=g_prod, device="cpu")
    init_nerf_pipeline_params(TNET, tc.render.n_importance, g_init)
    assert prod.grid is not None
    assert torch.equal(g_prod.get_state(), g_init.get_state())
    assert torch.equal(torch.get_rng_state(), before)


@pytest.mark.parametrize("bbox_half", [None, 0.3])
def test_occupancy_grid_matches_jax(bbox_half):
    jc, tc = _configs()
    models = _models("box")
    jexact = jc.replace(render=jcfg.RenderConfig(**RENDER))
    texact = tc.replace(render=tcfg.RenderConfig(**RENDER))
    want = JaxRenderer(jexact, models=models).occupancy_grid(resolution=16, bbox_half=bbox_half)
    got = NeuralSimRenderer(texact, models=models, device="cpu").occupancy_grid(
        resolution=16, bbox_half=bbox_half)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert float(got.occ.sum()) > 0
