"""Port parity for the occupancy-culled strips gradient
(``render_grad_psi_strips`` with a grid and ``hit_budget`` < 1) against the
dense gradient of the port and of ``neuralsim_tpu``, on the CPU, float32,
at the fixture size of ``tests/test_render_grad.py``.

The scene is the exact box density of ``bench.box_scene_params`` (zero
outside the box), so rays that miss the occupied box have identically zero
psi-gradient and the culled gradient equals the dense one to float
precision. Every case that claims the selection ran checks it: no overflow
warning, and the count of gather-rendered chunks."""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_tpu.hypergrad import render_grad as jrg
from neuralsim_tpu.sampler.poses import PoseNoise as JNoise
from neuralsim_tpu_torch.hypergrad import render_grad as trg
from neuralsim_tpu_torch.models.convert import params_from_numpy
from neuralsim_tpu_torch.models.nerf import make_sigma_fn
from neuralsim_tpu_torch.ops.occupancy import build_scene_grid, scene_half_extent
from tests.test_torch_render_grad import (
    JNET,
    JRC,
    JSC,
    K,
    N_IMG,
    PSI,
    PSI_G,
    TNET,
    TRC,
    TSC,
    H,
    W,
    assert_close_rel,
    box_models,
    gaussian_noise,
    grad_e,
    jax_strips,
    near_tie_noise,
    port_noise,
)

torch.set_num_threads(2)

LOGGER = "neuralsim_tpu_torch.hypergrad.render_grad"


def make_scene(half, center=(0.0, 0.0, 0.0), seed=20):
    models = box_models(half=half, center=center)
    tmodels = params_from_numpy(models, "cpu")
    grid = build_scene_grid(make_sigma_fn(tmodels["coarse"], TNET),
                            scene_half_extent(TSC.radius, TRC.far, H, W, K), device="cpu")
    return dict(models=models, tmodels=tmodels, grid=grid, ge=grad_e(seed))


@pytest.fixture(scope="module")
def scene():
    """half = 0.12: ~27% of the 12x12 frame's rays hit the box, so
    hit_budget 0.5 takes the selection with room to spare."""
    s = make_scene(0.12)
    s["noise"], s["noise_g"] = near_tie_noise(21), gaussian_noise(25)
    s["want"] = jax_strips(s["models"], PSI, s["noise"], s["ge"])
    s["want_g"] = jax_strips(s["models"], PSI_G, s["noise_g"], s["ge"], psi_mode="gaussian")
    return s


def culled(s, psi=PSI, noise=None, psi_mode="categorical", **kw):
    noise = s["noise"] if noise is None else noise
    return trg.render_grad_psi_strips(
        s["tmodels"], torch.from_numpy(psi), port_noise(noise, psi_mode),
        torch.from_numpy(s["ge"]), H, W, K, TNET, TRC, TSC, psi_mode=psi_mode,
        grid=s["grid"], **kw)


def counting(monkeypatch, *names):
    """Count the calls of the named functions of the port's render_grad."""
    counts = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(trg, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(trg, name, counted)
    return counts


def hits_per_image(s, noise):
    from neuralsim_tpu_torch.ops.occupancy import ray_aabb_bounds

    with torch.no_grad():
        ro, rd = trg._image_rays(torch.from_numpy(PSI), port_noise(noise), H, W, K, TSC,
                                 "categorical")
        return ray_aabb_bounds(s["grid"], ro, rd, TRC.near, TRC.far)[0].sum(-1).tolist()


@pytest.mark.parametrize("image_batch", [1, 3])
def test_culled_matches_dense(scene, caplog, monkeypatch, image_batch):
    """Selection taken (no overflow warning; 3 chunks of 32 rays per image,
    one selection), and the gradient equals JAX's and the port's dense."""
    dense = trg.render_grad_psi_strips(
        scene["tmodels"], torch.from_numpy(PSI), port_noise(scene["noise"]),
        torch.from_numpy(scene["ge"]), H, W, K, TNET, TRC, TSC, strip=32)
    assert max(hits_per_image(scene, scene["noise"])) <= 96
    counts = counting(monkeypatch, "ray_aabb_bounds", "psi_gather_loss",
                      "psi_gather_batch_loss")
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        got = culled(scene, strip=32, hit_budget=0.5, image_batch=image_batch)
    assert not any("falling back" in r.message for r in caplog.records)
    chunks = 3 * (N_IMG if image_batch == 1 else 1)
    assert counts == {"ray_aabb_bounds": 1,
                      "psi_gather_loss": chunks if image_batch == 1 else 0,
                      "psi_gather_batch_loss": chunks if image_batch > 1 else 0}
    assert_close_rel(got, scene["want"])
    assert_close_rel(got, dense.numpy())


def test_culled_matches_jax_culled(scene):
    """The JAX package's culled gradient on the same grid occupancy."""
    from neuralsim_tpu.ops.occupancy import OccupancyGrid

    grid = OccupancyGrid(*(jnp.asarray(t.numpy()) for t in scene["grid"]))
    want = np.asarray(jrg.render_grad_psi_strips(
        scene["models"], jnp.asarray(PSI), JNoise(*map(jnp.asarray, scene["noise"])),
        jnp.asarray(scene["ge"]), H, W, K, JNET, JRC, JSC, strip=32, grid=grid,
        hit_budget=0.5))
    assert_close_rel(culled(scene, strip=32, hit_budget=0.5), want)


def test_culled_overflow_falls_back(scene, caplog):
    """A budget below every image's hit count renders all pixels of every
    image (logged), never a truncated gradient."""
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        got = culled(scene, strip=8, hit_budget=0.01)
    msgs = [r.message for r in caplog.records if "falling back" in r.message]
    assert msgs and f"{N_IMG}/{N_IMG} images" in msgs[0]
    assert_close_rel(got, scene["want"])


@pytest.mark.parametrize("image_batch", [1, 2])
def test_culled_overflow_is_per_image(caplog, monkeypatch, image_batch):
    """An off-center box gives each pose its own hit count; a budget
    between the second-largest and the largest count overflows only the
    largest image, which renders all 144 pixels (18 chunks of 8) while the
    other two keep their selection (k_sel / 8 chunks each)."""
    s = make_scene(0.10, center=(0.25, 0.0, 0.0), seed=26)
    noise = near_tie_noise(19)              # hit counts 17, 18 and 38 of 144
    hits = sorted(hits_per_image(s, noise))
    k_sel = -(-hits[1] // 8) * 8
    assert k_sel < hits[2], f"hit counts {hits}: no budget overflows exactly one image"
    want = jax_strips(s["models"], PSI, noise, s["ge"])

    counts = counting(monkeypatch, "psi_gather_loss", "psi_gather_batch_loss")
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        got = culled(s, noise=noise, strip=8, hit_budget=k_sel / (H * W),
                     image_batch=image_batch)
    msgs = [r.message for r in caplog.records if "falling back" in r.message]
    assert msgs and "1/3 images" in msgs[0]
    if image_batch == 1:
        assert counts == {"psi_gather_loss": 2 * (k_sel // 8) + 18, "psi_gather_batch_loss": 0}
    else:
        assert counts == {"psi_gather_loss": 0, "psi_gather_batch_loss": k_sel // 8 + 18}
    assert_close_rel(got, want)


def test_culled_full_budget_skips_selection(scene, monkeypatch):
    """A budget that rounds up to every pixel skips the selection."""
    counts = counting(monkeypatch, "ray_aabb_bounds")
    got = culled(scene, strip=64, hit_budget=0.99)
    assert counts == {"ray_aabb_bounds": 0}
    assert_close_rel(got, scene["want"])


def test_culled_gaussian_psi(scene, caplog):
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        got = culled(scene, psi=PSI_G, noise=scene["noise_g"], psi_mode="gaussian",
                     strip=48, hit_budget=0.5)
    assert not any("falling back" in r.message for r in caplog.records)
    assert got.shape == (2,)
    assert_close_rel(got, scene["want_g"])
