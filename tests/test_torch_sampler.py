"""Port parity: psi presets, the Gumbel-softmax pose sampler and the
spherical poses of ``neuralsim_tpu_torch`` against ``neuralsim_tpu``, fed
the same numpy ``PoseNoise``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_tpu.bilevel.psi_init import psi_init as jpsi_init
from neuralsim_tpu.config import SamplerConfig as JSampler
from neuralsim_tpu.sampler import poses as jposes
from neuralsim_tpu_torch.bilevel.psi_init import psi_init
from neuralsim_tpu_torch.config import SamplerConfig
from neuralsim_tpu_torch.sampler import poses as tposes

torch.set_num_threads(2)

JSC, TSC = JSampler(), SamplerConfig()
# float32 trig and 4x4 products on both sides
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["uniform", "two_13", "two_27", "three_123",
                                  "three_147", "1", "5", "8"])
def test_psi_init_presets(mode):
    np.testing.assert_array_equal(psi_init(mode).numpy(), np.asarray(jpsi_init(mode)))


def test_psi_init_rejects_bad_index():
    with pytest.raises(ValueError):
        psi_init("9")


def test_psi_to_probs_and_explore_mix(rng):
    psi = rng.randn(8).astype(np.float32)
    np.testing.assert_allclose(tposes.psi_to_probs(torch.from_numpy(psi), TSC).numpy(),
                               np.asarray(jposes.psi_to_probs(psi, JSC)), **TOL)
    for eps in (0.0, 0.1, 0.5):
        np.testing.assert_allclose(
            tposes.explore_mix_psi(torch.from_numpy(psi), TSC, eps).numpy(),
            np.asarray(jposes.explore_mix_psi(psi, JSC, eps)), **TOL)


def test_bin_centers():
    np.testing.assert_array_equal(tposes.bin_centers(TSC).numpy(),
                                  np.asarray(jposes.bin_centers(JSC), np.float32))


def test_pose_spherical_scalar_and_batched(rng):
    theta = (85 + 10 * rng.rand(5)).astype(np.float32)
    phi = (360 * rng.rand(5) - 180).astype(np.float32)
    np.testing.assert_allclose(
        tposes.pose_spherical(torch.from_numpy(theta), torch.from_numpy(phi), 1.01).numpy(),
        np.asarray(jposes.pose_spherical(theta, phi, 1.01)), **TOL)
    np.testing.assert_allclose(
        tposes.pose_spherical(90.0, -30.0, 1.01).numpy(),
        np.asarray(jposes.pose_spherical(90.0, -30.0, 1.01)), **TOL)


def _noise(rng, k=6):
    u = rng.rand(k, 8).astype(np.float32)
    return (-np.log(-np.log(u))).astype(np.float32), rng.rand(k).astype(np.float32), \
        (85 + 10 * rng.rand(k)).astype(np.float32)


@pytest.mark.parametrize("psi_mode", ["5", "uniform", "saturated"])
def test_poses_from_noise_matches_jax(rng, psi_mode):
    g, u, th = _noise(rng)
    if psi_mode == "saturated":
        # probs underflow to 0 in float32: the 1e-30 log clamp keeps them finite
        psi = np.array([40.0, -40, -40, -40, -40, -40, -40, -40], np.float32)
    else:
        psi = np.array(jpsi_init(psi_mode))
    want = jposes.poses_from_noise(jposes.psi_to_probs(psi, JSC),
                                   jposes.PoseNoise(g, u, th), JSC)
    got = tposes.poses_from_noise(tposes.psi_to_probs(torch.from_numpy(psi), TSC),
                                  tposes.PoseNoise(*map(torch.from_numpy, (g, u, th))), TSC)
    assert got.shape == (6, 4, 4) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_gumbel_softmax_expectation(rng):
    from neuralsim_tpu.sampler.gumbel import gumbel_softmax_expectation as jgse
    from neuralsim_tpu_torch.sampler.gumbel import gumbel_softmax_expectation

    logits = rng.randn(1, 8).astype(np.float32)
    noise = rng.randn(4, 8).astype(np.float32)
    values = np.arange(8, dtype=np.float32) * 45 + 22.5
    np.testing.assert_allclose(
        gumbel_softmax_expectation(*map(torch.from_numpy, (logits, values, noise)), 0.1).numpy(),
        np.asarray(jgse(jnp.asarray(logits), values, noise, 0.1)), rtol=1e-5, atol=1e-3)


def test_draw_pose_noise_ranges_and_replay():
    a = tposes.draw_pose_noise(torch.Generator().manual_seed(3), TSC, num_k=64)
    b = tposes.draw_pose_noise(torch.Generator().manual_seed(3), TSC, num_k=64)
    assert a.gumbel.shape == (64, 8) and a.uniform.shape == (64,)
    assert torch.isfinite(a.gumbel).all()
    assert ((a.uniform >= 0) & (a.uniform < 1)).all()
    assert ((a.theta >= 85) & (a.theta <= 95)).all()
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert tposes.draw_pose_noise(None, TSC).gumbel.shape == (TSC.n_samples_k, 8)
