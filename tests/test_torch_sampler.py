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


@pytest.mark.parametrize("mean,std", [(157.5, 30.0), (-30.0, 40.0), (350.0, -25.0),
                                      (10.0, 60.0)])
def test_gaussian_poses_match_jax(rng, mean, std):
    """poses_from_noise_gaussian on the same eps and theta: phi = mean +
    |std| * eps wraps into [0, 360) as jnp.mod does (a floor-mod: -40
    becomes 320, not -40 as torch.fmod would leave it)."""
    eps = rng.randn(16).astype(np.float32)
    eps[:2] = (-1.5, 1.5)          # with mean -30 / 350: below 0 and above 360
    theta = (85 + 10 * rng.rand(16)).astype(np.float32)
    psi = np.array([mean, std], np.float32)
    want = jposes.poses_from_noise_gaussian(jnp.asarray(psi),
                                            jposes.GaussianPoseNoise(eps, theta), JSC)
    got = tposes.poses_from_noise_gaussian(
        torch.from_numpy(psi), tposes.GaussianPoseNoise(*map(torch.from_numpy, (eps, theta))),
        TSC)
    assert got.shape == (16, 4, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    phi = torch.remainder(torch.tensor(mean) + abs(std) * torch.from_numpy(eps), 360.0)
    np.testing.assert_allclose(phi.numpy(), np.mod(np.float32(mean) + np.float32(abs(std)) * eps,
                                                   np.float32(360.0)), rtol=0, atol=1e-4)
    assert (phi >= 0).all() and (phi < 360).all()


@pytest.mark.parametrize("mean,std", [(157.5, 30.0), (-30.0, 40.0), (20.0, -15.0)])
def test_gaussian_pose_gradients_match_jax(rng, mean, std):
    """torch.autograd gradients of a pose functional w.r.t. mean and std
    equal jax.grad's on the same eps (through the floor-mod and |std|)."""
    import jax

    eps = rng.randn(16).astype(np.float32)
    theta = (85 + 10 * rng.rand(16)).astype(np.float32)
    w = rng.randn(16, 3, 4).astype(np.float32)
    psi = np.array([mean, std], np.float32)

    def jf(p):
        ps = jposes.poses_from_noise_gaussian(p, jposes.GaussianPoseNoise(eps, theta), JSC)
        return jnp.sum(ps[:, :3, :] * w)

    want = np.asarray(jax.grad(jf)(jnp.asarray(psi)))
    p = torch.from_numpy(psi).requires_grad_(True)
    ps = tposes.poses_from_noise_gaussian(
        p, tposes.GaussianPoseNoise(*map(torch.from_numpy, (eps, theta))), TSC)
    got = torch.autograd.grad(torch.sum(ps[:, :3, :] * torch.from_numpy(w)), p)[0]
    assert np.abs(want).min() > 1e-3                  # both components live
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_draw_pose_noise_gaussian_shapes_ranges_and_replay():
    a = tposes.draw_pose_noise_gaussian(torch.Generator().manual_seed(3), TSC, num_k=4096)
    b = tposes.draw_pose_noise_gaussian(torch.Generator().manual_seed(3), TSC, num_k=4096)
    assert a.eps.shape == (4096,) and a.theta.shape == (4096,)
    assert a.eps.dtype == torch.float32 and torch.isfinite(a.eps).all()
    assert abs(float(a.eps.mean())) < 0.1 and abs(float(a.eps.std()) - 1.0) < 0.1
    assert ((a.theta >= 85) & (a.theta <= 95)).all()
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert tposes.draw_pose_noise_gaussian(None, TSC).eps.shape == (TSC.n_samples_k,)


def test_sample_poses_and_sample_poses_gaussian():
    """sample_poses replays through poses_from_noise; sample_poses_gaussian
    wraps phi into [0, 360) for a mean far below 0 and equals the pose of
    its own draws."""
    probs = tposes.psi_to_probs(psi_init("5"), TSC)
    poses, noise = tposes.sample_poses(torch.Generator().manual_seed(5), probs, TSC, num_k=6)
    assert poses.shape == (6, 4, 4)
    torch.testing.assert_close(poses, tposes.poses_from_noise(probs, noise, TSC), rtol=0, atol=0)

    poses_g, phis = tposes.sample_poses_gaussian(torch.Generator().manual_seed(6), -200.0,
                                                 30.0, TSC, num_k=64, device="cpu")
    assert poses_g.shape == (64, 4, 4) and phis.shape == (64,)
    assert (phis >= 0).all() and (phis < 360).all()
    g = torch.Generator().manual_seed(6)
    eps = torch.randn((64,), generator=g)
    torch.testing.assert_close(phis, torch.remainder(-200.0 + 30.0 * eps, 360.0))
    theta = TSC.theta_low_deg + (TSC.theta_high_deg - TSC.theta_low_deg) * torch.rand(
        (64,), generator=g)
    torch.testing.assert_close(poses_g, tposes.pose_spherical(theta, phis - 180.0, TSC.radius))


def test_sample_poses_follow_the_inputs_device():
    """With no device given, sample_poses builds its poses on probs' device
    and sample_poses_gaussian on a tensor mean's ("meta" here, a device
    other than the default); a float mean means cuda, and with no GPU that
    raises rather than falling back to the CPU."""
    probs = tposes.psi_to_probs(psi_init("5"), TSC).to("meta")
    poses, noise = tposes.sample_poses(torch.Generator().manual_seed(5), probs, TSC, num_k=3)
    assert poses.device.type == "meta" and noise.gumbel.device.type == "meta"
    poses_g, phis = tposes.sample_poses_gaussian(
        torch.Generator().manual_seed(6), torch.tensor(30.0, device="meta"), 20.0, TSC, num_k=3)
    assert poses_g.device.type == "meta" and phis.device.type == "meta"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tposes.sample_poses_gaussian(None, 30.0, 20.0, TSC, num_k=3)
