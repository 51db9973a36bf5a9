"""Port parity: rays, positional encoding and the volume-rendering
primitives of ``neuralsim_tpu_torch.ops`` against ``neuralsim_tpu.ops``.

Every input is made with numpy from a fixed seed (random draws too) and
handed to both sides; comparisons are float32 on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_tpu.ops import encoding as jenc
from neuralsim_tpu.ops import rays as jrays
from neuralsim_tpu.ops import volume as jvol
from neuralsim_tpu_torch.ops import encoding as tenc
from neuralsim_tpu_torch.ops import rays as trays
from neuralsim_tpu_torch.ops import volume as tvol

torch.set_num_threads(2)

# float32 on both sides; a handful of float32 ops per value
TOL = dict(rtol=1e-4, atol=1e-4)
# sample_pdf depths: a searchsorted + one linear interpolation
PDF_TOL = dict(rtol=1e-5, atol=1e-5)

K = np.array([[80.0, 0.0, 7.3], [0.0, 81.0, 8.6], [0.0, 0.0, 1.0]], np.float32)


def _c2w(rng, k=None):
    shape = (3, 3) if k is None else (k, 3, 3)
    q, _ = np.linalg.qr(rng.randn(*shape))
    c2w = np.zeros(shape[:-2] + (4, 4), np.float32)
    c2w[..., :3, :3] = q
    c2w[..., :3, 3] = rng.randn(*shape[:-2], 3)
    c2w[..., 3, 3] = 1.0
    return c2w


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def test_get_rays_matches_jax(rng):
    c2w = _c2w(rng)
    want_o, want_d = jrays.get_rays(7, 9, K, c2w)
    got_o, got_d = trays.get_rays(7, 9, K, torch.from_numpy(c2w))
    assert got_o.shape == (7, 9, 3)
    _close(got_o, want_o)
    _close(got_d, want_d)


def test_get_rays_batched_matches_per_pose(rng):
    c2ws = _c2w(rng, k=3)
    got_o, got_d = trays.get_rays(5, 6, K, torch.from_numpy(c2ws))
    want_o, want_d = jax.vmap(lambda m: jrays.get_rays(5, 6, K, m))(c2ws)
    assert got_d.shape == (3, 5, 6, 3)
    _close(got_o, want_o)
    _close(got_d, want_d)


def test_ndc_rays_matches_jax(rng):
    o = rng.randn(30, 3).astype(np.float32)
    o[:, 2] = -np.abs(o[:, 2]) - 1.0
    d = rng.randn(30, 3).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    want = jrays.ndc_rays(16, 12, 20.0, 1.0, o, d)
    got = trays.ndc_rays(16, 12, 20.0, 1.0, torch.from_numpy(o), torch.from_numpy(d))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("num_freqs", [4, 10])
def test_positional_encoding_matches_jax(rng, num_freqs):
    # coordinates up to 1.5: the top frequency reaches 2^9 * 1.5 rad, the
    # range a pipeline point covers
    x = (3.0 * rng.rand(200, 3) - 1.5).astype(np.float32)
    want = jenc.positional_encoding(jnp.asarray(x), num_freqs)
    got = tenc.positional_encoding(torch.from_numpy(x), num_freqs)
    assert got.shape == (200, 3 + 6 * num_freqs)
    # both sides take sin of the same float32 arguments; the sin
    # implementations differ by a few ulp
    _close(got, want, dict(rtol=1e-5, atol=1e-5))


def test_linspace_is_jax_bitwise():
    for n in (1, 2, 16, 64, 129):
        np.testing.assert_array_equal(tvol.linspace01(n).numpy(),
                                      np.asarray(jnp.linspace(0.0, 1.0, n)))


@pytest.mark.parametrize("lindisp", [False, True])
def test_stratified_z_vals_deterministic(lindisp):
    want = jvol.stratified_z_vals(None, 5, 64, 0.31, 1.93, perturb=False,
                                  lindisp=lindisp)
    got = tvol.stratified_z_vals(5, 64, 0.31, 1.93, perturb=False, lindisp=lindisp)
    _close(got, want, dict(rtol=1e-6, atol=1e-6))


def test_stratified_z_vals_perturbed_same_u(rng):
    key = jax.random.PRNGKey(3)
    n, s = 6, 32
    near = (0.3 + 0.1 * rng.rand(n)).astype(np.float32)
    far = (1.8 + 0.1 * rng.rand(n)).astype(np.float32)
    want = jvol.stratified_z_vals(key, n, s, near, far, perturb=True)
    # the draws jvol makes inside: jax.random.uniform(key, [n, s])
    u = np.array(jax.random.uniform(key, (n, s)))
    got = tvol.stratified_z_vals(n, s, torch.from_numpy(near), torch.from_numpy(far),
                                 perturb=True, u=torch.from_numpy(u))
    _close(got, want)


def _raw_inputs(rng, n=24, s=32):
    raw = rng.randn(n, s, 4).astype(np.float32)
    z = np.sort(0.3 + 1.6 * rng.rand(n, s), axis=-1).astype(np.float32)
    rays_d = rng.randn(n, 3).astype(np.float32)
    return raw, z, rays_d


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_raw2outputs_matches_jax(rng, white_bkgd):
    raw, z, rays_d = _raw_inputs(rng)
    want = jvol.raw2outputs(raw, z, rays_d, white_bkgd=white_bkgd)
    got = tvol.raw2outputs(torch.from_numpy(raw), torch.from_numpy(z),
                           torch.from_numpy(rays_d), white_bkgd=white_bkgd)
    for g, w in zip(got, want):
        _close(g, w)


def test_raw2outputs_density_noise_same_draws(rng):
    raw, z, rays_d = _raw_inputs(rng)
    key = jax.random.PRNGKey(5)
    want = jvol.raw2outputs(raw, z, rays_d, key=key, raw_noise_std=0.7)
    noise = np.array(jax.random.normal(key, raw.shape[:-1]))
    got = tvol.raw2outputs(torch.from_numpy(raw), torch.from_numpy(z),
                           torch.from_numpy(rays_d), raw_noise_std=0.7,
                           noise=torch.from_numpy(noise))
    for g, w in zip(got, want):
        _close(g, w)


def test_raw2outputs_channels_matches_jax(rng):
    raw, z, rays_d = _raw_inputs(rng)
    sigma = np.ascontiguousarray(raw[..., 3])
    rgb3 = np.ascontiguousarray(np.moveaxis(raw[..., :3], -1, 0))
    for kw in ({}, {"white_bkgd": True}):
        want = jvol.raw2outputs_channels(sigma, rgb3, z, rays_d, **kw)
        got = tvol.raw2outputs_channels(torch.from_numpy(sigma), torch.from_numpy(rgb3),
                                        torch.from_numpy(z), torch.from_numpy(rays_d), **kw)
        for g, w in zip(got, want):
            _close(g, w)


def test_raw2outputs_disparity_finite_for_empty_rays(rng):
    _, z, rays_d = _raw_inputs(rng, n=4)
    raw = np.full((4, 32, 4), -5.0, np.float32)     # relu(sigma) == 0
    _, disp, acc, _, _ = tvol.raw2outputs(torch.from_numpy(raw), torch.from_numpy(z),
                                          torch.from_numpy(rays_d))
    assert torch.all(acc == 0) and torch.all(torch.isfinite(disp))


@pytest.mark.parametrize("b", [5, 16, 62, 190, 300])
def test_blocked_sums_are_jax_bitwise(rng, b):
    x = rng.rand(50, b).astype(np.float32) ** 4 + 1e-5
    np.testing.assert_array_equal(tvol.sum_blocked(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.sum(jnp.asarray(x), -1)))
    x /= x.sum(-1, keepdims=True)
    np.testing.assert_array_equal(tvol.cumsum_blocked(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.cumsum(jnp.asarray(x), -1)))


def _pdf_inputs(rng, n=40, b=63):
    bins = np.sort(0.3 + 1.6 * rng.rand(n, b), axis=-1).astype(np.float32)
    weights = rng.rand(n, b - 1).astype(np.float32) ** 4
    weights[:5] = 0.0              # empty rays
    weights[5:15, 30:] = 0.0       # empty tails: the denom < 1e-5 guard engages
    return bins, weights


def test_sample_pdf_det_matches_jax(rng):
    bins, weights = _pdf_inputs(rng)
    want = jvol.sample_pdf(None, bins, weights, 128, det=True)
    got = tvol.sample_pdf(torch.from_numpy(bins), torch.from_numpy(weights), 128, det=True)
    assert got.shape == (40, 128)
    _close(got, want, PDF_TOL)


def test_sample_pdf_random_same_u(rng):
    bins, weights = _pdf_inputs(rng)
    key = jax.random.PRNGKey(11)
    want = jvol.sample_pdf(key, bins, weights, 64, det=False)
    u = np.array(jax.random.uniform(key, (40, 64)))
    got = tvol.sample_pdf(torch.from_numpy(bins), torch.from_numpy(weights), 64,
                          det=False, u=torch.from_numpy(u))
    _close(got, want, PDF_TOL)
