"""Port parity for the module that holds the march kernel
(``neuralsim_tpu_torch.kernels.raymarch``).

The plain twin ``march_channels_ref`` is held against the JAX package's
Pallas kernel run in interpret mode (as tests/test_pallas_kernel.py runs
it) and against its jnp reference ``_march_channels_ref``. The CUDA kernel
itself runs only on the card, where chip_smoke.py holds it against the twin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import box_scene_params as jax_box_scene
from neuralsim_tpu.config import NeRFNetConfig as JNet
from neuralsim_tpu.kernels import raymarch as jmarch
from neuralsim_tpu.models.nerf import init_nerf_params
from neuralsim_tpu.ops.volume import stratified_z_vals
from neuralsim_tpu_torch.config import NeRFNetConfig as TNet
from neuralsim_tpu_torch.kernels import raymarch as tmarch

torch.set_num_threads(2)

SMALL = dict(netdepth=4, netwidth=32, netdepth_fine=4, netwidth_fine=32, skips=(2,))
JNET, TNET = JNet(**SMALL), TNet(**SMALL)

# float32 on both sides: PE + a 7-matmul chain of width 32
TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(rng, n, s, scene="random"):
    if scene == "box":
        params = jax_box_scene(JNET, jax.random.PRNGKey(0))
    else:
        params = init_nerf_params(jax.random.PRNGKey(0), JNET)
    params = {k: np.array(v) for k, v in params.items()}
    rays_o = (rng.randn(n, 3) * 0.1).astype(np.float32)
    rays_d = rng.randn(n, 3).astype(np.float32)
    vd = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    z = np.array(stratified_z_vals(None, n, s, 0.05, 0.4 if scene == "box" else 2.0,
                                   perturb=False))
    return params, rays_o, rays_d, vd, z


def _t(params, *arrays):
    return ({k: torch.from_numpy(v) for k, v in params.items()},
            *[torch.from_numpy(a) for a in arrays])


@pytest.mark.parametrize("s", [16, 48, 144])
def test_twin_matches_pallas_interpret(rng, s):
    """Raw outputs, not images: a transposed sigma plane would still give
    finite images."""
    n = 20                                   # not a multiple of 8
    params, o, d, vd, z = _inputs(rng, n, s)
    want_sigma, want_rgb = jmarch._fused_march_channels(
        params, o, d, vd, z, JNET, compute_dtype=jnp.float32, target_tile=128,
        interpret=True)
    got_sigma, got_rgb = tmarch.march_channels_ref(*_t(params, o, d, vd, z), TNET)
    assert got_sigma.shape == (n, s) and got_rgb.shape == (3, n, s)
    np.testing.assert_allclose(got_sigma.numpy(), np.asarray(want_sigma), **TOL)
    np.testing.assert_allclose(got_rgb.numpy(), np.asarray(want_rgb), **TOL)


@pytest.mark.parametrize("scene", ["random", "box"])
@pytest.mark.parametrize("s", [16, 48, 144])
def test_twin_matches_jnp_reference(rng, s, scene):
    n = 20
    params, o, d, vd, z = _inputs(rng, n, s, scene)
    want_sigma, want_rgb = jmarch._march_channels_ref(params, o, d, vd, z, JNET)
    got_sigma, got_rgb = tmarch.march_channels_ref(*_t(params, o, d, vd, z), TNET)
    if scene == "box":
        assert (np.asarray(want_sigma) > 0).any()        # rays cross the box
    np.testing.assert_allclose(got_sigma.numpy(), np.asarray(want_sigma), **TOL)
    np.testing.assert_allclose(got_rgb.numpy(), np.asarray(want_rgb), **TOL)


def test_twin_bf16_rounds_like_jax(rng):
    params, o, d, vd, z = _inputs(rng, 20, 16)
    from neuralsim_tpu.models.nerf import nerf_apply
    from neuralsim_tpu.ops.encoding import positional_encoding

    pts = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
    dirs = np.broadcast_to(vd[:, None, :], (20, 16, 3)).reshape(-1, 3)
    want = np.asarray(nerf_apply(params, positional_encoding(pts, 10),
                                 positional_encoding(dirs, 4), JNET,
                                 compute_dtype=jnp.bfloat16)).reshape(20, 16, 4)
    got_sigma, got_rgb = tmarch.march_channels_ref(*_t(params, o, d, vd, z), TNET,
                                                   compute_dtype=torch.bfloat16)
    # same rounding points on both sides; sums differ in order only
    np.testing.assert_allclose(got_sigma.numpy(), want[..., 3], rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got_rgb.numpy(), np.moveaxis(want[..., :3], -1, 0),
                               rtol=2e-2, atol=2e-2)


def test_cpu_tensors_take_the_twin_without_launching(rng):
    params, o, d, vd, z = _inputs(rng, 13, 48)
    tmarch.fused_nerf_march.launches = 0
    args = _t(params, o, d, vd, z)
    got = tmarch.fused_nerf_march(*args, TNET, "float32")
    want = tmarch.march_channels_ref(*args, TNET)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert tmarch.fused_nerf_march.launches == 0


def test_twin_gradient_matches_jax_vjp(rng):
    """The kernel's backward recomputes through the twin; its gradient is
    the JAX package's _march_bwd."""
    params, o, d, vd, z = _inputs(rng, 10, 16, "box")
    ct_sigma = rng.randn(10, 16).astype(np.float32)
    ct_rgb = rng.randn(3, 10, 16).astype(np.float32)
    _, vjp = jax.vjp(lambda p, oo, zz: jmarch._march_channels_ref(p, oo, d, vd, zz, JNET),
                     params, o, z)
    want_p, want_o, want_z = vjp((ct_sigma, ct_rgb))
    tp, to, td, tvd, tz = _t(params, o, d, vd, z)
    for t in (*tp.values(), to, tz):
        t.requires_grad_(True)
    sigma, rgb = tmarch.march_channels_ref(tp, to, td, tvd, tz, TNET)
    torch.autograd.backward((sigma, rgb), (torch.from_numpy(ct_sigma), torch.from_numpy(ct_rgb)))
    # gradients through a 2^9 PE frequency scale: relative tolerance
    np.testing.assert_allclose(to.grad.numpy(), np.asarray(want_o), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(want_z), rtol=1e-3, atol=1e-3)
    for k in ("pts_0_kernel", "alpha_kernel", "views_0_kernel", "rgb_bias"):
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(want_p[k]),
                                   rtol=1e-3, atol=1e-3, err_msg=k)


def test_autograd_function_recomputes_through_twin(rng, monkeypatch):
    """The kernel route's autograd.Function, exercised on the CPU with the
    kernel predicate forced and the launch stood in by the twin: the
    gradients equal plain autograd through the twin."""
    def fake_launch(params, o, d, vd, z, net, compute_dtype):
        with torch.no_grad():
            return tmarch.march_channels_ref(params, o, d, vd, z, net, compute_dtype)

    monkeypatch.setattr(tmarch, "_launch", fake_launch)
    monkeypatch.setattr(tmarch, "uses_kernel", lambda t: True)
    params, o, d, vd, z = _inputs(rng, 9, 16, "box")
    keys = tuple(tmarch.param_keys(SMALL["netdepth"]))
    ct = torch.from_numpy(rng.randn(9, 16).astype(np.float32))

    def grads(fn):
        tp, to, td, tvd, tz = _t(params, o, d, vd, z)
        leaves = [tp[k].requires_grad_(True) for k in keys] + [
            to.requires_grad_(True), tz.requires_grad_(True)]
        sigma, rgb = fn(tp, to, td, tvd, tz)
        ((sigma * ct).sum() + rgb.square().sum()).backward()
        return [leaf.grad for leaf in leaves]

    got = grads(lambda tp, to, td, tvd, tz: tmarch.fused_nerf_march(
        tp, to, td, tvd, tz, TNET))
    want = grads(lambda tp, to, td, tvd, tz: tmarch.march_channels_ref(
        tp, to, td, tvd, tz, TNET))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


def test_param_keys_order():
    assert tmarch.param_keys(2) == [
        "pts_0_kernel", "pts_0_bias", "pts_1_kernel", "pts_1_bias",
        "feature_kernel", "feature_bias", "alpha_kernel", "alpha_bias",
        "views_0_kernel", "views_0_bias", "rgb_kernel", "rgb_bias"]
