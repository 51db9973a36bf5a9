"""Port parity for the point-major MLP kernels of
``neuralsim_tpu_torch.kernels.raymarch``: ``fused_nerf_mlp_widepe``,
``fused_nerf_mlp_pe`` and ``fused_nerf_mlp``, and the encoding they rest on.

Each plain twin is held against the JAX package's Pallas kernel run in
interpret mode (as tests/test_pallas_kernel.py runs it), and each wrapper's
backward (the launch stood in by the twin, on the CPU) against ``jax.vjp``
of the JAX backward's recompute. The CUDA kernels themselves run only on the
card, where chip_smoke.py holds them against these twins.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import box_scene_params as jax_box_scene
from neuralsim_tpu.config import NeRFNetConfig as JNet
from neuralsim_tpu.kernels import raymarch as jmarch
from neuralsim_tpu.models.nerf import init_nerf_params, nerf_apply
from neuralsim_tpu.ops import encoding as jenc
from neuralsim_tpu_torch.config import NeRFNetConfig as TNet
from neuralsim_tpu_torch.kernels import raymarch as tmarch
from neuralsim_tpu_torch.ops import encoding as tenc

torch.set_num_threads(2)

SMALL = dict(netdepth=4, netwidth=32, netdepth_fine=4, netwidth_fine=32, skips=(2,))
JNET, TNET = JNet(**SMALL), TNet(**SMALL)

# float32 on both sides: PE + a 7-matmul chain of width 32
TOL = dict(rtol=1e-4, atol=1e-4)
# gradients pass the 2^9 PE frequency: relative error of the sums times 512
GRAD_TOL = dict(rtol=1e-3, atol=1e-3)


def _params(scene):
    if scene == "box":
        p = jax_box_scene(JNET, jax.random.PRNGKey(0))
    else:
        p = init_nerf_params(jax.random.PRNGKey(0), JNET)
    return {k: np.array(v) for k, v in p.items()}


def _points(rng, m):
    """Points around the box scene's unit cube and unit directions."""
    pts = (0.15 * rng.randn(m, 3)).astype(np.float32)
    dirs = rng.randn(m, 3).astype(np.float32)
    return pts, dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)


def _t(params, *arrays):
    return ({k: torch.from_numpy(v) for k, v in params.items()},
            *[torch.from_numpy(np.array(a, np.float32)) for a in arrays])


@pytest.mark.parametrize("num_freqs", [4, 10])
def test_true_cos_encoding_matches_jax(rng, num_freqs):
    """projection=False: explicit sin and cos on both sides. The projection
    form's sin(y + pi/2) is ~2e-5 off a true cos at 2^9 * 1.5 rad, so the
    atol of 1e-6 tells the two forms apart."""
    x = (3.0 * rng.rand(2000, 3) - 1.5).astype(np.float32)
    want = jenc.positional_encoding(jnp.asarray(x), num_freqs, projection=False)
    got = tenc.positional_encoding(torch.from_numpy(x), num_freqs, projection=False)
    assert got.shape == (2000, 3 + 6 * num_freqs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("scene", ["random", "box"])
@pytest.mark.parametrize("m", [200, 64])
def test_widepe_twin_matches_pallas_interpret(rng, scene, m):
    params = _params(scene)
    pts, dirs = _points(rng, m)
    want = jmarch._fused_forward_widepe(params, pts, dirs, JNET,
                                        compute_dtype=jnp.float32, tile=128,
                                        interpret=True)
    got = tmarch.mlp_widepe_ref(*_t(params, pts, dirs), TNET)
    assert got.shape == (m, 4)
    if scene == "box":
        assert (np.asarray(want)[:, 3] > 0).any()          # points in the box
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("scene", ["random", "box"])
def test_pe_twin_matches_pallas_interpret(rng, scene):
    """The true-cos kernel against its twin, and the twin against the JAX
    MLP on the explicit sin/cos encoding."""
    params = _params(scene)
    pts, dirs = _points(rng, 200)
    want = jmarch._fused_forward_pe(params, pts, dirs, JNET,
                                    compute_dtype=jnp.float32, tile=128,
                                    interpret=True)
    got = tmarch.mlp_pe_ref(*_t(params, pts, dirs), TNET)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    explicit = nerf_apply(params, jenc.positional_encoding(pts, 10, projection=False),
                          jenc.positional_encoding(dirs, 4, projection=False), JNET)
    np.testing.assert_allclose(got.numpy(), np.asarray(explicit), **TOL)


@pytest.mark.parametrize("dtype, tol", [("float32", TOL),
                                        ("bfloat16", dict(rtol=2e-2, atol=2e-2))],
                         ids=["f32", "bf16"])
def test_pe_twin_matches_pallas_interpret_on_a_512_wide_net(rng, dtype, tol):
    """The true-cos kernel on an 8x512 net (the reference's --netwidth 512,
    random weights) against the port's twin, 64 points, in float32 and
    bfloat16."""
    wide = dict(netwidth=512, netwidth_fine=512)
    jnet, tnet = JNet(**wide), TNet(**wide)
    params = {k: np.array(v) for k, v in init_nerf_params(jax.random.PRNGKey(1), jnet).items()}
    pts, dirs = _points(rng, 64)
    want = np.asarray(jmarch._fused_forward_pe(params, pts, dirs, jnet,
                                               compute_dtype=getattr(jnp, dtype), tile=64,
                                               interpret=True))
    got = tmarch.mlp_pe_ref(*_t(params, pts, dirs), tnet, getattr(torch, dtype))
    assert got.shape == (64, 4) and np.abs(want).max() > 0.1      # not a vacuous field
    np.testing.assert_allclose(got.numpy(), want, **tol)


@pytest.mark.parametrize("scene", ["random", "box"])
def test_encoded_twin_matches_pallas_interpret(rng, scene):
    params = _params(scene)
    pts, dirs = _points(rng, 300)
    x_pe = np.asarray(jenc.positional_encoding(pts, 10))
    d_pe = np.asarray(jenc.positional_encoding(dirs, 4))
    want = jmarch._fused_forward(params, x_pe, d_pe, JNET,
                                 compute_dtype=jnp.float32, tile=128, interpret=True)
    got = tmarch.fused_nerf_mlp(*_t(params, x_pe, d_pe), TNET, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_widepe_twin_bf16_rounds_like_pallas(rng):
    """bfloat16: both sides round the encodings, weights and activations
    at the same places; sums differ in order only."""
    params = _params("random")
    pts, dirs = _points(rng, 128)
    want = jmarch._fused_forward_widepe(params, pts, dirs, JNET,
                                        compute_dtype=jnp.bfloat16, tile=128,
                                        interpret=True)
    got = tmarch.mlp_widepe_ref(*_t(params, pts, dirs), TNET, torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2, atol=2e-2)


def _jax_pe_recompute(p, x, d):
    """The recompute of the JAX kernels' _pe_bwd (projection form)."""
    return nerf_apply(p, jenc.positional_encoding(x, 10),
                      jenc.positional_encoding(d, 4), JNET, compute_dtype=jnp.float32)


def _jax_mlp_recompute(p, x, d):
    """The recompute of fused_nerf_mlp's _bwd."""
    return nerf_apply(p, x, d, JNET, compute_dtype=jnp.float32)


@pytest.mark.parametrize("wrapper, jax_ref, encoded", [
    ("fused_nerf_mlp_widepe", _jax_pe_recompute, False),
    ("fused_nerf_mlp_pe", _jax_pe_recompute, False),
    ("fused_nerf_mlp", _jax_mlp_recompute, True),
])
def test_backward_matches_jax_vjp(rng, monkeypatch, wrapper, jax_ref, encoded):
    """Each wrapper's autograd.Function on the kernel route (predicate
    forced, launch stood in by the twin): its gradient is the JAX
    package's backward. fused_nerf_mlp_pe's backward recomputes through
    the projection form, as JAX _pe_bwd does."""
    def fake_launch(kind, params, a, b, net, compute_dtype):
        twin = {"widepe": tmarch.mlp_widepe_ref, "pe": tmarch.mlp_pe_ref,
                "encoded": tmarch.nerf_apply}[kind]
        with torch.no_grad():
            return twin(params, a, b, net, compute_dtype)

    monkeypatch.setattr(tmarch, "uses_kernel", lambda t: True)
    monkeypatch.setattr(tmarch, "_launch_mlp", fake_launch)
    params = _params("box")
    pts, dirs = _points(rng, 40)
    if encoded:
        pts = np.asarray(jenc.positional_encoding(pts, 10))
        dirs = np.asarray(jenc.positional_encoding(dirs, 4))
    ct = rng.randn(40, 4).astype(np.float32)
    _, vjp = jax.vjp(jax_ref, params, pts, dirs)
    want_p, want_x, want_d = vjp(ct)

    tp, tx, td = _t(params, pts, dirs)
    for t in (*tp.values(), tx, td):
        t.requires_grad_(True)
    raw = getattr(tmarch, wrapper)(tp, tx, td, TNET)
    raw.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_x), **GRAD_TOL)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(want_d), **GRAD_TOL)
    for k in tp:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(want_p[k]),
                                   err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("wrapper, twin", [
    ("fused_nerf_mlp_widepe", "mlp_widepe_ref"),
    ("fused_nerf_mlp_pe", "mlp_pe_ref"),
])
def test_cpu_tensors_take_the_twin_without_launching(rng, wrapper, twin):
    params, pts, dirs = _t(_params("random"), *_points(rng, 50))
    fn = getattr(tmarch, wrapper)
    fn.launches = 0
    got = fn(params, pts, dirs, TNET, "float32")
    torch.testing.assert_close(got, getattr(tmarch, twin)(params, pts, dirs, TNET),
                               rtol=0, atol=0)
    assert fn.launches == 0


def test_fused_nerf_mlp_is_the_package_export():
    from neuralsim_tpu_torch import kernels

    assert kernels.fused_nerf_mlp is tmarch.fused_nerf_mlp
    assert tmarch.fused_nerf_mlp.launches == 0
