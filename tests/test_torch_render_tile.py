"""Port parity for the fused march + compositing kernel
(``neuralsim_tpu_torch.kernels.raymarch.fused_render_tile``) and for the
routing of the renderer's three kernel routes.

The plain twin ``render_tile_ref`` is held against the JAX package's Pallas
kernel ``fused_render_tile`` in interpret mode. The routing test runs on the
CPU with the kernel predicate forced and every launch stood in by its twin,
and counts which kernel each ray chunk calls. The CUDA kernel itself runs
only on the card, where chip_smoke.py holds it against the twin.
"""

import dataclasses

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
from neuralsim_tpu_torch.config import RenderConfig
from neuralsim_tpu_torch.kernels import raymarch as tmarch
from neuralsim_tpu_torch.models.convert import params_from_numpy
from neuralsim_tpu_torch.ops import render as trender

torch.set_num_threads(2)

SMALL = dict(netdepth=4, netwidth=32, netdepth_fine=4, netwidth_fine=32, skips=(2,))
JNET, TNET = JNet(**SMALL), TNet(**SMALL)

# float32 on both sides: PE + a 7-matmul chain of width 32, then the
# compositing sums over S samples
TOL = dict(rtol=1e-4, atol=1e-4)
NAMES = ("rgb", "disp", "acc", "weights", "depth")


def _inputs(rng, n, s, scene):
    """Rays from a sphere of radius 0.3 toward the box at the origin (|d|
    not 1), depths in [0.05, 0.6]: the last samples lie beyond the box."""
    if scene == "box":
        params = jax_box_scene(JNET, jax.random.PRNGKey(0))
    else:
        params = init_nerf_params(jax.random.PRNGKey(0), JNET)
    params = {k: np.array(v) for k, v in params.items()}
    rays_o = rng.randn(n, 3)
    rays_o = (0.3 * rays_o / np.linalg.norm(rays_o, axis=-1, keepdims=True))
    rays_d = (-rays_o / 0.3 * 1.3 + 0.05 * rng.randn(n, 3)).astype(np.float32)
    vd = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    z = np.array(stratified_z_vals(None, n, s, 0.05, 0.6, perturb=False))
    return params, rays_o.astype(np.float32), rays_d, vd, z


def _t(params, *arrays):
    return ({k: torch.from_numpy(v) for k, v in params.items()},
            *[torch.from_numpy(np.array(a, np.float32)) for a in arrays])


@pytest.mark.parametrize("white_bkgd", [False, True])
@pytest.mark.parametrize("n, s", [(20, 16), (13, 48)])
def test_twin_matches_pallas_interpret(rng, n, s, white_bkgd):
    """Box scene, ragged N (not a multiple of the JAX kernel's 8-ray step):
    all five maps, weights included."""
    params, o, d, vd, z = _inputs(rng, n, s, "box")
    want = jmarch.fused_render_tile(params, o, d, vd, z, JNET, white_bkgd=white_bkgd,
                                    compute_dtype=jnp.float32, target_tile=128,
                                    interpret=True)
    got = tmarch.render_tile_ref(*_t(params, o, d, vd, z), TNET, white_bkgd=white_bkgd)
    assert float(np.asarray(want[2]).max()) > 0.5              # rays hit the box
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == tuple(w.shape), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)


@pytest.mark.parametrize("white_bkgd", [False, True])
@pytest.mark.parametrize("n, s", [(20, 16), (13, 48)])
def test_twin_matches_jax_reference_on_random_field(rng, n, s, white_bkgd):
    """A random-init field has density at the last sample of most rays.
    There the JAX kernel in interpret mode returns NaN: XLA:CPU folds
    1 - alpha + 1e-10 to 0 when alpha = 1, and log(0) = -inf meets a zero
    of its triangular product matrix. So the twin is held against the JAX
    reference the TPU gate holds the kernel to (query_points +
    raw2outputs, tests_tpu/test_kernels_tpu.py:185-205)."""
    from neuralsim_tpu.models.nerf import query_points
    from neuralsim_tpu.ops.volume import raw2outputs

    params, o, d, vd, z = _inputs(rng, n, s, "random")
    raw = query_points(params, o[:, None, :] + d[:, None, :] * z[..., None], vd,
                       JNET, jnp.float32)
    want = raw2outputs(raw, z, d, white_bkgd=white_bkgd)
    got = tmarch.render_tile_ref(*_t(params, o, d, vd, z), TNET, white_bkgd=white_bkgd)
    assert float(np.asarray(want[2]).max()) > 0.05             # not vacuous
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)


def test_fast_epilogue_bf16_matches_pallas_interpret(rng):
    """fast_epilogue rounds each ReLU layer's product and bias to bf16
    before the add; the twin rounds where the JAX kernel does."""
    params, o, d, vd, z = _inputs(rng, 16, 16, "box")
    want = jmarch.fused_render_tile(params, o, d, vd, z, JNET,
                                    compute_dtype=jnp.bfloat16, target_tile=128,
                                    fast_epilogue=True, interpret=True)
    got = tmarch.render_tile_ref(*_t(params, o, d, vd, z), TNET,
                                 compute_dtype=torch.bfloat16, fast_epilogue=True)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-2, atol=2e-2,
                                   err_msg=name)


def test_fast_epilogue_changes_nothing_in_float32(rng):
    args = _t(*_inputs(rng, 9, 16, "random"))
    plain = tmarch.render_tile_ref(*args, TNET)
    fast = tmarch.render_tile_ref(*args, TNET, fast_epilogue=True)
    for g, w in zip(fast, plain):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_cpu_tensors_take_the_twin_without_launching(rng):
    args = _t(*_inputs(rng, 9, 16, "box"))
    tmarch.fused_render_tile.launches = 0
    got = tmarch.fused_render_tile(*args, TNET, white_bkgd=True, compute_dtype=torch.float32)
    want = tmarch.render_tile_ref(*args, TNET, white_bkgd=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert tmarch.fused_render_tile.launches == 0


@pytest.fixture
def kernel_route(monkeypatch):
    """Force the kernel predicate and stand each launch in by its twin;
    returns the list of (kernel, rays) calls."""
    calls = []

    def march(params, o, d, vd, z, net, compute_dtype):
        calls.append(("fused_nerf_march", z.shape[0]))
        with torch.no_grad():
            return tmarch.march_channels_ref(params, o, d, vd, z, net, compute_dtype)

    def mlp(kind, params, a, b, net, compute_dtype):
        calls.append((f"mlp_{kind}", a.shape[0]))
        with torch.no_grad():
            return tmarch.mlp_widepe_ref(params, a, b, net, compute_dtype)

    def render_tile(params, o, d, vd, z, net, white_bkgd, compute_dtype, fast_epilogue):
        calls.append(("fused_render_tile", z.shape[0]))
        return tmarch.render_tile_ref(params, o, d, vd, z, net, white_bkgd,
                                      compute_dtype, fast_epilogue)

    monkeypatch.setattr(tmarch, "uses_kernel", lambda t: True)
    monkeypatch.setattr(tmarch, "_launch", march)
    monkeypatch.setattr(tmarch, "_launch_mlp", mlp)
    monkeypatch.setattr(tmarch, "_launch_render_tile", render_tile)
    return calls


@pytest.mark.parametrize("override, kernel", [
    (dict(), "fused_nerf_march"),
    (dict(fuse_pointgen=False), "mlp_widepe"),
    (dict(fuse_compositing=True), "fused_render_tile"),
    (dict(fuse_compositing=True, fuse_pointgen=False), "fused_render_tile"),
    (dict(fuse_compositing=True, raw_noise_std=1.0), "fused_nerf_march"),
    (dict(fuse_compositing=True, raw_noise_std=1.0, fuse_pointgen=False), "mlp_widepe"),
], ids=["march", "widepe", "render_tile", "render_tile_over_pointgen",
        "noise_falls_through_to_march", "noise_falls_through_to_widepe"])
def test_kernel_routes(rng, kernel_route, override, kernel):
    """Each chunk's coarse and fine march call exactly one kernel, the one
    the config picks (fuse_compositing needs raw_noise_std == 0 and takes
    precedence over fuse_pointgen), and the render equals the plain
    route's on the same draws."""
    params, *_ = _inputs(rng, 1, 1, "box")
    models = params_from_numpy({"coarse": params, "fine": params}, "cpu")
    n, chunk = 50, 16                                   # 4 chunks, one ragged
    rays_o = torch.from_numpy((rng.randn(n, 3) * 0.02 + [0, 0, 0.3]).astype(np.float32))
    rays_d = torch.from_numpy((rng.randn(n, 3) * 0.05 + [0, 0, -1.0]).astype(np.float32))
    rc = RenderConfig(n_samples=16, n_importance=16, ray_chunk=chunk, perturb=False,
                      near=0.05, far=0.6, **override)
    got = trender.render_ray_batch(models, rays_o, rays_d, TNET, rc,
                                   torch.Generator().manual_seed(3))
    n_chunks = -(-n // chunk)
    assert [name for name, _ in kernel_route] == [kernel] * 2 * n_chunks
    if kernel != "mlp_widepe":                          # it counts points
        assert [m for _, m in kernel_route] == [
            min(chunk, n - start) for start in range(0, n, chunk) for _ in range(2)]

    plain = dataclasses.replace(rc, use_pallas=False)
    want = trender.render_ray_batch(models, rays_o, rays_d, TNET, plain,
                                    torch.Generator().manual_seed(3))
    assert float(want["acc_map"].max()) > 0.5                # rays hit the box
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-5, msg=k)


def test_render_tile_kernel_route_refuses_gradients(rng, kernel_route):
    """On the card the render tile is forward only: a grad-requiring input
    raises instead of returning tensors without a grad_fn."""
    params, o, d, vd, z = _t(*_inputs(rng, 8, 16, "box"))
    params["pts_0_kernel"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        tmarch.fused_render_tile(params, o, d, vd, z, TNET, compute_dtype=torch.float32)
    assert kernel_route == []
    with torch.no_grad():
        tmarch.fused_render_tile(params, o, d, vd, z, TNET, compute_dtype=torch.float32)
    z.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        trender._march(params, o, d, vd, z, TNET,
                       RenderConfig(fuse_compositing=True), torch.float32)
    assert kernel_route == [("fused_render_tile", 8)]
