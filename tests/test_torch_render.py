"""Port parity for the slice as a whole: ``render_ray_batch`` and
``NeuralSimRenderer`` of ``neuralsim_tpu_torch`` against ``neuralsim_tpu``
in test mode, on the CPU, with the same numpy weights and the same numpy
``PoseNoise`` on both sides."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from bench import box_scene_params as jax_box_scene
from neuralsim_tpu import config as jcfg
from neuralsim_tpu.models.nerf import init_nerf_pipeline_params
from neuralsim_tpu.ops.render import render_ray_batch as jax_render_ray_batch
from neuralsim_tpu.pipeline import NeuralSimRenderer as JaxRenderer
from neuralsim_tpu.sampler.poses import PoseNoise as JaxNoise
from neuralsim_tpu_torch import config as tcfg
from neuralsim_tpu_torch.models.convert import params_from_numpy
from neuralsim_tpu_torch.ops import render as trender
from neuralsim_tpu_torch.pipeline import NeuralSimRenderer
from neuralsim_tpu_torch.sampler.poses import PoseNoise, draw_pose_noise
from tests.test_torch_render_tile import kernel_route  # noqa: F401  (a fixture)

torch.set_num_threads(2)

SMALL = dict(netdepth=4, netwidth=32, netdepth_fine=4, netwidth_fine=32, skips=(2,))
# a 16x16 camera looking at the origin: the box scene fills part of it
CAMERA = dict(height=16, width=16, focal=80.0, fx=80.0, fy=80.0, cx=8.0, cy=8.0)
# float32 on both sides: MLP chain, compositing, sorting, inverse CDF
TOL = dict(rtol=1e-4, atol=1e-4)


def _tol(scene, key):
    """The box scene is held at TOL. A random-init field has density all
    along each ray, so ulp-level differences in the rays or the coarse
    weights move some importance samples by ~1e-4 in z (the inverse CDF
    divides by small bin masses); the top PE frequency 2^9 turns that into
    ~0.05 rad at the fine net's input, which moves those rays' maps by a
    few 1e-4. Disparity is a weighted mean of depth over the weights, and
    on nearly empty random-init rays (acc ~ 5e-3, sigma near the ReLU
    knee) those weights carry relative errors of 1e-3."""
    if scene == "box":
        return TOL
    if key.startswith("disp"):
        return dict(rtol=5e-3, atol=5e-3)
    return dict(rtol=1e-3, atol=1e-3)


def _models(scene):
    net = jcfg.NeRFNetConfig(**SMALL)
    if scene == "box":
        p = jax_box_scene(net, jax.random.PRNGKey(0))
        models = {"coarse": p, "fine": p}
    else:
        models = init_nerf_pipeline_params(jax.random.PRNGKey(0), net, 16)
    return {name: {k: np.array(v) for k, v in p.items()} for name, p in models.items()}


def _configs(**render):
    render = {"n_samples": 16, "n_importance": 16, "ray_chunk": 128, **render}
    j = jcfg.NeuralSimConfig(net=jcfg.NeRFNetConfig(**SMALL),
                             render=jcfg.RenderConfig(**render),
                             camera=jcfg.CameraConfig(**CAMERA))
    t = tcfg.NeuralSimConfig(net=tcfg.NeRFNetConfig(**SMALL),
                             render=tcfg.RenderConfig(**render),
                             camera=tcfg.CameraConfig(**CAMERA))
    return j, t


@pytest.mark.parametrize("scene", ["random", "box"])
def test_render_ray_batch_ragged_chunks(rng, scene):
    """Three full chunks and a ragged tail of 2 rays (the JAX side pads it
    by repeating the last ray; the port renders it short)."""
    jc, tc = _configs(ray_chunk=16)
    models = _models(scene)
    n = 50
    rays_o = (rng.randn(n, 3) * 0.02 + np.array([0, 0, 1.01])).astype(np.float32)
    rays_d = (rng.randn(n, 3) * 0.05 + np.array([0, 0, -1.0])).astype(np.float32)
    want = jax_render_ray_batch(models, rays_o, rays_d, None, jc.net,
                                jc.render.test_mode())
    got = trender.render_ray_batch(params_from_numpy(models, "cpu"),
                                   torch.from_numpy(rays_o), torch.from_numpy(rays_d),
                                   tc.net, tc.render.test_mode())
    assert set(got) == set(want)
    if scene == "box":
        assert float(np.asarray(want["acc_map"]).max()) > 0.5   # not vacuous
    for k in want:
        assert got[k].shape == tuple(want[k].shape), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **_tol(scene, k))


@pytest.mark.parametrize("scene", ["random", "box"])
def test_renderer_matches_jax(rng, scene):
    """NeuralSimRenderer end to end: psi -> poses -> rays -> coarse march ->
    sample_pdf -> fine march -> maps, K=2 images at 16x16."""
    jc, tc = _configs()
    models = _models(scene)
    k = 2
    g = (-np.log(-np.log(rng.rand(k, 8)))).astype(np.float32)
    u = rng.rand(k).astype(np.float32)
    th = (85 + 10 * rng.rand(k)).astype(np.float32)
    psi = np.array([0.02, 0.02, 0.02, 0.02, 0.86, 0.02, 0.02, 0.02], np.float32)

    want = JaxRenderer(jc, models=models)._render_fn(psi, JaxNoise(g, u, th))
    port = NeuralSimRenderer(tc, models=models, device="cpu")
    got = port._render_impl(torch.from_numpy(psi),
                            PoseNoise(*map(torch.from_numpy, (g, u, th))))
    assert got[0].shape == (k, 16, 16, 3)
    if scene == "box":
        assert float(np.asarray(want[2]).max()) > 0.5            # the box is hit
    for name, a, b in zip(("rgb", "disp", "acc"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **_tol(scene, name))


@pytest.mark.parametrize("ndc", [False, True])
def test_render_image_matches_jax(ndc):
    """One pose through render_image; with rc.ndc the rays go to NDC space
    and the z range becomes [0, 1] (apply_ndc)."""
    from neuralsim_tpu.ops.render import render_image as jax_render_image
    from neuralsim_tpu.sampler.poses import pose_spherical
    from neuralsim_tpu_torch.config import CameraConfig

    jc, tc = _configs(ndc=ndc)
    models = _models("box")
    c2w = np.array(pose_spherical(90.0, -30.0, 1.01))
    K = CameraConfig(**CAMERA).K
    want = jax_render_image(models, c2w, 8, 8, K, None, jc.net, jc.render.test_mode())
    got = trender.render_image(params_from_numpy(models, "cpu"), torch.from_numpy(c2w),
                               8, 8, K, tc.net, tc.render.test_mode(), device="cpu")
    for k in ("rgb_map", "acc_map", "depth_map"):
        assert got[k].shape[:2] == (8, 8)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)


def test_march_raw_matches_jax(rng):
    from neuralsim_tpu.ops.render import _march_raw as jax_march_raw

    jc, tc = _configs()
    models = _models("box")
    rays_o = (rng.randn(10, 3) * 0.02 + np.array([0, 0, 1.01])).astype(np.float32)
    rays_d = np.tile(np.array([[0, 0, -1.0]], np.float32), (10, 1))
    z = np.sort(0.5 + rng.rand(10, 12), -1).astype(np.float32)
    want = jax_march_raw(models["coarse"], rays_o, rays_d, rays_d, z, jc.net,
                         jc.render, np.float32)
    got = trender._march_raw(params_from_numpy(models, "cpu")["coarse"],
                             *map(torch.from_numpy, (rays_o, rays_d, rays_d, z)),
                             tc.net, tc.render, torch.float32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_render_images_draws_noise_and_renders():
    _, tc = _configs()
    r = NeuralSimRenderer(tc, generator=torch.Generator().manual_seed(0), device="cpu")
    rgb, noise = r.render_images(torch.full((8,), 0.125), torch.Generator().manual_seed(1),
                                 num_k=3)
    assert rgb.shape == (3, 16, 16, 3) and noise.gumbel.shape == (3, 8)
    assert torch.isfinite(rgb).all() and not rgb.requires_grad
    again = r._render_impl(torch.full((8,), 0.125), noise)[0]
    torch.testing.assert_close(rgb, again, rtol=0, atol=0)


def test_renderer_loads_npz(tmp_path):
    from neuralsim_tpu_torch.models.convert import save_params_npz

    _, tc = _configs()
    models = _models("random")
    (tmp_path / "nerf_models").mkdir()
    save_params_npz(str(tmp_path / "nerf_models" / "ycbvid2.npz"), models)
    tc = tc.replace(data=dataclasses.replace(tc.data, basedir=str(tmp_path),
                                             datadir=str(tmp_path)))
    r = NeuralSimRenderer(tc, device="cpu")
    np.testing.assert_array_equal(r.models["fine"]["rgb_kernel"].numpy(),
                                  models["fine"]["rgb_kernel"])


def test_camera_from_info_json_matches_jax(tmp_path):
    """The pipeline camera: half_res divides by 4, near/far widen by 0.5,
    render_factor downsamples."""
    import json

    from neuralsim_tpu.data.blender import load_data_param as jax_load
    from neuralsim_tpu_torch.data.blender import load_data_param

    info = {"near": 0.8, "far": 1.4, "H": 128, "W": 96, "frames": [{
        "file_path": "x", "transform_matrix": np.eye(4).tolist(),
        "intrinsic_matrix": [[426.66, 0, 62.5], [0, 426.9, 64.2], [0, 0, 1]]}]}
    (tmp_path / "nerf_traindata_info.json").write_text(json.dumps(info))
    for half_res in (False, True):
        got, want = load_data_param(str(tmp_path), half_res), jax_load(str(tmp_path), half_res)
        assert got._fields == want._fields
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    jc, tc = _configs()
    data = dict(datadir=str(tmp_path), basedir=str(tmp_path), half_res=True, render_factor=2)
    tc = tc.replace(data=dataclasses.replace(tc.data, **data))
    jc = jc.replace(data=dataclasses.replace(jc.data, **data))
    port, ref = NeuralSimRenderer(tc, device="cpu"), JaxRenderer(jc, models=_models("random"))
    assert (port.H, port.W) == (ref.H, ref.W) == (16, 12)
    np.testing.assert_array_equal(port.K, ref.K)
    assert (port.rc.near, port.rc.far) == (ref.rc.near, ref.rc.far) == (0.8 - 0.5, 1.4 + 0.5)


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tc = _configs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NeuralSimRenderer(tc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trender.render_poses({}, torch.eye(4)[None], 4, 4, np.eye(3), tc.net, tc.render)


@pytest.mark.parametrize("override", [
    dict(pe_projection=False), dict(fuse_pointgen=False), dict(fuse_compositing=True),
], ids=["pe_projection_false", "fuse_pointgen_false", "fuse_compositing"])
@pytest.mark.parametrize("scene", ["random", "box"])
def test_render_routes_match_jax_on_cpu(rng, scene, override):
    """The render routes that differ on the card render through the plain
    path on the CPU, as the JAX package does off the TPU, and match it:
    with pe_projection=False both sides encode with a true cos."""
    jc, tc = _configs(**override)
    models = _models(scene)
    k = 2
    g = (-np.log(-np.log(rng.rand(k, 8)))).astype(np.float32)
    u = rng.rand(k).astype(np.float32)
    th = (85 + 10 * rng.rand(k)).astype(np.float32)
    psi = np.array([0.02, 0.02, 0.02, 0.02, 0.86, 0.02, 0.02, 0.02], np.float32)

    want = JaxRenderer(jc, models=models)._render_fn(psi, JaxNoise(g, u, th))
    port = NeuralSimRenderer(tc, models=models, device="cpu")
    got = port._render_impl(torch.from_numpy(psi),
                            PoseNoise(*map(torch.from_numpy, (g, u, th))))
    if scene == "box":
        assert float(np.asarray(want[2]).max()) > 0.5            # the box is hit
    for name, a, b in zip(("rgb", "disp", "acc"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **_tol(scene, name))


def test_production_render_and_gradient_raise():
    """The production render and the render gradient are ported
    (tests/test_torch_production*.py, tests/test_torch_render_grad*.py) and
    raise only on what they cannot run: the production render on NDC rays
    (its grid is in world space), the gradient on an unknown mode. Each
    gradient mode gives a finite [8] gradient on the renderer's device."""
    _, tc = _configs()
    r = NeuralSimRenderer(tc, generator=torch.Generator().manual_seed(0), device="cpu")
    rc_ndc = dataclasses.replace(r.rc.production_mode(), ndc=True)
    with pytest.raises(ValueError, match="ndc"):
        trender.render_poses(r.models, r.calibration_poses()[:1], r.H, r.W, r.K, tc.net,
                             rc_ndc, grid=r.occupancy_grid(resolution=8), device="cpu")
    noise = draw_pose_noise(torch.Generator().manual_seed(1), tc.sampler, num_k=3)
    grad_E = torch.randn((2, 16, 16, 3), generator=torch.Generator().manual_seed(2)) * 1e-2
    for mode in ("strips", "rev", "fwd"):
        g = r.render_images_grad(torch.zeros(8), noise, grad_E, mode=mode)
        assert g.shape == (8,) and g.device.type == "cpu" and torch.isfinite(g).all()
    with pytest.raises(ValueError, match="unknown mode"):
        r.render_images_grad(torch.zeros(8), noise, grad_E, mode="jvp")


def test_to8b():
    x = torch.tensor([-0.5, 0.0, 0.5, 1.0, 2.0])
    np.testing.assert_array_equal(trender.to8b(x), [0, 0, 127, 255, 255])


# bf16 on both sides rounds at the same places (encodings, weights, each
# activation) and sums in other orders (XLA:CPU dot vs torch matmul). On the
# box scene no activation lands a bf16 step apart (4e-7 measured), so the
# render is held at the box scene's float32 tolerance; a float32 render is
# 3e-2 (rgb) and 6e-2 (acc) away from the bf16 one, so the check tells the
# two dtypes apart.
BF16_TOL = TOL


@pytest.mark.parametrize("override, kernel", [
    (dict(), "fused_nerf_march"),
    (dict(fuse_compositing=True), "fused_render_tile"),
    (dict(fuse_pointgen=False), "mlp_widepe"),
], ids=["march", "fuse_compositing", "fuse_pointgen_false"])
def test_renderer_bf16_matches_jax(rng, kernel_route, override, kernel):
    """NeuralSimRenderer in bfloat16 through a kernel route (the launch
    stood in by its bf16 twin on the CPU) against the JAX renderer in
    bfloat16, box scene, K=2 images at 16x16."""
    jc, tc = _configs(compute_dtype="bfloat16", **override)
    models = _models("box")
    k = 2
    g = (-np.log(-np.log(rng.rand(k, 8)))).astype(np.float32)
    u = rng.rand(k).astype(np.float32)
    th = (85 + 10 * rng.rand(k)).astype(np.float32)
    psi = np.array([0.02, 0.02, 0.02, 0.02, 0.86, 0.02, 0.02, 0.02], np.float32)

    want = JaxRenderer(jc, models=models)._render_fn(psi, JaxNoise(g, u, th))
    port = NeuralSimRenderer(tc, models=models, device="cpu")
    got = port._render_impl(torch.from_numpy(psi),
                            PoseNoise(*map(torch.from_numpy, (g, u, th))))
    assert {name for name, _ in kernel_route} == {kernel}
    assert float(np.asarray(want[2]).max()) > 0.5                # the box is hit
    for name, a, b in zip(("rgb", "disp", "acc"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **BF16_TOL)
