"""Port parity for the psi render gradient: ``render_grad_psi_strips``,
``render_grad_psi_rev``, ``render_grad_psi_fwd`` and
``NeuralSimRenderer.render_images_grad`` of ``neuralsim_tpu_torch`` against
``neuralsim_tpu`` on the CPU, float32 on both sides, with the same numpy
weights, noise and grad_E, at the fixture size of
``tests/test_render_grad.py`` (2x16 nets, 4 + 4 samples, 12x12, K = 3).

Each JAX reference is computed once per module, with the strips mode at
strip = H*W (one compiled program for every image) or the forward mode:
the JAX package holds its modes equal to each other, and the port's modes
are each held to that one reference. The Gumbel noise puts two bins of
each pose within 0.05 of each other, so the categorical gradient is not
saturated to ~0 (a near one-hot soft sample has a ~1e-9 gradient that any
atol swallows); every comparison asserts a nonzero norm first."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import box_scene_params as jax_box_scene
from neuralsim_tpu import config as jcfg
from neuralsim_tpu.hypergrad import render_grad as jrg
from neuralsim_tpu.models.nerf import init_nerf_pipeline_params as jax_init
from neuralsim_tpu.sampler.poses import GaussianPoseNoise as JGaussNoise
from neuralsim_tpu.sampler.poses import PoseNoise as JNoise
from neuralsim_tpu_torch import config as tcfg
from neuralsim_tpu_torch.hypergrad import render_grad as trg
from neuralsim_tpu_torch.models.convert import params_from_numpy
from neuralsim_tpu_torch.ops import render as trender
from neuralsim_tpu_torch.sampler.poses import GaussianPoseNoise, PoseNoise

torch.set_num_threads(2)

NET_KW = dict(netdepth=2, netwidth=16, netdepth_fine=2, netwidth_fine=16, skips=(0,),
              multires=2, multires_views=1)
RC_KW = dict(n_samples=4, n_importance=4, ray_chunk=4096, near=0.5, far=2.0)
JNET, TNET = jcfg.NeRFNetConfig(**NET_KW), tcfg.NeRFNetConfig(**NET_KW)
JRC, TRC = jcfg.RenderConfig(**RC_KW).test_mode(), tcfg.RenderConfig(**RC_KW).test_mode()
JSC, TSC = jcfg.SamplerConfig(), tcfg.SamplerConfig()
H = W = 12
N_IMG = 3
K = np.array([[15.0, 0, 6.0], [0, 15.0, 6.0], [0, 0, 1.0]], np.float32)
PSI = np.eye(8, dtype=np.float32)[4]
PSI_G = np.array([157.5, 20.0], np.float32)
# measured (CPU, float32; max abs difference over JAX's gradient norm): the
# box scene's modes within 5.4e-7, the live random scene's within 1.1e-6, so
# both are held to the box scene's 1e-4.
REL = 1e-4


def near_tie_noise(seed: int, k: int = N_IMG, psi=PSI):
    """Categorical noise (gumbel, uniform, theta) whose perturbed logits put
    a runner-up bin 0.05 below the best one in every pose."""
    rng = np.random.RandomState(seed)
    g = rng.gumbel(size=(k, 8)).astype(np.float32)
    logp = np.log(np.exp(psi / JSC.softmax_temperature)
                  / np.exp(psi / JSC.softmax_temperature).sum())
    for i in range(k):
        best, other = rng.choice(8, 2, replace=False)
        z = logp + g[i]
        g[i, best] = z.max() + 0.05 - logp[best]
        g[i, other] = z.max() - logp[other]
    u = rng.rand(k).astype(np.float32)
    theta = (85 + 10 * rng.rand(k)).astype(np.float32)
    return g, u, theta


def gaussian_noise(seed: int, k: int = N_IMG):
    rng = np.random.RandomState(seed)
    return rng.randn(k).astype(np.float32), (85 + 10 * rng.rand(k)).astype(np.float32)


def live_models(seed: int = 0):
    """Random init with the density bias raised by 1 (as
    tests/test_render_grad.py:_live_models): a raw init can give sigma <= 0
    on every ray, and then every psi gradient is exactly zero."""
    models = jax_init(jax.random.PRNGKey(seed), JNET, JRC.n_importance)
    return {m: {k: np.array(v) + (1.0 if k == "alpha_bias" else 0.0) for k, v in p.items()}
            for m, p in models.items()}


def box_models(half=0.12, center=(0.0, 0.0, 0.0)):
    p = {k: np.array(v) for k, v in
         jax_box_scene(JNET, jax.random.PRNGKey(0), half=half, center=center).items()}
    return {"coarse": p, "fine": p}


def grad_e(seed: int):
    return (np.random.RandomState(seed).randn(N_IMG, H, W, 3) * 1e-2).astype(np.float32)


def jax_strips(models, psi, noise, ge, psi_mode="categorical", **kw):
    """The JAX package's strips gradient, float32, one program per image."""
    jnoise = (JGaussNoise if psi_mode == "gaussian" else JNoise)(*map(jnp.asarray, noise))
    return np.asarray(jrg.render_grad_psi_strips(
        models, jnp.asarray(psi), jnoise, jnp.asarray(ge), H, W, K, JNET, JRC, JSC,
        psi_mode=psi_mode, strip=H * W, **kw))


def port_noise(noise, psi_mode="categorical"):
    return (GaussianPoseNoise if psi_mode == "gaussian" else PoseNoise)(
        *map(torch.from_numpy, noise))


def assert_close_rel(got, want, rel=REL, err_msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    norm = float(np.linalg.norm(want))
    assert norm > 0, "vacuous: the reference gradient is zero"
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * norm, err_msg=err_msg)


def cos(a, b):
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.fixture(scope="module")
def scenes():
    """Per scene: (numpy models, torch models, grad_E, categorical noise,
    Gaussian noise, JAX categorical gradient, JAX Gaussian gradient)."""
    out = {}
    for name, models in (("box", box_models()), ("live", live_models())):
        ge = grad_e(1)
        noise, noise_g = near_tie_noise(2), gaussian_noise(3)
        out[name] = dict(
            models=models, tmodels=params_from_numpy(models, "cpu"), ge=ge, noise=noise,
            noise_g=noise_g, want=jax_strips(models, PSI, noise, ge),
            want_g=np.asarray(jrg.render_grad_psi_fwd(
                models, jnp.asarray(PSI_G), JGaussNoise(*map(jnp.asarray, noise_g)),
                jnp.asarray(ge), H, W, K, JNET, JRC, JSC, psi_mode="gaussian")))
    return out


def port_grad(s, mode, psi_mode="categorical", rc=TRC, **kw):
    psi, noise = (PSI_G, s["noise_g"]) if psi_mode == "gaussian" else (PSI, s["noise"])
    args = (s["tmodels"], torch.from_numpy(psi), port_noise(noise, psi_mode),
            torch.from_numpy(s["ge"]), H, W, K, TNET, rc, TSC)
    if mode == "fwd":
        return trg.render_grad_psi_fwd(*args, psi_mode=psi_mode)
    if mode == "rev":
        return trg.render_grad_psi_rev(*args, psi_mode=psi_mode)
    return trg.render_grad_psi_strips(*args, psi_mode=psi_mode, **kw)


@pytest.mark.parametrize("scene", ["box", "live"])
@pytest.mark.parametrize("mode,kw", [("strips", dict(strip=50)), ("strips", dict(strip=H * W)),
                                     ("rev", {}), ("fwd", {})],
                         ids=["strips50", "stripsHW", "rev", "fwd"])
def test_categorical_modes_match_jax(scenes, scene, mode, kw):
    s = scenes[scene]
    got = port_grad(s, mode, **kw)
    assert got.shape == (8,) and got.dtype == torch.float32
    assert_close_rel(got, s["want"])


@pytest.mark.parametrize("scene", ["box", "live"])
@pytest.mark.parametrize("mode", ["fwd", "strips"])
def test_gaussian_modes_match_jax(scenes, scene, mode):
    s = scenes[scene]
    got = port_grad(s, mode, psi_mode="gaussian", strip=64)
    assert got.shape == (2,)
    assert_close_rel(got, s["want_g"])


@pytest.mark.parametrize("ib", [2, 3, 8])
def test_image_batch_matches_serial(scenes, ib):
    """image_batch folds images into one ray tile, with a shorter image
    tail (3 images at batch 2 and 8; the JAX package pads it with repeated
    noise and zero grad_E, which adds nothing) and a shorter strip tail
    (144 px at strip 64): the serial gradient and JAX's."""
    s = scenes["box"]
    serial = port_grad(s, "strips", strip=64)
    batched = port_grad(s, "strips", strip=64, image_batch=ib)
    torch.testing.assert_close(batched, serial, rtol=1e-5, atol=1e-6 * float(serial.norm()))
    assert_close_rel(batched, s["want"])


def test_rev_remat_matches_no_remat(scenes):
    """The reverse-mode gradient through psi_outer_loss with rc.remat (a
    checkpoint per ray tile, here 3 tiles of 144 rays) equals the one
    without it: remat changes memory, not values."""
    s = scenes["live"]
    rc = dataclasses.replace(TRC, ray_chunk=H * W, use_pallas=False, pe_projection=False)
    noise = port_noise(s["noise"])
    ge = torch.from_numpy(s["ge"])

    def grad(remat):
        psi = torch.from_numpy(PSI).requires_grad_(True)
        loss = trg.psi_outer_loss(s["tmodels"], psi, noise, ge, H, W, K, TNET,
                                  dataclasses.replace(rc, remat=remat), TSC)
        return torch.autograd.grad(loss, psi)[0]

    plain, remat = grad(False), grad(True)
    assert float(plain.norm()) > 0
    torch.testing.assert_close(remat, plain, rtol=1e-6, atol=1e-9)
    assert_close_rel(remat, s["want"])


def test_bf16_strips_close_to_f32(scenes):
    """compute_dtype="bfloat16" keeps the gradient's direction (cosine >
    0.99 to the float32 JAX gradient, as tests/test_render_grad.py:223);
    batched bf16 equals serial bf16 up to the order of the sums."""
    s = scenes["box"]
    bf16 = port_grad(s, "strips", strip=64, compute_dtype="bfloat16")
    bf16_b = port_grad(s, "strips", strip=64, image_batch=3, compute_dtype="bfloat16")
    assert cos(bf16.numpy(), s["want"]) > 0.99
    assert not torch.equal(bf16, port_grad(s, "strips", strip=64))
    torch.testing.assert_close(bf16_b, bf16, rtol=1e-2, atol=1e-4 * float(bf16.abs().max()))


# measured (CPU; max abs difference over the JAX bf16 gradient's norm): the
# port's bf16 strips gradient is 4.1e-7 from JAX's on the box scene and
# 1.1e-4 on the live random one (a bf16 step apart in a few activations),
# where the float32 gradient is 7.5e-2 and 8.8e-3 away, so each limit tells
# the two dtypes apart.
BF16_REL = {"box": REL, "live": 1e-3}


@pytest.mark.parametrize("scene", ["box", "live"])
@pytest.mark.parametrize("strip,ib", [(H * W, 1), (64, 3)], ids=["stripHW", "strip64_ib3"])
def test_bf16_strips_match_jax_bf16(scenes, scene, strip, ib):
    """compute_dtype="bfloat16" (BilevelConfig.grad_compute_dtype's
    default) equals the JAX package's bf16 strips gradient on the same
    inputs, scale included, where a cosine would pass a scale error; the
    JAX float32 gradient fails the same limit."""
    s = scenes[scene]
    want = jax_strips(s["models"], PSI, s["noise"], s["ge"], compute_dtype="bfloat16")
    got = port_grad(s, "strips", strip=strip, image_batch=ib, compute_dtype="bfloat16")
    assert_close_rel(got, want, rel=BF16_REL[scene])
    assert np.abs(s["want"] - want).max() > BF16_REL[scene] * np.linalg.norm(want)


def test_model_swap_gives_the_new_models_gradient(scenes):
    """The port keeps no compiled program, so the JAX package's cache
    invalidation has no counterpart; what it guards holds here too: after
    the models are swapped the gradient is the new models', not the old."""
    s = scenes["live"]
    other = live_models(11)
    before = port_grad(s, "strips", strip=H * W)
    swapped = dict(s, tmodels=params_from_numpy(other, "cpu"))
    after = port_grad(swapped, "strips", strip=H * W)
    assert_close_rel(after, jax_strips(other, PSI, s["noise"], s["ge"]))
    assert not np.allclose(after.numpy(), before.numpy())


def test_render_images_grad_matches_jax():
    """NeuralSimRenderer.render_images_grad in each mode: noise sliced to
    grad_E's length, strips at cfg.bilevel.grad_ray_chunk (one strip per
    12x12 image), against the JAX facade's strips gradient."""
    from neuralsim_tpu.pipeline import NeuralSimRenderer as JaxRenderer
    from neuralsim_tpu_torch.pipeline import NeuralSimRenderer

    camera = dict(height=H, width=W, focal=15.0, fx=15.0, fy=15.0, cx=6.0, cy=6.0)
    jc = jcfg.NeuralSimConfig(net=JNET, render=jcfg.RenderConfig(**RC_KW),
                              camera=jcfg.CameraConfig(**camera))
    tc = tcfg.NeuralSimConfig(net=TNET, render=tcfg.RenderConfig(**RC_KW),
                              camera=tcfg.CameraConfig(**camera))
    assert tc.bilevel == tcfg.BilevelConfig() and tc.bilevel.grad_ray_chunk == 5000
    models = box_models()
    ge = grad_e(4)
    g, u, th = near_tie_noise(5, k=N_IMG + 1)      # one pose more than grad_E
    want = np.asarray(JaxRenderer(jc, models=models).render_images_grad(
        jnp.asarray(PSI), JNoise(g, u, th), jnp.asarray(ge)))
    port = NeuralSimRenderer(tc, models=models, device="cpu")
    for mode in ("strips", "rev", "fwd"):
        got = port.render_images_grad(PSI, PoseNoise(*map(torch.from_numpy, (g, u, th))),
                                      torch.from_numpy(ge), mode=mode)
        assert got.device.type == "cpu"
        assert_close_rel(got, want, err_msg=mode)
    with pytest.raises(ValueError):
        port.render_images_grad(PSI, PoseNoise(*map(torch.from_numpy, (g, u, th))),
                                torch.from_numpy(ge), mode="jvp")


@pytest.mark.parametrize("perturb", [False, True])
def test_dense_remat_same_outputs_and_gradient(scenes, perturb):
    """_render_ray_batch_dense with rc.remat (a checkpoint per tile of 16
    rays, ragged tail) gives the same maps and the same gradient, w.r.t.
    the rays and a weight, as without it; under no_grad the same maps to
    the bit. With stratified jitter and density noise drawn from a
    generator, the recompute replays the first run's draws."""
    s = scenes["live"]
    rng = np.random.RandomState(7)
    o = torch.from_numpy((rng.randn(40, 3) * 0.05 + [0, 0, 1.2]).astype(np.float32))
    d = torch.from_numpy((rng.randn(40, 3) * 0.1 + [0, 0, -1.0]).astype(np.float32))
    w = torch.from_numpy(rng.randn(40, 3).astype(np.float32))
    rc = dataclasses.replace(TRC, ray_chunk=16, use_pallas=False)
    if perturb:
        rc = dataclasses.replace(rc, perturb=True, raw_noise_std=0.5)
    models = {m: dict(p) for m, p in s["tmodels"].items()}

    def run(remat, grad):
        rc_ = dataclasses.replace(rc, remat=remat)
        gen = torch.Generator().manual_seed(3)
        ro, rd = o.clone().requires_grad_(grad), d.clone().requires_grad_(grad)
        kernel = models["fine"]["rgb_kernel"].clone().requires_grad_(grad)
        m = {"coarse": models["coarse"], "fine": dict(models["fine"], rgb_kernel=kernel)}
        with torch.set_grad_enabled(grad):
            out = trender._render_ray_batch_dense(m, ro, rd, TNET, rc_, gen)
        if not grad:
            return out, None
        return out, torch.autograd.grad(torch.sum(out["rgb_map"] * w), (ro, rd, kernel))

    for grad in (False, True):
        plain, g_plain = run(False, grad)
        remat, g_remat = run(True, grad)
        for k in plain:
            torch.testing.assert_close(remat[k], plain[k], rtol=0, atol=0, msg=k)
        if grad:
            assert all(float(g.norm()) > 0 for g in g_plain)
            for a, b in zip(g_remat, g_plain):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
