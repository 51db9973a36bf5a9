"""The port's NeRF trainer (``neuralsim_tpu_torch/train_nerf.py``) against
the JAX one (``neuralsim_tpu/train_nerf.py``) on the CPU, at the tiny sizes
of ``tests/test_train_nerf.py`` (2x32 nets, 8 + 8 samples, 16x16 views).

JAX splits its key into image, pixel and render keys, and Threefry and
Philox cannot match, so the parity cases build the JAX draws here (the
image index, the pixel picks, the pool permutation, the k_strat / k_pdf
uniforms of the render) and inject them into the port (``StepDraws``,
``render_rays(uniforms=)``). Then every case of ``tests/test_train_nerf.py``
replayed through the port, and the kernel route of the step (the march
kernel stood in by a fake C entry that reads the weights it is given)."""

import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neuralsim_tpu import config as jcfg
from neuralsim_tpu import train_nerf as jtn
from neuralsim_tpu.data.blender import CameraParams as JCam
from neuralsim_tpu.data.blender import LinemodDataset as JDataset
from neuralsim_tpu.ops.render import img2mse as jimg2mse
from neuralsim_tpu.ops.render import mse2psnr as jmse2psnr
from neuralsim_tpu_torch import config as tcfg
from neuralsim_tpu_torch import train_nerf as ttn
from neuralsim_tpu_torch.data.blender import CameraParams, LinemodDataset
from neuralsim_tpu_torch.kernels import raymarch as rm
from neuralsim_tpu_torch.ops.render import img2mse, mse2psnr
from neuralsim_tpu_torch.sampler.poses import pose_spherical
from tests.test_torch_net_shapes import _FakeMarchLibrary

NET_KW = dict(netdepth=2, netwidth=32, netdepth_fine=2, netwidth_fine=32, skips=(0,),
              multires=4, multires_views=2)
RC_KW = dict(n_samples=8, n_importance=8, ray_chunk=256, near=0.5, far=2.0, perturb=True)
TC_KW = dict(n_rand=128, lrate=5e-3, lrate_decay=500)
NET, RC, TC = (tcfg.NeRFNetConfig(**NET_KW), tcfg.RenderConfig(**RC_KW),
               tcfg.TrainConfig(**TC_KW))
# losses: float32 sums in two programs (XLA and ATen) over the same inputs
LOSS_REL = 1e-5
# parameters and Adam moments, max |difference| over each tensor's norm
# after 3 steps: see test_train_step_matches_jax for the measured figure
STATE_REL = 1e-4


def configs(net=None, rc=None, tc=None):
    """(JAX configs, port configs) of the same fields."""
    kws = (dict(NET_KW, **(net or {})), dict(RC_KW, **(rc or {})), dict(TC_KW, **(tc or {})))
    names = ("NeRFNetConfig", "RenderConfig", "TrainConfig")
    return ([getattr(jcfg, n)(**kw) for n, kw in zip(names, kws)],
            [getattr(tcfg, n)(**kw) for n, kw in zip(names, kws)])


def datasets(n_views=4, hw=16, flat=True, seed=0):
    """The same LINEMOD-layout dataset for both packages: views from
    spherical poses, flat 0.6 (the JAX tests') or random colours."""
    poses = pose_spherical(torch.linspace(0, 270, n_views), torch.full((n_views,), -20.0),
                           1.2).numpy()
    if flat:
        images = np.full((n_views, hw, hw, 4), 0.6, np.float32)
    else:
        images = np.random.RandomState(seed).rand(n_views, hw, hw, 4).astype(np.float32)
    K = np.array([[20.0, 0, hw / 2], [0, 20.0, hw / 2], [0, 0, 1]], np.float32)
    split = (np.arange(n_views), np.array([], np.int64), np.array([], np.int64))
    return (JDataset(images, poses, poses, JCam(hw, hw, 20.0, K, 0.5, 2.0), split),
            LinemodDataset(images, poses, poses, CameraParams(hw, hw, 20.0, K, 0.5, 2.0), split))


def leaves(tree):
    """A port params tree (nested dicts) as {"coarse/pts_0_kernel": array}."""
    return {f"{n}/{k}": np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)
            for n in tree for k, v in tree[n].items()}


def rel_err(got, want):
    """max over tensors of max |got - want| / ||want||."""
    g, w = leaves(got), leaves(want)
    assert g.keys() == w.keys()
    return max(float(np.abs(g[k] - w[k]).max() / max(np.linalg.norm(w[k]), 1e-30))
               for k in w)


def jax_state_np(state):
    """A JAX TrainState's params, mu, nu as numpy trees."""
    adam = state.opt_state[0]
    return (jax.tree_util.tree_map(np.asarray, state.params),
            jax.tree_util.tree_map(np.asarray, adam.mu),
            jax.tree_util.tree_map(np.asarray, adam.nu), int(adam.count))


def render_uniforms(k_render, n_rays, rc):
    """The JAX render's k_strat and k_pdf uniforms (ops/render.py:57-58,
    ops/volume.py:40, :162) as torch tensors."""
    k_strat, k_pdf, _, _ = jax.random.split(k_render, 4)
    return (torch.from_numpy(np.asarray(jax.random.uniform(k_strat, (n_rays, rc.n_samples)))),
            torch.from_numpy(np.asarray(jax.random.uniform(k_pdf, (n_rays, rc.n_importance)))))


# ------------------------------------------------------- losses, optimizer --

def test_img2mse_and_mse2psnr_match_jax(rng):
    x, y = rng.rand(64, 3).astype(np.float32), rng.rand(64, 3).astype(np.float32)
    mse = img2mse(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(mse), float(jimg2mse(x, y)), rtol=1e-6)
    for v in (float(mse), 1e-10, 0.5):
        np.testing.assert_allclose(float(mse2psnr(torch.tensor(v))),
                                   float(jmse2psnr(jnp.float32(v))), rtol=1e-6)


def test_make_optimizer_matches_optax(rng):
    """10 Adam steps from the same params and gradients: the port's tensor
    arithmetic against optax.adam with the reference's schedule, decay fast
    enough that the schedule moves (lr 0.1 * 0.1^(step / 20))."""
    (_, _, jtc), (_, _, tc) = configs(tc=dict(lrate=0.1, lrate_decay=0.02))
    params = {"coarse": {"w": rng.randn(5, 4).astype(np.float32),
                         "b": rng.randn(4).astype(np.float32)},
              "fine": {"w": rng.randn(3).astype(np.float32)}}
    jopt = jtn.make_optimizer(jtc)
    jp, js = params, jopt.init(params)
    opt = ttn.make_optimizer(tc)
    tp = {n: {k: torch.from_numpy(v) for k, v in p.items()} for n, p in params.items()}
    ts = opt.init(tp)
    for step in range(10):
        # gradients across scales, a few near zero (Adam's sign-sensitive regime)
        grads = {n: {k: (rng.randn(*v.shape) * 10.0 ** rng.randint(-6, 2)).astype(np.float32)
                     for k, v in p.items()} for n, p in params.items()}
        updates, js = jopt.update(grads, js, jp)
        jp = optax.apply_updates(jp, updates)
        tp, ts = opt.update({n: {k: torch.from_numpy(v) for k, v in g.items()}
                             for n, g in grads.items()}, ts, tp)
        for got, want in ((tp, jp), (ts["mu"], js[0].mu), (ts["nu"], js[0].nu)):
            g, w = leaves(got), leaves(want)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=2e-6, atol=1e-7,
                                           err_msg=f"step {step} {k}")
        assert int(ts["count"]) == int(js[0].count) == int(js[1].count) == step + 1


def test_schedule_is_read_before_the_increment():
    """The first update moves each parameter by lrate (|m_hat / sqrt(v_hat)|
    is 1 at step 1, but for float32's 1 - 0.999 and eps): the schedule is
    taken at count 0, where it is lrate; at count 1 it would be lrate / 10
    (decay over 1 step)."""
    tc = tcfg.TrainConfig(lrate=0.25, lrate_decay=0.001)
    opt = ttn.make_optimizer(tc)
    p = {"coarse": {"w": torch.zeros(3)}}
    new, state = opt.update({"coarse": {"w": torch.tensor([2.0, -3.0, 1e-3])}}, opt.init(p), p)
    np.testing.assert_allclose(new["coarse"]["w"].numpy(), [-0.25, 0.25, -0.25], rtol=2e-5)
    assert int(state["count"]) == 1


# ------------------------------------------------------------ train step --

def _jax_init(jnet, jrc, jtc, seed=0):
    state = jtn.init_train_state(jax.random.PRNGKey(seed), jnet, jrc, jtc)
    params, mu, nu, count = jax_state_np(state)
    return state, ttn.train_state_from_jax(params, state.opt_state, state.step)


def test_train_state_from_jax_round_trip():
    """A JAX TrainState (params, optax's mu / nu / count, step) carried into
    the port: every leaf equal, after JAX steps too (non-zero moments)."""
    (jnet, jrc, jtc), _ = configs(rc=dict(perturb=False))
    jds, _ = datasets(flat=False)
    jstate, state = _jax_init(jnet, jrc, jtc)
    assert int(state.step) == 0 and int(state.opt_state["count"]) == 0
    ro, rd, tgt = jtn.sample_image_rays(jax.random.PRNGKey(2), jnp.asarray(jds.images[0]),
                                        jnp.asarray(jds.poses[0]), 16, 16, jds.camera.K, 32)
    for _ in range(2):
        jstate, _ = jtn.train_step(jstate, ro, rd, tgt, None, jnet, jrc, jtc)
    params, mu, nu, count = jax_state_np(jstate)
    state = ttn.train_state_from_jax(params, jstate.opt_state, jstate.step)
    assert int(state.step) == 2 and int(state.opt_state["count"]) == count == 2
    assert state.step.dtype == state.opt_state["count"].dtype == torch.int32
    for got, want in ((state.params, params), (state.opt_state["mu"], mu),
                      (state.opt_state["nu"], nu)):
        g, w = leaves(got), leaves(want)
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
            assert g[k].dtype == np.float32


def test_train_step_matches_jax():
    """3 steps with perturb=False (render_rays draws nothing) from one state
    on the same ray batches: losses to LOSS_REL, parameters and both Adam
    moments to STATE_REL of each tensor's norm.

    Measured here: the losses equal to 6 digits; parameters within 3.5e-6
    of the norm, mu and nu within 9e-7. Adam's first step moves each weight
    by lr * g / (|g| + 1e-8), so a gradient within rounding of zero could
    flip the sign of a whole lr step; none of this net's gradients lies that
    close (the test prints the figures under -s)."""
    (jnet, jrc, jtc), (net, rc, tc) = configs(rc=dict(perturb=False))
    jds, ds = datasets(flat=False)
    jstate, state = _jax_init(jnet, jrc, jtc)
    jstep = jax.jit(lambda s, ro, rd, tgt: jtn.train_step(s, ro, rd, tgt, None, jnet, jrc, jtc))
    for i in range(3):
        ro, rd, tgt = jtn.sample_image_rays(
            jax.random.PRNGKey(10 + i), jnp.asarray(jds.images[i]),
            jnp.asarray(jds.poses[i]), 16, 16, jds.camera.K, 64)
        jstate, jm = jstep(jstate, ro, rd, tgt)
        state, m = ttn.train_step(state, *(torch.from_numpy(np.asarray(a)) for a in (ro, rd, tgt)),
                                  net, rc, tc)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_REL)
        np.testing.assert_allclose(float(m["psnr"]), float(jm["psnr"]), rtol=LOSS_REL)
        params, mu, nu, count = jax_state_np(jstate)
        errs = [rel_err(state.params, params), rel_err(state.opt_state["mu"], mu),
                rel_err(state.opt_state["nu"], nu)]
        print(f"step {i}: loss {float(m['loss']):.6g} vs {float(jm['loss']):.6g}; "
              f"params / mu / nu {errs}")
        assert max(errs) < STATE_REL, errs
        assert int(state.step) == int(jstate.step) == i + 1


def test_perturbed_step_with_jax_draws():
    """One step with perturb=True: the JAX step's k_strat / k_pdf uniforms
    injected into the port's render give the same loss, parameters and
    moments."""
    (jnet, jrc, jtc), (net, rc, tc) = configs()
    jds, _ = datasets(flat=False)
    jstate, state = _jax_init(jnet, jrc, jtc)
    ro, rd, tgt = jtn.sample_image_rays(jax.random.PRNGKey(4), jnp.asarray(jds.images[1]),
                                        jnp.asarray(jds.poses[1]), 16, 16, jds.camera.K, 64)
    k = jax.random.PRNGKey(5)
    jstate, jm = jtn.train_step(jstate, ro, rd, tgt, k, jnet, jrc, jtc)
    state, m = ttn.train_step(state, *(torch.from_numpy(np.asarray(a)) for a in (ro, rd, tgt)),
                              net, rc, tc, uniforms=render_uniforms(k, 64, rc))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_REL)
    params, mu, nu, _ = jax_state_np(jstate)
    assert rel_err(state.params, params) < STATE_REL
    assert rel_err(state.opt_state["mu"], mu) < STATE_REL
    assert rel_err(state.opt_state["nu"], nu) < STATE_REL
    # without the injected draws the render jitters differently
    _, state0 = _jax_init(jnet, jrc, jtc)
    _, m2 = ttn.train_step(state0, *(torch.from_numpy(np.asarray(a)) for a in (ro, rd, tgt)),
                           net, rc, tc, generator=torch.Generator().manual_seed(0))
    assert float(m2["loss"]) != float(m["loss"])


def test_sample_image_rays_matches_jax():
    """The same pixel picks (JAX's choice without replacement, injected)
    give the same rays and targets, with and without the central crop."""
    jds, ds = datasets(flat=False)
    K = ds.camera.K
    for frac, n_coords in ((None, 256), (0.5, 64)):
        key = jax.random.PRNGKey(7)
        jro, jrd, jtgt = jtn.sample_image_rays(key, jnp.asarray(jds.images[2]),
                                               jnp.asarray(jds.poses[2]), 16, 16, K, 32, frac)
        pixels = torch.from_numpy(np.asarray(
            jax.random.choice(key, n_coords, (32,), replace=False)))
        ro, rd, tgt = ttn.sample_image_rays(torch.from_numpy(ds.images[2]),
                                            torch.from_numpy(ds.poses[2]), 16, 16, K, 32,
                                            frac, pixels=pixels)
        np.testing.assert_allclose(ro.numpy(), np.asarray(jro), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(rd.numpy(), np.asarray(jrd), rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(tgt.numpy(), np.asarray(jtgt))


def jax_loop_draws(key, ds, tc, rc, n_iters):
    """The draws of the JAX train_nerf loop (train_nerf.py:168-215), as the
    port's StepDraws: per iteration key, k_img, k_pix, k_render = split(key,
    4); the pool's first permutation from the split before the loop, a
    reshuffle from k_pix."""
    i_train = ds.i_split[0]
    cam = ds.camera
    m = len(i_train) * cam.height * cam.width
    n_take = min(tc.n_rand, m)
    out, i_batch = [], None
    if not tc.no_batching:
        key, k_perm = jax.random.split(key)
        first = np.asarray(jax.random.permutation(k_perm, m))
    for it in range(n_iters):
        key, k_img, k_pix, k_render = jax.random.split(key, 4)
        d = dict(uniforms=render_uniforms(k_render, n_take if not tc.no_batching else tc.n_rand,
                                          rc))
        if tc.no_batching:
            d["image"] = int(jax.random.choice(k_img, jnp.array(i_train)))
            crop = tc.precrop_frac if it < tc.precrop_iters else None
            n_coords = ((2 * int(cam.height // 2 * crop)) * (2 * int(cam.width // 2 * crop))
                        if crop else cam.height * cam.width)
            d["pixels"] = torch.from_numpy(np.asarray(
                jax.random.choice(k_pix, n_coords, (tc.n_rand,), replace=False)))
        else:
            if i_batch is None:
                d["perm"], i_batch = torch.from_numpy(first), 0
            elif i_batch + n_take > m:
                d["perm"] = torch.from_numpy(np.asarray(jax.random.permutation(k_pix, m)))
                i_batch = 0
            i_batch += n_take
        out.append(ttn.StepDraws(**d))
    return out


@pytest.mark.parametrize("tc_kw", [dict(), dict(precrop_iters=2, precrop_frac=0.5, n_rand=48),
                                   dict(no_batching=False, n_rand=300)],
                         ids=["per_image", "precrop", "use_batching"])
def test_train_nerf_matches_jax_with_its_draws(tc_kw):
    """The whole loop for 4 iterations, perturbed: the JAX train_nerf's
    draws injected, the port's loop gives the JAX loop's final state and
    last loss (use_batching: 4 x 300 rays of a 1024-ray pool, so the
    permutation is redrawn once)."""
    (jnet, jrc, jtc), (net, rc, tc) = configs(tc=tc_kw)
    jds, ds = datasets(flat=False)
    key = jax.random.PRNGKey(3)
    jstate, jm = jtn.train_nerf(jds, jnet, jrc, jtc, key=key, n_iters=4)
    jinit = jtn.init_train_state(key, jnet, dataclasses.replace(jrc, near=0.5, far=2.0), jtc)
    params, _, _, _ = jax_state_np(jinit)
    state0 = ttn.train_state_from_jax(params, jinit.opt_state, jinit.step)
    draws = jax_loop_draws(key, ds, tc, rc, 4)
    state, m = ttn.train_nerf(ds, net, rc, tc, n_iters=4, state=state0, device="cpu",
                              draws=lambda it: draws[it])
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_REL)
    params, mu, nu, count = jax_state_np(jstate)
    assert rel_err(state.params, params) < STATE_REL
    assert rel_err(state.opt_state["mu"], mu) < STATE_REL
    assert int(state.step) == 4 and count == 4


# ------------------------------------- replay of tests/test_train_nerf.py --

def test_lr_schedule_decays():
    """lr(0) = lrate, lr(decay * 1000) = 0.1 lrate: the first update of a
    fresh state moves by lr(0), one at count 1000 by lr(1000)."""
    tc = tcfg.TrainConfig(lrate=1.0, lrate_decay=1)
    opt = ttn.make_optimizer(tc)
    p = {"coarse": {"w": torch.zeros(1)}}
    g = {"coarse": {"w": torch.ones(1)}}
    new, _ = opt.update(g, opt.init(p), p)
    # float32's bias corrections (1 - 0.9f, 1 - 0.999f) leave 7e-6
    assert abs(float(new["coarse"]["w"]) + 1.0) < 2e-5
    state = opt.init(p)
    state["count"] = torch.tensor(1000, dtype=torch.int32)
    state["nu"] = {"coarse": {"w": torch.ones(1)}}
    state["mu"] = {"coarse": {"w": torch.ones(1)}}
    new, _ = opt.update(g, state, p)
    # m = v = 1: the step is the scheduled lr times m_hat / sqrt(v_hat)
    ratio = (1 / (1 - 0.9 ** 1001)) / np.sqrt(1 / (1 - 0.999 ** 1001))
    np.testing.assert_allclose(float(new["coarse"]["w"]), -0.1 * ratio, rtol=1e-4)


def test_sample_image_rays_shapes():
    _, ds = datasets()
    ro, rd, tgt = ttn.sample_image_rays(torch.from_numpy(ds.images[0]),
                                        torch.from_numpy(ds.poses[0]), 16, 16, ds.camera.K, 32,
                                        generator=torch.Generator().manual_seed(0))
    assert ro.shape == (32, 3) and rd.shape == (32, 3) and tgt.shape == (32, 3)


def test_sample_image_rays_precrop():
    _, ds = datasets()
    img = torch.from_numpy(ds.images[0]).clone()
    img[4:12, 4:12, 0] = 0.9
    _, _, tgt = ttn.sample_image_rays(img, torch.from_numpy(ds.poses[0]), 16, 16, ds.camera.K,
                                      16, precrop_frac=0.5,
                                      generator=torch.Generator().manual_seed(1))
    # all sampled pixels from the central crop -> red channel 0.9
    np.testing.assert_allclose(tgt[:, 0].numpy(), 0.9, atol=1e-6)


def _train(ds, rc=RC, tc=TC, n_iters=30, seed=0, **kw):
    return ttn.train_nerf(ds, NET, rc, tc, torch.Generator().manual_seed(seed),
                          n_iters=n_iters, device="cpu", **kw)


def test_training_improves_psnr():
    _, ds = datasets()
    state, metrics = _train(ds)
    assert int(state.step) == 30
    _, m0 = _train(ds, n_iters=1)
    assert float(metrics["loss"]) < float(m0["loss"]) * 0.7
    assert np.isfinite(float(metrics["psnr"]))


def test_train_step_pure_and_deterministic():
    _, ds = datasets()
    state = ttn.init_train_state(NET, RC, TC, torch.Generator().manual_seed(0), "cpu")
    before = leaves(state.params)
    ro, rd, tgt = ttn.sample_image_rays(torch.from_numpy(ds.images[0]),
                                        torch.from_numpy(ds.poses[0]), 16, 16, ds.camera.K, 64,
                                        generator=torch.Generator().manual_seed(2))
    s1, m1 = ttn.train_step(state, ro, rd, tgt, NET, RC, TC, torch.Generator().manual_seed(3))
    s2, m2 = ttn.train_step(state, ro, rd, tgt, NET, RC, TC, torch.Generator().manual_seed(3))
    assert float(m1["loss"]) == float(m2["loss"])
    l1, l2 = leaves(s1.params), leaves(s2.params)
    assert all(np.array_equal(l1[k], l2[k]) for k in l1)
    # the state passed in is left as it was
    assert all(np.array_equal(v, leaves(state.params)[k]) for k, v in before.items())
    assert int(state.step) == 0


def test_hook_continues_global_step_on_resume():
    _, ds = datasets()
    state, _ = _train(ds, n_iters=3)
    assert int(state.step) == 3
    seen = []
    _train(ds, n_iters=2, seed=1, state=state, hook=lambda i, s: seen.append(i))
    assert seen == [4, 5]


def test_ray_pool_covers_all_train_rays():
    """The pool holds exactly every train-image ray, and the sampler's first
    epoch visits each ray at most once (reference :604-621)."""
    from neuralsim_tpu_torch.ops.rays import get_rays

    _, ds = datasets(n_views=3, hw=8)
    pool = ttn.build_ray_pool(ds.images, ds.poses, ds.i_split[0], 8, 8, ds.camera.K, "cpu")
    m = 3 * 8 * 8
    assert pool.rays_o.shape == (m, 3) and pool.rgb.shape == (m, 3)
    ro0, rd0 = get_rays(8, 8, ds.camera.K, torch.from_numpy(ds.poses[0])[:3, :4])
    np.testing.assert_allclose(pool.rays_o[:64].numpy(), ro0.reshape(-1, 3).numpy())
    np.testing.assert_allclose(pool.rays_d[:64].numpy(), rd0.reshape(-1, 3).numpy())
    take = ttn.make_pool_sampler(48)
    perm = torch.randperm(m, generator=torch.Generator().manual_seed(0))
    seen = []
    for start in (0, 48, 96):
        ro, rd, tgt = take(pool, perm, start)
        assert ro.shape == (48, 3)
        np.testing.assert_array_equal(ro.numpy(), pool.rays_o[perm[start:start + 48]].numpy())
        seen.extend(perm[start:start + 48].tolist())
    assert len(set(seen)) == len(seen)


def test_ray_pool_matches_jax():
    from neuralsim_tpu.train_nerf import build_ray_pool

    jds, ds = datasets(n_views=3, hw=8, flat=False)
    jpool = build_ray_pool(jds.images, jds.poses, jds.i_split[0], 8, 8, jds.camera.K)
    pool = ttn.build_ray_pool(ds.images, ds.poses, ds.i_split[0], 8, 8, ds.camera.K, "cpu")
    for got, want in zip(pool, jpool):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_training_use_batching_improves():
    _, ds = datasets()
    tc = dataclasses.replace(TC, no_batching=False, n_rand=96)
    state, metrics = _train(ds, tc=tc)
    assert int(state.step) == 30
    _, m0 = _train(ds, tc=tc, n_iters=1)
    assert float(metrics["loss"]) < float(m0["loss"]) * 0.7


def test_ndc_render_and_train():
    from neuralsim_tpu_torch.ops.occupancy import OccupancyGrid
    from neuralsim_tpu_torch.ops.render import render_image

    _, ds = datasets()
    rc_ndc = dataclasses.replace(RC, ndc=True)
    models = ttn.init_train_state(NET, RC, TC, torch.Generator().manual_seed(0), "cpu").params
    with torch.no_grad():
        out = render_image(models, ds.poses[0], 16, 16, ds.camera.K, NET, rc_ndc,
                           torch.Generator().manual_seed(0), device="cpu")
    assert out["rgb_map"].shape == (16, 16, 3)
    assert torch.isfinite(out["rgb_map"]).all()
    assert float(out["depth_map"].max()) <= 1.0 + 1e-5
    grid = OccupancyGrid(torch.ones((4, 4, 4)), torch.full((3,), -1.0), torch.full((3,), 1.0))
    with pytest.raises(ValueError, match="world space"):
        render_image(models, ds.poses[0], 16, 16, ds.camera.K, NET,
                     dataclasses.replace(rc_ndc, hit_budget=0.5), grid=grid, device="cpu")
    _, m = _train(ds, rc=rc_ndc, n_iters=2)
    assert np.isfinite(float(m["loss"]))


# ------------------------------------------------------- the kernel route --

class _WeightReadingMarch(_FakeMarchLibrary):
    """A stand-in for the built nerf_march library whose C entry computes
    the march from what it is handed: the rays by pointer, and the weights
    from the cached padded set whose pointers it gets (so a stale cache
    entry would show in its output). Outputs are written by pointer."""

    def nerf_march(self, o, d, v, z, n, s, ptrs, width, depth, skip_mask, in_ch,
                   in_ch_views, bf16, packed, sigma_out, rgb_out, stream):
        self.calls.append((n, s))
        entry = [e for e in rm._PACKED.values()
                 if [w.data_ptr() for w in e[1]] == list(ptrs[:len(e[1])])]
        assert len(entry) == 1, "the weights handed over are not one cached set"
        _, weights, image = entry[0]
        assert image.data_ptr() == packed
        params = dict(zip(rm.param_keys(depth), weights))

        def at(ptr, count):
            return torch.frombuffer((ctypes.c_float * count).from_address(ptr),
                                    dtype=torch.float32)

        rays = [at(p, n * 3).reshape(n, 3) for p in (o, d, v)]
        zs = at(z, n * s).reshape(n, s)
        net = dataclasses.replace(NET, netwidth=width, netwidth_fine=width)
        for ptr, t in zip((sigma_out, rgb_out),
                          rm.march_channels_ref(params, *rays, zs, net, torch.float32)):
            t = t.contiguous()
            ctypes.memmove(ptr, t.data_ptr(), t.numel() * 4)
        return 0


@pytest.fixture
def weight_reading_march(monkeypatch):
    lib = _WeightReadingMarch()
    monkeypatch.setattr(rm, "uses_kernel", lambda t: True)
    monkeypatch.setattr(rm, "_library", lambda name: lib)
    monkeypatch.setattr(rm, "_run", lambda fn, device, what, *args: fn(*args, None))
    return lib


def test_kernel_route_steps_see_the_updated_weights(weight_reading_march):
    """On the card route each step's forward is two launches of the march
    kernel (coarse, fine) and the backward none; each launch reads the
    padded weights prepared from that step's parameters (a step makes new
    tensors, so every step prepares anew, and the cache holds the old
    tensors, so their ids are not reused while cached): 4 steps give the
    plain route's losses and parameters. An in-place update (the other way
    to change a weight) prepares anew too."""
    _, ds = datasets(flat=False)
    rc = dataclasses.replace(RC, perturb=False, compute_dtype="float32")
    gen = torch.Generator().manual_seed(0)
    state0 = ttn.init_train_state(NET, rc, TC, gen, "cpu")
    batches = [ttn.sample_image_rays(torch.from_numpy(ds.images[i]), torch.from_numpy(ds.poses[i]),
                                     16, 16, ds.camera.K, 64,
                                     generator=torch.Generator().manual_seed(i))
               for i in range(4)]
    rm.fused_nerf_march.launches = 0
    kernel, plain = state0, state0
    for i, batch in enumerate(batches):
        kernel, mk = ttn.train_step(kernel, *batch, NET, rc, TC)
        assert rm.fused_nerf_march.launches == 2 * (i + 1)
        rc_plain = dataclasses.replace(rc, use_pallas=False)
        plain, mp = ttn.train_step(plain, *batch, NET, rc_plain, TC)
        # the padded net sums zero rows in another order on the CPU (1 ulp)
        np.testing.assert_allclose(float(mk["loss"]), float(mp["loss"]), rtol=1e-6)
        assert rel_err(kernel.params, plain.params) < 1e-5
    assert weight_reading_march.calls == [(64, 8), (64, 16)] * 4

    params = {k: v.clone() for k, v in kernel.params["coarse"].items()}
    o, d, _ = batches[0]
    vd = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    z = torch.linspace(0.5, 2.0, 8).expand(64, 8).contiguous()
    with torch.no_grad():
        first = rm.fused_nerf_march(params, o, d, vd, z, NET, torch.float32)
        params["pts_1_kernel"].mul_(1.5)
        again = rm.fused_nerf_march(params, o, d, vd, z, NET, torch.float32)
        want = rm.march_channels_ref(params, o, d, vd, z, NET, torch.float32)
    assert not torch.equal(first[0], again[0])
    for got, ref in zip(again, want):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)


def test_fused_compositing_refuses_a_gradient_on_the_card(weight_reading_march):
    """fuse_compositing=True on the card: the render tile is forward only,
    so a train step raises, as the JAX package's forward-only kernel 3."""
    _, ds = datasets()
    rc = dataclasses.replace(RC, perturb=False, fuse_compositing=True)
    state = ttn.init_train_state(NET, rc, TC, torch.Generator().manual_seed(0), "cpu")
    batch = ttn.sample_image_rays(torch.from_numpy(ds.images[0]), torch.from_numpy(ds.poses[0]),
                                  16, 16, ds.camera.K, 16,
                                  generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="forward only"):
        ttn.train_step(state, *batch, NET, rc, TC)


def test_entry_points_need_cuda_or_an_explicit_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, ds = datasets()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttn.init_train_state(NET, RC, TC)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttn.train_nerf(ds, NET, RC, TC, n_iters=1)


# ------------------------------- whole images from the start (no precrop) --

def box_on_black(hw=32, n_views=22, half=0.06):
    """A solid grey box (the box scene's size, half-extent 0.06) on a black
    background, traced analytically: LINEMOD-like RGBA views at radius 1.01
    with the box scene camera scaled to hw^2, 16 train, 2 val, 4 test; near
    and far widened by 1 as the loader widens them."""
    az = torch.linspace(-180, 180, n_views + 1)[:-1]
    el = torch.tensor([-20.0, -40.0] * (n_views // 2))
    poses = pose_spherical(az, el, 1.01).numpy()
    f = 1333.3334 * hw / 400
    K = np.array([[f, 0, hw / 2], [0, f, hw / 2], [0, 0, 1]], np.float32)
    i, j = np.meshgrid(np.arange(hw), np.arange(hw), indexing="ij")
    dirs = np.stack([(j + 0.5 - hw / 2) / f, -(i + 0.5 - hw / 2) / f, -np.ones((hw, hw))], -1)
    images = np.zeros((n_views, hw, hw, 4), np.float32)
    for v, c2w in enumerate(poses):
        d = dirs @ c2w[:3, :3].T
        with np.errstate(divide="ignore", invalid="ignore"):
            t1, t2 = (-half - c2w[:3, 3]) / d, (half - c2w[:3, 3]) / d
        hit = (np.maximum(t1, t2).min(-1) > np.minimum(t1, t2).max(-1))
        images[v][hit] = (0.5, 0.5, 0.5, 1.0)
    split = (np.arange(16), np.arange(16, 18), np.arange(18, n_views))
    near, far = 1.01 - 0.154 - 1.0, 1.01 + 0.154 + 1.0
    return (JDataset(images, poses, poses, JCam(hw, hw, f, K, near, far), split),
            LinemodDataset(images, poses, poses, CameraParams(hw, hw, f, K, near, far), split))


def test_whole_images_stall_alike_in_jax_and_port(capsys, tmp_path):
    """Trained on whole images from the start (no precrop) on an object
    that covers a quarter of a black frame, the JAX trainer and the port,
    from the JAX draws, follow the same losses and stall alike near the
    all-black render: the stall is the recipe's, not the port's. 4x64
    nets, 32 + 32 samples, N_rand 256, lr 5e-4, 100 steps; the printed
    figures (pytest -s) are the ones PERF.md cites."""
    from neuralsim_tpu_torch import train_cli

    n_iters, every = 100, 20
    (jnet, jrc, jtc), (net, rc, tc) = configs(
        net=dict(netdepth=4, netwidth=64, netdepth_fine=4, netwidth_fine=64, skips=(2,),
                 multires=10, multires_views=4),
        rc=dict(n_samples=32, n_importance=32, ray_chunk=4096),
        tc=dict(n_rand=256, lrate=5e-4, lrate_decay=500))
    jds, ds = box_on_black()
    key = jax.random.PRNGKey(0)
    jstate, jm = jtn.train_nerf(jds, jnet, jrc, jtc, key=key, n_iters=n_iters, log_every=every)
    jinit = jtn.init_train_state(key, jnet, dataclasses.replace(
        jrc, near=ds.camera.near, far=ds.camera.far), jtc)
    params, _, _, _ = jax_state_np(jinit)
    state0 = ttn.train_state_from_jax(params, jinit.opt_state, jinit.step)
    draws = jax_loop_draws(key, ds, tc, rc, n_iters)
    state, m = ttn.train_nerf(ds, net, rc, tc, n_iters=n_iters, state=state0, device="cpu",
                              draws=lambda it: draws[it], log_every=every)
    lines = [ln.split() for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[train] iter")]
    # "[train] iter i loss x psnr y": the JAX loop's lines, then the port's
    losses = np.array([float(ln[4]) for ln in lines]).reshape(2, -1)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-3)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
    rcr = dataclasses.replace(rc, near=ds.camera.near, far=ds.camera.far)
    pj, _, _, _ = jax_state_np(jstate)
    psnr_jax = train_cli.render_testset(ttn.train_state_from_jax(
        pj, jstate.opt_state, jstate.step).params, ds, net, rcr, str(tmp_path / "j"), "cpu")
    psnr_port = train_cli.render_testset(state.params, ds, net, rcr, str(tmp_path / "p"), "cpu")
    gt = ds.images[ds.i_split[2]][..., :3]
    black = float(np.mean([-10 * np.log10(np.mean(g ** 2)) for g in gt]))
    with capsys.disabled():
        print(f"\nwhole images, {n_iters} steps: losses every {every} steps JAX "
              f"{losses[0].tolist()} port {losses[1].tolist()}; last loss "
              f"{float(jm['loss']):.7f} / {float(m['loss']):.7f}; test PSNR JAX "
              f"{psnr_jax:.3f} dB, port {psnr_port:.3f} dB, all-black render {black:.3f} dB")
    assert abs(psnr_port - psnr_jax) < 0.05
    assert max(psnr_jax, psnr_port) < black + 4.0
