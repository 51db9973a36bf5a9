"""The port's data-parallel NeRF train step (``train_nerf.train_step(mesh=)``)
with density noise and a sparse fine pass, on 4 gloo CPU ranks, against
the port's unsharded step on the whole batch (and, for the sparse pass, the
JAX package's ``train_step``).

The sizes and the launcher are tests/test_torch_parallel.py's: 2x32 nets,
256 train rays (64 a rank), one ``parallel.launch`` for the module. The
tolerances are that file's for the train step: loss and psnr rtol 1e-4,
the new parameters rtol 2e-3 / atol 2e-5, and every rank equal to the bit
to rank 0.

  (a) raw_noise_std = 1.0 with the whole batch's noise injected: the JAX
      ``raw2outputs`` takes only a key (neuralsim_tpu/ops/volume.py:45), so
      no noise can be handed to it; this case is held to the port's
      unsharded step alone;
  (b) fine_fraction = 0.5 on the box scene, whose rays are ordered so that
      the hit rays crowd two of the four blocks: the whole batch's top-k
      (k = 128) differs from the union of the blocks' own top-32 sets, and
      a step ranked per block moves the fine net's gradient by far more
      than the tolerance, which the test shows;
  (c) the draws left to the generator (perturb, noise, and both with the
      sparse pass): each rank takes its slice of the whole batch's draws,
      made in the unsharded render's order, so the step equals the
      unsharded one from the same generator.

The ranks import this module, so JAX and the JAX package are imported
inside the functions that run here, never at the top.
"""

import dataclasses

import numpy as np
import pytest
import torch

from neuralsim_tpu_torch import config as tcfg
from neuralsim_tpu_torch.ops.render import fine_ray_count, render_rays, top_k_indices
from neuralsim_tpu_torch.parallel import launch as tlaunch
from neuralsim_tpu_torch.parallel import mesh as tmesh
from neuralsim_tpu_torch.train_nerf import nerf_loss, train_step
from tests.test_torch_parallel import N_RANKS, N_TRAIN, NET_KW, RC_KW, TIMEOUT, _leaves, net

NOISE_RC = dict(RC_KW, raw_noise_std=1.0)
SPARSE_RC = dict(RC_KW, fine_fraction=0.5)
# (c): the render options, and whether the step trains the box pair
GENERATOR_CASES = {
    "perturb_noise": (dict(RC_KW, perturb=True, raw_noise_std=1.0), False),
    "perturb_noise_sparse": (dict(RC_KW, perturb=True, raw_noise_std=1.0, fine_fraction=0.5),
                             True),
}


def _steps(inputs):
    """Every case's step on this rank's mesh (or unsharded without one):
    {case: (params, metrics)}."""
    mesh = tmesh.make_mesh(device="cpu") if torch.distributed.is_initialized() else None
    rep = (lambda t: tmesh.replicate(t, mesh)) if mesh is not None else (lambda t: t)
    state, box = rep(inputs["state"]), rep(inputs["box_state"])
    rays = tuple(torch.from_numpy(inputs[k]) for k in ("train_o", "train_d", "train_t"))
    box_rays = tuple(torch.from_numpy(inputs[k]) for k in ("box_o", "box_d", "train_t"))
    tc = tcfg.TrainConfig(n_rand=N_TRAIN)
    noise = tuple(torch.from_numpy(x) for x in inputs["noise"])
    out = {"noise": train_step(state, *rays, net(), tcfg.RenderConfig(**NOISE_RC), tc,
                               noise=noise, mesh=mesh),
           "sparse": train_step(box, *box_rays, net(), tcfg.RenderConfig(**SPARSE_RC), tc,
                                mesh=mesh)}
    for name, (rc_kw, on_box) in GENERATOR_CASES.items():
        out[name] = train_step(box if on_box else state, *(box_rays if on_box else rays), net(),
                               tcfg.RenderConfig(**rc_kw), tc, torch.Generator().manual_seed(3),
                               mesh=mesh)
    return {k: (s.params, m) for k, (s, m) in out.items()}


def _ranks(inputs):
    torch.manual_seed(0)
    return _steps(inputs)


@pytest.fixture(scope="module")
def inputs():
    import jax
    import jax.numpy as jnp

    from bench import box_scene_params as jax_box_scene
    from neuralsim_tpu import config as jcfg
    from neuralsim_tpu.train_nerf import init_train_state as jinit_state
    from neuralsim_tpu_torch.train_nerf import train_state_from_jax

    jnet = jcfg.NeRFNetConfig(**NET_KW)
    jrc = jcfg.RenderConfig(**RC_KW)
    tree_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    jstate = jinit_state(jax.random.PRNGKey(0), jnet, jrc, jcfg.TrainConfig(n_rand=N_TRAIN))
    box = {k: np.array(v) for k, v in
           jax_box_scene(jnet, jax.random.PRNGKey(0), half=0.12).items()}
    jbox = jstate._replace(params={"coarse": box, "fine": box})
    train_d = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (N_TRAIN, 3)) * 0.1
                         + jnp.array([0.0, 0.0, -1.0]))
    # rays down -z at x from -0.3 to 0.3 in order: the box (|x| < 0.12)
    # covers the middle two blocks of four, 102 rays in all, the outer two
    # blocks none
    box_o = np.stack([np.linspace(-0.3, 0.3, N_TRAIN), np.zeros(N_TRAIN), np.ones(N_TRAIN)],
                     -1).astype(np.float32)
    box_d = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (N_TRAIN, 1))
    rng = np.random.RandomState(8)
    s, s_fine = RC_KW["n_samples"], RC_KW["n_samples"] + RC_KW["n_importance"]
    return {
        "state": train_state_from_jax(tree_np(jstate.params), tree_np(jstate.opt_state),
                                      np.asarray(jstate.step)),
        "box_state": train_state_from_jax(tree_np(jbox.params), tree_np(jbox.opt_state),
                                          np.asarray(jbox.step)),
        "jax_box_state": jbox,
        "train_o": np.zeros((N_TRAIN, 3), np.float32), "train_d": train_d,
        "train_t": np.full((N_TRAIN, 3), 0.5, np.float32),
        "box_o": box_o, "box_d": box_d,
        "noise": (rng.randn(N_TRAIN, s).astype(np.float32),
                  rng.randn(N_TRAIN, s_fine).astype(np.float32)),
    }


@pytest.fixture(scope="module")
def ranks(inputs):
    """The 4 ranks' steps (a JAX state does not pickle: left out)."""
    sent = {k: v for k, v in inputs.items() if k != "jax_box_state"}
    return tlaunch.launch(_ranks, N_RANKS, (sent,), device="cpu", timeout=TIMEOUT, threads=1)


@pytest.fixture(scope="module")
def unsharded(inputs):
    return _steps(inputs)


def _hold(ranks, case, want_params, want_metrics, start_params):
    """Every rank's step of ``case`` against one unsharded step, at the
    train step's tolerances, and equal to the bit to rank 0's."""
    want = _leaves(want_params)
    start = _leaves(start_params)
    assert max(float(np.abs(want[k] - start[k]).max()) for k in want) > 1e-5
    first = _leaves(ranks[0][case][0])
    for r in ranks:
        params, metrics = r[case]
        for name in ("loss", "psnr"):
            np.testing.assert_allclose(float(metrics[name]), float(want_metrics[name]),
                                       rtol=1e-4, err_msg=f"{case} {name}")
        got = _leaves(params)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-3, atol=2e-5,
                                       err_msg=f"{case} {k}")
            np.testing.assert_array_equal(got[k], first[k], err_msg=f"{case} {k}")


def test_sharded_step_with_injected_noise_matches_unsharded(ranks, inputs, unsharded):
    """(a) raw_noise_std = 1.0, the whole batch's noise injected: each rank
    takes its rows of it, and the step equals the unsharded step. The noise
    moves the step (against the same step without it)."""
    params, metrics = unsharded["noise"]
    _hold(ranks, "noise", params, metrics, inputs["state"].params)
    rays = tuple(torch.from_numpy(inputs[k]) for k in ("train_o", "train_d", "train_t"))
    _, quiet = train_step(inputs["state"], *rays, net(), tcfg.RenderConfig(**RC_KW),
                          tcfg.TrainConfig(n_rand=N_TRAIN))
    assert abs(float(quiet["loss"]) - float(metrics["loss"])) > 1e-4 * float(metrics["loss"])


def _block_ranked_loss(params, inputs, rc):
    """The sparse step's loss with each block of rays ranked on its own (the
    per-rank top-k that the sharded step must not take), in one process."""
    o, d, t = (torch.from_numpy(inputs[k]) for k in ("box_o", "box_d", "train_t"))
    b = N_TRAIN // N_RANKS
    return sum(nerf_loss(params, o[i:i + b], d[i:i + b], t[i:i + b], net(), rc)[0] / N_RANKS
               for i in range(0, N_TRAIN, b))


def test_sharded_sparse_fine_pass_ranks_the_whole_batch(ranks, inputs, unsharded):
    """(b) fine_fraction = 0.5 on the box scene: every rank equals the port's
    unsharded step and the JAX package's train_step on the whole batch. The
    whole batch's chosen rays differ from the union of the blocks' own
    top-k, and a step ranked per block moves the fine net's gradient by
    more than 1% of its norm: a per-rank ranking would fail this test."""
    import jax

    from neuralsim_tpu import config as jcfg
    from neuralsim_tpu.train_nerf import train_step as jstep

    rc = tcfg.RenderConfig(**SPARSE_RC)
    params, metrics = unsharded["sparse"]
    _hold(ranks, "sparse", params, metrics, inputs["box_state"].params)
    js, jm = jax.jit(jstep, static_argnums=(5, 6, 7))(inputs["jax_box_state"], inputs["box_o"], inputs["box_d"], inputs["train_t"],
                   jax.random.PRNGKey(2), jcfg.NeRFNetConfig(**NET_KW),
                   jcfg.RenderConfig(**SPARSE_RC), jcfg.TrainConfig(n_rand=N_TRAIN))
    _hold(ranks, "sparse", jax.tree_util.tree_map(np.asarray, js.params), jm,
          inputs["box_state"].params)

    box = inputs["box_state"].params
    o, d = torch.from_numpy(inputs["box_o"]), torch.from_numpy(inputs["box_d"])
    with torch.no_grad():
        acc = render_rays(box, o, d, d, net(), rc)["acc0"]
    hits = int((acc > 0).sum())
    assert 0 < hits < fine_ray_count(N_TRAIN, 0.5)
    chosen = set(top_k_indices(acc, fine_ray_count(N_TRAIN, 0.5)).tolist())
    b = N_TRAIN // N_RANKS
    per_block = set()
    for i in range(0, N_TRAIN, b):
        per_block |= {i + j for j in top_k_indices(acc[i:i + b], fine_ray_count(b, 0.5)).tolist()}
    assert chosen != per_block and set(torch.nonzero(acc > 0).squeeze(-1).tolist()) <= chosen

    def fine_grad(loss_fn):
        leaves = {n: {k: v.detach().requires_grad_() for k, v in p.items()}
                  for n, p in box.items()}
        keys = sorted(leaves["fine"])
        grads = torch.autograd.grad(loss_fn(leaves), [leaves["fine"][k] for k in keys])
        return torch.cat([g.reshape(-1) for g in grads])

    t = torch.from_numpy(inputs["train_t"])
    whole = fine_grad(lambda p: nerf_loss(p, o, d, t, net(), rc)[0])
    blocks = fine_grad(lambda p: _block_ranked_loss(p, inputs, rc))
    assert float((whole - blocks).norm() / whole.norm()) > 1e-2


@pytest.mark.parametrize("case", list(GENERATOR_CASES))
def test_sharded_step_slices_the_whole_batch_generator_draws(ranks, inputs, unsharded, case):
    """(c) With the uniforms and the density noise left to the generator
    (and with the sparse pass), every rank draws them for the whole batch
    in the unsharded render's order and takes its slice (its rows, or the
    chosen rays' rows of the sparse pass's fine draws): the step equals the
    unsharded one from the same generator. The draws move the step (against
    the same render options without perturb and noise)."""
    rc_kw, on_box = GENERATOR_CASES[case]
    params, metrics = unsharded[case]
    start = inputs["box_state" if on_box else "state"]
    _hold(ranks, case, params, metrics, start.params)
    rays = tuple(torch.from_numpy(inputs[k]) for k in (
        ("box_o", "box_d", "train_t") if on_box else ("train_o", "train_d", "train_t")))
    quiet = dataclasses.replace(tcfg.RenderConfig(**rc_kw), perturb=False, raw_noise_std=0.0)
    s_quiet, _ = train_step(start, *rays, net(), quiet, tcfg.TrainConfig(n_rand=N_TRAIN))
    want, other = _leaves(params), _leaves(s_quiet.params)
    assert max(float(np.abs(want[k] - other[k]).max()) for k in want) > 1e-6
