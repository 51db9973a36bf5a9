"""The port's mesh (``neuralsim_tpu_torch/parallel/``) against the JAX
package's on the CPU.

Layout and blocks are held to JAX's ``make_mesh`` on the 8 virtual
devices of tests/conftest.py: a port mesh over the ranks 0..7 (no process
group), looked at from each rank in turn, against each device's position
and ``addressable_shards[i].index``.

Everything else runs once per module on 4 gloo ranks of one process group
(``parallel.launch.launch``, one hard time limit): a (4, 1) mesh and a
(2, 2) mesh. The ranks return what they computed and the tests compare it
here with the port's unsharded functions and the JAX package's, at the
tolerances of the JAX mesh tests (tests/test_parallel.py,
test_distributed.py, test_render_grad.py):
  - the sharded render: rtol 1e-4 / atol 1e-5;
  - the sharded NeRF train step: loss 1e-4, parameters rtol 2e-3 / atol
    2e-5, and equal to the bit across ranks;
  - the tensor-parallel render against the replicated one: 2e-3 / 1e-5;
  - the strips psi gradient against the serial one: categorical and
    Gaussian 1e-5 / 1e-8, culled at hit_budget 0.5 1e-4 / 2e-8, each
    gradient nonzero (box scene, near-tie Gumbel noise);
  - the data-parallel inner step against one process, on a batch whose
    ranks hold different numbers of fg anchors (a per-rank normalizer
    would be off by far more than the tolerance, which the test shows).

The ranks import this module, so JAX and the JAX package are imported
inside the functions that run here, never at the top.
"""

import dataclasses

import numpy as np
import pytest
import torch

from neuralsim_tpu_torch import config as tcfg
from neuralsim_tpu_torch.detector import trainer as tt
from neuralsim_tpu_torch.detector.dataset import build_detector_batches
from neuralsim_tpu_torch.hypergrad import render_grad as trg
from neuralsim_tpu_torch.models.convert import params_from_numpy
from neuralsim_tpu_torch.models.retinanet import DetBatch, generate_anchors, retinanet_loss
from neuralsim_tpu_torch.models.nerf import make_sigma_fn
from neuralsim_tpu_torch.ops.occupancy import build_scene_grid
from neuralsim_tpu_torch.ops.render import render_ray_batch
from neuralsim_tpu_torch.parallel import distributed as tdist
from neuralsim_tpu_torch.parallel import launch as tlaunch
from neuralsim_tpu_torch.parallel import mesh as tmesh
from neuralsim_tpu_torch.sampler.poses import GaussianPoseNoise, PoseNoise
from neuralsim_tpu_torch.train_nerf import train_step

N_RANKS = 4
TIMEOUT = 300.0

NET_KW = dict(netdepth=2, netwidth=32, netdepth_fine=2, netwidth_fine=32, skips=(0,),
              multires=4, multires_views=2)
RC_KW = dict(n_samples=8, n_importance=8, ray_chunk=128, near=0.5, far=2.0, perturb=False)
TP_RC_KW = dict(n_samples=8, n_importance=8, ray_chunk=64, near=0.5, far=2.0, perturb=False)
N_RAYS, N_TRAIN, N_TP = 1024, 256, 128
# the strips gradient: the fixture size of tests/test_torch_render_grad.py
G_NET_KW = dict(netdepth=2, netwidth=16, netdepth_fine=2, netwidth_fine=16, skips=(0,),
                multires=2, multires_views=1)
G_RC_KW = dict(n_samples=4, n_importance=4, ray_chunk=4096, near=0.5, far=2.0)
G_HW = 12
G_K = [[15.0, 0.0, 6.0], [0.0, 15.0, 6.0], [0.0, 0.0, 1.0]]
DC = tcfg.DetectorConfig(num_classes=2, image_size=32, max_iter=2, images_per_batch=4,
                         warmup_iters=1)
DP_IDX = [[0, 1, 2, 3], [2, 3, 0, 1]]


def net():
    return tcfg.NeRFNetConfig(**NET_KW)


def strips_setup():
    net_g = tcfg.NeRFNetConfig(**G_NET_KW)
    return net_g, tcfg.RenderConfig(**G_RC_KW).test_mode(), tcfg.SamplerConfig()


def port_strips(inputs, case, mesh=None):
    """The port's strips gradient of one case (see ``inputs``)."""
    net_g, rc, sc = strips_setup()
    models = params_from_numpy(inputs["box"], "cpu")
    noise, psi, mode = inputs["strips"][case]
    noise = (GaussianPoseNoise if mode == "gaussian" else PoseNoise)(
        *map(torch.from_numpy, noise))
    kw = dict(psi_mode=mode, strip=32, mesh=mesh)
    if case == "culled":
        kw.update(grid=build_scene_grid(make_sigma_fn(models["coarse"], net_g), 1.2,
                                        resolution=32, device="cpu"), hit_budget=0.5)
    return trg.render_grad_psi_strips(models, torch.from_numpy(psi), noise,
                                      torch.from_numpy(inputs["grad_E"]), G_HW, G_HW, G_K,
                                      net_g, rc, sc, **kw)


def dp_data(images):
    """The inner train's dataset: 4 images annotated on the host."""
    return DetBatch(*build_detector_batches(images, [0, 1, 0, 1], DC, device="cpu"))


def detector_state():
    return tt.init_detector(torch.Generator().manual_seed(0), DC, device="cpu")


def _ranks(inputs):
    """One rank's work: everything the launch-based tests read."""
    torch.manual_seed(0)
    mesh = tmesh.make_mesh(device="cpu")
    tp_mesh = tmesh.make_mesh(data=2, model=2, device="cpu")
    rank = mesh.rank
    out = {"coords": mesh.coords, "tp_coords": tp_mesh.coords, "shape": mesh.shape,
           "tp_shape": tp_mesh.shape, "first": mesh.is_first}
    out["data_sum"] = tmesh.all_sum(torch.tensor([float(rank)]), tp_mesh.data_group)
    out["model_gather"] = tmesh.all_gather(torch.tensor([rank]), tp_mesh.model_group)

    # replicate: every rank ends with rank 0's bits, in new tensors
    mine = {"a": torch.full((3,), float(rank)), "b": [torch.tensor([rank])]}
    rep = tmesh.replicate(mine, mesh)
    out["replicated"] = rep
    out["replicate_new"] = rep["a"] is not mine["a"] and rep["b"][0] is not mine["b"][0]

    # blocks of one array on both meshes
    x = torch.arange(16 * 3).reshape(16, 3)
    out["rays_block"] = tmesh.shard_rays(x, mesh)
    out["tp_data_block"] = tmesh.shard_batch(x, tp_mesh)
    out["tp_model_block"] = tmesh.shard_batch(x, tp_mesh, axis="model")

    # the sharded render: each rank its block of rays, all-gathered
    models = tmesh.replicate(params_from_numpy(inputs["models"], "cpu"), mesh)
    rc = tcfg.RenderConfig(**RC_KW)
    render = tmesh.shard_map_compat(
        lambda o, d: render_ray_batch(models, o, d, net(), rc)["rgb_map"], mesh,
        ("data", "data"), "data")
    out["render"] = render(torch.from_numpy(inputs["rays_o"]),
                           torch.from_numpy(inputs["rays_d"]))

    # the sharded train step, deterministic and with the render's uniforms
    state = tmesh.replicate(inputs["train_state"], mesh)
    ro, rd, tgt = (torch.from_numpy(inputs[k]) for k in ("train_o", "train_d", "train_t"))
    tc = tcfg.TrainConfig(n_rand=N_TRAIN)
    s1, m1 = train_step(state, ro, rd, tgt, net(), rc, tc, mesh=mesh)
    out["train"] = (s1.params, m1)
    rc_p = dataclasses.replace(rc, perturb=True)
    s2, m2 = train_step(state, ro, rd, tgt, net(), rc_p, tc,
                        torch.Generator().manual_seed(3), mesh=mesh)
    out["train_perturb"] = (s2.params, m2)

    # tensor parallelism on the (2, 2) mesh: both modes' leaves, the render
    full = tcfg.NeRFNetConfig()
    tp = tdist.nerf_param_sharding(inputs["full_models"], tp_mesh, tensor_parallel=True)
    out["tp_params"] = dict(tp)
    out["tp_split"] = sorted("/".join(p) for p in tp.split)
    out["rep_params"] = tdist.nerf_param_sharding(inputs["full_models"], tp_mesh)
    out["tp_render"] = render_ray_batch(tp, torch.zeros(N_TP, 3),
                                        torch.from_numpy(inputs["tp_rays_d"]), full,
                                        tcfg.RenderConfig(**TP_RC_KW))["rgb_map"]

    # the strips psi gradient with its images over the data axis
    out["strips"] = {case: port_strips(inputs, case, mesh) for case in inputs["strips"]}

    # the data-parallel inner train
    det = tmesh.replicate(detector_state(), mesh)
    idx = torch.tensor(DP_IDX)
    data = dp_data(inputs["det_images"])
    det, metrics = tt.inner_train(det, (data, tmesh.shard_batch(idx.T, mesh).T), DC,
                                  group=mesh.data_group)
    trainable, _ = tt.split_trainable(det.params, DC)
    out["dp"] = ({k: trainable[k] for k in sorted(trainable)[:6] + sorted(trainable)[-6:]},
                 metrics, torch.cat([v.reshape(-1) for v in trainable.values()]).norm())
    return out


def _fails():
    tmesh.make_mesh(device="cpu")
    if torch.distributed.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    torch.distributed.barrier()


def _hangs():
    import time

    tmesh.make_mesh(device="cpu")
    if torch.distributed.get_rank() == 1:
        time.sleep(600)
    torch.distributed.barrier()


# --------------------------------------------------------------------------- #
# inputs and references, computed here
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def inputs():
    import jax
    import jax.numpy as jnp

    from bench import box_scene_params as jax_box_scene
    from neuralsim_tpu import config as jcfg
    from neuralsim_tpu.models.nerf import init_nerf_pipeline_params as jinit
    from neuralsim_tpu.train_nerf import init_train_state as jinit_state
    from neuralsim_tpu_torch.train_nerf import train_state_from_jax
    from tests.test_torch_render_grad import gaussian_noise, near_tie_noise

    jnet = jcfg.NeRFNetConfig(**NET_KW)
    jrc = jcfg.RenderConfig(**RC_KW)
    tree_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    models = tree_np(jinit(jax.random.PRNGKey(0), jnet, jrc.n_importance))
    rays_d = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (N_RAYS, 3)) * 0.1
                        + jnp.array([0.0, 0.0, -1.0]))
    jstate = jinit_state(jax.random.PRNGKey(0), jnet, jrc, jcfg.TrainConfig(n_rand=N_TRAIN))
    train_d = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (N_TRAIN, 3)) * 0.1
                         + jnp.array([0.0, 0.0, -1.0]))
    full_models = tree_np(jinit(jax.random.PRNGKey(0), jcfg.NeRFNetConfig(), 8))
    tp_rays_d = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (N_TP, 3)) * 0.1
                           + jnp.array([0.0, 0.0, -1.0]))
    gnet = jcfg.NeRFNetConfig(**G_NET_KW)
    box = {k: np.array(v) for k, v in
           jax_box_scene(gnet, jax.random.PRNGKey(0), half=0.12).items()}
    psi = np.zeros(8, np.float32)
    psi[2] = 0.5
    images = np.zeros((4, 32, 32, 3), np.float32)
    images[0, 2:30, 2:30] = 0.9          # one large object: many fg anchors
    images[1, 12:18, 12:18] = 0.7        # one small object
    images[2, 4:14, 4:14] = 0.8          # two objects
    images[2, 18:30, 16:28] = 0.6
    # image 3 stays empty: no fg anchor at all
    return {
        "models": models, "rays_o": np.zeros((N_RAYS, 3), np.float32), "rays_d": rays_d,
        "train_state": train_state_from_jax(tree_np(jstate.params),
                                            tree_np(jstate.opt_state), np.asarray(jstate.step)),
        "jax_train_state": jstate,
        "train_o": np.zeros((N_TRAIN, 3), np.float32), "train_d": train_d,
        "train_t": np.full((N_TRAIN, 3), 0.5, np.float32),
        "full_models": full_models, "tp_rays_d": tp_rays_d,
        "box": {"coarse": box, "fine": box},
        "grad_E": (np.random.RandomState(4).randn(3, G_HW, G_HW, 3) * 1e-2).astype(np.float32),
        "strips": {"categorical": (near_tie_noise(7, 3, psi), psi, "categorical"),
                   "gaussian": (gaussian_noise(9, 3), np.array([157.5, 20.0], np.float32),
                                "gaussian"),
                   "culled": (near_tie_noise(11, 3, psi), psi, "categorical")},
        "det_images": images,
    }


@pytest.fixture(scope="module")
def ranks(inputs):
    """The 4 ranks' results (a JAX state does not pickle: left out)."""
    sent = {k: v for k, v in inputs.items() if k != "jax_train_state"}
    return tlaunch.launch(_ranks, N_RANKS, (sent,), device="cpu", timeout=TIMEOUT, threads=1)


def jax_mesh(data, model, n=8):
    import jax

    from neuralsim_tpu.parallel.mesh import make_mesh

    return make_mesh(data=data, model=model, devices=jax.devices()[:n])


def port_layout(data, model, n=8):
    return tmesh.make_mesh(data=data, model=model, ranks=range(n), device="cpu")


def as_rank(mesh, r):
    return dataclasses.replace(mesh, rank=int(r))


# --------------------------------------------------------------------------- #
# layout and blocks, in this process
# --------------------------------------------------------------------------- #

LAYOUTS = {"all_data": (-1, 1), "4x2": (4, 2), "truncated_3x2": (3, 2), "2x4": (2, 4)}


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_mesh_layout_matches_jax(case):
    data, model = LAYOUTS[case]
    jm, pm = jax_mesh(data, model), port_layout(data, model)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    assert pm.devices.shape == jm.devices.shape
    np.testing.assert_array_equal(pm.devices, ids)
    assert pm.axis_names == tuple(jm.axis_names) == ("data", "model")
    assert pm.shape == dict(jm.shape)
    for pos, r in np.ndenumerate(ids):
        assert as_rank(pm, r).coords == pos
    left_out = set(range(8)) - set(ids.ravel().tolist())
    assert all(as_rank(pm, r).coords is None for r in left_out)
    assert pm.first_rank == 0 and as_rank(pm, 0).is_first


BLOCKS = {"rays_8x1": (8, 1, "data"), "batch_4x2": (4, 2, "data"),
          "batch_4x2_model": (4, 2, "model"), "batch_2x4_model": (2, 4, "model")}


@pytest.mark.parametrize("case", sorted(BLOCKS))
def test_blocks_match_jax_shards(case):
    """Each rank's block is the shard JAX puts on the device at the rank's
    mesh position."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    data, model, axis = BLOCKS[case]
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    jm, pm = jax_mesh(data, model), port_layout(data, model)
    sharded = jax.device_put(x, NamedSharding(jm, P(axis)))
    shards = {s.device.id: s.index for s in sharded.addressable_shards}
    assert len(shards) == 8
    for r, index in shards.items():
        mine = as_rank(pm, r)
        got = (tmesh.shard_rays(torch.from_numpy(x), mine) if axis == "data" and model == 1
               else tmesh.shard_batch({"x": torch.from_numpy(x)}, mine, axis=axis)["x"])
        np.testing.assert_array_equal(got.numpy(), x[index])


def test_non_dividing_length_raises_in_both():
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    x = np.zeros((10, 3), np.float32)
    with pytest.raises(ValueError):
        jax.device_put(x, NamedSharding(jax_mesh(8, 1), P("data")))
    pm = as_rank(port_layout(8, 1), 3)
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.shard_rays(torch.from_numpy(x), pm)
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.shard_batch([torch.from_numpy(x)], pm)
    with pytest.raises(ValueError):
        port_layout(3, 3)
    with pytest.raises(ValueError):
        port_layout(-1, 3)


def test_initialize_distributed_single_process_in_both():
    from neuralsim_tpu.parallel.distributed import initialize_distributed

    assert initialize_distributed() is False
    assert initialize_distributed(num_processes=1) is False
    assert tdist.initialize_distributed() is False
    assert tdist.initialize_distributed(num_processes=1) is False
    with pytest.raises(ValueError, match="coordinator_address"):
        tdist.initialize_distributed(num_processes=2, device="cpu")
    assert not torch.distributed.is_initialized()


def test_parallel_exports_and_pad():
    from neuralsim_tpu.parallel import __all__ as jall
    from neuralsim_tpu.parallel.mesh import pad_to_multiple
    from neuralsim_tpu_torch import parallel

    assert parallel.__all__ == list(jall)
    assert all(tmesh.pad_to_multiple(n, k) == pad_to_multiple(n, k)
               for n in range(0, 20) for k in (1, 3, 8))


# --------------------------------------------------------------------------- #
# the launcher
# --------------------------------------------------------------------------- #


def test_launch_fails_when_a_rank_raises():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        tlaunch.launch(_fails, 2, device="cpu", timeout=120.0, threads=1)


def test_launch_fails_when_a_rank_hangs():
    with pytest.raises(TimeoutError, match="did not finish"):
        tlaunch.launch(_hangs, 2, device="cpu", timeout=15.0, threads=1)


# --------------------------------------------------------------------------- #
# 4 gloo ranks
# --------------------------------------------------------------------------- #


def test_rank_layout_and_groups(ranks):
    assert [r["coords"] for r in ranks] == [(i, 0) for i in range(4)]
    assert [r["tp_coords"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert ranks[0]["shape"] == {"data": 4, "model": 1}
    assert ranks[0]["tp_shape"] == {"data": 2, "model": 2}
    assert [r["first"] for r in ranks] == [True, False, False, False]
    # data groups are the columns of [[0, 1], [2, 3]], model groups its rows
    assert [float(r["data_sum"][0]) for r in ranks] == [2.0, 4.0, 2.0, 4.0]
    assert [r["model_gather"].tolist() for r in ranks] == [[0, 1], [0, 1], [2, 3], [2, 3]]


def test_replicate_gives_every_rank_the_first_ranks_bits(ranks):
    for r in ranks:
        np.testing.assert_array_equal(r["replicated"]["a"], np.zeros(3, np.float32))
        np.testing.assert_array_equal(r["replicated"]["b"][0], [0])
        assert r["replicate_new"]


def test_rank_blocks(ranks):
    x = np.arange(16 * 3).reshape(16, 3)
    for i, r in enumerate(ranks):
        np.testing.assert_array_equal(r["rays_block"], x[4 * i:4 * i + 4])
        d, m = r["tp_coords"]
        np.testing.assert_array_equal(r["tp_data_block"], x[8 * d:8 * d + 8])
        np.testing.assert_array_equal(r["tp_model_block"], x[8 * m:8 * m + 8])


@pytest.mark.parametrize("mode", ["replicated", "tensor_parallel"])
def test_param_sharding_blocks_match_jax(ranks, inputs, mode):
    """Each rank's leaves equal JAX's shards on the device at the rank's
    position of a (2, 2) mesh; the split leaves are the wide ones."""
    import jax

    from neuralsim_tpu.parallel.distributed import nerf_param_sharding

    jm = jax_mesh(2, 2, n=4)
    placed = nerf_param_sharding(inputs["full_models"], jm, tensor_parallel=mode != "replicated")
    key = "tp_params" if mode == "tensor_parallel" else "rep_params"
    n_split = 0
    for net_name, leaves in placed.items():
        for name, arr in leaves.items():
            shards = {s.device.id: np.asarray(s.data) for s in arr.addressable_shards}
            for r, res in enumerate(ranks):
                got = res[key][net_name][name]
                np.testing.assert_array_equal(got, shards[r], err_msg=f"{net_name}.{name}")
            n_split += shards[0].shape != arr.shape
    split = ranks[0]["tp_split"]
    if mode == "tensor_parallel":
        assert n_split == len(split) > 0 and "coarse/pts_1_kernel" in split
        assert "coarse/alpha_kernel" not in split and "coarse/rgb_bias" not in split
    else:
        assert n_split == 0


def test_sharded_render_matches_unsharded(ranks, inputs):
    import jax.numpy as jnp

    from neuralsim_tpu import config as jcfg
    from neuralsim_tpu.ops.render import render_ray_batch as jrender

    models = params_from_numpy(inputs["models"], "cpu")
    base = render_ray_batch(models, torch.from_numpy(inputs["rays_o"]),
                            torch.from_numpy(inputs["rays_d"]), net(),
                            tcfg.RenderConfig(**RC_KW))["rgb_map"].numpy()
    jbase = np.asarray(jrender(inputs["models"], jnp.asarray(inputs["rays_o"]),
                               jnp.asarray(inputs["rays_d"]), None,
                               jcfg.NeRFNetConfig(**NET_KW), jcfg.RenderConfig(**RC_KW))["rgb_map"])
    assert base.std() > 1e-3
    for r in ranks:
        assert r["render"].shape == (N_RAYS, 3)
        np.testing.assert_allclose(r["render"], base, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(r["render"], jbase, rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(r["render"], ranks[0]["render"])


def _leaves(params):
    return {f"{n}.{k}": np.asarray(v) for n in sorted(params) for k, v in params[n].items()}


def test_sharded_train_step_matches_unsharded(ranks, inputs):
    import jax

    from neuralsim_tpu import config as jcfg
    from neuralsim_tpu.train_nerf import train_step as jstep

    rc, tc = tcfg.RenderConfig(**RC_KW), tcfg.TrainConfig(n_rand=N_TRAIN)
    ro, rd, tgt = (torch.from_numpy(inputs[k]) for k in ("train_o", "train_d", "train_t"))
    s_base, m_base = train_step(inputs["train_state"], ro, rd, tgt, net(), rc, tc)
    js, jm = jstep(inputs["jax_train_state"], inputs["train_o"], inputs["train_d"],
                   inputs["train_t"], jax.random.PRNGKey(2), jcfg.NeRFNetConfig(**NET_KW),
                   jcfg.RenderConfig(**RC_KW), jcfg.TrainConfig(n_rand=N_TRAIN))
    want = _leaves(s_base.params)
    jwant = _leaves(jax.tree_util.tree_map(np.asarray, js.params))
    first = _leaves(ranks[0]["train"][0])
    moved = max(float(np.abs(want[k] - _leaves(inputs["train_state"].params)[k]).max())
                for k in want)
    assert moved > 1e-5
    for r in ranks:
        params, metrics = r["train"]
        np.testing.assert_allclose(float(metrics["loss"]), float(m_base["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(metrics["psnr"]), float(m_base["psnr"]), rtol=1e-4)
        got = _leaves(params)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-3, atol=2e-5, err_msg=k)
            np.testing.assert_allclose(got[k], jwant[k], rtol=2e-3, atol=2e-5, err_msg=k)
            np.testing.assert_array_equal(got[k], first[k], err_msg=k)


def test_sharded_train_step_slices_the_whole_batch_draws(ranks, inputs):
    """With perturb, the ranks draw the step's uniforms for the whole batch
    and slice them: the step equals the unsharded one from the same
    generator (a per-rank draw would give every rank the first rows)."""
    rc = dataclasses.replace(tcfg.RenderConfig(**RC_KW), perturb=True)
    tc = tcfg.TrainConfig(n_rand=N_TRAIN)
    ro, rd, tgt = (torch.from_numpy(inputs[k]) for k in ("train_o", "train_d", "train_t"))
    s_base, m_base = train_step(inputs["train_state"], ro, rd, tgt, net(), rc, tc,
                                torch.Generator().manual_seed(3))
    s_det, _ = train_step(inputs["train_state"], ro, rd, tgt, net(), tcfg.RenderConfig(**RC_KW),
                          tc)
    want, det = _leaves(s_base.params), _leaves(s_det.params)
    assert max(float(np.abs(want[k] - det[k]).max()) for k in want) > 1e-6
    first = _leaves(ranks[0]["train_perturb"][0])
    for r in ranks:
        params, metrics = r["train_perturb"]
        np.testing.assert_allclose(float(metrics["loss"]), float(m_base["loss"]), rtol=1e-4)
        got = _leaves(params)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-3, atol=2e-5, err_msg=k)
            np.testing.assert_array_equal(got[k], first[k], err_msg=k)


def test_tensor_parallel_render_matches_replicated(ranks, inputs):
    import jax.numpy as jnp

    from neuralsim_tpu import config as jcfg
    from neuralsim_tpu.ops.render import render_ray_batch as jrender

    rd = torch.from_numpy(inputs["tp_rays_d"])
    base = render_ray_batch(params_from_numpy(inputs["full_models"], "cpu"),
                            torch.zeros_like(rd), rd, tcfg.NeRFNetConfig(),
                            tcfg.RenderConfig(**TP_RC_KW))["rgb_map"].numpy()
    jbase = np.asarray(jrender(inputs["full_models"], jnp.zeros((N_TP, 3)),
                               jnp.asarray(inputs["tp_rays_d"]), None, jcfg.NeRFNetConfig(),
                               jcfg.RenderConfig(**TP_RC_KW))["rgb_map"])
    for r in ranks:
        assert r["tp_params"]["coarse"]["pts_1_kernel"].shape == (256, 128)
        np.testing.assert_allclose(r["tp_render"], base, rtol=2e-3, atol=1e-5)
        np.testing.assert_allclose(r["tp_render"], jbase, rtol=2e-3, atol=1e-5)


STRIP_TOL = {"categorical": (1e-5, 1e-8), "gaussian": (1e-5, 1e-8), "culled": (1e-4, 2e-8)}


@pytest.mark.parametrize("case", sorted(STRIP_TOL))
def test_mesh_strips_grad_matches_serial(ranks, inputs, case):
    """3 images over the 4-wide data axis (one rank differentiates only a
    padded image with zero grad_E), against the port's serial gradient and
    the JAX package's."""
    import jax.numpy as jnp

    from neuralsim_tpu import config as jcfg
    from neuralsim_tpu.hypergrad import render_grad as jrg
    from neuralsim_tpu.models.nerf import make_sigma_fn as jsigma
    from neuralsim_tpu.ops.occupancy import build_scene_grid as jgrid
    from neuralsim_tpu.sampler.poses import GaussianPoseNoise as JG
    from neuralsim_tpu.sampler.poses import PoseNoise as JP

    serial = port_strips(inputs, case).numpy()
    noise, psi, mode = inputs["strips"][case]
    jnet = jcfg.NeRFNetConfig(**G_NET_KW)
    kw = dict(psi_mode=mode, strip=32)
    if case == "culled":
        kw.update(grid=jgrid(jsigma(inputs["box"]["coarse"], jnet), 1.2, resolution=32),
                  hit_budget=0.5)
    jax_g = np.asarray(jrg.render_grad_psi_strips(
        inputs["box"], jnp.asarray(psi), (JG if mode == "gaussian" else JP)(
            *map(jnp.asarray, noise)), jnp.asarray(inputs["grad_E"]), G_HW, G_HW,
        np.asarray(G_K, np.float32), jnet, jcfg.RenderConfig(**G_RC_KW).test_mode(),
        jcfg.SamplerConfig(), **kw))
    norm = np.linalg.norm(serial)
    assert norm > 1e-4, "vacuous: the gradient is ~0"
    np.testing.assert_allclose(serial, jax_g, rtol=0, atol=1e-4 * norm)
    rtol, atol = STRIP_TOL[case]
    for r in ranks:
        got = r["strips"][case]
        np.testing.assert_allclose(got, serial, rtol=rtol, atol=atol)
        np.testing.assert_array_equal(got, ranks[0]["strips"][case])


def test_dp_inner_step_uses_the_whole_batch_normalizer(ranks, inputs):
    """Two data-parallel steps at batch 4 (one image per rank) against one
    process; the ranks' images hold different numbers of fg anchors."""
    data = dp_data(inputs["det_images"])
    state = detector_state()
    anchors = torch.cat(generate_anchors(DC.image_size, "cpu"), dim=0)
    det, metrics = tt.inner_train(state, (data, torch.tensor(DP_IDX)), DC, anchors)
    trainable, _ = tt.split_trainable(det.params, DC)

    # each rank's fg count, and what a per-rank normalizer would give: the
    # mean of the per-image losses
    _, apply_fn = tt.make_detector_apply(DC)
    fg, local = [], []

    def count(n):
        fg.append(float(n))
        return n

    for i in DP_IDX[0]:
        one = DetBatch(*(x[i:i + 1] for x in data))
        local.append(float(retinanet_loss(apply_fn, state.params, one, anchors, DC,
                                          fg_total=count)[0]))
    whole, _ = retinanet_loss(apply_fn, state.params, DetBatch(*(x[DP_IDX[0]] for x in data)),
                              anchors, DC)
    assert len(set(fg)) == 4 and min(fg) == 0, fg
    assert abs(np.mean(local) - float(whole)) > 0.1 * float(whole)

    for r in ranks:
        params, m, norm = r["dp"]
        np.testing.assert_allclose(m["loss"], metrics["loss"].numpy(), rtol=1e-4)
        np.testing.assert_allclose(m["loss_cls"], metrics["loss_cls"].numpy(), rtol=1e-4)
        for k, v in params.items():
            np.testing.assert_allclose(v, trainable[k].numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=k)
            np.testing.assert_array_equal(v, ranks[0]["dp"][0][k], err_msg=k)
        np.testing.assert_allclose(
            norm, float(torch.cat([v.reshape(-1) for v in trainable.values()]).norm()),
            rtol=1e-6)


def test_dryrun_multichip_cpu():
    from neuralsim_tpu_torch.parallel.dryrun import dryrun_multichip

    results = dryrun_multichip(N_RANKS, "cpu", timeout=TIMEOUT)
    assert [r["local_poses"] for r in results] == [1] * N_RANKS
    assert [r["local_rays"] for r in results] == [16] * N_RANKS
    assert all(r["tp_local_width"] == 128 for r in results)
    assert np.isfinite(results[0]["loss"])
