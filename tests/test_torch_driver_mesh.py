"""The port's bilevel driver on a mesh of 4 gloo ranks (``BilevelDriver(
mesh=)``) against its single-process epoch and the JAX driver's
single-device epoch, from one state with the JAX draws.

The configuration is tests/test_driver_mesh.py's: a 2x16 NeRF pair at
32x32, K = 3 poses (padded to 4 on the 4-wide data axis), RetinaNet at
32^2 with 2 inner steps at batch 8 (2 images per rank, data-parallel),
onestep inverse HVP, float32 strips over grad_e_max_images = 2 images
(padded to 4, one per rank). Three things differ, so that the gradient
is not vacuous and the psi check means what it meant there: the NeRF pair
is the box scene (a random init renders no density there and every psi
gradient is exactly zero), the Gumbel temperature is 1.0 (at 0.1 the soft
sample saturates), and the psi learning rate is 1e-8: the gradient is then
~1e5 (~0 in the JAX test), and at its 1e-3 the step would move psi by
~1e2, so psi's rtol 1e-5 would hold the gradient to 1e-5 instead of its
own 2e-3; at 1e-8 the step moves psi by ~1e-3. The tolerances are
tests/test_driver_mesh.py's (:96-120): grad_psi rtol 2e-3 / atol 2e-6, psi
rtol 1e-5 / atol 1e-7, inner loss rtol 1e-3, mAP rtol 1e-2 / atol 1e-3.

The ranks import this module, so JAX and the JAX package are imported
inside the functions that run here, never at the top.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from neuralsim_tpu_torch import config as tcfg
from neuralsim_tpu_torch.bilevel import driver as tdriver
from neuralsim_tpu_torch.parallel import launch as tlaunch
from neuralsim_tpu_torch.parallel import mesh as tmesh

N_RANKS = 4
TIMEOUT = 400.0
NET_KW = dict(netdepth=2, netwidth=16, netdepth_fine=2, netwidth_fine=16, skips=(0,),
              multires=2, multires_views=1)


def port_cfg() -> tcfg.NeuralSimConfig:
    return tcfg.NeuralSimConfig(
        net=tcfg.NeRFNetConfig(**NET_KW),
        render=tcfg.RenderConfig(n_samples=4, n_importance=4, ray_chunk=1024, near=0.5,
                                 far=2.0),
        camera=tcfg.CameraConfig(height=32, width=32, focal=40.0, fx=40.0, fy=40.0, cx=16.0,
                                 cy=16.0),
        sampler=tcfg.SamplerConfig(n_samples_k=3, gumbel_temperature=1.0),
        detector=tcfg.DetectorConfig(num_classes=2, image_size=32, max_iter=2,
                                     images_per_batch=8, warmup_iters=1),
        bilevel=tcfg.BilevelConfig(n_epochs=1, opt_lr=1e-8, opt_method="momentum",
                                   grad_compute_dtype="float32", psi_pose_cats_mode="uniform",
                                   ihvp_solver="onestep", grad_e_max_images=2),
        data=tcfg.DataConfig(save_pngs=False))


def summary(drv, record, renders) -> dict:
    """What the tests compare of one epoch."""
    trainable = {k: v for k, v in record["detector_state"].params.items()
                 if not k.startswith("backbone.")}
    return {"psi": record["psi"], "grad_psi": record["grad_psi"],
            "inner_loss": record["inner_loss"], "map": record["map"],
            "psi_probs": record["psi_probs"], "renders": renders,
            "det": torch.cat([trainable[k].reshape(-1) for k in sorted(trainable)]),
            "writes": drv.writes}


def run_port(cfg, models, val, state_path, draws, output_dir, mesh=None) -> dict:
    """One port epoch from the saved state with the given draws."""
    drv = tdriver.BilevelDriver(cfg, models, tdriver.ValData(*map(torch.from_numpy, val)),
                                object_class=0, output_dir=output_dir, device="cpu", mesh=mesh)
    seen = {}
    render = drv._render

    def kept(*args):
        out = render(*args)
        seen["renders"] = out[0]
        return out

    drv._render = kept
    psi, popt, det, _ = torch.load(state_path, weights_only=False)
    record = drv.run_epoch(0, psi, popt, det, draws=draws)
    return summary(drv, record, seen["renders"])


def _rank(cfg, models, val, state_path, draws, output_dir):
    torch.manual_seed(0)
    return run_port(cfg, models, val, state_path, draws, output_dir,
                    tmesh.make_mesh(device="cpu"))


@pytest.fixture(scope="module")
def epochs():
    import jax
    import jax.numpy as jnp

    from bench import box_scene_params as jax_box_scene
    from neuralsim_tpu import config as jcfg
    from neuralsim_tpu.bilevel import driver as jdriver
    from neuralsim_tpu.detector.dataset import build_detector_batches
    from tests.test_torch_driver import jax_cfg, jax_draws, jax_start_state

    torch.set_num_threads(2)
    cfg = port_cfg()
    jc = jax_cfg(cfg)
    box = {k: np.array(v) for k, v in
           jax_box_scene(jcfg.NeRFNetConfig(**NET_KW), jax.random.PRNGKey(0), half=0.12).items()}
    models = {"coarse": box, "fine": box}
    val_imgs = np.zeros((2, 32, 32, 3), np.float32)
    val_imgs[0, 8:20, 8:20] = 0.9
    val_imgs[1, 12:28, 4:16] = 0.7
    val = tuple(np.asarray(x) for x in build_detector_batches(val_imgs, [0, 1], jc.detector))

    key = jax.random.PRNGKey(0)
    jdrv = jdriver.BilevelDriver(jc, models, jdriver.ValData(*map(jnp.asarray, val)), key=key,
                                 object_class=0, output_dir=tempfile.mkdtemp())
    seen = {}
    do_render = jdrv._do_render

    def kept(*args):
        seen["renders"] = do_render(*args)
        return seen["renders"]

    jdrv._do_render = kept
    psi, popt, det = jax_start_state(jc)
    state = jax.tree_util.tree_map(np.asarray, jdrv._ckpt_state(psi, popt, det, 0))
    jrec = jdrv.run_epoch(0, psi, popt, det, save_pngs=False)
    draws = jax_draws(jc, key, cfg.sampler.n_samples_k)

    tmp = tempfile.mkdtemp()
    state_path = os.path.join(tmp, "state.pt")
    torch.save(tdriver.bilevel_state_from_jax(state, cfg.bilevel.opt_method), state_path)
    single = run_port(cfg, models, val, state_path, draws, os.path.join(tmp, "single"))
    mesh_dir = os.path.join(tmp, "mesh")
    ranks = tlaunch.launch(_rank, N_RANKS, (cfg, models, val, state_path, draws, mesh_dir),
                           device="cpu", timeout=TIMEOUT, threads=1)
    with open(os.path.join(mesh_dir, "save_result.txt")) as f:
        lines = f.read().splitlines()
    return {"jax": jrec, "jax_renders": np.asarray(seen["renders"][0]), "single": single,
            "ranks": ranks, "mesh_lines": lines, "psi0": np.asarray(psi)}


def assert_epoch_close(got, want_psi, want_grad, want_loss, want_map):
    np.testing.assert_allclose(got["grad_psi"], want_grad, rtol=2e-3, atol=2e-6)
    np.testing.assert_allclose(got["psi"], want_psi, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got["inner_loss"], want_loss, rtol=1e-3)
    assert got["map"].keys() == want_map.keys()
    for k, v in want_map.items():
        if isinstance(v, float) and np.isfinite(v):
            np.testing.assert_allclose(got["map"][k], v, rtol=1e-2, atol=1e-3, err_msg=k)


def test_mesh_epoch_matches_single_process(epochs):
    one = epochs["single"]
    g = np.asarray(one["grad_psi"])
    assert np.linalg.norm(g) > 1e3 * 2e-6, "vacuous: grad_psi is ~0"
    step = np.abs(one["psi"].numpy() - epochs["psi0"]).max()
    assert step > 1e2 * (1e-5 * np.abs(epochs["psi0"]).max() + 1e-7), "psi did not move"
    assert one["renders"].shape == (3, 32, 32, 3) and one["renders"].max() > 0.1
    for r in epochs["ranks"]:
        assert r["renders"].shape == (3, 32, 32, 3)
        np.testing.assert_allclose(r["renders"], one["renders"].numpy(), rtol=0, atol=1e-6)
        assert_epoch_close(r, one["psi"].numpy(), g, one["inner_loss"], one["map"])
        np.testing.assert_allclose(r["det"], one["det"].numpy(), rtol=1e-4, atol=1e-7)


def test_mesh_epoch_matches_jax(epochs):
    jrec = epochs["jax"]
    for r in epochs["ranks"]:
        np.testing.assert_allclose(r["renders"], epochs["jax_renders"], rtol=0, atol=1e-4)
        assert_epoch_close(r, np.asarray(jrec["psi"]), np.asarray(jrec["grad_psi"]),
                           float(jrec["inner_loss"]), jrec["map"])


def test_ranks_agree_to_the_bit(epochs):
    first = epochs["ranks"][0]
    for r in epochs["ranks"][1:]:
        for k in ("psi", "grad_psi", "renders", "det", "psi_probs"):
            np.testing.assert_array_equal(r[k], first[k], err_msg=k)
        assert r["inner_loss"] == first["inner_loss"]


def test_only_the_first_rank_writes(epochs):
    assert [r["writes"] for r in epochs["ranks"]] == [True, False, False, False]
    heads = [line[:9] for line in epochs["mesh_lines"] if line.startswith("epoch: ")]
    assert heads == ["epoch: 0{", "epoch: 0t"]
