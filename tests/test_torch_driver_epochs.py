"""The port's driver epochs on the production render (the setup of
tests/test_torch_driver.py): the budget-overflow guard's containment
against the JAX driver from one state with its draws, then one influence
epoch (cg_normal) and one unrolled epoch of the port alone on the CPU."""

import dataclasses
import tempfile

import numpy as np
import pytest
import torch

from neuralsim_tpu_torch.bilevel import driver as tdriver
from neuralsim_tpu_torch.bilevel.psi_init import psi_init
from neuralsim_tpu_torch.bilevel.psi_opt import psi_optimizer_init
from neuralsim_tpu_torch.detector.trainer import init_detector
from neuralsim_tpu_torch.ops.render import render_poses
from tests.test_torch_driver import TOL, box_models, run_pair, val_arrays
from tests.test_torch_driver_production import production_cfg


def test_occ_overflow_epoch_is_contained():
    """A budget far below the hit fraction: the epoch renders again with the
    raised budget before the detector sees it, on both sides alike."""
    def sabotage(drv, side):
        drv.rc_test = dataclasses.replace(drv.rc_test, hit_budget=0.05)
        if side == "jax":
            drv._build_render_fn()

    pair = run_pair(production_cfg(optimization=False), patch=sabotage)
    jrec, jcap, jdrv = pair["jax"]
    trec, tcap, tdrv = pair["port"]
    assert tdrv.rc_test.hit_budget > 0.05
    assert tdrv.rc_test.hit_budget == jdrv.rc_test.hit_budget
    hit, budget = tcap["_render"][1][1].tolist()
    assert hit <= budget
    np.testing.assert_allclose(tcap["_render"][1][0].numpy(),
                               np.asarray(jcap["_do_render"][1][0]), rtol=0, atol=TOL)
    np.testing.assert_allclose(trec["inner_loss"], jrec["inner_loss"], rtol=TOL)


def port_driver(cfg):
    val = tdriver.ValData(*map(torch.from_numpy, val_arrays()))
    return tdriver.BilevelDriver(cfg, box_models(), val, object_class=1,
                                 output_dir=tempfile.mkdtemp(), device="cpu")


@pytest.mark.parametrize("mode", ["influence", "unrolled"])
def test_port_epoch_on_the_cpu(mode):
    """One epoch of the port alone on the CPU (its own draws): influence
    with the cg_normal solver, and the unrolled hypergradient. grad_psi is
    finite and nonzero, psi moves, the probabilities sum to 1; the
    unrolled epoch's grad_E is unrolled_grad_images on the epoch's renders,
    from the pre-train state, on the epoch's schedule."""
    cfg = production_cfg(hypergrad_mode=mode, ihvp_solver="cg_normal", cg_iters=2)
    drv = port_driver(cfg)
    seen = {}
    unrolled = drv._unrolled

    def spy(state0, renders, labels, batch_idx):
        seen["args"] = (state0, renders, labels, batch_idx)
        seen["out"] = unrolled(state0, renders, labels, batch_idx)
        return seen["out"]

    drv._unrolled = spy
    psi = psi_init("5")
    det = init_detector(torch.Generator().manual_seed(3), cfg.detector, device="cpu")
    popt = psi_optimizer_init("momentum", 1e-1)
    draws = drv.draw_epoch()
    rec = drv.run_epoch(0, psi, popt, det, draws=draws)
    g = rec["grad_psi"]
    assert g.shape == (8,) and np.isfinite(g).all() and np.abs(g).max() > 0
    assert not np.allclose(rec["psi"].numpy(), psi.numpy())
    np.testing.assert_allclose(rec["psi_probs"].sum(), 1.0, rtol=1e-5)
    stages = drv.phases.report()
    hyper = "unrolled_grad_E" if mode == "unrolled" else "inverse_hvp"
    assert {"render", "build_dataset", "inner_train", "inference", hyper,
            "render_grad"} <= set(stages)
    if mode == "unrolled":
        state0, renders, labels, batch_idx = seen["args"]
        assert state0 is det and torch.equal(batch_idx, draws.batch_idx)
        assert labels == [1] * 3
        with torch.no_grad():
            poses = tdriver.psi_poses(psi, draws.noise, cfg.sampler)
            want = render_poses(drv.nerf_models, poses, 24, 24, cfg.camera.K, cfg.net,
                                drv.rc_test, grid=drv.grid, device="cpu")["rgb_map"]
        torch.testing.assert_close(renders, want, rtol=0, atol=0)
        assert seen["out"].shape == (3, 24, 24, 3) and torch.isfinite(seen["out"]).all()
    else:
        assert "args" not in seen
