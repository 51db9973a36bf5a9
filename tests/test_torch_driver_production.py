"""The port's driver on the production render (occupancy grid, culled
single-pass march), against the JAX driver from one state with its draws
(the setup of tests/test_torch_driver.py): the grid's calibrated budget,
a whole epoch with the culled strips gradient, the first epoch's PSNR
guard and the budget-overflow guard (its containment, and the port's own
epochs on the CPU, are in tests/test_torch_driver_epochs.py)."""

import dataclasses

import numpy as np
import pytest

from tests.test_torch_driver import (
    GRAD_PSI_TOL,
    PSI_TOL,
    TOL,
    norm_err,
    port_cfg,
    run_pair,
    txt,
)

PRODUCTION = dict(hit_budget=0.25, tighten_bounds=True, n_samples_culled=8,
                  n_importance_culled=0)


def production_cfg(**bilevel):
    return port_cfg(render=PRODUCTION, **bilevel)


@pytest.fixture(scope="module")
def production_pair():
    return run_pair(production_cfg())


def test_production_epoch_equals_jax(production_pair):
    jrec, jcap, jdrv = production_pair["jax"]
    trec, tcap, tdrv = production_pair["port"]
    assert tdrv.grid is not None and tdrv.rc_test.hit_budget < 1.0
    for g, w in zip(tdrv.grid, jdrv.grid):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    renders = tcap["_render"][1][0].numpy()
    np.testing.assert_allclose(renders, np.asarray(jcap["_do_render"][1][0]), rtol=0, atol=TOL)
    hit, budget = tcap["_render"][1][1].tolist()
    assert hit <= budget and hit == int(np.asarray(jcap["_do_render"][1][1]).sum())
    ge, jge = tcap["_grad_e"][1].numpy(), np.asarray(jcap["_grad_e_fn"][1])
    assert norm_err(ge, jge) < TOL
    g, jg = trec["grad_psi"], np.asarray(jrec["grad_psi"])
    assert np.linalg.norm(jg) > 1e-4
    assert norm_err(g, jg) < GRAD_PSI_TOL
    np.testing.assert_allclose(trec["psi"].numpy(), np.asarray(jrec["psi"]), rtol=0,
                               atol=PSI_TOL)
    assert txt(tdrv) == txt(jdrv)


def test_first_epoch_cull_guard_psnr(production_pair):
    """Epoch 0 renders 2 poses exactly and compares: the PSNR of the culled
    renders against them within 0.01 dB of the JAX driver's. (The test's
    production render takes 8 samples per ray against the exact 8 + 8, so
    it sits below the guard's 40 dB warning on both sides.)"""
    _, _, jdrv = production_pair["jax"]
    _, _, tdrv = production_pair["port"]
    print(f"cull guard: port {tdrv.last_cull_psnr:.4f} dB, JAX {jdrv.last_cull_psnr:.4f} dB")
    assert np.isfinite(tdrv.last_cull_psnr)
    assert abs(tdrv.last_cull_psnr - jdrv.last_cull_psnr) < 0.01


def test_occ_budget_guard_equals_jax(production_pair):
    """_check_occ_budget on the same counts: under budget a no-op, an
    overflow raises the budget by the same rule (clamped at 1)."""
    _, _, jdrv = production_pair["jax"]
    _, _, tdrv = production_pair["port"]
    rc_j, rc_t = jdrv.rc_test, tdrv.rc_test
    try:
        for hit, budget, start in ((10, 100, None), (150, 100, 0.25), (10 ** 6, 100, 0.25),
                                   (10 ** 6, 10 ** 6, 0.25), (120, 100, 0.95)):
            if start is not None:
                jdrv.rc_test = dataclasses.replace(rc_j, hit_budget=start)
                tdrv.rc_test = dataclasses.replace(rc_t, hit_budget=start)
            want = jdrv._check_occ_budget(hit, budget)
            assert tdrv._check_occ_budget(hit, budget) == want
            assert tdrv.rc_test.hit_budget == jdrv.rc_test.hit_budget
    finally:
        jdrv.rc_test, tdrv.rc_test = rc_j, rc_t
