"""Variants of one driver epoch, the port against the JAX package from one
state with the JAX driver's draws (the setup of tests/test_torch_driver.py):
the exploration floor's chain back to raw psi, a Gaussian psi, an epoch
without the psi optimization, and the nonfinite-gradient guard.
Tolerances as there: grad_psi 1e-3 of its norm, psi after the step 1e-5,
the save_result.txt lines equal."""

import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_driver import (
    GRAD_PSI_TOL,
    PSI_TOL,
    TOL,
    norm_err,
    port_cfg,
    run_pair,
    txt,
)


def assert_epochs_equal(pair):
    jrec, _, jdrv = pair["jax"]
    trec, _, tdrv = pair["port"]
    g, jg = trec["grad_psi"], np.asarray(jrec["grad_psi"])
    assert np.linalg.norm(jg) > 1e-4
    err = norm_err(g, jg)
    print(f"grad_psi {err:.2e} of the norm")
    assert err < GRAD_PSI_TOL
    np.testing.assert_allclose(trec["psi"].numpy(), np.asarray(jrec["psi"]), rtol=0,
                               atol=PSI_TOL)
    assert not np.allclose(trec["psi"].numpy(), pair["state"]["psi"])
    np.testing.assert_allclose(trec["inner_loss"], jrec["inner_loss"], rtol=TOL)
    assert txt(tdrv) == txt(jdrv)


def test_explore_eps_chains_back_to_raw_psi():
    """With an exploration floor the epoch samples, renders and
    differentiates at psi_eff and chains the gradient back through the mix
    map to raw psi."""
    pair = run_pair(port_cfg(explore_eps=0.2))
    assert_epochs_equal(pair)
    # the render saw the mixed logits, not raw psi
    _, tcap, _ = pair["port"]
    assert not np.allclose(tcap["_render"][0][0].numpy(), pair["state"]["psi"])


def test_gaussian_psi_epoch():
    pair = run_pair(port_cfg(psi_mode="gaussian"))
    assert_epochs_equal(pair)
    assert pair["port"][0]["psi"].shape == (2,)
    # a Gaussian psi reports its (mean, std) as it entered the epoch
    np.testing.assert_array_equal(pair["port"][0]["psi_probs"], pair["state"]["psi"])


def test_epoch_without_optimization():
    """optimization=False: the epoch ends after the mAP, psi and its
    optimizer unchanged, one log line."""
    pair = run_pair(port_cfg(optimization=False))
    jrec, _, jdrv = pair["jax"]
    trec, tcap, tdrv = pair["port"]
    assert "grad_psi" not in trec and "grad_psi" not in jrec
    np.testing.assert_array_equal(trec["psi"].numpy(), pair["state"]["psi"])
    np.testing.assert_allclose(trec["psi_probs"], np.asarray(jrec["psi_probs"]), atol=PSI_TOL)
    np.testing.assert_allclose(trec["inner_loss"], jrec["inner_loss"], rtol=TOL)
    assert "_val_grad" not in tcap and "_grad_e" not in tcap
    assert txt(tdrv) == txt(jdrv) and len(txt(tdrv).splitlines()) == 1


def test_nonfinite_grad_psi_is_dropped():
    """A NaN grad_E (a diverged solver) gives a nonfinite grad_psi: the step
    is dropped and logged, psi and the optimizer state carry over."""
    def nan_grad_e(drv, side):
        if side == "jax":
            drv._grad_e_fn = lambda params, renders, *rest: jnp.full(renders.shape, jnp.nan)
        else:
            drv._grad_e = lambda params, renders, *rest: torch.full(renders.shape, torch.nan)

    pair = run_pair(port_cfg(), patch=nan_grad_e)
    jrec, _, jdrv = pair["jax"]
    trec, _, tdrv = pair["port"]
    assert not np.isfinite(trec["grad_psi"]).any()
    np.testing.assert_array_equal(trec["psi"].numpy(), pair["state"]["psi"])
    np.testing.assert_array_equal(trec["psi_opt"].m.numpy(), pair["state"]["psi_opt"]["m"])
    np.testing.assert_array_equal(np.asarray(jrec["psi"]), pair["state"]["psi"])
    lines = txt(tdrv).splitlines()
    assert lines[1] == "epoch: 0epoch 0: nonfinite grad_psi dropped (ihvp_solver=onestep)"
    assert txt(tdrv) == txt(jdrv)
