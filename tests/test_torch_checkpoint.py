"""Checkpoint/resume of the port's driver (neuralsim_tpu_torch/utils/
checkpoint.py, BilevelDriver.run): 2 epochs straight equal 1 epoch + a
resume in a new driver, to the bit on the CPU (psi, its optimizer, the
detector's parameters, momentum and warmup counter, the generator's
stream), mirroring tests/test_driver_resume.py; and a checkpoint the JAX
package's manager wrote in its npz layout resumes in the port through
``bilevel_state_from_jax``."""

import os
import tempfile

import jax
import numpy as np
import pytest
import torch

from neuralsim_tpu.detector import trainer as jt
from neuralsim_tpu.utils.checkpoint import CheckpointManager as JCheckpointManager
from neuralsim_tpu_torch.bilevel import driver as tdriver
from neuralsim_tpu_torch.models.convert_retinanet import params_from_flax
from neuralsim_tpu_torch.utils.checkpoint import CheckpointManager
from tests.test_torch_driver import (
    box_models,
    jax_cfg,
    jax_start_state,
    port_cfg,
    val_arrays,
)
from neuralsim_tpu.bilevel import driver as jdriver


def new_driver(cfg, seed):
    val = tdriver.ValData(*map(torch.from_numpy, val_arrays()))
    return tdriver.BilevelDriver(cfg, box_models(), val, object_class=1,
                                 generator=torch.Generator().manual_seed(seed),
                                 output_dir=tempfile.mkdtemp(), device="cpu")


def assert_states_equal(a, b):
    assert torch.equal(a["psi"], b["psi"])
    for f in ("lr", "step", "m", "v"):
        assert torch.equal(getattr(a["psi_opt"], f), getattr(b["psi_opt"], f)), f
    da, db = a["detector_state"], b["detector_state"]
    assert int(da.step) == int(db.step)
    for k in da.params:
        assert torch.equal(da.params[k], db.params[k]), k
    assert torch.equal(da.opt_state["count"], db.opt_state["count"])
    for k in da.opt_state["trace"]:
        assert torch.equal(da.opt_state["trace"][k], db.opt_state["trace"][k]), k


@pytest.fixture
def one_thread():
    """Bit-equal runs on the CPU take one thread: with several, the double
    backward of grad_E does not sum in a fixed order (the same epoch
    repeated differs in grad_E at ~1e-7 relative)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("optimization", [True, False], ids=["psi_step", "no_psi_step"])
def test_two_epochs_equal_one_plus_resume(tmp_path, optimization, one_thread):
    cfg = port_cfg(optimization=optimization, opt_lr=1e-2)
    straight = new_driver(cfg, seed=0).run(n_epochs=2, save_pngs=False,
                                           checkpoint_dir=str(tmp_path / "a"))
    ckdir = str(tmp_path / "b")
    first = new_driver(cfg, seed=0).run(n_epochs=1, save_pngs=False, checkpoint_dir=ckdir)
    trace = first["detector_state"].opt_state["trace"]
    assert any(bool((t != 0).any()) for t in trace.values()), "momentum is live"
    # a crash: a new driver with another generator resumes from the checkpoint
    resumed = new_driver(cfg, seed=99).run(n_epochs=2, save_pngs=False, checkpoint_dir=ckdir)
    assert [h["epoch"] for h in resumed["history"]] == [1]
    assert int(resumed["detector_state"].step) == 2 * cfg.detector.max_iter
    assert int(resumed["detector_state"].opt_state["count"]) == 2 * cfg.detector.max_iter
    assert_states_equal(resumed, straight)
    np.testing.assert_array_equal(resumed["history"][0]["psi_probs"],
                                  straight["history"][1]["psi_probs"])
    # a resumed run with no epoch left hands back the checkpointed state
    again = new_driver(cfg, seed=5).run(n_epochs=2, save_pngs=False, checkpoint_dir=ckdir)
    assert again["history"] == []
    assert_states_equal(again, resumed)
    if optimization:
        assert not torch.equal(straight["psi"], first["psi"])


def test_manager_keeps_the_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.latest_step() is None and mgr.restore() is None
    for step in range(4):
        mgr.save(step, {"x": torch.full((2,), float(step)), "n": [step, {"k": step}]})
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000002.pt", "ckpt_00000003.pt"]
    assert mgr.latest_step() == 3
    got = mgr.restore()
    assert torch.equal(got["x"], torch.full((2,), 3.0)) and got["n"] == [3, {"k": 3}]
    assert torch.equal(mgr.restore(2)["x"], torch.full((2,), 2.0))


def test_jax_npz_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX driver's state (momentum trace, step, psi optimizer) saved
    by its manager's npz fallback comes back in the port unchanged."""
    cfg = port_cfg()
    jc = jax_cfg(cfg)
    val = val_arrays()
    jdrv = jdriver.BilevelDriver(jc, box_models(), jdriver.ValData(*val),
                                 key=jax.random.PRNGKey(0), output_dir=str(tmp_path / "j"))
    psi, popt, det = jax_start_state(jc)
    mgr = JCheckpointManager(str(tmp_path / "ck"), use_orbax=False)
    mgr.save(4, jdrv._ckpt_state(psi, popt, det, 4))
    assert os.listdir(tmp_path / "ck") == ["ckpt_00000004.npz"]

    port_mgr = CheckpointManager(str(tmp_path / "ck"))
    assert port_mgr.latest_step() == 4 and port_mgr.is_jax_layout(4)
    with pytest.raises(ValueError, match="like"):
        port_mgr.restore(4)

    result = new_driver(cfg, seed=1).run(n_epochs=5, save_pngs=False,
                                         checkpoint_dir=str(tmp_path / "ck"))
    assert result["history"] == []
    np.testing.assert_array_equal(result["psi"].numpy(), np.asarray(psi))
    for f in ("lr", "step", "m", "v"):
        np.testing.assert_array_equal(getattr(result["psi_opt"], f).numpy(),
                                      np.asarray(getattr(popt, f)))
    state = result["detector_state"]
    assert int(state.step) == int(det.step)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, det.params))
    for k in want:
        assert torch.equal(state.params[k], want[k]), k
    trainable, _ = jt.split_trainable(det.params, jc.detector)
    trace = params_from_flax(jax.tree_util.tree_map(
        np.asarray, det.opt_state[1][0].trace))
    assert sorted(state.opt_state["trace"]) == sorted(trace)
    assert len(trace) == len(jax.tree_util.tree_leaves(trainable))
    for k in trace:
        assert torch.equal(state.opt_state["trace"][k], trace[k]), k
    assert int(state.opt_state["count"]) == int(det.opt_state[1][1].count)

    # the next epoch runs from it
    result = new_driver(cfg, seed=1).run(n_epochs=6, save_pngs=False,
                                         checkpoint_dir=str(tmp_path / "ck"))
    assert [h["epoch"] for h in result["history"]] == [5]
    assert CheckpointManager(str(tmp_path / "ck")).latest_step() == 5


def test_bilevel_state_from_jax_rejects_a_foreign_layout(tmp_path):
    cfg = port_cfg()
    jc = jax_cfg(cfg)
    jdrv = jdriver.BilevelDriver(jc, box_models(), jdriver.ValData(*val_arrays()),
                                 key=jax.random.PRNGKey(0), output_dir=str(tmp_path))
    psi, popt, det = jax_start_state(jc)
    tree = jax.tree_util.tree_map(np.asarray, jdrv._ckpt_state(psi, popt, det, 2))
    tree["detector"]["opt_leaves"] = tree["detector"]["opt_leaves"][1:]
    with pytest.raises(ValueError, match="optimizer leaves"):
        tdriver.bilevel_state_from_jax(tree)
