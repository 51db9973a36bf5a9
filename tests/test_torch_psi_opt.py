"""Port parity for the outer-loop psi optimizer
(``neuralsim_tpu_torch.bilevel.psi_opt`` against
``neuralsim_tpu/bilevel/psi_opt.py``) and the bilevel configuration."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_tpu.bilevel import psi_opt as jopt
from neuralsim_tpu.config import BilevelConfig as JBilevel
from neuralsim_tpu_torch.bilevel import psi_opt as topt
from neuralsim_tpu_torch.config import BilevelConfig, NeuralSimConfig


@pytest.mark.parametrize("method", ["sgd", "momentum", "adam", "Adam"])
def test_ten_steps_match_jax(rng, method):
    """Ten steps on the same gradients (the schedule changes lr between
    steps, as bilevel/driver.py does): psi and the state equal JAX's to 1e-6."""
    psi0 = rng.randn(8).astype(np.float32)
    grads = rng.randn(10, 8).astype(np.float32)
    js, jpsi = jopt.psi_optimizer_init(method, 0.05), jnp.asarray(psi0)
    ts, tpsi = topt.psi_optimizer_init(method, 0.05), torch.from_numpy(psi0)
    assert ts.method == js.method and ts.lr.dtype == torch.float32
    for step, g in enumerate(grads):
        lr = jopt.adjust_learning_rate(step + 1, 0.05, 20)
        js, jpsi = jopt.psi_optimizer_update(js._replace(lr=jnp.asarray(lr, jnp.float32)),
                                             jpsi, jnp.asarray(g))
        ts, tpsi = topt.psi_optimizer_update(
            ts._replace(lr=torch.tensor(lr, dtype=torch.float32)), tpsi, torch.from_numpy(g))
        np.testing.assert_allclose(tpsi.numpy(), np.asarray(jpsi), rtol=1e-6, atol=1e-6)
    assert int(ts.step) == int(js.step)
    np.testing.assert_allclose(ts.m.numpy(), np.asarray(js.m), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.v.numpy(), np.asarray(js.v), rtol=1e-6, atol=1e-6)
    assert not np.allclose(tpsi.numpy(), psi0)


def test_adam_bias_corrected_lr_and_eps():
    """One Adam step from zero state: m = (1 - b1) g, v = (1 - b2) g^2 and
    lr_t = lr sqrt(1 - b2) / (1 - b1), so the step is
    lr s g / (s |g| + 1e-7) with s = sqrt(1 - b2): the reference's eps sits
    outside the bias correction."""
    st = topt.psi_optimizer_init("adam", 1e-3, dim=2)
    g = torch.tensor([0.5, -2e-7])
    _, psi = topt.psi_optimizer_update(st, torch.zeros(2), g)
    s = 0.001 ** 0.5
    torch.testing.assert_close(psi, -1e-3 * s * g / (s * g.abs() + 1e-7), rtol=1e-5, atol=0)


def test_adjust_learning_rate_matches_jax():
    for max_epoch in (10, 50):
        for epoch in range(0, max_epoch + 4):
            assert topt.adjust_learning_rate(epoch, 5e-5, max_epoch) == \
                jopt.adjust_learning_rate(epoch, 5e-5, max_epoch), (epoch, max_epoch)
    assert topt.adjust_learning_rate(53, 1.0, 50) == 0.0      # clamped, not ascent
    assert topt.adjust_learning_rate(2, 1.0, 50) == pytest.approx(0.4)


@pytest.mark.parametrize("method", ["sgd", "momentum", "adam"])
def test_state_lives_on_the_given_device(method):
    """The state follows psi's device without being told: a psi on another
    device (here "meta") takes lr, step, m and v there in one update."""
    st = topt.psi_optimizer_init(method, 0.1, dim=2)
    assert st.m.shape == (2,) and st.step.dtype == torch.int32
    st, psi = topt.psi_optimizer_update(st, torch.zeros(2, device="meta"),
                                        torch.ones(2, device="meta"))
    assert psi.device.type == "meta"
    assert all(t.device.type == "meta" for t in (st.lr, st.step, st.m, st.v))
    with pytest.raises(KeyError):
        topt.psi_optimizer_init("rmsprop", 0.1)


def test_bilevel_config_matches_jax():
    """BilevelConfig has the JAX package's fields and defaults (the
    gradient reads grad_compute_dtype = "bfloat16", grad_ray_chunk = 5000),
    and NeuralSimConfig carries it."""
    # grad_dynamic_start only shapes XLA compilation (a traced strip offset,
    # the same math) and has no counterpart in eager PyTorch
    want = {f.name: getattr(JBilevel(), f.name) for f in dataclasses.fields(JBilevel)
            if f.name != "grad_dynamic_start"}
    got = {f.name: getattr(BilevelConfig(), f.name) for f in dataclasses.fields(BilevelConfig)}
    assert got == want
    assert NeuralSimConfig().bilevel == BilevelConfig()
    assert BilevelConfig().grad_compute_dtype == "bfloat16"
