"""Parity of the port's inner fine-tune (neuralsim_tpu_torch/detector/
trainer.py) with the JAX package's: 3 steps of inner_train from the same
weights with JAX's index array, in the stacked and the indexed forms,
with freeze_backbone True and False and with remat (against JAX's
indexed form with remat, which the JAX package's own tests hold equal to
its stacked form).

Tolerances: per-step losses 1e-4 relative; each trainable parameter 1e-4
of its norm, and the whole update (final - initial) 1e-3 of its norm; the
frozen subtree is bit-equal to where it started. Also the config fields,
auto_scale_config, cycle_indices and the device rule of the entry points.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_tpu.config import DetectorConfig as JDC
from neuralsim_tpu.config import NeuralSimConfig as JNeuralSimConfig
from neuralsim_tpu.detector import trainer as jt
from neuralsim_tpu.models import retinanet as jr
from neuralsim_tpu_torch.config import DetectorConfig, NeuralSimConfig
from neuralsim_tpu_torch.detector import dataset as tds
from neuralsim_tpu_torch.detector import trainer as tt
from neuralsim_tpu_torch.models import retinanet as tr
from neuralsim_tpu_torch.models.convert_retinanet import params_from_flax
from tests.test_torch_retinanet import (
    UNPORTED_FIELDS,
    carried_params,
    jdc_fields,
    jdc_of,
    loss_batch,
)

DC = DetectorConfig(num_classes=3, image_size=64, images_per_batch=2, warmup_iters=2)


def dataset():
    return loss_batch(np.random.RandomState(11), n=4)


IDX = np.array([[0, 1], [2, 3], [3, 0]], np.int32)             # JAX's index array


@functools.lru_cache(maxsize=2)
def jax_run(freeze: bool):
    """JAX's 3 indexed-form steps with remat (the JAX package's own tests
    hold its stacked form equal to this, and remat changes no value)."""
    jdc = jdc_of(dataclasses.replace(DC, freeze_backbone=freeze))
    _, flax = carried_params(DC)
    opt = jt.make_detector_optimizer(jdc)
    state = jt.DetectorState(flax, opt.init(jt.split_trainable(flax, jdc)[0]),
                             jnp.zeros((), jnp.int32))
    state, metrics = jax.jit(lambda s, d, i: jt.inner_train(s, (d, i), jdc, remat=True))(
        state, jr.DetBatch(*(jnp.asarray(x) for x in dataset())), IDX)
    return jax.tree_util.tree_map(np.asarray, (state, metrics))


@pytest.mark.parametrize("form,freeze,remat", [
    ("stacked", True, False), ("indexed", True, True), ("indexed", False, False)])
def test_inner_train_equals_jax(form, freeze, remat):
    dc = dataclasses.replace(DC, freeze_backbone=freeze)
    port, _ = carried_params(DC)
    want_state, want = jax_run(freeze)
    tstate = tt.init_detector(torch.Generator().manual_seed(0), dc, device="cpu")
    tstate = tt.DetectorState(port, tstate.opt_state, tstate.step)
    tdata = tr.DetBatch(*(torch.as_tensor(x) for x in dataset()))
    idx = torch.as_tensor(IDX).long()
    if form == "stacked":
        tbatches = tr.DetBatch(*(x[idx] for x in tdata))
    else:
        tbatches = (tdata, idx)
    got_state, got = tt.inner_train(tstate, tbatches, dc, remat=remat)

    for k in ("loss", "loss_cls", "loss_box_reg"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-4)
    assert int(got_state.step) == int(want_state.step) == 3
    assert int(got_state.opt_state["count"]) == 3
    want_params = params_from_flax(want_state.params)
    trainable, frozen = tt.split_trainable(got_state.params, dc)
    assert bool(frozen) == freeze and (not freeze or "backbone.stem_conv.weight" in frozen)
    for k, v in frozen.items():
        assert torch.equal(v, port[k]) and torch.equal(want_params[k], port[k]), k
    du, dw = [], []
    for k, v in trainable.items():
        w = want_params[k]
        assert torch.linalg.norm(v - w) <= 1e-4 * torch.linalg.norm(w) + 1e-12, k
        du.append((v - port[k]).reshape(-1))
        dw.append((w - port[k]).reshape(-1))
    du, dw = torch.cat(du), torch.cat(dw)
    assert torch.linalg.norm(dw) > 0
    assert torch.linalg.norm(du - dw) <= 1e-3 * torch.linalg.norm(dw)
    # the momentum buffers equal optax's trace
    trace = params_from_flax(want_state.opt_state[1][0].trace)
    for k, v in got_state.opt_state["trace"].items():
        assert torch.linalg.norm(v - trace[k]) <= 1e-3 * torch.linalg.norm(trace[k]) + 1e-12, k


def test_schedule_and_optimizer_arithmetic():
    """The optimizer on plain tensors against optax, bit for bit, through
    the warmup and after it."""
    dc = dataclasses.replace(DC, warmup_iters=3)
    rng = np.random.RandomState(5)
    p = {"a": rng.randn(4, 3).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    opt_j = jt.make_detector_optimizer(jdc_of(dc))
    opt_t = tt.make_detector_optimizer(dc)
    sj, st = opt_j.init(p), opt_t.init({k: torch.as_tensor(v) for k, v in p.items()})
    pj, pt = dict(p), {k: torch.as_tensor(v) for k, v in p.items()}
    for step in range(5):
        g = {k: rng.randn(*v.shape).astype(np.float32) for k, v in p.items()}
        upd, sj = opt_j.update(g, sj, pj)
        pj = jax.tree_util.tree_map(lambda a, b: a + b, pj, upd)
        pt, st = opt_t.update({k: torch.as_tensor(v) for k, v in g.items()}, st, pt)
        for k in p:
            np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), rtol=1e-6, atol=1e-7)
    assert int(st["count"]) == 5


def test_config_fields_equal_jax():
    want = {f.name: getattr(JDC(), f.name) for f in dataclasses.fields(JDC)
            if f.name not in UNPORTED_FIELDS}
    got = {f.name: getattr(DetectorConfig(), f.name) for f in dataclasses.fields(DetectorConfig)}
    assert got == want
    assert NeuralSimConfig().detector == DetectorConfig()
    assert jdc_fields(JNeuralSimConfig().detector) == dataclasses.asdict(
        NeuralSimConfig().detector)


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_auto_scale_config_equals_jax(world):
    dc = DetectorConfig()
    assert dataclasses.asdict(tt.auto_scale_config(dc, world)) == jdc_fields(
        jt.auto_scale_config(JDC(), world))


def test_cycle_indices_permutations():
    gen = torch.Generator().manual_seed(7)
    n, steps, batch = 5, 7, 3
    idx = tt.cycle_indices(n, steps, batch, gen)
    assert idx.shape == (steps, batch) and idx.dtype == torch.int64
    flat = idx.reshape(-1).tolist()
    for start in range(0, len(flat) - n + 1, n):      # every pass is a permutation
        assert sorted(flat[start:start + n]) == list(range(n))
    assert sorted(flat[(len(flat) // n) * n:]) == sorted(set(flat[(len(flat) // n) * n:]))
    assert torch.equal(idx, tt.cycle_indices(n, steps, batch, torch.Generator().manual_seed(7)))
    assert not torch.equal(idx, tt.cycle_indices(n, steps, batch,
                                                 torch.Generator().manual_seed(8)))
    images = torch.arange(n, dtype=torch.float32)[:, None, None, None].expand(n, 2, 2, 3)
    b = tt.cycle_batches(images, torch.zeros(n, 1, 4), torch.zeros(n, 1), torch.ones(n, 1),
                         steps, batch, torch.Generator().manual_seed(7))
    assert torch.equal(b.images[:, :, 0, 0, 0].long(), idx)


def test_entry_points_raise_without_a_gpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the entry points run on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tt.init_detector(torch.Generator(), DC)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tds.build_detector_batches_device(np.zeros((1, 8, 8, 3), np.float32), [0], DC)
    # CPU tensors run where they are
    inputs, boxes, labels, valid = tds.build_detector_batches_device(
        torch.zeros(1, 8, 8, 3), [0], DC)
    assert inputs.device.type == "cpu" and not valid.any()
