"""Differentiating the port's inner fine-tune (neuralsim_tpu_torch/detector/
trainer.py) through its whole trajectory, against ``jax.grad`` of the JAX
package's ``inner_train``: the gradient the unrolled hypergradient needs.

f(train images, initial trainable parameters) is the detector loss, on a
fixed val batch, of the parameters after 2 inner steps (indexed form,
JAX's index array, frozen backbone), differentiated by the images and the
initial parameters, or by the images alone (the parameters then carry no
graph and the steps must keep the images'). The port runs with and
without ``remat`` (a ``torch.utils.checkpoint`` per step, which recomputes
a step whose backward takes a second-order graph). LR 5e-3, as the JAX
package's unrolled tests use: the trajectory then carries all of the
images' gradient (they reach f only through the SGD updates) and 86% of
the initial parameters' (the rest is d f / d final parameters).

Tolerances: f 1e-4 relative (as the losses of the inner steps); remat
against no remat 1e-6 of the norm (the same arithmetic, recomputed);
each gradient (the parameters' as one vector) 3e-2 of the JAX gradient's
norm (the difference's norm). The last is set by ReLU kinks, not by
rounding: a pre-activation within float32 rounding of zero takes another
side in another float32 program, and a second derivative sees it. Here
one unit of the head tower does so: it moves the images' gradient by
1.0% and the parameters' by 1.1%, and a 1e-6 relative change of the
images moves the port's by the same amounts. A step that drops its graph
misses by 86% or more: the test asserts that margin.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_tpu.detector import trainer as jt
from neuralsim_tpu.models import retinanet as jr
from neuralsim_tpu_torch.config import DetectorConfig
from neuralsim_tpu_torch.detector import trainer as tt
from neuralsim_tpu_torch.models import retinanet as tr
from neuralsim_tpu_torch.models.convert_retinanet import params_from_flax
from tests.test_torch_retinanet import carried_params, jdc_of, loss_batch

DC = DetectorConfig(num_classes=2, image_size=32, images_per_batch=2, warmup_iters=1,
                    base_lr=5e-3)
IDX = np.array([[0, 1], [2, 0]], np.int32)                     # JAX's index array
GRAD_TOL = 3e-2


def data():
    return (loss_batch(np.random.RandomState(21), n=3, size=32, num_classes=2),
            loss_batch(np.random.RandomState(22), n=2, size=32, num_classes=2))


def flat(grads: dict):
    return torch.cat([grads[k].reshape(-1) for k in sorted(grads)])


@functools.lru_cache(maxsize=1)
def jax_grads():
    jdc = jdc_of(DC)
    _, flax = carried_params(DC)
    (images, *gt), val = data()
    val = jr.DetBatch(*(jnp.asarray(x) for x in val))
    trainable0, frozen = jt.split_trainable(flax, jdc)
    anchors = jnp.concatenate(jr.generate_anchors(DC.image_size), axis=0)
    opt = jt.make_detector_optimizer(jdc)

    def f(imgs, tp):
        state = jt.DetectorState(jt.merge_params(tp, frozen), opt.init(tp),
                                 jnp.zeros((), jnp.int32))
        dataset = jr.DetBatch(imgs, *(jnp.asarray(x) for x in gt))
        final, _ = jt.inner_train(state, (dataset, IDX), jdc, anchors, remat=True)
        return jt.detector_loss_fn(final.params, val, jdc, anchors)

    value, (g_img, g_tp) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(
        jnp.asarray(images), trainable0)
    g_tp = params_from_flax(jax.tree_util.tree_map(np.asarray, g_tp))
    return float(value), np.array(g_img), g_tp


def port_grads(remat: bool, by_params: bool):
    """(f, d f / d images, d f / d initial trainable, d f / d final
    trainable, final state) of the port; the parameter gradients are None
    when only the images are differentiated."""
    port, _ = carried_params(DC)
    (images, *gt), val = data()
    trainable0, frozen = tt.split_trainable(port, DC)
    if by_params:
        trainable0 = {k: v.clone().requires_grad_() for k, v in trainable0.items()}
    images = torch.as_tensor(images).requires_grad_()
    dataset = tr.DetBatch(images, *(torch.as_tensor(x) for x in gt))
    state = tt.DetectorState(tt.merge_params(trainable0, frozen),
                             tt.make_detector_optimizer(DC).init(trainable0),
                             torch.zeros((), dtype=torch.int32))
    anchors = torch.cat(tr.generate_anchors(DC.image_size), dim=0)
    final, _ = tt.inner_train(state, (dataset, torch.as_tensor(IDX)), DC, anchors,
                              remat=remat)
    f = tt.detector_loss_fn(final.params, tr.DetBatch(*(torch.as_tensor(x) for x in val)),
                            DC, anchors)
    names = sorted(trainable0)
    if not by_params:
        (g_img,) = torch.autograd.grad(f, [images])
        return float(f.detach()), g_img, None, None, final
    g_img, *g = torch.autograd.grad(
        f, [images] + [trainable0[k] for k in names] + [final.params[k] for k in names])
    return (float(f.detach()), g_img, flat(dict(zip(names, g[:len(names)]))),
            flat(dict(zip(names, g[len(names):]))), final)


def close(got, want, tol):
    return bool(torch.linalg.norm(got - want) <= tol * torch.linalg.norm(want))


@pytest.mark.parametrize("by", ["images_and_params", "images"])
def test_trajectory_gradient_equals_jax(by):
    want_f, want_img, want_tp = jax_grads()
    want_img = torch.as_tensor(want_img)
    assert torch.linalg.norm(want_img) > 0
    by_params = by == "images_and_params"
    runs = {remat: port_grads(remat, by_params) for remat in (False, True)}
    for remat, (f, g_img, g_tp, direct, final) in runs.items():
        np.testing.assert_allclose(f, want_f, rtol=1e-4)
        assert close(g_img, want_img, GRAD_TOL), remat
        if by_params:
            want = flat({k: want_tp[k] for k in tt.split_trainable(want_tp, DC)[0]})
            assert close(g_tp, want, GRAD_TOL), remat
            # the trajectory's share exceeds the tolerance many times over
            assert not close(direct, want, 10 * GRAD_TOL)
        # the frozen backbone stays where it was, and carries no graph
        for k, v in tt.split_trainable(final.params, DC)[1].items():
            assert not v.requires_grad, k
    (f0, img0, tp0, _, _), (f1, img1, tp1, _, _) = runs[False], runs[True]
    assert f0 == f1 and close(img1, img0, 1e-6)
    assert not by_params or close(tp1, tp0, 1e-6)
