"""The port's unrolled hypergradient (neuralsim_tpu_torch/hypergrad/
unrolled.py) against the JAX package's ``unrolled_grad_images``, on the
textured setup of tests/test_unrolled.py (3 textured objects on a zero
background, 2 val images, 3 inner steps at batch 2, LR 5e-3) from the same
weights (the port draws them, ``params_to_flax`` carries them), on the
same schedule (JAX's ``cycle_indices`` of its key), with and without 2
background images.

Tolerance: 1e-3 of the JAX gradient's norm (the difference's norm), and
val_loss_sum 1e-5 relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_tpu.bilevel.driver import ValData as JValData
from neuralsim_tpu.detector import dataset as jds
from neuralsim_tpu.detector import trainer as jt
from neuralsim_tpu.hypergrad import unrolled as ju
from neuralsim_tpu.models import retinanet as jr
from neuralsim_tpu_torch.bilevel.driver import ValData
from neuralsim_tpu_torch.config import DetectorConfig
from neuralsim_tpu_torch.detector import trainer as tt
from neuralsim_tpu_torch.hypergrad import unrolled as tu
from neuralsim_tpu_torch.models import retinanet as tr
from tests.test_torch_retinanet import carried_params, jdc_of

torch.set_num_threads(2)

DC = DetectorConfig(num_classes=2, image_size=32, max_iter=3, images_per_batch=2,
                    warmup_iters=1, base_lr=5e-3)
TOL = 1e-3


@functools.lru_cache(maxsize=1)
def setup():
    prng = np.random.RandomState(42)
    imgs = np.zeros((3, 32, 32, 3), np.float32)
    imgs[0, 6:20, 6:20] = 0.3 + 0.5 * prng.rand(14, 14, 3)
    imgs[1, 10:26, 4:18] = 0.2 + 0.5 * prng.rand(16, 14, 3)
    imgs[2, 2:12, 14:30] = 0.3 + 0.4 * prng.rand(10, 16, 3)
    labels = np.array([0, 1, 0], np.int32)
    val_imgs = np.zeros((2, 32, 32, 3), np.float32)
    val_imgs[0, 8:20, 8:20] = 0.9
    val_imgs[1, 12:28, 4:16] = 0.7
    val = tuple(np.asarray(x) for x in jds.build_detector_batches(val_imgs, [0, 1], jdc_of(DC)))
    bg = np.clip(0.3 + 0.2 * np.random.RandomState(9).randn(2, 32, 32, 3), 0.05,
                 1.0).astype(np.float32)
    return imgs, labels, val, bg, [1, 0]


def jax_grad(background: bool):
    imgs, labels, val, bg, bg_labels = setup()
    jdc = jdc_of(DC)
    _, flax = carried_params(DC)
    trainable, _ = jt.split_trainable(flax, jdc)
    det0 = jt.DetectorState(flax, jt.make_detector_optimizer(jdc).init(trainable),
                            jnp.zeros((), jnp.int32))
    _, apply = jt.make_detector_apply(jdc)
    anchors = jnp.concatenate(jr.generate_anchors(DC.image_size), axis=0)
    key = jax.random.PRNGKey(3)
    vd = JValData(*map(jnp.asarray, val))
    kw = dict(background_images=bg, background_labels=bg_labels) if background else {}
    g = ju.unrolled_grad_images(apply, det0, jnp.asarray(imgs), jnp.asarray(labels), vd, jdc,
                                anchors, key, **kw)
    n = len(imgs) + (len(bg) if background else 0)
    idx = np.array(jt.cycle_indices(n, DC.max_iter, DC.images_per_batch, key))
    loss = ju.val_loss_sum(apply, flax, vd, jdc, anchors)
    return np.asarray(g), idx, float(loss)


@pytest.mark.parametrize("background", [False, True], ids=["renders", "with_backgrounds"])
def test_unrolled_grad_images_equals_jax(background):
    imgs, labels, val, bg, bg_labels = setup()
    want, idx, want_loss = jax_grad(background)
    port, _ = carried_params(DC)
    state = tt.init_detector(torch.Generator().manual_seed(0), DC, device="cpu")
    det0 = tt.DetectorState(port, state.opt_state, state.step)
    _, apply = tt.make_detector_apply(DC)
    anchors = torch.cat(tr.generate_anchors(DC.image_size), dim=0)
    vd = ValData(*map(torch.from_numpy, val))
    kw = dict(background_images=bg, background_labels=bg_labels) if background else {}
    got = tu.unrolled_grad_images(apply, det0, torch.from_numpy(imgs), torch.from_numpy(labels),
                                  vd, DC, anchors, torch.from_numpy(idx), **kw)
    assert got.shape == imgs.shape and torch.isfinite(got).all()
    if background:
        assert idx.max() >= len(imgs), "the schedule visits a background"
    err = float(np.linalg.norm(got.numpy() - want) / np.linalg.norm(want))
    print(f"unrolled grad_E ({'with' if background else 'without'} backgrounds): "
          f"{err:.2e} of the norm")
    assert np.abs(want).max() > 0 and err < TOL
    loss = float(tu.val_loss_sum(apply, port, vd, DC, anchors))
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
