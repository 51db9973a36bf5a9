"""Parity of the port's box ops, anchor matching and NMS
(neuralsim_tpu_torch/ops/boxes.py, ops/nms.py) with the JAX package's.

The same numpy inputs, made from a seed, go through both. Box arithmetic is
held to 1e-6 (relative and absolute); matching and NMS must be equal:
indices, labels and validity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_tpu.ops import boxes as jb
from neuralsim_tpu.ops import nms as jn
from neuralsim_tpu_torch.models.retinanet import generate_anchors
from neuralsim_tpu_torch.ops import boxes as tb
from neuralsim_tpu_torch.ops import nms as tn

TOL = dict(rtol=1e-6, atol=1e-6)


def random_boxes(rng, n, lo=0.0, hi=64.0, min_wh=0.0, max_wh=40.0):
    xy = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(min_wh, max_wh, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def t(x):
    return torch.as_tensor(np.asarray(x))


def test_box_area_iou_encode_decode(rng):
    a = random_boxes(rng, 30)
    b = random_boxes(rng, 20)
    b[:3, 2:] = b[:3, :2]                      # degenerate boxes: zero area
    b[3, 2:] = b[3, :2] - 1.0                  # inverted box: area clamps to 0
    np.testing.assert_allclose(tb.box_area(t(a)).numpy(), np.asarray(jb.box_area(a)), **TOL)
    np.testing.assert_allclose(tb.pairwise_iou(t(a), t(b)).numpy(),
                               np.asarray(jb.pairwise_iou(a, b)), **TOL)
    anchors = random_boxes(rng, 40, min_wh=4.0)
    boxes = random_boxes(rng, 40, min_wh=0.0)
    enc = tb.encode_deltas(t(anchors), t(boxes)).numpy()
    np.testing.assert_allclose(enc, np.asarray(jb.encode_deltas(anchors, boxes)), **TOL)
    deltas = rng.normal(0, 1.5, (40, 4)).astype(np.float32)
    deltas[:5, 2:] = 50.0                      # past the log(1000/16) clamp
    np.testing.assert_allclose(tb.decode_deltas(t(anchors), t(deltas)).numpy(),
                               np.asarray(jb.decode_deltas(anchors, deltas)), **TOL)
    assert tb.DELTA_CLIP == 4.135166556742356


def matching_cases(rng):
    anchors = torch.cat(generate_anchors(64)).numpy()
    cases = []
    for trial in range(6):
        g = 4
        gt = random_boxes(rng, g, hi=56.0, min_wh=2.0, max_wh=40.0)
        valid = rng.rand(g) < 0.7
        cases.append((gt, valid))
    cases.append((random_boxes(rng, 4), np.zeros(4, bool)))           # no valid GT
    # a box no anchor overlaps by 0.5: its best anchor is forced fg
    cases.append((np.array([[30, 30, 33, 37], [0, 0, 0, 0], [5, 5, 63, 9], [0, 0, 0, 0]],
                           np.float32), np.array([True, False, True, False])))
    return anchors, cases


def test_match_anchors_equal(rng):
    anchors, cases = matching_cases(rng)
    forced = 0
    for gt, valid in cases:
        jidx, jlab = jb.match_anchors(anchors, gt, valid, 0.5, 0.4)
        tidx, tlab = tb.match_anchors(t(anchors), t(gt), t(valid), 0.5, 0.4)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(tlab.numpy(), np.asarray(jlab))
        iou = np.asarray(jb.pairwise_iou(anchors, gt))
        forced += int(((iou.max(0) < 0.5) & valid & (iou.max(0) > 0)).sum())
    assert forced > 0, "no low-quality override among the cases"
    assert (np.asarray(jb.match_anchors(anchors, *cases[-2])[1]) == 0).all()


def test_match_anchors_batched_equals_per_image(rng):
    """The port matches a batch [N, G] in one call; each image equals the
    JAX package's single-image match."""
    anchors, cases = matching_cases(rng)
    gt = np.stack([c[0] for c in cases])
    valid = np.stack([c[1] for c in cases])
    tidx, tlab = tb.match_anchors(t(anchors), t(gt), t(valid))
    for i, (g, v) in enumerate(cases):
        jidx, jlab = jb.match_anchors(anchors, g, v)
        np.testing.assert_array_equal(tidx[i].numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(tlab[i].numpy(), np.asarray(jlab))


def nms_case(rng, n=60):
    boxes = random_boxes(rng, n, hi=48.0, min_wh=4.0, max_wh=24.0)
    # quantized scores: many exact ties, broken by the lower index
    scores = (rng.randint(0, 6, n) / 5.0).astype(np.float32)
    scores[rng.rand(n) < 0.15] = -np.inf
    scores[0] = np.nan                           # counts as -inf
    labels = rng.randint(0, 3, n).astype(np.int32)
    return boxes, scores, labels


@pytest.mark.parametrize("far", [False, True], ids=["near", "far_box"])
def test_nms_and_class_nms_equal(rng, far):
    batch = [nms_case(rng) for _ in range(4)]
    if far:
        # one box far outside the others (score -inf): it sets the class
        # offset of its image, as in the JAX package
        for boxes, scores, _ in batch:
            boxes[5] = [5000.0, 5000.0, 5030.0, 5040.0]
            scores[5] = -np.inf
    max_out = 60          # every box: the tail picks are padding
    jnms = jax.jit(jn.nms, static_argnums=(2, 3))
    jclass = jax.jit(jn.batched_class_nms, static_argnums=(3, 4))
    for boxes, scores, labels in batch:
        jk, jv = jnms(jnp.asarray(boxes), jnp.asarray(scores), 0.5, max_out)
        tk, tv = tn.nms(t(boxes), t(scores), 0.5, max_out)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        jk, jv = jclass(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels), 0.5,
                        max_out)
        tk, tv = tn.batched_class_nms(t(boxes), t(scores), t(labels), 0.5, max_out)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        assert 0 < int(tv.sum()) < max_out
    # the whole batch in one call of the port: each image's picks as above
    tk, tv = tn.batched_class_nms(*(t(np.stack(x)) for x in zip(*batch)), 0.5, max_out)
    for i, (boxes, scores, labels) in enumerate(batch):
        jk, jv = jclass(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels), 0.5,
                        max_out)
        np.testing.assert_array_equal(tk[i].numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv[i].numpy(), np.asarray(jv))


def test_nms_known_cases():
    boxes = t(np.array([[0.0, 0, 10, 10], [1.0, 1, 11, 11], [20.0, 20, 30, 30]], np.float32))
    keep, valid = tn.nms(boxes, t(np.array([0.9, 0.8, 0.7], np.float32)), 0.5, 3)
    assert keep.tolist() == [0, 2, 0] and valid.tolist() == [True, True, False]
    same = t(np.array([[0.0, 0, 10, 10], [0.0, 0, 10, 10]], np.float32))
    _, valid = tn.batched_class_nms(same, t(np.array([0.9, 0.8], np.float32)),
                                    t(np.array([0, 1])), 0.5, 2)
    assert valid.tolist() == [True, True]
