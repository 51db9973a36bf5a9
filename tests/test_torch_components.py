"""Parity of the port's on-device connected components
(neuralsim_tpu_torch/ops/components.py) with the JAX package's, and with
the port's host connected components (native library and numpy twin).

Labels and boxes must be equal, bit for bit: random masks with several
blobs, diagonal-only links, components of equal box area and empty masks.
"""

import jax
import numpy as np
import pytest
import torch

from neuralsim_tpu.config import DetectorConfig as JDC
from neuralsim_tpu.detector import dataset as jds
from neuralsim_tpu.ops import components as jc
from neuralsim_tpu_torch.config import DetectorConfig
from neuralsim_tpu_torch.detector import dataset as tds
from neuralsim_tpu_torch.native import _connected_components_np, connected_components
from neuralsim_tpu_torch.ops import components as tc

jlabel = jax.jit(jc.label_components)
jboxes = jax.jit(jc.component_boxes, static_argnums=1)


def masks(rng):
    """[N, H, W] bool batches of each kind."""
    h, w = 23, 29
    out = {"random": rng.rand(6, h, w) < rng.uniform(0.2, 0.7, (6, 1, 1))}
    diag = np.zeros((3, h, w), bool)
    for i in range(min(h, w)):
        diag[0, i, i] = True                       # one diagonal line
        diag[1, i, w - 1 - i] = True               # the anti-diagonal
    diag[2, ::2, ::2] = True                       # a checkerboard lattice:
    diag[2, 1::2, 1::2] = True                     # linked only diagonally
    out["diagonal"] = diag
    equal = np.zeros((2, h, w), bool)
    for y0, x0 in ((2, 2), (2, 15), (12, 6), (16, 20)):
        equal[0, y0:y0 + 4, x0:x0 + 5] = True      # four 5x4 boxes: area ties
    equal[1, 1:4, 1:7] = True
    equal[1, 10:16, 20:23] = True                  # 6x3 and 3x6: equal area
    out["equal_area"] = equal
    out["empty"] = np.zeros((2, h, w), bool)
    blobs = np.zeros((2, h, w), bool)
    yy, xx = np.mgrid[:h, :w]
    for n in range(2):
        for _ in range(5):
            cy, cx, r = rng.randint(0, h), rng.randint(0, w), rng.uniform(1.5, 5)
            blobs[n] |= (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
    out["blobs"] = blobs
    return out


def host_boxes(mask, k):
    """The host connected components' boxes, by box area with the
    first-found component first among equal areas."""
    stats = sorted(connected_components(mask.astype(np.uint8)), key=lambda s: -s[2] * s[3])
    return [(float(x), float(y), float(x + w), float(y + h)) for x, y, w, h, _ in stats[:k]]


@pytest.mark.parametrize("kind", ["random", "diagonal", "equal_area", "empty", "blobs"])
def test_labels_and_boxes_equal_jax_and_host(rng, kind):
    m = masks(rng)[kind]
    tlab = tc.label_components(torch.as_tensor(m))
    np.testing.assert_array_equal(tlab.numpy(), np.asarray(jlabel(m)))
    assert tlab.dtype == torch.int32
    k = 8
    tb, tv = tc.component_boxes(torch.as_tensor(m), k)
    jb, jv = jboxes(m, k)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for i, mask in enumerate(m):
        want = host_boxes(mask, k)
        got = [tuple(map(float, b)) for b, v in zip(tb[i].numpy(), tv[i].numpy()) if v]
        assert sorted(got) == sorted(want), (kind, i)
        if want:
            assert got[0] == want[0], (kind, i)          # slot 0: the host's largest
        # the C++ library and its numpy twin agree
        assert sorted(connected_components(mask.astype(np.uint8))) == sorted(
            _connected_components_np(mask.astype(np.uint8)))
    if kind == "diagonal":
        assert tv[:, 0].all() and not tv[:, 1].any()      # one component each


def test_device_batches_equal_jax(rng):
    """build_detector_batches_device on multi-blob renders: the same boxes,
    labels, validity and model inputs as the JAX package's."""
    img = np.zeros((3, 28, 28, 3), np.float32)
    img[0, 4:12, 4:14] = 0.8
    img[0, 18:24, 20:26] = 0.6
    img[1, 7:19, 9:23] = rng.uniform(0.0, 1.0, (12, 14, 3))     # pixels near the threshold
    img[1, 7:19, 9:23] *= rng.rand(12, 14, 1) < 0.8
    for largest_only in (False, True):
        got = tds.build_detector_batches_device(
            img, [1, 0, 1], DetectorConfig(num_classes=2, image_size=32),
            largest_only=largest_only, device="cpu")
        want = jds.build_detector_batches_device(
            img, [1, 0, 1], JDC(num_classes=2, image_size=32), largest_only=largest_only)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-6)
    assert got[3][0, 0] and not got[3][2].any()
