"""Parity of the port's RetinaNet-R50-FPN (models/resnet.py, fpn.py,
retinanet.py, convert_retinanet.py) with the JAX package's, on the same
weights: the port draws them and ``params_to_flax`` carries them across.

Tolerances: anchors 1e-6; feature maps, logits and deltas 1e-4 of their
max |x|; losses 1e-5 relative (1e-4 through the network); d loss / d images
1e-4 of the JAX gradient's norm (the difference's norm); inference labels,
validity and order equal, boxes and scores 1e-4. The weight map round trip
is exact.
"""

import dataclasses
import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_tpu.config import DetectorConfig as JDC
from neuralsim_tpu.detector import trainer as jt
from neuralsim_tpu.models import convert_retinanet as jconv
from neuralsim_tpu.models import fpn as jfpn
from neuralsim_tpu.models import resnet as jres
from neuralsim_tpu.models import retinanet as jr
from neuralsim_tpu_torch.config import DetectorConfig
from neuralsim_tpu_torch.detector import trainer as tt
from neuralsim_tpu_torch.models import convert_retinanet as tconv
from neuralsim_tpu_torch.models import fpn as tfpn
from neuralsim_tpu_torch.models import resnet as tres
from neuralsim_tpu_torch.models import retinanet as tr
from neuralsim_tpu_torch.ops.boxes import encode_deltas, match_anchors
from tests.test_convert_retinanet import _fake_torchvision_sd


# fields of the JAX DetectorConfig that the port's leaves out (none: the
# bilevel driver brought eval_stream_images)
UNPORTED_FIELDS = ()


def jdc_of(dc: DetectorConfig) -> JDC:
    return JDC(**dataclasses.asdict(dc))


def jdc_fields(jdc: JDC) -> dict:
    """The JAX config's fields that the port's DetectorConfig has."""
    return {k: v for k, v in dataclasses.asdict(jdc).items() if k not in UNPORTED_FIELDS}


@functools.lru_cache(maxsize=4)
def _carried(dc: DetectorConfig, seed: int):
    state = tt.init_detector(torch.Generator().manual_seed(seed), dc, device="cpu")
    return state.params, tconv.params_to_flax(state.params)


def carried_params(dc: DetectorConfig, seed: int = 0):
    """(port params {name: CPU tensor}, the same weights as the JAX
    package's tree of jnp arrays). Fresh dicts: callers may replace
    entries."""
    port, tree = _carried(dc, seed)
    return dict(port), jax.tree_util.tree_map(jnp.asarray, tree)


def rel_err(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def test_weight_map_round_trip_is_exact():
    dc = DetectorConfig(num_classes=3, image_size=64)
    port, tree = carried_params(dc)
    back = tconv.params_from_flax(tree)
    assert sorted(back) == sorted(port)
    for k, v in port.items():
        assert back[k].dtype == torch.float32 and torch.equal(back[k], v), k
    again = tconv.params_to_flax(back)
    jax.tree_util.tree_map(np.testing.assert_array_equal, again,
                           jax.tree_util.tree_map(np.asarray, tree))
    # the JAX module takes the carried tree as its own: same structure, shapes
    shapes = jax.eval_shape(
        jr.RetinaNet(num_classes=3).init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    want = jax.tree_util.tree_map(lambda x: x.shape, shapes["params"])
    assert jax.tree_util.tree_map(lambda x: x.shape, tree) == want
    assert port["backbone.res2_block0.conv1.weight"].shape == (64, 64, 1, 1)
    assert port["backbone.res3_block0.downsample_bn.scale"].shape == (512,)


def test_torchvision_converter_and_merge_equal_jax(rng, tmp_path):
    sd = _fake_torchvision_sd(rng, num_classes=80)
    want = jconv.convert_torchvision_retinanet(sd)
    got = tconv.convert_torchvision_retinanet(sd)
    jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)
    path = str(tmp_path / "retinanet_coco.npz")
    np.savez(path, **sd)
    loaded = tconv.load_retinanet_checkpoint(path)
    assert tconv.detect_p6_source(loaded) == jconv.detect_p6_source(want) == "p5"
    for k, v in tconv.params_from_flax(jconv.load_retinanet_checkpoint(path)).items():
        assert torch.equal(loaded[k], v), k
    # merge into a 6-class model: the 80-class cls_score is skipped on both sides
    dc = DetectorConfig(num_classes=6, image_size=64, fpn_p6_source="p5")
    fresh = tt.init_detector(torch.Generator().manual_seed(1), dc, device="cpu").params
    merged, skipped = tconv.merge_pretrained(fresh, loaded)
    jmerged, jskipped = jconv.merge_pretrained(tconv.params_to_flax(fresh), want)
    assert skipped == ["head.cls_score.weight", "head.cls_score.bias"]
    assert len(jskipped) == len(skipped)
    for k, v in tconv.params_from_flax(jax.tree_util.tree_map(np.asarray, jmerged)).items():
        assert torch.equal(merged[k], v), k
    # init_detector from the local checkpoint
    state = tt.init_detector(torch.Generator().manual_seed(1),
                             dataclasses.replace(dc, pretrain=True, pretrain_weight=path),
                             device="cpu")
    for k in merged:
        assert torch.equal(state.params[k], merged[k]), k
    with pytest.raises(ValueError, match="P6 source"):
        tt.init_detector(None, dataclasses.replace(dc, pretrain_weight=path, fpn_p6_source="c5"),
                         device="cpu")
    with pytest.raises(ValueError, match="pretrain_weight"):
        tt.init_detector(None, dataclasses.replace(dc, pretrain=True), device="cpu")


@pytest.mark.parametrize("size", [64, 100, 128])
def test_anchors_equal(size):
    got = tr.generate_anchors(size)
    want = jr.generate_anchors(size)
    assert [g.shape[0] for g in got] == [w.shape[0] for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    if size == 100:   # the ceil grid: 13, 7, 4, 2, 1 cells per side
        assert [g.shape[0] // tr.NUM_ANCHORS for g in got] == [169, 49, 16, 4, 1]


@pytest.mark.parametrize("p6_source", ["c5", "p5"])
def test_resnet_reduced_and_fpn_at_100px(rng, p6_source):
    """ResNet50 with (1, 1, 2, 1) blocks and the FPN on its maps at 100 px,
    where the laterals are not twice the coarser maps (13, 7, 4)."""
    blocks = (1, 1, 2, 1)
    gen = torch.Generator().manual_seed(2)
    backbone = tres.ResNet50(stage_blocks=blocks, stride_in_1x1=p6_source == "p5")
    fpn = tfpn.FPN(p6_source=p6_source)
    bp = tr.init_params(backbone, gen)
    fp = tr.init_params(fpn, gen)
    x = rng.randn(2, 100, 100, 3).astype(np.float32)
    cs = torch.func.functional_call(backbone, bp, (torch.as_tensor(x).permute(0, 3, 1, 2),))
    ps = torch.func.functional_call(fpn, fp, cs)

    jbb = jres.ResNet50(stage_blocks=blocks, stride_in_1x1=p6_source == "p5")
    jcs = jax.jit(jbb.apply)({"params": tconv.params_to_flax(bp)}, x)
    for c, jc in zip(cs, jcs):
        assert rel_err(c.permute(0, 2, 3, 1).detach(), jc) < 1e-4
    jps = jax.jit(jfpn.FPN(p6_source=p6_source).apply)(
        {"params": tconv.params_to_flax(fp)}, *jcs)
    assert [p.shape[-1] for p in ps] == [13, 7, 4, 2, 1]
    for p, jp in zip(ps, jps):
        assert rel_err(p.permute(0, 2, 3, 1).detach(), jp) < 1e-4


def test_upsample_index_rule():
    x = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 5)
    for h_out, w_out in ((7, 9), (8, 10), (13, 13)):
        want = jfpn._upsample_nearest_to(jnp.asarray(x.permute(0, 2, 3, 1).numpy()),
                                         h_out, w_out)
        got = tfpn.upsample_nearest_to(x, h_out, w_out).permute(0, 2, 3, 1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def loss_batch(rng, n=3, size=64, g=3, num_classes=3):
    """Images with boxes of each kind: fg matches, low-quality ones, and an
    image with no GT."""
    images = rng.randn(n, size, size, 3).astype(np.float32)
    xy = rng.uniform(0, size * 0.6, (n, g, 2))
    wh = rng.uniform(6, size * 0.5, (n, g, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    labels = rng.randint(0, num_classes, (n, g)).astype(np.int32)
    valid = rng.rand(n, g) < 0.8
    valid[:, 0] = True
    valid[-1] = False                                   # the last image: no GT
    return images, boxes, labels, valid


def test_losses_equal_jax(rng):
    x = (rng.randn(50, 6) * 3).astype(np.float32)
    onehot = (rng.rand(50, 6) < 0.2).astype(np.float32)
    np.testing.assert_allclose(
        tr.sigmoid_focal_loss(torch.as_tensor(x), torch.as_tensor(onehot), 0.25, 2.0).numpy(),
        np.asarray(jr.sigmoid_focal_loss(x, onehot, 0.25, 2.0)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tr.smooth_l1(torch.as_tensor(x), 0.1).numpy(),
                               np.asarray(jr.smooth_l1(x, 0.1)), rtol=1e-6, atol=1e-6)
    # retinanet_loss on given logits and deltas (a stand-in apply_fn)
    dc = DetectorConfig(num_classes=3, image_size=64)
    anchors = torch.cat(tr.generate_anchors(64)).numpy()
    images, boxes, labels, valid = loss_batch(rng)
    a = anchors.shape[0]
    logits = (rng.randn(3, a, 3) * 2).astype(np.float32)
    deltas = rng.randn(3, a, 4).astype(np.float32)
    jloss = jax.jit(lambda lg, dl, w: jr.retinanet_loss(
        lambda p, im: (lg, dl), None, jr.DetBatch(images, boxes, labels, valid), anchors,
        jdc_of(dc), image_weight=w))
    for weight in (None, np.array([1.0, 0.0, 1.0], np.float32)):
        want, wparts = jloss(logits, deltas, weight)
        got, gparts = tr.retinanet_loss(
            lambda p, im: (torch.as_tensor(logits), torch.as_tensor(deltas)), None,
            tr.DetBatch(*(torch.as_tensor(v) for v in (images, boxes, labels, valid))),
            torch.as_tensor(anchors), dc,
            image_weight=None if weight is None else torch.as_tensor(weight))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        for k in wparts:
            np.testing.assert_allclose(float(gparts[k]), float(wparts[k]), rtol=1e-5)
    # an all-empty batch: no fg, the normalizer clamps at 1
    empty = tr.DetBatch(*(torch.as_tensor(v) for v in (images, boxes, labels, valid & False)))
    total, parts = tr.retinanet_loss(
        lambda p, im: (torch.as_tensor(logits), torch.as_tensor(deltas)), None, empty,
        torch.as_tensor(anchors), dc)
    assert float(parts["loss_box_reg"]) == 0.0 and float(total) > 0


def shared_norm_loss(logits, deltas, batch, anchors, dc, image_weight=None):
    """retinanet_loss's default as it stood before the per-image option (a
    copy): one normalizer, the batch's clamped fg count."""
    midx, mlabel = match_anchors(anchors, batch.gt_boxes, batch.gt_valid,
                                 dc.iou_fg_threshold, dc.iou_bg_threshold)
    fg, not_ignore = mlabel == 1, mlabel != -1
    cls_target = torch.where(fg, torch.gather(batch.gt_labels.long(), 1, midx), -1)
    onehot = (cls_target[..., None] == torch.arange(dc.num_classes)).to(logits.dtype)
    cls_loss = tr.sigmoid_focal_loss(logits, onehot, dc.focal_alpha, dc.focal_gamma)
    cls_l = torch.where(not_ignore, cls_loss, torch.zeros_like(cls_loss)).sum(dim=-1)
    matched = torch.gather(batch.gt_boxes, 1, midx[..., None].expand(*midx.shape, 4))
    box_loss = tr.smooth_l1(deltas - encode_deltas(anchors, matched), dc.smooth_l1_beta).sum(-1)
    box_l = torch.where(fg, box_loss, torch.zeros_like(box_loss)).sum(dim=-1)
    n_fg = fg.to(cls_l.dtype).sum(dim=-1)
    if image_weight is not None:
        cls_l, box_l, n_fg = cls_l * image_weight, box_l * image_weight, n_fg * image_weight
    norm = torch.clamp(n_fg.sum(), min=1.0)
    return cls_l.sum() / norm + box_l.sum() / norm


def test_per_image_normalizer_sums_the_batch1_losses(rng):
    """Under per_image_norm a batch's loss is the sum of its images' batch-1
    losses (weight 0 drops an image; the image without GT clamps its
    normalizer at 1); the default, the batch's shared normalizer, is the
    formula it was, to the bit."""
    dc = DetectorConfig(num_classes=3, image_size=64)
    anchors = torch.cat(tr.generate_anchors(64))
    images, boxes, labels, valid = (torch.as_tensor(v) for v in loss_batch(rng))
    a = anchors.shape[0]
    logits = torch.as_tensor((rng.randn(3, a, 3) * 2).astype(np.float32))
    deltas = torch.as_tensor(rng.randn(3, a, 4).astype(np.float32))
    batch = tr.DetBatch(images, boxes, labels, valid)
    n_fg = (match_anchors(anchors, boxes, valid, dc.iou_fg_threshold,
                          dc.iou_bg_threshold)[1] == 1).sum(-1).tolist()
    assert n_fg[-1] == 0 and len(set(n_fg[:-1])) == 2 and min(n_fg[:-1]) > 1, n_fg

    def loss(rows, **kw):
        return tr.retinanet_loss(lambda p, im: (logits[rows], deltas[rows]), None,
                                 tr.DetBatch(*(x[rows] for x in batch)), anchors, dc, **kw)

    one = [float(loss([i])[0]) for i in range(3)]
    for weight in (None, torch.tensor([1.0, 0.0, 1.0])):
        w = [1.0] * 3 if weight is None else weight.tolist()
        total, parts = loss([0, 1, 2], image_weight=weight, per_image_norm=True)
        want = sum(wi * li for wi, li in zip(w, one))
        np.testing.assert_allclose(float(total), want, rtol=1e-6)
        np.testing.assert_allclose(float(parts["loss_cls"] + parts["loss_box_reg"]),
                                   float(total), rtol=1e-7)
        shared, _ = loss([0, 1, 2], image_weight=weight)
        assert torch.equal(shared, shared_norm_loss(logits, deltas, batch, anchors, dc,
                                                    image_weight=weight))
        assert abs(float(shared) - want) > 1e-3 * want


def test_network_logits_loss_and_image_grad_equal_jax(rng):
    """The full RetinaNet at 64 px: logits and deltas, the loss with and
    without image weights, and d loss / d images (through the frozen
    backbone) against jax.grad."""
    dc = DetectorConfig(num_classes=3, image_size=64)
    port, flax = carried_params(dc)
    images, boxes, labels, valid = loss_batch(rng)
    weight = np.array([1.0, 0.5, 1.0], np.float32)
    _, japply = jt.make_detector_apply(jdc_of(dc))
    janchors = jnp.concatenate(jr.generate_anchors(64))

    @jax.jit
    def jax_side(params, images):
        def loss(im, w):
            return jr.retinanet_loss(japply, params, jr.DetBatch(im, boxes, labels, valid),
                                     janchors, jdc_of(dc), image_weight=w)[0]

        return japply(params, images), loss(images, None), jax.grad(loss)(images, None), \
            loss(images, weight)

    (jl, jd), jloss, jgrad, jloss_w = jax_side(flax, images)
    _, tapply = tt.make_detector_apply(dc)
    x = torch.as_tensor(images).requires_grad_()
    batch = tr.DetBatch(x, *(torch.as_tensor(v) for v in (boxes, labels, valid)))
    anchors = torch.cat(tr.generate_anchors(64))
    tl, td = tapply(port, x)
    assert rel_err(tl.detach(), jl) < 1e-4 and rel_err(td.detach(), jd) < 1e-4
    loss, _ = tr.retinanet_loss(tapply, port, batch, anchors, dc)
    (grad,) = torch.autograd.grad(loss, [x])
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    jgrad = np.asarray(jgrad)
    assert np.linalg.norm(jgrad) > 0
    assert np.linalg.norm(grad.numpy() - jgrad) < 1e-4 * np.linalg.norm(jgrad)
    loss_w, _ = tr.retinanet_loss(tapply, port, batch, anchors, dc,
                                  image_weight=torch.as_tensor(weight))
    np.testing.assert_allclose(float(loss_w.detach()), float(jloss_w), rtol=1e-4)


def designed_outputs(rng, dc, n=2):
    """Logits whose sigmoid scores are all at least 1e-3 apart (a shuffled
    grid), and random deltas: every top-k and NMS pick has a margin far
    beyond float noise."""
    a = sum(x.shape[0] for x in tr.generate_anchors(dc.image_size))
    grid = np.linspace(0.01, 0.99, n * a * dc.num_classes)
    scores = rng.permutation(grid).reshape(n, a, dc.num_classes)
    logits = np.log(scores / (1 - scores)).astype(np.float32)
    deltas = (rng.randn(n, a, 4) * 0.3).astype(np.float32)
    return logits, deltas


def assert_detections_equal(got, want):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=1e-4, atol=1e-4)


def test_inference_equals_jax_on_separated_scores(rng):
    """retinanet_inference with a per-level top-k that cuts (k < level
    size), the score threshold and class NMS."""
    dc = DetectorConfig(num_classes=3, image_size=64, topk_per_level=60, max_detections=300)
    logits, deltas = designed_outputs(rng, dc)
    want = jax.jit(lambda lg, dl: jr.retinanet_inference(
        lambda p, im: (lg, dl), None, None, jr.generate_anchors(64), jdc_of(dc)))(logits, deltas)
    got = tr.retinanet_inference(lambda p, im: (torch.as_tensor(logits), torch.as_tensor(deltas)),
                                 None, None, tr.generate_anchors(64), dc)
    assert_detections_equal(got, want)
    assert 0 < int(got.valid.sum()) < got.valid.numel()


def controlled_params(dc, rng):
    """Carried weights whose class logits and box deltas are per-anchor
    constants (zero kernels, distinct biases): the scores of one anchor
    shape and class are one value, equal on every cell, ranked by index on
    both sides; scores of different shapes or classes lie far apart."""
    port, _ = carried_params(dc, seed=3)
    k = tr.NUM_ANCHORS * dc.num_classes
    port["head.cls_score.weight"] = torch.zeros_like(port["head.cls_score.weight"])
    port["head.cls_score.bias"] = torch.as_tensor(
        rng.permutation(np.linspace(-3.0, 2.0, k)).astype(np.float32))
    port["head.bbox_pred.weight"] = torch.zeros_like(port["head.bbox_pred.weight"])
    port["head.bbox_pred.bias"] = torch.as_tensor(
        rng.uniform(-0.3, 0.3, tr.NUM_ANCHORS * 4).astype(np.float32))
    return port, jax.tree_util.tree_map(jnp.asarray, tconv.params_to_flax(port))


def test_inference_through_the_network_equals_jax(rng):
    dc = DetectorConfig(num_classes=2, image_size=64, max_detections=50)
    port, flax = controlled_params(dc, rng)
    images = rng.randn(2, 64, 64, 3).astype(np.float32)
    _, japply = jt.make_detector_apply(jdc_of(dc))
    want = jax.jit(lambda p, im: jr.retinanet_inference(
        japply, p, im, jr.generate_anchors(64), jdc_of(dc)))(flax, images)
    _, tapply = tt.make_detector_apply(dc)
    got = tr.retinanet_inference(tapply, port, torch.as_tensor(images),
                                 tr.generate_anchors(64), dc)
    assert_detections_equal(got, want)
    assert int(got.valid.sum()) > 20


def test_module_layout_matches_flax_defaults():
    """Padding and pooling where Flax's defaults decide them."""
    bb = tres.ResNet50()
    assert bb.res3_block0.downsample_conv.padding == (0, 0)
    assert bb.res3_block0.conv1.padding == (0, 0) and bb.res3_block0.conv2.stride == (2, 2)
    assert bb.stem_conv.padding == (3, 3)
    x = torch.full((1, 1, 4, 4), -5.0)
    # max_pool pads with -inf: a negative map stays negative at its edges
    assert torch.equal(torch.nn.functional.max_pool2d(x, 3, 2, 1), torch.full((1, 1, 2, 2), -5.0))
    jx = nn.max_pool(jnp.full((1, 4, 4, 1), -5.0), (3, 3), (2, 2), ((1, 1), (1, 1)))
    assert (np.asarray(jx) == -5.0).all()
