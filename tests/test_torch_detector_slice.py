"""The detector slice as a whole, port against JAX, at a small size: a
box-scene render (K = 4, 32x32) -> build_detector_batches_device -> 2
inner steps (image_size 32, 2 classes) -> inference -> coco_map.

Both sides get the same rendered array, the same weights (the port draws
them, ``params_to_flax`` carries them) and JAX's index array. Annotation
is bit-equal, losses match to 1e-4 relative; inference runs on JAX's
trained weights carried back, and the kept detections must be equal
(labels, validity, order; boxes and scores to 1e-4) and coco_map's dict
identical. Where a pick could flip on a near-tie (the score threshold, the
order of the scores NMS picks from, IoU against the NMS threshold and the
COCO IoU thresholds, the COCO area ranges), the test first asserts that
the margin exceeds the tolerance, so a real difference fails loudly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from neuralsim_tpu.detector import dataset as jds
from neuralsim_tpu.detector import evaluator as jev
from neuralsim_tpu.detector import trainer as jt
from neuralsim_tpu.models import retinanet as jr
from neuralsim_tpu.ops.boxes import pairwise_iou
from neuralsim_tpu_torch.bilevel.psi_init import psi_init
from neuralsim_tpu_torch.config import (
    CameraConfig,
    DetectorConfig,
    NeRFNetConfig,
    NeuralSimConfig,
    RenderConfig,
)
from neuralsim_tpu_torch.detector import dataset as tds
from neuralsim_tpu_torch.detector import evaluator as tev
from neuralsim_tpu_torch.detector import trainer as tt
from neuralsim_tpu_torch.models import retinanet as tr
from neuralsim_tpu_torch.models.box_scene import box_scene_params
from neuralsim_tpu_torch.models.convert_retinanet import params_from_flax, params_to_flax
from neuralsim_tpu_torch.pipeline import NeuralSimRenderer
from tests.test_torch_detector_io import same_result
from tests.test_torch_retinanet import (
    assert_detections_equal,
    carried_params,
    jdc_fields,
    jdc_of,
)

K, SIDE = 4, 32
DC = DetectorConfig(num_classes=2, image_size=32, images_per_batch=2, warmup_iters=2)
TOL = 1e-4
# the port's scores and boxes differ from JAX's by ~1e-6 here: a pick with
# less margin than this could flip
SCORE_MARGIN, IOU_MARGIN = 1e-5, 1e-4
# random-init class logits sit at the 0.01 prior (std ~0.04): their kernel is
# scaled so that a few scores per image pass the 0.05 threshold
CLS_KERNEL_SCALE = 12.0


def render():
    """K box-scene renders at 32x32 (the 100x100 camera scaled), on the CPU."""
    s = SIDE / 100.0
    cam = CameraConfig(height=SIDE, width=SIDE, fx=CameraConfig.fx * s, fy=CameraConfig.fy * s,
                       cx=CameraConfig.cx * s, cy=CameraConfig.cy * s)
    net = NeRFNetConfig(netdepth=4, netwidth=32, netdepth_fine=4, netwidth_fine=32, skips=(2,))
    cfg = NeuralSimConfig(net=net, camera=cam, render=RenderConfig(n_samples=24, n_importance=24))
    box = box_scene_params(net, generator=torch.Generator().manual_seed(0))
    r = NeuralSimRenderer(cfg, models={"coarse": box, "fine": box}, device="cpu")
    rgb, _ = r.render_images(psi_init("5"), torch.Generator().manual_seed(1), num_k=K)
    return rgb.numpy()


def assert_margins(scores, boxes, labels, gt_boxes, dc):
    """Every candidate score is far from the threshold and from every other
    candidate; same-class candidate pairs are far from the NMS IoU; the
    kept boxes are far from the COCO IoU thresholds against every GT box and
    from the area-range bounds."""
    for s, b, lab, gt in zip(scores, boxes, labels, gt_boxes):
        assert np.abs(s - dc.score_threshold).min() > SCORE_MARGIN
        cand = s > dc.score_threshold
        cs, cb, cl = s[cand], b[cand], lab[cand]
        gaps = np.abs(cs[:, None] - cs[None, :]) + np.eye(len(cs))
        assert len(cs) == 0 or gaps.min() > SCORE_MARGIN
        iou = np.asarray(pairwise_iou(cb, cb))
        same = (cl[:, None] == cl[None, :]) & ~np.eye(len(cs), dtype=bool)
        assert not same.any() or np.abs(iou[same] - dc.nms_threshold).min() > IOU_MARGIN
        if len(gt) and len(cb):
            to_gt = np.asarray(pairwise_iou(cb, gt)).reshape(-1)
            thresholds = np.linspace(0.5, 0.95, 10)
            assert np.abs(to_gt[:, None] - thresholds[None]).min() > IOU_MARGIN
        area = (cb[:, 2] - cb[:, 0]).clip(0) * (cb[:, 3] - cb[:, 1]).clip(0)
        bounds = np.array([32.0 ** 2, 96.0 ** 2])
        assert len(area) == 0 or np.abs(area[:, None] - bounds).min() > 1e-2
    return int(sum((s > dc.score_threshold).sum() for s in scores))


def test_slice_equals_jax():
    rgb = render()
    assert rgb.shape == (K, SIDE, SIDE, 3) and np.isfinite(rgb).all()
    labels = [1] * K
    jdc = jdc_of(DC)

    # annotation on the device path, both sides, from the same array
    tb = tds.build_detector_batches_device(torch.as_tensor(rgb), labels, DC)
    jb = jds.build_detector_batches_device(rgb, labels, jdc)
    for g, w in zip(tb[1:], jb[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(tb[0].numpy(), np.asarray(jb[0]), rtol=1e-6, atol=1e-6)
    assert tb[3][:, 0].all(), "every render shows the box"
    for img, box in zip(rgb, tb[1][:, 0].numpy()):
        x, y, w, h = tds.auto_annotate(img)
        assert list(box) == [x, y, x + w, y + h]

    # 2 inner steps from the same weights with JAX's index array
    port, _ = carried_params(DC, seed=4)
    port["head.cls_score.weight"] = port["head.cls_score.weight"] * CLS_KERNEL_SCALE
    flax = jax.tree_util.tree_map(jnp.asarray, params_to_flax(port))
    idx = np.asarray(jt.cycle_indices(K, 2, DC.images_per_batch, jax.random.PRNGKey(0)))
    opt = jt.make_detector_optimizer(jdc)
    jstate = jt.DetectorState(flax, opt.init(jt.split_trainable(flax, jdc)[0]),
                              jnp.zeros((), jnp.int32))
    jstate, jm = jax.jit(lambda s, d, i: jt.inner_train(s, (d, i), jdc))(
        jstate, jr.DetBatch(*jb), idx)
    tstate = tt.init_detector(torch.Generator().manual_seed(4), DC, device="cpu")
    tstate, tm = tt.inner_train(tt.DetectorState(port, tstate.opt_state, tstate.step),
                                (tr.DetBatch(*tb), torch.as_tensor(idx.copy())), DC)
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]), rtol=TOL)
    assert np.isfinite(tm["loss"].numpy()).all()

    # inference on JAX's trained weights, carried back
    trained = params_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params))
    _, japply = jt.make_detector_apply(jdc)
    (jlogits, jdeltas), want = jax.jit(lambda p, im: (japply(p, im), jr.retinanet_inference(
        japply, p, im, jr.generate_anchors(DC.image_size), jdc)))(jstate.params, jb[0])
    jscores = np.asarray(jax.nn.sigmoid(jlogits)).reshape(K, -1)
    anchors = torch.cat(tr.generate_anchors(DC.image_size)).numpy()
    jboxes = np.asarray(jr.decode_deltas(anchors[None], jdeltas))
    cand_boxes = np.repeat(jboxes, DC.num_classes, axis=1)
    cand_labels = np.tile(np.arange(DC.num_classes), anchors.shape[0])[None].repeat(K, 0)
    gt = [np.asarray(jb[1][i])[np.asarray(jb[3][i])] for i in range(K)]
    n_cand = assert_margins(jscores, cand_boxes, cand_labels, gt, DC)
    assert n_cand > 0, "no detection above the score threshold"

    _, tapply = tt.make_detector_apply(DC)
    got = tr.retinanet_inference(tapply, trained, tb[0], tr.generate_anchors(DC.image_size), DC)
    assert_detections_equal(got, want)

    truth = [{"boxes": g, "labels": np.ones(len(g), np.int64)} for g in gt]
    mine = tev.coco_map(tev.detections_to_eval(got), truth)
    theirs = jev.coco_map(jev.detections_to_eval(want), truth)
    same_result(mine, theirs)
    assert np.isfinite(mine["AP"]) and np.isfinite(mine["AP50"])
    assert dataclasses.asdict(DC) == jdc_fields(jdc)
