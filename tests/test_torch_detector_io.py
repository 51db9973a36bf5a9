"""The port's detector I/O against the JAX package's: coco_map and
detections_to_eval (detector/evaluator.py), the host annotation and
batch builders and COCO export (detector/dataset.py), transforms,
catalogs and the predictor.

coco_map must return dicts identical to JAX's (every case of
tests/test_evaluator_golden.py and tests/test_evaluator.py, replayed through
both); annotations, JSON documents and catalog records must be equal; model
inputs and predictor boxes and scores are held to 1e-6 and 1e-4.
"""

import inspect
import json
import math

import numpy as np
import pytest
import torch

from neuralsim_tpu.config import DetectorConfig as JDC
from neuralsim_tpu.detector import catalog as jcat
from neuralsim_tpu.detector import dataset as jds
from neuralsim_tpu.detector import evaluator as jev
from neuralsim_tpu.detector import predictor as jpred
from neuralsim_tpu.detector import transforms as jtr
from neuralsim_tpu.models import retinanet as jr
from neuralsim_tpu_torch.config import DetectorConfig
from neuralsim_tpu_torch.detector import catalog as tcat
from neuralsim_tpu_torch.detector import dataset as tds
from neuralsim_tpu_torch.detector import evaluator as tev
from neuralsim_tpu_torch.detector import predictor as tpred
from neuralsim_tpu_torch.detector import transforms as ttr
from neuralsim_tpu_torch.models import retinanet as tr
from tests import test_evaluator, test_evaluator_golden
from tests.test_torch_retinanet import controlled_params


def same_result(a, b):
    """Dict equality with NaN equal to NaN."""
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            same_result(a[k], b[k])
        elif not (math.isnan(a[k]) and math.isnan(b[k])):
            assert a[k] == b[k], k


def evaluator_cases():
    for module in (test_evaluator_golden, test_evaluator):
        for name, fn in sorted(vars(module).items()):
            if name.startswith("test_") and not inspect.signature(fn).parameters:
                yield pytest.param(module, name, id=f"{module.__name__.split('.')[-1]}::{name}")


@pytest.mark.parametrize("module,name", evaluator_cases())
def test_coco_map_equals_jax_on_the_evaluator_cases(monkeypatch, module, name):
    """Each case calls coco_map; the call goes to both and the dicts must
    be identical (the case's own assertions then read the JAX result)."""
    calls = []

    def both(*args, **kwargs):
        want = jev.coco_map(*args, **kwargs)
        same_result(tev.coco_map(*args, **kwargs), want)
        calls.append(name)
        return want

    monkeypatch.setattr(module, "coco_map", both)
    getattr(module, name)()
    assert calls


def test_detections_to_eval_equals_jax(rng):
    n, d = 3, 7
    boxes = rng.uniform(0, 60, (n, d, 4)).astype(np.float32)
    scores = rng.rand(n, d).astype(np.float32)
    labels = rng.randint(0, 5, (n, d)).astype(np.int32)
    valid = rng.rand(n, d) < 0.6
    for valid_only in (True, False):
        got = tev.detections_to_eval(tr.Detections(
            *(torch.as_tensor(x) for x in (boxes, scores, labels.astype(np.int64), valid))),
            valid_only=valid_only)
        want = jev.detections_to_eval(jr.Detections(boxes, scores, labels, valid), valid_only)
        for g, w in zip(got, want):
            for k in ("boxes", "scores", "labels"):
                np.testing.assert_array_equal(g[k], w[k])


def renders(rng):
    """Renders in [0, 1] with one or two objects, pixels near the
    threshold, and an empty frame."""
    imgs = np.zeros((4, 30, 26, 4), np.float32)
    imgs[0, 5:20, 3:12, :3] = rng.uniform(0.2, 1.0, (15, 9, 3))
    imgs[1, 2:6, 2:6, :3] = 0.5
    imgs[1, 12:28, 8:25, :3] = rng.uniform(0.0, 0.02, (16, 17, 3))   # around 1.5/255
    imgs[2] = rng.rand(30, 26, 4) * (rng.rand(30, 26, 1) < 0.3)
    imgs[..., 3] = 1.0
    return imgs


def test_annotation_and_host_batches_equal_jax(rng):
    imgs = renders(rng)
    for img in imgs:
        assert tds.auto_annotate(img) == jds.auto_annotate(img)
        np.testing.assert_array_equal(tds.annotation_mask(img), jds.annotation_mask(img))
        u8 = (np.clip(img[..., :3], 0, 1) * 255).astype(np.uint8)
        assert tds.auto_annotate(u8) == jds.auto_annotate(u8)
    assert tds.auto_annotate(imgs[3]) is None
    dc, jdc = DetectorConfig(num_classes=3, image_size=32), JDC(num_classes=3, image_size=32)
    got = tds.prepare_images(imgs, dc, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(jds.prepare_images(imgs, jdc)),
                               rtol=1e-6, atol=1e-6)
    assert got.shape == (4, 32, 32, 3)
    with pytest.raises(ValueError):
        tds.prepare_images(imgs, DetectorConfig(image_size=16), device="cpu")
    got = tds.build_detector_batches(imgs, [0, 1, 2, 1], dc, device="cpu")
    want = jds.build_detector_batches(imgs, [0, 1, 2, 1], jdc)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the device path's slot 0 is the host path's box
    dev = tds.build_detector_batches_device(imgs, [0, 1, 2, 1], dc, device="cpu")
    np.testing.assert_array_equal(dev[3][:, 0].numpy(), got[3][:, 0].numpy())
    np.testing.assert_array_equal(dev[1][:, 0].numpy(), got[1][:, 0].numpy())


def write_pngs(root, rng):
    import imageio.v2 as imageio

    for cate in ("a", "b"):
        d = root / "src" / cate
        d.mkdir(parents=True)
        for i in range(2):
            img = np.zeros((16, 20, 3), np.uint8)
            img[4 + i:12, 4:12 + i] = 255
            img[14, 1] = 90 * i                       # a second, tiny component
            imageio.imwrite(str(d / f"{i:06d}.png"), img)
    return {c: str(root / "src" / c) for c in ("a", "b")}


def test_coco_export_and_catalogs_equal_jax(tmp_path, rng):
    dirs = write_pngs(tmp_path, rng)
    docs = {}
    for side, ds in (("jax", jds), ("port", tds)):
        out = tmp_path / side / "D_train"
        docs[side] = ds.write_coco_json(dirs, str(out / "train.json"),
                                        copy_to=str(out / "train"), with_rle_masks=True)
    assert (json.loads((tmp_path / "port" / "D_train" / "train.json").read_text())
            == json.loads((tmp_path / "jax" / "D_train" / "train.json").read_text()))
    assert docs["port"]["annotations"][0]["bbox"] == [4, 4, 8, 8]
    assert (tds.dataset_dicts_from_dirs(str(tmp_path / "src"), {"a": 1, "b": 2})
            == jds.dataset_dicts_from_dirs(str(tmp_path / "src"), {"a": 1, "b": 2}))

    out = tmp_path / "port" / "D_train"
    records = []
    for cat in (jcat, tcat):
        ds_cat, md_cat = cat.DatasetCatalog(), cat.MetadataCatalog()
        md = cat.register_coco_instances("t", {"evaluator_type": "coco"}, str(out / "train.json"),
                                         str(out / "train"), ds_cat, md_cat)
        with pytest.raises(KeyError):
            ds_cat.register("t", list)
        records.append((ds_cat.get("t"), md.as_dict(), ds_cat.list(), md_cat.list()))
        ds_cat.remove("t")
        ds_cat.register("t", list)
        md.thing_classes = md.thing_classes
        with pytest.raises(AttributeError):
            md.thing_classes = ["other"]
    assert records[0] == records[1]

    info = {"train_info": {"2": "x", "5": "bg5"}, "test_info": {"one_1": {"2": "v2"}}}
    path = tmp_path / "info.json"
    path.write_text(json.dumps(info))
    args = (str(path), "one_1", "2", "/rendered", "/base")
    assert tds.resolve_train_val_dirs(*args) == jds.resolve_train_val_dirs(*args)


def test_transforms_equal_jax(rng):
    img = rng.rand(20, 24, 3).astype(np.float32)
    boxes = np.array([[2, 3, 10, 12], [5, 1, 20, 18]], np.float32)
    for make in (lambda m: m.resize(31, 17), lambda m: m.hflip(), lambda m: m.vflip(),
                 lambda m: m.crop(2, 3, 12, 15), lambda m: m.brightness(1.3),
                 lambda m: m.contrast(0.7), lambda m: m.saturation(1.5),
                 lambda m: m.compose([m.hflip(), m.resize(10, 12), m.brightness(0.9)]),
                 lambda m: m.compose([]),
                 lambda m: m.random_crop(0.6, np.random.RandomState(4)),
                 lambda m: m.random_flip(0.5, np.random.RandomState(5), horizontal=False)):
        gi, gb = make(ttr)(img, boxes.copy())
        wi, wb = make(jtr)(img, boxes.copy())
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gb, wb)


def test_predictor_equals_jax(rng):
    dc, jdc = DetectorConfig(num_classes=2, image_size=64), JDC(num_classes=2, image_size=64)
    port, flax = controlled_params(dc, rng)
    img = np.zeros((50, 60, 3), np.float32)
    img[10:40, 10:40] = 0.8
    got = tpred.DetectorPredictor(port, dc)(img)
    want = jpred.DetectorPredictor(flax, jdc)(img)
    assert len(got["boxes"]) > 10
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=1e-4, atol=1e-4)
    drawn = tpred.draw_detections(img, got["boxes"], got["labels"], got["scores"], thickness=2)
    np.testing.assert_array_equal(
        drawn, jpred.draw_detections(img, want["boxes"], want["labels"], want["scores"], 2))
    u8 = (img * 255).astype(np.uint8)
    np.testing.assert_array_equal(tpred.draw_detections(u8, [[4, 4, 20, 25]]),
                                  jpred.draw_detections(u8, [[4, 4, 20, 25]]))
