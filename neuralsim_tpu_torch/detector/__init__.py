"""The detector stack (the names of ``neuralsim_tpu.detector``):
RetinaNet-R50-FPN inner fine-tune, auto-annotation and COCO mAP."""

from neuralsim_tpu_torch.detector.trainer import (
    DetectorState,
    init_detector,
    inner_train,
    make_detector_apply,
)
from neuralsim_tpu_torch.detector.dataset import (
    auto_annotate,
    build_detector_batches,
    prepare_images,
)
from neuralsim_tpu_torch.detector.evaluator import coco_map

__all__ = [
    "DetectorState",
    "init_detector",
    "inner_train",
    "make_detector_apply",
    "auto_annotate",
    "build_detector_batches",
    "prepare_images",
    "coco_map",
]
