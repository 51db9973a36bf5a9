"""Single-image prediction + box visualization (the port of
``neuralsim_tpu/detector/predictor.py``).

The DefaultPredictor / Visualizer capability of the reference's detectron2
stack (``utils/defaults.py`` predictor; visualization used in commented-out
dataset checks, ``neural_sim_main.py:773-780``): run one image through the
detector and draw the resulting boxes.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from neuralsim_tpu_torch.config import DetectorConfig
from neuralsim_tpu_torch.detector.dataset import prepare_images
from neuralsim_tpu_torch.detector.evaluator import detections_to_eval
from neuralsim_tpu_torch.detector.trainer import make_detector_apply
from neuralsim_tpu_torch.models.retinanet import generate_anchors, retinanet_inference


class DetectorPredictor:
    """predictor(image) -> {"boxes", "scores", "labels"} for one image, on
    the device of ``params``."""

    def __init__(self, params, dc: DetectorConfig,
                 class_names: Optional[Sequence[str]] = None):
        self.params = params
        self.dc = dc
        self.class_names = class_names
        self.device = next(iter(params.values())).device
        self.anchors = generate_anchors(dc.image_size, self.device)
        _, self.apply_fn = make_detector_apply(dc)

    @torch.no_grad()
    def __call__(self, image: np.ndarray) -> Dict[str, np.ndarray]:
        """image: [H, W, 3+] float in [0,1] or uint8."""
        img = np.asarray(image)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        inputs = prepare_images(img[None, ..., :3], self.dc, device=self.device)
        dets = retinanet_inference(self.apply_fn, self.params, inputs, self.anchors, self.dc)
        return detections_to_eval(dets)[0]


_PALETTE = np.array([
    [230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
    [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
], np.uint8)


def draw_detections(image: np.ndarray, boxes, labels=None, scores=None,
                    thickness: int = 1) -> np.ndarray:
    """Draw XYXY boxes on a copy of the image (uint8 out)."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img[..., :3], 0, 1) * 255).astype(np.uint8)
    else:
        img = img[..., :3].copy()
    h, w = img.shape[:2]
    for i, box in enumerate(np.asarray(boxes)):
        x0, y0, x1, y1 = [int(round(float(v))) for v in box]
        x0, x1 = np.clip([x0, x1], 0, w - 1)
        y0, y1 = np.clip([y0, y1], 0, h - 1)
        color = _PALETTE[int(labels[i]) % len(_PALETTE)] if labels is not None \
            else _PALETTE[0]
        for t in range(thickness):
            img[y0 + t, x0:x1 + 1] = color
            img[max(y1 - t, 0), x0:x1 + 1] = color
            img[y0:y1 + 1, x0 + t] = color
            img[y0:y1 + 1, max(x1 - t, 0)] = color
    return img
