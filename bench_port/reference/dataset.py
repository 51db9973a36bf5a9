"""Detector inputs: the renders annotated on the device and normalized
(a copy of ``build_detector_batches_device`` and ``prepare_images`` of
``neuralsim_tpu_torch/detector/dataset.py``): grayscale, threshold > 1/255,
8-connected components, their boxes."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from bench_port.reference.common import resolve_device
from bench_port.reference.config import DetectorConfig
from bench_port.reference.components import component_boxes

# ITU-R BT.601 luma: what cv2.cvtColor(RGB2GRAY) computes (reference :793)
_LUMA = np.array([0.299, 0.587, 0.114], np.float32)


def _as_images(images, device) -> torch.Tensor:
    """float32 tensor of ``images``: a tensor stays on its device, anything
    else goes to ``device`` (``cuda`` unless the caller asks for the CPU)."""
    if isinstance(images, torch.Tensor):
        return images.to(torch.float32)
    return torch.as_tensor(np.asarray(images, np.float32), device=resolve_device(device))


def prepare_images(images, dc: DetectorConfig,
                   pixel_mean: Sequence[float] = (0.485, 0.456, 0.406),
                   pixel_std: Sequence[float] = (0.229, 0.224, 0.225), device=None):
    """RGBA/RGB renders [N,H,W,C] in [0,1] -> padded normalized model input
    [N, S, S, 3] (top-left pad to dc.image_size, so pixels stay aligned
    with the render and image gradients align pixel for pixel)."""
    imgs = _as_images(images, device)[..., :3]
    _, h, w, _ = imgs.shape
    s = dc.image_size
    if h > s or w > s:
        raise ValueError(f"renders {h}x{w} exceed detector input {s}")
    imgs = F.pad(imgs, (0, 0, 0, s - w, 0, s - h))
    mean = torch.tensor(pixel_mean, dtype=torch.float32, device=imgs.device)
    std = torch.tensor(pixel_std, dtype=torch.float32, device=imgs.device)
    return (imgs - mean) / std


def build_detector_batches_device(images, labels: Sequence[int], dc: DetectorConfig,
                                  max_boxes: int = 4, largest_only: bool = False,
                                  device=None):
    """The device-resident twin of build_detector_batches: renders stay on
    the device into the detector. Boxes come from exact 8-connected
    components computed on the device (``ops.components``), so slot 0 is
    the host auto_annotate's largest-component box exactly; the other
    slots carry the next-largest components (same class label), which the
    reference's single-box annotation drops (neural_sim_main.py:689-690);
    ``largest_only=True`` keeps that behaviour.

    Runs on the images' device (a numpy array goes to ``device``). Returns
    (model inputs [N,S,S,3], gt_boxes [N,max_boxes,4] XYXY, gt_labels
    [N,max_boxes] int64, gt_valid [N,max_boxes] bool)."""
    imgs = _as_images(images, device)[..., :3]
    n = imgs.shape[0]
    # floor, as the host path's to8b truncation ((clip*255).astype(uint8),
    # reference run_nerf_helpers.py:14), then the luma as a float32 sum of
    # the three channels (no matmul, which may run in TF32 on the card)
    u8 = torch.floor(torch.clamp(imgs.detach(), 0.0, 1.0) * 255.0)
    luma = [float(c) for c in _LUMA]
    gray = torch.round(u8[..., 0] * luma[0] + u8[..., 1] * luma[1] + u8[..., 2] * luma[2])
    gt_boxes, gt_valid = component_boxes(gray > 1.0, max_boxes)
    if largest_only:
        gt_valid[:, 1:] = False
        gt_boxes[:, 1:] = 0.0
    gt_labels = torch.as_tensor(labels, dtype=torch.int64, device=imgs.device)[:, None]
    gt_labels = torch.where(gt_valid, gt_labels.expand(n, max_boxes), 0)
    return prepare_images(imgs, dc), gt_boxes, gt_labels, gt_valid
