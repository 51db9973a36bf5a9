"""Box utilities: IoU, Faster-RCNN-style delta encoding, anchor matching
(a copy of
``neuralsim_tpu_torch/ops/boxes.py``).

Boxes are XYXY float32 throughout. Every function takes leading batch
dimensions on its box arguments, so the detector's loss matches a whole
batch in one call.
"""

from __future__ import annotations

import math

import torch

# detectron2's Box2BoxTransform clamp of dw, dh: log(1000 / 16)
DELTA_CLIP = math.log(1000.0 / 16)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
            * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0))


def pairwise_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """IoU matrix [..., A, B] for XYXY boxes [..., A, 4] and [..., B, 4]."""
    lt = torch.maximum(boxes_a[..., :, None, :2], boxes_b[..., None, :, :2])
    rb = torch.minimum(boxes_a[..., :, None, 2:], boxes_b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(boxes_a)[..., :, None] + box_area(boxes_b)[..., None, :] - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-10),
                       torch.zeros_like(inter))


def encode_deltas(anchors: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """(dx, dy, dw, dh) regression targets of ``boxes`` w.r.t. ``anchors``
    (Faster-RCNN parameterization, weights (1, 1, 1, 1))."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + 0.5 * aw
    ay = anchors[..., 1] + 0.5 * ah

    bw = boxes[..., 2] - boxes[..., 0]
    bh = boxes[..., 3] - boxes[..., 1]
    bx = boxes[..., 0] + 0.5 * bw
    by = boxes[..., 1] + 0.5 * bh

    aw_, ah_ = torch.clamp(aw, min=1e-6), torch.clamp(ah, min=1e-6)
    return torch.stack([
        (bx - ax) / aw_,
        (by - ay) / ah_,
        torch.log(torch.clamp(bw, min=1e-6) / aw_),
        torch.log(torch.clamp(bh, min=1e-6) / ah_),
    ], dim=-1)


def match_anchors(anchors: torch.Tensor, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                  fg_thresh: float = 0.5, bg_thresh: float = 0.4):
    """RetinaNet anchor matching with low-quality matches.

    Args:
      anchors: [A, 4].
      gt_boxes: [..., G, 4] (padded).
      gt_valid: [..., G] bool mask of real boxes.

    Returns:
      matched_idx: [..., A] int64 index into gt (argmax IoU; the first of
        equal maxima, as jnp.argmax).
      labels: [..., A] int64: 1 fg, 0 bg, -1 ignore (between thresholds).
    """
    iou = pairwise_iou(anchors, gt_boxes)                     # [..., A, G]
    valid = gt_valid[..., None, :]
    iou = torch.where(valid, iou, torch.full_like(iou, -1.0))
    matched_iou = iou.amax(dim=-1)
    matched_idx = torch.argmax(iou, dim=-1)

    one = torch.ones_like(matched_idx)
    labels = torch.where(matched_iou >= fg_thresh, one,
                         torch.where(matched_iou < bg_thresh, torch.zeros_like(one), -one))

    # low-quality matches: each gt's best anchor becomes fg even below the
    # threshold (detectron2 Matcher allow_low_quality_matches)
    best_per_gt = iou.amax(dim=-2, keepdim=True)               # [..., 1, G]
    is_best = (iou == best_per_gt) & valid & (iou > 0)
    force_fg = is_best.any(dim=-1)
    labels = torch.where(force_fg, one, labels)
    low_quality = torch.argmax(torch.where(is_best, iou, torch.full_like(iou, -1.0)), dim=-1)
    matched_idx = torch.where(force_fg, low_quality, matched_idx)

    # an image with no real box is all background
    labels = torch.where(gt_valid.any(dim=-1, keepdim=True), labels, torch.zeros_like(labels))
    return matched_idx, labels
