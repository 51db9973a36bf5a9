"""Fixed-shape non-maximum suppression (the port of
``neuralsim_tpu/ops/nms.py``).

``max_out`` rounds of pick-argmax / suppress-overlaps over a score vector,
with the pick's IoU row computed on the fly each round (O(max_out * N)
work, O(N) memory). The rounds run over every image of a batch at once:
leading dimensions of ``boxes`` and ``scores`` are batch dimensions.
"""

from __future__ import annotations

import torch

from neuralsim_tpu_torch.ops.boxes import box_area


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float, max_out: int):
    """Greedy NMS.

    Args:
      boxes: [..., N, 4] XYXY.
      scores: [..., N] (suppressed or invalid entries carry -inf; NaN and
        +inf count as -inf).
      max_out: number of picks.

    Returns:
      keep_idx: [..., max_out] int64 indices into boxes (the first of equal
        scores, as jnp.argmax; padding picks repeat an index).
      keep_valid: [..., max_out] bool, False for padded tail picks.
    """
    lead, n = scores.shape[:-1], scores.shape[-1]
    flat = boxes.reshape(-1, n, 4)
    live = scores.reshape(-1, n)
    ninf = torch.tensor(-torch.inf, dtype=live.dtype, device=live.device)
    live = torch.where(torch.isfinite(live), live, ninf)
    areas = box_area(flat)                                      # [B, N]
    rows = torch.arange(flat.shape[0], device=flat.device)
    cols = torch.arange(n, device=flat.device)
    keep_idx, keep_valid = [], []
    for _ in range(max_out):
        best = torch.argmax(live, dim=1)                        # [B]
        valid = live[rows, best] > -torch.inf
        box = flat[rows, best]                                  # [B, 4]
        lt = torch.maximum(box[:, None, :2], flat[..., :2])
        rb = torch.minimum(box[:, None, 2:], flat[..., 2:])
        wh = torch.clamp(rb - lt, min=0.0)
        inter = wh[..., 0] * wh[..., 1]
        union = areas[rows, best][:, None] + areas - inter
        iou = torch.where(union > 0, inter / torch.clamp(union, min=1e-10),
                          torch.zeros_like(inter))
        # suppress the overlaps of the pick, the pick included
        suppress = (iou > iou_threshold) | (cols[None, :] == best[:, None])
        live = torch.where(valid[:, None] & suppress, ninf, live)
        keep_idx.append(best)
        keep_valid.append(valid)
    return (torch.stack(keep_idx, dim=-1).reshape(*lead, max_out),
            torch.stack(keep_valid, dim=-1).reshape(*lead, max_out))


def batched_class_nms(boxes: torch.Tensor, scores: torch.Tensor, labels: torch.Tensor,
                      iou_threshold: float, max_out: int):
    """Per-class NMS by the coordinate-offset trick (boxes of different
    classes never overlap), detectron2's batched_nms semantics. The offset
    spans every candidate box of the image, those with a score of -inf
    included, as in the JAX package."""
    span = boxes.amax(dim=(-2, -1)) - boxes.amin(dim=(-2, -1)) + 1.0    # [...]
    offsets = labels.to(boxes.dtype) * span[..., None]
    return nms(boxes + offsets[..., None], scores, iou_threshold, max_out)
