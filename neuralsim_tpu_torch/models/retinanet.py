"""RetinaNet-R50-FPN: model, anchors, losses, fixed-shape inference (the
port of ``neuralsim_tpu/models/retinanet.py``).

The reference's detectron2 RetinaNet (``COCO-Detection/retinanet_R_50_FPN_3x``
with the overrides of ``optimization/neural_sim_main.py:594-622``). Anchor
matching, the focal and smooth-L1 losses and top-k + NMS inference are
fixed-shape tensor code over the whole batch.

Images enter as [N, S, S, 3] (NHWC, as ``detector.dataset.prepare_images``
returns them); the convolutions run NCHW, and each head output is permuted
back to NHWC before it is flattened, so anchor a of the concatenated
outputs is (row, col, anchor) in the JAX package's order.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from neuralsim_tpu_torch import draw
from neuralsim_tpu_torch.config import DetectorConfig
from neuralsim_tpu_torch.models.fpn import FPN
from neuralsim_tpu_torch.models.resnet import FrozenBN, ResNet50, conv
from neuralsim_tpu_torch.ops.boxes import decode_deltas, encode_deltas, match_anchors
from neuralsim_tpu_torch.ops.nms import batched_class_nms
from neuralsim_tpu_torch.ops.render import top_k_indices

STRIDES = (8, 16, 32, 64, 128)
SIZES = (32, 64, 128, 256, 512)
SCALES = tuple(2.0 ** (i / 3.0) for i in range(3))
RATIOS = (0.5, 1.0, 2.0)
NUM_ANCHORS = len(SCALES) * len(RATIOS)  # 9


def generate_anchors(image_size: int, device="cpu") -> List[torch.Tensor]:
    """Per-level anchor boxes [H*W*9, 4] (XYXY, image coords), centres at
    (i + 0.5) * stride on a ceil(side / stride) grid (the cells of the
    SAME-padded strided convs), scale-major then ratio order."""
    levels = []
    for stride, size in zip(STRIDES, SIZES):
        fs = -(-image_size // stride)
        base = []
        for scale in SCALES:
            area = (size * scale) ** 2
            for ratio in RATIOS:
                w = math.sqrt(area / ratio)
                h = w * ratio
                base.append([-w / 2, -h / 2, w / 2, h / 2])
        base = torch.tensor(base, dtype=torch.float32, device=device)      # [9, 4]
        ctr = (torch.arange(fs, dtype=torch.float32, device=device) + 0.5) * stride
        cy, cx = torch.meshgrid(ctr, ctr, indexing="ij")
        shifts = torch.stack([cx, cy, cx, cy], dim=-1).reshape(-1, 1, 4)
        levels.append((shifts + base[None]).reshape(-1, 4))
    return levels


class RetinaNetHead(nn.Module):
    def __init__(self, num_classes: int, num_convs: int = 4, channels: int = 256,
                 prior_prob: float = 0.01):
        super().__init__()
        self.num_classes = num_classes
        self.num_convs = num_convs
        self.prior_prob = prior_prob
        for i in range(num_convs):
            self.add_module(f"cls_tower{i}", conv(channels, channels, 3, padding=1))
        for i in range(num_convs):
            self.add_module(f"box_tower{i}", conv(channels, channels, 3, padding=1))
        self.cls_score = conv(channels, NUM_ANCHORS * num_classes, 3, padding=1)
        self.bbox_pred = conv(channels, NUM_ANCHORS * 4, 3, padding=1)

    def forward(self, features: List[torch.Tensor]):
        logits, deltas = [], []
        for feat in features:  # one set of weights for every level
            c = feat
            b = feat
            for i in range(self.num_convs):
                c = F.relu(getattr(self, f"cls_tower{i}")(c))
            for i in range(self.num_convs):
                b = F.relu(getattr(self, f"box_tower{i}")(b))
            n, _, h, w = feat.shape
            logits.append(self.cls_score(c).permute(0, 2, 3, 1)
                          .reshape(n, h * w * NUM_ANCHORS, self.num_classes))
            deltas.append(self.bbox_pred(b).permute(0, 2, 3, 1)
                          .reshape(n, h * w * NUM_ANCHORS, 4))
        return torch.cat(logits, dim=1), torch.cat(deltas, dim=1)


class RetinaNet(nn.Module):
    def __init__(self, num_classes: int = 6, fpn_p6_source: str = "c5"):
        super().__init__()
        self.backbone = ResNet50()
        self.fpn = FPN(p6_source=fpn_p6_source)
        self.head = RetinaNetHead(num_classes)

    def forward(self, images):
        """images: [N, H, W, 3] normalized. Returns (logits [N, A, C],
        deltas [N, A, 4]) over all pyramid anchors.

        Backbone freezing is a parameter-side matter
        (``detector.trainer.split_trainable``): d loss / d images flows
        through the frozen backbone."""
        c3, c4, c5 = self.backbone(images.permute(0, 3, 1, 2))
        return self.head(self.fpn(c3, c4, c5))


def init_params(model: nn.Module, generator: torch.Generator = None,
                device="cpu") -> Dict[str, torch.Tensor]:
    """Fresh parameters of ``model`` by name, with the Flax modules'
    initialisers: lecun-normal conv weights (a normal truncated at 2
    standard deviations, scaled to variance 1 / fan_in), zero biases, the
    focal-loss prior on the class logits' bias, FrozenBN scale 1 and bias 0.
    Drawn from ``generator`` (the port's own stream: JAX's threefry draws
    cannot be matched)."""
    params = {}
    for mname, module in model.named_modules():
        prefix = f"{mname}." if mname else ""
        if isinstance(module, nn.Conv2d):
            cout, cin, kh, kw = module.weight.shape
            # inverse-CDF draw of the standard normal truncated to [-2, 2]
            lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
            u = lo + (1 - 2 * lo) * draw((cout, cin, kh, kw), generator, device)
            z = math.sqrt(2) * torch.erfinv(2 * u - 1)
            # 0.8796...: the standard deviation of that truncated normal
            params[prefix + "weight"] = z * (math.sqrt(1 / (cin * kh * kw)) / .87962566103423978)
            if module.bias is not None:
                params[prefix + "bias"] = torch.zeros(cout, device=device)
        elif isinstance(module, FrozenBN):
            params[prefix + "scale"] = torch.ones_like(module.scale, device=device)
            params[prefix + "bias"] = torch.zeros_like(module.bias, device=device)
    for mname, module in model.named_modules():
        if isinstance(module, RetinaNetHead):
            prior = -math.log((1.0 - module.prior_prob) / module.prior_prob)
            params[f"{mname}.cls_score.bias"] = torch.full(
                (NUM_ANCHORS * module.num_classes,), prior, device=device)
    names = [name for name, _ in model.named_parameters()]
    assert sorted(names) == sorted(params), "a parameter kind has no initialiser"
    return {name: params[name] for name in names}


# --------------------------------------------------------------------------- #
# Losses
# --------------------------------------------------------------------------- #


def sigmoid_ce(logits, labels):
    """Sigmoid cross-entropy, in optax's stable form."""
    return torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def sigmoid_focal_loss(logits, targets_onehot, alpha: float, gamma: float):
    """Per-element focal loss; sum over classes."""
    p = torch.sigmoid(logits)
    ce = sigmoid_ce(logits, targets_onehot)
    p_t = p * targets_onehot + (1 - p) * (1 - targets_onehot)
    alpha_t = alpha * targets_onehot + (1 - alpha) * (1 - targets_onehot)
    return torch.sum(alpha_t * ((1 - p_t) ** gamma) * ce, dim=-1)


def smooth_l1(x, beta: float):
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


class DetBatch(NamedTuple):
    """One detector batch: images + padded GT."""

    images: torch.Tensor     # [N, H, W, 3]
    gt_boxes: torch.Tensor   # [N, G, 4] XYXY (padded)
    gt_labels: torch.Tensor  # [N, G] 0-based class ids
    gt_valid: torch.Tensor   # [N, G] bool


def retinanet_loss(apply_fn, params, batch: DetBatch, anchors: torch.Tensor,
                   dc: DetectorConfig, image_weight=None, fg_total=None,
                   per_image_norm: bool = False):
    """Total loss (focal cls + smooth-L1 box), normalized by the number of
    fg anchors: the sum of detectron2's loss dict that the reference
    backprops (``neural_sim_main.py:555-589``).

    ``image_weight``: optional [N] weights. Weight 0 removes an image from
    the loss sums and from the fg count, so a zero-padded batch has the
    loss of the smaller batch.

    ``fg_total``: maps this batch's fg count to the whole batch's when the
    batch is one rank's block of a data-parallel step (a sum over the data
    group): the loss sums stay local, the normalizer is the whole batch's,
    so the group's losses and gradients sum to those of the whole batch.

    ``per_image_norm``: each image's sums over its own clamped fg count,
    ``sum_i w_i (cls_i + box_i) / max(n_fg_i w_i, 1)``: the sum of the
    images' batch-1 losses, so no image's term depends on another image
    (grad_E's batches, ``hypergrad.influence.mixed_grad_wrt_image_batch``).
    It leaves ``fg_total`` unused. The default is the whole batch's
    normalizer, detectron2's."""
    logits, deltas = apply_fn(params, batch.images)               # [N,A,C], [N,A,4]
    midx, mlabel = match_anchors(anchors, batch.gt_boxes, batch.gt_valid,
                                 dc.iou_fg_threshold, dc.iou_bg_threshold)
    fg = mlabel == 1
    not_ignore = mlabel != -1

    # a target of -1 (no fg) is a zero row, as jax.nn.one_hot gives it
    cls_target = torch.where(fg, torch.gather(batch.gt_labels.long(), 1, midx), -1)
    classes = torch.arange(dc.num_classes, device=logits.device)
    onehot = (cls_target[..., None] == classes).to(logits.dtype)
    cls_loss = sigmoid_focal_loss(logits, onehot, dc.focal_alpha, dc.focal_gamma)
    cls_l = torch.where(not_ignore, cls_loss, torch.zeros_like(cls_loss)).sum(dim=-1)

    matched = torch.gather(batch.gt_boxes, 1, midx[..., None].expand(*midx.shape, 4))
    box_loss = smooth_l1(deltas - encode_deltas(anchors, matched), dc.smooth_l1_beta).sum(-1)
    box_l = torch.where(fg, box_loss, torch.zeros_like(box_loss)).sum(dim=-1)
    n_fg = fg.to(cls_l.dtype).sum(dim=-1)
    if image_weight is not None:
        w = image_weight.to(cls_l.dtype)
        cls_l, box_l, n_fg = cls_l * w, box_l * w, n_fg * w
    if per_image_norm:
        norm = torch.clamp(n_fg, min=1.0)
        losses = {"loss_cls": (cls_l / norm).sum(), "loss_box_reg": (box_l / norm).sum()}
    else:
        n_total = n_fg.sum() if fg_total is None else fg_total(n_fg.sum())
        norm = torch.clamp(n_total, min=1.0)
        losses = {"loss_cls": cls_l.sum() / norm, "loss_box_reg": box_l.sum() / norm}
    return losses["loss_cls"] + losses["loss_box_reg"], losses


# --------------------------------------------------------------------------- #
# Inference
# --------------------------------------------------------------------------- #


class Detections(NamedTuple):
    boxes: torch.Tensor    # [N, D, 4]
    scores: torch.Tensor   # [N, D]
    labels: torch.Tensor   # [N, D]
    valid: torch.Tensor    # [N, D] bool


def retinanet_inference(apply_fn, params, images, anchors_per_level,
                        dc: DetectorConfig) -> Detections:
    """Fixed-shape decode: per-level top-k -> concat -> class NMS -> top D,
    over the whole batch at once. Runs on the images' device."""
    logits, deltas = apply_fn(params, images)
    n = logits.shape[0]
    scores_all = torch.sigmoid(logits)                             # [N, A, C]
    boxes_parts, scores_parts, labels_parts = [], [], []
    start = 0
    for anchors in anchors_per_level:
        anchors = anchors.to(logits.device)
        sl = slice(start, start + anchors.shape[0])
        start += anchors.shape[0]
        s = scores_all[:, sl].reshape(n, -1)                       # [N, a*C]
        top_i = top_k_indices(s, min(dc.topk_per_level, s.shape[1]))
        top_s = torch.gather(s, 1, top_i)
        anchor_i = top_i // dc.num_classes
        delta = torch.gather(deltas[:, sl], 1, anchor_i[..., None].expand(*anchor_i.shape, 4))
        boxes_parts.append(decode_deltas(anchors[anchor_i], delta))
        scores_parts.append(torch.where(top_s > dc.score_threshold, top_s,
                                        torch.full_like(top_s, -torch.inf)))
        labels_parts.append(top_i % dc.num_classes)
    boxes = torch.cat(boxes_parts, 1)
    scores = torch.cat(scores_parts, 1)
    labels = torch.cat(labels_parts, 1)
    keep_idx, keep_valid = batched_class_nms(boxes, scores, labels, dc.nms_threshold,
                                             dc.max_detections)
    kept_scores = torch.gather(scores, 1, keep_idx)
    return Detections(
        torch.gather(boxes, 1, keep_idx[..., None].expand(*keep_idx.shape, 4)),
        torch.where(keep_valid, kept_scores, torch.zeros_like(kept_scores)),
        torch.gather(labels, 1, keep_idx),
        keep_valid & torch.isfinite(kept_scores),
    )
