"""COCO-style mAP evaluation (bbox), first-party (the port of
``neuralsim_tpu/detector/evaluator.py``: ``coco_map`` is a copy, numpy only).

Replaces the reference's ``COCOEvaluator`` + pycocotools COCOeval
(``optimization/neural_sim_main.py:847-853``) with a numpy implementation of
the full COCO bbox protocol: greedy per-image score-ordered matching at IoU
thresholds 0.50:0.05:0.95 with iscrowd and area-range ignore semantics
(pycocotools cocoeval.py evaluateImg/accumulate), 101-point interpolated AP,
maxDets=100, averaged over classes with ground truth. Reports the full
detectron2 bbox key set (AP, AP50, AP75, APs, APm, APl + per-class) so
save_result.txt lines carry the same dict keys as the reference.

The matching loop is vectorized over the 10 IoU thresholds (one python
iteration per detection instead of per (threshold, detection)) — same
asymptotics as pycocotools' pure-python evaluateImg, ~10x fewer python
steps.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

IOU_THRESHOLDS = np.linspace(0.5, 0.95, 10)  # exact .5:.05:.95 (COCO protocol)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)
# pycocotools areaRng (pixels^2): all, small, medium, large
AREA_RANGES = (
    ("all", 0.0, 1e10),
    ("small", 0.0, 32.0 ** 2),
    ("medium", 32.0 ** 2, 96.0 ** 2),
    ("large", 96.0 ** 2, 1e10),
)


def _box_area(b: np.ndarray) -> np.ndarray:
    return (np.clip(b[:, 2] - b[:, 0], 0, None)
            * np.clip(b[:, 3] - b[:, 1], 0, None))


def _iou_matrix(det: np.ndarray, gt: np.ndarray,
                gt_crowd: np.ndarray) -> np.ndarray:
    """IoU with pycocotools' crowd convention: for iscrowd gt the
    denominator is the DET area (a det fully inside a crowd region scores
    1.0), else the union."""
    lt = np.maximum(det[:, None, :2], gt[None, :, :2])
    rb = np.minimum(det[:, None, 2:], gt[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_d = _box_area(det)
    area_g = _box_area(gt)
    union = area_d[:, None] + area_g[None, :] - inter
    denom = np.where(gt_crowd[None, :], area_d[:, None], union)
    return np.where(denom > 0, inter / np.maximum(denom, 1e-12), 0.0)


def _match_image(iou: np.ndarray, gt_ignore: np.ndarray,
                 gt_crowd: np.ndarray, det_out_of_range: np.ndarray):
    """Greedy COCO matching for one (image, class, area-range), all IoU
    thresholds at once (pycocotools evaluateImg semantics).

    Per score-ordered det: among gts with iou >= thr that are not already
    taken (crowd gts are never blocked), prefer a NON-ignored gt (max IoU,
    later index wins ties) over any ignored one; fall back to the
    max-IoU ignored gt. A det matched to an ignored gt — or unmatched with
    its own area outside the range — is ignored (neither TP nor FP).

    Returns (matched [T, D] bool, det_ignored [T, D] bool).
    """
    t = len(IOU_THRESHOLDS)
    d, g = iou.shape
    matched = np.zeros((t, d), bool)
    dt_ig = np.zeros((t, d), bool)
    if g == 0:
        dt_ig |= det_out_of_range[None, :]
        return matched, dt_ig

    taken = np.zeros((t, g), bool)
    thr = np.minimum(IOU_THRESHOLDS, 1.0 - 1e-10)[:, None]   # [T, 1]
    # "later index wins ties": argmax on the reversed axis
    rev = slice(None, None, -1)
    for di in range(d):
        cand = (iou[di][None, :] >= thr) & (~taken | gt_crowd[None, :])
        cand_n = cand & ~gt_ignore[None, :]
        cand_i = cand & gt_ignore[None, :]
        use_n = cand_n.any(axis=1)
        pick_from = np.where(use_n[:, None], cand_n, cand_i)
        any_pick = pick_from.any(axis=1)
        iou_masked = np.where(pick_from, iou[di][None, :], -1.0)
        best = g - 1 - np.argmax(iou_masked[:, rev], axis=1)
        rows = np.where(any_pick)[0]
        if rows.size:
            cols = best[rows]
            matched[rows, di] = True
            dt_ig[rows, di] = gt_ignore[cols]
            taken[rows, cols] = True
    # unmatched dets outside the area range are ignored, not FPs
    dt_ig |= (~matched) & det_out_of_range[None, :]
    return matched, dt_ig


def coco_map(detections: Sequence[Dict], ground_truth: Sequence[Dict],
             max_dets: int = 100,
             class_names: Optional[Dict[int, str]] = None) -> Dict[str, float]:
    """Compute bbox AP with the full COCOeval protocol.

    Args:
      detections: per-image dicts {"boxes": [D,4] XYXY, "scores": [D],
        "labels": [D] int} (invalid rows removed by the caller).
      ground_truth: per-image dicts {"boxes": [G,4] XYXY, "labels": [G]};
        optional "iscrowd": [G] bool (crowd regions are ignore-matched, as
        pycocotools) and "areas": [G] (the COCO annotation 'area' field;
        defaults to the box area — our auto-annotation emits box-tight
        masks, so the two coincide for pipeline-generated data).
      class_names: optional {label: name} for the per-class keys (the
        reference logs detectron2's AP-{thing_class} names).

    Returns {"AP", "AP50", "AP75", "APs", "APm", "APl",
    "AP-per-class": {...}} — the detectron2 bbox result key set
    (neural_sim_main.py:847-853 logs str() of that dict).
    """
    assert len(detections) == len(ground_truth)
    classes = sorted(
        {int(l) for g in ground_truth for l in np.atleast_1d(g["labels"])}
    )
    n_t, n_a = len(IOU_THRESHOLDS), len(AREA_RANGES)

    # ap_table[t, a, c]: AP at (iou threshold, area range, class)
    ap_table = np.full((n_t, n_a, len(classes)), np.nan)
    for ci, cls in enumerate(classes):
        # per-image per-range matches, gathered then globally score-sorted
        scores_all: List[np.ndarray] = []
        match_all: List[List[np.ndarray]] = [[] for _ in range(n_a)]
        ignore_all: List[List[np.ndarray]] = [[] for _ in range(n_a)]
        n_gt = np.zeros(n_a, np.int64)

        for det, gt in zip(detections, ground_truth):
            d_mask = np.asarray(det["labels"]) == cls
            d_boxes = np.asarray(det["boxes"], np.float64)[d_mask]
            d_scores = np.asarray(det["scores"], np.float64)[d_mask]
            order = np.argsort(-d_scores, kind="mergesort")[:max_dets]
            d_boxes, d_scores = d_boxes[order], d_scores[order]
            d_areas = _box_area(d_boxes)

            g_mask = np.asarray(gt["labels"]) == cls
            g_boxes = np.asarray(gt["boxes"], np.float64)[g_mask]
            g_crowd = (np.asarray(gt["iscrowd"], bool)[g_mask]
                       if "iscrowd" in gt
                       else np.zeros(len(g_boxes), bool))
            g_areas = (np.asarray(gt["areas"], np.float64)[g_mask]
                       if "areas" in gt else _box_area(g_boxes))

            if len(d_boxes) == 0 and len(g_boxes) == 0:
                continue
            iou = _iou_matrix(d_boxes, g_boxes, g_crowd)

            for ai, (_, lo, hi) in enumerate(AREA_RANGES):
                g_ig = g_crowd | (g_areas < lo) | (g_areas > hi)
                # gts sorted non-ignored first (stable), pycocotools order
                g_order = np.argsort(g_ig, kind="mergesort")
                d_oor = (d_areas < lo) | (d_areas > hi)
                m, ig = _match_image(iou[:, g_order], g_ig[g_order],
                                     g_crowd[g_order], d_oor)
                n_gt[ai] += int((~g_ig).sum())
                match_all[ai].append(m)
                ignore_all[ai].append(ig)
            scores_all.append(d_scores)

        if not scores_all:
            scores_cat = np.zeros((0,), np.float64)
        else:
            scores_cat = np.concatenate(scores_all)
        order = np.argsort(-scores_cat, kind="mergesort")

        for ai in range(n_a):
            if n_gt[ai] == 0:
                continue  # class absent at this area range -> NaN (skipped)
            if scores_cat.size == 0:
                ap_table[:, ai, ci] = 0.0
                continue
            m_cat = np.concatenate(match_all[ai], axis=1)[:, order]
            ig_cat = np.concatenate(ignore_all[ai], axis=1)[:, order]
            tps = m_cat & ~ig_cat
            fps = ~m_cat & ~ig_cat
            tp_sum = np.cumsum(tps, axis=1)
            fp_sum = np.cumsum(fps, axis=1)
            for ti in range(n_t):
                tp, fp = tp_sum[ti], fp_sum[ti]
                recall = tp / n_gt[ai]
                precision = tp / np.maximum(tp + fp, 1e-12)
                # monotone-decreasing precision envelope (running max from
                # the right — was a python loop, 1M+ steps on real val sets)
                precision = np.maximum.accumulate(precision[::-1])[::-1]
                idx = np.searchsorted(recall, RECALL_POINTS, side="left")
                p_at_r = np.where(
                    idx < len(precision),
                    precision[np.minimum(idx, len(precision) - 1)], 0.0)
                ap_table[ti, ai, ci] = p_at_r.mean()

    def _mean(tbl: np.ndarray) -> float:
        return (float(np.nanmean(tbl)) * 100
                if ~np.isnan(tbl).all() else float("nan"))

    a_all = ap_table[:, 0, :]
    result = {
        "AP": _mean(a_all),
        "AP50": _mean(a_all[0]),
        "AP75": _mean(a_all[5]),
        "APs": _mean(ap_table[:, 1, :]),
        "APm": _mean(ap_table[:, 2, :]),
        "APl": _mean(ap_table[:, 3, :]),
        "AP-per-class": {
            (class_names[cls] if class_names else str(cls)):
                float(np.nanmean(a_all[:, ci])) * 100
            for ci, cls in enumerate(classes)
            if not np.isnan(a_all[:, ci]).all()
        },
    }
    return result


def detections_to_eval(det_batch, valid_only: bool = True) -> List[Dict]:
    """Convert a models.retinanet.Detections of tensors to evaluator
    inputs, with one device-to-host transfer (boxes, scores, labels and
    validity packed into one float32 tensor; labels are small integers,
    exact in float32)."""
    import torch

    packed = torch.cat([det_batch.boxes.to(torch.float32),
                        det_batch.scores[..., None].to(torch.float32),
                        det_batch.labels[..., None].to(torch.float32),
                        det_batch.valid[..., None].to(torch.float32)], dim=-1)
    packed = packed.detach().cpu().numpy()
    boxes, scores = packed[..., :4], packed[..., 4]
    labels, valid = packed[..., 5].astype(np.int64), packed[..., 6] > 0
    out = []
    for i in range(boxes.shape[0]):
        m = valid[i] if valid_only else np.ones(boxes.shape[1], bool)
        out.append({"boxes": boxes[i][m], "scores": scores[i][m],
                    "labels": labels[i][m]})
    return out
