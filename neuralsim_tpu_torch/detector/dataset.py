"""Detector dataset construction: auto-annotation, batches on the device,
COCO-format export (the port of ``neuralsim_tpu/detector/dataset.py``).

Capability parity with the reference's ``createCocoJSONFromSynthetics`` /
``create_dataset`` / ``find_bbox`` / ``get_annotation``
(``optimization/neural_sim_main.py:624-832``): boxes come from the rendered
image alone (grayscale, threshold > 1/255, connected components, the
largest component's box), and a COCO JSON can be written for
interoperability. The host path uses the port's own annotation library
(``neuralsim_tpu_torch.native``); the main path
(``build_detector_batches_device``) keeps the renders on the device and
labels components there (``ops.components``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from neuralsim_tpu_torch import resolve_device
from neuralsim_tpu_torch.config import DetectorConfig
from neuralsim_tpu_torch.native import connected_components, rle_encode
from neuralsim_tpu_torch.ops.components import component_boxes

# ITU-R BT.601 luma: what cv2.cvtColor(RGB2GRAY) computes (reference :793)
_LUMA = np.array([0.299, 0.587, 0.114], np.float32)


def auto_annotate(image: np.ndarray) -> Optional[Tuple[int, int, int, int]]:
    """Largest-component bounding box (x, y, w, h) of a rendered image, or
    None for an empty image. ``image`` is [H, W, 3+] float in [0,1] or uint8."""
    stats = connected_components(annotation_mask(image))  # [(x, y, w, h, area)], no bg
    if not stats:
        return None
    x, y, w, h, _ = max(stats, key=lambda s: s[2] * s[3])
    return int(x), int(y), int(w), int(h)


def annotation_mask(image: np.ndarray) -> np.ndarray:
    """Binary foreground mask (the reference's cv2.threshold output)."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img[..., :3], 0, 1) * 255).astype(np.uint8)
    gray = (img[..., :3].astype(np.float32) @ _LUMA).round().astype(np.uint8)
    return (gray > 1).astype(np.uint8)


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


def build_detector_batches(images: np.ndarray, labels: Sequence[int], dc: DetectorConfig,
                           max_boxes: int = 4, device=None):
    """Annotate every image on the host and pack GT into padded tensors.

    Args:
      images: [N, H, W, C] rendered/synthetic images in [0,1].
      labels: per-image 0-based class id.

    Returns (model inputs [N,S,S,3], gt_boxes [N,max_boxes,4] XYXY,
    gt_labels [N,max_boxes], gt_valid [N,max_boxes]) on ``device``
    (``cuda`` unless the caller asks for the CPU).
    """
    n = len(images)
    gt_boxes = np.zeros((n, max_boxes, 4), np.float32)
    gt_labels = np.zeros((n, max_boxes), np.int64)
    gt_valid = np.zeros((n, max_boxes), bool)
    for i, (img, lab) in enumerate(zip(images, labels)):
        bbox = auto_annotate(np.asarray(img))
        if bbox is None:
            continue
        x, y, w, h = bbox
        gt_boxes[i, 0] = [x, y, x + w, y + h]
        gt_labels[i, 0] = lab
        gt_valid[i, 0] = True
    device = resolve_device(device)
    inputs = prepare_images(np.asarray(images, np.float32), dc, device=device)
    return (inputs, *(torch.as_tensor(a, device=device) for a in (gt_boxes, gt_labels, gt_valid)))


# --------------------------------------------------------------------------- #
# COCO-format export / import (interoperability with the reference layout)
# --------------------------------------------------------------------------- #


def write_coco_json(class_dirs: Dict[str, str], json_path: str,
                    copy_to: Optional[str] = None,
                    with_rle_masks: bool = False) -> dict:
    """Walk per-class image directories, auto-annotate each PNG, and emit a
    COCO JSON (reference createCocoJSONFromSynthetics, :624-727 — same
    dataset dict: category ids are 1-based in directory order, one largest
    box per image)."""
    import imageio.v2 as imageio
    from shutil import copyfile

    images, annotations, categories = [], [], []
    image_id, annotation_id = 1, 1
    for class_index, (class_name, class_dir) in enumerate(class_dirs.items()):
        category_id = class_index + 1
        categories.append(
            {"supercategory": "ycbv", "id": category_id, "name": class_name}
        )
        files = sorted(
            f for f in os.listdir(class_dir) if f.endswith(".png")
        )
        for fname in files:
            path = os.path.join(class_dir, fname)
            img = imageio.imread(path)
            h, w = img.shape[:2]
            rel = os.path.join(class_name, fname)
            if copy_to:
                dst = os.path.join(copy_to, class_name)
                os.makedirs(dst, exist_ok=True)
                copyfile(path, os.path.join(dst, fname))
            images.append({
                "license": 0, "file_name": rel, "width": w, "height": h,
                "id": image_id,
            })
            bbox = auto_annotate(np.asarray(img))
            if bbox is not None:
                ann = {
                    "iscrowd": 0, "image_id": image_id,
                    "category_id": category_id, "id": annotation_id,
                    "bbox": list(bbox), "area": bbox[2] * bbox[3],
                }
                if with_rle_masks:
                    ann["segmentation"] = rle_encode(annotation_mask(np.asarray(img)))
                annotations.append(ann)
                annotation_id += 1
            image_id += 1

    doc = {
        "info": {"description": os.path.basename(os.path.dirname(json_path)),
                 "version": "1"},
        "licenses": [{"url": "", "id": 0, "name": "License"}],
        "images": images, "categories": categories, "annotations": annotations,
    }
    os.makedirs(os.path.dirname(json_path) or ".", exist_ok=True)
    with open(json_path, "w") as f:
        json.dump(doc, f)
    return doc


def dataset_dicts_from_dirs(basedir: str, cate_to_id: Dict[str, int],
                            with_rle_masks: bool = True) -> List[dict]:
    """Walk ``basedir/{category}/*.png`` and build detectron2-style dataset
    dicts with auto-annotated boxes + RLE masks (reference get_ycbv_dicts,
    ``neural_sim_main.py:799-832`` — the alternative, JSON-free registration
    path)."""
    import imageio.v2 as imageio

    dicts: List[dict] = []
    image_index = 0
    for cate in sorted(os.listdir(basedir)):
        cdir = os.path.join(basedir, cate)
        if not os.path.isdir(cdir) or cate not in cate_to_id:
            continue
        for fname in sorted(os.listdir(cdir)):
            if not fname.endswith(".png"):
                continue
            path = os.path.join(cdir, fname)
            img = np.asarray(imageio.imread(path))
            h, w = img.shape[:2]
            record = {"file_name": path, "image_id": image_index,
                      "height": h, "width": w, "annotations": []}
            bbox = auto_annotate(img)
            if bbox is not None:
                x, y, bw, bh = bbox
                ann = {"bbox": [x, y, x + bw, y + bh],
                       "category_id": cate_to_id[cate], "iscrowd": 0}
                if with_rle_masks:
                    ann["segmentation"] = rle_encode(annotation_mask(img))
                record["annotations"].append(ann)
            dicts.append(record)
            image_index += 1
    return dicts


def resolve_train_val_dirs(train_val_path_info: str, test_distribution: str,
                           object_id: str, rendered_dir: str, basedir: str):
    """Reference create_dataset path resolution (:729-745): the optimized
    class's train dir points at the fresh renders; background classes and the
    chosen val distribution come from the path-info JSON."""
    with open(train_val_path_info) as f:
        info = json.load(f)
    train_info = dict(info["train_info"])
    test_info = dict(info["test_info"][test_distribution])
    for cate in train_info:
        if cate == object_id:
            train_info[cate] = os.path.join(rendered_dir, object_id)
        else:
            train_info[cate] = os.path.join(basedir, train_info[cate])
    for cate in test_info:
        test_info[cate] = os.path.join(basedir, test_info[cate])
    return train_info, test_info
