"""Image/box transform framework for detector data (a copy of
``neuralsim_tpu/detector/transforms.py``, which imports no framework).

Capability parity with the reference's vendored detectron2 transforms
(``optimization/utils/transforms/``, 1,321 LoC: Transform/Augmentation base
classes + Resize/Flip/Crop/Color impls). The reference pipeline runs every
loader with ``augmentations=[]`` (``neural_sim_main.py:548-553`` — pixel
alignment with renders is load-bearing for the hypergradient), so this
module is intentionally compact: pure functions ``(image, boxes) ->
(image, boxes)``, composable, jit-friendly where useful, with the same
box convention (XYXY, absolute pixels).
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np

Array = np.ndarray
TransformFn = Callable[[Array, Array], Tuple[Array, Array]]


def _bilinear_resize(image: Array, out_h: int, out_w: int) -> Array:
    h, w = image.shape[:2]
    ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None, None]
    wx = np.clip(xs - x0, 0, 1)[None, :, None]
    img = image.astype(np.float32)
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def resize(out_h: int, out_w: int) -> TransformFn:
    """Resize image; scale boxes accordingly (detectron2 ResizeTransform)."""

    def fn(image, boxes):
        h, w = image.shape[:2]
        out = _bilinear_resize(image, out_h, out_w)
        if boxes is not None and len(boxes):
            sx, sy = out_w / w, out_h / h
            boxes = boxes * np.array([sx, sy, sx, sy], np.float32)
        return out, boxes

    return fn


def hflip() -> TransformFn:
    """Horizontal flip (detectron2 HFlipTransform)."""

    def fn(image, boxes):
        w = image.shape[1]
        out = image[:, ::-1]
        if boxes is not None and len(boxes):
            boxes = boxes.copy()
            boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
        return out, boxes

    return fn


def vflip() -> TransformFn:
    def fn(image, boxes):
        h = image.shape[0]
        out = image[::-1]
        if boxes is not None and len(boxes):
            boxes = boxes.copy()
            boxes[:, [1, 3]] = h - boxes[:, [3, 1]]
        return out, boxes

    return fn


def crop(y0: int, x0: int, ch: int, cw: int) -> TransformFn:
    """Fixed crop; boxes clipped to the window (CropTransform)."""

    def fn(image, boxes):
        out = image[y0: y0 + ch, x0: x0 + cw]
        if boxes is not None and len(boxes):
            boxes = boxes - np.array([x0, y0, x0, y0], np.float32)
            boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, cw)
            boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, ch)
        return out, boxes

    return fn


def random_crop(frac: float, rng: np.random.RandomState) -> TransformFn:
    def fn(image, boxes):
        h, w = image.shape[:2]
        ch, cw = int(h * frac), int(w * frac)
        y0 = rng.randint(0, h - ch + 1)
        x0 = rng.randint(0, w - cw + 1)
        return crop(y0, x0, ch, cw)(image, boxes)

    return fn


def random_flip(prob: float, rng: np.random.RandomState,
                horizontal: bool = True) -> TransformFn:
    base = hflip() if horizontal else vflip()

    def fn(image, boxes):
        if rng.rand() < prob:
            return base(image, boxes)
        return image, boxes

    return fn


def brightness(scale: float) -> TransformFn:
    def fn(image, boxes):
        return np.clip(image * scale, 0, 1 if image.dtype != np.uint8 else 255), boxes

    return fn


def contrast(scale: float) -> TransformFn:
    def fn(image, boxes):
        mean = image.mean(axis=(0, 1), keepdims=True)
        out = mean + (image - mean) * scale
        return np.clip(out, 0, 1 if image.dtype != np.uint8 else 255), boxes

    return fn


def saturation(scale: float) -> TransformFn:
    def fn(image, boxes):
        gray = image[..., :3].mean(axis=-1, keepdims=True)
        out = image.copy().astype(np.float32)
        out[..., :3] = gray + (image[..., :3] - gray) * scale
        return np.clip(out, 0, 1 if image.dtype != np.uint8 else 255), boxes

    return fn


def compose(transforms: Sequence[TransformFn]) -> TransformFn:
    """Apply in order — the AugmentationList analog. An empty list is the
    identity, which is exactly how the reference pipeline runs."""

    def fn(image, boxes):
        for t in transforms:
            image, boxes = t(image, boxes)
        return image, boxes

    return fn
