"""Unrolled (exact) hypergradient through the inner training loop (the
port of ``neuralsim_tpu/hypergrad/unrolled.py``).

The reference approximates dL_val/dI with an influence function
(``neural_sim_main.py:912-1069``). Here the inner fine-tune is a function
of the images (``detector.trainer.inner_train``): the true gradient of the
validation loss through the whole training trajectory is one backward
pass, with each step recomputed in it (``remat``: a checkpoint per step),
so memory stays at about one step's activations and compute at ~2x the
forward training.

Gradients flow through image pixel values only: the auto-annotation's
boxes are integer reductions (zero derivative), as the reference treats
labels as data (``neural_sim_main.py:855-911``).
"""

from __future__ import annotations

import torch

from neuralsim_tpu_torch.config import DetectorConfig
from neuralsim_tpu_torch.detector.dataset import build_detector_batches_device
from neuralsim_tpu_torch.detector.trainer import DetectorState, inner_train
from neuralsim_tpu_torch.models.retinanet import DetBatch, retinanet_loss


def val_loss_sum(det_apply, params, val_data, dc: DetectorConfig, anchors_cat):
    """The detector loss over the entire val set as one batch (the quantity
    whose parameter gradient the reference accumulates, :948-969)."""
    batch = DetBatch(val_data.images, val_data.gt_boxes, val_data.gt_labels,
                     val_data.gt_valid)
    total, _ = retinanet_loss(det_apply, params, batch, anchors_cat, dc)
    return total


def unrolled_grad_images(det_apply, det_state0: DetectorState, images, labels, val_data,
                         dc: DetectorConfig, anchors_cat, batch_idx,
                         background_images=None, background_labels=None):
    """d val_loss(inner_train(det_state0, batches(images))) / d images.

    Args:
      det_state0: detector state before the inner fine-tune (the unroll
        recomputes the training trajectory under the gradient).
      images: [N, H, W, 3] rendered images in [0, 1].
      batch_idx: [n_steps, batch] dataset indices, the same schedule the
        forward inner train used (the JAX package passes the key that
        drew it), over the renders followed by the backgrounds.
      background_images/labels: optional mixed-dataset backgrounds (the
        reference's create_dataset merges background classes,
        neural_sim_main.py:729-781). They enter the schedule as constant
        dataset entries appended after the renders, annotated with the
        largest component only, and get no image gradient: the result
        covers the renders only.

    Returns [N, H, W, 3], the true dL_val/dI the influence path
    approximates.
    """
    images = torch.as_tensor(images)
    device = images.device
    has_bg = background_images is not None
    bg_const = None
    if has_bg:
        bg = torch.as_tensor(background_images, dtype=torch.float32, device=device).detach()
        bg_const = build_detector_batches_device(bg, list(background_labels), dc,
                                                 largest_only=True)
    labels = [int(x) for x in torch.as_tensor(labels).reshape(-1).tolist()]
    idx = torch.as_tensor(batch_idx, device=device).long()
    trainable0 = {k: v.detach() for k, v in det_state0.params.items()}
    state0 = DetectorState(trainable0, det_state0.opt_state, det_state0.step)

    imgs = images.detach().to(torch.float32).requires_grad_()
    with torch.enable_grad():
        inputs, gb, gl, gv = build_detector_batches_device(imgs, labels, dc,
                                                           largest_only=has_bg)
        if has_bg:
            inputs, gb, gl, gv = (torch.cat([a, b], dim=0)
                                  for a, b in zip((inputs, gb, gl, gv), bg_const))
        final, _ = inner_train(state0, (DetBatch(inputs, gb, gl, gv), idx), dc,
                               anchors_cat, remat=True)
        loss = val_loss_sum(det_apply, final.params, val_data, dc, anchors_cat)
        return torch.autograd.grad(loss, imgs)[0]
