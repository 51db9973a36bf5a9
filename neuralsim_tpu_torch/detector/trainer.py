"""Inner-loop detector fine-tuning (the port of
``neuralsim_tpu/detector/trainer.py``).

The reference's ``Trainer(DefaultTrainer)`` + ``Detector.train``
(``optimization/neural_sim_main.py:531-589, 834-845``): 50 SGD-momentum
steps at batch 8, LR 2.5e-4 with a 10-step linear warmup, no decay, frozen
backbone; a warm start from the previous outer iteration is "pass the same
state in".

Parameters are a dict {name: tensor} run through
``torch.func.functional_call``, and the optimizer is tensor arithmetic on
that dict (optax's add_decayed_weights + sgd with momentum, step for
step), so a caller can differentiate the whole inner trajectory: when the
trainable parameters carry a graph, each step keeps it (``create_graph``),
and ``remat`` recomputes each step in the backward pass
(``torch.utils.checkpoint``).
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Callable, Dict, NamedTuple

import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from neuralsim_tpu_torch import draw, resolve_device
from neuralsim_tpu_torch.config import DetectorConfig
from neuralsim_tpu_torch.models.retinanet import (
    DetBatch,
    RetinaNet,
    generate_anchors,
    init_params,
    retinanet_loss,
)
from neuralsim_tpu_torch.parallel.mesh import all_sum, all_sum_tree
from neuralsim_tpu_torch.utils.profiling import span

Params = Dict[str, torch.Tensor]


class DetectorState(NamedTuple):
    params: Params
    opt_state: dict      # {"trace": {name: momentum buffer}, "count": int32}
    step: torch.Tensor


@functools.lru_cache(maxsize=8)
def _module(num_classes: int, p6_source: str) -> RetinaNet:
    # the module only lays out the computation; its tensors live on the meta
    # device and every call swaps the caller's parameters in
    with torch.device("meta"):
        return RetinaNet(num_classes=num_classes, fpn_p6_source=p6_source)


def make_detector_apply(dc: DetectorConfig):
    """Returns (module, apply_fn(params, images))."""
    model = _module(dc.num_classes, dc.fpn_p6_source)

    def apply_fn(params: Params, images: torch.Tensor):
        return functional_call(model, params, (images,), strict=True)

    return model, apply_fn


def split_trainable(params: Params, dc: DetectorConfig):
    """Partition params into (trainable, frozen): FREEZE_AT=6 freezes the
    whole ResNet, FPN and head stay trainable. The trainable set is the
    reference optimizer's param_groups, and the theta of every
    hypergradient quantity."""
    if not dc.freeze_backbone:
        return dict(params), {}
    trainable = {k: v for k, v in params.items() if not k.startswith("backbone.")}
    frozen = {k: v for k, v in params.items() if k.startswith("backbone.")}
    return trainable, frozen


def merge_params(trainable: Params, frozen: Params) -> Params:
    return {**trainable, **frozen}


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def make_detector_optimizer(dc: DetectorConfig) -> Optimizer:
    """SGD + momentum with weight decay and linear warmup, constant after
    (the reference's solver: BASE_LR 2.5e-4, WARMUP_ITERS 10, STEPS=[]):
    optax.chain(add_decayed_weights(wd), sgd(schedule, momentum)) of the JAX
    package, in its order of operations. ``update`` returns (new params,
    new state)."""

    def init(trainable: Params) -> dict:
        device = next(iter(trainable.values())).device
        return {"trace": {k: torch.zeros_like(v) for k, v in trainable.items()},
                "count": torch.zeros((), dtype=torch.int32, device=device)}

    def update(grads: Params, state: dict, trainable: Params):
        count = state["count"]
        warm = torch.clamp((count + 1).to(torch.float32) / max(dc.warmup_iters, 1), max=1.0)
        step_size = -(torch.tensor(dc.base_lr, dtype=torch.float32, device=count.device) * warm)
        trace = {k: (grads[k] + dc.weight_decay * trainable[k]) + dc.momentum * state["trace"][k]
                 for k in trainable}
        new = {k: trainable[k] + step_size * trace[k] for k in trainable}
        return new, {"trace": trace, "count": count + 1}

    return Optimizer(init, update)


def init_detector(generator: torch.Generator, dc: DetectorConfig, device=None) -> DetectorState:
    """The initial detector state, drawn from ``generator`` on ``device``
    (``cuda`` unless the caller asks for the CPU). With
    ``dc.pretrain_weight`` set, the backbone, FPN and head towers start
    from that local checkpoint (the reference's --pretrain_weight,
    neural_sim_main.py:602-606); tensors whose shapes differ (cls_score
    when num_classes differs from the checkpoint's) keep their fresh
    values, as detectron2's checkpointer does."""
    device = resolve_device(device)
    model, _ = make_detector_apply(dc)
    params = init_params(model, generator, device)
    if dc.pretrain_weight:
        from neuralsim_tpu_torch.models.convert_retinanet import (
            detect_p6_source,
            load_retinanet_checkpoint,
            merge_pretrained,
        )

        converted = load_retinanet_checkpoint(dc.pretrain_weight, device)
        ckpt_p6 = detect_p6_source(converted)
        if ckpt_p6 != dc.fpn_p6_source:
            raise ValueError(
                f"checkpoint {dc.pretrain_weight} has P6 source {ckpt_p6!r} "
                f"but DetectorConfig.fpn_p6_source={dc.fpn_p6_source!r}; set "
                "fpn_p6_source to match (torchvision exports need 'p5')")
        params, skipped = merge_pretrained(params, converted)
        if skipped:
            logging.getLogger(__name__).info(
                "pretrained init: %d tensors kept fresh (shape mismatch): %s",
                len(skipped), skipped)
    elif dc.pretrain:
        raise ValueError(
            "detector.pretrain=True requires detector.pretrain_weight: nothing "
            "is downloaded; point pretrain_weight at a local checkpoint")
    trainable, _ = split_trainable(params, dc)
    opt_state = make_detector_optimizer(dc).init(trainable)
    return DetectorState(params, opt_state, torch.zeros((), dtype=torch.int32, device=device))


def detector_loss_fn(params: Params, batch: DetBatch, dc: DetectorConfig, anchors_cat):
    """Scalar total loss: the loss the hypergradient differentiates."""
    _, apply_fn = make_detector_apply(dc)
    total, _ = retinanet_loss(apply_fn, params, batch, anchors_cat, dc)
    return total


def train_step(state: DetectorState, batch: DetBatch, dc: DetectorConfig, anchors_cat,
               group=None):
    """One SGD step. When the parameters or the batch carry a graph (a
    caller differentiates the trajectory, by the initial parameters or by
    the images), the step keeps it; otherwise it takes the gradient and
    updates without one.

    ``group``: a data-parallel step over a process group (the mesh's data
    group), ``batch`` this rank's block of the step's batch. The fg count
    is summed over the group first, each rank divides its local loss sums
    by that whole-batch count, and the gradients are summed over the group
    before the update, so every rank takes the whole batch's step (JAX's
    psum of the sharded batch's grads); the losses are the group's sums.
    Averaging gradients normalized per rank would differ whenever the
    ranks hold different numbers of fg anchors."""
    _, apply_fn = make_detector_apply(dc)
    trainable, frozen = split_trainable(state.params, dc)
    keep_graph = torch.is_grad_enabled() and any(
        v.requires_grad for v in (*state.params.values(), *batch))
    if keep_graph and group is not None:
        raise ValueError("a data-parallel step cannot keep a graph through its collectives")
    trainable = {k: v if keep_graph and v.requires_grad else v.detach().requires_grad_()
                 for k, v in trainable.items()}
    fg_total = None if group is None else (lambda n: all_sum(n, group))
    with torch.enable_grad():
        total, losses = retinanet_loss(apply_fn, merge_params(trainable, frozen), batch,
                                       anchors_cat, dc, fg_total=fg_total)
        grads = torch.autograd.grad(total, list(trainable.values()), create_graph=keep_graph)
    grads = dict(zip(trainable, grads))
    if group is not None:
        grads = all_sum_tree(grads, group)
        total, cls, box = all_sum(torch.stack([total.detach(), losses["loss_cls"].detach(),
                                               losses["loss_box_reg"].detach()]), group)
        losses = {"loss_cls": cls, "loss_box_reg": box}
    with torch.set_grad_enabled(keep_graph):
        trainable, opt_state = make_detector_optimizer(dc).update(
            grads, state.opt_state, trainable)
    if not keep_graph:
        total, losses = total.detach(), {k: v.detach() for k, v in losses.items()}
    return (DetectorState(merge_params(trainable, frozen), opt_state, state.step + 1),
            {"loss": total, **losses})


def inner_train(state: DetectorState, batches, dc: DetectorConfig, anchors_cat=None,
                remat: bool = False, group=None):
    """Run the inner fine-tune, one step per batch, on the device of the
    state's parameters.

    Args:
      batches: either a DetBatch whose tensors carry a leading [n_steps]
        axis, or a ``(dataset: DetBatch [N, ...], idx: [n_steps, batch])``
        pair: each step gathers its batch from the dataset, so the steps
        hold no duplicated images.
      remat: recompute each step in the backward pass of a caller that
        differentiates the trajectory (``torch.utils.checkpoint``): memory
        stays at one step's activations instead of n_steps'.
      group: data-parallel steps over this process group (``train_step``);
        ``batches`` then hold this rank's block of each step's batch.

    Returns (final state, {"loss", "loss_cls", "loss_box_reg": [n_steps]}).
    """
    device = next(iter(state.params.values())).device
    if anchors_cat is None:
        anchors_cat = torch.cat(generate_anchors(dc.image_size, device), dim=0)
    if isinstance(batches, DetBatch):
        n_steps = batches.images.shape[0]

        def batch_of(i):
            return DetBatch(*(x[i] for x in batches))
    else:
        data, idx = batches
        idx = torch.as_tensor(idx, device=device).long()
        n_steps = idx.shape[0]

        def batch_of(i):
            return DetBatch(*(x[idx[i]] for x in data))

    def body(s, i):
        return train_step(s, batch_of(i), dc, anchors_cat, group)

    metrics = []
    for i in range(n_steps):
        # outside the checkpoint: a recompute in the backward opens no span
        with span("inner_train.step"):
            if remat and torch.is_grad_enabled():
                state, m = checkpoint(body, state, i, use_reentrant=False)
            else:
                state, m = body(state, i)
        metrics.append(m)
    return state, {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}


def auto_scale_config(dc: DetectorConfig, world_size: int) -> DetectorConfig:
    """Linear-scaling rule for data-parallel inner training: batch and LR
    scale with the number of devices, warmup and steps shrink to keep the
    same epochs (detectron2's auto_scale_workers, reference
    utils/defaults.py:572-641)."""
    if world_size <= 1:
        return dc
    return dataclasses.replace(
        dc,
        images_per_batch=dc.images_per_batch * world_size,
        base_lr=dc.base_lr * world_size,
        warmup_iters=max(1, dc.warmup_iters // world_size),
        max_iter=max(1, dc.max_iter // world_size),
    )


def cycle_indices(n: int, n_steps: int, batch_size: int, generator: torch.Generator = None,
                  device="cpu") -> torch.Tensor:
    """[n_steps, batch_size] int64 dataset indices by shuffled cycling (the
    reference's infinite training loader over a small synthetic set): one
    fresh permutation of range(n) per pass, from ``generator``. This is the
    batch schedule: cycle_batches materializes exactly these picks."""
    total = n_steps * batch_size
    reps = -(-total // n)
    perm = torch.cat([torch.argsort(draw((n,), generator)) for _ in range(reps)])[:total]
    return perm.reshape(n_steps, batch_size).to(device)


def cycle_batches(images, gt_boxes, gt_labels, gt_valid, n_steps: int, batch_size: int,
                  generator: torch.Generator = None) -> DetBatch:
    """Materialized [n_steps, batch_size, ...] batches from cycle_indices."""
    idx = cycle_indices(images.shape[0], n_steps, batch_size, generator,
                        images.device).reshape(-1)
    return DetBatch(*(x[idx].reshape((n_steps, batch_size) + x.shape[1:])
                      for x in (images, gt_boxes, gt_labels, gt_valid)))
