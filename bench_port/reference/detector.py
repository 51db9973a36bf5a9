"""The inner detector fine-tune (a copy of the single-device, no-graph
path of ``neuralsim_tpu_torch/detector/trainer.py``): 50 SGD-momentum steps
at batch 8, LR 2.5e-4 with a 10-step linear warmup, weight decay 1e-4,
frozen backbone, parameters as a dict run through ``functional_call``."""

from __future__ import annotations

import functools
from typing import Callable, Dict, NamedTuple

import torch
from torch.func import functional_call

from bench_port.reference.common import draw, resolve_device
from bench_port.reference.config import DetectorConfig
from bench_port.reference.retinanet import (
    DetBatch,
    RetinaNet,
    init_params,
    retinanet_loss,
)

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
    (``cuda`` unless the caller asks for the CPU)."""
    device = resolve_device(device)
    model, _ = make_detector_apply(dc)
    params = init_params(model, generator, device)
    trainable, _ = split_trainable(params, dc)
    opt_state = make_detector_optimizer(dc).init(trainable)
    return DetectorState(params, opt_state, torch.zeros((), dtype=torch.int32, device=device))


def train_step(state: DetectorState, batch: DetBatch, dc: DetectorConfig, anchors_cat):
    """One SGD step, without a graph."""
    _, apply_fn = make_detector_apply(dc)
    trainable, frozen = split_trainable(state.params, dc)
    trainable = {k: v.detach().requires_grad_() for k, v in trainable.items()}
    with torch.enable_grad():
        total, losses = retinanet_loss(apply_fn, merge_params(trainable, frozen), batch,
                                       anchors_cat, dc)
        grads = torch.autograd.grad(total, list(trainable.values()))
    grads = dict(zip(trainable, grads))
    with torch.no_grad():
        trainable, opt_state = make_detector_optimizer(dc).update(
            grads, state.opt_state, trainable)
    return (DetectorState(merge_params(trainable, frozen), opt_state, state.step + 1),
            {"loss": total.detach(), **{k: v.detach() for k, v in losses.items()}})


def inner_train(state: DetectorState, data: DetBatch, idx, dc: DetectorConfig,
                anchors_cat):
    """The inner fine-tune: step i trains on the rows idx[i] of ``data``.
    Returns (final state, {"loss", "loss_cls", "loss_box_reg": [n_steps]})."""
    metrics = []
    for i in range(idx.shape[0]):
        state, m = train_step(state, DetBatch(*(x[idx[i]] for x in data)), dc, anchors_cat)
        metrics.append(m)
    return state, {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}


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
