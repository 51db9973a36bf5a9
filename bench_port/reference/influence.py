"""The influence-function hypergradient's parts at the outer loop's
defaults (a copy of ``neuralsim_tpu_torch/hypergrad/influence.py`` without
the solvers it does not run): v = dL_val/dtheta over val batches, the
onestep (H + damping I) v by double reverse mode, and grad_E =
d/dI <dL_train/dtheta, v> one image at a time. Trees are nested dicts of
tensors whose keys are visited in sorted order.
"""

from __future__ import annotations

from typing import Callable

import torch


# --------------------------------------------------------------------------- #
# trees of tensors
# --------------------------------------------------------------------------- #


# dict keys are visited in sorted order (as JAX flattens them), so two trees
# with the same keys pair their leaves whatever their insertion order


def _map(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in sorted(t0)}
    if isinstance(t0, tuple) and hasattr(t0, "_fields"):
        return type(t0)(*(_map(fn, *parts) for parts in zip(*trees)))
    if isinstance(t0, (list, tuple)):
        return type(t0)(_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _rebuild(tree, leaves):
    it = iter(leaves)
    return _map(lambda _: next(it), tree)


def tree_axpy(alpha, x, y):
    """alpha * x + y, leaf by leaf."""
    return _map(lambda xi, yi: alpha * xi + yi, x, y)


def _grad(loss_fn: Callable, params, batch):
    """d loss_fn(params, batch) / d params, without a graph."""
    leaves = [p.detach().requires_grad_() for p in _leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(_rebuild(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return _rebuild(params, grads)


def _batch_at(batches, i: int):
    """Batch i of a stacked tree (every leaf leads with the batch axis)."""
    return _map(lambda x: x[i], batches)


def _n_stacked(batches) -> int:
    return next(iter(_leaves(batches))).shape[0]


def grad_loss(loss_fn: Callable, params, batches):
    """Accumulated dL/dparams over a sequence of batches (the reference
    accumulates .grad over the whole val loader, :948-975).

    ``batches`` is a python LIST of batches, or a tree whose leaves carry a
    leading batch-of-batches axis (the stacked form); tuples are trees,
    not sequences."""
    if not isinstance(batches, list):
        batches = [_batch_at(batches, i) for i in range(_n_stacked(batches))]
    total = None
    for b in batches:
        g = _grad(loss_fn, params, b)
        total = g if total is None else _map(torch.add, total, g)
    return total


def hvp(loss_fn: Callable, params, batch, v):
    """(d2L/dtheta2) v by double reverse mode: the gradient of
    <dL/dtheta, v> (the JAX package takes the jvp of the gradient; the
    Hessian is symmetric, so both give H v). Double reverse is the path the
    unrolled hypergradient already takes through the detector (a step's
    create_graph backward), so it needs no forward-mode formula for any op
    of the loss."""
    leaves = [p.detach().requires_grad_() for p in _leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(_rebuild(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, create_graph=True, allow_unused=True,
                                    materialize_grads=True)
        dot = sum(torch.sum(g * vi) for g, vi in zip(grads, _leaves(v)))
        hv = torch.autograd.grad(dot, leaves, allow_unused=True, materialize_grads=True)
    return _rebuild(params, hv)


def inverse_hvp_onestep(loss_fn: Callable, params, batch, v, damping: float = 1e-2):
    """(H + damping I) v: the reference's live default for H^-1 v
    (neural_sim_main.py:995-1018), the outer loop's ``ihvp_solver``."""
    return tree_axpy(damping, v, hvp(loss_fn, params, batch, v))


def mixed_grad_wrt_images(loss_fn_img: Callable, params, images, v):
    """grad_E: d/dI <dL_train/dtheta, v> for a batch of images.

    The reference loops images with create_graph double-grads (:855-911);
    here too, one image at a time: loss_fn_img(params, image) is one
    image's loss, a batch of 1 (the detector loss normalizes by its batch's
    foreground count, so a batch of several images is a different loss).

    Args:
      loss_fn_img: (params, image) -> scalar train loss for one image.
      images: [P, ...] tensor.
      v: inverse-HVP tree (same structure as params).

    Returns grad_E [P, ...].
    """
    leaves = [p.detach().requires_grad_() for p in _leaves(params)]
    p_tree = _rebuild(params, leaves)
    out = []
    for image in images:
        img = image.detach().requires_grad_()
        with torch.enable_grad():
            grads = torch.autograd.grad(loss_fn_img(p_tree, img), leaves, create_graph=True,
                                        allow_unused=True, materialize_grads=True)
            dot = sum(torch.sum(g * vi) for g, vi in zip(grads, _leaves(v)))
            out.append(torch.autograd.grad(dot, img, allow_unused=True,
                                           materialize_grads=True)[0])
    return torch.stack(out)
