"""Outer-loop psi optimizers: SGD / momentum / Adam on the psi vector
(a copy of ``neuralsim_tpu_torch/bilevel/psi_opt.py``).

Capability parity with the reference's numpy optimizers
(``optimization/neural_sim_main.py:1085-1134``) and its warmup/decay
schedule (``adjust_learning_rate``, :1137-1141), as a functional
(state, psi, grad) -> (state, psi) update:

  - SGD, momentum and Adam all descend (params -= lr * grad);
  - Adam uses the reference's bias-corrected learning rate with eps = 1e-7;
  - the state follows psi: each update moves it to psi's device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PsiOptState(NamedTuple):
    method: str           # "sgd" | "momentum" | "adam"
    lr: torch.Tensor      # current learning rate (set by the schedule)
    momentum: float
    beta1: float
    beta2: float
    step: torch.Tensor    # adam t
    m: torch.Tensor
    v: torch.Tensor


def psi_optimizer_init(method: str, lr: float, dim: int = 8,
                       momentum: float = 0.9, beta1: float = 0.9,
                       beta2: float = 0.999) -> PsiOptState:
    """The optimizer's initial state; its tensors move to psi's device in
    the first update."""
    method = {"sgd": "sgd", "momentum": "momentum", "adam": "adam",
              "Adam": "adam"}[method]
    zeros = torch.zeros((dim,), dtype=torch.float32)
    return PsiOptState(
        method=method,
        lr=torch.tensor(lr, dtype=torch.float32),
        momentum=momentum,
        beta1=beta1,
        beta2=beta2,
        step=torch.zeros((), dtype=torch.int32),
        m=zeros,
        v=zeros,
    )


def psi_optimizer_update(state: PsiOptState, psi, grad):
    """One descent step; returns (new_state, new_psi), the state on psi's
    device."""
    state = state._replace(**{f: getattr(state, f).to(psi.device)
                              for f in ("lr", "step", "m", "v")})
    if state.method == "sgd":
        return state, psi - state.lr * grad

    if state.method == "momentum":
        vel = state.momentum * state.m - state.lr * grad
        return state._replace(m=vel), psi + vel

    t = state.step + 1
    m = state.m + (1.0 - state.beta1) * (grad - state.m)
    v = state.v + (1.0 - state.beta2) * (grad**2 - state.v)
    tf = t.to(torch.float32)
    lr_t = state.lr * torch.sqrt(1.0 - state.beta2**tf) / (1.0 - state.beta1**tf)
    new_psi = psi - lr_t * m / (torch.sqrt(v) + 1e-7)
    return state._replace(step=t, m=m, v=v), new_psi


def adjust_learning_rate(epoch: int, base_lr: float, max_epoch: int) -> float:
    """5-epoch linear warmup, then linear decay (reference :1137-1141),
    clamped at zero: past max_epoch the reference formula turns negative
    (gradient ascent)."""
    if epoch <= 5:
        return base_lr * epoch / 5.0
    return max(0.0, base_lr * (1.0 - epoch / max_epoch))
