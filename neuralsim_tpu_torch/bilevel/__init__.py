"""The bilevel loop (the names of ``neuralsim_tpu.bilevel``). The outer
loop itself, ``driver.BilevelDriver``, is reached through its module, as in
the JAX package."""

from neuralsim_tpu_torch.bilevel.psi_init import psi_init
from neuralsim_tpu_torch.bilevel.psi_opt import (
    PsiOptState,
    adjust_learning_rate,
    psi_optimizer_init,
    psi_optimizer_update,
)

__all__ = [
    "psi_init",
    "PsiOptState",
    "adjust_learning_rate",
    "psi_optimizer_init",
    "psi_optimizer_update",
]
