"""The hypergradient (the names of ``neuralsim_tpu.hypergrad`` that the
port has: the psi render gradient; the influence and unrolled engines are
not ported yet). ``render_grad.render_grad_psi_strips``, the default mode,
is reached through its module, as in the JAX package."""

from neuralsim_tpu_torch.hypergrad.render_grad import (
    psi_outer_loss,
    render_grad_psi_fwd,
    render_grad_psi_rev,
)

__all__ = [
    "psi_outer_loss",
    "render_grad_psi_fwd",
    "render_grad_psi_rev",
]
