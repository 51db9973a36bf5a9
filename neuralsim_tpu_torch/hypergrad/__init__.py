"""The hypergradient (the names of ``neuralsim_tpu.hypergrad``): the psi
render gradient and the influence engine. ``render_grad.
render_grad_psi_strips``, the default render-gradient mode, and
``unrolled.unrolled_grad_images`` are reached through their modules, as in
the JAX package."""

from neuralsim_tpu_torch.hypergrad.render_grad import (
    psi_outer_loss,
    render_grad_psi_fwd,
    render_grad_psi_rev,
)
from neuralsim_tpu_torch.hypergrad.influence import (
    flat_dot,
    grad_loss,
    hvp,
    inverse_hvp,
    mixed_grad_wrt_images,
)

__all__ = [
    "psi_outer_loss",
    "render_grad_psi_fwd",
    "render_grad_psi_rev",
    "flat_dot",
    "grad_loss",
    "hvp",
    "inverse_hvp",
    "mixed_grad_wrt_images",
]
