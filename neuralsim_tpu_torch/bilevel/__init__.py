"""The bilevel loop (the names of ``neuralsim_tpu.bilevel`` that the port
has; the psi optimizer is not ported yet)."""

from neuralsim_tpu_torch.bilevel.psi_init import psi_init

__all__ = [
    "psi_init",
]
