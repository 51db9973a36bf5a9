"""Experiment record, timing and checkpoints (the names of
``neuralsim_tpu.utils``)."""

from neuralsim_tpu_torch.utils.logging import ResultLog, save_args_snapshot
from neuralsim_tpu_torch.utils.profiling import phase_timer

__all__ = ["ResultLog", "save_args_snapshot", "phase_timer"]
