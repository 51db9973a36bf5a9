"""Dataset and camera loaders and NeRF checkpoints (the names of
``neuralsim_tpu.data``; the checkpoint converter lives in
``models.convert``). The offline BOP converters are the modules
``data.bop_convert`` and ``data.blenderproc_config``."""

from neuralsim_tpu_torch.data.blender import load_data_param, load_linemod_data
from neuralsim_tpu_torch.models.convert import (
    convert_torch_checkpoint,
    load_nerf_checkpoint,
)

__all__ = [
    "load_linemod_data",
    "load_data_param",
    "convert_torch_checkpoint",
    "load_nerf_checkpoint",
]
