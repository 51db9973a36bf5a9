"""Camera parameters and NeRF checkpoints (the names of
``neuralsim_tpu.data`` that the port has; the checkpoint converter lives in
``models.convert``, the LINEMOD loader is not ported yet)."""

from neuralsim_tpu_torch.data.blender import load_data_param
from neuralsim_tpu_torch.models.convert import (
    convert_torch_checkpoint,
    load_nerf_checkpoint,
)

__all__ = [
    "load_data_param",
    "convert_torch_checkpoint",
    "load_nerf_checkpoint",
]
