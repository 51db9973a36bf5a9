"""The NeRF MLP (the names of ``neuralsim_tpu.models``)."""

from neuralsim_tpu_torch.models.nerf import (
    init_nerf_params,
    init_nerf_pipeline_params,
    nerf_apply,
    query_points,
)

__all__ = [
    "init_nerf_params",
    "init_nerf_pipeline_params",
    "nerf_apply",
    "query_points",
]
