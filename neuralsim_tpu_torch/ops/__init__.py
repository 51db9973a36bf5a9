"""Rays, encoding, volume rendering and the hierarchical renderer (the
names of ``neuralsim_tpu.ops`` that the port has)."""

from neuralsim_tpu_torch.ops.rays import get_rays, ndc_rays
from neuralsim_tpu_torch.ops.encoding import positional_encoding, encoding_dim
from neuralsim_tpu_torch.ops.volume import raw2outputs, sample_pdf, stratified_z_vals

__all__ = [
    "get_rays",
    "ndc_rays",
    "positional_encoding",
    "encoding_dim",
    "raw2outputs",
    "sample_pdf",
    "stratified_z_vals",
    "render_rays",
    "render_ray_batch",
    "render_image",
    "render_poses",
]


def __getattr__(name):
    # lazy: ops.render imports kernels.raymarch, which imports models.nerf,
    # which imports ops.encoding
    if name in ("render_rays", "render_ray_batch", "render_image", "render_poses"):
        from neuralsim_tpu_torch.ops import render as _render

        return getattr(_render, name)
    raise AttributeError(name)
