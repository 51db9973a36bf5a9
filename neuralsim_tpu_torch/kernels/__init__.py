from neuralsim_tpu_torch.kernels.raymarch import fused_nerf_mlp, uses_kernel

__all__ = ["fused_nerf_mlp", "uses_kernel"]
