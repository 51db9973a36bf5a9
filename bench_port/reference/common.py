"""What every reference module shares: the seeded draws and the
arithmetic modes.

The reference is plain PyTorch. ``arithmetic(mode)`` sets how its float32
products run: ``"float32"`` with TF32 off (what the configurations state and
what the reference computes), ``"tf32"`` with TF32 on for cuBLAS and cuDNN
(the control of a float32 stage: the nearest precision below float32).
The MLP's operand rounding (bfloat16, and float8 e4m3 as the control of a
bfloat16 stage) goes through ``compute_dtype`` in ``nerf.py``.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``device``, or ``cuda`` when None."""
    return torch.device("cuda" if device is None else device)


def draw(shape, generator=None, device="cpu", normal: bool = False) -> torch.Tensor:
    """U[0, 1) (or standard-normal) draws from ``generator``, made on the
    generator's own device and moved to ``device``."""
    gen_device = generator.device if generator is not None else "cpu"
    fn = torch.randn if normal else torch.rand
    return fn(shape, generator=generator, device=gen_device).to(device)


@contextlib.contextmanager
def arithmetic(mode: str = "float32"):
    """float32 products with TF32 off ("float32") or on ("tf32") for the
    duration, and deterministic cuDNN algorithms; the previous switches
    come back after."""
    if mode not in ("float32", "tf32"):
        raise ValueError(f"arithmetic: unknown mode {mode!r}")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    tf32 = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) = saved


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float8": torch.float8_e4m3fn}


def as_dtype(name: str) -> torch.dtype:
    return DTYPES[name]
