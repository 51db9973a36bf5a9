"""neuralsim_tpu_torch — the PyTorch/CUDA port of ``neuralsim_tpu``.

A second package beside the JAX one, written for one NVIDIA H100. It keeps
the JAX package's module names so that each function's counterpart is easy
to find, and it imports nothing from that package: what it needs of the
framework-free modules (configuration, camera loader, checkpoint key map)
it keeps as its own copies.

Slices ported so far: the exact K-pose render of the outer iteration
(``pipeline.NeuralSimRenderer.render_images``) on its three march routes
(the ray march, the point-major MLP with ``fuse_pointgen=False``, the fused
march + compositing with ``fuse_compositing=True``); the production render
(``RenderConfig.production_mode()``: occupancy grid, ray culling, the
z-tightened single-pass march, ``ops/occupancy.py``) with coarse-raw reuse
and the sparse fine pass; every kernel the JAX package wrote in Pallas,
each as a CUDA kernel written for Hopper (``kernels/raymarch.py``, sources
in ``kernels/csrc/``); the psi render gradient (``hypergrad/render_grad.py``);
and the detector stack: on-device auto-annotation
(``detector.dataset.build_detector_batches_device``), RetinaNet-R50-FPN
(``models/retinanet.py``), its inner fine-tune (``detector.trainer``) and
COCO mAP (``detector.evaluator``); the hypergradient engines
(``hypergrad/influence.py``, ``hypergrad/unrolled.py``), the outer loop
(``bilevel/driver.py``), its checkpoints, logs and timers (``utils/``) and
the reference's command line (``cli.py``, ``config.parse_cli``); the
standalone NeRF trainer (``train_nerf.py``, ``train_cli.py``) on the LINEMOD
loader (``data.load_linemod_data``, frames read by ``utils/png.py``); the
sampler diagnostics and the offline BOP tools (``sampler/diagnostics.py``,
``data/bop_convert.py``, ``data/blenderproc_config.py``). Not ported yet:
``parallel/`` and the ``mesh`` paths that take it.

On the card the command lines set one numeric policy
(``set_card_numerics``): TF32 off, deterministic cuDNN algorithms.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no device given and no GPU present they raise.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, the CPU only
    when the caller asks for it. Never falls back silently."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def on_card(device) -> bool:
    """Whether ``device`` is a CUDA device."""
    return torch.device(device).type == "cuda"


def set_card_numerics(device):
    """The port's one numeric policy on the card, set by the command lines
    once they know their device: float32 stays float32 (TF32 off for
    cuBLAS and cuDNN, as the parity limits assume) and cuDNN picks
    deterministic algorithms, not benchmarked ones, so that a run repeats
    from its seed as the JAX package's runs repeat from their key. Process
    wide, as torch's switches are; nothing on another device."""
    if not on_card(device):
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def draw(shape, generator=None, device="cpu", normal: bool = False) -> torch.Tensor:
    """U[0, 1) (or standard-normal) draws from ``generator``, made on the
    generator's own device and moved to ``device``."""
    gen_device = generator.device if generator is not None else "cpu"
    fn = torch.randn if normal else torch.rand
    return fn(shape, generator=generator, device=gen_device).to(device)
