"""The plain reference of the benchmark's ``correct``: plain PyTorch that
imports nothing of ``neuralsim_tpu_torch`` and takes nothing the program
made. It is a frozen copy of the port's plain paths, its imports pointed at
this folder, so that a later change to the program cannot move it.

It runs with TF32 off and deterministic cuDNN (``common.arithmetic``), the
NeRF MLP's operands rounded to the dtype the configuration states and
everything else in float32; ``common.arithmetic("tf32")`` and the
``"float8"`` operand dtype are the controls one precision below.

Departures from the port, each a path no benchmarked cell takes:

- ``render.py``: the exact render only (no kernels, occupancy culling,
  z tightening, coarse-raw reuse, sparse fine pass, NDC, density noise);
- ``render_grad.py``: the dense strips gradient, one image per tile (no
  culled strips, image batches, mesh, fwd or rev modes); it returns each
  image's gradient, whose mean is the program's;
- ``nerf.py``: no kernel route, no sigma function, no ``nn.Module``;
  float8 operands round in the forward pass only (``_Float8``);
- ``detector.py``: one device, no graph kept through the steps (no remat,
  no data-parallel step, no pretrained init); ``retinanet.py`` without
  inference and NMS; ``dataset.py`` the device annotator only;
- ``influence.py``: the onestep (H + damping I) v solver only;
- ``poses.py``: the categorical sampler only;
- ``train.py``: the NeRF train step written out (loss, autograd, Adam);
- ``config.py``: the dataclasses without the flag and txt parsers.
"""
