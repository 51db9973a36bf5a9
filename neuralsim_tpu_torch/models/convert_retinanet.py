"""RetinaNet weights in and out of the port (the port of
``neuralsim_tpu/models/convert_retinanet.py``).

Two maps:

  - a torchvision ``retinanet_resnet50_fpn`` / detectron2 state_dict (the
    reference's ``--pretrain_weight``, ``optimization/neural_sim_main.py:
    602-606``) -> the JAX package's parameter tree, as that package converts
    it (``convert_torchvision_retinanet``; BatchNorm folds into FrozenBN:
    scale = gamma / sqrt(var + eps), bias = beta - mean * scale);
  - that tree (nested dicts of numpy arrays: Flax layout, HWIO kernels) <->
    the port's parameters by name (``params_from_flax``, ``params_to_flax``).
    The port's modules carry the tree's names, so the map is one rule per
    parameter kind: a conv ``kernel`` [kh, kw, in, out] is the ``weight``
    [out, in, kh, kw]; FrozenBN ``scale`` / ``bias`` and conv ``bias`` keep
    their names and values.

FPN P6 layouts differ between sources: detectron2 feeds C5 (2048 channels)
into P6, torchvision feeds P5 (256). ``detect_p6_source`` reads it off the
weights; build the model with the matching ``DetectorConfig.fpn_p6_source``.
Checkpoints load from a local path only.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_BN_EPS = 1e-5


def _arr(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def _conv(sd: Mapping, name: str) -> Dict[str, np.ndarray]:
    out = {"kernel": _arr(sd[f"{name}.weight"]).transpose(2, 3, 1, 0)}
    if f"{name}.bias" in sd:
        out["bias"] = _arr(sd[f"{name}.bias"])
    return out


def _frozen_bn(sd: Mapping, name: str) -> Dict[str, np.ndarray]:
    gamma = _arr(sd[f"{name}.weight"])
    beta = _arr(sd[f"{name}.bias"])
    mean = _arr(sd[f"{name}.running_mean"])
    var = _arr(sd[f"{name}.running_var"])
    scale = gamma / np.sqrt(var + _BN_EPS)
    return {"scale": scale, "bias": beta - mean * scale}


def convert_torchvision_retinanet(sd: Mapping) -> Dict:
    """Full state_dict -> {'backbone': ..., 'fpn': ..., 'head': ...}."""
    params: Dict = {"backbone": {}, "fpn": {}, "head": {}}
    bb = params["backbone"]
    body = "backbone.body"

    bb["stem_conv"] = _conv(sd, f"{body}.conv1")
    bb["stem_bn"] = _frozen_bn(sd, f"{body}.bn1")

    blocks_per_stage = (3, 4, 6, 3)
    for stage, n_blocks in enumerate(blocks_per_stage):
        layer = f"{body}.layer{stage + 1}"
        for b in range(n_blocks):
            dst = {}
            for ci in (1, 2, 3):
                dst[f"conv{ci}"] = _conv(sd, f"{layer}.{b}.conv{ci}")
                dst[f"bn{ci}"] = _frozen_bn(sd, f"{layer}.{b}.bn{ci}")
            if f"{layer}.{b}.downsample.0.weight" in sd:
                dst["downsample_conv"] = _conv(sd, f"{layer}.{b}.downsample.0")
                dst["downsample_bn"] = _frozen_bn(sd, f"{layer}.{b}.downsample.1")
            bb[f"res{stage + 2}_block{b}"] = dst

    fpn = params["fpn"]
    # torchvision fpn: inner_blocks (lateral 1x1) and layer_blocks (3x3) for
    # C3..C5 in order; extra_blocks.p6/p7
    for i, lvl in enumerate((3, 4, 5)):
        inner = f"backbone.fpn.inner_blocks.{i}"
        outer = f"backbone.fpn.layer_blocks.{i}"
        # torchvision >=0.13 nests Conv2dNormActivation: `.0`; older is bare
        inner = inner if f"{inner}.weight" in sd else f"{inner}.0"
        outer = outer if f"{outer}.weight" in sd else f"{outer}.0"
        fpn[f"lateral{lvl}"] = _conv(sd, inner)
        fpn[f"output{lvl}"] = _conv(sd, outer)
    fpn["p6"] = _conv(sd, "backbone.fpn.extra_blocks.p6")
    fpn["p7"] = _conv(sd, "backbone.fpn.extra_blocks.p7")

    head = params["head"]
    for i in range(4):
        cname = f"head.classification_head.conv.{i}"
        bname = f"head.regression_head.conv.{i}"
        cname = cname if f"{cname}.weight" in sd else f"{cname}.0"
        bname = bname if f"{bname}.weight" in sd else f"{bname}.0"
        head[f"cls_tower{i}"] = _conv(sd, cname)
        head[f"box_tower{i}"] = _conv(sd, bname)
    head["cls_score"] = _conv(sd, "head.classification_head.cls_logits")
    head["bbox_pred"] = _conv(sd, "head.regression_head.bbox_reg")
    return params


def params_from_flax(tree: Mapping, device="cpu") -> Dict[str, torch.Tensor]:
    """The JAX package's parameter tree -> the port's {name: float32 tensor}
    (``backbone.res2_block0.conv1.weight``, ...) on ``device``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{key}.")
                continue
            value = _arr(value)
            if key == "kernel":
                key, value = "weight", value.transpose(3, 2, 0, 1)
            out[prefix + key] = torch.as_tensor(np.array(value, order="C"), device=device)

    walk(tree, "")
    return out


def params_to_flax(params: Mapping[str, torch.Tensor]) -> Dict:
    """The inverse of ``params_from_flax``: nested dicts of float32 numpy
    arrays in the Flax layout."""
    tree: Dict = {}
    for name, value in params.items():
        *path, key = name.split(".")
        value = _arr(value)
        if key == "weight" and value.ndim == 4:
            key, value = "kernel", np.ascontiguousarray(value.transpose(2, 3, 1, 0))
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[key] = value
    return tree


def detect_p6_source(params: Mapping[str, torch.Tensor]) -> str:
    """Which feature the FPN P6 conv of the port's ``params`` consumes, from
    its in-channels: 2048 -> "c5" (detectron2, the reference's layout),
    256 -> "p5" (torchvision)."""
    cin = int(params["fpn.p6.weight"].shape[1])
    if cin == 2048:
        return "c5"
    if cin == 256:
        return "p5"
    raise ValueError(f"unrecognized P6 kernel in-channels: {cin}")


def merge_pretrained(params: Mapping[str, torch.Tensor],
                     converted: Mapping[str, torch.Tensor]):
    """Copy every converted tensor whose shape matches into ``params``;
    the others (the num_classes-dependent cls_score of a COCO checkpoint)
    keep their fresh values: detectron2's checkpointer semantics for the
    reference's NUM_CLASSES=6 (neural_sim_main.py:602-617). Returns
    (merged, skipped names)."""
    merged, skipped = {}, []
    for name, fresh in params.items():
        ckpt = converted[name]
        if tuple(fresh.shape) == tuple(ckpt.shape):
            merged[name] = ckpt.to(dtype=fresh.dtype, device=fresh.device)
        else:
            merged[name] = fresh
            skipped.append(name)
    return merged, skipped


def load_retinanet_checkpoint(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """A local .pth/.pt/.npz checkpoint -> the port's parameters."""
    if path.endswith(".npz"):
        with np.load(path) as flat:
            sd = {k: flat[k] for k in flat.files}
    else:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        sd = ckpt.get("model", ckpt.get("state_dict", ckpt))
    return params_from_flax(convert_torchvision_retinanet(sd), device)
