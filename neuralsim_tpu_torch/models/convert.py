"""NeRF weights in and out of the port.

The param dict has the JAX package's keys and layout
(``neuralsim_tpu/models/nerf.py:45-73``): ``pts_{i}_kernel [in, out]``,
``pts_{i}_bias [out]``, ``feature_*``, ``alpha_*``, ``views_0_*``,
``rgb_*``. A pipeline holds ``{"coarse": params, "fine": params}``.

The reference's published checkpoints (``ycbvid{id}.tar``) are torch
``state_dict`` archives whose ``nn.Linear`` weights are ``[out, in]``;
``convert_torch_checkpoint`` maps their keys and transposes each weight.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_NAME_MAP = [
    ("feature_linear", "feature"),
    ("alpha_linear", "alpha"),
    ("views_linears.0", "views_0"),
    ("rgb_linear", "rgb"),
    ("output_linear", "output"),
]


def params_from_numpy(models, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"coarse": {name: array}, ...} -> the same nesting of float32
    tensors on ``device``. Accepts numpy arrays or tensors."""
    def tensor(v):
        if not isinstance(v, torch.Tensor):
            v = np.asarray(v)
        return torch.as_tensor(v, dtype=torch.float32, device=device)

    return {name: {k: tensor(v) for k, v in params.items()}
            for name, params in models.items()}


def params_to_numpy(models) -> Dict[str, Dict[str, np.ndarray]]:
    return {
        name: {k: v.detach().cpu().numpy() for k, v in params.items()}
        for name, params in models.items()
    }


def _convert_state_dict(sd: Dict) -> Dict[str, np.ndarray]:
    params: Dict[str, np.ndarray] = {}
    for key, val in sd.items():
        arr = np.asarray(val.detach().cpu().numpy() if hasattr(val, "detach") else val,
                         dtype=np.float32)
        if key.startswith("pts_linears."):
            _, idx, kind = key.split(".")
            name = f"pts_{idx}"
        else:
            name = None
            for torch_name, ours in _NAME_MAP:
                if key.startswith(torch_name):
                    name, kind = ours, key.rsplit(".", 1)[1]
                    break
            if name is None:
                raise KeyError(f"unrecognized checkpoint key: {key}")
        if kind == "weight":
            params[f"{name}_kernel"] = arr.T.copy()
        elif kind == "bias":
            params[f"{name}_bias"] = arr
        else:
            raise KeyError(f"unrecognized parameter kind in key: {key}")
    return params


def convert_torch_checkpoint(ckpt: Dict) -> Dict[str, Dict[str, np.ndarray]]:
    """A loaded reference checkpoint dict -> {'coarse': ..., 'fine': ...}."""
    models = {"coarse": _convert_state_dict(ckpt["network_fn_state_dict"])}
    fine = ckpt.get("network_fine_state_dict")
    if fine is not None:
        models["fine"] = _convert_state_dict(fine)
    return models


def load_nerf_checkpoint(path: str):
    """(models, global_step) of a reference ``.tar`` checkpoint."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return convert_torch_checkpoint(ckpt), int(ckpt.get("global_step", 0))


def save_params_npz(path: str, models: Dict[str, Dict[str, np.ndarray]]):
    flat = {f"{name}/{k}": np.asarray(v)
            for name, params in models.items() for k, v in params.items()}
    np.savez(path, **flat)


def load_params_npz(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    flat = np.load(path)
    models: Dict[str, Dict[str, np.ndarray]] = {}
    for key in flat.files:
        model_name, pname = key.split("/", 1)
        models.setdefault(model_name, {})[pname] = flat[key]
    return models
