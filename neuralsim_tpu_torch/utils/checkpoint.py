"""Checkpoint/resume of the whole bilevel state (the port of
``neuralsim_tpu/utils/checkpoint.py``), without orbax.

The reference checkpoints only the NeRF (.tar every i_weights iters,
run_nerf_noscale.py:723-731) and the detector (model_final.pth chaining
outer iterations, neural_sim_main.py:841); psi itself is never
checkpointed. Here one file per step, ``ckpt_{step:08d}.pt``, holds the
whole state as nested dicts and lists of tensors (psi and its optimizer,
the detector's parameters and optimizer state, the driver's generator
state, the epoch), so a resume is exact.

The manager also reads the JAX package's npz fallback layout
(``ckpt_{step:08d}.npz``: ``leaf_{i}`` arrays in JAX's flatten order, with
``__treedef__``). Those leaves are unflattened into a ``like`` tree in the
JAX layout (dict keys sorted at every level, as JAX flattens them);
``bilevel.driver.bilevel_state_from_jax`` carries that tree into the port's
state.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch


def _jax_leaves(tree):
    """The leaves of nested dicts / lists / tuples in JAX's flatten order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _jax_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _jax_leaves(v)
    else:
        yield tree


def _jax_unflatten(like, leaves):
    """``like``'s structure filled with ``leaves`` (an iterator) in JAX's
    flatten order."""
    if isinstance(like, dict):
        return {k: _jax_unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return [_jax_unflatten(v, leaves) for v in like]
    return next(leaves)


class CheckpointManager:
    """Numbered checkpoints in one directory, the newest ``max_to_keep``
    kept."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int, ext: str) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.{ext}")

    def save(self, step: int, state: Dict[str, Any]):
        """Write ``state`` (nested dicts / lists of tensors and python
        scalars) as step ``step``; tensors are stored from the host."""
        state = _to_host(state)
        tmp = self._path(step, "pt.tmp")
        torch.save(state, tmp)
        os.replace(tmp, self._path(step, "pt"))
        for s in self._steps("pt")[: -self.max_to_keep]:
            os.remove(self._path(s, "pt"))

    def latest_step(self) -> Optional[int]:
        steps = sorted(set(self._steps("pt")) | set(self._steps("npz")))
        return steps[-1] if steps else None

    def is_jax_layout(self, step: int) -> bool:
        """Whether step ``step`` is the JAX package's npz (and not the
        port's own file)."""
        return (not os.path.exists(self._path(step, "pt"))
                and os.path.exists(self._path(step, "npz")))

    def restore(self, step: Optional[int] = None,
                like: Optional[Dict[str, Any]] = None) -> Optional[Dict[str, Any]]:
        """The state of ``step`` (default: the latest), or None if there
        is none. A port checkpoint comes back as saved, on the CPU; with
        ``like`` its tensors move to the devices of like's. A JAX npz needs
        ``like`` in the JAX layout and comes back as numpy arrays in it."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        if self.is_jax_layout(step):
            if like is None:
                raise ValueError("npz restore requires a `like` tree in the JAX layout")
            with np.load(self._path(step, "npz")) as data:
                n = len(data.files) - 1
                leaves = [data[f"leaf_{i}"] for i in range(n)]
            expected = sum(1 for _ in _jax_leaves(like))
            if expected != n:
                raise ValueError(f"JAX checkpoint {step} holds {n} leaves; the layout "
                                 f"given has {expected}")
            return _jax_unflatten(like, iter(leaves))
        state = torch.load(self._path(step, "pt"), map_location="cpu", weights_only=True)
        return state if like is None else _to_devices(state, like)

    def _steps(self, ext: str):
        suffix = f".{ext}"
        return sorted(
            int(f[5:-len(suffix)]) for f in os.listdir(self.directory)
            if f.startswith("ckpt_") and f.endswith(suffix)
        )


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_host(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def _to_devices(tree, like):
    if isinstance(tree, dict):
        return {k: _to_devices(v, like[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_devices(v, w) for v, w in zip(tree, like)]
    if isinstance(tree, torch.Tensor) and isinstance(like, torch.Tensor):
        return tree.to(like.device)
    return tree


def save_nerf_tar_compatible(path: str, models: Dict, global_step: int = 0):
    """Write a reference-layout ``.tar`` checkpoint (``network_fn_state_dict``
    / ``network_fine_state_dict``, torch Linear weights [out, in]) from the
    port's NeRF params: the inverse of ``models.convert.load_nerf_checkpoint``."""

    def to_sd(params):
        sd = {}
        groups: Dict[str, Dict[str, np.ndarray]] = {}
        for key, val in params.items():
            name, kind = key.rsplit("_", 1)
            if isinstance(val, torch.Tensor):
                val = val.detach().cpu().numpy()
            groups.setdefault(name, {})[kind] = np.asarray(val)
        name_map = {
            "feature": "feature_linear", "alpha": "alpha_linear",
            "views_0": "views_linears.0", "rgb": "rgb_linear",
            "output": "output_linear",
        }
        for name, kv in groups.items():
            if name.startswith("pts_"):
                torch_name = f"pts_linears.{name[4:]}"
            else:
                torch_name = name_map[name]
            sd[f"{torch_name}.weight"] = torch.from_numpy(kv["kernel"].T.copy())
            sd[f"{torch_name}.bias"] = torch.from_numpy(kv["bias"].copy())
        return sd

    ckpt = {
        "global_step": global_step,
        "network_fn_state_dict": to_sd(models["coarse"]),
    }
    if "fine" in models:
        ckpt["network_fine_state_dict"] = to_sd(models["fine"])
    torch.save(ckpt, path)
