"""Process-group bootstrap and NeRF parameter sharding (the port of
``neuralsim_tpu/parallel/distributed.py``).

The JAX package joins hosts with ``jax.distributed.initialize`` and lets
sharding annotations do the rest. The port runs one process per rank on a
``torch.distributed`` process group: NCCL between cards, gloo on the CPU
(or for several ranks on one card, which NCCL refuses). ``parallel.mesh``
holds the layout and the collectives.

Sharding rules, as in the JAX package:
  - NeRF params: replicated by default; ``nerf_param_sharding`` optionally
    splits the wide layers over the ``model`` axis (tensor parallelism);
  - detector params: replicated, the inner train's image batch split over
    ``data``;
  - ray and image batches: leading dimension over ``data``.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from neuralsim_tpu_torch import resolve_device
from neuralsim_tpu_torch.parallel.mesh import Mesh, all_gather, replicate


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           backend: Optional[str] = None, device=None) -> bool:
    """Join this process to a group of ``num_processes`` ranks as rank
    ``process_id``, the first rank listening at ``coordinator_address``
    ("host:port"). A no-op returning False for a single process (None or
    <= 1), as in the JAX package; True once joined.

    The backend is NCCL when the device is CUDA (the default device, which
    raises without a GPU) and gloo when it is the CPU; ``backend``
    overrides that choice (gloo for several ranks on one card). A failure
    to initialise raises: no other backend is tried."""
    if num_processes is None or num_processes <= 1:
        return False
    if coordinator_address is None or process_id is None:
        raise ValueError("a group of several processes needs coordinator_address and "
                         "process_id")
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def _wide(x, model: int) -> bool:
    return x.shape[-1] % model == 0 and x.shape[-1] >= 128


class ModelShards(dict):
    """A NeRF parameter tree ({name: tensor}, or {"coarse": ..., "fine":
    ...}) whose wide layers hold this rank's column block over the mesh's
    model axis. ``split`` holds the paths of those leaves."""

    def __init__(self, tree: dict, mesh: Mesh, split: frozenset):
        super().__init__(tree)
        self.mesh = mesh
        self.split = split

    def whole_layers(self) -> dict:
        """The tree with every block all-gathered over the model group
        into its whole layer, as XLA gathers the operands of a Pallas
        custom call; the render calls this before its kernel, which takes
        whole layers."""
        group = self.mesh.model_group

        def walk(tree, path):
            if isinstance(tree, dict):
                return {k: walk(v, path + (k,)) for k, v in tree.items()}
            return all_gather(tree, group, dim=-1) if path in self.split else tree

        return walk(dict(self), ())


def nerf_param_sharding(params, mesh: Mesh, tensor_parallel: bool = False):
    """Place NeRF params: replicated, or column-split over 'model'.

    The params are first replicated from the mesh's first rank. With
    ``tensor_parallel`` and a model axis of m > 1, each ``*_kernel`` [in,
    out] whose output width divides by m and is at least 128 is split by
    columns, as is its ``*_bias`` [out]: the rank at model coordinate j
    holds block j of m, the shard of JAX's ``P(None, 'model')`` /
    ``P('model')`` on that mesh position. Everything else stays whole (the
    alpha head of width 1, the rgb head of width 3).

    The result is a ``ModelShards``: the render all-gathers the blocks over
    the model group before the ray-march kernel, which takes whole layers
    (``ModelShards.whole_layers``), as XLA gathers the operands of a Pallas
    custom call on the TPU. A column-parallel kernel, which the JAX package
    lacks too, is not part of the port."""
    full = replicate(params, mesh)
    m = mesh.shape["model"]
    if not tensor_parallel or m == 1:
        return full
    j = mesh.index("model")
    split = set()

    def place(tree, path):
        if isinstance(tree, dict):
            return {k: place(v, path + (k,)) for k, v in tree.items()}
        name = str(path[-1])
        if name.endswith(("_kernel", "_bias")) and _wide(tree, m):
            split.add(path)
            w = tree.shape[-1] // m
            return tree[..., j * w:(j + 1) * w].contiguous()
        return tree

    return ModelShards(place(full, ()), mesh, frozenset(split))
