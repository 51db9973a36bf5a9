"""The ('data', 'model') mesh on ``torch.distributed`` (the port of
``neuralsim_tpu/parallel/mesh.py``).

JAX runs its mesh from one controller: one program, inputs sharded, and
XLA inserts the psums and all-gathers. The port runs one process per rank
instead, and holds the same contract, that a sharded result equals the
unsharded one:

  - every rank executes the same Python and draws the same random numbers
    from the same seed;
  - every rank computes the replicated stages the same way, as XLA does
    for replicated operands;
  - each rank takes its block of what JAX shards: the rank at data
    coordinate i of d holds rows [i n / d, (i + 1) n / d) of the leading
    dimension, the block of JAX's ``P("data")`` on that mesh position
    (``shard_rays``, ``shard_batch``);
  - a collective stands where XLA would put one: ``all_sum`` for a psum,
    ``all_gather`` for an all-gather of sharded outputs.

The collectives take the tensors where they lie: NCCL on the card, gloo
on the CPU, and gloo on the card too, which runs all_reduce, broadcast and
all_gather on CUDA tensors itself (chip_smoke.py phase 12 checks it), so
nothing is staged through the host.

Ranks are laid out as ``ranks.reshape(data, model)``, as JAX lays out its
devices. Start the process group first (``distributed.
initialize_distributed``, or ``launch.launch`` for N ranks on one host);
without one, ``make_mesh`` lays out this process alone, and every
collective over its one-rank groups is the identity.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from neuralsim_tpu_torch import resolve_device

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A ('data', 'model') layout of global ranks and this rank's place in
    it.

    ``devices`` [data, model] holds global ranks (JAX's ``mesh.devices``);
    ``group`` spans the mesh, ``data_group`` the ranks that share this
    rank's model coordinate, ``model_group`` those that share its data
    coordinate (None without a process group). ``device`` is where this
    rank computes."""

    devices: np.ndarray
    rank: int
    device: torch.device
    group: object = None
    data_group: object = None
    model_group: object = None

    axis_names = AXES

    @property
    def shape(self) -> dict:
        d, m = self.devices.shape
        return {"data": d, "model": m}

    @property
    def coords(self) -> Optional[Tuple[int, int]]:
        """(data, model) coordinates of this rank; None when the mesh
        leaves it out."""
        hit = np.argwhere(self.devices == self.rank)
        return (int(hit[0][0]), int(hit[0][1])) if hit.size else None

    @property
    def first_rank(self) -> int:
        return int(self.devices.flat[0])

    @property
    def is_first(self) -> bool:
        """Whether this rank is the mesh's first: the one that writes files."""
        return self.rank == self.first_rank

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        coords = self.coords
        if coords is None:
            raise ValueError(f"rank {self.rank} is not in the mesh {self.devices.tolist()}")
        return coords[AXES.index(axis)]


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _mesh_device(device) -> torch.device:
    """The card this process is bound to (``torch.cuda.current_device``,
    which the launcher sets per rank) unless the caller asks for another
    device; raises without a GPU, as every entry point does."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(data: int = -1, model: int = 1, ranks: Optional[Sequence[int]] = None,
              device=None) -> Mesh:
    """Create a ('data', 'model') mesh over ``ranks`` (default: every rank
    of the process group, or this process alone without one).

    data=-1 takes all the ranks on the data axis. When data * model is
    less than the number of ranks, the ranks beyond it are left out, as
    JAX truncates its devices. Every rank of the process group must call
    this with the same arguments: each creates every group, in one order.
    """
    world, rank = _world()
    ranks = np.arange(world) if ranks is None else np.asarray(list(ranks))
    n = ranks.size
    if data == -1:
        if n % model:
            raise ValueError(f"{n} ranks not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"a {data}x{model} mesh needs {data * model} ranks, there are {n}")
    layout = ranks[: data * model].reshape(data, model)
    groups = {}
    if dist.is_available() and dist.is_initialized():
        def new_group(members):
            g = dist.new_group([int(r) for r in members])
            return g if rank in members else None

        groups["group"] = new_group(list(layout.ravel()))
        for j in range(model):
            g = new_group(list(layout[:, j]))
            if g is not None:
                groups["data_group"] = g
        for i in range(data):
            g = new_group(list(layout[i, :]))
            if g is not None:
                groups["model_group"] = g
    return Mesh(layout, rank, _mesh_device(device), **groups)


# --------------------------------------------------------------------------- #
# collectives
# --------------------------------------------------------------------------- #


def all_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (XLA's psum), as a new tensor; ``t``
    itself without a group."""
    if group is None:
        return t
    out = t.detach().clone().contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors (one shape) concatenated along ``dim`` in group
    order (XLA's all-gather of a sharded output); ``t`` without a group."""
    if group is None:
        return t
    src = t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` of global rank ``src`` on every rank of ``group``, as a new
    tensor (never the caller's, see ``replicate``)."""
    out = t.detach().clone().contiguous()
    if group is not None:
        dist.broadcast(out, src=src, group=group)
    return out


def barrier(mesh: Mesh):
    """Wait for every rank of the mesh."""
    if mesh.group is None:
        return
    if dist.get_backend(mesh.group) == "nccl":
        dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
    else:
        dist.barrier(group=mesh.group)


def tree_map(fn, tree):
    """fn over the leaves of nested dicts, lists, tuples and NamedTuples."""
    if isinstance(tree, dict):
        return type(tree)({k: tree_map(fn, v) for k, v in tree.items()})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _coalesced(tree, fn):
    """Apply ``fn(flat buffer) -> flat buffer`` to all tensor leaves at
    once, one buffer per dtype (one collective per dtype instead of one
    per leaf); returns the tree with the new leaves."""
    found = {}
    tree_map(lambda x: found.setdefault(id(x), x) if isinstance(x, torch.Tensor) else x, tree)
    leaves = list(found.values())
    new = {}
    for dtype in dict.fromkeys(t.dtype for t in leaves):
        same = [t for t in leaves if t.dtype == dtype]
        flat = fn(torch.cat([t.detach().reshape(-1) for t in same]))
        for t, part in zip(same, torch.split(flat, [t.numel() for t in same])):
            new[id(t)] = part.view(t.shape)
    return tree_map(lambda x: new[id(x)] if isinstance(x, torch.Tensor) else x, tree)


def all_sum_tree(tree, group):
    """``all_sum`` of every tensor leaf, in one collective per dtype."""
    if group is None:
        return tree
    return _coalesced(tree, lambda flat: all_sum(flat, group))


# --------------------------------------------------------------------------- #
# placement
# --------------------------------------------------------------------------- #


def replicate(tree, mesh: Mesh):
    """Fully replicate a tree (NeRF params, a train state, the val set)
    across the mesh: every rank holds the bits of the mesh's first rank,
    on its own device. Numpy leaves become tensors.

    The leaves are always new tensors, never the caller's: a broadcast
    into a tensor does not bump its version, so a weight set the kernels
    packed before (``kernels.raymarch._packed_weights``, keyed by id and
    version) would otherwise be served stale."""
    def to_device(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(mesh.device) if isinstance(x, torch.Tensor) else x

    tree = tree_map(to_device, tree)
    return _coalesced(tree, lambda flat: broadcast(flat, mesh.first_rank, mesh.group))


def _block(x, mesh: Mesh, axis: str):
    n_blocks = mesh.shape[axis]
    n = x.shape[0]
    if n % n_blocks:
        raise ValueError(f"a leading dimension of {n} does not divide over the "
                         f"{n_blocks} ranks of the {axis!r} axis")
    b = n // n_blocks
    i = mesh.index(axis)
    return x[i * b:(i + 1) * b]


def shard_rays(rays, mesh: Mesh):
    """This rank's block of a flat [N, ...] ray array along the data axis.
    N must divide over the axis (JAX's ``device_put`` raises too; its
    docstring's padding is not what its code does)."""
    return _block(rays, mesh, "data")


def shard_batch(tree, mesh: Mesh, axis: str = "data"):
    """This rank's block of every leaf's leading dimension along ``axis``."""
    return tree_map(lambda x: _block(x, mesh, axis), tree)


def pad_to_multiple(n: int, k: int) -> int:
    return -(-n // k) * k


def pad_rows(x: torch.Tensor, n: int, zero: bool = False) -> torch.Tensor:
    """x's leading dimension padded to n rows, repeating its last row (or
    with zeros): what a batch that must divide over the data axis takes."""
    pad = n - x.shape[0]
    if not pad:
        return x
    fill = torch.zeros_like(x[-1:]) if zero else x[-1:]
    return torch.cat([x, fill.expand((pad,) + tuple(x.shape[1:]))], 0)


def shard_map_compat(f, mesh: Mesh, in_specs, out_specs):
    """The counterpart of JAX's ``shard_map``: ``f`` runs on this rank's
    blocks of the arguments whose spec is "data" (the others whole), and
    each output whose spec is "data" is all-gathered along the data axis
    (None: returned as this rank computed it). ``out_specs`` is one spec,
    or a tuple of specs for a tuple of outputs.

    JAX's replication check (``check_vma`` / ``check_rep``), which the
    reference turns off, has no counterpart: a rank's output is whatever
    it computed."""
    def gather(x, spec):
        return all_gather(x, mesh.data_group) if spec == "data" else x

    def run(*args):
        local = [shard_batch(a, mesh) if spec == "data" else a
                 for a, spec in zip(args, in_specs)]
        out = f(*local)
        if isinstance(out_specs, tuple):
            return tuple(tree_map(lambda x, s=s: gather(x, s), o)
                         for o, s in zip(out, out_specs))
        return tree_map(lambda x: gather(x, out_specs), out)

    return run
