"""Run a function on N ranks of one host: the counterpart of the JAX
package's virtual-device mesh, which a single controller gets for free.

``launch(fn, n_ranks, args, device=...)`` spawns N processes (start
method ``spawn``: CUDA cannot be forked), joins them into one process group
through ``initialize_distributed`` on a free localhost port, runs
``fn(*args)`` in each and returns the ranks' results in rank order, with
every tensor in them as numpy. A rank that raises, dies or outlives the
call's one time limit fails the whole call, and the other ranks are
stopped.

On the card every rank binds ``cuda:{rank % cards}``; several ranks on one
card need ``backend="gloo"`` (NCCL refuses two ranks on one device). Each
rank loads the kernels' libraries that an earlier build left in
``kernels/_build/`` and builds only what is missing.
"""

from __future__ import annotations

import multiprocessing
import queue
import socket
import time
import traceback
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from neuralsim_tpu_torch.parallel.distributed import initialize_distributed
from neuralsim_tpu_torch.parallel.mesh import tree_map


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def _rank_main(fn, rank: int, n_ranks: int, port: int, backend: Optional[str], device: str,
               threads: Optional[int], args: Sequence, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        initialize_distributed(f"localhost:{port}", n_ranks, rank, backend=backend,
                               device=device)
        out = tree_map(_host, fn(*args))
        results.put((rank, True, out))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn, n_ranks: int, args: Sequence = (), *, device: str = "cuda",
           backend: Optional[str] = None, timeout: float = 600.0,
           threads: Optional[int] = None) -> list:
    """``fn(*args)`` on each of ``n_ranks`` spawned processes of one
    process group; returns [rank 0's result, ..., rank n-1's]. ``fn`` and
    ``args`` must pickle (a module-level function; CPU tensors or numpy).
    ``backend`` as in ``initialize_distributed``; ``threads``: torch's
    intra-op threads per rank. Raises RuntimeError when a rank fails and
    TimeoutError when the ranks outlive ``timeout`` seconds."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, n_ranks, port, backend, device, threads, args, results))
             for r in range(n_ranks)]
    deadline = time.monotonic() + timeout
    out, failed = {}, None
    try:
        for p in procs:
            p.start()
        while len(out) < n_ranks and failed is None:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{n_ranks} ranks of {getattr(fn, '__name__', fn)} did not "
                                   f"finish in {timeout:g} s (done: {sorted(out)})")
            try:
                rank, ok, payload = results.get(timeout=min(1.0, left))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in out and p.exitcode is not None]
                if dead:
                    # its result may still be in the pipe: one more look
                    try:
                        rank, ok, payload = results.get(timeout=5.0)
                    except queue.Empty:
                        failed = (f"rank {dead[0]} exited with code {procs[dead[0]].exitcode} "
                                  "without a result")
                        continue
                else:
                    continue
            if ok:
                out[rank] = payload
            else:
                failed = f"rank {rank} failed:\n{payload}"
        if failed is not None:
            raise RuntimeError(failed)
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return [out[r] for r in range(n_ranks)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=5.0)
        results.close()

