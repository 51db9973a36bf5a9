"""The yardstick's arithmetic of the hash-grid ray march (``csrc/ngp_march.cu``):
its work from the hash field's settings (the reference's layout,
``reference/ngp.py``) and a call's shape; ``work.py`` holds the peaks and
the least time.

Every count follows from a configuration's ``hash`` section and a call's
shape, never from what the program reports. A point's operations: the
two MLPs' multiply-adds (the density MLP's and the colour MLP's, no
biases) and the interpolation's, L levels x 2^3 corners x F features,
each counted as two operations. A call's bytes: each input read once
(origins, directions, view directions [N,3], depths [N,S]), each output
written once (sigma [N,S], rgb [3,N,S]), and the table and the MLP
weights once. The corners' gathers that the caches serve are not counted
as bytes, so a call's least time is never above its time.
"""

from __future__ import annotations

from bench_port.reference.ngp import grid_of, kernel_shapes, rows_of


def table_rows(h: dict) -> int:
    """Rows of the table: (N + 1)^3 a dense level, 2^log2_hashmap_size a
    hashed one (the reference's layout)."""
    return rows_of(grid_of(h))


def mlp_macs(h: dict) -> int:
    """Multiply-adds of one point through both bias-free MLPs (9,408 for
    Instant-NGP's)."""
    return sum(a * b for a, b in kernel_shapes(grid_of(h)).values())


def flop_per_point(h: dict) -> float:
    return 2.0 * (mlp_macs(h) + h["hash_levels"] * 8 * h["hash_features"])


def weight_bytes(h: dict) -> int:
    """The table's and the MLP kernels' bytes in float32 (a bias-free
    kernel holds one weight a multiply-add)."""
    return 4 * (table_rows(h) * h["hash_features"] + mlp_macs(h))


def march_work(h: dict, n: int, s: int):
    """(FLOP, bytes) of one hash march call on n rays x s samples."""
    m = n * s
    return flop_per_point(h) * m, 3 * n * 3 * 4 + m * 4 + 4 * m * 4 + weight_bytes(h)
