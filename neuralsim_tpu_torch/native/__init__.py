"""The host annotation library (the port of ``neuralsim_tpu/native``):
C++ connected components and COCO RLE, with their numpy twins.

``connected_components`` and ``rle_encode`` replace the OpenCV /
pycocotools C extensions used by the reference's auto-annotation
(``optimization/neural_sim_main.py:786-797, 825``). They run the C++
library, built with g++ at first use (``native/build.py``); a build that
fails raises. The numpy twins (``_connected_components_np``,
``_rle_encode_np``) are the oracle the tests hold the library to. They
serve the host annotation path and COCO export, never the device path.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import numpy as np

_LIB = None


def _load_lib():
    """The built library (g++ at the first call; raises if it fails)."""
    global _LIB
    if _LIB is None:
        from neuralsim_tpu_torch.native.build import build

        lib = ctypes.CDLL(str(build()))
        lib.connected_components_stats.restype = ctypes.c_int32
        lib.connected_components_stats.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.rle_encode_mask.restype = ctypes.c_int32
        lib.rle_encode_mask.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint32),
        ]
        _LIB = lib
    return _LIB


Stats = Tuple[int, int, int, int, int]  # (x, y, w, h, area)


def connected_components(mask: np.ndarray, max_components: int = 256) -> List[Stats]:
    """8-connected component stats of a binary mask, background excluded.
    ``max_components`` sizes the first buffer; a mask with more components
    is labelled again with room for the most an h x w mask can hold."""
    mask = np.ascontiguousarray(mask.astype(np.uint8))
    h, w = mask.shape
    lib = _load_lib()
    for room in (max_components, ((h + 1) // 2) * ((w + 1) // 2)):
        stats = np.zeros((max(room, 1), 5), np.int32)
        n = lib.connected_components_stats(
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            h, w,
            stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            stats.shape[0], None,
        )
        if n >= 0:
            return [tuple(int(v) for v in row) for row in stats[:n]]
    raise RuntimeError(f"connected components: more than {room} in a {h}x{w} mask")


def _connected_components_np(mask: np.ndarray) -> List[Stats]:
    """Two-pass union-find in numpy/python (the library's oracle)."""
    h, w = mask.shape
    labels = np.zeros((h, w), np.int32)
    parent = [0]

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def unite(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra

    nxt = 1
    for y in range(h):
        for x in range(w):
            if not mask[y, x]:
                continue
            neigh = []
            if y > 0 and labels[y - 1, x]:
                neigh.append(labels[y - 1, x])
            if x > 0 and labels[y, x - 1]:
                neigh.append(labels[y, x - 1])
            if y > 0 and x > 0 and labels[y - 1, x - 1]:
                neigh.append(labels[y - 1, x - 1])
            if y > 0 and x + 1 < w and labels[y - 1, x + 1]:
                neigh.append(labels[y - 1, x + 1])
            if not neigh:
                labels[y, x] = nxt
                parent.append(nxt)
                nxt += 1
            else:
                lab = min(neigh)
                labels[y, x] = lab
                for nb in neigh:
                    unite(lab, nb)

    out: Dict[int, List[int]] = {}
    ys, xs = np.nonzero(labels)
    for y, x in zip(ys, xs):
        root = find(labels[y, x])
        if root not in out:
            out[root] = [x, y, x, y, 0]
        s = out[root]
        s[0] = min(s[0], x)
        s[1] = min(s[1], y)
        s[2] = max(s[2], x)
        s[3] = max(s[3], y)
        s[4] += 1
    return [
        (int(s[0]), int(s[1]), int(s[2] - s[0] + 1), int(s[3] - s[1] + 1), int(s[4]))
        for s in out.values()
    ]


def rle_encode(mask: np.ndarray) -> Dict:
    """COCO uncompressed RLE ({'size': [h, w], 'counts': [...]}),
    column-major starting with a zero-run — pycocotools-compatible."""
    mask = np.ascontiguousarray(mask.astype(np.uint8))
    h, w = mask.shape
    counts = np.zeros(h * w + 1, np.uint32)
    n = _load_lib().rle_encode_mask(
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    return {"size": [h, w], "counts": [int(c) for c in counts[:n]]}


def _rle_encode_np(mask: np.ndarray) -> Dict:
    """rle_encode in numpy/python (the library's oracle)."""
    h, w = mask.shape
    flat = mask.T.reshape(-1)
    counts = []
    current, run = 0, 0
    for v in flat:
        if int(v != 0) == current:
            run += 1
        else:
            counts.append(run)
            current = int(v != 0)
            run = 1
    counts.append(run)
    return {"size": [h, w], "counts": counts}


def rle_decode(rle: Dict) -> np.ndarray:
    h, w = rle["size"]
    flat = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for c in rle["counts"]:
        flat[pos: pos + c] = val
        pos += c
        val = 1 - val
    return flat.reshape(w, h).T
