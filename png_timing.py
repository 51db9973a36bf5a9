#!/usr/bin/env python3
"""Times the port's PNG reader (``neuralsim_tpu_torch/utils/png.py``) on
the host's CPU, on both of its reconstructions.

    python3 png_timing.py [--frames 22] [--side 400] [--reps 5]

One RGBA frame of ``side``^2 (a smooth gradient with noise, as a render
with an alpha channel) is written twice: by ``write_png`` (every row
filter 0, so ``read_png`` takes its row path) and by this script's
encoder with the five filter types in turn row by row, as an adaptive
encoder mixes them (so ``read_png`` takes its anti-diagonal path). Both
files must read back equal to the frame. It prints, as one JSON line, the
median over ``reps`` of ``read_png`` on each file and of
``load_linemod_data(half_res=True)`` on a LINEMOD-layout directory of
``frames`` copies of each, with the CPU it ran on. Needs no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import shutil
import statistics
import struct
import tempfile
import time
import zlib

import numpy as np

from neuralsim_tpu_torch.data import load_linemod_data
from neuralsim_tpu_torch.utils.png import read_png, write_png


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_mixed_filters(path: str, img: np.ndarray):
    """An RGBA PNG whose row r carries filter r % 5 (None, Sub, Up,
    Average, Paeth), filtered with numpy (the encoder sees every byte)."""
    h, w, bpp = img.shape
    x = img.astype(np.int64)
    a = np.pad(x, ((0, 0), (1, 0), (0, 0)))[:, :-1]          # left
    b = np.pad(x, ((1, 0), (0, 0), (0, 0)))[:-1]             # up
    c = np.pad(x, ((1, 0), (1, 0), (0, 0)))[:-1, :-1]        # up-left
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = [np.zeros_like(x), a, b, (a + b) >> 1, paeth]
    kind = np.arange(h) % 5
    filt = np.stack([(x[r] - preds[kind[r]][r]) & 255 for r in range(h)]).astype(np.uint8)
    raw = np.concatenate([kind[:, None].astype(np.uint8), filt.reshape(h, w * bpp)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def frame(side: int) -> np.ndarray:
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:side, 0:side] / side
    rgb = np.stack([xx, yy, 0.5 * (xx + yy)], -1) * 200 + rng.rand(side, side, 3) * 40
    alpha = ((xx - 0.5) ** 2 + (yy - 0.5) ** 2 < 0.1) * 255
    return np.concatenate([rgb, alpha[..., None]], -1).astype(np.uint8)


def linemod_dir(root: str, png: str, n: int) -> str:
    """A LINEMOD-layout directory whose train, val and test splits hold
    copies of png (n frames in all)."""
    os.makedirs(root)
    k = [[500.0, 0.0, 200.0], [0.0, 500.0, 200.0], [0.0, 0.0, 1.0]]
    counts = {"train": n - 6, "val": 2, "test": 4}
    for split, count in counts.items():
        frames = []
        for i in range(count):
            path = os.path.join(root, f"{split}_{i}.png")
            shutil.copy(png, path)
            c2w = np.eye(4)
            c2w[2, 3] = 1.0
            frames.append({"file_path": path, "transform_matrix": c2w.tolist(),
                           "intrinsic_matrix": k})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"frames": frames, "near": 0.5, "far": 1.5}, f)
    return root


def median_s(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--frames", type=int, default=22)
    parser.add_argument("--side", type=int, default=400)
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()
    img = frame(args.side)
    out = {"cpu": platform.processor() or platform.machine(), "cpus": os.cpu_count(),
           "side": args.side, "frames": args.frames}
    with tempfile.TemporaryDirectory() as tmp:
        for name, writer in (("filter0_rows", write_png), ("mixed_diagonals", write_mixed_filters)):
            path = os.path.join(tmp, f"{name}.png")
            writer(path, img)
            if not np.array_equal(read_png(path), img):
                raise SystemExit(f"png_timing: {name} does not read back equal")
            d = linemod_dir(os.path.join(tmp, name), path, args.frames)
            out[name] = {
                "bytes": os.path.getsize(path),
                "read_png_ms": 1e3 * median_s(lambda: read_png(path), args.reps),
                "load_linemod_s": median_s(lambda: load_linemod_data(d, half_res=True),
                                           args.reps),
            }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
