"""PNG on ``zlib`` and ``struct`` alone, so that saving renders and reading
frames needs no image package: ``write_png`` (8-bit gray / RGB / RGBA, no
filtering) and ``read_png`` (8-bit gray, gray + alpha, RGB, RGBA and
palette, every filter type, not interlaced)."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}     # channels -> PNG color type
# PNG color type -> (name, channels per pixel in the file)
_CHANNELS = {0: ("gray", 1), 2: ("RGB", 3), 3: ("palette", 1), 4: ("gray+alpha", 2),
             6: ("RGBA", 4)}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray):
    """Write a uint8 image [H, W], [H, W, 1], [H, W, 3] or [H, W, 4]."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 images, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"write_png takes 1, 3 or 4 channels, got {c}")
    # each row starts with its filter byte (0: none)
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", header))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def _chunks(data: bytes, path: str):
    """(kind, payload) of each chunk, CRCs checked."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file (bad signature)")
    pos = 8
    while pos + 12 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + length]
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(payload) != length or zlib.crc32(kind + payload) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: chunk {kind!r} is truncated or fails its CRC")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: no IEND chunk")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int, path: str) -> np.ndarray:
    """Undo the per-row filters of 8-bit samples: raw [h, 1 + w*bpp] (filter
    byte first) -> [h, w, bpp] uint8.

    Rows of None, Sub and Up take one vectorised step each. Average and
    Paeth predict a byte from its left, upper and upper-left neighbours, so
    with either present the image is reconstructed along anti-diagonals of
    pixels (all of one diagonal at once, each row by its own filter)."""
    ftype = raw[:, 0].astype(np.int64)
    if ftype.size and ftype.max() > 4:
        raise ValueError(f"{path}: unknown filter type {int(ftype.max())}")
    filt = raw[:, 1:].reshape(h, w, bpp).astype(np.int64)
    if not (ftype >= 3).any():
        out = np.zeros((h, w, bpp), np.int64)
        prev = np.zeros((w, bpp), np.int64)
        for r in range(h):
            row = filt[r]
            if ftype[r] == 1:
                row = np.cumsum(row, axis=0)
            elif ftype[r] == 2:
                row = row + prev
            out[r] = prev = row & 255
        return out.astype(np.uint8)
    # recon[r + 1, x + 1] holds pixel (r, x); row 0 and column 0 are zeros
    recon = np.zeros((h + 1, w + 1, bpp), np.int64)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - r
        a, b, c = recon[r + 1, x], recon[r, x + 1], recon[r, x]
        kind = ftype[r][:, None]
        pred = np.select([kind == 1, kind == 2, kind == 3, kind == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        recon[r + 1, x + 1] = (filt[r, x] + pred) & 255
    return recon[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit PNG as uint8 [H, W] (gray) or [H, W, C] (C = 2 gray +
    alpha, 3 RGB, 4 RGBA; a palette image comes back as RGB): what
    ``imageio.v2.imread`` returns for the same file. Raises ValueError,
    naming what it met, for other bit depths, interlaced files and palette
    images with transparency."""
    with open(path, "rb") as f:
        data = f.read()
    header, palette, idat, transparent = None, None, [], False
    for kind, payload in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            transparent = True
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, compression, filter_method, interlace = header
    if color not in _CHANNELS:
        raise ValueError(f"{path}: unknown PNG color type {color}")
    name, channels = _CHANNELS[color]
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit {name} PNG; read_png reads 8-bit images only")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNG; read_png reads non-interlaced "
                         "images only")
    if compression or filter_method:
        raise ValueError(f"{path}: compression method {compression}, filter method "
                         f"{filter_method}; PNG defines 0 only")
    if color == 3 and (palette is None or transparent):
        raise ValueError(f"{path}: palette PNG " + ("with transparency (tRNS)" if transparent
                                                     else "without a PLTE chunk")
                         + "; read_png reads opaque palette images only")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * channels):
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected "
                         f"{h * (1 + w * channels)} for {w}x{h} {name}")
    img = _unfilter(raw.reshape(h, 1 + w * channels), h, w, channels, path)
    if color == 3:
        if img.max(initial=0) >= len(palette):
            raise ValueError(f"{path}: palette index {int(img.max())} beyond the "
                             f"{len(palette)} entries of PLTE")
        return palette[img[..., 0]]
    return img[..., 0] if channels == 1 else img
