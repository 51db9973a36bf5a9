"""The port's PNG reader (``utils/png.py:read_png``) against imageio: files
encoded here by hand with each of the five filter types (and all of them
mixed row by row) in gray, gray + alpha, RGB, RGBA and palette, files
written by imageio and by the port's ``write_png``; the files it refuses
raise, naming what they hold."""

import struct
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest

from neuralsim_tpu_torch.utils.png import read_png, write_png

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}     # color type -> bytes per pixel


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def _filter_row(row, prev, ftype, bpp):
    """The PNG encoder's filter of one row (plain Python, byte by byte)."""
    out = bytearray()
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[ftype]
        out.append((x - pred) % 256)
    return bytes(out)


def encode(img, color, ftypes, depth=8, interlace=0, palette=None, trns=None):
    """A PNG of uint8 samples img [H, W, bpp] whose row r carries filter
    ftypes[r % len(ftypes)]."""
    h, w, bpp = img.shape
    flat = img.reshape(h, w * bpp).astype(int)
    prev = [0] * (w * bpp)
    raw = bytearray()
    for r in range(h):
        ftype = ftypes[r % len(ftypes)]
        raw.append(ftype)
        raw += _filter_row(list(flat[r]), prev, ftype, bpp)
        prev = list(flat[r])
    out = b"\x89PNG\r\n\x1a\n" + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    # two IDAT chunks: a reader must join them
    z = zlib.compress(bytes(raw), 9)
    out += _chunk(b"IDAT", z[:len(z) // 2]) + _chunk(b"IDAT", z[len(z) // 2:])
    return out + _chunk(b"IEND", b"")


def _image(color, h=9, w=7, seed=0):
    rng = np.random.RandomState(seed)
    if color == 3:
        return rng.randint(0, 6, size=(h, w, 1)).astype(np.uint8)
    return rng.randint(0, 256, size=(h, w, CHANNELS[color])).astype(np.uint8)


PALETTE = [[10, 20, 30], [200, 5, 9], [0, 255, 128], [77, 77, 77], [1, 2, 3], [250, 251, 252]]


@pytest.mark.parametrize("ftypes", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4], [4, 3, 1]],
                         ids=["none", "sub", "up", "average", "paeth", "mixed", "mixed2"])
@pytest.mark.parametrize("color", [0, 4, 2, 6, 3],
                         ids=["gray", "gray_alpha", "rgb", "rgba", "palette"])
def test_hand_encoded_filters_match_imageio(tmp_path, color, ftypes):
    img = _image(color)
    path = tmp_path / "x.png"
    path.write_bytes(encode(img, color, ftypes, palette=PALETTE if color == 3 else None))
    got, want = read_png(str(path)), imageio.imread(path)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if color != 3:
        np.testing.assert_array_equal(got.reshape(img.shape), img)


@pytest.mark.parametrize("shape", [(16, 16, 4), (5, 11, 3), (6, 4), (3, 3, 2), (1, 1, 4)],
                         ids=["rgba", "rgb", "gray", "gray_alpha", "one_pixel"])
def test_files_written_by_imageio(tmp_path, shape):
    """imageio (through pillow) chooses its own filters per row."""
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, size=shape).astype(np.uint8)
    # smooth images make the encoder pick the predicting filters
    smooth = (np.cumsum(np.cumsum(img.astype(int), 0), 1) // 7 % 256).astype(np.uint8)
    for i, a in enumerate((img, smooth)):
        path = tmp_path / f"{i}.png"
        imageio.imwrite(path, a)
        np.testing.assert_array_equal(read_png(str(path)), imageio.imread(path))
        np.testing.assert_array_equal(read_png(str(path)), a)


@pytest.mark.parametrize("shape", [(12, 10, 4), (12, 10, 3), (12, 10), (12, 10, 1)])
def test_files_written_by_write_png(tmp_path, shape):
    img = np.random.RandomState(2).randint(0, 256, size=shape).astype(np.uint8)
    path = tmp_path / "w.png"
    write_png(str(path), img)
    np.testing.assert_array_equal(read_png(str(path)), imageio.imread(path))
    np.testing.assert_array_equal(read_png(str(path)), img.reshape(12, 10, -1).squeeze(-1)
                                  if img.size == 120 else img)


def test_a_large_paeth_image(tmp_path):
    """The anti-diagonal reconstruction at the size of a LINEMOD frame row
    count, against imageio."""
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, size=(40, 64, 4)).astype(np.uint8)
    path = tmp_path / "big.png"
    path.write_bytes(encode(img, 6, [4, 4, 3, 2, 1, 0, 4]))
    np.testing.assert_array_equal(read_png(str(path)), imageio.imread(path))


@pytest.mark.parametrize("kind, match", [
    ("16bit", "16-bit RGB"),
    ("interlaced", "interlaced"),
    ("palette_trns", "palette PNG with transparency"),
    ("palette_no_plte", "without a PLTE"),
    ("bad_filter", "unknown filter type 5"),
    ("signature", "not a PNG"),
    ("crc", "CRC"),
    ("color", "unknown PNG color type 5"),
    ("subbyte_gray", "4-bit gray"),
])
def test_refused_files_raise(tmp_path, kind, match):
    img = _image(2, h=4, w=4)
    if kind == "16bit":
        data = encode(np.repeat(img, 2, axis=2), 2, [0], depth=16)
    elif kind == "interlaced":
        data = encode(img, 2, [0], interlace=1)
    elif kind == "palette_trns":
        data = encode(_image(3, 4, 4), 3, [0], palette=PALETTE, trns=b"\x00\xff")
    elif kind == "palette_no_plte":
        data = encode(_image(3, 4, 4), 3, [0])
    elif kind == "bad_filter":
        data = encode(img, 2, [0])
        raw = bytearray(zlib.decompress(_idat(data)))
        raw[0] = 5
        data = _with_idat(data, zlib.compress(bytes(raw)))
    elif kind == "signature":
        data = b"GIF89a" + encode(img, 2, [0])[6:]
    elif kind == "crc":
        data = bytearray(encode(img, 2, [0]))
        data[20] ^= 1
        data = bytes(data)
    elif kind == "color":
        data = encode(img, 5, [0])
    else:
        data = encode(_image(0, 4, 4) // 16, 0, [0], depth=4)
    path = tmp_path / "bad.png"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=match):
        read_png(str(path))


def _idat(png):
    out, pos = b"", 8
    while pos < len(png):
        n, kind = struct.unpack(">I4s", png[pos:pos + 8])
        if kind == b"IDAT":
            out += png[pos + 8:pos + 8 + n]
        pos += 12 + n
    return out


def _with_idat(png, payload):
    head, pos = png[:8], 8
    body = b""
    while pos < len(png):
        n, kind = struct.unpack(">I4s", png[pos:pos + 8])
        if kind == b"IDAT":
            if payload is not None:
                body += _chunk(b"IDAT", payload)
                payload = None
        else:
            body += png[pos:pos + 12 + n]
        pos += 12 + n
    return head + body
