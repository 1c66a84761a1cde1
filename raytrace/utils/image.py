"""PNG output with the reference's vertical flip.

The reference's pixel row 0 is the BOTTOM of the image and every PNG is
written flipped (ui_util.rs:46-49); we keep identical file output.

Encoding and decoding use only zlib and struct: 8-bit RGB/RGBA/grey,
non-interlaced — everything the renderer writes, and what load_png
reads back.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> PNG colour type
_CHANNELS = {v: k for k, v in _COLOR_TYPES.items()}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _encode(arr: np.ndarray) -> bytes:
    """(H, W[, C]) u8 -> PNG bytes, rows written top-first as given."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, c = arr.shape
    # filter type 0 (None) on every scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    return (_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _decode(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) u8, rows top-first."""
    if data[:8] != _SIG:
        raise ValueError("not a PNG")
    off, idat = 8, []
    w = h = c = None
    while off < len(data):
        (n,) = struct.unpack_from(">I", data, off)
        tag = data[off + 4:off + 8]
        body = data[off + 8:off + 8 + n]
        off += 12 + n
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
            if depth != 8 or interlace or ctype not in _CHANNELS:
                raise ValueError("only 8-bit non-interlaced grey/RGB/RGBA PNGs")
            c = _CHANNELS[ctype]
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * c)
    out = np.zeros((h, w * c), np.int32)
    prev = np.zeros((w * c,), np.int32)
    for y in range(h):
        f, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if f == 0:
            cur = line
        elif f == 2:
            cur = (line + prev) & 0xFF
        else:
            # Sub / Average / Paeth depend on the reconstructed left
            # neighbour: walk the row pixel by pixel
            cur = np.zeros_like(line)
            for x in range(w * c):
                a = cur[x - c] if x >= c else 0
                b = prev[x]
                d = prev[x - c] if x >= c else 0
                pred = {1: a, 3: (a + b) // 2, 4: int(_paeth(a, b, d))}[int(f)]
                cur[x] = (line[x] + pred) & 0xFF
        out[y] = cur
        prev = cur
    return out.astype(np.uint8).reshape(h, w, c)


def save_png(path: str, rgba_or_rgb: np.ndarray):
    """rgba_or_rgb: (H, W, 3|4) u8 with row 0 = bottom; flipped on save."""
    with open(path, "wb") as f:
        f.write(_encode(rgba_or_rgb[::-1]))


def encode_png(rgba_or_rgb: np.ndarray) -> bytes:
    """save_png to memory (same vertical flip); used by the live
    preview server."""
    return _encode(rgba_or_rgb[::-1])


def load_png(path: str) -> np.ndarray:
    """Inverse of save_png: returns (H, W, C) u8 with row 0 = bottom."""
    with open(path, "rb") as f:
        return _decode(f.read())[::-1]
