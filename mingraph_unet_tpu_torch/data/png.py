"""A PNG writer and header reader on the standard library (``zlib``,
``struct``), so that the port writes and sizes PNGs without OpenCV. A file
written here decodes, by OpenCV or the C++ loader (``csrc/decode.cc``), to
the array it was given."""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

__all__ = ["png_bytes", "write_png", "png_size"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def png_bytes(arr: np.ndarray) -> bytes:
    """A PNG of a uint8 (H, W) gray or (H, W, 3) RGB array, its rows taking
    the five filter types in turn (so that a decoder meets every one)."""
    if arr.dtype != np.uint8 or arr.ndim not in (2, 3) or (arr.ndim == 3 and arr.shape[2] != 3):
        raise ValueError(f"expected uint8 (H, W) or (H, W, 3), got {arr.dtype} {arr.shape}")
    h, w = arr.shape[:2]
    c = 1 if arr.ndim == 2 else 3
    x = arr.reshape(h, w * c).astype(np.int16)
    prev = np.zeros(w * c, np.int16)
    rows = []
    for y in range(h):
        cur, ft = x[y], y % 5
        left = np.concatenate([np.zeros(c, np.int16), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int16), prev[:-c]])
        if ft == 4:  # Paeth
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        else:
            pred = (0, left, prev, (left + prev) // 2)[ft]
        rows.append(bytes([ft]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prev = cur

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    header = struct.pack(">IIBBBBB", w, h, 8, 0 if c == 1 else 2, 0, 0, 0)
    return (_SIGNATURE + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


def write_png(path: str, arr: np.ndarray) -> str:
    """Write :func:`png_bytes` of ``arr`` to ``path``; returns ``path``."""
    with open(path, "wb") as f:
        f.write(png_bytes(np.ascontiguousarray(arr)))
    return path


def png_size(path: str) -> Tuple[int, int]:
    """(H, W) from a PNG file's header; ``ValueError`` for another file."""
    with open(path, "rb") as f:
        head = f.read(24)
    if len(head) < 24 or head[:8] != _SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"not a PNG file: {path!r}")
    w, h = struct.unpack(">II", head[16:24])
    return h, w
