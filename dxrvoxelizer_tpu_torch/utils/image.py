"""Image / grid sinks: PNG screenshots and .npy voxel-grid export.

The reference's F11 screenshot path reads back the framebuffer and encodes a
timestamped PNG with stb_image_write (reference: DXRVoxelizer.cpp:531-551,
Common/stb_image_write.h). Here: the native C++ encoder (utils/native.py,
``_native/pngwrite.cpp``) for file writes when it builds, a dependency-free
Python encoder otherwise and for in-memory PNGs (zlib is in the stdlib), and
``.npy`` export of voxel grids (``-savegrid``).
"""

from __future__ import annotations

import struct
import time
import zlib
from pathlib import Path

import numpy as np


def to_u8(img: np.ndarray) -> np.ndarray:
    """Float [0,1] -> uint8 with round-half-away like D3D UNORM stores."""
    return np.clip(np.asarray(img) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def _normalize_u8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = to_u8(img)
    if img.ndim == 2:
        img = img[:, :, None].repeat(3, axis=2)
    assert img.shape[2] in (1, 3, 4)
    return img


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """Encode an [H,W,{1,3,4}] uint8/float image to PNG bytes (in memory).

    Pure Python (stdlib zlib). ``level``: zlib effort.
    """
    img = _normalize_u8(img)
    h, w, ch = img.shape
    color_type = {1: 0, 3: 2, 4: 6}[ch]

    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, level))
        + chunk(b"IEND", b"")
    )


def write_png(path: str | Path, img: np.ndarray) -> Path:
    """Write an [H,W,3] or [H,W,4] uint8/float image as PNG: the native
    encoder when it builds, else :func:`encode_png`."""
    from dxrvoxelizer_tpu_torch.utils.native import write_png_native

    path = Path(path)
    img = _normalize_u8(img)
    if not write_png_native(path, img):
        path.write_bytes(encode_png(img))
    return path


def read_png(path: str | Path) -> np.ndarray:
    """Minimal PNG reader for round-trip tests (8-bit, no interlace)."""
    data = Path(path).read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos = 8
    idat = b""
    w = h = ch = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, color_type, *_ = struct.unpack(">IIBBBBB", body)
            assert depth == 8
            ch = {0: 1, 2: 3, 6: 4}[color_type]
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * ch
    out = np.zeros((h, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    for y in range(h):
        f = raw[y * (stride + 1)]
        line = np.frombuffer(raw[y * (stride + 1) + 1 : (y + 1) * (stride + 1)], np.uint8)
        line = line.copy()
        if f == 0:
            pass
        elif f == 1:  # sub
            for x in range(ch, stride):
                line[x] = (int(line[x]) + int(line[x - ch])) & 0xFF
        elif f == 2:  # up
            line = (line.astype(np.int32) + prev.astype(np.int32)).astype(np.uint8)
        elif f == 3:  # average
            for x in range(stride):
                a = int(line[x - ch]) if x >= ch else 0
                line[x] = (int(line[x]) + (a + int(prev[x])) // 2) & 0xFF
        elif f == 4:  # paeth
            for x in range(stride):
                a = int(line[x - ch]) if x >= ch else 0
                b = int(prev[x])
                c = int(prev[x - ch]) if x >= ch else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pr = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                line[x] = (int(line[x]) + pr) & 0xFF
        out[y] = line
        prev = line
    return out.reshape(h, w, ch)


def screenshot_name(prefix: str = "dxrvoxelizer_tpu_torch") -> str:
    """Timestamped capture name (reference: DXRVoxelizer.cpp:537-546)."""
    return time.strftime(f"{prefix}_%Y%m%d_%H%M%S.png")


def save_grid_npy(path: str | Path, occupancy: np.ndarray) -> Path:
    """Write a voxel grid (an occupancy array, or packed words) as .npy."""
    path = Path(path)
    np.save(path, np.asarray(occupancy))
    return path
