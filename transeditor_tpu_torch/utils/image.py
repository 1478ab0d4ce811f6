"""Image conversion helpers, and a PNG writer without PIL."""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[-1,1] float NHWC -> uint8 NHWC."""
    img = np.asarray(img, dtype=np.float32)
    return np.clip((img + 1.0) * 127.5 + 0.5, 0, 255).astype(np.uint8)


def make_grid(imgs: np.ndarray, nrow: int = 8, pad: int = 2) -> np.ndarray:
    """Tile [N,H,W,3] images in [-1, 1] into one uint8 grid image, ``nrow``
    images a row (``transeditor_tpu/utils/image.py::make_grid``)."""
    x = np.clip((np.asarray(imgs, np.float32) + 1.0) / 2.0, 0, 1)
    n, h, w, c = x.shape
    rows = math.ceil(n / nrow)
    grid = np.ones((rows * (h + pad) + pad, nrow * (w + pad) + pad, c),
                   np.float32)
    for i in range(n):
        r, col = divmod(i, nrow)
        y0, x0 = pad + r * (h + pad), pad + col * (w + pad)
        grid[y0:y0 + h, x0:x0 + w] = x[i]
    return (grid * 255 + 0.5).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def save_png(path: str, img_uint8: np.ndarray) -> None:
    """Write an [H, W, 3] uint8 image as an 8-bit RGB PNG with the
    standard library alone (zlib)."""
    img = np.ascontiguousarray(img_uint8, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"need an [H, W, 3] image, got {img.shape}")
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),    # filter 0
                           img.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2,
                                            0, 0, 0)))     # 2: RGB
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))
