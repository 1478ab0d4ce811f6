"""PNG files written by hand with numpy and zlib, in every colour type x
bit depth x interlace pair the PNG spec allows, their rows filtered with
all five filter types (PIL writes no interlaced PNG and no 2-bit gray).

``png_bytes(samples, depth, color, interlace, palette, seed)`` is the
writer; ``FORMS`` lists the (colour type, bit depth) pairs."""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
FORMS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16),
         (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def _pack_rows(s: np.ndarray, depth: int) -> np.ndarray:
    """[h, w, c] samples -> [h, rowbytes] uint8, big-endian, sub-byte
    samples packed from the high bit."""
    h = s.shape[0]
    if depth == 16:
        return s.astype(">u2").view(np.uint8).reshape(h, -1)
    flat = s.reshape(h, -1).astype(np.uint8)
    if depth == 8:
        return flat
    bits = (flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)


def _filter(rows: np.ndarray, bpp: int, rng) -> bytes:
    """Filter each row with a filter type drawn from 0-4."""
    out = []
    prev = np.zeros(rows.shape[1], np.int32)
    for row in rows.astype(np.int32):
        ft = int(rng.randint(5))
        a = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        b = prev
        if ft == 0:
            f = row
        elif ft == 1:
            f = row - a
        elif ft == 2:
            f = row - b
        elif ft == 3:
            f = row - ((a + b) >> 1)
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            f = row - np.where((pa <= pb) & (pa <= pc), a,
                               np.where(pb <= pc, b, c))
        out.append(bytes([ft]) + (f & 0xFF).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def png_bytes(samples: np.ndarray, depth: int, color: int,
              interlace: int = 0, palette: np.ndarray | None = None,
              seed: int = 0, extra: bytes = b"") -> bytes:
    """A PNG of ``samples`` ([H, W, C], C the colour type's channels);
    ``extra`` chunks go between IHDR (and PLTE) and IDAT."""
    h, w, c = samples.shape
    assert c == CHANNELS[color]
    rng = np.random.RandomState(seed)
    bpp = max(1, c * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = []
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw.append(_filter(_pack_rows(sub, depth), bpp, rng))
    out = SIGNATURE + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    out += extra
    stream = zlib.compress(b"".join(raw), 9)
    half = len(stream) // 2                     # two IDAT chunks
    return (out + chunk(b"IDAT", stream[:half]) + chunk(b"IDAT", stream[half:])
            + chunk(b"IEND", b""))


def samples_for(color: int, depth: int, h: int, w: int, seed: int,
                n_palette: int = 0) -> np.ndarray:
    """Seeded samples spanning the depth's whole range (16-bit gray also
    above 255, where PIL clamps)."""
    rng = np.random.RandomState(seed)
    top = n_palette if color == 3 else 1 << depth
    return rng.randint(0, top, (h, w, CHANNELS[color])).astype(
        np.uint16 if depth == 16 else np.uint8)
