"""RLE8 / RLE4 BMP files (compression 1 and 2) written by hand: PIL writes
none.

``encode_rows(idx, rle4)`` codes an index image as a BMP encoder does:
runs of a repeated index (of two alternating indices, in RLE4) as
encoded runs, the rest as absolute runs, an end-of-line escape after
each row and end-of-bitmap at the end, rows bottom-up.  ``ops(...)``
writes any sequence of runs and escapes, so that a file can hold each
escape where a test wants it (delta, an odd RLE4 absolute run, a row
left short, a stream that stops early).  ``bmp(stream, w, h, ...)``
wraps a stream in the file and info headers and a palette, with
``gap`` bytes between the palette and the stream (an odd one moves the
stream to an odd file offset)."""

from __future__ import annotations

import struct

import numpy as np


def ops(items, rle4: bool) -> bytes:
    """Items: ("run", n, index[, index2]) an encoded run; ("abs",
    [indices]) an absolute run, padded to a 16-bit word of the stream;
    ("eol",), ("eob",), ("delta", right, up) escapes.  The delta escape
    is written as PIL reads it: two bytes it skips, then (right, up)."""
    out = bytearray()
    for it in items:
        kind = it[0]
        if kind == "run":
            n, a = it[1], it[2]
            b = it[3] if len(it) > 3 else a
            out += bytes([n, (a << 4 | b) if rle4 else a])
        elif kind == "abs":
            vals = list(it[1])
            out += bytes([0, len(vals)])
            if rle4:
                vals += [0] * (len(vals) % 2)
                data = bytes(vals[i] << 4 | vals[i + 1]
                             for i in range(0, len(vals), 2))
            else:
                data = bytes(vals)
            out += data + b"\0" * (len(data) % 2)
        elif kind == "eol":
            out += b"\0\0"
        elif kind == "eob":
            out += b"\0\1"
        elif kind == "delta":
            out += bytes([0, 2, 0, 0, it[1], it[2]])
        else:
            raise ValueError(kind)
    return bytes(out)


def row_items(row: np.ndarray, rle4: bool) -> list:
    """One row of indices as runs: repeats of 3 or more encoded, the
    rest in absolute runs of 3 to 254 (shorter ones encoded; in RLE4 of
    even length, since PIL misreads an odd one)."""
    items, lit = [], []
    i, w = 0, len(row)

    def flush():
        while lit:
            chunk = lit[:254]
            del lit[:254]
            tail = chunk[-1:] if rle4 and len(chunk) % 2 else []
            chunk = chunk[:len(chunk) - len(tail)]
            if len(chunk) >= 3:
                items.append(("abs", chunk))
            else:
                items.extend(("run", 1, int(v)) for v in chunk)
            items.extend(("run", 1, int(v)) for v in tail)
    while i < w:
        j = i + 1
        while j < w and j - i < 255 and row[j] == row[i]:
            j += 1
        if j - i >= 3:
            flush()
            items.append(("run", j - i, int(row[i])))
            i = j
        else:
            lit.append(int(row[i]))
            i += 1
    flush()
    return items


def encode_rows(idx: np.ndarray, rle4: bool, top_down: bool = False
                ) -> bytes:
    rows = idx if top_down else idx[::-1]
    items = []
    for r in rows:
        items += row_items(r, rle4) + [("eol",)]
    return ops(items[:-1] + [("eob",)], rle4)


def bmp(stream: bytes, w: int, h: int, palette, *, rle4: bool = False,
        bpp: int | None = None, compression: int | None = None,
        top_down: bool = False, colors_used: int = 0, gap: int = 0
        ) -> bytes:
    """The file: BITMAPFILEHEADER, BITMAPINFOHEADER, the palette (BGRX),
    ``gap`` zero bytes, then the stream."""
    bpp = bpp or (4 if rle4 else 8)
    compression = (2 if rle4 else 1) if compression is None else compression
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1,
                       bpp, compression, len(stream), 2835, 2835,
                       colors_used, 0)
    pal = b"".join(bytes([b, g, r, 0]) for r, g, b in palette)
    offset = 14 + len(info) + len(pal) + gap
    head = b"BM" + struct.pack("<IHHI", offset + len(stream), 0, 0, offset)
    return head + info + pal + b"\0" * gap + stream
