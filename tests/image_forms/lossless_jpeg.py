"""Lossless JPEG (SOF3, Huffman-coded) written by hand with numpy: neither
libjpeg-turbo 2.1 nor PIL writes one.

``encode(planes, factors, predictor, pt, ...)`` takes each component's
samples at its own (subsampled) size and writes one frame, in one
interleaved scan or one scan a component, with restart markers every
``restart`` MCUs.  The predictors are those of ITU T.81 H.1.2.1: the
first row of the scan (and of each restart interval) is predicted from
the left, its first sample from 2^(P - Pt - 1), the first column from
above.  Each scan's Huffman table is optimal for its categories (T.81
Annex K.2, codes at most 16 bits long)."""

from __future__ import annotations

import struct

import numpy as np


def segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def predict(s: np.ndarray, predictor: int, pt: int,
            reset_rows: set[int]) -> np.ndarray:
    """[h, w] samples (already shifted right by ``pt``) -> the
    differences, mod 2^16, with the first-row rule on row 0 and on each
    row in ``reset_rows``."""
    s = s.astype(np.int64)
    h, w = s.shape
    d = np.zeros((h, w), np.int64)
    for y in range(h):
        row = s[y]
        if y == 0 or y in reset_rows:
            p = np.concatenate([[1 << (8 - pt - 1)], row[:-1]])
        else:
            up = s[y - 1]
            ra = np.concatenate([[0], row[:-1]])
            rb, rc = up, np.concatenate([[0], up[:-1]])
            p = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
                 5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                 7: (ra + rb) >> 1}[predictor].copy()
            p[0] = up[0]
        d[y] = (row - p) & 0xFFFF
    return d


def category(d: int) -> tuple[int, int, int]:
    """(category, extra bits, their count) of a difference mod 2^16."""
    v = d - 65536 if d >= 32768 else d
    if v == 0:
        return 0, 0, 0
    if v == -32768:
        return 16, 0, 0
    n = abs(v).bit_length()
    return n, (v if v > 0 else v + (1 << n) - 1), n


def optimal_table(freq: dict[int, int]) -> tuple[list[int], list[int]]:
    """(bits[1..16], values) of an optimal length-limited code for the
    symbols in ``freq`` (jcparam's jpeg_gen_optimal_table)."""
    f = [0] * 257
    for s, n in freq.items():
        f[s] = n
    f[256] = 1                       # reserves the all-ones code
    size = [0] * 257
    others = [-1] * 257
    while True:
        c1 = c2 = -1
        v = v2 = 1 << 40
        for i in range(257):
            if f[i] and f[i] <= v:
                v, c1 = f[i], i
        for i in range(257):
            if f[i] and f[i] <= v2 and i != c1:
                v2, c2 = f[i], i
        if c2 < 0:
            break
        f[c1] += f[c2]
        f[c2] = 0
        size[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            size[c1] += 1
        others[c1] = c2
        size[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            size[c2] += 1
    bits = [0] * 33
    for i in range(257):
        if size[i]:
            bits[size[i]] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1                     # drop the reserved code
    values = [s for length in range(1, 33) for s in range(256)
              if size[s] == length]
    return bits[1:17], values


class _Writer:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, v: int, k: int):
        self.acc = (self.acc << k) | (v & ((1 << k) - 1))
        self.n += k
        while self.n >= 8:
            self.n -= 8
            b = (self.acc >> self.n) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self):
        if self.n:
            self.put(0x7F, 8 - self.n)


def encode(planes: list[np.ndarray], factors: list[tuple[int, int]],
           predictor: int = 1, pt: int = 0, *, restart: int = 0,
           interleaved: bool = True, ids: tuple[int, ...] | None = None,
           app: bytes = b"", size=None, extra_symbol16: bool = False
           ) -> bytes:
    """Planes [h_i, w_i] uint8 with sampling ``factors`` (h, v) each ->
    JPEG bytes.  ``size`` (w, h) defaults to the first plane's with
    factors at the maximum.  ``app`` is written after SOI (a JFIF or
    Adobe segment).  ``extra_symbol16`` puts category 16 in the table
    (its code is never used by 8-bit samples)."""
    nf = len(planes)
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    if size is None:
        size = (planes[0].shape[1] * hmax // factors[0][0],
                planes[0].shape[0] * vmax // factors[0][1])
    w, h = size
    ids = ids or tuple(range(1, nf + 1))
    mcux = -(-w // hmax)
    scans = [list(range(nf))] if interleaved else [[i] for i in range(nf)]
    out = bytearray(b"\xff\xd8") + app
    sof = struct.pack(">BHHB", 8, h, w, nf) + b"".join(
        bytes([ids[i], factors[i][0] << 4 | factors[i][1], 0])
        for i in range(nf))
    out += segment(0xC3, sof)
    if restart:
        out += segment(0xDD, struct.pack(">H", restart))
    for scan in scans:
        inter = len(scan) > 1
        # per component: differences (with reset rows from restarts)
        if inter:
            mcus_row = mcux
            rows_per_mcu_row = {c: factors[c][1] for c in scan}
        else:
            c = scan[0]
            mcus_row = planes[c].shape[1]
            rows_per_mcu_row = {c: 1}
        reset_every = restart // mcus_row if restart else 0
        diffs = {}
        for c in scan:
            hp = planes[c].shape[0]
            reset = set()
            if reset_every:
                step = reset_every * rows_per_mcu_row[c]
                reset = set(range(step, hp, step))
            diffs[c] = predict(planes[c] >> pt, predictor, pt, reset)
        # the MCU walk: (component, y, x) of each sample, in order
        order = []
        if inter:
            mcuy = -(-h // vmax)
            for my in range(mcuy):
                for mx in range(mcux):
                    for c in scan:
                        hc, vc = factors[c]
                        for yy in range(vc):
                            for xx in range(hc):
                                order.append((c, my * vc + yy, mx * hc + xx))
        else:
            c = scan[0]
            hp, wp = planes[c].shape
            order = [(c, y, x) for y in range(hp) for x in range(wp)]
        values = []
        for c, y, x in order:
            hp, wp = planes[c].shape
            d = int(diffs[c][y, x]) if y < hp and x < wp else 0
            values.append(category(d))
        freq: dict[int, int] = {}
        for cat, _, _ in values:
            freq[cat] = freq.get(cat, 0) + 1
        if extra_symbol16:
            freq.setdefault(16, 1)
        bits, vals = optimal_table(freq)
        codes, code, k = {}, 0, 0
        for length in range(1, 17):
            for _ in range(bits[length - 1]):
                codes[vals[k]] = (code, length)
                code += 1
                k += 1
            code <<= 1
        out += segment(0xC4, bytes([0x00]) + bytes(bits) + bytes(vals))
        out += segment(0xDA, bytes([len(scan)]) + b"".join(
            bytes([ids[c], 0x00]) for c in scan) + bytes([predictor, 0, pt]))
        wr = _Writer()
        per_mcu = sum(factors[c][0] * factors[c][1] for c in scan) \
            if inter else 1
        rst = 0
        for i, (cat, v, n) in enumerate(values):
            if restart and i and i % (restart * per_mcu) == 0:
                wr.flush()
                out += wr.out + bytes([0xFF, 0xD0 + rst])
                rst = (rst + 1) & 7
                wr = _Writer()
            code, length = codes[cat]
            wr.put(code, length)
            if n:
                wr.put(v, n)
        wr.flush()
        out += wr.out
    out += b"\xff\xd9"
    return bytes(out)


def encode_image(img: np.ndarray, predictor: int = 1, pt: int = 0,
                 **kw) -> bytes:
    """[h, w] or [h, w, c] uint8 at full resolution (no subsampling)."""
    if img.ndim == 2:
        img = img[..., None]
    planes = [np.ascontiguousarray(img[..., c]) for c in range(img.shape[2])]
    return encode(planes, [(1, 1)] * len(planes), predictor, pt, **kw)
