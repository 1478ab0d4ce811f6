"""What a WebP file holds, read without libwebp: its chunks, and of a
VP8 (lossy) frame the header fields the fixtures are made to cover
(segments, filter type, level and sharpness, token partitions); of an
ALPH chunk its compression and filter.  Used by ``make_fixtures.py`` to
check that each fixture has the form it is named for."""

from __future__ import annotations

import struct


def chunks(data: bytes) -> list[tuple[bytes, int, int]]:
    """(fourcc, payload offset, payload size) of the top-level chunks,
    and of the chunks inside each ANMF frame."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        tag, size = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
        out.append((tag, pos + 8, size))
        if tag == b"ANMF":
            sub = pos + 8 + 16
            while sub + 8 <= pos + 8 + size:
                t, s = data[sub:sub + 4], struct.unpack("<I", data[sub + 4:sub + 8])[0]
                out.append((t, sub + 8, s))
                sub += 8 + s + (s & 1)
        pos += 8 + size + (size & 1)
    return out


class _Bool:
    """RFC 6386's boolean decoder, bit by bit."""

    def __init__(self, data: bytes):
        self.d, self.pos = data, 2
        self.value = (data[0] << 8) | data[1]
        self.range, self.bit_count = 255, 0

    def bit(self, prob: int) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        big = split << 8
        if self.value >= big:
            b, self.range, self.value = 1, self.range - split, self.value - big
        else:
            b, self.range = 0, split
        while self.range < 128:
            self.value <<= 1
            self.range <<= 1
            self.bit_count += 1
            if self.bit_count == 8:
                self.bit_count = 0
                self.value |= self.d[self.pos] if self.pos < len(self.d) else 0
                self.pos += 1
        return b

    def get(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return v

    def signed(self, n: int) -> int:
        v = self.get(n)
        return -v if self.get(1) else v


def vp8_header(frame: bytes) -> dict:
    """Segments, filter and partitions of a VP8 key frame."""
    br = _Bool(frame[10:])
    br.get(2)
    out = {"segments": br.get(1), "segment_data": 0}
    if out["segments"]:
        update_map, update_data = br.get(1), br.get(1)
        out["segment_data"] = update_data
        if update_data:
            br.get(1)
            for _ in range(4):
                if br.get(1):
                    br.signed(7)
            for _ in range(4):
                if br.get(1):
                    br.signed(6)
        if update_map:
            for _ in range(3):
                if br.get(1):
                    br.get(8)
    out["simple_filter"] = br.get(1)
    out["filter_level"] = br.get(6)
    out["sharpness"] = br.get(3)
    if br.get(1) and br.get(1):
        for _ in range(8):
            if br.get(1):
                br.signed(6)
    out["partitions"] = 1 << br.get(2)
    return out


def describe(data: bytes) -> dict:
    """The chunks of a WebP file; for its first VP8 frame the header
    fields, for its first VP8L bitstream the type of its first transform
    (3: colour indexing), for its first ALPH chunk the compression and
    filter."""
    cs = chunks(data)
    out = {"chunks": [c[0].decode() for c in cs]}
    for tag, off, size in cs:
        if tag == b"VP8 " and "vp8" not in out:
            out["vp8"] = vp8_header(data[off:off + size])
        if tag == b"VP8L" and "vp8l_first_transform" not in out:
            bits = data[off + 5]                 # after the 5-byte header
            out["vp8l_first_transform"] = (bits >> 1) & 3 if bits & 1 else None
        if tag == b"ALPH" and "alpha" not in out:
            out["alpha"] = {"compression": data[off] & 3,
                            "filter": (data[off] >> 2) & 3}
        if tag == b"ANMF" and "first_frame" not in out:
            h = data[off:off + 16]
            out["first_frame"] = {
                "x": 2 * int.from_bytes(h[0:3], "little"),
                "y": 2 * int.from_bytes(h[3:6], "little"),
                "w": 1 + int.from_bytes(h[6:9], "little"),
                "h": 1 + int.from_bytes(h[9:12], "little")}
        if tag == b"VP8X":
            out["canvas"] = (1 + int.from_bytes(data[off + 4:off + 7], "little"),
                             1 + int.from_bytes(data[off + 7:off + 10], "little"))
    return out
