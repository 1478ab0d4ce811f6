"""Minimal LMDB writer (pure Python) for dataset preparation
(``transeditor_tpu/data/lmdb_writer.py``, copied: the port imports
nothing of the JAX package).

Builds a fresh, read-optimised LMDB file bottom-up (sorted leaves,
branch levels, twin meta pages) in liblmdb's 64-bit on-disk format.
The dataset CLI writes the reference's ``MultiResolutionDataset``
layout with it: pre-resized JPEGs keyed ``f'{resolution}-{idx:05d}'``
plus a ``length`` record.  The same items give the same bytes as the
JAX writer.

Only fresh-file writes are supported (no updates, no free list), which
is all dataset preparation needs.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterable, List, Sequence, Tuple

PSIZE = 4096
PAGEHDR = 16
P_BRANCH, P_LEAF, P_OVERFLOW, P_META = 0x01, 0x02, 0x04, 0x08
F_BIGDATA = 0x01
MAGIC = 0xBEEFC0DE
VERSION = 1
INVALID = 0xFFFFFFFFFFFFFFFF
# values whose leaf node would exceed this go to overflow pages
MAX_NODE = 1500


def _page_header(pgno: int, flags: int, lower: int, upper: int) -> bytes:
    return struct.pack("<QHHHH", pgno, 0, flags, lower, upper)


def _overflow_header(pgno: int, npages: int) -> bytes:
    return struct.pack("<QHHI", pgno, 0, P_OVERFLOW, npages)


class _PageAllocator:
    def __init__(self, first_pgno: int):
        self.pages: List[bytes] = []
        self.first = first_pgno

    def alloc(self, data: bytes) -> int:
        assert len(data) % PSIZE == 0
        pgno = self.first + sum(len(p) // PSIZE for p in self.pages)
        self.pages.append(data)
        return pgno


def write_lmdb(path: str, items: Dict[bytes, bytes]) -> None:
    """Write ``items`` to ``path`` (a directory; creates data.mdb)."""
    keys = sorted(items)
    alloc = _PageAllocator(first_pgno=2)

    # ---- overflow pages first (so leaf nodes can reference them)
    overflow_pgno: Dict[bytes, int] = {}
    n_overflow = 0
    for k in keys:
        v = items[k]
        if 8 + len(k) + len(v) > MAX_NODE:
            npages = (PAGEHDR + len(v) + PSIZE - 1) // PSIZE
            raw = bytearray(npages * PSIZE)
            raw[:PAGEHDR] = _overflow_header(0, npages)
            raw[PAGEHDR:PAGEHDR + len(v)] = v
            pgno = alloc.alloc(bytes(raw))
            raw[:PAGEHDR] = _overflow_header(pgno, npages)
            alloc.pages[-1] = bytes(raw)
            overflow_pgno[k] = pgno
            n_overflow += npages

    def leaf_node(k: bytes) -> bytes:
        v = items[k]
        if k in overflow_pgno:
            hdr = struct.pack("<HHHH", len(v) & 0xFFFF, len(v) >> 16,
                              F_BIGDATA, len(k))
            return hdr + k + struct.pack("<Q", overflow_pgno[k])
        hdr = struct.pack("<HHHH", len(v) & 0xFFFF, len(v) >> 16, 0, len(k))
        return hdr + k + v

    def build_pages(nodes: Sequence[Tuple[bytes, bytes]],
                    flags: int) -> List[Tuple[bytes, int]]:
        """Pack (first_key, node_bytes) into pages; returns
        [(first_key, pgno)] after allocation."""
        out = []
        cur: List[Tuple[bytes, bytes]] = []
        cur_size = PAGEHDR

        def flush():
            nonlocal cur, cur_size
            if not cur:
                return
            raw = bytearray(PSIZE)
            n = len(cur)
            upper = PSIZE
            ptrs = []
            for _, nb in cur:
                sz = len(nb) + (len(nb) & 1)       # 2-byte align
                upper -= sz
                raw[upper:upper + len(nb)] = nb
                ptrs.append(upper)
            lower = PAGEHDR + 2 * n
            raw[:PAGEHDR] = _page_header(0, flags, lower, upper)
            raw[PAGEHDR:lower] = struct.pack(f"<{n}H", *ptrs)
            pgno = alloc.alloc(bytes(raw))
            raw[:PAGEHDR] = _page_header(pgno, flags, lower, upper)
            alloc.pages[-1] = bytes(raw)
            out.append((cur[0][0], pgno))
            cur, cur_size = [], PAGEHDR

        for first_key, nb in nodes:
            need = 2 + len(nb) + (len(nb) & 1)
            if cur and cur_size + need > PSIZE:
                flush()
            cur.append((first_key, nb))
            cur_size += need
        flush()
        return out

    # ---- leaves
    leaf_nodes = [(k, leaf_node(k)) for k in keys]
    level = build_pages(leaf_nodes, P_LEAF)
    n_leaf = len(level)
    depth = 1

    # ---- branches
    n_branch = 0
    while len(level) > 1:
        branch_nodes = []
        for i, (first_key, pgno) in enumerate(level):
            key = b"" if i == 0 else first_key
            hdr = struct.pack("<HHHH", pgno & 0xFFFF,
                              (pgno >> 16) & 0xFFFF,
                              (pgno >> 32) & 0xFFFF, len(key))
            branch_nodes.append((first_key, hdr + key))
        level = build_pages(branch_nodes, P_BRANCH)
        n_branch += len(level)
        depth += 1

    root = level[0][1] if keys else INVALID
    last_pg = 1 + sum(len(p) // PSIZE for p in alloc.pages)

    def db_record(flags=0, depth_=0, branch=0, leaf=0, overflow=0,
                  entries=0, root_=INVALID) -> bytes:
        return struct.pack("<IHHQQQQQ", 0, flags, depth_, branch, leaf,
                           overflow, entries, root_)

    def meta_page(pgno: int, txnid: int) -> bytes:
        raw = bytearray(PSIZE)
        raw[:PAGEHDR] = _page_header(pgno, P_META, PAGEHDR, PSIZE)
        meta = struct.pack("<IIQQ", MAGIC, VERSION, 0,
                           max(len(alloc.pages) + 2, 1024) * PSIZE)
        meta += db_record()                                   # free DB
        meta += db_record(0, depth if keys else 0, n_branch, n_leaf,
                          n_overflow, len(keys), root)        # main DB
        meta += struct.pack("<QQ", last_pg, txnid)
        raw[PAGEHDR:PAGEHDR + len(meta)] = meta
        return bytes(raw)

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "data.mdb"), "wb") as f:
        f.write(meta_page(0, 0))
        f.write(meta_page(1, 1))
        for p in alloc.pages:
            f.write(p)


def write_image_dataset(path: str, jpegs: Iterable[bytes],
                        resolution: int) -> int:
    """Write the MultiResolutionDataset layout (keys
    f'{res}-{idx:05d}' + 'length')."""
    items: Dict[bytes, bytes] = {}
    n = 0
    for i, blob in enumerate(jpegs):
        items[f"{resolution}-{i:05d}".encode()] = blob
        n += 1
    items[b"length"] = str(n).encode()
    write_lmdb(path, items)
    return n
