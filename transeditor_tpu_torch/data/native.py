"""ctypes binding to the port's native IO runtime, ``csrc/teio.cpp`` and
``csrc/jpeg.cpp`` (``transeditor_tpu/data/native.py``).

  * ``NativeLMDB``       - read-only LMDB access (no lmdb package);
  * ``decode_jpeg`` / ``encode_jpeg`` - the port's own JPEG codec: 8-bit
    decode to RGB of Huffman and arithmetic-coded, sequential and
    progressive frames, baseline 4:2:0 encode, each giving
    libjpeg-turbo's default pixels and bytes bit for bit; with
    ``as_pil=True`` (image files, as PIL reads them) also CMYK / YCCK
    and 8-bit lossless (SOF3);
  * ``NativeLMDBSource`` - random access to one decoded record;
  * ``NativeLMDBLoader`` - C++ worker threads producing decoded uint8
    [B, res, res, 3] batches.

The runtime is built from ``csrc/teio.cpp`` and ``csrc/jpeg.cpp`` with
g++ alone at first use into ``build/transeditor_tpu_torch/libteio-
<hash>.so`` (``ops/cuda_build.py`` names and caches it).  It links no
image library: the codec is plain integer C++.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
SRC = _CSRC / "teio.cpp"
SOURCES = (SRC, _CSRC / "jpeg.cpp")
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lpthread",)

# the codec's refusals (csrc/jpeg.cpp), by return code
CODEC_ERRORS = {
    -1: "corrupt JPEG: a malformed marker segment",
    -2: "the JPEG's size is not the one asked for",
    -3: "not a JPEG (no SOI marker)",
    -4: "truncated JPEG: the data ends before the image does",
    -5: "lossless arithmetic-coded JPEG (SOF11) is not supported (nor by "
        "libjpeg-turbo)",
    -6: "JPEG sample precision other than 8 bits (12-bit) is not supported",
    -7: "lossless JPEG (SOF3) is not read from LMDB records (the JAX "
        "binding's libjpeg-turbo 2.1 refuses it); image files decode it",
    -8: "JPEG with other than 1 or 3 components (CMYK / YCCK) is not "
        "supported here (LMDB records are RGB, as the JAX binding reads "
        "them); image files decode it",
    -9: "JPEG sampling factors other than 1 or 2 per axis are not "
        "supported",
    -10: "corrupt JPEG: no Huffman code matches the data",
    -11: "corrupt JPEG: a scan uses a missing or invalid table",
    -12: "progressive JPEG whose scans leave coefficients unrefined "
         "(libjpeg would smooth them) is not supported",
    -13: "JPEG frame larger than its data can hold (corrupt)",
    -14: "corrupt JPEG: invalid progressive scan parameters",
    -15: "JPEG without an image (no frame or no scan before EOI)",
    -16: "corrupt JPEG: coefficients run past the end of a block",
    -17: "invalid arguments to the JPEG codec",
    -18: "hierarchical JPEG (SOF5-7, SOF13-15) is not supported (nor by "
         "libjpeg-turbo)",
    -19: "corrupt arithmetic-coded JPEG data (libjpeg would warn and drop "
         "the rest of the scan)",
    -20: "lossless JPEG whose colour space needs converting (JFIF, or an "
         "Adobe transform): libjpeg-turbo converts none in lossless mode",
    -21: "lossless JPEG whose restart interval is not a whole number of "
         "MCU rows (libjpeg-turbo refuses it)",
}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path() -> Path:
    """Where the runtime for these sources is (or will be) built."""
    from transeditor_tpu_torch.ops.cuda_build import hashed_path
    return hashed_path("teio", SOURCES, [*GXX_FLAGS, *LIBS])


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the runtime, with its entry points
    typed; cached per process."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        from transeditor_tpu_torch.ops.cuda_build import build_shared
        lib = ctypes.CDLL(str(build_shared("teio", SOURCES, "g++", GXX_FLAGS,
                                           LIBS)))
        lib.teio_lmdb_open.restype = ctypes.c_void_p
        lib.teio_lmdb_open.argtypes = [ctypes.c_char_p]
        lib.teio_lmdb_close.restype = None
        lib.teio_lmdb_close.argtypes = [ctypes.c_void_p]
        lib.teio_lmdb_entries.restype = ctypes.c_long
        lib.teio_lmdb_entries.argtypes = [ctypes.c_void_p]
        lib.teio_lmdb_length.restype = ctypes.c_long
        lib.teio_lmdb_length.argtypes = [ctypes.c_void_p]
        lib.teio_lmdb_get.restype = ctypes.c_long
        lib.teio_lmdb_get.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long,
            ctypes.c_void_p, ctypes.c_long]
        for fn in (lib.teio_jpeg_decode, lib.teio_jpeg_decode_pil):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_int]
        lib.teio_jpeg_encode.restype = ctypes.c_long
        lib.teio_jpeg_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_long]
        lib.teio_loader_create.restype = ctypes.c_void_p
        lib.teio_loader_create.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint64, ctypes.c_int, ctypes.c_long, ctypes.c_long,
            ctypes.c_int]
        lib.teio_loader_next.restype = ctypes.c_int
        lib.teio_loader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.teio_loader_destroy.restype = None
        lib.teio_loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class NativeLMDB:
    """Read-only LMDB handle over the native engine."""

    def __init__(self, path: str):
        self._h = None
        self._lib = load_library()
        self._h = self._lib.teio_lmdb_open(str(path).encode())
        if not self._h:
            raise IOError(f"cannot open LMDB at {path}")

    def get(self, key: bytes) -> Optional[bytes]:
        """The value of ``key``, or None if it is absent."""
        size = self._lib.teio_lmdb_get(self._h, key, len(key), None, 0)
        if size < 0:
            return None
        buf = ctypes.create_string_buffer(size)
        self._lib.teio_lmdb_get(self._h, key, len(key), buf, size)
        return buf.raw

    @property
    def entries(self) -> int:
        return self._lib.teio_lmdb_entries(self._h)

    def __len__(self) -> int:
        """The ``length`` record (else the entry count less one)."""
        return self._lib.teio_lmdb_length(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.teio_lmdb_close(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()


def jpeg_size(data: bytes) -> tuple[int, int]:
    """(width, height) from a JPEG's start-of-frame header."""
    pos = 2
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG (no SOI marker)")
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"corrupt JPEG marker at byte {pos}")
        marker = data[pos + 1]
        if marker == 0xFF:                       # fill byte
            pos += 1
            continue
        if marker in (0x01, *range(0xD0, 0xD8)):  # no length field
            pos += 2
            continue
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            h = int.from_bytes(data[pos + 5:pos + 7], "big")
            w = int.from_bytes(data[pos + 7:pos + 9], "big")
            return w, h
        pos += 2 + length
    raise ValueError("JPEG without a start-of-frame header")


def decode_jpeg(data: bytes, width: Optional[int] = None,
                height: Optional[int] = None, *,
                as_pil: bool = False) -> np.ndarray:
    """JPEG bytes -> [H, W, 3] uint8 RGB.  ``width`` / ``height``, when
    given, must be the image's (else it raises); by default they are
    read from the header.  By default it reads what the JAX binding
    (libjpeg-turbo 2.1) reads from LMDB records: a 4-component (CMYK /
    YCCK) or lossless (SOF3) stream raises.  ``as_pil`` reads an image
    file as PIL does: those decode too, to the RGB of PIL's
    ``convert("RGB")``."""
    if width is None or height is None:
        width, height = jpeg_size(data)
    lib = load_library()
    out = np.empty((height, width, 3), np.uint8)
    fn = lib.teio_jpeg_decode_pil if as_pil else lib.teio_jpeg_decode
    rc = fn(data, len(data), out.ctypes.data_as(ctypes.c_void_p), width,
            height)
    if rc != 0:
        raise ValueError(CODEC_ERRORS.get(rc, f"jpeg decode failed ({rc})"))
    return out


def encode_jpeg(img: np.ndarray, quality: int = 90) -> bytes:
    """[H, W, 3] uint8 RGB -> baseline 4:2:0 JPEG bytes, those of
    libjpeg-turbo's ``jpeg_set_defaults`` + ``jpeg_set_quality(quality,
    TRUE)`` (quality clamped to 1..100)."""
    lib = load_library()
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected [H,W,3] uint8, got {img.shape}")
    h, w, _ = img.shape
    cap = w * h * 3 + 4096
    buf = ctypes.create_string_buffer(cap)
    n = lib.teio_jpeg_encode(img.ctypes.data_as(ctypes.c_void_p),
                             w, h, quality, buf, cap)
    if n < 0:
        raise ValueError(f"jpeg encode failed ({n}): "
                         + CODEC_ERRORS.get(n, "output larger than its "
                                                "buffer"))
    return buf.raw[:n]


class NativeLMDBSource:
    """Source-protocol adapter over the dataset layout (keys
    ``f'{res}-{idx:05d}'``)."""

    def __init__(self, path: str):
        self.db = NativeLMDB(path)
        self._len = len(self.db)

    def __len__(self):
        return self._len

    def get(self, idx: int, resolution: int) -> np.ndarray:
        data = self.db.get(f"{resolution}-{idx:05d}".encode())
        if data is None:
            raise KeyError(idx)
        return decode_jpeg(data, resolution, resolution)


class NativeLMDBLoader:
    """Endless iterator of NHWC batches, decoded and queued ahead by
    ``workers`` C++ threads (each owns a disjoint sub-shard of this
    host's index shard ``host_index::host_count``).

    The horizontal flips are drawn from
    ``np.random.RandomState(seed + 1000 + host_index)``, as the JAX
    loader's, so the same LMDB and seed give the same batches bit for
    bit.  ``as_uint8=True`` yields the raw uint8 frames (the train step
    normalises on the device); the default yields float32 in [-1, 1].
    """

    def __init__(self, path: str, batch: int, resolution: int, *,
                 prefetch: int = 4, seed: int = 0, shuffle: bool = True,
                 host_index: int = 0, host_count: int = 1,
                 flip: bool = True, workers: int = 1,
                 as_uint8: bool = False):
        self._h = None
        self._lib = load_library()
        self._h = self._lib.teio_loader_create(
            str(path).encode(), resolution, batch, prefetch, seed,
            int(shuffle), host_index, host_count, workers)
        if not self._h:
            raise IOError(f"cannot create loader for {path}")
        self.batch = batch
        self.resolution = resolution
        self.flip = flip
        self.as_uint8 = as_uint8
        self._rng = np.random.RandomState(seed + 1000 + host_index)

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        if not self._h:
            raise StopIteration
        out = np.empty((self.batch, self.resolution, self.resolution, 3),
                       np.uint8)
        rc = self._lib.teio_loader_next(
            self._h, out.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise StopIteration
        if self.flip:
            mask = self._rng.rand(self.batch) < 0.5
            out[mask] = out[mask, :, ::-1, :]
        if self.as_uint8:
            return out
        return out.astype(np.float32) / 127.5 - 1.0

    def close(self) -> None:
        """Stop and join the worker threads."""
        if self._h:
            self._lib.teio_loader_destroy(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()
