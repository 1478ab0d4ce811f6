"""Image conversion helpers, and image reading, writing and resizing
without PIL: PNG through zlib, JPEG through the port's own codec
(``data/native.py``), and PIL's LANCZOS and BILINEAR resizes.  PNG
unfiltering and the resize's passes run in ``csrc/image_io.cpp``, built
with g++ at first use."""

from __future__ import annotations

import ctypes
import functools
import math
import struct
import threading
import zlib
from typing import Optional

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # gray, RGB, gray+alpha, RGBA
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[-1,1] float NHWC -> uint8 NHWC."""
    img = np.asarray(img, dtype=np.float32)
    return np.clip((img + 1.0) * 127.5 + 0.5, 0, 255).astype(np.uint8)


def make_grid(imgs: np.ndarray, nrow: int = 8, pad: int = 2,
              normalize_range=(-1.0, 1.0)) -> np.ndarray:
    """Tile [N,H,W,3] images into one uint8 grid image, ``nrow`` images a
    row, ``normalize_range`` mapped to [0, 1]
    (``transeditor_tpu/utils/image.py::make_grid``)."""
    lo, hi = normalize_range
    x = np.clip((np.asarray(imgs, np.float32) - lo) / (hi - lo), 0, 1)
    n, h, w, c = x.shape
    rows = math.ceil(n / nrow)
    grid = np.ones((rows * (h + pad) + pad, nrow * (w + pad) + pad, c),
                   np.float32)
    for i in range(n):
        r, col = divmod(i, nrow)
        y0, x0 = pad + r * (h + pad), pad + col * (w + pad)
        grid[y0:y0 + h, x0:x0 + w] = x[i]
    return (grid * 255 + 0.5).astype(np.uint8)


def colorize_heatmap(x: np.ndarray, upscale: int = 16) -> np.ndarray:
    """[H,W] scores -> uint8 RGB heatmap on a three-anchor colormap (dark
    blue -> green -> yellow), each cell ``upscale`` pixels square (the
    attention similarity plots, as the JAX package draws them)."""
    x = np.asarray(x, np.float32)
    x = (x - x.min()) / max(x.max() - x.min(), 1e-12)
    anchors = np.asarray([[68, 1, 84], [33, 145, 140], [253, 231, 37]],
                         np.float32)
    t = x * 2.0
    lo = np.clip(np.floor(t).astype(int), 0, 1)
    frac = (t - lo)[..., None]
    rgb = anchors[lo] * (1 - frac) + anchors[lo + 1] * frac
    img = rgb.astype(np.uint8)
    if upscale > 1:
        img = np.repeat(np.repeat(img, upscale, 0), upscale, 1)
    return img


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _filter_rows(rows: np.ndarray, bpp: int) -> np.ndarray:
    """PNG-filter [H, N] uint8 rows (N = width * ``bpp``) as libpng's
    adaptive heuristic does: each row takes the filter (None, Sub, Up,
    Average, Paeth) whose bytes, read as signed, have the least absolute
    sum.  Returns [H, 1 + N], each row led by its filter type."""
    x = rows.astype(np.int16)
    a = np.zeros_like(x)                   # left
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)                   # up
    b[1:] = x[:-1]
    c = np.zeros_like(x)                   # up-left
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    cand = np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - paeth]) & 0xFF
    choice = np.minimum(cand, 256 - cand).sum(axis=-1).argmin(axis=0)
    out = cand[choice, np.arange(x.shape[0])]
    return np.concatenate([choice[:, None], out], axis=1).astype(np.uint8)


def save_png(path: str, img_uint8: np.ndarray) -> None:
    """Write an [H, W, 3] uint8 image as an 8-bit RGB PNG with the
    standard library alone (zlib), its rows filtered as libpng and PIL
    filter them."""
    img = np.ascontiguousarray(img_uint8, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"need an [H, W, 3] image, got {img.shape}")
    h, w, _ = img.shape
    rows = _filter_rows(img.reshape(h, w * 3), 3)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2,
                                            0, 0, 0)))     # 2: RGB
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def _native() -> ctypes.CDLL:
    """``csrc/image_io.cpp``, built with g++ at first use into
    ``build/transeditor_tpu_torch/`` (``ops/cuda_build.py``); its entry
    points typed; cached per process.  A failed build raises."""
    global _lib
    with _lock:
        if _lib is None:
            from transeditor_tpu_torch.ops.cuda_build import (CSRC,
                                                              build_shared)
            lib = ctypes.CDLL(str(build_shared(
                "image_io", CSRC / "image_io.cpp", "g++", GXX_FLAGS)))
            lib.teimg_png_unfilter.restype = ctypes.c_long
            lib.teimg_png_unfilter.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
                ctypes.c_long, ctypes.c_void_p]
            lib.teimg_resample.restype = None
            lib.teimg_resample.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, *[ctypes.c_long] * 4,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
            for name in ("teimg_bmp_info", "teimg_bmp_decode"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_long
                fn.argtypes = [ctypes.c_char_p, ctypes.c_long,
                               ctypes.c_void_p]
            _lib = lib
        return _lib


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def _unfilter(rows: np.ndarray, w: int, c: int) -> np.ndarray:
    """Undo PNG row filtering: [H, 1 + W*C] stored rows -> [H, W, C]."""
    h = rows.shape[0]
    if not rows[:, 0].any():                       # filter 0 throughout
        return rows[:, 1:].reshape(h, w, c)
    rows = np.ascontiguousarray(rows)
    out = np.empty((h, w, c), np.uint8)
    bad = _native().teimg_png_unfilter(_ptr(rows), h, w * c, c, _ptr(out))
    if bad:
        raise ValueError(f"PNG filter type {int(rows[bad - 1, 0])} is not "
                         f"0-4 (row {bad - 1})")
    return out


def load_png(path: str) -> np.ndarray:
    """Read an 8-bit, non-interlaced gray, gray+alpha, RGB or RGBA PNG
    as [H, W, 3] uint8 RGB (gray replicated, alpha dropped, as PIL's
    ``convert("RGB")``).  Anything else (palette, 16-bit, interlaced)
    raises ``ValueError``."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _PNG_CHANNELS or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced gray / RGB / "
                         f"RGBA PNGs are read (bit depth {depth}, color "
                         f"type {color}, interlace {interlace})")
    c = _PNG_CHANNELS[color]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if rows.size != h * (1 + w * c):
        raise ValueError(f"{path}: {rows.size} pixel bytes for {w}x{h}x{c}")
    img = _unfilter(rows.reshape(h, 1 + w * c), w, c)
    if c <= 2:
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


# teimg_bmp_* error codes (csrc/image_io.cpp, BmpError)
_BMP_ERRORS = {
    1: "not a BMP, or its header is cut short",
    2: "a BMP info header of a size this reader does not know",
    3: "compressed BMP (compression {3}: RLE or another) is not read; "
       "only BI_RGB and BI_BITFIELDS",
    4: "BMP of {2} bits a pixel at compression {3} is not read",
    5: "BMP pixel rows or palette run past the end of the file",
    6: "BMP of {0}x{1} pixels",
}


def load_bmp(path: str) -> np.ndarray:
    """Read an uncompressed BMP as [H, W, 3] uint8 RGB (as PIL's
    ``convert("RGB")``): BI_RGB at 1, 4 and 8 bits (palette), 16 (5-5-5),
    24 and 32 bits, and BI_BITFIELDS at 16 and 32 bits, stored
    bottom-up or top-down (``csrc/image_io.cpp``).  RLE or any other
    compression raises ``ValueError`` naming the file."""
    with open(path, "rb") as f:
        data = f.read()
    info = np.zeros(4, np.int64)
    rc = _native().teimg_bmp_info(data, len(data), _ptr(info))
    if rc:
        raise ValueError(f"{path}: " + _BMP_ERRORS.get(
            rc, "unreadable BMP").format(*info.tolist()))
    w, h = int(info[0]), int(info[1])
    out = np.empty((h, w, 3), np.uint8)
    rc = _native().teimg_bmp_decode(data, len(data), _ptr(out))
    if rc:
        raise ValueError(f"{path}: " + _BMP_ERRORS.get(
            rc, "unreadable BMP").format(*info.tolist()))
    return out


def load_image(path: str) -> np.ndarray:
    """A PNG, JPEG or BMP file as [H, W, 3] uint8 RGB, by its leading
    bytes.  JPEG goes through the port's own codec (``data/native.py``:
    baseline and progressive, libjpeg's pixels); any other format raises
    ``ValueError`` naming the file."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head == PNG_SIGNATURE:
        return load_png(path)
    if head[:2] == b"\xff\xd8":
        from transeditor_tpu_torch.data.native import decode_jpeg
        with open(path, "rb") as f:
            return decode_jpeg(f.read())
    if head[:2] == b"BM":
        return load_bmp(path)
    raise ValueError(f"{path}: only PNG and JPEG images and uncompressed "
                     f"BMPs are read")


# PIL's fixed-point resampling (Pillow's Resample.c, 8 bits a channel)
_PRECISION_BITS = 32 - 8 - 2


def _lanczos(x: float) -> float:
    if not -3.0 <= x < 3.0:
        return 0.0

    def sinc(v):
        if v == 0.0:
            return 1.0
        v *= math.pi
        return math.sin(v) / v
    return sinc(x) * sinc(x / 3.0)


def _triangle(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


# PIL's filters by name: (kernel, support at scale 1)
_FILTERS = {"lanczos": (_lanczos, 3.0), "bilinear": (_triangle, 1.0)}


@functools.lru_cache(maxsize=16)
def _coeffs(in_size: int, out_size: int, filt: str):
    """Per output pixel: its first input pixel and how many it reads
    ([out, 2] int32), and their fixed-point weights ([out, K] int32, 0
    past each pixel's support), for PIL's filter ``filt``."""
    kernel, base_support = _FILTERS[filt]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = base_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    bounds = np.zeros((out_size, 2), np.int32)
    wts = np.zeros((out_size, ksize), np.int32)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [kernel((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        total = sum(k)
        for x, v in enumerate(k):
            v = v / total if total != 0.0 else v
            v *= 1 << _PRECISION_BITS
            wts[xx, x] = int(v - 0.5) if v < 0 else int(v + 0.5)
        bounds[xx] = xmin, xmax
    bounds.flags.writeable = wts.flags.writeable = False
    return bounds, wts


def _resample_axis(img: np.ndarray, out_size: int, axis: int,
                   filt: str) -> np.ndarray:
    """One pass (axis 0: vertical, 1: horizontal) of [H, W, C] uint8."""
    bounds, wts = _coeffs(img.shape[axis], out_size, filt)
    img = np.ascontiguousarray(img)
    h, w, c = img.shape
    outer, n_in, inner = (h, w, c) if axis == 1 else (1, h, w * c)
    shape = (h, out_size, c) if axis == 1 else (out_size, w, c)
    out = np.empty(shape, np.uint8)
    _native().teimg_resample(_ptr(img), _ptr(out), outer, n_in, out_size,
                             inner, _ptr(bounds), _ptr(wts), wts.shape[1])
    return out


def _resize(img: np.ndarray, width: int, height: int, filt: str
            ) -> np.ndarray:
    img = np.asarray(img, np.uint8)
    if img.shape[1] != width:
        img = _resample_axis(img, width, 1, filt)
    if img.shape[0] != height:
        img = _resample_axis(img, height, 0, filt)
    return img


def resize_lanczos(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """[H, W, C] uint8 -> [height, width, C] uint8 as PIL's
    ``Image.resize((width, height), Image.LANCZOS)``: separable Lanczos
    (a = 3) whose support grows with the downscale factor, weights
    normalised per output pixel and rounded to 22-bit fixed point, the
    horizontal pass first, rounded to 8 bits, then the vertical one.
    An axis whose size does not change is not resampled."""
    return _resize(img, width, height, "lanczos")


def resize_bilinear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """[H, W, C] uint8 -> [height, width, C] uint8 as PIL's
    ``Image.resize((width, height), Image.BILINEAR)``: the same passes as
    ``resize_lanczos`` with a triangle filter of support 1, widened by
    the downscale factor."""
    return _resize(img, width, height, "bilinear")
