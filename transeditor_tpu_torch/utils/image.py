"""Image conversion helpers, and image reading, writing and resizing
without PIL or any image library: PNG through zlib, JPEG through the
port's own codec (``data/native.py``), WebP through ``csrc/webp.cpp``,
BMP, and PIL's LANCZOS and BILINEAR resizes.  Every reader gives what
PIL's ``convert("RGB")`` gives.  PNG unfiltering, BMP and WebP decoding
and the resize's passes run in ``csrc/image_io.cpp`` and
``csrc/webp.cpp``, built with g++ at first use."""

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
                "image_io", (CSRC / "image_io.cpp", CSRC / "webp.cpp"),
                "g++", GXX_FLAGS)))
            lib.teimg_png_unfilter.restype = ctypes.c_long
            lib.teimg_png_unfilter.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
                ctypes.c_long, ctypes.c_void_p]
            lib.teimg_resample.restype = None
            lib.teimg_resample.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, *[ctypes.c_long] * 4,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
            for name in ("teimg_bmp_info", "teimg_bmp_decode",
                         "teimg_webp_info", "teimg_webp_decode"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_long
                fn.argtypes = [ctypes.c_char_p, ctypes.c_long,
                               ctypes.c_void_p]
            _lib = lib
        return _lib


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def _unfilter(rows: np.ndarray, n: int, bpp: int) -> np.ndarray:
    """Undo PNG row filtering: [H, 1 + N] stored rows -> [H, N] bytes,
    each filter reading the byte ``bpp`` to the left (whole bytes, also
    for samples under 8 bits)."""
    h = rows.shape[0]
    if not rows[:, 0].any():                       # filter 0 throughout
        return rows[:, 1:]
    rows = np.ascontiguousarray(rows)
    out = np.empty((h, n), np.uint8)
    bad = _native().teimg_png_unfilter(_ptr(rows), h, n, bpp, _ptr(out))
    if bad:
        raise ValueError(f"PNG filter type {int(rows[bad - 1, 0])} is not "
                         f"0-4 (row {bad - 1})")
    return out


# the bit depths each colour type allows (PNG spec, table 11.1)
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7 passes: first column, first row, column step, row step
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_samples(raw: memoryview, w: int, h: int, depth: int,
                 c: int) -> tuple[np.ndarray, int]:
    """The [h, w, c] samples (uint8, or uint16 at depth 16) of one
    image or Adam7 pass at the start of ``raw``, and the bytes read."""
    rowbytes = (w * c * depth + 7) // 8
    size = h * (1 + rowbytes)
    rows = np.frombuffer(raw[:size], np.uint8).reshape(h, 1 + rowbytes)
    un = _unfilter(rows, rowbytes, max(1, c * depth // 8))
    if depth == 16:
        return un.view(">u2").reshape(h, w, c).astype(np.uint16), size
    if depth < 8:
        bits = np.unpackbits(un, axis=1).reshape(h, -1, depth)
        un = (bits << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(
            axis=2, dtype=np.uint8)[:, :w]
    return un.reshape(h, w, c), size


def _png_rgb(s: np.ndarray, depth: int, color: int,
             palette: Optional[np.ndarray]) -> np.ndarray:
    """[H, W, C] samples -> [H, W, 3] uint8 as PIL's ``convert("RGB")``
    gives them: gray at 1, 2 and 4 bits scaled by 255, 85 and 17, 16-bit
    gray clamped to 255 (mode ``I;16``), other 16-bit samples their high
    byte, palette indices past ``PLTE`` black, alpha and ``tRNS``
    dropped."""
    if color == 3:
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette
        return lut[s[..., 0]]
    if depth == 16:
        s = np.minimum(s, 255) if color == 0 else s >> 8
    elif depth < 8:
        s = s * {1: 255, 2: 85, 4: 17}[depth]
    s = s.astype(np.uint8)
    if color in (0, 4):
        return np.repeat(s[..., :1], 3, axis=-1)
    return np.ascontiguousarray(s[..., :3])


def load_png(path: str) -> np.ndarray:
    """Read a PNG as [H, W, 3] uint8 RGB, as PIL's ``convert("RGB")``
    does: every colour type at every bit depth the format allows (gray
    1-16, RGB 8 / 16, palette 1-8, gray+alpha and RGBA 8 / 16), plain or
    Adam7-interlaced (``_png_rgb`` says how each becomes RGB).  Ancillary
    chunks are ignored; the CRCs of the chunks before the image data are
    checked, as PIL checks them.  A file PIL refuses (truncated, corrupt,
    a form outside the spec) raises ``ValueError`` naming the file."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return _decode_png(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def _is_chunk_name(kind: bytes) -> bool:
    return len(kind) == 4 and all(
        c == 95 or 48 <= c <= 57 or 65 <= c <= 90 or 97 <= c <= 122
        for c in kind)


def _decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, 3] uint8, refusing what PIL refuses: chunks
    before the image data are read whole and their CRCs checked; the
    image data are the run of IDAT chunks that follows (the last one may
    be cut short), and need only hold the image; after it, a chunk that
    names itself must be whole, up to IEND."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG")
    pos, header, palette = 8, None, None
    while True:
        if pos + 8 > len(data):
            raise ValueError("truncated PNG: no image data")
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if not _is_chunk_name(kind):
            raise ValueError(f"broken PNG file (chunk {kind!r})")
        if kind == b"IDAT":
            break
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise ValueError(f"truncated {kind!r} chunk")
        if crc != struct.pack(">I", zlib.crc32(kind + body)):
            raise ValueError(f"bad CRC in the {kind!r} chunk")
        if kind == b"IHDR":
            if n < 13:
                raise ValueError("truncated IHDR chunk")
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            if n % 3 or not 0 < n <= 768:
                raise ValueError(f"PLTE of {n} bytes")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IEND":
            raise ValueError("PNG without image data")
        pos += 12 + n
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, filt, interlace = header
    # as PIL: the compression byte is not looked at, any interlace byte
    # but 0 means Adam7
    if color not in _PNG_DEPTHS or depth not in _PNG_DEPTHS[color] or filt:
        raise ValueError(f"a PNG form outside the spec (bit depth {depth}, "
                         f"colour type {color}, filter method {filt})")
    if color == 3 and palette is None:     # PIL reads it all black
        palette = np.zeros((0, 3), np.uint8)
    if not 0 < w < 2 ** 31 or not 0 < h < 2 ** 31:
        raise ValueError(f"PNG of {w}x{h} pixels")
    c = _PNG_CHANNELS[color]
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    dims = [((w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy)
            for x0, y0, dx, dy in passes]
    need = sum(ph * (1 + (pw * c * depth + 7) // 8)
               for pw, ph in dims if pw and ph)
    idat = []                         # (body, offset after its CRC)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind != b"IDAT":
            break
        idat.append((data[pos + 8:pos + 8 + n], pos + 12 + n))
        pos += 12 + n
    # zlib expands at most ~1032:1, so a header that claims more than the
    # data could hold is corrupt: refused before anything is allocated
    if need > 1100 * sum(len(b) for b, _ in idat) + 64:
        raise ValueError(f"{w}x{h} pixels need {need} bytes, more than "
                         f"the image data can hold")
    inflate, raw = zlib.decompressobj(), b""
    try:
        for body, after in idat:
            raw += inflate.decompress(body, need - len(raw))
            if len(raw) >= need:
                break
    except zlib.error as e:
        raise ValueError(f"corrupt PNG image data ({e})") from None
    if len(raw) < need:
        raise ValueError("truncated PNG: the image data end before the "
                         "image does")
    pos = after
    while pos + 8 <= len(data):       # PIL's load_end
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if not _is_chunk_name(kind) or kind == b"IEND":
            break
        if pos + 8 + n > len(data):
            raise ValueError(f"truncated {kind!r} chunk")
        pos += 12 + n
    raw = memoryview(raw)
    if interlace:
        img = np.zeros((h, w, c), np.uint16 if depth == 16 else np.uint8)
        for (x0, y0, dx, dy), (pw, ph) in zip(passes, dims):
            if pw and ph:
                s, used = _png_samples(raw, pw, ph, depth, c)
                img[y0::dy, x0::dx] = s
                raw = raw[used:]
    else:
        img, _ = _png_samples(raw, w, h, depth, c)
    return _png_rgb(img, depth, color, palette)


# teimg_bmp_* error codes (csrc/image_io.cpp, BmpError)
_BMP_ERRORS = {
    1: "not a BMP, or its header is cut short",
    2: "a BMP info header of a size this reader does not know",
    3: "BMP compression {3} (JPEG, PNG or another) is not read, as PIL "
       "reads none",
    4: "BMP of {2} bits a pixel at compression {3} is not read",
    5: "BMP pixel rows run past the end of the file",
    6: "BMP of {0}x{1} pixels",
    7: "RLE BMP whose stream ends before the image does (PIL: not enough "
       "image data)",
    8: "RLE BMP with a black-and-white palette (PIL: unknown raw mode for "
       "mode 1)",
    9: "RLE BMP whose delta escape is cut short",
    10: "BMP palette of more than 256 colours",
    11: "a BMP bitfields layout PIL does not read",
}


def decode_bmp(data: bytes) -> np.ndarray:
    """BMP bytes -> [H, W, 3] uint8 RGB, as PIL's ``convert("RGB")``
    gives them: BI_RGB at 1, 4 and 8 bits (palette), 16 (5-5-5), 24 and
    32 bits, BI_BITFIELDS at 16, 24 and 32 bits in the layouts PIL
    reads, and RLE8 / RLE4 at 1, 4 and 8 bits as PIL's
    ``BmpRleDecoder`` decodes them, quirks included
    (``csrc/image_io.cpp``), stored bottom-up or top-down.  What PIL
    refuses (another compression, an RLE stream that ends early, ...)
    raises ``ValueError``."""
    info = np.zeros(4, np.int64)
    rc = _native().teimg_bmp_info(data, len(data), _ptr(info))
    if rc == 0:
        out = np.empty((int(info[1]), int(info[0]), 3), np.uint8)
        rc = _native().teimg_bmp_decode(data, len(data), _ptr(out))
    if rc:
        raise ValueError(_BMP_ERRORS.get(rc, "unreadable BMP").format(
            *info.tolist()))
    return out


def load_bmp(path: str) -> np.ndarray:
    """Read a BMP file as ``decode_bmp`` decodes it; ``ValueError``
    names the file."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode_bmp(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


# teimg_webp_* error codes (csrc/webp.cpp)
_WEBP_ERRORS = {
    -1: "not a WebP file, or a chunk layout libwebp rejects",
    -2: "truncated WebP: the file ends before its RIFF size says",
    -3: "corrupt or truncated VP8 (lossy) bitstream",
    -4: "corrupt or truncated VP8L (lossless) bitstream",
    -5: "corrupt ALPH (alpha) chunk",
    -6: "WebP larger than PIL opens, or than its data can hold",
    -7: "WebP without a frame",
}


def decode_webp(data: bytes) -> np.ndarray:
    """WebP bytes -> [H, W, 3] uint8 RGB, as PIL's ``convert("RGB")``
    gives them (``csrc/webp.cpp``): lossy (VP8) with libwebp's fancy
    upsampling and YUV->RGB, lossless (VP8L), either with an alpha
    channel (dropped), and of an animation its first frame on a black
    canvas.  What libwebp refuses raises ``ValueError``."""
    info = np.zeros(2, np.int64)
    rc = _native().teimg_webp_info(data, len(data), _ptr(info))
    if rc == 0:
        w, h = int(info[0]), int(info[1])
        out = np.empty((h, w, 3), np.uint8)
        rc = _native().teimg_webp_decode(data, len(data), _ptr(out))
    if rc:
        raise ValueError(_WEBP_ERRORS.get(rc, f"unreadable WebP ({rc})"))
    return out


def load_webp(path: str) -> np.ndarray:
    """Read a WebP file as ``decode_webp`` decodes it; ``ValueError``
    names the file."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode_webp(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def load_image(path: str) -> np.ndarray:
    """A PNG, JPEG, WebP or BMP file as [H, W, 3] uint8 RGB, by its
    leading bytes, as PIL's ``convert("RGB")`` gives it.  JPEG goes
    through the port's own codec (``data/native.py``: Huffman and
    arithmetic-coded, baseline, extended and progressive, and 8-bit
    lossless; gray, YCbCr, RGB, CMYK and YCCK; libjpeg's pixels); BMP
    uncompressed, bitfields or RLE8 / RLE4; any other format, or a file
    PIL would refuse, raises ``ValueError`` naming the file."""
    with open(path, "rb") as f:
        head = f.read(12)
    if head[:8] == PNG_SIGNATURE:
        return load_png(path)
    if head[:2] == b"\xff\xd8":
        from transeditor_tpu_torch.data.native import decode_jpeg
        with open(path, "rb") as f:
            data = f.read()
        try:
            return decode_jpeg(data, as_pil=True)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return load_webp(path)
    if head[:2] == b"BM":
        return load_bmp(path)
    raise ValueError(f"{path}: only PNG and JPEG images, WebP and BMP "
                     f"are read")


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
