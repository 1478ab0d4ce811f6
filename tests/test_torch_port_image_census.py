"""A census of the frame types and compressions the JAX package can meet
in an image file, each held to PIL (the JAX package reads every image
file through ``Image.open(p).convert("RGB")``) and, for JPEG, to the
JAX package's LMDB binding (libjpeg-turbo 2.1): the port either gives
the same pixels or raises where they raise.  So no form can be refused
"by design" while the JAX package reads it.

  * JPEG: a small seeded file of every start-of-frame type, SOF0-3,
    SOF5-7, SOF9-11, SOF13-15 (Huffman or arithmetic; sequential,
    progressive, lossless or hierarchical);
  * BMP: every compression value 0-6 (RGB, RLE8, RLE4, BITFIELDS, JPEG,
    PNG, ALPHABITFIELDS) at every bit depth 1, 2, 4, 8, 16, 24 and 32.
"""

import io
import struct
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from transeditor_tpu.data import native as jax_native
from transeditor_tpu_torch.data import native
from transeditor_tpu_torch.utils.image import load_image

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "image_forms"
sys.path.insert(0, str(FIXTURES))

import bmp_rle  # noqa: E402
import lossless_jpeg  # noqa: E402


def _seeded(h, w, c, seed):
    rng = np.random.RandomState(seed)
    img = np.cumsum(rng.randint(-20, 21, (h, w, c)), axis=1) + 128
    return np.clip(img, 0, 255).astype(np.uint8)


def _pil_jpeg(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=80, **kw)
    return buf.getvalue()


def _with_sof(data, marker):
    """The file with its frame marker replaced (the frame as it was)."""
    for old in (0xC0, 0xC2, 0xC3, 0xC9, 0xCA):
        pos = data.find(bytes([0xFF, old]))
        if pos >= 0:
            return data[:pos + 1] + bytes([marker]) + data[pos + 2:]
    raise ValueError("no frame")


def jpeg_of(marker):
    img = _seeded(13, 17, 3, seed=marker)
    baseline, progressive = _pil_jpeg(img), _pil_jpeg(img, progressive=True)
    lossless = lossless_jpeg.encode_image(img, 4, 0)
    sof9 = (FIXTURES / "sof9_420_17x13.jpg").read_bytes()
    sof10 = (FIXTURES / "sof10_420_17x13.jpg").read_bytes()
    return {0xC0: baseline, 0xC1: _with_sof(baseline, 0xC1),
            0xC2: progressive, 0xC3: lossless,
            0xC5: _with_sof(baseline, 0xC5),
            0xC6: _with_sof(progressive, 0xC6),
            0xC7: _with_sof(lossless, 0xC7), 0xC9: sof9, 0xCA: sof10,
            0xCB: _with_sof(lossless, 0xCB), 0xCD: _with_sof(sof9, 0xCD),
            0xCE: _with_sof(sof10, 0xCE),
            0xCF: _with_sof(lossless, 0xCF)}[marker]


def _pil(path):
    try:
        return np.asarray(Image.open(path).convert("RGB"))
    except Exception:
        return None


def _port(path):
    try:
        return load_image(str(path))
    except ValueError:
        return None


def _same(a, b):
    return (a is None and b is None) or (
        a is not None and b is not None and np.array_equal(a, b))


@pytest.mark.parametrize("marker", [0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6,
                                    0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE,
                                    0xCF], ids=lambda m: f"SOF{m - 0xC0}")
def test_every_jpeg_frame_type_as_pil_and_the_jax_binding(tmp_path, marker):
    data = jpeg_of(marker)
    assert bytes([0xFF, marker]) in data
    path = tmp_path / "x.jpg"
    path.write_bytes(data)
    want, got = _pil(path), _port(path)
    assert _same(got, want), (want is None, got is None)
    w, h = native.jpeg_size(data)
    try:
        lmdb_want = jax_native.decode_jpeg(data, w, h)
    except ValueError:
        lmdb_want = None
    try:
        lmdb_got = native.decode_jpeg(data)
    except ValueError:
        lmdb_got = None
    assert _same(lmdb_got, lmdb_want), (lmdb_want is None, lmdb_got is None)
    # what each reads: DCT Huffman and arithmetic frames everywhere,
    # lossless only from image files, hierarchical nowhere
    assert (want is not None) == (marker in (0xC0, 0xC1, 0xC2, 0xC3, 0xC9,
                                             0xCA))
    assert (lmdb_want is not None) == (marker in (0xC0, 0xC1, 0xC2, 0xC9,
                                                  0xCA))


def bmp_of(compression, bpp, seed):
    """A small seeded BMP (7x5) of that compression and bit depth."""
    rng = np.random.RandomState(seed)
    w, h = 7, 5
    colors = min(1 << bpp, 16) if bpp <= 8 else 0
    palette = [tuple(int(v) for v in rng.randint(0, 256, 3))
               for _ in range(colors)]
    if compression in (1, 2):
        idx = rng.randint(0, max(colors, 2), (h, w))
        stream = bmp_rle.encode_rows(idx, compression == 2)
        return bmp_rle.bmp(stream, w, h, palette, bpp=bpp,
                           compression=compression, colors_used=colors)
    stride = (w * bpp + 31) // 32 * 4
    pixels = rng.randint(0, 256, (h, stride)).astype(np.uint8).tobytes()
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, bpp, compression,
                       len(pixels), 2835, 2835, colors, 0)
    extra = b""
    if compression in (3, 6):
        extra = struct.pack("<3I", *((0xF800, 0x07E0, 0x001F) if bpp == 16
                                     else (0xFF0000, 0xFF00, 0xFF)))
    extra += b"".join(bytes([b, g, r, 0]) for r, g, b in palette)
    offset = 14 + len(info) + len(extra)
    return (b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset)
            + info + extra + pixels)


@pytest.mark.parametrize("bpp", [1, 2, 4, 8, 16, 24, 32])
@pytest.mark.parametrize("compression", range(7))
def test_every_bmp_compression_and_depth_as_pil(tmp_path, compression, bpp):
    path = tmp_path / "x.bmp"
    path.write_bytes(bmp_of(compression, bpp, seed=10 * compression + bpp))
    want, got = _pil(path), _port(path)
    assert _same(got, want), (want is None, got is None)
    readable = {0: (1, 4, 8, 16, 24, 32), 1: (1, 4, 8), 2: (1, 4, 8),
                3: (16, 24, 32)}
    assert (want is not None) == (bpp in readable.get(compression, ()))


@pytest.mark.parametrize("bpp,masks", [
    (16, (0xF800, 0x07E0, 0x001F)), (16, (0x7C00, 0x03E0, 0x001F)),
    (16, (0x0F00, 0x00F0, 0x000F)), (24, (0xFF0000, 0xFF00, 0xFF)),
    (24, (0xFF, 0xFF00, 0xFF0000)), (32, (0xFF0000, 0xFF00, 0xFF)),
    (32, (0xFF000000, 0xFF0000, 0xFF00)), (32, (0xFF000000, 0xFF00, 0xFF)),
    (32, (0, 0, 0)), (32, (0xFF, 0xFF00, 0xFF0000)),
    (32, (0x3FF00000, 0xFFC00, 0x3FF))])
def test_bitfields_layouts_as_pil(tmp_path, bpp, masks):
    """BI_BITFIELDS in the layouts PIL reads (all-zero masks at 32 bits
    read as BGRA), and three it refuses."""
    data = bytearray(bmp_of(3, bpp, seed=bpp))
    data[54:66] = struct.pack("<3I", *masks)
    path = tmp_path / "x.bmp"
    path.write_bytes(bytes(data))
    assert _same(_port(path), _pil(path))
