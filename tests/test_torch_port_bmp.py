"""The port's BMP reader (``utils/image.py::load_bmp``,
``csrc/image_io.cpp``) against PIL, which the JAX package reads BMPs
through (``data/dataset.py``, ``metrics/paired.py::_load_img``).

Each file is written here byte by byte from a seeded draw: BI_RGB at 1,
4 and 8 bits (palette, 4-byte entries and the core header's 3-byte
ones), 16 (5-5-5), 24 and 32 bits; BI_BITFIELDS at 16 bits (5-6-5,
5-5-5) and 32 bits (masks after a 40-byte header, or inside a V4 / V5
header, with an alpha mask); rows bottom-up and top-down, at widths
whose rows need padding.  Every variant decodes equal to PIL's
``convert("RGB")``, pixel for pixel; an RLE stream cut short raises
naming the file, as PIL raises.
"""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from transeditor_tpu.data.dataset import ImageFolderSource as JaxFolder
from transeditor_tpu_torch.data.dataset import ImageFolderSource
from transeditor_tpu_torch.utils.image import load_bmp, load_image
from torch_port_threads import torch_worker_threads  # noqa: F401


def _pack_indices(idx: np.ndarray, bpp: int) -> bytes:
    """One row of palette indices, most significant bits first."""
    per = 8 // bpp
    out = bytearray()
    for i in range(0, len(idx), per):
        byte = 0
        for j, v in enumerate(idx[i:i + per]):
            byte |= int(v) << (8 - bpp * (j + 1))
        out.append(byte)
    return bytes(out)


def write_bmp(path, rows, width, bpp, *, compression=0, header=40,
              palette=None, masks=None, top_down=False, colors_used=0):
    """A BMP of ``rows`` (the stored bytes of each row, top row first,
    unpadded)."""
    stride = (width * bpp + 31) // 32 * 4
    stored = rows if top_down else rows[::-1]
    pixels = b"".join(r + b"\0" * (stride - len(r)) for r in stored)
    h = len(rows)
    if header == 12:
        info = struct.pack("<IHHHH", 12, width, h, 1, bpp)
    else:
        info = struct.pack("<IiiHHIIiiII", header, width,
                           -h if top_down else h, 1, bpp, compression,
                           len(pixels), 2835, 2835, colors_used, 0)
        if header >= 108:
            m = list(masks or (0, 0, 0)) + [0] * (4 - len(masks or ()))
            info += struct.pack("<4I", *m[:4]) + b"BGRs" + b"\0" * 48
            if header == 124:
                info += b"\0" * 16
    extra = b""
    if header == 40 and compression == 3:
        extra = struct.pack("<3I", *masks[:3])
    if palette is not None:
        entry = 3 if header == 12 else 4
        extra += b"".join(bytes([b, g, r, 0][:entry]) for r, g, b in palette)
    offset = 14 + len(info) + len(extra)
    head = b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset)
    path.write_bytes(head + info + extra + pixels)
    return path


def _palette_rows(rng, w, h, bpp, n_colors):
    idx = rng.randint(0, n_colors, (h, w))
    palette = [tuple(int(v) for v in rng.randint(0, 256, 3))
               for _ in range(n_colors)]
    return [_pack_indices(r, bpp) for r in idx], palette


def _values(rng, w, h, nbytes):
    vals = rng.randint(0, 256, (h, w, nbytes)).astype(np.uint8)
    return [r.tobytes() for r in vals]


# name -> (bpp, compression, header, masks, colors (palette), top_down)
VARIANTS = {
    "rgb1": (1, 0, 40, None, 2, False),
    "rgb4": (4, 0, 40, None, 16, True),
    "rgb8": (8, 0, 40, None, 256, False),
    "rgb8_used": (8, 0, 40, None, 37, True),
    "core8": (8, 0, 12, None, 256, False),
    "core24": (24, 0, 12, None, 0, False),
    "rgb16": (16, 0, 40, None, 0, False),
    "rgb24": (24, 0, 40, None, 0, True),
    "rgb24_v5": (24, 0, 124, None, 0, False),
    "rgb32": (32, 0, 40, None, 0, False),
    "bf16_565": (16, 3, 40, (0xF800, 0x07E0, 0x001F), 0, False),
    "bf16_555": (16, 3, 40, (0x7C00, 0x03E0, 0x001F), 0, True),
    "bf32": (32, 3, 40, (0xFF0000, 0xFF00, 0xFF), 0, False),
    "bf32_v4_alpha": (32, 3, 108, (0xFF0000, 0xFF00, 0xFF, 0xFF000000), 0,
                      True),
    "bf32_v5_xbgr": (32, 3, 124, (0xFF000000, 0xFF0000, 0xFF00, 0), 0,
                     False),
}


@pytest.mark.parametrize("width,height", [(7, 5), (13, 3)])
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_bmp_decodes_as_pil(tmp_path, name, width, height):
    bpp, comp, header, masks, colors, top_down = VARIANTS[name]
    rng = np.random.RandomState(zlib.crc32(f"{name}{width}".encode()))
    palette = None
    if colors:
        rows, palette = _palette_rows(rng, width, height, bpp, colors)
    else:
        rows = _values(rng, width, height, bpp // 8)
    path = write_bmp(tmp_path / f"{name}.bmp", rows, width, bpp,
                     compression=comp, header=header, palette=palette,
                     masks=masks, top_down=top_down,
                     colors_used=colors if name == "rgb8_used" else 0)
    want = np.asarray(Image.open(path).convert("RGB"))
    got = load_bmp(str(path))
    assert got.shape == (height, width, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(load_image(str(path)), want)


@pytest.mark.parametrize("bpp,comp", [(8, 1), (4, 2)])
def test_rle_raises_naming_the_file(tmp_path, bpp, comp):
    """What is still refused of RLE, where PIL refuses it too: a stream
    that ends (here after its first row of two) before the image does.
    Whole RLE streams decode (``test_torch_port_bmp_rle.py``)."""
    rows = [bytes([2, 1, 0, 0]), b""]       # one row of runs, then nothing
    path = write_bmp(tmp_path / f"rle{bpp}.bmp", rows, 2, bpp,
                     compression=comp, palette=[(9, 9, 9)] * (1 << bpp))
    with pytest.raises(ValueError, match=f"rle{bpp}.bmp.*ends before"):
        load_image(str(path))
    with pytest.raises(ValueError, match="not enough image data"):
        Image.open(path).load()


def test_truncated_bmp_raises_naming_the_file(tmp_path):
    path = write_bmp(tmp_path / "cut.bmp", _values(
        np.random.RandomState(0), 4, 4, 3), 4, 24)
    path.write_bytes(path.read_bytes()[:-5])
    with pytest.raises(ValueError, match="cut.bmp.*past the end"):
        load_bmp(str(path))


def test_folder_source_reads_bmp_as_the_jax_source(tmp_path):
    """A folder of BMP (24-bit and 8-bit palette) and PNG images, read
    and resized by both packages' folder sources."""
    rng = np.random.RandomState(3)
    write_bmp(tmp_path / "a.bmp", _values(rng, 12, 12, 3), 12, 24)
    rows, palette = _palette_rows(rng, 12, 12, 8, 256)
    write_bmp(tmp_path / "b.bmp", rows, 12, 8, palette=palette)
    Image.fromarray(rng.randint(0, 256, (12, 12, 3)).astype(np.uint8)).save(
        tmp_path / "c.png")
    port, jax_src = ImageFolderSource(str(tmp_path)), JaxFolder(str(tmp_path))
    assert len(port) == len(jax_src) == 3
    for i in range(3):
        np.testing.assert_array_equal(port.get(i, 12), jax_src.get(i, 12))
