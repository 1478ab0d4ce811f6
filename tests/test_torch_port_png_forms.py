"""The port's PNG reader (``utils/image.py::load_png``) in every form the
PNG spec allows, against PIL, which the JAX package reads images with,
on the CPU.

  * the committed fixtures (``tests/image_forms/png_*``: each colour
    type x bit depth x interlace pair, some with tRNS and ancillary
    chunks) decode uint8-equal to PIL's ``convert("RGB")`` and to the JAX
    ``ImageFolderSource``, at their own size and through the 256px
    resize;
  * PNGs written here by hand (``tests/image_forms/pngforms.py``) in each
    form, at sizes whose rows end mid-byte and whose Adam7 passes are
    empty, equal PIL's reading;
  * PIL's conversions: 1/2/4-bit gray scaled by 255/85/17, 16-bit gray
    clamped, other 16-bit samples their high byte, palette indices past
    PLTE black;
  * truncated and corrupted files, in a child process: refused exactly
    where PIL refuses them, PIL's pixels otherwise;
  * ``cli/edit_eval.py`` reads its frames in these forms.
"""

import hashlib
import json
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from transeditor_tpu_torch.utils.image import load_image, load_png
from torch_port_threads import torch_worker_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "image_forms"
sys.path.insert(0, str(FIXTURES))

import pngforms  # noqa: E402
from test_torch_port_webp import (  # noqa: E402
    DIGESTS, hold_fixture, sources,  # noqa: F401  (a fixture)
    test_truncations_and_corruptions_refused_as_pil_refuses as _agreement)

PNGS = sorted(n for n in DIGESTS if n.endswith(".png"))


@pytest.mark.parametrize("name", PNGS)
def test_png_fixture_equals_pil_and_the_jax_source(name, sources):
    hold_fixture(name, sources)


def test_fixtures_cover_every_form():
    forms = {(c, d, i) for c, d in pngforms.FORMS for i in (0, 1)}
    have = set()
    for name in PNGS:
        data = (FIXTURES / name).read_bytes()
        _, _, depth, color, _, _, interlace = struct.unpack(
            ">IIBBBBB", data[16:29])
        have.add((color, depth, interlace))
    assert have == forms and len(forms) == 30


@pytest.mark.parametrize("color,depth", pngforms.FORMS)
def test_png_written_here_equals_pil(tmp_path, color, depth):
    """Widths whose rows end mid-byte, heights and widths under 8 (empty
    Adam7 passes), every filter type, plain and interlaced."""
    for interlace in (0, 1):
        for h, w in ((1, 1), (1, 9), (5, 3), (8, 8), (13, 30)):
            n_pal = 1 << depth if color == 3 else 0
            s = pngforms.samples_for(color, depth, h, w, seed=h * w + depth,
                                     n_palette=n_pal)
            pal = (np.random.RandomState(depth).randint(
                0, 256, (max(1, n_pal - 1), 3)) if color == 3 else None)
            path = tmp_path / f"{interlace}_{h}x{w}.png"
            path.write_bytes(pngforms.png_bytes(s, depth, color, interlace,
                                                pal, seed=w))
            want = np.asarray(Image.open(path).convert("RGB"))
            np.testing.assert_array_equal(load_png(str(path)), want)


def test_conversions_are_pils(tmp_path):
    cases = [
        (0, 1, np.array([[[0], [1]]], np.uint8), [[0] * 3, [255] * 3]),
        (0, 2, np.array([[[0], [1], [2], [3]]], np.uint8),
         [[0] * 3, [85] * 3, [170] * 3, [255] * 3]),
        (0, 4, np.array([[[1], [15]]], np.uint8), [[17] * 3, [255] * 3]),
        (0, 16, np.array([[[100], [255], [256], [65535]]], np.uint16),
         [[100] * 3, [255] * 3, [255] * 3, [255] * 3]),
        (2, 16, np.array([[[256, 512, 65535]]], np.uint16), [[1, 2, 255]]),
        (4, 16, np.array([[[0x1234, 7]]], np.uint16), [[0x12] * 3]),
        (3, 2, np.array([[[0], [3]]], np.uint8), [[9, 8, 7], [0, 0, 0]]),
        (3, 8, np.array([[[0], [200]]], np.uint8), [[0, 0, 0], [0, 0, 0]]),
    ]
    for i, (color, depth, s, want) in enumerate(cases):
        # the last case has no PLTE, which PIL reads as all black
        pal = np.array([[9, 8, 7]]) if color == 3 and depth < 8 else None
        path = tmp_path / f"{i}.png"
        path.write_bytes(pngforms.png_bytes(s, depth, color, 0, pal))
        got = load_image(str(path))
        np.testing.assert_array_equal(got[0], np.array(want, np.uint8))
        np.testing.assert_array_equal(
            got, np.asarray(Image.open(path).convert("RGB")))


@pytest.mark.parametrize("case", ["crc", "depth", "cut", "filter"])
def test_png_refusals_name_the_file(tmp_path, case):
    """Forms outside the spec and broken files raise ``ValueError``
    naming the file; PIL refuses them too."""
    s = np.zeros((4, 4, 1), np.uint8)
    if case == "crc":
        data = bytearray(pngforms.png_bytes(s, 8, 0))
        data[29] ^= 1                              # IHDR's CRC
    elif case == "depth":                          # 16-bit palette
        data = bytearray(pngforms.png_bytes(s, 8, 3, palette=[[1, 2, 3]]))
        data[24] = 16
        data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    elif case == "cut":                            # inside the image data
        data = pngforms.png_bytes(np.arange(64, dtype=np.uint8).reshape(
            8, 8, 1), 8, 0)
        data = data[:data.index(b"IDAT") + 12]
    else:
        raw = zlib.compress(b"".join(b"\x07" + bytes(4) for _ in range(4)))
        data = (pngforms.SIGNATURE + pngforms.chunk(
            b"IHDR", struct.pack(">IIBBBBB", 4, 4, 8, 0, 0, 0, 0))
            + pngforms.chunk(b"IDAT", raw) + pngforms.chunk(b"IEND", b""))
    path = tmp_path / "x.png"
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="x.png"):
        load_png(str(path))
    with pytest.raises(Exception):
        Image.open(path).convert("RGB")


def test_png_truncations_and_corruptions_refused_as_pil_refuses(tmp_path):
    _agreement(tmp_path, "png", 16)


def test_edit_eval_reads_frames_in_any_png_form(tmp_path):
    """``cli/edit_eval.py::load_strips`` reads palette and interlaced
    16-bit frames, as PIL would."""
    from transeditor_tpu_torch.cli.edit_eval import load_strips
    d = tmp_path / "p_plus"
    d.mkdir()
    want = []
    for j, (color, depth, interlace) in enumerate([(3, 4, 0), (2, 16, 1)]):
        s = pngforms.samples_for(color, depth, 6, 6, seed=j, n_palette=16)
        pal = np.random.RandomState(j).randint(0, 256, (16, 3))
        path = d / f"origin_0_edit_{j}_x.png"
        path.write_bytes(pngforms.png_bytes(s, depth, color, interlace,
                                            pal if color == 3 else None))
        want.append(np.asarray(Image.open(path).convert("RGB")))
    got = load_strips(str(tmp_path))["p_plus"][0]
    np.testing.assert_array_equal(
        got, np.stack(want).astype(np.float32) / 127.5 - 1.0)


def test_fixture_digests_are_pils():
    """``digests.json`` (chip_smoke's 6f-1 reference) is PIL's reading
    of every committed fixture."""
    for name, want in DIGESTS.items():
        px = np.asarray(Image.open(FIXTURES / name).convert("RGB"))
        assert list(px.shape) == want["shape"], name
        assert hashlib.sha256(px.tobytes()).hexdigest() == want["sha256"]
