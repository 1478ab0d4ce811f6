"""The port's 8-bit lossless JPEG decode (SOF3, ``csrc/jpeg.cpp``)
against PIL, on the CPU.

PIL 12.1 reads SOF3 through its bundled libjpeg-turbo 3.1: the stored
samples, the point transform's left shift applied, no colour conversion
(libjpeg-turbo refuses a lossless frame that would need one: a JFIF
marker, or an Adobe transform), subsampled components replicated.  The
JAX package reads every image file through PIL, so its folder readers
take such files; its LMDB binding (libjpeg-turbo 2.1) refuses them.
Here:

  * every committed SOF3 fixture (``tests/image_forms/sof3_*.jpg``:
    predictors 1-7, point transforms 0 and 2, gray, RGB and CMYK,
    restarts, one scan a component, 4:2:0) decodes uint8-equal to PIL
    and to the JAX ``ImageFolderSource``;
  * seeded files written here (``image_forms/lossless_jpeg.py``) across
    predictors, point transforms, sizes, restart intervals, scan
    layouts, sampling factors and markers decode equal to PIL, or raise
    where PIL raises;
  * cut and corrupted files, in a child: the port never decodes what
    PIL refuses nor gives other pixels; it refuses some files PIL
    decodes, only where libjpeg warns and substitutes data (a bad
    Huffman code, data ending at a marker or too short for the frame, a
    wrong restart marker);
  * the LMDB path refuses SOF3, as the JAX binding does.
"""

import io
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from transeditor_tpu.data import native as jax_native
from transeditor_tpu_torch.data import native

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "image_forms"
sys.path.insert(0, str(FIXTURES))

import lossless_jpeg as lj  # noqa: E402
from test_torch_port_webp import DIGESTS, hold_fixture, sources  # noqa: E402,F401

SOF3 = sorted(n for n in DIGESTS if n.startswith("sof3_"))
JFIF = lj.segment(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def adobe(transform):
    return lj.segment(0xEE, b"Adobe\0\x64\0\0\0\0" + bytes([transform]))


def _pil(data):
    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception:
        return None


def _port(data):
    try:
        return native.decode_jpeg(data, as_pil=True)
    except ValueError:
        return None


@pytest.mark.parametrize("name", SOF3)
def test_lossless_fixture_equals_pil_and_the_jax_source(name, sources):  # noqa: F811
    assert b"\xff\xc3" in (FIXTURES / name).read_bytes()
    hold_fixture(name, sources)


def test_fixture_set_covers_every_form():
    for form in [*(f"rgb_p{p}_" for p in range(1, 8)), "gray_p1_pt2",
                 "gray_p7_pt2", "_1x1", "_17x13", "restart", "scans",
                 "cmyk", "adobe", "420", "v2_restart", "256x256"]:
        assert any(form in n for n in SOF3), form


def _image(rng, h, w, c):
    img = np.cumsum(rng.randint(-12, 13, (h, w, c)), axis=1) + 128
    return np.clip(img, 0, 255).astype(np.uint8)


def test_written_here_decode_as_pil_or_raise_where_it_raises():
    """300 seeded files: 1, 3 and 4 components, predictors 1-7, point
    transforms 0-7, sizes 1-40, restart intervals (whole MCU rows and
    not), interleaved or one scan a component, 4:2:0 / 4:2:2 / 3x1 /
    2x2-gray factors, and JFIF, Adobe 0 / 1 / 2 or component-id
    markers."""
    rng = np.random.RandomState(3)
    counts = {"decoded": 0, "refused": 0}
    bad = []
    for i in range(300):
        h, w = (int(v) for v in rng.randint(1, 41, 2))
        c = int(rng.choice([1, 3, 3, 4]))
        img = _image(rng, h, w, c)
        psv, pt = int(rng.randint(1, 8)), int(rng.choice([0, 0, 1, 2, 7]))
        kw = dict(interleaved=bool(rng.randint(3)))
        app = rng.randint(6)
        kw["app"] = (b"", b"", JFIF, adobe(0), adobe(1), adobe(2))[app]
        if c == 3 and rng.randint(4) == 0:
            kw["ids"] = (82, 71, 66)
        layout = rng.randint(4) if c == 3 else 0
        if layout == 0:
            planes = [np.ascontiguousarray(img[..., k]) for k in range(c)]
            factors = [(1, 1)] * c
            if c == 1 and rng.randint(3) == 0:
                factors = [(2, 2)]
        else:
            fh, fv = ((2, 2), (2, 1), (3, 1))[layout - 1]
            planes = [np.ascontiguousarray(img[..., 0]),
                      np.ascontiguousarray(img[::fv, ::fh, 1]),
                      np.ascontiguousarray(img[::fv, ::fh, 2])]
            factors = [(fh, fv), (1, 1), (1, 1)]
        mcus_row = -(-w // max(f[0] for f in factors)) if (
            kw["interleaved"] and c > 1) else planes[0].shape[1]
        if rng.randint(3) == 0:
            kw["restart"] = int(mcus_row * rng.randint(1, 4)
                                + (rng.randint(3) == 0))
        data = lj.encode(planes, factors, psv, pt, size=(w, h), **kw)
        want, got = _pil(data), _port(data)
        if (want is None) != (got is None) or (
                want is not None and not np.array_equal(want, got)):
            bad.append(i)
        counts["refused" if got is None else "decoded"] += 1
    assert bad == []
    assert counts["decoded"] > 150 and counts["refused"] > 30


def test_difference_category_16_and_the_default_table():
    """A table holding category 16 (a difference of 32768: no extra
    bits); and a file without DHT, which libjpeg-turbo's lossless decoder
    refuses (its DCT decoders fall back to the standard tables)."""
    rng = np.random.RandomState(5)
    img = _image(rng, 9, 11, 3)
    data = lj.encode_image(img, 3, 0, extra_symbol16=True)
    np.testing.assert_array_equal(_port(data), _pil(data))
    np.testing.assert_array_equal(_port(data), img)
    # an 8x8 gray frame of 128s: every difference 0, category 0, whose
    # code in the standard luminance DC table is 00
    std = lj.segment(0xC4, bytes([0x00, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0,
                                   0, 0, 0, 0]) + bytes(range(12)))
    head = b"\xff\xd8" + lj.segment(0xC3, bytes([8, 0, 8, 0, 8, 1, 1, 0x11,
                                                   0]))
    scan = lj.segment(0xDA, bytes([1, 1, 0x00, 1, 0, 0])) + b"\0" * 16
    data = head + std + scan + b"\xff\xd9"
    np.testing.assert_array_equal(_port(data), _pil(data))
    np.testing.assert_array_equal(_port(data), np.full((8, 8, 3), 128))
    data = head + scan + b"\xff\xd9"
    assert _pil(data) is None
    with pytest.raises(ValueError, match="missing or invalid table"):
        native.decode_jpeg(data, as_pil=True)


@pytest.mark.parametrize("name", ["sof3_rgb_p1_33x65.jpg",
                                  "sof3_gray_p4_pt2_33x65.jpg"])
def test_lmdb_records_refuse_lossless_as_the_jax_binding(name):
    """The LMDB path (``decode_jpeg`` without ``as_pil``, and the native
    loader's C++ workers) refuses SOF3, as the JAX binding's
    libjpeg-turbo 2.1 does; image files decode it."""
    data = (FIXTURES / name).read_bytes()
    w, h = native.jpeg_size(data)
    with pytest.raises(ValueError, match="lossless"):
        native.decode_jpeg(data)
    with pytest.raises(ValueError):
        jax_native.decode_jpeg(data, w, h)
    assert native.decode_jpeg(data, as_pil=True).shape == (h, w, 3)


@pytest.mark.parametrize("app,reason", [
    (JFIF, "colour space"), (adobe(1), "colour space"),
    (adobe(2), "colour space"), (b"restart", "restart interval")])
def test_refusals_where_libjpeg_turbo_refuses(app, reason):
    img = _image(np.random.RandomState(1), 6, 10, 3)
    if app == b"restart":
        data = lj.encode_image(img, 2, 0, restart=7)     # not 10 a row
    else:
        data = lj.encode_image(img, 2, 0, app=app)
    with pytest.raises(ValueError, match=reason):
        native.decode_jpeg(data, as_pil=True)
    assert _pil(data) is None


ROBUSTNESS = textwrap.dedent("""
    import io, json, sys
    import numpy as np
    from pathlib import Path
    from PIL import Image
    from transeditor_tpu_torch.data import native
    fixtures, n_cases = Path(sys.argv[1]), int(sys.argv[2])
    rng = np.random.RandomState(11)
    counts = {"decoded": 0, "refused": 0, "refused_pil_decodes": 0}
    bad, reasons = [], set()
    for path in sorted(fixtures.glob("sof3_*.jpg")):
        if "256x256" in path.name:
            continue
        orig = path.read_bytes()
        cases = [orig[:n] for n in range(0, len(orig),
                                         max(1, len(orig) // 10))]
        for _ in range(n_cases):
            b = bytearray(orig)
            for _ in range(1 + rng.randint(3)):
                b[rng.randint(len(b))] = rng.randint(256)
            cases.append(bytes(b))
        for data in cases:
            try:
                want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
            except Exception:
                want = None
            try:
                got, why = native.decode_jpeg(data, as_pil=True), None
            except ValueError as e:
                got, why = None, str(e)
            if got is not None and (want is None
                                    or not np.array_equal(want, got)):
                bad.append([path.name, len(data)])
            if got is None and want is not None:
                counts["refused_pil_decodes"] += 1
                reasons.add(why)
            counts["refused" if got is None else "decoded"] += 1
    print(json.dumps({**counts, "bad": bad[:10],
                      "reasons": sorted(reasons)}))
""")


def test_cut_and_corrupted_never_decode_otherwise_than_pil(tmp_path):
    """In a child process: ten cuts of each fixture and 40 seeded 1-3
    byte corruptions.  Where the port decodes, PIL decodes the same
    pixels; where PIL raises, the port raises; the files only PIL
    decodes are those on which libjpeg warns and substitutes data."""
    native.load_library()
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", ROBUSTNESS, str(FIXTURES),
                           "40"], capture_output=True, text=True,
                          timeout=600, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-2000:])
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    assert got["decoded"] > 50 and got["refused"] > 100
    # a bad Huffman code, data ending at a marker (or a frame larger than
    # its data could fill), a wrong restart marker
    padded = (native.CODEC_ERRORS[-10], native.CODEC_ERRORS[-4],
              native.CODEC_ERRORS[-13], native.CODEC_ERRORS[-1])
    assert set(got["reasons"]) <= set(padded), got["reasons"]
