"""The port's RLE8 / RLE4 BMP reader (``csrc/image_io.cpp`` through
``utils/image.py::load_bmp``) against PIL, which the JAX package reads
every image with (``data/dataset.py``, ``metrics/paired.py``).

PIL decodes BMP compression 1 and 2 with ``BmpRleDecoder``, a Python
decoder whose quirks the port keeps: the delta escape skips two bytes
and reads (right, up) from the next two; an RLE4 absolute run of odd
length n reads n // 2 bytes but moves x by n; the word alignment after
an absolute run follows the file offset; encoded runs are clipped to the
row, absolute ones are not; end-of-line and delta fill with index 0;
data past the image is ignored; a stream that ends first raises; a
black-and-white palette (mode "1") raises; a gray palette (mode "L")
gives the index as gray.

  * every committed fixture (``tests/image_forms/bmp_*.bmp``) decodes
    uint8-equal to PIL's ``convert("RGB")`` and to the JAX
    ``ImageFolderSource``;
  * a seeded sweep of streams made of random runs and escapes, cut and
    corrupted, decodes equal to PIL or raises exactly where PIL raises;
  * the reader built with AddressSanitizer and UBSan over seeded
    corruptions of the fixtures.
"""

import io
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from transeditor_tpu_torch.utils.image import load_bmp, load_image

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "transeditor_tpu_torch"
FIXTURES = ROOT / "tests" / "image_forms"
sys.path.insert(0, str(FIXTURES))

import bmp_rle  # noqa: E402
from test_torch_port_webp import DIGESTS, hold_fixture, sources  # noqa: E402,F401

RLE = sorted(n for n in DIGESTS if n.startswith("bmp_"))


@pytest.mark.parametrize("name", RLE)
def test_rle_fixture_equals_pil_and_the_jax_source(name, sources):  # noqa: F811
    data = (FIXTURES / name).read_bytes()
    assert int.from_bytes(data[30:34], "little") in (1, 2)
    hold_fixture(name, sources)


def test_fixture_set_covers_every_form():
    want = ["bmp_rle8_1x1", "bmp_rle8_17x13", "bmp_rle8_33x65",
            "bmp_rle4_1x1", "bmp_rle4_33x65", "rle8_topdown", "rle4_topdown",
            "rle8_escapes_gap0", "rle8_escapes_gap1", "rle4_escapes_gap1",
            "rle8_gray_palette", "rle4_short_palette", "rle8_in_1bit",
            "rle4_in_8bit", "bmp_rle8_256x256"]
    for form in want:
        assert any(form in n for n in RLE), form
    data = (FIXTURES / "bmp_rle8_escapes_gap1_17x13.bmp").read_bytes()
    assert int.from_bytes(data[10:14], "little") % 2 == 1


def _pil(data):
    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception:             # OSError, ValueError, a bomb
        return None


def _port(path, data):
    path.write_bytes(data)
    try:
        return load_bmp(str(path))
    except ValueError:
        return None


def _random_stream(rng, rle4):
    """Runs and escapes drawn at random, odd RLE4 absolute runs too."""
    items = []
    top = 16 if rle4 else 256
    for _ in range(rng.randint(1, 30)):
        k = rng.randint(6)
        if k == 0:
            items.append(("run", int(rng.randint(1, 30)),
                          int(rng.randint(top)), int(rng.randint(top))))
        elif k == 1:
            items.append(("abs", [int(v) for v in
                                  rng.randint(0, top, rng.randint(3, 30))]))
        elif k == 2:
            items.append(("eol",))
        elif k == 3:
            items.append(("delta", int(rng.randint(5)), int(rng.randint(3))))
        elif k == 4:
            items.append(("eob",))
        else:
            items.append(("abs", [int(v) for v in
                                  rng.randint(0, 16, 2 * rng.randint(2, 5)
                                              + 1)]))
    return bmp_rle.ops(items, rle4)


def test_seeded_streams_decode_as_pil_or_raise_where_it_raises(tmp_path):
    """1,200 files: whole encodings and random run / escape sequences,
    some with junk after them or cut anywhere, at 1, 4 and 8 bits, with
    colour, gray, black-and-white and short palettes, bottom-up and
    top-down, at even and odd pixel offsets."""
    rng = np.random.RandomState(7)
    counts = {"decoded": 0, "refused": 0}
    bad = []
    path = tmp_path / "x.bmp"
    for i in range(1200):
        w, h = (int(v) for v in rng.randint(1, 20, 2))
        rle4 = bool(rng.randint(2))
        ncol = int(rng.choice([2, 3, 16, 200, 256]))
        if rng.randint(4) == 0:
            pal = [(v, v, v) for v in range(ncol)]
        elif rng.randint(8) == 0:
            pal = [(0, 0, 0), (255, 255, 255)][:ncol] + [(9, 9, 9)] * (ncol - 2)
        else:
            pal = [tuple(int(v) for v in rng.randint(0, 256, 3))
                   for _ in range(ncol)]
        kind = rng.randint(4)
        if kind == 0:
            idx = rng.randint(0, 16 if rle4 else 256, (h, w))
            idx = np.where(rng.rand(h, w) < 0.5, idx[:, :1], idx)
            stream = bmp_rle.encode_rows(idx, rle4)
        else:
            stream = _random_stream(rng, rle4)
            if kind == 2:
                stream += rng.randint(0, 256, rng.randint(40)).astype(
                    np.uint8).tobytes()
            if kind == 3 and stream:
                stream = stream[:rng.randint(len(stream))]
        bpp = int(rng.choice([1, 4, 8])) if rng.randint(3) == 0 else None
        data = bmp_rle.bmp(stream, w, h, pal, rle4=rle4, bpp=bpp,
                           top_down=bool(rng.randint(2)),
                           colors_used=ncol if rng.randint(2) else 0,
                           gap=int(rng.randint(3)))
        if rng.randint(5) == 0:   # a corrupted byte (not in the size)
            b = bytearray(data)
            pos = rng.randint(len(b) - 8)
            b[pos + 8 * (18 <= pos < 26)] = rng.randint(256)
            data = bytes(b)
        want, got = _pil(data), _port(path, data)
        if (want is None) != (got is None) or (
                want is not None and not np.array_equal(want, got)):
            bad.append(i)
        counts["refused" if got is None else "decoded"] += 1
    assert bad == []
    assert counts["decoded"] > 300 and counts["refused"] > 300


@pytest.mark.parametrize("case,reason", [
    ("short", "ends before"), ("black_and_white", "black-and-white"),
    ("delta_cut", "delta escape"), ("rle_24bit", "24 bits"),
    ("jpeg_in_bmp", "compression 4")])
def test_refusals_name_the_file_where_pil_refuses(tmp_path, case, reason):
    idx = np.arange(12).reshape(3, 4) % 5
    pal = [(10 * i, 20, 30) for i in range(8)]
    stream, kw = bmp_rle.encode_rows(idx, False), {}
    if case == "short":
        stream = stream[:len(stream) // 2]
    elif case == "black_and_white":
        idx, pal = idx % 2, [(0, 0, 0), (255, 255, 255)]
        stream, kw = bmp_rle.encode_rows(idx, False), dict(colors_used=2)
    elif case == "delta_cut":
        stream = bmp_rle.ops([("run", 3, 1), ("delta", 1, 1)], False)[:-1]
    elif case == "rle_24bit":
        kw = dict(bpp=24)
    else:
        kw = dict(compression=4)
    path = tmp_path / f"{case}.bmp"
    path.write_bytes(bmp_rle.bmp(stream, 4, 3, pal, **kw))
    with pytest.raises(ValueError, match=f"{case}.bmp.*{reason}"):
        load_image(str(path))
    assert _pil(path.read_bytes()) is None


def test_quirks_follow_pil_not_the_specification(tmp_path):
    """Streams that a reader written from the BMP specification decodes
    otherwise (4x2, rows bottom-up, the stream at file offset 86, or 87
    with one gap byte): PIL's readings of them, pinned."""
    pal = [(i * 30, 255 - i * 30, 7) for i in range(8)]

    def image(top, bottom):
        return np.array([[pal[i] for i in top], [pal[i] for i in bottom]],
                        np.uint8)

    def check(data, want):
        np.testing.assert_array_equal(_pil(data), want)
        np.testing.assert_array_equal(_port(tmp_path / "q.bmp", data), want)

    # delta: "0 2 9 9" then PIL takes the NEXT two bytes, (1, 0), as
    # (right, up); a run clipped at the row's end; end of line
    check(bmp_rle.bmp(bytes([2, 1, 0, 2, 9, 9, 1, 0, 2, 2, 0, 0, 4, 3]), 4,
                      2, pal), image([3, 3, 3, 3], [1, 1, 0, 2]))
    # RLE4 absolute run of 3: one byte read (two pixels), x moved by 3,
    # so the next run is clipped to one pixel; end of line fills index 0
    check(bmp_rle.bmp(bytes([0, 3, 0x12, 0x30, 2, 0x44, 0, 0, 4, 0x55]), 4,
                      2, pal, rle4=True), image([5, 5, 5, 5], [1, 2, 4, 0]))
    # the alignment after an absolute run follows the file offset: at
    # the odd offset the pad byte starts the next pair (0 2: a delta)
    stream = bytes([0, 3, 1, 2, 3, 0, 2, 4, 0, 0, 4, 6])
    check(bmp_rle.bmp(stream, 4, 2, pal), image([6, 6, 6, 6], [1, 2, 3, 4]))
    check(bmp_rle.bmp(stream, 4, 2, pal, gap=1),
          image([0, 0, 0, 0], [1, 2, 3, 0]))


FUZZ_HARNESS = r"""
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <random>
#include <vector>
extern "C" long teimg_bmp_info(const uint8_t*, long, long*);
extern "C" long teimg_bmp_decode(const uint8_t*, long, uint8_t*);

int main(int argc, char** argv) {
  std::mt19937 rng(77);
  long decoded = 0, refused = 0;
  for (int f = 2; f < argc; ++f) {
    FILE* fp = fopen(argv[f], "rb");
    std::vector<uint8_t> orig(1 << 20);
    orig.resize(fread(orig.data(), 1, orig.size(), fp));
    fclose(fp);
    for (int it = 0; it < atoi(argv[1]); ++it) {
      std::vector<uint8_t> d = orig;
      for (int k = 1 + rng() % 4; k > 0; --k) {
        size_t pos = rng() % d.size();
        switch (rng() % 3) {
          case 0: d[pos] = uint8_t(rng()); break;
          case 1: d[pos] ^= uint8_t(1 << (rng() % 8)); break;
          default: d.resize(pos + 1);
        }
      }
      long info[4];
      if (teimg_bmp_info(d.data(), long(d.size()), info) != 0) {
        ++refused;
        continue;
      }
      if (info[0] * info[1] > 4000000) continue;
      std::vector<uint8_t> out(size_t(info[0]) * info[1] * 3);
      (teimg_bmp_decode(d.data(), long(d.size()), out.data()) == 0
           ? decoded : refused)++;
    }
  }
  printf("%ld %ld\n", decoded, refused);
  return 0;
}
"""


def test_reader_under_address_and_undefined_sanitizers(tmp_path):
    """``csrc/image_io.cpp``'s BMP reader built with AddressSanitizer and
    UBSan (any report aborts): 1,000 seeded 1-4 byte corruptions or
    truncations of each 17x13 and 33x65 RLE fixture."""
    seeds = [str(FIXTURES / n) for n in RLE if "256x256" not in n
             and "_1x1" not in n]
    (tmp_path / "fuzz.cpp").write_text(FUZZ_HARNESS)
    exe = tmp_path / "fuzz"
    subprocess.run(["g++", "-O1", "-g", "-std=c++17",
                    "-fsanitize=address,undefined",
                    "-fno-sanitize-recover=undefined", "-o", str(exe),
                    str(tmp_path / "fuzz.cpp"),
                    str(PKG / "csrc" / "image_io.cpp")],
                   check=True, capture_output=True)
    proc = subprocess.run([str(exe), "1000", *seeds], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    decoded, refused = map(int, proc.stdout.split())
    assert decoded > 0 and refused > 0 and decoded + refused > 10_000
