"""The port's arithmetic-coded JPEG decode (SOF9 sequential, SOF10
progressive; ``csrc/jpeg.cpp``'s port of libjpeg-turbo's jdarith.c)
against libjpeg-turbo, on the CPU.

PIL (libjpeg-turbo 3.1) reads these files, and so does the JAX
package's LMDB binding (libjpeg-turbo 2.1.5 built with arithmetic
decoding), so the port decodes them on both paths.  Here:

  * every committed SOF9 / SOF10 fixture (``tests/image_forms/sof9_*``,
    ``sof10_*``: gray, 4:4:4, 4:2:0, CMYK, restarts, DAC conditioning)
    decodes uint8-equal to PIL and to the JAX ``ImageFolderSource``; on
    the LMDB path equal to the JAX binding (CMYK refused by both), and
    to the digests ``chip_smoke.py`` 6e holds the card's machine to;
  * files written here through the system libjpeg
    (``image_forms/arith_jpeg.c``) across sizes, components, sampling,
    progression, restart intervals and DAC values decode the same;
  * cut and corrupted files: where the port decodes, PIL and the JAX
    binding give the same pixels; where they raise, so does the port; it
    raises where they decode only on files on which libjpeg itself warns
    (its warning count read through a small libjpeg program);
  * the decoders of image files (CMYK, lossless and arithmetic) built
    with AddressSanitizer and UBSan over seeded corruptions.
"""

import hashlib
import io
import itertools
import subprocess
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from transeditor_tpu.data import native as jax_native
from transeditor_tpu_torch.data import native
from torch_port_threads import torch_worker_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "transeditor_tpu_torch"
FIXTURES = ROOT / "tests" / "image_forms"

from test_torch_port_jpeg import PIL_HARNESS, _chip_smoke  # noqa: E402
from test_torch_port_webp import DIGESTS, hold_fixture, sources  # noqa: E402,F401

ARITH = sorted(n for n in DIGESTS if n.startswith(("sof9_", "sof10_")))


def _pil(data):
    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception:
        return None


def _port(data, as_pil):
    try:
        return native.decode_jpeg(data, as_pil=as_pil)
    except ValueError:
        return None


def _jax(data):
    try:
        return jax_native.decode_jpeg(data, *native.jpeg_size(data))
    except ValueError:
        return None


@pytest.mark.parametrize("name", ARITH)
def test_arith_fixture_equals_pil_and_the_jax_source(name, sources):  # noqa: F811
    data = (FIXTURES / name).read_bytes()
    assert (b"\xff\xc9" if name.startswith("sof9_") else b"\xff\xca") in data
    assert b"\xff\xcc" in data                        # DAC
    hold_fixture(name, sources)


def test_fixture_set_covers_every_form():
    for sof in ("sof9", "sof10"):
        for form in ("gray_33x65", "444_33x65", "420_33x65", "cmyk_420_33x65",
                     "420_restart_33x65", "444_dac_33x65", "420_1x1",
                     "gray_17x13", "420_256x256"):
            assert f"{sof}_{form}.jpg" in ARITH, (sof, form)


@pytest.mark.parametrize("name", [n for n in ARITH if "cmyk" not in n])
def test_lmdb_path_equals_the_jax_binding(name):
    data = (FIXTURES / name).read_bytes()
    got = native.decode_jpeg(data)
    np.testing.assert_array_equal(got, _jax(data))
    np.testing.assert_array_equal(got, native.decode_jpeg(data, as_pil=True))


def test_lmdb_path_refuses_arithmetic_cmyk_as_the_jax_binding():
    for name in ("sof9_cmyk_420_33x65.jpg", "sof10_cmyk_420_33x65.jpg"):
        data = (FIXTURES / name).read_bytes()
        with pytest.raises(ValueError, match="CMYK"):
            native.decode_jpeg(data)
        assert _jax(data) is None
        np.testing.assert_array_equal(native.decode_jpeg(data, as_pil=True),
                                      _pil(data))


def test_chip_smoke_lmdb_digests_are_the_jax_bindings():
    """6e holds the LMDB path's decode of these fixtures to digests of
    the JAX binding's pixels (the card's machine has no libjpeg):
    recomputed here from the binding and the port."""
    cs = _chip_smoke()
    names = [n for n in ARITH if "cmyk" not in n and "256x256" not in n]
    assert sorted(cs.LMDB_ARITH_SHA256) == names
    for name, want in cs.LMDB_ARITH_SHA256.items():
        data = (FIXTURES / name).read_bytes()
        for px in (_jax(data), native.decode_jpeg(data)):
            assert hashlib.sha256(px.tobytes()).hexdigest() == want, name
    assert cs.LMDB_REFUSED == "sof3_rgb_p1_33x65.jpg"


@pytest.fixture(scope="module")
def libjpeg_tools(tmp_path_factory):
    """The arithmetic encoder of the fixtures, and a decoder that prints
    libjpeg's warning count for each file (or "error"), both built
    against the system libjpeg."""
    tmp = tmp_path_factory.mktemp("libjpeg")
    enc, warn = tmp / "arith_jpeg", tmp / "warnings"
    (tmp / "warnings.c").write_text(WARNINGS_C)
    for exe, src in ((enc, FIXTURES / "arith_jpeg.c"),
                     (warn, tmp / "warnings.c")):
        subprocess.run(["cc", "-O2", "-o", str(exe), str(src), "-ljpeg"],
                       check=True, capture_output=True)
    return tmp, enc, warn


WARNINGS_C = r"""
#include <setjmp.h>
#include <stdio.h>
#include <stdlib.h>
#include <jpeglib.h>

struct err { struct jpeg_error_mgr mgr; jmp_buf jb; };
static void on_error(j_common_ptr c) { longjmp(((struct err*)c->err)->jb, 1); }
static void on_message(j_common_ptr c, int level) {
  if (level < 0) c->err->num_warnings++;
}

int main(int argc, char** argv) {
  for (int f = 1; f < argc; ++f) {
    FILE* fp = fopen(argv[f], "rb");
    unsigned char* buf = malloc(1 << 20);
    size_t n = fread(buf, 1, 1 << 20, fp);
    fclose(fp);
    struct jpeg_decompress_struct cinfo;
    struct err e;
    cinfo.err = jpeg_std_error(&e.mgr);
    e.mgr.error_exit = on_error;
    e.mgr.emit_message = on_message;
    jpeg_create_decompress(&cinfo);
    JSAMPARRAY row = NULL;
    if (setjmp(e.jb)) {
      printf("error\n");
    } else {
      jpeg_mem_src(&cinfo, buf, n);
      jpeg_read_header(&cinfo, TRUE);
      jpeg_start_decompress(&cinfo);
      row = (*cinfo.mem->alloc_sarray)((j_common_ptr)&cinfo, JPOOL_IMAGE,
          cinfo.output_width * cinfo.output_components, 1);
      while (cinfo.output_scanline < cinfo.output_height)
        jpeg_read_scanlines(&cinfo, row, 1);
      jpeg_finish_decompress(&cinfo);
      printf("%ld\n", e.mgr.num_warnings);
    }
    jpeg_destroy_decompress(&cinfo);
    free(buf);
  }
  return 0;
}
"""


def test_written_here_equal_pil_and_the_jax_binding(libjpeg_tools):
    """72 files: gray, RGB and CMYK; 4:4:4 and 4:2:0; sequential and
    progressive; restart intervals 0 and 2; DAC (L, U, K) at the
    defaults (0, 1, 5) and at (3, 7, 20), (0, 0, 1), (15, 15, 63); two
    qualities; sizes 1x1 to 40x64."""
    tmp, enc, _ = libjpeg_tools
    rng = np.random.RandomState(9)
    done = 0
    for c, sub, prog, restart, dac in itertools.product(
            (1, 3, 4), ("444", "420"), (0, 1), (0, 2),
            ((0, 1, 5), (3, 7, 20), (0, 0, 1), (15, 15, 63))):
        if c == 1 and sub == "420" or rng.randint(2):
            continue
        h, w = (int(v) for v in rng.randint(1, 65, 2))
        img = np.clip(np.cumsum(rng.randint(-15, 16, (h, w, c)), 1) + 128,
                      0, 255).astype(np.uint8)
        (tmp / "in.raw").write_bytes(img.tobytes())
        subprocess.run([str(enc), str(w), str(h), str(c), sub, str(prog),
                        str(restart), *map(str, dac),
                        str(rng.choice([20, 95])), str(tmp / "in.raw"),
                        str(tmp / "out.jpg")], check=True)
        data = (tmp / "out.jpg").read_bytes()
        np.testing.assert_array_equal(_port(data, True), _pil(data))
        if c != 4:
            np.testing.assert_array_equal(_port(data, False), _jax(data))
        done += 1
    assert done > 15


def test_cut_and_corrupted_refused_only_where_libjpeg_warns(libjpeg_tools):
    """Eight cuts and 30 seeded 1-3 byte corruptions of each 33x65 and
    17x13 fixture.  The port (image files) against PIL, and (LMDB
    records) against the JAX binding: the same pixels wherever the port
    decodes, a refusal wherever they raise, and a refusal where they
    decode only on a file libjpeg warns on (and pads or drops data)."""
    tmp, _, warn = libjpeg_tools
    rng = np.random.RandomState(13)
    cases = []
    for name in ARITH:
        if "_1x1" in name or "256x256" in name:
            continue
        orig = (FIXTURES / name).read_bytes()
        cases += [orig[:n] for n in range(0, len(orig),
                                          max(1, len(orig) // 8))]
        for _ in range(30):
            b = bytearray(orig)
            for _ in range(1 + rng.randint(3)):
                b[rng.randint(len(b))] = rng.randint(256)
            cases.append(bytes(b))
    paths = []
    for i, data in enumerate(cases):
        paths.append(tmp / f"case{i}.jpg")
        paths[-1].write_bytes(data)
    out = subprocess.run([str(warn), *map(str, paths)], capture_output=True,
                         text=True, timeout=300, check=True)
    warned = [s != "0" for s in out.stdout.split()]
    assert len(warned) == len(cases)
    bad, counts = [], {"decoded": 0, "refused": 0, "only_libjpeg": 0}
    for i, data in enumerate(cases):
        for as_pil, oracle in ((True, _pil), (False, _jax)):
            got, want = _port(data, as_pil), oracle(data)
            if got is not None:
                ok = want is not None and np.array_equal(got, want)
            else:
                ok = want is None or warned[i]
                counts["only_libjpeg"] += want is not None
            counts["refused" if got is None else "decoded"] += 1
            if not ok:
                bad.append((i, as_pil))
    assert bad == []
    assert counts["decoded"] > 300 and counts["refused"] > 100
    assert counts["only_libjpeg"] > 0


def test_image_file_decoders_under_address_and_undefined_sanitizers(tmp_path):
    """The decoder of image files (``teio_jpeg_decode_pil``: arithmetic
    sequential and progressive, lossless, CMYK) built with ASan and UBSan:
    800 seeded 1-4 byte corruptions or truncations of each 33x65
    arithmetic and lossless fixture."""
    (tmp_path / "fuzz.cpp").write_text(PIL_HARNESS)
    exe = tmp_path / "fuzz"
    subprocess.run(["g++", "-O1", "-g", "-std=c++17",
                    "-fsanitize=address,undefined",
                    "-fno-sanitize-recover=undefined", "-o", str(exe),
                    str(tmp_path / "fuzz.cpp"),
                    str(PKG / "csrc" / "jpeg.cpp")],
                   check=True, capture_output=True)
    seeds = [str(FIXTURES / n) for n in DIGESTS if n.startswith(
        ("sof9_", "sof10_", "sof3_")) and "33x65" in n]
    proc = subprocess.run([str(exe), "800", *seeds], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    decoded, refused = map(int, proc.stdout.split())
    assert decoded > 0 and refused > 0 and decoded + refused > 15_000
