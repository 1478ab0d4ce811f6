"""The port's WebP reader (``csrc/webp.cpp`` through
``utils/image.py::load_webp``) against PIL, which the JAX package reads
every image with, on the CPU.

  * every committed WebP fixture (``tests/image_forms/``: lossy at four
    qualities and two methods, lossless, with ALPH raw and compressed
    under each filter, animated with a first frame smaller than its
    canvas, and the encoder settings PIL cannot pass) decodes uint8-equal
    to PIL's ``convert("RGB")`` and to the JAX ``ImageFolderSource``, at
    its own size and through the 256px LANCZOS resize;
  * seeded images written by PIL here decode equal to PIL's reading;
  * truncated and corrupted files, in a child process: the port refuses
    (``ValueError``) exactly the files PIL refuses, and decodes the others
    to PIL's pixels;
  * the decoder built with AddressSanitizer and UBSan over seeded
    corruptions of each fixture form;
  * no module of the port, and not ``chip_smoke.py``, imports JAX, the
    JAX package or PIL.
"""

import hashlib
import io
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from transeditor_tpu.data import dataset as jax_dataset
from transeditor_tpu_torch.data import dataset
from transeditor_tpu_torch.utils import image as port_image
from transeditor_tpu_torch.utils.image import load_image, load_webp

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "transeditor_tpu_torch"
FIXTURES = ROOT / "tests" / "image_forms"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
WEBP = sorted(n for n in DIGESTS if n.endswith(".webp"))


@pytest.fixture(scope="module")
def sources():
    return (dataset.ImageFolderSource(str(FIXTURES)),
            jax_dataset.ImageFolderSource(str(FIXTURES)))


def _pil(path):
    return np.asarray(Image.open(path).convert("RGB"))


def hold_fixture(name, sources):
    """A fixture through ``load_image`` and ``ImageFolderSource.get``:
    equal to PIL and to the JAX source at its own size (square files),
    within the folder tests' one level through the 256px resize."""
    port, jax = sources
    path = FIXTURES / name
    want = _pil(path)
    got = load_image(str(path))
    np.testing.assert_array_equal(got, want)
    assert hashlib.sha256(got.tobytes()).hexdigest() == \
        DIGESTS[name]["sha256"]
    i = port.paths.index(str(path))
    assert jax.paths[i] == port.paths[i]
    h, w, _ = want.shape
    if h == w:
        np.testing.assert_array_equal(port.get(i, h), jax.get(i, h))
    a, b = port.get(i, 256), jax.get(i, 256)
    assert a.shape == b.shape == (256, 256, 3)
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


@pytest.mark.parametrize("name", WEBP)
def test_webp_fixture_equals_pil_and_the_jax_source(name, sources):
    hold_fixture(name, sources)


def test_fixture_set_covers_every_form():
    """The committed WebP forms the reader is held to."""
    want = ["webp_lossy_q0_m0", "webp_lossy_q100_m6", "webp_lossless_",
            "webp_lossless_alpha_exact", "webp_lossy_alpha", "webp_anim_",
            "simple_filter", "sharpness7", "filter_strength0",
            "partitions2", "partitions4", "partitions8", "segments1",
            "segments4", "alph_raw_gradient", "alph_lossless_horizontal",
            "near_lossless", "palette2_", "palette4_", "palette16_",
            "palette256_", "_256x256"]
    for form in want:
        assert any(form in n for n in WEBP), form
    total = sum((FIXTURES / n).stat().st_size for n in DIGESTS)
    assert total < 400_000


@pytest.mark.parametrize("kind", ["lossy", "lossless", "alpha", "anim"])
def test_webp_written_here_equals_pil(tmp_path, kind):
    """Seeded images at odd sizes, written by PIL here, read as PIL
    reads them."""
    rng = np.random.RandomState(len(kind))
    for i in range(6):
        h, w = rng.randint(1, 70, 2)
        img = rng.randint(0, 256, (h, w, 4)).astype(np.uint8)
        img[..., :3] = np.clip(np.cumsum(img[..., :3] // 32 - 3, axis=1)
                               + 128, 0, 255)
        path = tmp_path / f"{i}.webp"
        if kind == "anim":
            frames = [Image.fromarray(np.roll(img, k, 1), "RGBA")
                      for k in range(3)]
            frames[0].save(path, "WEBP", save_all=True,
                           append_images=frames[1:], quality=60)
        else:
            mode = "RGB" if kind == "lossy" else "RGBA"
            Image.fromarray(img if mode == "RGBA" else img[..., :3],
                            mode).save(path, "WEBP",
                                       lossless=kind == "lossless",
                                       quality=int(rng.randint(0, 101)),
                                       method=int(rng.randint(0, 7)))
        np.testing.assert_array_equal(load_webp(str(path)), _pil(path))


def test_folder_of_webp_reads_as_the_jax_source(tmp_path):
    """``ImageFolderSource`` takes ``.webp`` now (it raised before)."""
    for i, name in enumerate(["b.webp", "a.png", "c.webp"]):
        Image.fromarray(np.full((9, 9, 3), 40 * i + 10, np.uint8)).save(
            tmp_path / name, lossless=True)
    port = dataset.ImageFolderSource(str(tmp_path))
    jax = jax_dataset.ImageFolderSource(str(tmp_path))
    assert not hasattr(dataset.ImageFolderSource, "UNREAD")
    for i in range(3):
        np.testing.assert_array_equal(port.get(i, 9), jax.get(i, 9))
        np.testing.assert_array_equal(port.get(i, 16), jax.get(i, 16))


@pytest.mark.parametrize("case", ["riff_size", "not_webp", "no_frame",
                                  "bad_alpha", "vp8_signature"])
def test_refusals_name_the_file(tmp_path, case):
    """What libwebp refuses raises ``ValueError`` naming the file, and
    PIL refuses it too."""
    data = bytearray((FIXTURES / "webp_lossy_alpha_33x65.webp").read_bytes())
    if case == "riff_size":
        data[4:8] = (len(data)).to_bytes(4, "little")       # 8 bytes short
    elif case == "not_webp":
        data[12:16] = b"JUNK"
    elif case == "no_frame":
        data = data[:30]
        data[4:8] = (len(data) - 8).to_bytes(4, "little")
    elif case == "bad_alpha":
        pos = data.index(b"ALPH") + 8
        data[pos] |= 0xC0                                   # reserved bits
    else:
        pos = data.index(b"VP8 ") + 8
        data[pos + 3] ^= 0xFF
    path = tmp_path / "x.webp"
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="x.webp"):
        load_webp(str(path))
    with pytest.raises(Exception):
        Image.open(path).convert("RGB")


def test_segment_header_without_values_keeps_libwebp_defaults(tmp_path):
    """A VP8 header that turns segments on but sends no segment values
    (two bytes of a fixture changed): libwebp then keeps its defaults,
    absolute values of 0 for the quantiser and the filter level, and so
    must the port."""
    sys.path.insert(0, str(FIXTURES))
    from vp8_header import describe
    data = bytearray((FIXTURES / "webp_lossy_q0_m6_17x13.webp").read_bytes())
    data[30], data[60] = 230, 64
    assert describe(bytes(data))["vp8"]["segments"] == 1
    assert describe(bytes(data))["vp8"]["segment_data"] == 0
    path = tmp_path / "x.webp"
    path.write_bytes(bytes(data))
    want = _pil(path)
    np.testing.assert_array_equal(load_webp(str(path)), want)
    assert not np.array_equal(want, _pil(FIXTURES / "webp_lossy_q0_m6_17x13.webp"))


AGREEMENT = textwrap.dedent("""
    import io, json, sys, warnings
    import numpy as np
    from pathlib import Path
    from PIL import Image
    from transeditor_tpu_torch.utils.image import _decode_png, load_webp
    warnings.simplefilter("ignore")
    fixtures, kind, n_cases = Path(sys.argv[1]), sys.argv[2], int(sys.argv[3])
    rng = np.random.RandomState(0)
    tmp = Path("case." + kind)
    counts = {"refused": 0, "decoded": 0}
    bad = []

    def port(data):
        if kind == "png":
            return _decode_png(data)
        tmp.write_bytes(data)
        return load_webp(str(tmp))

    for path in sorted(fixtures.glob(kind + "_*." + kind)):
        if "256x256" in path.name:
            continue
        orig = path.read_bytes()
        cases = [orig[:n] for n in range(0, len(orig),
                                         max(1, len(orig) // 12))]
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
                got = port(data)
            except ValueError:
                got = None
            if (want is None) != (got is None) or (
                    want is not None and not np.array_equal(want, got)):
                bad.append([path.name, len(data)])
            counts["refused" if got is None else "decoded"] += 1
    print(json.dumps({**counts, "bad": bad[:10]}))
""")


@pytest.mark.parametrize("kind,n_cases", [("webp", 12)])
def test_truncations_and_corruptions_refused_as_pil_refuses(tmp_path, kind,
                                                            n_cases):
    """In a child process (a crash would not take the test run down):
    cuts of each fixture and seeded 1-3 byte corruptions; the port
    raises ``ValueError`` exactly where PIL raises, and otherwise gives
    PIL's pixels."""
    port_image._native()                          # built before the child
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", AGREEMENT, str(FIXTURES),
                           kind, str(n_cases)], capture_output=True,
                          text=True, timeout=600, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-2000:])
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    assert got["refused"] > 20 and got["decoded"] > 20
    assert got["refused"] + got["decoded"] > 500


FUZZ_HARNESS = r"""
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <random>
#include <vector>
extern "C" long teimg_webp_info(const uint8_t*, long, long*);
extern "C" long teimg_webp_decode(const uint8_t*, long, uint8_t*);

int main(int argc, char** argv) {
  std::mt19937 rng(321);
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
      long info[2];
      if (teimg_webp_info(d.data(), long(d.size()), info) != 0) {
        ++refused;
        continue;
      }
      if (info[0] * info[1] > 4000000) continue;
      std::vector<uint8_t> out(size_t(info[0]) * info[1] * 3);
      (teimg_webp_decode(d.data(), long(d.size()), out.data()) == 0
           ? decoded : refused)++;
    }
  }
  printf("%ld %ld\n", decoded, refused);
  return 0;
}
"""


def test_decoder_under_address_and_undefined_sanitizers(tmp_path):
    """``csrc/webp.cpp`` built with AddressSanitizer and UBSan (any
    report aborts): 400 seeded 1-4 byte corruptions or truncations of
    each of 20 fixtures, one of every form."""
    seeds = sorted(n for n in WEBP if "_33x65" in n or "_48x40" in n
                   or "_17x13" in n and "lossless" in n)
    seeds = [n for i, n in enumerate(seeds) if i % 2 == 0 or
             "alph" in n or "anim" in n][:20]
    (tmp_path / "fuzz.cpp").write_text(FUZZ_HARNESS)
    exe = tmp_path / "fuzz"
    subprocess.run(["g++", "-O1", "-g", "-std=c++17",
                    "-fsanitize=address,undefined",
                    "-fno-sanitize-recover=undefined", "-o", str(exe),
                    str(tmp_path / "fuzz.cpp"), str(PKG / "csrc" / "webp.cpp")],
                   check=True, capture_output=True)
    proc = subprocess.run([str(exe), "400",
                           *[str(FIXTURES / n) for n in seeds]],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    decoded, refused = map(int, proc.stdout.split())
    assert decoded > 0 and refused > 0 and decoded + refused > 5000


_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(jax|jaxlib|PIL|transeditor_tpu)(?:[.\s]|$)",
    re.MULTILINE)


def test_no_port_module_imports_jax_the_jax_package_or_pil():
    """The port and ``chip_smoke.py`` read every image without PIL (the
    card's machine has none) and never reach JAX."""
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 50
    bad = [(str(p.relative_to(ROOT)), m.group(0).strip())
           for p in files for m in _IMPORT.finditer(p.read_text())]
    assert bad == []


def test_decodes_without_any_image_library():
    """The image reader's library links no libwebp, libpng or libjpeg."""
    import importlib
    jpeg_tests = importlib.import_module("test_torch_port_jpeg")
    port_image._native()
    from transeditor_tpu_torch.ops.cuda_build import hashed_path
    lib = hashed_path("image_io", (PKG / "csrc" / "image_io.cpp",
                                   PKG / "csrc" / "webp.cpp"),
                      port_image.GXX_FLAGS)
    needed = jpeg_tests._needed_libraries(lib)
    assert needed and not any(k in n for n in needed
                              for k in ("webp", "png", "jpeg", "z.so"))
