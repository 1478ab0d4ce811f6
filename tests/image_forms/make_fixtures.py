"""Writes the image-form fixtures beside this file and ``digests.json``,
the SHA-256 of each one's pixels as PIL's ``Image.open(p).convert("RGB")``
gives them.  The port's readers are held to these files and digests by
``tests/test_torch_port_{webp,png_forms,jpeg}.py`` here and by
``chip_smoke.py`` (phase 6f) on a machine without PIL.

    python tests/image_forms/make_fixtures.py

needs PIL with WebP (libwebp 1.6.0 as Pillow 12.1 bundles it; settings
PIL cannot pass go through ``webp_encode.py``) and a C compiler with the
system libjpeg (``jpeglib.h``, ``-ljpeg``) for ``arith_jpeg.c``.
Re-running it rewrites every file; the tests read them as committed and
do not run it.

The forms:
  * WebP lossy (VP8) at qualities 0, 50, 75 and 100, methods 0 and 6;
    lossless (VP8L) with and without alpha (``exact``); lossy with an
    ALPH chunk; animations whose first frame is smaller than the canvas;
  * WebP that PIL cannot ask for: the simple loop filter, sharpness 7,
    filter strength 0, 2 / 4 / 8 token partitions, 1 and 4 segments,
    ALPH raw and VP8L-compressed under each of its four filters,
    near-lossless, and palettes of 2, 4, 16 and 256 colours (pixel
    bundling);
  * PNG in every colour type x bit depth x interlace pair of the spec
    (``pngforms.py``), some with tRNS and ancillary chunks;
  * CMYK and YCCK JPEG (Adobe transform 0 and 2), baseline and
    progressive, 4:4:4 and 4:2:0;
  * arithmetic-coded JPEG (``arith_jpeg.c``: SOF9 sequential, SOF10
    progressive): gray, 4:4:4, 4:2:0 and CMYK, with and without restart
    markers, default and other DAC conditioning;
  * 8-bit lossless JPEG (SOF3, ``lossless_jpeg.py``): predictors 1-7,
    point transforms 0 and 2, gray, RGB and CMYK, restart intervals,
    one scan a component, 4:2:0 and 2x2 gray factors, an Adobe marker;
  * RLE8 and RLE4 BMP (``bmp_rle.py``): encoded and absolute runs,
    end-of-line, delta, end-of-bitmap, an odd RLE4 absolute run, an odd
    file offset, clipped runs, excess data, top-down rows, gray and short
    palettes, RLE in a 1- and 4-bit file;
each at 1x1, 17x13 and 33x65 (width x height) where the form has sizes,
and at 256x256 for lossy, lossless and animated WebP, a 4:2:0 CMYK JPEG,
SOF9 and SOF10 4:2:0, SOF3 RGB and RLE8 (the sizes chip_smoke times).
"""

from __future__ import annotations

import hashlib
import io
import json
import struct
import subprocess
import sys
import tempfile
import zlib
from pathlib import Path

import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import bmp_rle  # noqa: E402
import lossless_jpeg  # noqa: E402
import pngforms  # noqa: E402
from vp8_header import describe  # noqa: E402
from webp_encode import encode  # noqa: E402

SIZES = ((1, 1), (17, 13), (33, 65))        # width x height


def natural(w: int, h: int, seed: int, channels: int = 3,
            noise: float = 6.0) -> np.ndarray:
    """A smooth seeded image with a little noise: [h, w, channels]."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    s = max(w, h, 8)
    out = []
    for c in range(channels):
        f = rng.uniform(1, 4, 2) * 2 * np.pi / s
        ph = rng.uniform(0, 2 * np.pi, 2)
        out.append(128 + 70 * np.sin(f[0] * x + ph[0]) * np.cos(f[1] * y + ph[1])
                   + 40 * np.sin(f[1] * (x + y) / 2 + ph[1]))
    img = np.stack(out, -1) + rng.normal(0, noise, (h, w, channels))
    return np.clip(img, 0, 255).round().astype(np.uint8)


def alpha_of(w: int, h: int, seed: int) -> np.ndarray:
    """An alpha plane with opaque, clear and partial regions."""
    a = natural(w, h, seed, 1, noise=0)[..., 0].astype(np.int32)
    a = np.where(a > 170, 255, np.where(a < 80, 0, a))
    return a.astype(np.uint8)


def rgba(w: int, h: int, seed: int) -> np.ndarray:
    return np.concatenate([natural(w, h, seed), alpha_of(w, h, seed + 7)[..., None]], -1)


def pil_webp(img: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img, "RGBA" if img.shape[-1] == 4 else "RGB").save(
        buf, "WEBP", **kw)
    return buf.getvalue()


def webp_files() -> dict[str, bytes]:
    out = {}
    for w, h in SIZES:
        tag = f"{w}x{h}"
        img = natural(w, h, seed=w * h)
        for q in (0, 50, 75, 100):
            for m in (0, 6):
                out[f"webp_lossy_q{q}_m{m}_{tag}.webp"] = pil_webp(
                    img, quality=q, method=m)
        out[f"webp_lossless_{tag}.webp"] = pil_webp(img, lossless=True)
        out[f"webp_lossless_alpha_exact_{tag}.webp"] = pil_webp(
            rgba(w, h, w + h), lossless=True, exact=True)
        out[f"webp_lossy_alpha_{tag}.webp"] = pil_webp(rgba(w, h, w + h + 1),
                                                       quality=80)
    big = natural(256, 256, seed=256, noise=2.0)
    out["webp_lossy_q75_256x256.webp"] = pil_webp(big, quality=75)
    out["webp_lossless_256x256.webp"] = pil_webp(
        natural(256, 256, seed=257, noise=0.0), lossless=True)
    out["webp_lossy_alpha_256x256.webp"] = pil_webp(
        np.concatenate([big, alpha_of(256, 256, 3)[..., None]], -1),
        quality=75)
    for name, (cw, ch), kw in (("webp_anim_lossy_48x40.webp", (48, 40),
                                dict(quality=70)),
                               ("webp_anim_lossless_48x40.webp", (48, 40),
                                dict(lossless=True)),
                               ("webp_anim_lossy_256x256.webp", (256, 256),
                                dict(quality=75))):
        out[name] = animation(cw, ch, **kw)
    # what PIL cannot set
    base = natural(33, 65, seed=99)
    opaque = np.concatenate([base, np.full((65, 33, 1), 255, np.uint8)], -1)
    for name, kw in (
            ("simple_filter", dict(filter_type=0, filter_strength=60)),
            ("sharpness7", dict(filter_type=1, filter_strength=80,
                                filter_sharpness=7)),
            ("filter_strength0", dict(filter_strength=0)),
            ("partitions2", dict(partitions=1, method=0)),
            ("partitions4", dict(partitions=2, method=0)),
            ("partitions8", dict(partitions=3, method=0)),
            ("segments1", dict(segments=1)),
            ("segments4", dict(segments=4, method=0))):
        out[f"webp_vp8_{name}_33x65.webp"] = encode(opaque, 70.0, **kw)
    with_alpha = np.concatenate([base, alpha_of(33, 65, 5)[..., None]], -1)
    for comp in (0, 1):
        data = encode(with_alpha, 70.0, alpha_compression=comp,
                      alpha_filtering=0)
        for filt, fname in enumerate(("none", "horizontal", "vertical",
                                      "gradient")):
            out[f"webp_alph_{'lossless' if comp else 'raw'}_{fname}"
                f"_33x65.webp"] = set_alpha_filter(data, filt)
    out["webp_near_lossless_33x65.webp"] = encode(with_alpha, 100.0,
                                                  lossless=1,
                                                  near_lossless=60)
    rng = np.random.RandomState(4)
    for n in (2, 4, 16, 256):
        # a ramp between two colours, so that the image stays smooth
        ends = rng.randint(0, 256, (2, 4))
        t = np.linspace(0, 1, n)[:, None]
        palette = np.round(ends[0] * (1 - t) + ends[1] * t).astype(np.uint8)
        palette[:, 3] = 255
        idx = (natural(33, 65, seed=n, channels=1, noise=20)[..., 0].astype(
            np.int64) * n) // 256
        out[f"webp_palette{n}_33x65.webp"] = encode(palette[idx], 100.0,
                                                    lossless=1, exact=1)
    return out


def set_alpha_filter(data: bytes, filt: int) -> bytes:
    """The ALPH chunk's filter bits set to ``filt`` (the alpha it decodes
    to changes; the RGB does not)."""
    data = bytearray(data)
    pos = data.index(b"ALPH") + 8
    data[pos] = (data[pos] & ~0x0C) | (filt << 2)
    return bytes(data)


def animation(cw: int, ch: int, **kw) -> bytes:
    """Three frames; the first one opaque only in a rectangle away from
    the canvas's corner, so that Pillow stores it as a smaller frame at
    an offset."""
    frames = []
    for i in range(3):
        f = np.zeros((ch, cw, 4), np.uint8)
        x0, y0 = (cw // 4 + i * 2) & ~1, (ch // 4 + i) & ~1
        f[y0:y0 + ch // 2, x0:x0 + cw // 2, :3] = natural(cw // 2, ch // 2,
                                                          seed=cw + i)
        f[y0:y0 + ch // 2, x0:x0 + cw // 2, 3] = 255
        frames.append(Image.fromarray(f, "RGBA"))
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:],
                   duration=80, loop=0, **kw)
    return buf.getvalue()


def png_files() -> dict[str, bytes]:
    out = {}
    w, h = 17, 13
    for color, depth in pngforms.FORMS:
        for interlace in (0, 1):
            seed = color * 100 + depth * 2 + interlace
            pal = None
            if color == 3:
                n = 1 << depth
                pal = np.random.RandomState(seed).randint(0, 256, (n, 3))
                # a smooth index image, plus indices past a short PLTE
                s = (natural(w, h, seed, 1, noise=10).astype(np.int64) * n
                     // 256).astype(np.uint8)
                if depth >= 2:
                    pal = pal[:n - 1]          # the top index is past PLTE
            elif depth == 16:
                top = 700 if color == 0 else 65535
                s = (natural(w, h, seed, pngforms.CHANNELS[color],
                             noise=4).astype(np.int64) * top // 255
                     ).astype(np.uint16)
            else:
                s = (natural(w, h, seed, pngforms.CHANNELS[color],
                             noise=6).astype(np.int64) >> (8 - depth)
                     ).astype(np.uint8)
            extra = b""
            if interlace:                        # ancillary chunks PIL skips
                extra = (pngforms.chunk(b"gAMA", struct.pack(">I", 45455))
                         + pngforms.chunk(b"tEXt", b"Comment\0fixture"))
            if color == 3 and depth == 8:
                extra += pngforms.chunk(b"tRNS", bytes([0, 128, 255]))
            if color == 2 and depth == 8:
                extra += pngforms.chunk(b"tRNS", struct.pack(">HHH", 1, 2, 3))
            if color == 0 and depth == 16 and not interlace:
                extra += pngforms.chunk(b"iCCP", b"x\0\0" + zlib.compress(b"p"))
            out[f"png_c{color}_d{depth}_{'adam7' if interlace else 'plain'}"
                f".png"] = pngforms.png_bytes(s, depth, color, interlace,
                                              pal, seed=seed, extra=extra)
    return out


def jpeg_files() -> dict[str, bytes]:
    out = {}
    img = natural(33, 65, seed=5, channels=4, noise=3)
    for prog in (False, True):
        for sub, stag in ((0, "444"), (2, "420")):
            buf = io.BytesIO()
            Image.fromarray(img, "CMYK").save(buf, "JPEG", quality=85,
                                              progressive=prog,
                                              subsampling=sub)
            data = buf.getvalue()
            kind = "progressive" if prog else "baseline"
            out[f"jpeg_cmyk_{kind}_{stag}_33x65.jpg"] = data
            out[f"jpeg_ycck_{kind}_{stag}_33x65.jpg"] = adobe_transform(data, 2)
    buf = io.BytesIO()
    Image.fromarray(natural(256, 256, seed=6, channels=4, noise=2),
                    "CMYK").save(buf, "JPEG", quality=75, subsampling=2)
    out["jpeg_cmyk_baseline_420_256x256.jpg"] = buf.getvalue()
    return out


def arith_files() -> dict[str, bytes]:
    """SOF9 / SOF10 through the system libjpeg (``arith_jpeg.c``)."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        exe = Path(tmp) / "arith_jpeg"
        subprocess.run(["cc", "-O2", "-o", str(exe), str(HERE / "arith_jpeg.c"),
                        "-ljpeg"], check=True)

        def arith(img, sub="444", prog=0, restart=0, dac=(0, 1, 5), q=85):
            raw = Path(tmp) / "in.raw"
            raw.write_bytes(np.ascontiguousarray(img).tobytes())
            h, w = img.shape[:2]
            c = 1 if img.ndim == 2 else img.shape[2]
            dst = Path(tmp) / "out.jpg"
            subprocess.run([str(exe), str(w), str(h), str(c), sub, str(prog),
                            str(restart), *map(str, dac), str(q), str(raw),
                            str(dst)], check=True)
            return dst.read_bytes()

        for prog, sof in ((0, "sof9"), (1, "sof10")):
            img = natural(33, 65, seed=20 + prog, channels=4, noise=3)
            out[f"{sof}_gray_33x65.jpg"] = arith(img[..., 0], prog=prog)
            out[f"{sof}_444_33x65.jpg"] = arith(img[..., :3], prog=prog)
            out[f"{sof}_420_33x65.jpg"] = arith(img[..., :3], "420", prog)
            out[f"{sof}_cmyk_420_33x65.jpg"] = arith(img, "420", prog)
            out[f"{sof}_420_restart_33x65.jpg"] = arith(img[..., :3], "420",
                                                        prog, restart=3)
            out[f"{sof}_444_dac_33x65.jpg"] = arith(
                img[..., :3], prog=prog, dac=(2, 6, 12) if prog else (0, 3, 40))
            for w, h in SIZES[:2]:
                small = natural(w, h, seed=w * h + prog)
                out[f"{sof}_420_{w}x{h}.jpg"] = arith(small, "420", prog)
                out[f"{sof}_gray_{w}x{h}.jpg"] = arith(small[..., 1], prog=prog)
            out[f"{sof}_420_256x256.jpg"] = arith(
                natural(256, 256, seed=30 + prog, noise=2), "420", prog, q=75)
    return out


def lossless_files() -> dict[str, bytes]:
    """SOF3 written by ``lossless_jpeg.py``."""
    enc = lossless_jpeg.encode_image
    out = {}
    img = natural(33, 65, seed=40, channels=4, noise=2)
    for p in range(1, 8):
        out[f"sof3_rgb_p{p}_33x65.jpg"] = enc(img[..., :3], p, 0)
    for p in (1, 4, 7):
        out[f"sof3_gray_p{p}_pt2_33x65.jpg"] = enc(img[..., 3], p, 2)
    for w, h in SIZES[:2]:
        small = natural(w, h, seed=w + h, noise=2)
        out[f"sof3_rgb_p4_{w}x{h}.jpg"] = enc(small, 4, 0)
        out[f"sof3_gray_p6_pt2_{w}x{h}.jpg"] = enc(small[..., 0], 6, 2)
    out["sof3_rgb_p5_restart_33x65.jpg"] = enc(img[..., :3], 5, 0,
                                                restart=33 * 2)
    out["sof3_rgb_p7_scans_restart_33x65.jpg"] = enc(
        img[..., :3], 7, 2, interleaved=False, restart=33 * 5)
    out["sof3_cmyk_p3_33x65.jpg"] = enc(img, 3, 0)
    out["sof3_rgb_p2_adobe_17x13.jpg"] = enc(
        img[:13, :17, :3], 2, 0, app=lossless_jpeg.segment(
            0xEE, b"Adobe\0\x64\0\0\0\0\0"))
    y = img[..., 0]
    out["sof3_420_p1_33x65.jpg"] = lossless_jpeg.encode(
        [y, img[::2, ::2, 1].copy(), img[::2, ::2, 2].copy()],
        [(2, 2), (1, 1), (1, 1)], 1, 0, restart=17 * 4)
    # a gray frame with 2x2 factors: each iMCU row holds two sample rows,
    # and a restart every third row resets the prediction of a whole one
    out["sof3_gray_v2_restart_33x65.jpg"] = lossless_jpeg.encode(
        [y], [(2, 2)], 4, 0, restart=33 * 3)
    out["sof3_rgb_p6_256x256.jpg"] = enc(
        natural(256, 256, seed=41, noise=0), 6, 0)
    return out


def rle_files() -> dict[str, bytes]:
    """RLE8 / RLE4 BMPs written by ``bmp_rle.py``."""
    out = {}
    rng = np.random.RandomState(50)

    def palette(n, end=None):
        """A ramp between two colours (to ``end``, if given): a smooth
        index image stays smooth, so its LMDB record keeps 40 dB."""
        a, b = rng.randint(0, 256, (2, 3))
        b = b if end is None else np.asarray(end)
        t = np.linspace(0, 1, n)[:, None]
        return [tuple(int(v) for v in row)
                for row in np.round(a * (1 - t) + b * t)]

    def indices(w, h, n, seed):
        """A smooth index image, so that runs repeat."""
        g = natural(w, h, seed=seed, channels=1, noise=0)[..., 0]
        return (g.astype(np.int64) * n // 256 // 4 * 4).astype(np.uint8)

    for rle4, tag in ((False, "rle8"), (True, "rle4")):
        n = 16 if rle4 else 256
        pal = palette(n)
        for w, h in SIZES:
            out[f"bmp_{tag}_{w}x{h}.bmp"] = bmp_rle.bmp(
                bmp_rle.encode_rows(indices(w, h, n, w * h), rle4), w, h,
                pal, rle4=rle4)
        idx = indices(17, 13, n, 7)
        out[f"bmp_{tag}_topdown_17x13.bmp"] = bmp_rle.bmp(
            bmp_rle.encode_rows(idx, rle4, top_down=True), 17, 13, pal,
            rle4=rle4, top_down=True)
        # every escape: end-of-line leaving a row short, a delta, an
        # absolute run ending on an odd offset, a run clipped at the row's
        # end, an odd RLE4 absolute run, end-of-bitmap past the image
        # (odd pixel-data offset: the word alignment follows the file)
        items = [("run", 5, 3, 1), ("eol",), ("abs", [1, 2, 3, 4, 5]),
                 ("delta", 3, 1), ("run", 40, 2, 5), ("eol",),
                 ("abs", [7, 6, 5, 4, 3, 2, 1]), ("run", 9, 1, 2), ("eol",),
                 ("abs", [9, 8, 7]), ("delta", 4, 2),
                 ("abs", [1, 3, 5, 7, 9, 11, 13, 15, 2, 4, 6])]
        # rows enough to fill the image, read in step or a byte off (no
        # value byte is an escape code then)
        for k in range(40):
            items += [("eol",), ("run", 17, 3 + k % 13, 15 - k % 13)]
        for gap in (0, 1):
            out[f"bmp_{tag}_escapes_gap{gap}_17x13.bmp"] = bmp_rle.bmp(
                bmp_rle.ops(items + [("eob",)], rle4) + b"\x07" * 9, 17, 13,
                pal, rle4=rle4, gap=gap)
        # a gray palette (mode "L": indices past it read as gray) and a
        # short one (indices past it black)
        gidx = indices(33, 65, 256 if not rle4 else 16, 8)
        out[f"bmp_{tag}_gray_palette_33x65.bmp"] = bmp_rle.bmp(
            bmp_rle.encode_rows(gidx, rle4), 33, 65,
            [(i, i, i) for i in range(n // 2)], rle4=rle4,
            colors_used=n // 2)
        short = n // 2 + 3        # dark at its end: black past it
        out[f"bmp_{tag}_short_palette_33x65.bmp"] = bmp_rle.bmp(
            bmp_rle.encode_rows(gidx, rle4), 33, 65,
            palette(short, end=(4, 4, 4)), rle4=rle4, colors_used=short)
    idx = indices(17, 13, 2, 9)
    out["bmp_rle8_in_1bit_17x13.bmp"] = bmp_rle.bmp(
        bmp_rle.encode_rows(idx + 1, False), 17, 13, palette(2), bpp=1)
    out["bmp_rle4_in_8bit_17x13.bmp"] = bmp_rle.bmp(
        bmp_rle.encode_rows(indices(17, 13, 16, 10), True), 17, 13,
        palette(256), rle4=True, bpp=8)
    out["bmp_rle8_256x256.bmp"] = bmp_rle.bmp(
        bmp_rle.encode_rows(indices(256, 256, 256, 11), False), 256, 256,
        palette(256))
    return out


def adobe_transform(data: bytes, transform: int) -> bytes:
    """The Adobe APP14 transform byte set: PIL (libjpeg) then reads the
    same scans as YCCK (2) or CMYK (0)."""
    data = bytearray(data)
    pos = data.index(b"Adobe")
    data[pos + 11] = transform
    return bytes(data)


def check_forms(files: dict[str, bytes]) -> None:
    """Each file has the form its name says."""
    for name, data in files.items():
        if not name.startswith("webp_"):
            continue
        d = describe(data)
        v = d.get("vp8", {})
        if "partitions" in name:
            want = int(name.split("partitions")[1].split("_")[0])
            assert v["partitions"] == want, (name, d)
        if "simple_filter" in name:
            assert v["simple_filter"] == 1 and v["filter_level"] > 0, (name, d)
        if "sharpness7" in name:
            assert v["sharpness"] == 7 and v["filter_level"] > 0, (name, d)
        if "filter_strength0" in name:
            assert v["filter_level"] == 0, (name, d)
        if "segments1" in name:
            assert v["segments"] == 0, (name, d)
        if "segments4" in name:
            assert v["segments"] == 1, (name, d)
        if name.startswith("webp_alph_"):
            comp = 1 if "_lossless_" in name else 0
            filt = ("none", "horizontal", "vertical", "gradient").index(
                name.split("_")[3])
            assert d["alpha"] == {"compression": comp, "filter": filt}, (name, d)
        if "_alpha_" in name and "lossless" not in name:
            assert "ALPH" in d["chunks"], (name, d)
        if "_anim_" in name:
            f, (cw, ch) = d["first_frame"], d["canvas"]
            assert f["w"] < cw and f["h"] < ch and f["x"] > 0 and f["y"] > 0, (
                name, d)
        if "palette" in name:          # colour indexing, read first
            assert d["vp8l_first_transform"] == 3, (name, d)
        if "lossless" in name or "palette" in name or "near" in name:
            assert "VP8L" in d["chunks"] or "ALPH" in d["chunks"], (name, d)


def main() -> None:
    files = {**webp_files(), **png_files(), **jpeg_files(), **arith_files(),
             **lossless_files(), **rle_files()}
    check_forms(files)
    for old in HERE.iterdir():
        if old.suffix in (".webp", ".png", ".jpg", ".bmp"):
            old.unlink()
    digests = {}
    for name, data in sorted(files.items()):
        (HERE / name).write_bytes(data)
        px = np.asarray(Image.open(HERE / name).convert("RGB"))
        digests[name] = {"sha256": hashlib.sha256(px.tobytes()).hexdigest(),
                         "shape": list(px.shape)}
    (HERE / "digests.json").write_text(json.dumps(digests, indent=1) + "\n")
    total = sum(len(d) for d in files.values())
    print(f"{len(files)} fixtures, {total} bytes")


if __name__ == "__main__":
    main()
