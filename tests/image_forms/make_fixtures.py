"""Writes the image-form fixtures beside this file and ``digests.json``,
the SHA-256 of each one's pixels as PIL's ``Image.open(p).convert("RGB")``
gives them.  The port's readers are held to these files and digests by
``tests/test_torch_port_{webp,png_forms,jpeg}.py`` here and by
``chip_smoke.py`` (phase 6f) on a machine without PIL.

    python tests/image_forms/make_fixtures.py

needs PIL with WebP (libwebp 1.6.0 as Pillow 12.1 bundles it; settings
PIL cannot pass go through ``webp_encode.py``).  Re-running it rewrites
every file; the tests read them as committed and do not run it.

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
each at 1x1, 17x13 and 33x65 (width x height) where the form has sizes,
and at 256x256 for lossy, lossless and animated WebP and a 4:2:0 CMYK
JPEG (the sizes chip_smoke times).
"""

from __future__ import annotations

import hashlib
import io
import json
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

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
    files = {**webp_files(), **png_files(), **jpeg_files()}
    check_forms(files)
    for old in HERE.iterdir():
        if old.suffix in (".webp", ".png", ".jpg"):
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
