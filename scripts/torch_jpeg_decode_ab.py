"""Single-thread decode time of two versions of the port's JPEG codec
(``transeditor_tpu_torch/csrc/jpeg.cpp``) on one machine, in turns.

    python scripts/torch_jpeg_decode_ab.py OLD_jpeg.cpp NEW_jpeg.cpp

Builds each source with g++ alone into a temporary directory, encodes
seeded 256px and 1024px images at quality 95 with the newer codec, and
times ``teio_jpeg_decode`` of each (100 / 10 calls a turn) in the order
old, new, new, old; prints one JSON line: µs a decode per turn, and the
ratio of the means.  Both versions must give the same pixels.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np


def build(src: Path, out: Path) -> ctypes.CDLL:
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-o",
                    str(out), str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    lib.teio_jpeg_decode.restype = ctypes.c_int
    lib.teio_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                     ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int]
    lib.teio_jpeg_encode.restype = ctypes.c_long
    lib.teio_jpeg_encode.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_long]
    return lib


def image(n: int, seed: int) -> np.ndarray:
    """A smooth seeded RGB image with a little noise."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:n, 0:n] / n
    f = rng.uniform(1, 4, (3, 2))
    img = np.stack([np.sin(6.3 * (f[c, 0] * x + f[c, 1] * y)) for c in
                    range(3)], -1) * 100 + 128 + rng.normal(0, 3, (n, n, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def main(old: str, new: str) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"old": build(Path(old), Path(tmp) / "old.so"),
                "new": build(Path(new), Path(tmp) / "new.so")}
        result = {}
        for n, reps in ((256, 100), (1024, 10)):
            img = image(n, seed=n)
            buf = ctypes.create_string_buffer(n * n * 3 + 4096)
            size = libs["new"].teio_jpeg_encode(
                img.ctypes.data_as(ctypes.c_void_p), n, n, 95, buf,
                len(buf))
            data = buf.raw[:size]
            outs = {}
            for name, lib in libs.items():
                outs[name] = np.empty((n, n, 3), np.uint8)
                ptr = outs[name].ctypes.data_as(ctypes.c_void_p)
                assert lib.teio_jpeg_decode(data, len(data), ptr, n, n) == 0
            assert np.array_equal(outs["old"], outs["new"])
            turns = []
            for name in ("old", "new", "new", "old"):
                lib, ptr = libs[name], outs[name].ctypes.data_as(
                    ctypes.c_void_p)
                t = time.perf_counter()
                for _ in range(reps):
                    lib.teio_jpeg_decode(data, len(data), ptr, n, n)
                turns.append((name, (time.perf_counter() - t) / reps * 1e6))
            mean = {k: float(np.mean([t for m, t in turns if m == k]))
                    for k in libs}
            result[f"{n}px"] = {"us_by_turn": turns,
                                "new_over_old": mean["new"] / mean["old"]}
    print(json.dumps(result))


if __name__ == "__main__":
    main(*sys.argv[1:3])
