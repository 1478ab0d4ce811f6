"""Build the port's native sources into shared libraries, at first use.

Each ``csrc/<name>.cu`` has a plain C interface.  ``nvcc`` compiles it
for ``sm_90a`` into ``build/transeditor_tpu_torch/lib<name>-<hash>.so``
at the root of the checkout, where ``<hash>`` covers the source and the
flags, so an edit rebuilds it.  ``build_shared`` does the same for any
other source and compiler (the data loader's C++ runtime and
``csrc/image_io.cpp`` are built with g++ through it).  The library is loaded with ``ctypes``.  Nothing here
runs at import time: this module is imported on machines without
``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "transeditor_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return path


def _sources(src: Path | Sequence[Path]) -> list[Path]:
    return [Path(src)] if isinstance(src, (str, Path)) else \
        [Path(s) for s in src]


def hashed_path(stem: str, src: Path | Sequence[Path],
                flags: Sequence[str]) -> Path:
    """``BUILD_DIR/lib<stem>-<hash>.so``, the hash over the sources (one
    or several, in order) and the flags."""
    h = hashlib.sha256()
    for s in _sources(src):
        h.update(s.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:16]}.so"


def build_shared(stem: str, src: Path | Sequence[Path], compiler: str,
                 flags: Sequence[str], libs: Sequence[str] = ()) -> Path:
    """Compile ``src`` (one source or several, linked into one library)
    with ``compiler flags -o <lib> src... libs`` unless its hashed
    library exists; returns the library's path.

    The compiler's report is kept beside the library as ``<lib>.log``.
    A failed build raises with that report.
    """
    srcs = _sources(src)
    out = hashed_path(stem, srcs, [*flags, *libs])
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [compiler, *flags, "-o", str(tmp), *map(str, srcs), *libs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(compiler).name} failed for "
                           f"{', '.join(s.name for s in srcs)}:\n{log}")
    out.with_suffix(".so.log").write_text(log)
    os.replace(tmp, out)          # atomic: concurrent builds agree
    return out


def library_path(name: str) -> Path:
    return hashed_path(name, CSRC / f"{name}.cu", NVCC_FLAGS)


def compile_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists.

    The compiler's report (registers, shared memory, spills) is kept
    beside the library as ``<lib>.log``.
    """
    out = library_path(name)
    if out.exists():
        return out
    return build_shared(name, CSRC / f"{name}.cu", _nvcc(), NVCC_FLAGS)


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(compile_library(name)))
            _loaded[name] = lib
        return lib
