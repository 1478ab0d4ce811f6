"""Face-alignment CLI (``transeditor_tpu/cli/align.py``; the
``align_all_parallel.py`` analogue), without PIL.

Usage:
  python -m transeditor_tpu_torch.cli.align --root_path raw/ \\
      --out_path aligned/ [--landmarks lm.npz | --predictor \\
      shape_predictor_68.dat] [--output_size 256] [--num_workers 4]

Landmark sources, in priority order:
  * ``--landmarks``: an .npz mapping image filename -> [68, 2] array
    (precomputed by any detector);
  * ``--predictor``: dlib shape-predictor weights (requires dlib).

Images are read with ``utils/image.py::load_image`` (PNG of every
form, JPEG with CMYK / YCCK, WebP lossy / lossless / animated, and
uncompressed BMP, each as PIL's ``convert("RGB")`` gives it) and each
aligned image is written under its source's name: PNG through
zlib, JPEG through the port's own codec (``data/native.py``, the bytes
libjpeg writes) at PIL's default quality (75).  Any other output format
(BMP, WebP) raises ``ValueError`` naming the file before any image is
aligned.  Host preprocessing: no device is involved.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from transeditor_tpu_torch.utils.face_align import (align_face,
                                                    dlib_landmark_provider)
from transeditor_tpu_torch.utils.image import load_image, save_png

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")
JPEG_QUALITY = 75            # PIL's default, which the JAX CLI writes at


def check_writable(names) -> None:
    """Raise ``ValueError`` naming the first output that is neither PNG
    nor JPEG."""
    for name in names:
        if os.path.splitext(name)[1].lower() not in (".png", ".jpg",
                                                      ".jpeg"):
            raise ValueError(f"{name}: only PNG and JPEG outputs are "
                             f"written")


def save_image(path: str, img: np.ndarray) -> None:
    if os.path.splitext(path)[1].lower() == ".png":
        save_png(path, img)
        return
    from transeditor_tpu_torch.data.native import encode_jpeg
    with open(path, "wb") as f:
        f.write(encode_jpeg(img, quality=JPEG_QUALITY))


def _align_one(job):
    src, dst, lm, output_size = job
    out = align_face(load_image(src), lm, output_size=output_size,
                     transform_size=output_size)
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    save_image(dst, out)
    return dst


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root_path", required=True)
    p.add_argument("--out_path", required=True)
    p.add_argument("--landmarks", type=str, default=None,
                   help=".npz of filename -> [68,2] landmark arrays")
    p.add_argument("--predictor", type=str, default=None,
                   help="dlib shape-predictor .dat (requires dlib)")
    p.add_argument("--output_size", type=int, default=256)
    p.add_argument("--num_workers", type=int, default=1)
    args = p.parse_args(argv)

    if args.landmarks is None and args.predictor is None:
        p.error("need --landmarks or --predictor")

    names = sorted(f for f in os.listdir(args.root_path)
                   if f.lower().endswith(IMG_EXTS))

    lm_db = None
    provider = None
    if args.landmarks:
        lm_db = np.load(args.landmarks)
    else:
        provider = dlib_landmark_provider(args.predictor)

    jobs, skipped = [], []
    for name in names:
        src = os.path.join(args.root_path, name)
        try:
            lm = (np.asarray(lm_db[name]) if lm_db is not None
                  else provider(src))
        except (KeyError, ValueError) as e:
            skipped.append((name, str(e)))
            continue
        jobs.append((src, os.path.join(args.out_path, name), lm,
                     args.output_size))
    check_writable(os.path.basename(j[1]) for j in jobs)

    if args.num_workers > 1:
        import multiprocessing as mp
        with mp.Pool(args.num_workers) as pool:
            done = pool.map(_align_one, jobs)
    else:
        done = [_align_one(j) for j in jobs]

    print(f"aligned {len(done)} images -> {args.out_path}")
    for name, why in skipped:
        print(f"skipped {name}: {why}")


if __name__ == "__main__":
    main()
