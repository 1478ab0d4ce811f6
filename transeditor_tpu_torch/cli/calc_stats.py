"""Real-data FID statistics (``transeditor_tpu/cli/calc_stats.py``; the
metrics/calc_inception.py analogue): InceptionV3 pool3 mean and
covariance over up to 50k dataset images, pickled for the evaluator.

Usage, on the card:
  python -m transeditor_tpu_torch.cli.calc_stats --data_dir imgs_or_lmdb \\
      --out inception_ffhq.pkl --size 256 \\
      --inception_weights pt_inception.pth [--n_samples 50000] \\
      [--device cuda]

The flags are the JAX CLI's, plus ``--device``.  Without
``--inception_weights`` the network is the port's seeded random one
(the JAX CLI's is flax's, which the port cannot reproduce).
"""

from __future__ import annotations

import argparse
import os
import pickle

from transeditor_tpu_torch.device import resolve_device


def open_source(path: str):
    """An LMDB dataset (a folder holding ``data.mdb``) or an image folder."""
    if os.path.isdir(path) and os.path.exists(os.path.join(path,
                                                           "data.mdb")):
        from transeditor_tpu_torch.data.native import NativeLMDBSource
        return NativeLMDBSource(path)
    from transeditor_tpu_torch.data.dataset import ImageFolderSource
    return ImageFolderSource(path)


def load_inception(path, device):
    """``load_fid_inception(path)`` on ``device``, or the seeded random
    network with the JAX CLI's warning when ``path`` is None."""
    from transeditor_tpu_torch.metrics.inception import (InceptionV3Features,
                                                         load_fid_inception)
    if path:
        return load_fid_inception(path).to(device)
    print("WARNING: random InceptionV3 (pass --inception_weights)")
    return InceptionV3Features(device=device).eval()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--n_samples", type=int, default=50_000)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--inception_weights", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from transeditor_tpu_torch.metrics.evaluator import real_stats_from_source

    dev = resolve_device(args.device)
    source = open_source(args.data_dir)
    inception = load_inception(args.inception_weights, dev)
    mean, cov = real_stats_from_source(source, inception, args.size,
                                       n_samples=args.n_samples,
                                       batch=args.batch)
    n = min(args.n_samples, len(source))
    with open(args.out, "wb") as f:
        pickle.dump({"mean": mean, "cov": cov, "n": n}, f)
    print(f"wrote stats for {n} images to {args.out}")


if __name__ == "__main__":
    main()
