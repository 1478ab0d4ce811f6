"""Dataset preparation: image folder -> LMDB of pre-resized JPEGs
(``transeditor_tpu/cli/prepare_data.py``).

Writes the ``MultiResolutionDataset`` layout that the training loader
(and the reference's ``utils/dataset.py``) reads: keys
``f'{res}-{idx:05d}'`` holding JPEG bytes plus a ``length`` record.
Images are read and resized without PIL (``data/dataset.py``) and
encoded by the port's own JPEG codec (``data/native.py``), which writes
the bytes libjpeg's defaults write.

Usage:
  python -m transeditor_tpu_torch.cli.prepare_data --in_dir imgs/ \\
      --out data/ffhq_lmdb --size 256 [--quality 95]
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from transeditor_tpu_torch.data.dataset import ImageFolderSource
from transeditor_tpu_torch.data.lmdb_writer import write_image_dataset
from transeditor_tpu_torch.data.native import encode_jpeg


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--in_dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--quality", type=int, default=95)
    args = p.parse_args(argv)

    source = ImageFolderSource(args.in_dir)

    def jpegs():
        for i in range(len(source)):
            yield encode_jpeg(source.get(i, args.size), args.quality)
            if (i + 1) % 500 == 0:
                print(f"{i + 1}/{len(source)}", flush=True)

    n = write_image_dataset(args.out, jpegs(), args.size)
    print(f"wrote {n} images at {args.size}px to {args.out}")
    return n


if __name__ == "__main__":
    main()
