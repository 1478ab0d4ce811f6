"""Input pipeline (``transeditor_tpu/data/dataset.py``).

  * a source protocol: ``len(source)`` and ``source.get(idx, res)`` ->
    [res, res, 3] uint8 (``ArraySource``, ``ImageFolderSource``, and
    ``data/native.py::NativeLMDBSource``);
  * ``make_train_iterator``: an endless, shuffled, host-sharded batch
    iterator with random horizontal flips, read ahead on a thread.

Shuffle and flip draws come from ``np.random.RandomState(seed +
host_index)`` in the JAX iterator's order, so the same source and seed
give the same batches bit for bit.  Images are read and resized without
PIL (``utils/image.py``), each to the pixels of PIL's
``convert("RGB")``.
"""

from __future__ import annotations

import os
import queue as queue_lib
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from transeditor_tpu_torch.utils.image import load_image, resize_lanczos


class ArraySource:
    """In-memory source (tests, synthetic data): [N, H, W, 3] uint8."""

    def __init__(self, array: np.ndarray):
        if array.ndim != 4 or array.shape[-1] != 3:
            raise ValueError(f"need [N, H, W, 3], got {array.shape}")
        self.array = array

    def __len__(self):
        return self.array.shape[0]

    def get(self, idx: int, resolution: int) -> np.ndarray:
        img = self.array[idx]
        if img.shape[:2] != (resolution, resolution):
            img = resize_lanczos(img, resolution, resolution)
        return img


class ImageFolderSource:
    """The images of a folder in sorted name order, as the JAX source
    lists them: PNG (every colour type, bit depth and interlace), JPEG
    (CMYK and YCCK too), WebP (lossy, lossless, with alpha, or the first
    frame of an animation) and uncompressed BMP, each read as PIL's
    ``convert("RGB")`` reads it (``utils/image.py::load_image``)."""

    EXTS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")

    def __init__(self, root: str):
        self.paths = sorted(
            os.path.join(root, f) for f in os.listdir(root)
            if f.lower().endswith(self.EXTS))
        if not self.paths:
            raise ValueError(f"no images under {root}")

    def __len__(self):
        return len(self.paths)

    def get(self, idx: int, resolution: int) -> np.ndarray:
        img = load_image(self.paths[idx])
        if img.shape[:2] != (resolution, resolution):
            img = resize_lanczos(img, resolution, resolution)
        return img


def _to_train_batch(imgs: np.ndarray, flip_mask: np.ndarray) -> np.ndarray:
    """uint8 [B,H,W,3] -> float32 in [-1,1], flipped where ``flip_mask``."""
    out = imgs.astype(np.float32) / 127.5 - 1.0
    out[flip_mask] = out[flip_mask, :, ::-1, :]
    return out


class _Failed:
    """The producer's exception, handed to the consumer."""

    def __init__(self, exc: Exception):
        self.exc = exc


def make_train_iterator(
    source,
    batch_size: int,
    resolution: int,
    *,
    seed: int = 0,
    host_index: int = 0,
    host_count: int = 1,
    shuffle: bool = True,
    prefetch: int = 2,
    flip: bool = True,
    normalize: bool = True,
) -> Iterator[np.ndarray]:
    """Endless host-sharded batch iterator, read ahead on a thread.

    Host ``host_index`` of ``host_count`` reads the indices
    ``host_index::host_count``.  ``normalize=False`` yields flipped uint8
    batches (the train step normalises on the device).  Each batch's
    images are read on cpu_count - 1 threads (file reads, zlib and the
    native image code release the GIL), in the order one thread would
    read them.  Closing the generator stops the threads; an error while
    reading is raised to the consumer (the JAX iterator would leave it
    waiting).
    """
    n = len(source)
    local_indices = np.arange(host_index, n, host_count)
    stop = threading.Event()

    def read(i: int) -> np.ndarray:
        return source.get(i, resolution)

    def produce(out_q: queue_lib.Queue, pool):
        rng = np.random.RandomState(seed + host_index)
        epoch_order = local_indices.copy()
        pos = len(epoch_order)             # shuffle on first use
        while not stop.is_set():
            batch_idx = []
            while len(batch_idx) < batch_size:
                if pos >= len(epoch_order):
                    if shuffle:
                        rng.shuffle(epoch_order)
                    pos = 0
                batch_idx.append(int(epoch_order[pos]))
                pos += 1
            imgs = np.stack(list(pool.map(read, batch_idx)) if pool
                            else [read(i) for i in batch_idx])
            flips = (rng.rand(batch_size) < 0.5) if flip else \
                np.zeros(batch_size, bool)
            if normalize:
                item = _to_train_batch(imgs, flips)
            else:
                imgs[flips] = imgs[flips, :, ::-1, :]
                item = imgs
            put(out_q, item)

    def put(out_q: queue_lib.Queue, item) -> None:
        # a bounded put that honours stop, so an abandoned iterator
        # never leaves this thread blocked on a full queue
        while not stop.is_set():
            try:
                out_q.put(item, timeout=0.25)
                return
            except queue_lib.Full:
                continue

    def run(out_q: queue_lib.Queue):
        readers = (os.cpu_count() or 2) - 1
        pool = ThreadPoolExecutor(readers) if readers > 1 else None
        try:
            produce(out_q, pool)
        except Exception as e:                 # handed to the consumer
            put(out_q, _Failed(e))
        finally:
            if pool:
                pool.shutdown(cancel_futures=True)

    q: queue_lib.Queue = queue_lib.Queue(maxsize=prefetch)
    t = threading.Thread(target=run, args=(q,), daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, _Failed):
                raise item.exc
            yield item
    finally:
        stop.set()                 # closed or collected: the thread ends
        t.join(timeout=30)
