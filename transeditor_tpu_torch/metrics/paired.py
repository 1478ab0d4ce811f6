"""Folder-vs-folder paired image metrics: LPIPS / L2 / ID similarity
(``transeditor_tpu/metrics/paired.py``).

The analogue of the reference's encoder-quality scripts
(``pSp/scripts/calc_losses_on_images.py``: LPIPS (alex) or L2 between a
results folder and a ground-truth folder paired by name, a ``.png``
result falling back to the ``.jpg`` ground truth; and
``calc_id_loss_parallel.py``: the IR-101 CurricularFace embedding
cosine of each pair).  Pairs run in fixed-size batches on one device;
the last batch is padded and the padding's scores are dropped, so no
file is skipped.

Images are read without PIL (``utils/image.py::load_image``: PNG, or
JPEG where libjpeg is present) and resized with
``resize_bilinear``, PIL's ``Image.BILINEAR``, when their size differs.
``.webp`` / ``.bmp`` files are paired as the JAX package pairs them but
cannot be read: ``load_image`` raises naming the file.  The ID crop is
the training ID loss's (``train/coach.py::face_crop`` / ``resize_112``).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from transeditor_tpu_torch.device import resolve_device
from transeditor_tpu_torch.utils.image import load_image, resize_bilinear

__all__ = [
    "pair_folders", "load_pair_batch", "make_l2_fn", "make_lpips_fn",
    "make_id_fn", "paired_scores", "write_report",
]

_EXTS = (".jpg", ".jpeg", ".png", ".webp", ".bmp")


def pair_folders(result_dir: str, gt_dir: str) -> List[Tuple[str, str]]:
    """Name-match images in ``result_dir`` to ``gt_dir``: the same file
    name first, then any extension swap within ``_EXTS`` (the reference's
    ``.png`` result -> ``.jpg`` ground truth)."""
    pairs = []
    for f in sorted(os.listdir(result_dir)):
        stem, ext = os.path.splitext(f)
        if ext.lower() not in _EXTS:
            continue
        candidates = [f] + [stem + e for e in _EXTS if e != ext.lower()]
        for cand in candidates:
            gt = os.path.join(gt_dir, cand)
            if os.path.exists(gt):
                pairs.append((os.path.join(result_dir, f), gt))
                break
        else:
            raise FileNotFoundError(
                f"no ground-truth match for {f} under {gt_dir}")
    if not pairs:
        raise ValueError(f"no images under {result_dir}")
    return pairs


def _load_img(path: str, resolution: int) -> np.ndarray:
    img = load_image(path)
    if img.shape[:2] != (resolution, resolution):
        img = resize_bilinear(img, resolution, resolution)
    return img.astype(np.float32) / 127.5 - 1.0


def load_pair_batch(pairs: Sequence[Tuple[str, str]],
                    resolution: int) -> Tuple[np.ndarray, np.ndarray]:
    """[-1, 1] float32 NHWC batches (results, ground truths)."""
    res = np.stack([_load_img(r, resolution) for r, _ in pairs])
    gt = np.stack([_load_img(g, resolution) for _, g in pairs])
    return res, gt


def make_l2_fn() -> Callable:
    """Per-pair MSE over all pixels and channels (torch ``MSELoss``)."""
    def l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return ((a - b) ** 2).mean(dim=(1, 2, 3))
    return l2


def make_lpips_fn(lpips) -> Callable:
    """Per-pair LPIPS distance of an ``LPIPS`` module."""
    def fn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return lpips(a, b)
    return fn


def make_id_fn(arcface) -> Callable:
    """Per-pair cosine of unit-length ArcFace embeddings of the ID crops."""
    from transeditor_tpu_torch.train.coach import face_crop, resize_112

    def fn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        fa = arcface(resize_112(face_crop(a)))
        fb = arcface(resize_112(face_crop(b)))
        return (fa * fb).sum(dim=-1)
    return fn


def paired_scores(score_fn: Callable,
                  pairs: Sequence[Tuple[str, str]],
                  resolution: int = 256,
                  batch_size: int = 8,
                  progress: bool = False,
                  device: str | torch.device | None = None
                  ) -> Dict[str, float]:
    """``score_fn`` over all pairs on ``device`` (default cuda) ->
    {result basename: score}, in fixed-size batches (the last padded with
    its last pair)."""
    dev = resolve_device(device)
    scores: Dict[str, float] = {}
    for start in range(0, len(pairs), batch_size):
        chunk = list(pairs[start:start + batch_size])
        n = len(chunk)
        while len(chunk) < batch_size:       # pad to the fixed shape
            chunk.append(chunk[-1])
        a, b = load_pair_batch(chunk, resolution)
        with torch.no_grad():
            vals = score_fn(torch.from_numpy(a).to(dev),
                            torch.from_numpy(b).to(dev)).cpu().numpy()
        for (rpath, _), v in zip(chunk[:n], vals[:n]):
            scores[os.path.basename(rpath)] = float(v)
        if progress:
            print(f"  {min(start + batch_size, len(pairs))}/{len(pairs)}")
    return scores


def write_report(scores: Dict[str, float], out_dir: str,
                 mode: str) -> Tuple[float, float]:
    """Write ``stat_{mode}.txt`` and ``scores_{mode}.json`` as the
    reference writes them; returns (mean, std)."""
    vals = list(scores.values())
    mean, std = float(np.mean(vals)), float(np.std(vals))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"stat_{mode}.txt"), "w") as f:
        f.write("Average loss is {:.2f}+-{:.2f}".format(mean, std)
                if mode != "id" else
                "New Average score is {:.2f}+-{:.2f}".format(mean, std))
    with open(os.path.join(out_dir, f"scores_{mode}.json"), "w") as f:
        json.dump(scores, f)
    return mean, std
