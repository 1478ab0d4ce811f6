"""Precision / Recall / Density / Coverage
(``transeditor_tpu/metrics/prdc.py``; the reference's k = 3 protocol).

Manifold estimation by k-NN radii, streamed: each pass walks row chunks
of a squared-distance matrix, one [chunk, D] x [D, N] matmul (float32,
TF32 off: the JAX package asks for ``Precision.HIGHEST``) and a row
reduction a chunk, so peak device memory is O(row_chunk * N) and the
50k-sample protocol never holds an [N, N] matrix.

Semantics, as in the JAX package:
  * a radius is the distance to the k-th nearest OTHER point: index k of
    the ascending row, which holds the point itself at 0;
  * every ball membership is a strict ``<`` on squared distances;
  * the four values are counts divided in float64 (the JAX package takes
    numpy means of host arrays), so the port's and JAX's are equal when
    their counts are.
Rows are sliced, not padded, so no padded real row (radius -1 in the JAX
scan) exists here.
"""

from __future__ import annotations

import numpy as np
import torch

from transeditor_tpu_torch.device import resolve_device
from transeditor_tpu_torch.ops.precision import conv_precision


def _sq_dists(rows: torch.Tensor, x: torch.Tensor,
              x_sq: torch.Tensor) -> torch.Tensor:
    """|rows_i - x_j|^2 by the matmul expansion, clamped at 0."""
    r_sq = (rows * rows).sum(dim=1)
    d = r_sq[:, None] + x_sq[None, :] - 2.0 * (rows @ x.T)
    return d.clamp_min(0.0)


def _float32_on(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dev, torch.float32)
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)


def _chunks(n: int, chunk: int):
    return [(s, min(s + chunk, n)) for s in range(0, n, chunk)]


def knn_sq_radii(x: torch.Tensor, k: int, chunk: int) -> torch.Tensor:
    """Squared distance of each row of ``x`` to its k-th nearest other
    row (index k of the ascending row), [N]."""
    x_sq = (x * x).sum(dim=1)
    out = torch.empty(x.shape[0], dtype=x.dtype, device=x.device)
    for s, e in _chunks(x.shape[0], chunk):
        d = _sq_dists(x[s:e], x, x_sq)
        out[s:e] = torch.topk(d, k + 1, dim=1, largest=False,
                              sorted=True).values[:, k]
    return out


def compute_prdc(real_features, fake_features, nearest_k: int = 3,
                 row_chunk: int = 2048,
                 device: str | torch.device | None = None) -> dict:
    """dict(precision, recall, density, coverage) of [N, D] real and fake
    features (arrays or tensors) on ``device`` (default cuda)."""
    dev = resolve_device(device)
    conv_precision(torch.float32)
    real, fake = (_float32_on(f, dev) for f in (real_features,
                                                fake_features))
    n_real, n_fake = real.shape[0], fake.shape[0]
    chunk = int(max(1, min(row_chunk, n_real, n_fake)))

    with torch.no_grad():
        real_radii = knn_sq_radii(real, nearest_k, chunk)
        fake_radii = knn_sq_radii(fake, nearest_k, chunk)
        fake_sq = (fake * fake).sum(dim=1)
        in_real_ball = torch.zeros(n_fake, dtype=torch.bool, device=dev)
        n_balls = torch.zeros(n_fake, dtype=torch.int64, device=dev)
        recall = torch.empty(n_real, dtype=torch.bool, device=dev)
        cover = torch.empty(n_real, dtype=torch.bool, device=dev)
        for s, e in _chunks(n_real, chunk):
            d = _sq_dists(real[s:e], fake, fake_sq)        # [chunk, Nf]
            rrad = real_radii[s:e]
            contains = d < rrad[:, None]           # real ball i ∋ fake j
            in_real_ball |= contains.any(dim=0)
            n_balls += contains.sum(dim=0)
            recall[s:e] = (d < fake_radii[None, :]).any(dim=1)
            cover[s:e] = d.min(dim=1).values < rrad
        counts = torch.stack([in_real_ball.sum(), recall.sum(),
                              n_balls.sum(), cover.sum()]).tolist()
    prec, rec, dens, cov = counts
    return dict(
        precision=float(prec / n_fake),
        recall=float(rec / n_real),
        density=float(dens / n_fake / nearest_k),
        coverage=float(cov / n_real),
    )
