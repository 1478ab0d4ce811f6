"""FID: feature statistics and the Fréchet distance
(``transeditor_tpu/metrics/fid.py``).

Float64 numpy and scipy on the host, the port's own copy of the JAX
package's code: (mean, covariance) of [N, D] features, and
d² = |m1 - m2|² + Tr(C1 + C2 - 2 sqrtm(C1 C2)) with pytorch-fid's eps
offset for singular products and its refusal of a materially imaginary
square root.  The feature extractor is ``metrics/inception.py``.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np


def compute_stats(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(mean, covariance) of [N, D] features (float64)."""
    feats = np.asarray(features, np.float64)
    mean = feats.mean(axis=0)
    cov = np.cov(feats, rowvar=False)
    return mean, cov


def _sqrtm(m: np.ndarray) -> np.ndarray:
    """``scipy.linalg.sqrtm(m, disp=False)``'s root; SciPy releases that
    drop ``disp`` return the root alone."""
    import scipy.linalg

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        try:
            return scipy.linalg.sqrtm(m, disp=False)[0]
        except TypeError:
            return scipy.linalg.sqrtm(m)


def frechet_distance(mean1, cov1, mean2, cov2, eps: float = 1e-6) -> float:
    """d² = |m1-m2|² + Tr(C1 + C2 - 2·sqrtm(C1·C2))."""
    mean1, mean2 = np.asarray(mean1), np.asarray(mean2)
    cov1, cov2 = np.asarray(cov1), np.asarray(cov2)

    cc = _sqrtm(cov1 @ cov2)
    if not np.isfinite(cc).all():
        # regularise singular covariances, as pytorch-fid does
        offset = np.eye(cov1.shape[0]) * eps
        cc = _sqrtm((cov1 + offset) @ (cov2 + offset))
    if np.iscomplexobj(cc):
        # a materially imaginary sqrtm means the stats are bad: fail
        # rather than report a wrong FID
        if not np.allclose(np.diagonal(cc).imag, 0, atol=1e-3):
            raise ValueError(
                f"Imaginary component {np.max(np.abs(cc.imag))}")
        cc = cc.real
    diff = mean1 - mean2
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2)
                 - 2 * np.trace(cc))


def fid_from_features(gen_features: np.ndarray, real_mean, real_cov) -> float:
    """FID of [N, D] features against cached real statistics."""
    mean, cov = compute_stats(gen_features)
    return frechet_distance(mean, cov, real_mean, real_cov)

