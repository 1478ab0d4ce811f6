"""Edit-quality evaluation (the port's copy of
``transeditor_tpu/edit/evaluate.py``; numpy, as there).

Reference: ``our_interfaceGAN/editing_evaluate.py`` (re-score edited
strips with every attribute classifier), ``calculate_score.py:44-72``
(disentanglement = ratio of interest-attribute drift to
changed-attribute drift, averaged over both edit directions),
``calculate_score.py:7-8`` (cosine similarity between boundaries),
``editing_evaluate_id.py:23-25`` (ArcFace ID preservation).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np


def boundary_cosine(b1: np.ndarray, b2: np.ndarray) -> float:
    """Cosine similarity between two editing directions."""
    a = np.asarray(b1).ravel()
    b = np.asarray(b2).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def direction_deltas(traj: Sequence[float]):
    """(positive-direction drift, negative-direction drift) of a score
    trajectory whose center is the unedited image
    (calculate_score.py:51-56 uses windows of a 7-point trajectory —
    generalised to any odd length)."""
    t = np.asarray(traj, np.float64)
    m = len(t) // 2
    pos = float(np.sum(t[m + 1:] - t[m:-1]))
    neg = float(np.sum(t[:m] - t[1:m + 1]))
    return pos, neg


def disentanglement_score(change_trajs: List[Sequence[float]],
                          interest_trajs: List[Sequence[float]]) -> float:
    """mean(|Δinterest/Δchange|) over both directions
    (calculate_score.py:44-72).  Lower = better disentanglement."""
    cp = cn = ip = in_ = 0.0
    n = len(change_trajs)
    for ct, it in zip(change_trajs, interest_trajs):
        p, q = direction_deltas(ct)
        cp += p / n
        cn += q / n
        p, q = direction_deltas(it)
        ip += p / n
        in_ += q / n
    return (abs(ip / cp) + abs(in_ / cn)) / 2 if cp and cn else float("nan")


def score_correlation(change_trajs, interest_trajs) -> float:
    a = np.concatenate([np.asarray(t) for t in change_trajs])
    b = np.concatenate([np.asarray(t) for t in interest_trajs])
    return float(np.corrcoef(a, b)[0, 1])


def id_preservation(embed: Callable, origin_imgs: np.ndarray,
                    edited_imgs: np.ndarray) -> np.ndarray:
    """ArcFace cosine similarity origin vs edited
    (editing_evaluate_id.py:23-25).  embed: [-1,1] NHWC -> [B,512]
    l2-normalised."""
    f0 = to_numpy(embed(origin_imgs))
    f1 = to_numpy(embed(edited_imgs))
    return np.sum(f0 * f1, axis=-1)


def rescore_strips(strip_images: Dict[str, np.ndarray],
                   scorers: Dict[str, Callable]) -> Dict[str, Dict[str, np.ndarray]]:
    """Score every strip with every attribute classifier:
    result[attr][space] = [steps] trajectory."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for attr, scorer in scorers.items():
        out[attr] = {}
        for space, imgs in strip_images.items():
            out[attr][space] = to_numpy(scorer(imgs))
    return out


def to_numpy(x) -> np.ndarray:
    """A scorer's or embedder's output (a tensor on any device, or an
    array) as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)
