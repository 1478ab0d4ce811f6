"""InterfaceGAN-style semantic boundaries
(``transeditor_tpu/edit/boundary.py``).

Reference behaviour (our_interfaceGAN/train_boundary.py:5-139,
linear_interpolation.py:4-48): rank the samples by attribute score, take
the top/bottom 2% as positive/negative classes, fit a linear SVM, return
the unit-norm normal as the editing direction; edits move a latent along
that normal over a linspace of signed distances, with 2-D codes first
re-centered by their current projection onto the boundary.

The ranking and the train/val split run on the host in numpy, as in the
JAX package, so the split indices are bit-identical; the SVM fit, which
the JAX package leaves to scikit-learn's libsvm, is the port's own C-SVC
solver on the device (``edit/linear_svc.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from transeditor_tpu_torch.edit.linear_svc import fit_linear_svc


def train_boundary(
    latents: np.ndarray,
    scores: np.ndarray,
    chosen_ratio: float = 0.02,
    split_ratio: float = 0.7,
    invalid_value=None,
    seed: int = 0,
    verbose: bool = True,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Fit a linear SVM (C = 1) separating high- vs low-scoring latents,
    on ``device`` (default cuda).

    Args:
      latents: [N, D] flattened latent codes.
      scores: [N] or [N, 1] attribute scores.
      chosen_ratio: fraction (of N) used for each class; values > 1 are
        treated as absolute counts.  Capped at N//2.

    Returns:
      [1, D] unit-norm boundary normal (positive side = higher score).
    """
    latents = np.asarray(latents)
    scores = np.asarray(scores).reshape(-1)
    if latents.ndim != 2 or latents.shape[0] != scores.shape[0]:
        raise ValueError(
            f"latents must be [N,D] with matching scores; got "
            f"{latents.shape} vs {scores.shape}")
    if invalid_value is not None:
        keep = scores != invalid_value
        latents, scores = latents[keep], scores[keep]

    n, dim = latents.shape
    order = np.argsort(-scores)
    chosen = int(n * chosen_ratio) if 0 < chosen_ratio <= 1 \
        else int(chosen_ratio)
    chosen = max(1, min(chosen, n // 2))

    rng = np.random.RandomState(seed)
    top = order[:chosen]
    bottom = order[-chosen:]
    n_train = max(1, int(chosen * split_ratio))

    def split(idx):
        perm = rng.permutation(len(idx))
        return idx[perm[:n_train]], idx[perm[n_train:]]

    pos_tr, pos_va = split(top)
    neg_tr, neg_va = split(bottom)

    x_tr = np.concatenate([latents[pos_tr], latents[neg_tr]])
    y_tr = np.concatenate([np.ones(len(pos_tr)), np.zeros(len(neg_tr))])

    clf = fit_linear_svc(x_tr, y_tr, device=device)

    if verbose:
        def accuracy(x, y):
            return (clf.predict(x).cpu().numpy() == y).mean()

        msg = f"boundary: train acc {accuracy(x_tr, y_tr):.4f}"
        if len(pos_va) and len(neg_va):
            x_va = np.concatenate([latents[pos_va], latents[neg_va]])
            y_va = np.concatenate([np.ones(len(pos_va)),
                                   np.zeros(len(neg_va))])
            msg += f", val acc {accuracy(x_va, y_va):.4f}"
        print(msg)

    normal = clf.coef.cpu().numpy().reshape(1, dim).astype(np.float32)
    return normal / np.linalg.norm(normal)


def linear_interpolate(
    latent: np.ndarray,
    boundary: np.ndarray,
    start_distance: float = -3.0,
    end_distance: float = 3.0,
    steps: int = 10,
) -> np.ndarray:
    """Move one latent along a boundary normal.

    latent: [1, D] (re-centered: distances are absolute projections)
    or [1, L, D] (plus/W+ spaces: the offset is added to every layer,
    distances relative).  Returns [steps, ...].
    """
    latent = np.asarray(latent, np.float32)
    boundary = np.asarray(boundary, np.float32)
    if latent.shape[0] != 1 or boundary.shape[0] != 1 or boundary.ndim != 2 \
            or boundary.shape[1] != latent.shape[-1]:
        raise ValueError(f"bad shapes {latent.shape} / {boundary.shape}")

    dists = np.linspace(start_distance, end_distance, steps)
    if latent.ndim == 2:
        dists = dists - latent @ boundary.T  # current projection removed
        return latent + dists.reshape(-1, 1).astype(np.float32) * boundary
    if latent.ndim == 3:
        return latent + dists.reshape(-1, 1, 1).astype(np.float32) \
            * boundary.reshape(1, 1, -1)
    raise ValueError(f"latent must be 2-D or 3-D, got {latent.ndim}-D")
