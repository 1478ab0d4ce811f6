"""Moving latents along an editing boundary (InterfaceGAN style).

Only ``linear_interpolate`` is ported so far (the serving path's
``edit_strip`` uses it); boundary training comes with the editing slice.
"""

from __future__ import annotations

import numpy as np


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
