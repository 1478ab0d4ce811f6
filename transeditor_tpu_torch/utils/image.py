"""Image conversion helpers."""

from __future__ import annotations

import numpy as np


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[-1,1] float NHWC -> uint8 NHWC."""
    img = np.asarray(img, dtype=np.float32)
    return np.clip((img + 1.0) * 127.5 + 0.5, 0, 255).astype(np.uint8)
