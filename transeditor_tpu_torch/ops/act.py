"""Fused bias + LeakyReLU activation, as plain torch ops.

``leaky_relu(x + bias, 0.2) * sqrt(2)`` with the bias on the last axis
(NHWC images, [B, T, D] tokens), as ``transeditor_tpu/ops/act.py``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_SQRT2 = math.sqrt(2.0)


def fused_leaky_relu(x: torch.Tensor, bias: torch.Tensor | None = None,
                     negative_slope: float = 0.2,
                     scale: float = _SQRT2) -> torch.Tensor:
    """``leaky_relu(x + bias, slope) * scale``, bias broadcast on the
    last axis and cast to ``x.dtype``."""
    if bias is not None:
        x = x + bias.to(x.dtype)
    return F.leaky_relu(x, negative_slope) * scale


def scaled_leaky_relu(x: torch.Tensor,
                      negative_slope: float = 0.2) -> torch.Tensor:
    """Bias-free variant."""
    return F.leaky_relu(x, negative_slope) * _SQRT2
