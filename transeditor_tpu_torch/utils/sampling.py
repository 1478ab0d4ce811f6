"""Latent samplers drawing from an explicit ``torch.Generator``.

Token tensors are [B, T, D] (tokens-major), as in
``transeditor_tpu/utils/sampling.py``.  The tensors land on the
generator's device.  ``same=True`` repeats one draw across the batch.
"""

from __future__ import annotations

import torch


def sample_tokens(rng: torch.Generator, batch: int, n_tokens: int = 16,
                  dim: int = 512, truncation: float = 1.0,
                  same: bool = False,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, T, D] standard-normal tokens (optionally batch-repeated)."""
    rows = 1 if same else batch
    out = torch.randn((rows, n_tokens, dim), generator=rng,
                      device=rng.device, dtype=dtype)
    if same:
        out = out.expand(batch, n_tokens, dim)
    if truncation != 1.0:
        out = out * truncation
    return out


def sample_zp(rng: torch.Generator, batch: int, n_tokens: int = 16,
              dim: int = 512, truncation: float = 1.0, z_same: bool = False,
              p_same: bool = False, dtype: torch.dtype = torch.float32):
    """Draw a (Z, P) pair, Z first, from the same generator."""
    z = sample_tokens(rng, batch, n_tokens, dim, truncation, z_same, dtype)
    p = sample_tokens(rng, batch, n_tokens, dim, truncation, p_same, dtype)
    return z, p
