"""Reading reference-layout ``.pt`` checkpoints.

The reference saves ``{'g', 'd', 'g_ema', 'g_optim', 'd_optim'}``
bundles of state dicts.  The port names its parameters as those keys,
so a generator state dict loads into ``Generator`` unchanged.
"""

from __future__ import annotations

from typing import Dict

import torch

from transeditor_tpu_torch.config import ModelConfig


def load_reference_generator(pt_path: str, cfg: ModelConfig,
                             key: str = "g_ema") -> Dict[str, torch.Tensor]:
    """The ``key`` generator state dict of a reference ``.pt`` bundle
    (CPU tensors).  Raises if its synthesis depth is not ``cfg.size``'s."""
    ckpt = torch.load(pt_path, map_location="cpu", weights_only=True)
    if key not in ckpt:
        raise KeyError(f"{pt_path} has no {key!r} (keys: {sorted(ckpt)})")
    sd = ckpt[key]
    last = cfg.log_size - 3                  # index of the last ToRGB
    if (f"to_rgbs.{last}.conv.weight" not in sd
            or f"to_rgbs.{last + 1}.conv.weight" in sd):
        raise ValueError(f"{pt_path}[{key!r}] is not a {cfg.size}px "
                         f"generator")
    return sd
