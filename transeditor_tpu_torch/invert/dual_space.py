"""DualSpaceEncoder: the inference wrapper of a trained encoder
(``transeditor_tpu/invert/dual_space.py``; reference
dual_space_encoder.py:12-32): ``encode(images) -> (z, p)`` plus-space
tokens, ``decode(z, p, plus_space) -> images``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from transeditor_tpu_torch.invert.projector import _device_of, _tensor
from transeditor_tpu_torch.models.generator import Generator
from transeditor_tpu_torch.models.psp import GradualStyleEncoder, PSPModel


class DualSpaceEncoder:
    """``encoder`` (eval mode) and the frozen ``decoder``, on the
    decoder's device.  Without ``latent_avg`` (z [T, D], p [T, D]) and
    with ``start_from_latent_avg``, the average is estimated from 10k
    mapped draws of a generator seeded with ``seed``."""

    def __init__(self, decoder: Generator, encoder: GradualStyleEncoder,
                 latent_avg: Optional[Sequence] = None,
                 start_from_latent_avg: bool = True,
                 seed: int | torch.Generator = 0):
        self.dev = _device_of(decoder)
        if _device_of(encoder) != self.dev:
            raise ValueError(f"the encoder is on {_device_of(encoder)}, "
                             f"the decoder on {self.dev}")
        self.psp = PSPModel(encoder.eval(), decoder.eval())
        if latent_avg is None and start_from_latent_avg:
            latent_avg = self.psp.estimate_latent_avg(seed)
        if latent_avg is not None:
            self.psp.latent_avg = tuple(_tensor(a, self.dev)
                                        for a in latent_avg)

    @torch.no_grad()
    def encode(self, images):
        """[-1, 1] NHWC images -> (z, p) plus-space tokens [B, 16, 512],
        numpy float32."""
        z, p = self.psp.encode(_tensor(images, self.dev))
        return z.float().cpu().numpy(), p.float().cpu().numpy()

    @torch.no_grad()
    def decode(self, z, p, plus_space: bool = True) -> np.ndarray:
        img = self.psp.decode(_tensor(z, self.dev), _tensor(p, self.dev),
                              from_plus_space=plus_space)
        return img.float().cpu().numpy()
