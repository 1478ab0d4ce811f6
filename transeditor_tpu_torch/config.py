"""Model and training hyper-parameters for the PyTorch port.

The same dataclasses as ``transeditor_tpu/config.py``'s ``ModelConfig``
and ``TrainConfig``, without JAX: the derived invariants
(``token_dim``/``n_latent`` 14, ``num_layers`` 13, the ``channels``
table, ``num_mappings``, ``ema_decay``) are computed once here and
``compute_dtype`` returns a ``torch.dtype``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Generator architecture configuration (defaults: the 256px model)."""

    size: int = 256                     # output resolution
    style_dim: int = 512                # Z token feature dim (--latent)
    param_dim: int = 512                # P token feature dim
    n_tokens: int = 16                  # tokens per space (--para_num)
    channel_multiplier: int = 2
    blur_kernel: Sequence[int] = (1, 3, 3, 1)
    lr_mlp: float = 0.01                # mapping-net lr multiplier
    layer_noise_injection: bool = False  # --inject_noise
    use_spatial_mapping: bool = True     # not --no_spatial_map
    num_region: int = 1
    n_trans: int = 8                     # --num_trans
    # 'feature' == reference --pixel_norm_op_dim 1 (normalise over the
    # feature axis); 'token' == dim 2.
    pixel_norm_axis: str = "feature"
    no_trans: bool = False
    attn_groups: int = 4
    attn_compress: int = 4
    # test-only knob: cap synthesis channel counts so unit tests run on
    # the CPU quickly.  512 == reference behaviour.
    max_channels: int = 512
    # compute dtype of the whole forward; parameters are always float32
    dtype: str = "float32"
    # int8 synthesis convs are not ported yet; kept so configs carry over
    quantize: str | None = None

    @property
    def log_size(self) -> int:
        return int(math.log2(self.size))

    @property
    def token_dim(self) -> int:
        """Number of per-layer style vectors (14 @ 256px)."""
        return 2 * (self.log_size - 1)

    @property
    def n_latent(self) -> int:
        return self.log_size * 2 - 2

    @property
    def num_layers(self) -> int:
        """Number of styled conv layers (13 @ 256px)."""
        return (self.log_size - 2) * 2 + 1

    @property
    def num_mappings(self) -> int:
        """Independent per-token mapping layers (16 / num_region)."""
        return self.n_tokens // self.num_region

    @property
    def channels(self) -> dict[int, int]:
        cm = self.channel_multiplier
        raw = {
            4: 512, 8: 512, 16: 512, 32: 512,
            64: 256 * cm, 128: 128 * cm, 256: 64 * cm,
            512: 32 * cm, 1024: 16 * cm,
        }
        return {k: min(v, self.max_channels) for k, v in raw.items()}

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def __post_init__(self):
        if self.size & (self.size - 1):
            raise ValueError(f"size must be a power of two, got {self.size}")
        if self.pixel_norm_axis not in ("feature", "token"):
            raise ValueError("pixel_norm_axis must be 'feature' or 'token'")
        if self.n_tokens % self.num_region:
            raise ValueError("n_tokens must be divisible by num_region")
        if self.quantize not in (None, "int8"):
            raise ValueError("quantize must be None or 'int8'")
        if self.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, "
                             f"got {self.dtype!r}")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """GAN training recipe (``transeditor_tpu/config.py``'s
    ``TrainConfig``; reference train_spatial_query.py:381-391)."""

    total_steps: int = 800_000
    batch_size: int = 16                 # batch per step
    lr: float = 0.002
    r1_gamma: float = 10.0               # --r1
    d_reg_every: int = 16
    g_reg_every: int = 4
    path_regularize: float = 2.0
    path_batch_shrink: int = 2
    grad_accum: int = 1                  # microbatches per step (memory knob)
    spatial_regu: bool = False
    spatial_path_regularize: float = 2.0
    regu_space: str = "p+"               # --regu_sapce [sic]
    ema_halflife_kimg: float = 10.0      # accum = 0.5 ** (32 / (10*1000))
    sample_every: int = 500
    checkpoint_every: int = 10_000
    n_sample: int = 64
    seed: int = 0

    @property
    def ema_decay(self) -> float:
        return 0.5 ** (32.0 / (self.ema_halflife_kimg * 1000.0))
