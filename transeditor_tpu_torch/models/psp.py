"""The pSp dual-space encoder and its wrapper, ``transeditor_tpu/models/psp.py``.

Reference ``pSp/models/encoders/psp_encoders_new.py:11-209`` and
``pSp/models/psp_new.py:30-178``.  ``GradualStyleEncoder`` is an IR-SE-50
trunk with taps at body units 6 / 20 / 23, an FPN merge
(``latlayer1/2``, bilinear with ``align_corners=True``), ``style_count``
heads over three pyramid levels mixed by ``adjust_style`` (14 -> 16
along the token axis) into Z tokens, and ``spatial_count`` heads off the
coarsest map as P tokens.  Module names are the reference keys
(``styles.{j}.convs.{0,2,..}``, ``styles.{j}.linear``, ``spatials.{j}``,
``latlayer1/2``, ``adjust_style``, ``output_layer_2.{0,3}``), so a pSp
state dict (its ``encoder.`` prefix stripped) loads with ``strict=True``.

Images are NHWC in [-1, 1]; tokens [B, 16, 512].  Convolutions, pools,
the bilinear resize and the linears are library calls.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from transeditor_tpu_torch.invert.projector import estimate_latent_stats
from transeditor_tpu_torch.models.irse import (BatchNorm2d, IRSEBackbone,
                                               _nchw, _nhwc)
from transeditor_tpu_torch.nn.layers import EqualLinear


def _bilinear(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    return F.interpolate(x, size=(oh, ow), mode="bilinear",
                         align_corners=True)


def bilinear_align_corners(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """NHWC bilinear resize with ``align_corners=True`` (the FPN merge,
    psp_encoders_new.py:100-101)."""
    return _nhwc(_bilinear(_nchw(x), oh, ow))


class GradualStyleBlock(nn.Module):
    """log2(spatial) stride-2 3x3 convs, each followed by leaky ReLU 0.01,
    then ``EqualLinear`` -> one ``out_c`` token
    (psp_encoders_new.py:11-32)."""

    def __init__(self, in_c: int, out_c: int, spatial: int):
        super().__init__()
        layers = []
        for i in range(int(math.log2(spatial))):
            layers += [nn.Conv2d(in_c if i == 0 else out_c, out_c, 3, 2, 1),
                       nn.LeakyReLU(0.01)]
        self.convs = nn.Sequential(*layers)
        self.linear = EqualLinear(out_c, out_c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(self.convs(x).flatten(1))


class GradualStyleEncoder(IRSEBackbone):
    """Image [B, H, W, 3] -> (Z tokens [B, S, C], P tokens [B, S, C]),
    S = ``spatial_count``, C = ``head_channels``.  The fields are the JAX
    module's; ``head_channels`` is the heads' width, the reference's 512
    (narrower only to test against a narrow decoder, as
    ``ModelConfig.max_channels`` is)."""

    def __init__(self, num_layers: int = 50, mode: str = "ir_se",
                 style_count: int = 14, coarse_ind: int = 3,
                 middle_ind: int = 7, spatial_count: int = 16,
                 head_channels: int = 512):
        super().__init__(num_layers, mode, taps=(6, 20, 23))
        self.style_count, self.coarse_ind = style_count, coarse_ind
        self.middle_ind, self.spatial_count = middle_ind, spatial_count
        c = head_channels
        self.styles = nn.ModuleList(
            GradualStyleBlock(512, c, 16 if j < coarse_ind
                              else 32 if j < middle_ind else 64)
            for j in range(style_count))
        self.latlayer1 = nn.Conv2d(256, 512, 1)
        self.latlayer2 = nn.Conv2d(128, 512, 1)
        self.adjust_style = EqualLinear(style_count, spatial_count)
        self.spatials = nn.ModuleList(
            GradualStyleBlock(512, c, 16) for _ in range(spatial_count))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        (c1, c2, c3), _ = self.trunk(_nchw(x), self.taps)
        p2 = _bilinear(c3, *c2.shape[2:]) + self.latlayer1(c2)
        p1 = _bilinear(p2, *c1.shape[2:]) + self.latlayer2(c1)
        levels = [c3 if j < self.coarse_ind else
                  p2 if j < self.middle_ind else p1
                  for j in range(self.style_count)]
        z = torch.stack([head(f) for head, f in zip(self.styles, levels)], 1)
        # adjust_style mixes the heads into tokens along the token axis
        z = self.adjust_style(z.transpose(1, 2)).transpose(1, 2)
        p = torch.stack([head(c3) for head in self.spatials], 1)
        return z, p


class BackboneEncoderIntoW(IRSEBackbone):
    """Trunk -> global average pool -> EqualLinear -> one 512-d w
    (psp_encoders_new.py:143-173)."""

    def __init__(self, num_layers: int = 50, mode: str = "ir_se"):
        super().__init__(num_layers, mode, taps=())
        self.linear = EqualLinear(512, 512)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, x = self.trunk(_nchw(x))
        return self.linear(x.mean(dim=(2, 3)))


class BackboneEncoderIntoWPlus(IRSEBackbone):
    """Trunk -> BN -> AdaptiveAvgPool2d(7, 7) -> flatten (channel-major)
    -> Linear -> EqualLinear(512 * n_styles) -> [B, n_styles, 512]
    (psp_encoders_new.py:176-209).  At 256px the trunk's map is 16x16,
    so the pool is a true 16 -> 7 adaptive pool."""

    def __init__(self, num_layers: int = 50, mode: str = "ir_se",
                 n_styles: int = 18):
        super().__init__(num_layers, mode, taps=())
        self.n_styles = n_styles
        self.output_layer_2 = nn.Sequential(
            BatchNorm2d(512), nn.AdaptiveAvgPool2d((7, 7)), nn.Flatten(),
            nn.Linear(512 * 7 * 7, 512))
        self.linear = EqualLinear(512, 512 * n_styles)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, x = self.trunk(_nchw(x))
        x = self.linear(self.output_layer_2(x))
        return x.reshape(x.shape[0], self.n_styles, 512)


class PSPModel:
    """Encoder + frozen decoder (the pSp wrapper, psp_new.py:30-178).
    ``latent_avg``: the (z, p) plus-space averages [T, D] added to the
    encoder's tokens when ``start_from_latent_avg``."""

    def __init__(self, encoder: GradualStyleEncoder, decoder: nn.Module,
                 latent_avg: Optional[Sequence[torch.Tensor]] = None,
                 start_from_latent_avg: bool = True):
        self.encoder, self.decoder = encoder, decoder
        self.latent_avg = None if latent_avg is None else tuple(latent_avg)
        self.start_from_latent_avg = start_from_latent_avg

    def encode(self, images: torch.Tensor):
        z, p = self.encoder(images)
        if self.start_from_latent_avg and self.latent_avg is not None:
            z = z + self.latent_avg[0][None]
            p = p + self.latent_avg[1][None]
        return z, p

    def decode(self, z: torch.Tensor, p: torch.Tensor,
               from_plus_space: bool = True) -> torch.Tensor:
        return self.decoder(z, p, map_z=not from_plus_space,
                            map_p=not from_plus_space).image

    @torch.no_grad()
    def estimate_latent_avg(self, seed: int | torch.Generator = 0,
                            n_samples: int = 10_000, chunk: int = 1000,
                            draws: Optional[Sequence] = None):
        """Plus-space averages (z [T, D], p [T, D]) of mapped random
        draws (psp_new.py:137-178), on the decoder's device.  ``draws``:
        the chunks' (z, p) pairs in place of ``n_samples // chunk`` draws
        from ``seed`` (a generator on the decoder's device, or the seed
        of a new one)."""
        z_mean, _, p_mean = estimate_latent_stats(
            self.decoder, seed, n_samples, chunk, draws=draws)
        return z_mean, p_mean
