"""StyleGAN2 discriminator as an nn.Module
(``transeditor_tpu/models/discriminator.py``).

NHWC throughout.  ``from_rgb`` (1x1), one residual down block per
resolution from ``size`` to 8, minibatch stddev, a 3x3 conv at 4x4 and
two linear layers.  Parameter and buffer names are the reference ``d``
keys (``convs.0`` is from_rgb, ``convs.{j}`` the res blocks,
``final_conv``, ``final_linear.{0,1}``), so a reference ``d`` state dict
loads with ``strict=True``.  Every blur here is the plain
``ops/resample.py::blur`` (shifted slices, cheap to differentiate twice
for R1): the JAX package computes it in plain jnp.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from transeditor_tpu_torch.config import ModelConfig
from transeditor_tpu_torch.device import resolve_device
from transeditor_tpu_torch.nn.layers import ConvLayer, EqualLinear
from transeditor_tpu_torch.parallel.data_parallel import (all_reduce_sum,
                                                          data_axis)


class ResBlock(nn.Module):
    """Residual down block: two 3x3 convs (the second downsampling) plus
    a 1x1 downsampling skip, summed and scaled by 1/sqrt(2)."""

    def __init__(self, in_ch: int, out_ch: int, *, dtype: torch.dtype,
                 rng: torch.Generator | None = None):
        super().__init__()
        self.conv1 = ConvLayer(in_ch, in_ch, 3, dtype=dtype, rng=rng)
        self.conv2 = ConvLayer(in_ch, out_ch, 3, downsample=True, dtype=dtype,
                               rng=rng)
        self.skip = ConvLayer(in_ch, out_ch, 1, downsample=True, bias=False,
                              activate=False, dtype=dtype, rng=rng)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.conv1(x))
        return (out + self.skip(x)) * (1 / math.sqrt(2))


def _group_size(b: int, group_size: int) -> int:
    g = min(b, group_size)
    while b % g:
        g -= 1
    return g


def minibatch_stddev(x: torch.Tensor, group_size: int = 4,
                     num_features: int = 1, mesh=None) -> torch.Tensor:
    """Append the cross-sample stddev map as extra channels.  The group
    is the largest divisor of the batch not above ``group_size``; the
    variance is biased and taken in float32.

    The groups are strided: sample n of a batch of B falls in group
    n mod (B / g).  When the data axis (``mesh``'s, else the process
    group's) runs collectives, the batch is the global one (data rank r
    holds samples r*b .. r*b + b - 1 of it, as
    ``parallel/data_parallel.py::local_rows`` lays it out), so a group
    spans ranks: see ``_minibatch_stddev_global``."""
    b, h, w, c = x.shape
    if data_axis(mesh)[3]:
        return _minibatch_stddev_global(x, group_size, num_features, mesh)
    g = _group_size(b, group_size)
    y = x.reshape(g, b // g, h, w, num_features,
                  c // num_features).float()
    std = torch.sqrt(y.var(dim=0, unbiased=False) + 1e-8)
    std = std.mean(dim=(1, 2, 4))                  # [b//g, num_features]
    std = std[:, None, None, :].repeat(g, h, w, 1).to(x.dtype)
    return torch.cat([x, std], dim=-1)


def _minibatch_stddev_global(x: torch.Tensor, group_size: int,
                             num_features: int, mesh=None) -> torch.Tensor:
    """``minibatch_stddev`` over the global batch of the data axis
    (every rank holds the same number of samples).  Each group's mean
    and then its centred sum of squares are summed across ranks from
    per-rank partial sums (two differentiable all-reduces, indexed by
    global group), so the result equals the single-process one on the
    whole batch.  Sums into groups and reads back out of them are
    products with a one-hot [groups, b] matrix, which are deterministic
    on the card, forward and backward (index_add is not)."""
    b, h, w, c = x.shape
    world, rank, _, _ = data_axis(mesh)
    g = _group_size(b * world, group_size)
    n_groups = b * world // g
    group = (rank * b + torch.arange(b, device=x.device)) % n_groups
    onehot = (group[None, :] == torch.arange(n_groups, device=x.device)
              [:, None]).float()                        # [groups, b]
    y = x.reshape(b, -1).float()
    mean = all_reduce_sum(onehot @ y, mesh) / g         # [groups, hwc]
    centred = y - onehot.t() @ mean
    var = all_reduce_sum(onehot @ (centred * centred), mesh) / g
    std = torch.sqrt(var + 1e-8).reshape(n_groups, h, w, num_features,
                                         c // num_features)
    std = onehot.t() @ std.mean(dim=(1, 2, 4))          # [b, features]
    std = std[:, None, None, :].expand(b, h, w, num_features)
    return torch.cat([x, std.to(x.dtype)], dim=-1)


class Discriminator(nn.Module):
    """Built on ``device`` (default "cuda"; raises if CUDA is absent and
    the CPU was not asked for) with weights drawn from ``seed``.
    ``forward`` takes NHWC images [B, size, size, 3] and returns logits
    [B, 1].  ``mesh``: the mesh whose data axis holds the global batch of
    the minibatch stddev (``None``: the process group); the train step
    sets it."""

    def __init__(self, cfg: ModelConfig, *,
                 device: str | torch.device | None = None, seed: int = 0):
        dev = resolve_device(device)
        super().__init__()
        self.cfg = cfg
        dtype = cfg.compute_dtype
        rng = torch.Generator().manual_seed(seed)
        ch = cfg.channels

        convs = [ConvLayer(3, ch[cfg.size], 1, dtype=dtype, rng=rng)]
        in_ch = ch[cfg.size]
        for i in range(cfg.log_size, 2, -1):
            out_ch = ch[2 ** (i - 1)]
            convs.append(ResBlock(in_ch, out_ch, dtype=dtype, rng=rng))
            in_ch = out_ch
        self.convs = nn.Sequential(*convs)
        self.final_conv = ConvLayer(in_ch + 1, ch[4], 3, dtype=dtype, rng=rng)
        self.final_linear = nn.Sequential(
            EqualLinear(ch[4] * 4 * 4, ch[4], activation="fused_lrelu",
                        dtype=dtype, rng=rng),
            EqualLinear(ch[4], 1, dtype=dtype, rng=rng))
        self.mesh = None
        self.to(dev)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = self.convs(img.to(self.cfg.compute_dtype))
        x = self.final_conv(minibatch_stddev(x, mesh=self.mesh))
        # channel-major flatten, as the reference's NCHW view
        x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
        return self.final_linear(x)
