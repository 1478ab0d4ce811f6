"""IR-SE ResNet backbones (ArcFace style), ``transeditor_tpu/models/irse.py``.

The trunk of the pSp dual-space encoder and the ArcFace network of the
ID loss (reference ``pSp/models/encoders/helpers.py`` and
``model_irse.py``).  Modules carry the InsightFace names
(``input_layer.{0,1,2}``, ``body.{i}.shortcut_layer.{0,1}``,
``body.{i}.res_layer.{0..5}`` with ``res_layer.5.fc1/fc2``,
``output_layer.{0,3,4}``), so a reference state dict loads with
``strict=True``.

Public inputs and outputs are NHWC, as in the JAX package; inside, the
permuted (channels-last) NCHW view goes to cuDNN.  The convolutions are
library calls, as the JAX package's are XLA ops outside any Pallas
kernel.

BatchNorm follows the JAX package (flax), not ``torch.nn``: in training
the running variance moves toward the *biased* batch variance, where
``nn.BatchNorm2d`` takes the unbiased one (n / (n - 1) larger).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from transeditor_tpu_torch.nn.layers import EqualLinear
from transeditor_tpu_torch.ops.precision import conv_precision

BLOCK_SPECS = {
    50: [(64, 64, 3), (64, 128, 4), (128, 256, 14), (256, 512, 3)],
    100: [(64, 64, 3), (64, 128, 13), (128, 256, 30), (256, 512, 3)],
    152: [(64, 64, 3), (64, 128, 8), (128, 256, 36), (256, 512, 3)],
}


def unit_list(num_layers: int) -> List[Tuple[int, int, int]]:
    """Flatten block specs to (in_ch, depth, stride) units."""
    units = []
    for in_ch, depth, n in BLOCK_SPECS[num_layers]:
        units.append((in_ch, depth, 2))
        units.extend((depth, depth, 1) for _ in range(n - 1))
    return units


@torch.no_grad()
def init_weights(module: nn.Module, rng: torch.Generator) -> nn.Module:
    """Redraw ``module``'s convs, linears and ``EqualLinear``s from
    ``rng`` with torch's default initialisers (``EqualLinear``: N(0, 1) /
    lr_mul).  Norms and PReLUs keep their constant inits.  Returns
    ``module``."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=rng)
            if m.bias is not None:
                bound = 1 / math.sqrt(m.weight[0].numel())
                nn.init.uniform_(m.bias, -bound, bound, generator=rng)
        elif isinstance(m, EqualLinear):
            m.weight.copy_(torch.randn(m.weight.shape, generator=rng)
                           / m.lr_mul)
    return module


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class _FlaxStats:
    """BatchNorm with flax's running statistics (momentum 0.9 there, 0.1
    here): a training call normalises with the batch statistics and moves
    the running mean and the running *biased* variance toward them.  An
    eval call reads the running statistics.  The state-dict keys are
    ``torch.nn``'s, ``num_batches_tracked`` included."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        dims = [0] + list(range(2, x.dim()))
        with torch.no_grad():
            var, mean = torch.var_mean(
                x.to(torch.promote_types(x.dtype, torch.float32)), dim=dims,
                unbiased=False)
            m = self.momentum
            self.running_mean.copy_(self.running_mean * (1 - m) + mean * m)
            self.running_var.copy_(self.running_var * (1 - m) + var * m)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True,
                            0.0, self.eps)


class BatchNorm2d(_FlaxStats, nn.BatchNorm2d):
    pass


class BatchNorm1d(_FlaxStats, nn.BatchNorm1d):
    pass


class SEModule(nn.Module):
    """Squeeze-excitation (helpers.py:57-73): ``fc1`` / ``fc2`` 1x1 convs
    without bias."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, channels // reduction, 1, bias=False)
        self.fc2 = nn.Conv2d(channels // reduction, channels, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.fc2(F.relu(self.fc1(s)))
        return x * torch.sigmoid(s)


class BottleneckIRSE(nn.Module):
    """bottleneck_IR / bottleneck_IR_SE (helpers.py:76-120).  With
    ``in_ch == depth`` the shortcut is the stride subsample
    (``MaxPool2d(1, stride)``, no parameters)."""

    def __init__(self, in_ch: int, depth: int, stride: int,
                 use_se: bool = True):
        super().__init__()
        self.stride = stride
        if in_ch == depth:
            self.shortcut_layer = None
        else:
            self.shortcut_layer = nn.Sequential(
                nn.Conv2d(in_ch, depth, 1, stride, bias=False),
                BatchNorm2d(depth))
        res = [BatchNorm2d(in_ch),
               nn.Conv2d(in_ch, depth, 3, 1, 1, bias=False),
               nn.PReLU(depth),
               nn.Conv2d(depth, depth, 3, stride, 1, bias=False),
               BatchNorm2d(depth)]
        if use_se:
            res.append(SEModule(depth))
        self.res_layer = nn.Sequential(*res)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.shortcut_layer is None:
            shortcut = x[:, :, ::self.stride, ::self.stride]
        else:
            shortcut = self.shortcut_layer(x)
        return self.res_layer(x) + shortcut


class IRSEBackbone(nn.Module):
    """The trunk: ``input_layer`` (3x3 conv, BN, PReLU) and the flattened
    bottleneck ``body``.  Calling it returns the NHWC activations after
    body units ``taps`` and the final body output (pSp taps 6 / 20 / 23,
    psp_encoders_new.py:109-117).  Subclasses add their heads; their
    state-dict keys keep ``input_layer.*`` and ``body.*`` at the top."""

    def __init__(self, num_layers: int = 50, mode: str = "ir_se",
                 taps: Sequence[int] = (6, 20, 23)):
        super().__init__()
        if mode not in ("ir", "ir_se"):
            raise ValueError(f"mode must be 'ir' or 'ir_se', got {mode!r}")
        self.num_layers, self.mode, self.taps = num_layers, mode, tuple(taps)
        self.input_layer = nn.Sequential(
            nn.Conv2d(3, 64, 3, 1, 1, bias=False), BatchNorm2d(64),
            nn.PReLU(64))
        self.body = nn.Sequential(*[
            BottleneckIRSE(i, d, s, use_se=(mode == "ir_se"))
            for i, d, s in unit_list(num_layers)])

    def trunk(self, x: torch.Tensor, taps: Sequence[int] = ()):
        """NCHW trunk: (activations after ``taps``, final output)."""
        conv_precision(x.dtype)
        x = self.input_layer(x)
        outs = {}
        for i, unit in enumerate(self.body):
            x = unit(x)
            if i in taps:
                outs[i] = x
        return [outs[i] for i in taps], x

    def forward(self, x: torch.Tensor):
        taps, x = self.trunk(_nchw(x), self.taps)
        return [_nhwc(t) for t in taps], _nhwc(x)


class ArcFaceBackbone(IRSEBackbone):
    """The recognition network (model_irse.py Backbone, 112px input):
    trunk, then ``output_layer`` (BN, flatten channel-major, Linear to
    512, BN1d) and unit-length normalisation with ``max(norm, 1e-12)``.
    ``output_layer.1`` is an identity where the reference has a Dropout
    (the JAX network has none; the ID loss runs it in eval mode).
    ``mode="ir", num_layers=100`` is the IR-101 of the image metrics."""

    def __init__(self, num_layers: int = 50, mode: str = "ir_se"):
        super().__init__(num_layers, mode, taps=())
        self.output_layer = nn.Sequential(
            BatchNorm2d(512), nn.Identity(), nn.Flatten(),
            nn.Linear(512 * 7 * 7, 512), BatchNorm1d(512))

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """The trunk's NCHW output -> unit-length embeddings [B, 512]."""
        x = self.output_layer(x)              # NCHW flatten: channel-major
        norm = torch.linalg.vector_norm(x, dim=1, keepdim=True)
        return x / norm.clamp_min(1e-12)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.trunk(_nchw(x))[1])
