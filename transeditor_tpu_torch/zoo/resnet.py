"""ResNet-18 feature trunk in torchvision's layout
(``transeditor_tpu/zoo/resnet.py``).

Used by the pose classifier (reference
``our_interfaceGAN/ffhq_utils/dex/models.py:74-89``: resnet18 minus the
final fc, + Linear(512, n_class) + softmax).  The trunk is an
``nn.Sequential`` whose indices are those of
``nn.Sequential(*resnet18().children()[:-1])``: 0 conv1, 1 bn1, 2 relu,
3 maxpool, 4-7 layer1-4 (two ``BasicBlock``s each), 8 the global average
pool; so such a state dict loads with ``strict=True``.  Inference only:
BatchNorm always normalises by its running statistics (eps 1e-5), as the
JAX trunk does with ``train=False``.  Input NHWC, output [B, 512].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from transeditor_tpu_torch.ops.precision import conv_precision

PLAN = ((64, 1), (128, 2), (256, 2), (512, 2))   # (width, stride) a layer


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (same parameters, buffers and keys) that always
    normalises by its running statistics, in ``train()`` mode too."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class BasicBlock(nn.Module):
    """torchvision's ``BasicBlock`` (NCHW): conv3x3-bn-relu-conv3x3-bn,
    plus a 1x1 conv + bn ``downsample`` where the shape changes."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = FrozenBatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False),
                FrozenBatchNorm2d(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(y)) + identity)


class ResNet18Features(nn.Sequential):
    """conv1..layer4 + global average pool: NHWC [B, H, W, 3] -> [B, 512]."""

    def __init__(self):
        layers, cin = [], 64
        for cout, stride in PLAN:
            layers.append(nn.Sequential(BasicBlock(cin, cout, stride),
                                        BasicBlock(cout, cout)))
            cin = cout
        super().__init__(
            nn.Conv2d(3, 64, 7, 2, 3, bias=False), FrozenBatchNorm2d(64),
            nn.ReLU(), nn.MaxPool2d(3, 2, 1),        # pads with -inf
            *layers, nn.AdaptiveAvgPool2d(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv_precision(x.dtype)
        return super().forward(x.permute(0, 3, 1, 2)).flatten(1)
