"""Classic convnet backbones (``transeditor_tpu/zoo/backbones.py``).

Inference feature extractors behind the metric and loss stack:
  * AlexNet: the LPIPS diversity metric and richzhang's 'net-lin alex'
    LPIPS;
  * VGG16: 'net-lin vgg' LPIPS (the projector's loss) and the PRDC fc7
    features (``VGG16Fc7``);
  * VGG19: the reference's VGGLoss (``vgg19_perceptual_loss``).

Modules are ``nn.Module``s whose parameters carry torchvision's names
(``features.{idx}.weight``, ``classifier.{0,3}.weight``), so a
torchvision state dict loads with ``strict=True``; the JAX package's
transposing porters have no counterpart here.  Public inputs and feature
maps are NHWC, as in the JAX package; inside, ``x.permute(0, 3, 1, 2)``
hands cuDNN a channels-last NCHW view, and the outputs are permuted back
(views, no copy).  The convolutions and pools are library calls, as the
JAX package's are ``lax`` ops outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from transeditor_tpu_torch.ops.precision import conv_precision

# VGG configurations: channel list with 'M' = maxpool(2, 2).
VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M")
VGG19_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M")
# relu taps, by 0-based position among the conv layers
VGG16_TAPS = (1, 3, 6, 9, 12)    # relu1_2, 2_2, 3_3, 4_3, 5_3 (LPIPS)
VGG19_TAPS = (0, 2, 4, 8, 12)    # relu1_1, 2_1, 3_1, 4_1, 5_1 (VGGLoss)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: int = 1, padding: int = 0) -> torch.Tensor:
    """NHWC conv with a torch-layout [O, I, kh, kw] weight."""
    conv_precision(x.dtype)
    return _nhwc(F.conv2d(_nchw(x), w, b, stride, padding))


def max_pool(x: torch.Tensor, window: int = 3, stride: int = 2,
             padding: int = 0) -> torch.Tensor:
    """NHWC max pool over VALID windows (``ceil_mode=False``)."""
    return _nhwc(F.max_pool2d(_nchw(x), window, stride, padding))


def adaptive_avg_pool_2d(x: torch.Tensor, out_hw=(7, 7)) -> torch.Tensor:
    """``nn.AdaptiveAvgPool2d`` on NHWC: output cell i averages input rows
    floor(i*n/out) .. ceil((i+1)*n/out) - 1 (so 8x8 -> 7x7 overlaps)."""
    if x.shape[1] < 1 or x.shape[2] < 1:
        raise ValueError(
            f"adaptive_avg_pool_2d got an empty spatial map {tuple(x.shape)} "
            f"(input image too small for an upstream crop?)")
    return _nhwc(F.adaptive_avg_pool2d(_nchw(x), tuple(out_hw)))


def _vgg_layers(cfg: Sequence) -> List[nn.Module]:
    """torchvision's ``make_layers`` (no batch norm): conv, relu, pool."""
    layers, in_ch = [], 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2d(2, 2))
        else:
            layers += [nn.Conv2d(in_ch, v, 3, 1, 1), nn.ReLU()]
            in_ch = v
    return layers


def _run_taps(features: nn.Sequential, x: torch.Tensor,
              taps: Sequence[int]) -> List[torch.Tensor]:
    """Run ``features`` on NHWC ``x`` up to its last tapped relu; the
    outputs of the relus after conv layers ``taps``, NHWC."""
    conv_precision(x.dtype)
    out, conv_idx, h = [], -1, _nchw(x)
    for layer in features:
        h = layer(h)
        if isinstance(layer, nn.Conv2d):
            conv_idx += 1
        elif isinstance(layer, nn.ReLU) and conv_idx in taps:
            out.append(_nhwc(h))
            if len(out) == len(taps):
                break
    return out


class AlexNetFeatures(nn.Module):
    """torchvision AlexNet ``.features`` (indices 0-11; the last max pool,
    12, has no parameters and follows the last tap), returning the five
    relu taps LPIPS reads (relu1 .. relu5)."""

    TAPS = (0, 1, 2, 3, 4)

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 11, 4, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, 1, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(384, 256, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, 1, 1), nn.ReLU())

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return _run_taps(self.features, x, self.TAPS)


class VGGFeatures(nn.Module):
    """torchvision VGG16 / VGG19 ``.features`` with configurable relu
    taps (``VGG16_TAPS`` for LPIPS, ``VGG19_TAPS`` for VGGLoss).  Every
    conv of ``cfg`` is built, so a torchvision state dict loads whole;
    the forward stops at the last tap."""

    def __init__(self, cfg: Sequence = VGG16_CFG,
                 taps: Sequence[int] = VGG16_TAPS):
        super().__init__()
        self.taps = tuple(taps)
        self.features = nn.Sequential(*_vgg_layers(cfg))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return _run_taps(self.features, x, self.taps)


class VGG16Fc7(nn.Module):
    """torchvision VGG16 through classifier fc7 (4096-d ReLU features):
    the PRDC feature space.  ``classifier`` holds entries 0-5 of
    torchvision's (the 1000-way layer, 6, is dropped as the reference
    drops it); Dropout is an identity in inference."""

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(*_vgg_layers(VGG16_CFG))
        self.classifier = nn.Sequential(
            nn.Linear(512 * 7 * 7, 4096), nn.ReLU(), nn.Dropout(),
            nn.Linear(4096, 4096), nn.ReLU(), nn.Dropout())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv_precision(x.dtype)
        # at 256px the map is 8x8, so this is the live 8 -> 7 pool
        h = F.adaptive_avg_pool2d(self.features(_nchw(x)), (7, 7))
        h = torch.flatten(h, 1)                           # channel-major
        fc6, fc7 = self.classifier[0], self.classifier[3]
        return F.relu(fc7(F.relu(fc6(h))))


_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def vgg19_perceptual_loss(features: Callable[[torch.Tensor],
                                             List[torch.Tensor]],
                          x: torch.Tensor, y: torch.Tensor,
                          weights: Optional[Sequence[float]] = None
                          ) -> torch.Tensor:
    """The reference's VGGLoss: weighted L1 over the VGG19 relu taps
    (``VGGFeatures(VGG19_CFG, VGG19_TAPS)``) of normalised [-1, 1] NHWC
    inputs; no gradient flows into ``y``.  Kept as the reference has it:
    the [-1, 1] -> [0, 1] shift applied twice, and ``sqrt(std + 1e-5)``
    as the divisor."""
    weights = weights or [1 / 32, 1 / 16, 1 / 8, 1 / 4, 1.0]
    mean = torch.tensor(_IMAGENET_MEAN, device=x.device)
    std = torch.tensor(_IMAGENET_STD, device=x.device)

    def norm(t):
        t = t * 0.5 + 0.5
        t = t * 0.5 + 0.5
        return (t - mean) / torch.sqrt(std + 1e-5)

    fx = features(norm(x))
    with torch.no_grad():
        fy = features(norm(y))
    loss = x.new_zeros(())
    for w, a, b in zip(weights, fx, fy):
        loss = loss + w * (a - b).abs().mean()
    return loss
