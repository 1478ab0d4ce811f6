"""LPIPS perceptual distance (``transeditor_tpu/zoo/lpips.py``).

Both LPIPS stacks of the reference:
  * richzhang 'net-lin' (PNetLin vgg / alex: the projector's loss, PPL,
    the encoder's metrics): the per-sample distance is the sum over the
    tapped layers of the spatial mean of the 1x1-reweighted squared
    differences of unit-normalised features;
  * the StarGAN-v2 variant (the LPIPS diversity metric): the same with
    AlexNet.

Inputs are [-1, 1] NHWC; the scaling layer (shift [-.030, -.088, -.188],
scale [.458, .448, .450]) is applied inside.  As in the JAX package:
features are normalised as ``x * rsqrt(sum x^2 + 1e-10)``, the heads are
applied as ``|w|``, and ``use_linear=False`` takes the mean over H, W
and C.

Parameter names: ``backbone.features.{idx}.*`` (torchvision indices) and
the heads ``lin0`` .. ``lin4``, each [C] (kept, unread, when
``use_linear`` is False).  ``load_lpips_params`` turns a richzhang or
StarGAN-v2 checkpoint into that layout; ``LPIPS.load_state_dict`` then
takes it with ``strict=True``.
"""

from __future__ import annotations

import warnings
from typing import Dict, Literal, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from transeditor_tpu_torch.device import resolve_device
from transeditor_tpu_torch.io.checkpoint import read_torch_file
from transeditor_tpu_torch.zoo.backbones import (VGG16_CFG, VGG16_TAPS,
                                                 AlexNetFeatures, VGGFeatures)

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

ALEX_CHANNELS = (64, 192, 384, 256, 256)
VGG_CHANNELS = (64, 128, 256, 512, 512)


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(dim=-1, keepdim=True) + eps)


def _random_init(module: nn.Module, rng: torch.Generator) -> None:
    """The JAX package's initialisers: conv weights N(0, 0.1), biases 0,
    heads 1 (the projector CLI's 'random LPIPS')."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.startswith("lin"):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=rng) * 0.1)


class LPIPS(nn.Module):
    """Per-sample LPIPS distance [B] (float32) between two [-1, 1] NHWC
    image batches.  Built on ``device`` (default "cuda"; raises without a
    card unless "cpu") with seeded random weights (``_random_init``);
    load real ones with ``load_lpips_params``."""

    def __init__(self, net: Literal["alex", "vgg"] = "alex",
                 use_linear: bool = True, *,
                 device: str | torch.device | None = None, seed: int = 0):
        dev = resolve_device(device)
        super().__init__()
        if net not in ("alex", "vgg"):
            raise ValueError(f"net must be 'alex' or 'vgg', got {net!r}")
        self.net, self.use_linear = net, use_linear
        if net == "alex":
            self.backbone = AlexNetFeatures()
            channels = ALEX_CHANNELS
        else:
            self.backbone = VGGFeatures(VGG16_CFG, VGG16_TAPS)
            channels = VGG_CHANNELS
        for i, c in enumerate(channels):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.ones(c)))
        # the scaling layer's constants, outside the state dict
        self.register_buffer("shift", torch.tensor(_SHIFT), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE), persistent=False)
        _random_init(self, torch.Generator().manual_seed(seed))
        self.to(dev)

    def _scaled(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.shift.to(x.dtype)) / self.scale.to(x.dtype)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        fx = self.backbone(self._scaled(x))
        fy = self.backbone(self._scaled(y))
        total = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
        for i, (a, b) in enumerate(zip(fx, fy)):
            d = (_unit_normalize(a) - _unit_normalize(b)) ** 2
            if self.use_linear:
                w = getattr(self, f"lin{i}").abs().to(d.dtype)
                layer = (d * w).sum(dim=-1).mean(dim=(1, 2))
            else:
                layer = d.mean(dim=(1, 2, 3))
            total = total + layer.float()
        return total


def _tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.asarray(v))


def _features_of(sd: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """``{prefix}{idx}.{weight,bias}`` -> ``backbone.features.{idx}.*``."""
    return {f"backbone.features.{k[len(prefix):]}": _tensor(v)
            for k, v in sd.items() if k.startswith(prefix)}


def load_lpips_params(sd: Mapping, net: str = "alex",
                      backbone_sd: Optional[Mapping] = None,
                      ) -> Dict[str, torch.Tensor]:
    """A torch LPIPS checkpoint as an ``LPIPS(net)`` state dict (CPU).

    Accepts the richzhang layout (``lin{i}.model.1.weight`` plus a
    torchvision backbone under ``features.*``) or the StarGAN-v2 layout
    (``alexnet.layers.{idx}.*`` plus ``lpips_weights.{i}.main.1.weight``).
    Both reference distributions ship only the heads: pass the
    torchvision state dict of the backbone as ``backbone_sd``.  With
    neither, the backbone is random (``LPIPS``'s seeded init; the heads
    are still loaded) and a warning says so: fine for a smoke run, not
    for reportable metric values.  Values may be tensors or arrays.
    """
    if any(k.startswith("alexnet.layers.") for k in sd):
        out = _features_of(sd, "alexnet.layers.")
    elif any(k.startswith("features.") for k in sd):
        out = _features_of(sd, "features.")
    elif backbone_sd is not None:
        out = _features_of(backbone_sd, "features.")
    else:
        warnings.warn("LPIPS checkpoint has only linear heads and no "
                      "backbone_sd given: the backbone is RANDOM init")
        rand = LPIPS(net=net, device="cpu").state_dict()
        out = {k: v for k, v in rand.items() if k.startswith("backbone.")}
    for i in range(5):
        for key in (f"lpips_weights.{i}.main.1.weight",
                    f"lin{i}.model.1.weight"):
            if key in sd:
                out[f"lin{i}"] = _tensor(sd[key]).reshape(-1)
                break
        else:
            raise KeyError(f"no linear head {i} in checkpoint")
    return out


def load_lpips(path: Optional[str], net: str,
               device: str | torch.device | None = None,
               backbone_path: Optional[str] = None, seed: int = 0) -> LPIPS:
    """``LPIPS(net)`` on ``device`` in eval mode with the weights of the
    torch checkpoint ``path`` (``load_lpips_params``; the backbone from
    the torchvision state dict ``backbone_path`` when ``path`` holds only
    the heads), or with the random weights seeded ``seed`` when ``path``
    is None.  A caller that falls back to random weights says so itself."""
    lpips = LPIPS(net=net, device=device, seed=seed)
    if path:
        backbone = read_torch_file(backbone_path) if backbone_path else None
        lpips.load_state_dict(load_lpips_params(
            read_torch_file(path), net=net, backbone_sd=backbone),
            strict=True)
    return lpips.eval()


def lpips_pairwise_diversity(lpips: nn.Module,
                             groups: Sequence) -> float:
    """StarGAN-v2 diversity: the mean over pairs i < j of the batch-mean
    LPIPS between outputs ``groups[i]`` and ``groups[j]`` ([B, H, W, 3]
    each, arrays or tensors), on the module's device."""
    dev = next(lpips.parameters()).device
    vals = []
    with torch.no_grad():
        for i in range(len(groups) - 1):
            for j in range(i + 1, len(groups)):
                a, b = (_tensor(g).to(dev) for g in (groups[i], groups[j]))
                vals.append(float(lpips(a, b).mean()))
    return float(np.mean(vals))
