"""Attribute classifiers for editing sweeps
(``transeditor_tpu/edit/classifiers.py``).

Reference: ``our_interfaceGAN/ffhq_utils/dex/{models,api}.py`` —
  * DEX VGG16 heads: Age (101-way softmax, scored by expectation over
    ages 1..101, api.py:42-58) and Gender (2-way);
  * pose: torchvision resnet18 trunk + Linear(512, 2) + softmax;
  * inputs are center-cropped to 224 (api.py:49-52).

The modules carry the reference key layouts (DEX: ``conv.{b}.conv{i}``,
``fc1.0``, ``fc2.0``, ``cls``; pose: ``backbone.{0,1,4..7}``,
``extra_layer``), so a reference state dict loads with ``strict=True``;
the JAX package's transposing porters have no counterpart here.  Public
inputs are NHWC, as in the JAX package.  The classifiers run in float32
with TF32 off (``ops/precision.py``), as the JAX scorer is fed float32
images (``edit/sweep.py:78,145``).
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from transeditor_tpu_torch.device import resolve_device
from transeditor_tpu_torch.ops.precision import conv_precision
from transeditor_tpu_torch.zoo.resnet import ResNet18Features

# (width, convs) of the five DEX VGG16 blocks, each closed by a 2x2 pool
VGG_PLAN = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
FC_WIDTH = 4096


class _VGGBlock(nn.Module):
    """``conv1`` .. ``conv{n}`` (3x3, pad 1, each + relu), then a 2x2 max
    pool."""

    def __init__(self, cin: int, cout: int, n_convs: int):
        super().__init__()
        for c in range(n_convs):
            self.add_module(f"conv{c + 1}",
                            nn.Conv2d(cin if c == 0 else cout, cout, 3, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.children():
            x = F.relu(conv(x))
        return F.max_pool2d(x, 2, 2)


class DexVGG(nn.Module):
    """DEX VGG16 (conv blocks + 2 fc + cls head + softmax) on 224px NHWC
    BGR 0..255 inputs."""

    def __init__(self, classes: int = 101):
        super().__init__()
        blocks, cin = [], 3
        for feat, n_convs in VGG_PLAN:
            blocks.append(_VGGBlock(cin, feat, n_convs))
            cin = feat
        self.conv = nn.ModuleList(blocks)
        self.fc1 = nn.Sequential(nn.Linear(cin * 7 * 7, FC_WIDTH), nn.ReLU())
        self.fc2 = nn.Sequential(nn.Linear(FC_WIDTH, FC_WIDTH), nn.ReLU())
        self.cls = nn.Linear(FC_WIDTH, classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv_precision(x.dtype)
        x = x.permute(0, 3, 1, 2)
        for block in self.conv:
            x = block(x)
        x = self.fc2(self.fc1(x.flatten(1)))        # channel-major flatten
        return torch.softmax(self.cls(x), dim=-1)


class PoseClassifier(nn.Module):
    """resnet18 trunk (``backbone``) + Linear(512, n_class) + softmax."""

    def __init__(self, n_class: int = 2):
        super().__init__()
        self.backbone = ResNet18Features()
        self.extra_layer = nn.Linear(512, n_class)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self.extra_layer(self.backbone(x)), dim=-1)


def center_crop_224(img: torch.Tensor) -> torch.Tensor:
    """Center crop to 224 (api.py:49-52).  Below 224px the offset is
    negative and the slice clamps, as the JAX package's does."""
    h = img.shape[1]
    off = (h - 224) // 2
    return img[:, off:off + 224, off:off + 224, :]


def expected_age(probs: torch.Tensor) -> torch.Tensor:
    """Softmax expectation over ages 1..101 (api.py:42-47)."""
    ages = torch.arange(1, probs.shape[-1] + 1, dtype=probs.dtype,
                        device=probs.device)
    return torch.sum(probs * ages, dim=-1)


def dex_preprocess(img: torch.Tensor) -> torch.Tensor:
    """[-1,1] RGB NHWC -> BGR 0..255 rounded + 224 center crop — the
    exact feed the DEX nets expect (edit_all_noinversion_ffhq.py:113-116,
    api.py:49-52).  ``torch.round`` rounds half to even, as ``jnp.round``."""
    x = torch.round((img.clamp(-1, 1) + 1) * 127.5)
    return center_crop_224(torch.flip(x, dims=[-1]))


class Scorer:
    """Image -> attribute-score callable holding its network, eval and
    frozen, on its device.  Takes [-1,1] RGB NHWC images (numpy or a
    tensor; moved to the device as float32) and returns the [B] scores as
    a float32 tensor on the device."""

    def __init__(self, fn: Callable[[nn.Module, torch.Tensor], torch.Tensor],
                 net: nn.Module, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.net = net.to(self.device).eval().requires_grad_(False)
        self.fn = fn                      # fn(net, img) -> [B]

    def __call__(self, img) -> torch.Tensor:
        x = torch.as_tensor(img).to(self.device, torch.float32)
        with torch.no_grad():
            return self.fn(self.net, x)


def _dex_age(net, img):
    return expected_age(net(dex_preprocess(img)))


def _first_class(net, img):
    return net(dex_preprocess(img))[:, 0]


def classifier_module(attribute: str) -> nn.Module:
    """The classifier of ``attribute``, dispatched as
    ``load_scorer_from_checkpoint`` does: DEX VGG16 for age (101 classes)
    and gender (2), resnet18 for pose, the CelebA-HQ attribute net for
    anything else.  Built with torch's default initialisers."""
    if attribute in ("age", "gender"):
        return DexVGG(classes=101 if attribute == "age" else 2)
    if attribute == "pose":
        return PoseClassifier()
    from transeditor_tpu_torch.edit.celebahq_classifier import (
        CelebAHQAttributeClassifier)
    return CelebAHQAttributeClassifier()


def random_classifier(attribute: str, rng: torch.Generator) -> nn.Module:
    """``classifier_module(attribute)`` on the CPU with weights drawn
    from ``rng``: convs and linears by torch's default initialisers,
    except in the CelebA-HQ net's wscale layers, whose weights and biases
    are N(0, 1) as the JAX package initialises them; BatchNorms at their
    constant inits."""
    from transeditor_tpu_torch.edit.celebahq_classifier import _WScale
    from transeditor_tpu_torch.models.irse import init_weights

    with torch.device("meta"):
        net = classifier_module(attribute)
    net.to_empty(device="cpu")
    with torch.no_grad():
        init_weights(net, rng)
        for m in net.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            elif isinstance(m, _WScale):
                m.b.normal_(generator=rng)
            elif hasattr(m, "wscale"):
                layer = m.conv if hasattr(m, "conv") else m.linear
                layer.weight.normal_(generator=rng)
    return net


def make_scorer(attribute: str, net: nn.Module,
                device: str | torch.device | None = None) -> Scorer:
    """A Scorer of ``net`` (a ``DexVGG`` or ``PoseClassifier``) on
    ``device`` (default cuda): [-1,1] RGB NHWC images -> [B] scores.

    attribute in {'age', 'gender', 'pose'}.
    """
    if attribute == "age":
        return Scorer(_dex_age, net, device)
    if attribute in ("gender", "pose"):
        return Scorer(_first_class, net, device)
    raise ValueError(attribute)


def classifier_from_state_dict(attribute: str,
                               sd: Mapping[str, torch.Tensor]) -> nn.Module:
    """``classifier_module(attribute)`` on the CPU, holding ``sd``'s
    tensors (``strict=True``; no initialiser runs)."""
    with torch.device("meta"):
        net = classifier_module(attribute)
    net.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()},
                        strict=True, assign=True)
    return net


def make_attribute_scorer(attribute: str, net: nn.Module,
                          device: str | torch.device | None = None
                          ) -> Scorer:
    """The Scorer of any attribute's ``net``: DEX / pose through
    ``make_scorer``, CelebA-HQ attributes through
    ``make_celebahq_scorer``."""
    if attribute in ("age", "gender", "pose"):
        return make_scorer(attribute, net, device)
    from transeditor_tpu_torch.edit.celebahq_classifier import (
        make_celebahq_scorer)
    return make_celebahq_scorer(net, device)


def load_scorer_from_checkpoint(attribute: str, path: str,
                                device: str | torch.device | None = None
                                ) -> Scorer:
    """Load a torch classifier checkpoint (a reference-layout state dict)
    and build its Scorer on ``device`` (default cuda), dispatched on the
    attribute name: DEX VGG16 for age/gender (api.py:15-18), resnet18 for
    pose (models.py:78-89), and the CelebA-HQ ProGAN-D attribute nets for
    anything else (domain_classifier.py:4-36)."""
    from transeditor_tpu_torch.io.checkpoint import read_torch_file

    net = classifier_from_state_dict(attribute, read_torch_file(path))
    return make_attribute_scorer(attribute, net, device)
