"""CelebA-HQ attribute classifiers (gan-ensembling stack)
(``transeditor_tpu/edit/celebahq_classifier.py``).

Reference: ``our_interfaceGAN/celebahq_utils/dex/networks/classifiers/
attribute_classifier.py`` — a ProGAN-discriminator-shaped binary
classifier (wscale conv blocks, avg-pool downscale with
conv->bias->downscale->act ordering, fixed-size fromRGB, no
minibatch-std) at 256px, one logit; scored as
``softmax([logit, -logit])[:, 1]`` after box-downsampling inputs to 256
(attribute_utils.py:8-31).  40 CelebA attributes, one checkpoint each.

The modules carry the reference key layout (``fromrgb_lod0.conv.conv.
weight``, ``{R}x{R}.conv{0,1}.wscale.b``, ``4x4.dense{0,1}.linear.
weight``), so a reference state dict loads with ``strict=True``.  Public
inputs are NHWC.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from transeditor_tpu_torch.ops.precision import conv_precision

# The 40 CelebA attributes in the reference's sweep order
# (edit_all_noinversion_celebahq.py:25-66); index into this list is the
# reference's --attribute_index.
CELEBAHQ_ATTRIBUTES = [
    "Male", "Smiling", "Attractive", "Wavy_Hair", "Young",
    "5_o_Clock_Shadow", "Arched_Eyebrows", "Bags_Under_Eyes", "Bald",
    "Bangs", "Big_Lips", "Big_Nose", "Black_Hair", "Blond_Hair",
    "Blurry", "Brown_Hair", "Bushy_Eyebrows", "Chubby", "Double_Chin",
    "Eyeglasses", "Goatee", "Gray_Hair", "Heavy_Makeup",
    "High_Cheekbones", "Mouth_Slightly_Open", "Mustache", "Narrow_Eyes",
    "No_Beard", "Oval_Face", "Pale_Skin", "Pointy_Nose",
    "Receding_Hairline", "Rosy_Cheeks", "Sideburns", "Straight_Hair",
    "Wearing_Earrings", "Wearing_Hat", "Wearing_Lipstick",
    "Wearing_Necklace", "Wearing_Necktie",
]


def _nf(stage: int, fmap_base=8192, fmap_max=512) -> int:
    return min(int(fmap_base / (2.0 ** stage)), fmap_max)


class _WScale(nn.Module):
    """The reference's ``wscale`` layer: its bias ``b``."""

    def __init__(self, features: int):
        super().__init__()
        self.b = nn.Parameter(torch.zeros(features))


class WScaleConv(nn.Module):
    """``conv`` (no bias) scaled by gain / sqrt(fan_in), + ``wscale.b``
    (NCHW inside the classifier)."""

    def __init__(self, cin: int, features: int, kernel: int,
                 padding: int = 0, gain: float = math.sqrt(2)):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, kernel, 1, padding, bias=False)
        self.wscale = _WScale(features)
        self.scale = gain / math.sqrt(cin * kernel * kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x) * self.scale + self.wscale.b.view(1, -1, 1, 1)


class WScaleDense(nn.Module):
    """``linear`` (no bias) scaled by gain / sqrt(fan_in), + ``wscale.b``."""

    def __init__(self, cin: int, features: int, gain: float = math.sqrt(2)):
        super().__init__()
        self.linear = nn.Linear(cin, features, bias=False)
        self.wscale = _WScale(features)
        self.scale = gain / math.sqrt(cin)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x) * self.scale + self.wscale.b


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean, stride 2 (NCHW)."""
    return F.avg_pool2d(x, 2, 2)


def _act(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class _FromRGB(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv = WScaleConv(3, features, 1)


class _Block(nn.Module):
    def __init__(self, cin: int, mid: int, cout: int):
        super().__init__()
        self.conv0 = WScaleConv(cin, mid, 3, 1)
        self.conv1 = WScaleConv(mid, cout, 3, 1)


class _Head(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.conv = WScaleConv(cin, _nf(1), 3, 1)
        self.dense0 = WScaleDense(_nf(1) * 16, _nf(0))
        self.dense1 = WScaleDense(_nf(0), 1, gain=1.0)


class CelebAHQAttributeClassifier(nn.Module):
    """256px binary attribute net: NHWC [B, 256, 256, 3] -> raw logit
    [B].  Children ``fromrgb_lod0``, ``256x256`` .. ``8x8``, ``4x4``."""

    def __init__(self, resolution: int = 256):
        super().__init__()
        self.log2res = int(math.log2(resolution))
        self.fromrgb_lod0 = _FromRGB(_nf(self.log2res - 1))
        cin = _nf(self.log2res - 1)
        for res in range(self.log2res, 2, -1):
            self.add_module(f"{2 ** res}x{2 ** res}",
                            _Block(cin, _nf(res - 1), _nf(res - 2)))
            cin = _nf(res - 2)
        self.add_module("4x4", _Head(cin))

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = _act(self.fromrgb_lod0.conv(img.permute(0, 3, 1, 2)))
        for res in range(self.log2res, 2, -1):
            blk = getattr(self, f"{2 ** res}x{2 ** res}")
            x = _act(blk.conv0(x))
            # conv -> bias -> downscale -> act ordering (reference :98-106)
            x = _act(avg_pool2(blk.conv1(x)))
        head = getattr(self, "4x4")
        x = _act(head.conv(x)).flatten(1)            # channel-major
        x = _act(head.dense0(x))
        return head.dense1(x)[:, 0]


def box_downsample_256(img: torch.Tensor) -> torch.Tensor:
    """Resize NHWC images to the classifier's fixed 256px: factor-mean
    downsample (attribute_utils.py:8-19) for larger inputs; nearest
    upsample for smaller ones (the reference never feeds <256, but small
    dev generators do)."""
    h = img.shape[1]
    if h == 256:
        return img
    if h < 256:
        f = 256 // h
        return img.repeat_interleave(f, dim=1).repeat_interleave(f, dim=2)
    f = h // 256
    b, _, _, c = img.shape
    return img.reshape(b, 256, f, 256, f, c).mean(dim=(2, 4))


def _celebahq_score(net, img):
    conv_precision(img.dtype)
    logit = net(box_downsample_256(img))
    return torch.softmax(torch.stack([logit, -logit], -1), dim=-1)[:, 1]


def make_celebahq_scorer(net: CelebAHQAttributeClassifier,
                         device: str | torch.device | None = None):
    """[-1,1] RGB NHWC -> (N,) softmaxed attribute scores
    (attribute_utils.get_softmaxed), as a ``classifiers.Scorer`` on
    ``device`` (default cuda)."""
    from transeditor_tpu_torch.edit.classifiers import Scorer
    return Scorer(_celebahq_score, net, device)
