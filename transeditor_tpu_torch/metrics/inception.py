"""InceptionV3 pool3 features for FID
(``transeditor_tpu/metrics/inception.py``).

pytorch-fid's InceptionV3 (torchvision's blocks with the FID pooling
quirks: 3x3 average pools with ``count_include_pad=False`` in the A, C
and E blocks, a max pool in the last E block), inference only, with each
BatchNorm folded into a per-channel scale and bias when the weights are
loaded (``load_fid_inception``, eps 1e-3, as the JAX porter folds them).
A ``ConvBN`` is conv (no bias), ``* scale + bias``, ReLU, in that order.

Inputs are [-1, 1] NHWC images of any size; ``resize_input`` takes them
to 299x299 with ``F.interpolate(bilinear, align_corners=False)``, which
does not antialias even when it downscales (the JAX package's
``jax.image.resize(..., antialias=False)``).  The output is the spatial
mean of Mixed_7c, [N, 2048].  The network runs NCHW inside; convs and
pools are library calls, as the JAX package's are ``lax`` ops outside
any Pallas kernel.  Float32 runs with TF32 off (``ops/precision.py``).

Parameter names follow the JAX tree: ``Mixed_5b.branch1x1.weight``
([O, I, kh, kw]), ``.scale``, ``.bias``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from transeditor_tpu_torch.device import resolve_device
from transeditor_tpu_torch.ops.precision import conv_precision

Pad = Tuple[int, int]
BN_EPS = 1e-3           # pytorch-fid's BatchNorm eps, folded at load


class ConvBN(nn.Module):
    """BasicConv2d with its BatchNorm folded: conv, ``* scale + bias``,
    ReLU.  ``padding`` is (rows, cols)."""

    def __init__(self, cin: int, cout: int, kernel: Pad,
                 stride: int = 1, padding: Pad = (0, 0)):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(cout, cin, *kernel))
        self.scale = nn.Parameter(torch.ones(cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.weight, None, self.stride, self.padding)
        return F.relu(y * self.scale[:, None, None]
                      + self.bias[:, None, None])


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 max pool over VALID windows (NCHW)."""
    return F.max_pool2d(x, 3, 2)


def max_pool_3x3_s1_p1(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 max pool, padded by 1 with -inf (Mixed_7c)."""
    return F.max_pool2d(x, 3, 1, 1)


def avg_pool_3x3_s1_p1_nocountpad(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 average pool padded by 1 that divides by the number of
    real pixels in each window (``count_include_pad=False``)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


_P1 = (1, 1)
_P17, _P71 = (0, 3), (3, 0)
_P13, _P31 = (0, 1), (1, 0)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = ConvBN(cin, 64, (1, 1))
        self.branch5x5_1 = ConvBN(cin, 48, (1, 1))
        self.branch5x5_2 = ConvBN(48, 64, (5, 5), padding=(2, 2))
        self.branch3x3dbl_1 = ConvBN(cin, 64, (1, 1))
        self.branch3x3dbl_2 = ConvBN(64, 96, (3, 3), padding=_P1)
        self.branch3x3dbl_3 = ConvBN(96, 96, (3, 3), padding=_P1)
        self.branch_pool = ConvBN(cin, pool_features, (1, 1))

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(avg_pool_3x3_s1_p1_nocountpad(x))
        return torch.cat([self.branch1x1(x), b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = ConvBN(cin, 384, (3, 3), stride=2)
        self.branch3x3dbl_1 = ConvBN(cin, 64, (1, 1))
        self.branch3x3dbl_2 = ConvBN(64, 96, (3, 3), padding=_P1)
        self.branch3x3dbl_3 = ConvBN(96, 96, (3, 3), stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, max_pool_3x3_s2(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = ConvBN(cin, 192, (1, 1))
        self.branch7x7_1 = ConvBN(cin, c7, (1, 1))
        self.branch7x7_2 = ConvBN(c7, c7, (1, 7), padding=_P17)
        self.branch7x7_3 = ConvBN(c7, 192, (7, 1), padding=_P71)
        self.branch7x7dbl_1 = ConvBN(cin, c7, (1, 1))
        self.branch7x7dbl_2 = ConvBN(c7, c7, (7, 1), padding=_P71)
        self.branch7x7dbl_3 = ConvBN(c7, c7, (1, 7), padding=_P17)
        self.branch7x7dbl_4 = ConvBN(c7, c7, (7, 1), padding=_P71)
        self.branch7x7dbl_5 = ConvBN(c7, 192, (1, 7), padding=_P17)
        self.branch_pool = ConvBN(cin, 192, (1, 1))

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(avg_pool_3x3_s1_p1_nocountpad(x))
        return torch.cat([self.branch1x1(x), b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = ConvBN(cin, 192, (1, 1))
        self.branch3x3_2 = ConvBN(192, 320, (3, 3), stride=2)
        self.branch7x7x3_1 = ConvBN(cin, 192, (1, 1))
        self.branch7x7x3_2 = ConvBN(192, 192, (1, 7), padding=_P17)
        self.branch7x7x3_3 = ConvBN(192, 192, (7, 1), padding=_P71)
        self.branch7x7x3_4 = ConvBN(192, 192, (3, 3), stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for i in range(2, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, max_pool_3x3_s2(x)], dim=1)


class InceptionE(nn.Module):
    """``pool`` is "avg" in Mixed_7b and "max" in Mixed_7c (FID)."""

    def __init__(self, cin: int, pool: str = "avg"):
        super().__init__()
        self.pool = pool
        self.branch1x1 = ConvBN(cin, 320, (1, 1))
        self.branch3x3_1 = ConvBN(cin, 384, (1, 1))
        self.branch3x3_2a = ConvBN(384, 384, (1, 3), padding=_P13)
        self.branch3x3_2b = ConvBN(384, 384, (3, 1), padding=_P31)
        self.branch3x3dbl_1 = ConvBN(cin, 448, (1, 1))
        self.branch3x3dbl_2 = ConvBN(448, 384, (3, 3), padding=_P1)
        self.branch3x3dbl_3a = ConvBN(384, 384, (1, 3), padding=_P13)
        self.branch3x3dbl_3b = ConvBN(384, 384, (3, 1), padding=_P31)
        self.branch_pool = ConvBN(cin, 192, (1, 1))

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       dim=1)
        bp = (max_pool_3x3_s1_p1(x) if self.pool == "max"
              else avg_pool_3x3_s1_p1_nocountpad(x))
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)],
                         dim=1)


def _init_random(module: nn.Module, rng: torch.Generator) -> None:
    """The JAX package's initialisers: conv weights N(0, 0.1), scales 1,
    biases 0."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("weight"):
                p.copy_(torch.randn(p.shape, generator=rng) * 0.1)
            else:
                p.fill_(1.0 if name.endswith("scale") else 0.0)


class InceptionV3Features(nn.Module):
    """[-1, 1] NHWC images (any H x W) -> [N, 2048] pool3 features.
    Built on ``device`` (default "cuda"; raises without a card unless
    "cpu") with seeded random weights; load real ones with
    ``load_fid_inception``."""

    def __init__(self, resize_input: bool = True, *,
                 device: str | torch.device | None = None, seed: int = 0):
        dev = resolve_device(device)
        super().__init__()
        self.resize_input = resize_input
        self.Conv2d_1a_3x3 = ConvBN(3, 32, (3, 3), stride=2)
        self.Conv2d_2a_3x3 = ConvBN(32, 32, (3, 3))
        self.Conv2d_2b_3x3 = ConvBN(32, 64, (3, 3), padding=_P1)
        self.Conv2d_3b_1x1 = ConvBN(64, 80, (1, 1))
        self.Conv2d_4a_3x3 = ConvBN(80, 192, (3, 3))
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")
        if dev.type != "meta":
            _init_random(self, torch.Generator().manual_seed(seed))
            self.to(dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv_precision(x.dtype)
        # contiguous NCHW: cuDNN's float32 convs are NCHW kernels, and a
        # channels-last view costs a layout conversion around every conv
        x = x.permute(0, 3, 1, 2).contiguous()
        if self.resize_input:
            x = F.interpolate(x, size=(299, 299), mode="bilinear",
                              align_corners=False, antialias=False)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = max_pool_3x3_s2(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = max_pool_3x3_s2(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


def conv_names(net: nn.Module) -> Sequence[str]:
    """The dotted names of ``net``'s ``ConvBN``s (``Mixed_5b.branch1x1``)."""
    return [n for n, m in net.named_modules() if isinstance(m, ConvBN)]


def fold_fid_batchnorms(sd: Mapping, names: Sequence[str]
                        ) -> Dict[str, torch.Tensor]:
    """A pytorch-fid state dict (``{name}.conv.weight``,
    ``{name}.bn.{weight,bias,running_mean,running_var}``; values tensors
    or arrays) -> the port's ``{name}.{weight,scale,bias}`` for each
    ``names``, BN folded in float32 numpy as the JAX porter folds it:
    ``scale = gamma / sqrt(var + BN_EPS)``, ``bias = beta - mean * scale``.
    Other keys (``fc.*``, ``num_batches_tracked``) are not read.  Raises
    ``KeyError`` naming the first missing key of a conv of the net."""
    def arr(key):
        if key not in sd:
            raise KeyError(f"the InceptionV3 state dict has no {key!r}")
        v = sd[key]
        return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    out = {}
    for name in names:
        w = arr(f"{name}.conv.weight")
        gamma, beta = arr(f"{name}.bn.weight"), arr(f"{name}.bn.bias")
        mean = arr(f"{name}.bn.running_mean")
        var = arr(f"{name}.bn.running_var")
        scale = gamma / np.sqrt(var + BN_EPS)
        bias = beta - mean * scale
        out[f"{name}.weight"] = torch.from_numpy(np.array(w, np.float32))
        out[f"{name}.scale"] = torch.from_numpy(scale.astype(np.float32))
        out[f"{name}.bias"] = torch.from_numpy(bias.astype(np.float32))
    return out


def load_fid_inception(sd_or_path, resize_input: bool = True
                       ) -> InceptionV3Features:
    """A pytorch-fid InceptionV3 checkpoint (``pt_inception-2015-12-05``;
    a path, or its loaded dict) -> ``InceptionV3Features`` on the CPU in
    eval mode, BN folded (``fold_fid_batchnorms``)."""
    from transeditor_tpu_torch.io.checkpoint import read_torch_file

    sd = (read_torch_file(sd_or_path) if isinstance(sd_or_path, str)
          else sd_or_path)
    with torch.device("meta"):
        net = InceptionV3Features(resize_input, device="meta")
    folded = fold_fid_batchnorms(sd, conv_names(net))
    net.load_state_dict(folded, strict=True, assign=True)
    return net.eval()
