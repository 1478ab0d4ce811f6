"""Plain float32 reference of TransEditor at 256px: the generator and the
StyleGAN2 discriminator.

Written from the published description (TransEditor, Xu et al., CVPR 2022;
StyleGAN2, Karras et al., CVPR 2020): the per-token mapping networks, the
cross-attention interaction, the 16 -> 14 token mix, and the modulated
convolutions in their per-sample-weight form (a grouped convolution with the
style folded into the weight, demodulation folded in too), the up-sampling
conv as a grouped transposed convolution followed by a dense 4x4 FIR blur,
and every FIR filter as a dense 2-D convolution of one channel at a time.

NCHW inside; images in and out are NHWC, as the program takes and returns
them.  Parameter and buffer names are the reference checkpoint's keys, so
one state dict loads into this module and into the program with
``strict=True``.  Only ``torch`` is imported.

``Quant`` lowers the precision on purpose, for the checks' controls
(symmetric fake quantisation to integers or to float8 e4m3, passed straight
through in the backward) with ``scope="all"``: every convolution and linear
layer of both networks, on both operands (a model computed in that format
throughout); in fp8 the gradients flowing back into them are float8 e5m2
too, as fp8 training runs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

SQRT2 = math.sqrt(2.0)


@dataclasses.dataclass(frozen=True)
class Quant:
    bits: int                      # 8 or 4; with fmt "fp8", 8 (e4m3)
    scope: str                     # "all"
    fmt: str = "int"               # "int" or "fp8"


def fake_quant(x: torch.Tensor, quant: Quant, dims) -> torch.Tensor:
    """Symmetric quantisation over ``dims`` (one scale for each index of the
    other dims), dequantised; the gradient passes straight through.  "int":
    ``bits``-bit integers, scale amax / (2**(bits-1) - 1), rounded half to
    even.  "fp8": float8 e4m3, scale amax / 448, rounded to nearest even."""
    xd = x.detach()
    amax = xd.abs().amax(dim=dims, keepdim=True).clamp_min(1e-12)
    if quant.fmt == "fp8":
        s = amax / 448.0
        q = (xd / s).to(torch.float8_e4m3fn).to(xd.dtype) * s
    else:
        qmax = 2 ** (quant.bits - 1) - 1
        s = amax / qmax
        q = torch.clamp(torch.round(xd / s), -qmax, qmax) * s
    return x + (q - xd).detach()


class _GradQuant(torch.autograd.Function):
    """Identity forward; the gradient flowing back is quantised to float8
    e5m2 (per-sample scale), passed straight through again so that a
    double backward goes on."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        gd = g.detach()
        dims = tuple(range(1, g.dim()))
        s = gd.abs().amax(dim=dims, keepdim=True).clamp_min(1e-30) / 57344.0
        q = (gd / s).to(torch.float8_e5m2).to(gd.dtype) * s
        return g + (q - gd)


def quant_grad(y: torch.Tensor, quant) -> torch.Tensor:
    """``y``'s gradient in float8 e5m2 where ``quant`` is fp8 everywhere
    (fp8 training: e4m3 operands forward, e5m2 gradients backward)."""
    if quant is not None and quant.fmt == "fp8" and quant.scope == "all":
        return _GradQuant.apply(y)
    return y


def fir_kernel(taps=(1, 3, 3, 1), gain: float = 1.0) -> torch.Tensor:
    k = torch.tensor(taps, dtype=torch.float32)
    k = torch.outer(k, k)
    return k / k.sum() * gain


def upfirdn(x: torch.Tensor, kernel: torch.Tensor, up: int = 1,
            down: int = 1, pad=(0, 0)) -> torch.Tensor:
    """Zero-stuff by ``up``, pad, convolve (true convolution) with the 2-D
    ``kernel``, keep every ``down``-th sample.  x: [N, C, H, W]."""
    n, c, h, w = x.shape
    if up > 1:
        x = x.reshape(n, c, h, 1, w, 1)
        x = F.pad(x, (0, up - 1, 0, 0, 0, up - 1))
        x = x.reshape(n, c, h * up, w * up)
    p0, p1 = pad
    x = F.pad(x, (p0, p1, p0, p1))
    kh, kw = kernel.shape
    k = torch.flip(kernel, (0, 1)).to(x.dtype)[None, None]
    y = F.conv2d(x.reshape(n * c, 1, x.shape[2], x.shape[3]), k,
                 stride=down)
    return y.reshape(n, c, y.shape[2], y.shape[3])


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2) * SQRT2


class Param(nn.Module):
    """Base: records how each parameter is initialised, for
    ``weights.make_weights``: ``("randn", std)`` or ``("const", value)``."""

    init: dict

    def __init__(self):
        super().__init__()
        self.init = {}
        self.quant: Optional[Quant] = None


class Linear(Param):
    def __init__(self, i: int, o: int, *, bias_init: float = 0.0,
                 lr_mul: float = 1.0, act: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(o, i))
        self.bias = nn.Parameter(torch.empty(o))
        self.init = {"weight": ("randn", 1.0 / lr_mul),
                     "bias": ("const", bias_init)}
        self.scale = lr_mul / math.sqrt(i)
        self.lr_mul = lr_mul
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight * self.scale
        if self.quant is not None and self.quant.scope == "all":
            x = fake_quant(x, self.quant, tuple(range(1, x.dim())))
            w = fake_quant(w, self.quant, (1,))
        y = quant_grad(F.linear(x, w), self.quant) + self.bias * self.lr_mul
        return lrelu(y) if self.act else y


class Conv(Param):
    """Equalised-lr conv, NCHW."""

    def __init__(self, i: int, o: int, k: int, *, stride: int = 1,
                 padding: int = 0, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(o, i, k, k))
        self.init = {"weight": ("randn", 1.0)}
        if bias:
            self.bias = nn.Parameter(torch.empty(o))
            self.init["bias"] = ("const", 0.0)
        else:
            self.bias = None
        self.scale = 1.0 / math.sqrt(i * k * k)
        self.stride, self.padding = stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight * self.scale
        if self.quant is not None and self.quant.scope == "all":
            x = fake_quant(x, self.quant, (1, 2, 3))
            w = fake_quant(w, self.quant, (1, 2, 3))
        y = quant_grad(F.conv2d(x, w, stride=self.stride,
                                padding=self.padding), self.quant)
        if self.bias is not None:
            y = y + self.bias[None, :, None, None]
        return y


class BiasAct(Param):
    """``activate.bias``: bias, leaky ReLU, times sqrt(2)."""

    def __init__(self, c: int):
        super().__init__()
        self.bias = nn.Parameter(torch.empty(c))
        self.init = {"bias": ("const", 0.0)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return lrelu(x + self.bias[None, :, None, None])


class Blur(nn.Module):
    def __init__(self, pad, gain: float = 1.0):
        super().__init__()
        self.register_buffer("kernel", fir_kernel(gain=gain))
        self.pad = pad

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upfirdn(x, self.kernel, pad=self.pad)


class Upsample(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("kernel", fir_kernel(gain=4.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upfirdn(x, self.kernel, up=2, pad=(2, 1))


class NoiseWeight(Param):
    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1))
        self.init = {"weight": ("const", 0.0)}


class ModConv(Param):
    """Modulated conv, optionally demodulated and up-sampling by 2."""

    def __init__(self, i: int, o: int, k: int, style_dim: int, *,
                 demodulate: bool = True, upsample: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1, o, i, k, k))
        self.init = {"weight": ("randn", 1.0)}
        self.modulation = Linear(style_dim, i, bias_init=1.0)
        if upsample:
            self.blur = Blur((1, 1), gain=4.0)
        self.scale = 1.0 / math.sqrt(i * k * k)
        self.demodulate, self.upsample, self.k = demodulate, upsample, k

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        b, i, h, w = x.shape
        s = self.modulation(style)                               # [b, i]
        q = self.quant
        weight = self.scale * self.weight * s[:, None, :, None, None]
        if self.demodulate:
            d = torch.rsqrt(weight.pow(2).sum((2, 3, 4)) + 1e-8)
            weight = weight * d[:, :, None, None, None]
        o, k = weight.shape[1], self.k
        if q is not None and q.scope == "all":
            x = fake_quant(x, q, (1, 2, 3))
            weight = fake_quant(weight, q, (2, 3, 4))
        if self.upsample:
            wt = weight.transpose(1, 2).reshape(b * i, o, k, k)
            out = F.conv_transpose2d(x.reshape(1, b * i, h, w), wt,
                                     stride=2, groups=b)
            out = out.reshape(b, o, out.shape[2], out.shape[3])
            return self.blur(quant_grad(out, q))
        out = F.conv2d(x.reshape(1, b * i, h, w),
                       weight.reshape(b * o, i, k, k), padding=k // 2,
                       groups=b)
        return quant_grad(out.reshape(b, o, h, w), q)


class StyledConv(nn.Module):
    def __init__(self, i, o, k, style_dim, upsample=False):
        super().__init__()
        self.conv = ModConv(i, o, k, style_dim, upsample=upsample)
        self.noise = NoiseWeight()          # carried; noise injection is off
        self.activate = BiasAct(o)

    def forward(self, x, style):
        return self.activate(self.conv(x, style))


class ToRGB(Param):
    def __init__(self, i, style_dim, upsample=True):
        super().__init__()
        self.conv = ModConv(i, 3, 1, style_dim, demodulate=False)
        self.bias = nn.Parameter(torch.empty(1, 3, 1, 1))
        self.init = {"bias": ("const", 0.0)}
        if upsample:
            self.upsample = Upsample()

    def forward(self, x, style, skip=None):
        out = self.conv(x, style) + self.bias
        if skip is not None:
            out = out + self.upsample(skip)
        return out


class Mapping(nn.ModuleList):
    """Per-token mapping: pixel norm over features, then token t through
    its own equalised linear layer (lr_mul 0.01) and leaky ReLU.  Index 0 is
    the parameter-free norm, as in the checkpoint."""

    def __init__(self, n_tokens, dim, lr_mul):
        super().__init__([nn.Identity()] + [
            Linear(dim, dim, lr_mul=lr_mul, act=True)
            for _ in range(n_tokens)])

    def forward(self, x):
        x = x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + 1e-8)
        return torch.stack([self[t + 1](x[:, t]) for t in range(len(self) - 1)],
                           dim=1)


def layer_norm_tokens(x):
    """LayerNorm over tokens and channels together, no affine."""
    mean = x.mean(dim=(-2, -1), keepdim=True)
    var = x.var(dim=(-2, -1), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + 1e-5)


class Attention(nn.Module):
    """Queries from the content tokens, keys and values from the style
    tokens; 128 planes in 4 groups of 32, softmax scale planes ** -0.5."""

    def __init__(self, q_dim, kv_dim, out_dim, lr_mul, groups=4, compress=4):
        super().__init__()
        planes = out_dim // compress
        self.q_transform = Linear(q_dim, planes, lr_mul=lr_mul)
        self.k_transform = Linear(kv_dim, planes, lr_mul=lr_mul)
        self.v_transform = Linear(kv_dim, planes, lr_mul=lr_mul)
        self.proj = Linear(planes, out_dim, lr_mul=lr_mul)
        self.planes, self.groups = planes, groups

    def forward(self, kv, q_tokens):
        g, planes = self.groups, self.planes
        q, k, v = (self.q_transform(q_tokens), self.k_transform(kv),
                   self.v_transform(kv))
        b, m, _ = q.shape
        n = k.shape[1]
        q = q.reshape(b, m, g, -1).transpose(1, 2)               # [b, g, m, p]
        k = k.reshape(b, n, g, -1).transpose(1, 2)
        v = v.reshape(b, n, g, -1).transpose(1, 2)
        sim = torch.softmax(q @ k.transpose(-1, -2) * planes ** -0.5, dim=-1)
        out = (sim @ v).transpose(1, 2).reshape(b, m, planes)
        return self.proj(out)


class Block(nn.Module):
    def __init__(self, in_dim, q_dim, out_dim, lr_mul):
        super().__init__()
        self.atten = Attention(q_dim, in_dim, out_dim, lr_mul)
        self.mlp = nn.Sequential(Linear(out_dim, out_dim, lr_mul=lr_mul),
                                 nn.GELU(),
                                 Linear(out_dim, out_dim, lr_mul=lr_mul))
        if in_dim != out_dim:
            self.proj = Linear(in_dim, out_dim, lr_mul=lr_mul)
        self.in_dim, self.out_dim = in_dim, out_dim

    def forward(self, x, q_tokens):
        out = self.atten(layer_norm_tokens(x), q_tokens)
        x = (self.proj(x) if self.in_dim != self.out_dim else x) + out
        return x + self.mlp(layer_norm_tokens(x))


def channels(cfg: dict) -> dict:
    cm, cap = cfg["channel_multiplier"], cfg.get("max_channels", 512)
    raw = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * cm, 128: 128 * cm,
           256: 64 * cm, 512: 32 * cm, 1024: 16 * cm}
    return {k: min(v, cap) for k, v in raw.items()}


class Generator(nn.Module):
    """``cfg``: the configuration file's ``model`` dict (size, style_dim,
    param_dim, n_tokens, n_trans, channel_multiplier, lr_mlp[, max_channels])."""

    def __init__(self, cfg: dict):
        super().__init__()
        size, sd, pd = cfg["size"], cfg["style_dim"], cfg["param_dim"]
        nt, lr = cfg["n_tokens"], cfg["lr_mlp"]
        log = int(math.log2(size))
        n_latent = 2 * (log - 1)
        self.register_buffer("token", torch.eye(n_latent))
        self.register_buffer("token_spatial", torch.eye(nt))
        self.style_mapping_network = Mapping(nt, sd, lr)
        self.spatial_mapping_network = Mapping(nt, pd, lr)
        self.interact = nn.ModuleList([
            Block(sd + (nt if i == 0 else 0), pd + (nt if i == 0 else 0), sd,
                  lr) for i in range(cfg["n_trans"])])
        self.adjust_style = Linear(nt, n_latent)
        ch = channels(cfg)
        self.conv1 = StyledConv(pd, ch[4], 3, sd)
        self.to_rgb1 = ToRGB(ch[4], sd, upsample=False)
        convs, rgbs, c_in = [], [], ch[4]
        for i in range(3, log + 1):
            c = ch[2 ** i]
            convs += [StyledConv(c_in, c, 3, sd, upsample=True),
                      StyledConv(c, c, 3, sd)]
            rgbs.append(ToRGB(c, sd))
            c_in = c
        self.convs = nn.ModuleList(convs)
        self.to_rgbs = nn.ModuleList(rgbs)
        self.noises = nn.Module()
        for i in range(2 * (log - 2) + 1):
            res = 2 ** ((i + 5) // 2)
            self.noises.register_buffer(f"noise_{i}", torch.empty(1, 1, res,
                                                                  res))
        self.pd = pd

    def set_quant(self, quant: Optional[Quant]) -> "Generator":
        for m in self.modules():
            if isinstance(m, Param):
                m.quant = quant
        return self

    def map_codes(self, z, p):
        return self.style_mapping_network(z), self.spatial_mapping_network(p)

    def latents(self, z_plus, p_plus):
        b, nt = z_plus.shape[:2]
        eye = self.token_spatial.expand(b, nt, nt)
        x = torch.cat([z_plus, eye], -1)
        q0 = torch.cat([p_plus, eye], -1)
        for i, blk in enumerate(self.interact):
            x = blk(x, q0 if i == 0 else p_plus)
        return self.adjust_style(x.transpose(1, 2)).transpose(1, 2)

    def synthesize(self, p_plus, latent):
        """P+ [B, 16, D] and styles [B, 14, D] -> NHWC image."""
        b = p_plus.shape[0]
        x = p_plus.reshape(b, 4, 4, self.pd).permute(0, 3, 1, 2)
        x = self.conv1(x, latent[:, 0])
        skip = self.to_rgb1(x, latent[:, 1])
        i = 1
        for j, rgb in enumerate(self.to_rgbs):
            x = self.convs[2 * j](x, latent[:, i])
            x = self.convs[2 * j + 1](x, latent[:, i + 1])
            skip = rgb(x, latent[:, i + 2], skip)
            i += 2
        return skip.permute(0, 2, 3, 1)

    def forward(self, z, p, plus_space: bool = False):
        z_plus, p_plus = (z, p) if plus_space else self.map_codes(z, p)
        return self.synthesize(p_plus, self.latents(z_plus, p_plus))


class ConvLayer(nn.Sequential):
    """[Blur] + conv [+ bias and leaky ReLU], indexed as the checkpoint."""

    def __init__(self, i, o, k, downsample=False, bias=True, activate=True):
        layers = []
        if downsample:
            p = 2 + (k - 1)
            layers.append(Blur(((p + 1) // 2, p // 2)))
            layers.append(Conv(i, o, k, stride=2, bias=bias and not activate))
        else:
            layers.append(Conv(i, o, k, padding=k // 2,
                               bias=bias and not activate))
        if activate:
            layers.append(BiasAct(o))
        super().__init__(*layers)


class ResBlock(nn.Module):
    def __init__(self, i, o):
        super().__init__()
        self.conv1 = ConvLayer(i, i, 3)
        self.conv2 = ConvLayer(i, o, 3, downsample=True)
        self.skip = ConvLayer(i, o, 1, downsample=True, bias=False,
                              activate=False)

    def forward(self, x):
        return (self.conv2(self.conv1(x)) + self.skip(x)) / SQRT2


class Discriminator(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        size = cfg["size"]
        ch = channels(cfg)
        log = int(math.log2(size))
        convs, c_in = [ConvLayer(3, ch[size], 1)], ch[size]
        for i in range(log, 2, -1):
            convs.append(ResBlock(c_in, ch[2 ** (i - 1)]))
            c_in = ch[2 ** (i - 1)]
        self.convs = nn.Sequential(*convs)
        self.final_conv = ConvLayer(c_in + 1, ch[4], 3)
        self.final_linear = nn.Sequential(
            Linear(ch[4] * 16, ch[4], act=True), Linear(ch[4], 1))

    def set_quant(self, quant: Optional[Quant]) -> "Discriminator":
        for m in self.modules():
            if isinstance(m, Param):
                m.quant = quant
        return self

    def forward(self, img):
        """NHWC images -> logits [B, 1]."""
        x = self.convs(img.permute(0, 3, 1, 2))
        b, c, h, w = x.shape
        g = min(b, 4)
        while b % g:
            g -= 1
        y = x.reshape(g, b // g, 1, c, h, w)
        std = torch.sqrt(y.var(dim=0, unbiased=False) + 1e-8)
        std = std.mean(dim=(2, 3, 4)).reshape(b // g, 1, 1, 1)
        x = torch.cat([x, std.repeat(g, 1, h, w)], dim=1)
        x = self.final_conv(x)
        return self.final_linear(x.reshape(b, -1))
