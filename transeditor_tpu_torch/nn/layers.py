"""Equalized-learning-rate building blocks (``nn.Module``s).

The math of ``transeditor_tpu/nn/layers.py``, with parameters and
buffers named and shaped as the reference ``.pt`` keys (Linear weights
``[out, in]``, conv weights ``[O, I, kh, kw]``, modulated weights
``[1, O, I, kh, kw]``, ``activate.bias``, ``noise.weight``,
``blur.kernel``, ``upsample.kernel``), so a reference ``g_ema`` state
dict loads with ``load_state_dict(strict=True)``.

Parameters are float32 and cast to the compute dtype per call.  Token
tensors are [batch, tokens, features]; images are NHWC.  Each
constructor draws its initial weights from ``rng`` (a
``torch.Generator``; ``None`` means torch's default generator).

``model_axis``: set (to a ``parallel/mesh.py::Mesh``) while a layer's
weight is held as its output-channel slice on a model axis
(``ShardedParams.gather_(column=True)``): the layer then computes its
slice and gathers the full output (``parallel/model_parallel.py``).
``None``, the default, computes the whole layer.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from transeditor_tpu_torch.ops.act import fused_leaky_relu
from transeditor_tpu_torch.ops.modconv import (modulated_conv2d,
                                               modulated_conv2d_up_fused)
from transeditor_tpu_torch.ops.precision import conv_precision
from transeditor_tpu_torch.ops.resample import (_upsample_pads, blur,
                                                make_resample_kernel,
                                                upfirdn2d)
from transeditor_tpu_torch.parallel.model_parallel import (copy_in,
                                                           gather_out,
                                                           slice_of)

_SQRT2 = math.sqrt(2.0)


def pixel_norm(x: torch.Tensor, axis: int = -1,
               eps: float = 1e-8) -> torch.Tensor:
    """x * rsqrt(mean(x^2, axis) + eps), computed in float32."""
    x32 = x.float()
    out = x32 * torch.rsqrt((x32 * x32).mean(dim=axis, keepdim=True) + eps)
    return out.to(x.dtype)


def layer_norm_tokens(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the LAST TWO dims jointly (tokens and channels
    together, biased variance), no affine, computed in float32."""
    x32 = x.float()
    mean = x32.mean(dim=(-2, -1), keepdim=True)
    var = x32.var(dim=(-2, -1), keepdim=True, unbiased=False)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class EqualLinear(nn.Module):
    """Linear with runtime weight scale ``lr_mul / sqrt(in_dim)``.

    weight ~ N(0,1)/lr_mul; bias scaled by lr_mul at run time.
    ``activation='fused_lrelu'`` applies the bias inside the activation.
    """

    def __init__(self, in_dim: int, out_dim: int, *, bias: bool = True,
                 bias_init: float = 0.0, lr_mul: float = 1.0,
                 activation: str | None = None,
                 dtype: torch.dtype = torch.float32,
                 rng: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.randn(out_dim, in_dim, generator=rng) / lr_mul)
        self.bias = (nn.Parameter(torch.full((out_dim,), float(bias_init)))
                     if bias else None)
        self.scale = lr_mul / math.sqrt(in_dim)
        self.lr_mul = lr_mul
        self.activation = activation
        self.dtype = dtype
        self.model_axis = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ax = self.model_axis
        if ax is not None:
            x = copy_in(x, ax)
        conv_precision(self.dtype)
        y = F.linear(x.to(self.dtype), (self.weight * self.scale).to(
            self.dtype))
        b = None if self.bias is None else self.bias * self.lr_mul
        if ax is not None and b is not None:
            b = slice_of(b, ax)                 # a replicated bias
        if self.activation == "fused_lrelu":
            y = fused_leaky_relu(y, b)
        elif b is not None:
            y = y + b.to(y.dtype)
        return y if ax is None else gather_out(y, ax)


class PixelNorm(nn.Module):
    """Parameter-free layer 0 of the reference mapping ``Sequential``."""

    def __init__(self, axis: int = -1):
        super().__init__()
        self.axis = axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pixel_norm(x, axis=self.axis)


class TokenMapping(nn.ModuleList):
    """Per-token mapping network (the Z+/P+ "plus space" map).

    Layer 0 is the shared ``PixelNorm``; token *i* < ``n_mapping``
    passes through its OWN ``EqualLinear`` (layer i+1, lr_mul 0.01,
    fused leaky ReLU).  The layers are stacked into one batched matmul
    per call.  With num_region > 1 the tail tokens are EXACTLY zero.
    """

    def __init__(self, n_tokens: int, in_dim: int, features: int, *,
                 lr_mul: float = 0.01, pixel_norm_axis: str = "feature",
                 n_mapping: int | None = None,
                 dtype: torch.dtype = torch.float32,
                 rng: torch.Generator | None = None):
        n_map = n_tokens if n_mapping is None else n_mapping
        axis = -1 if pixel_norm_axis == "feature" else -2
        super().__init__(
            [PixelNorm(axis)]
            + [EqualLinear(in_dim, features, lr_mul=lr_mul,
                           activation="fused_lrelu", dtype=dtype, rng=rng)
               for _ in range(n_map)])
        self.n_tokens = n_tokens
        self.n_map = n_map
        self.scale = lr_mul / math.sqrt(in_dim)
        self.lr_mul = lr_mul
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self[0](x)
        layers = list(self)[1:]
        # on a model axis each layer holds its output slice, biases too
        # (JAX stacks them into one [n, out] leaf, cut like the kernel)
        ax = layers[0].model_axis
        if ax is not None:
            x = copy_in(x, ax)
        kernel = torch.stack([m.weight for m in layers])   # [n, out, in]
        bias = torch.stack([m.bias for m in layers])        # [n, out]
        conv_precision(self.dtype)
        y = torch.einsum("btc,tdc->btd", x[:, :self.n_map].to(self.dtype),
                         (kernel * self.scale).to(self.dtype))
        y = y + (bias * self.lr_mul).to(y.dtype)[None]
        y = F.leaky_relu(y, 0.2) * _SQRT2
        if ax is not None:
            y = gather_out(y, ax)
        if self.n_map < self.n_tokens:
            y = F.pad(y, (0, 0, 0, self.n_tokens - self.n_map))
        return y


class EqualConv2d(nn.Module):
    """Conv with 1/sqrt(fan_in) runtime scale; NHWC in and out."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, *,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 rng: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(
            out_ch, in_ch, kernel_size, kernel_size, generator=rng))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.scale = 1.0 / math.sqrt(in_ch * kernel_size ** 2)
        self.stride = stride
        self.padding = padding
        self.dtype = dtype
        self.model_axis = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ax = self.model_axis
        if ax is not None:
            x = copy_in(x, ax)
        conv_precision(self.dtype)
        w = (self.weight * self.scale).to(
            self.dtype, memory_format=torch.channels_last)
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2), w,
                     stride=self.stride, padding=self.padding)
        y = y.permute(0, 2, 3, 1).contiguous()
        if self.bias is not None:
            b = self.bias if ax is None else slice_of(self.bias, ax)
            y = y + b.to(y.dtype)
        return y if ax is None else gather_out(y, ax)


class Blur(nn.Module):
    """Holds the reference's ``blur.kernel`` buffer (outer(k,k)/sum ·
    factor²).  The fused up-conv takes the same filter as 4 taps by
    value, so there the buffer is carried for checkpoint interop; the
    discriminator's downsampling ``ConvLayer`` calls it, an FIR blur
    padded by ``pad``."""

    def __init__(self, kernel_1d: Sequence[int], upsample_factor: int = 1,
                 pad: tuple[int, int] = (0, 0)):
        super().__init__()
        k = make_resample_kernel(kernel_1d) * upsample_factor ** 2
        self.register_buffer("kernel", torch.from_numpy(k))
        self.kernel_1d = tuple(kernel_1d)
        self.upsample_factor = upsample_factor
        self.pad = tuple(pad)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return blur(x, self.kernel_1d, pad=self.pad,
                    upsample_factor=self.upsample_factor)


class Upsample(nn.Module):
    """FIR upsample by 2 (the ToRGB skip path); ``kernel`` buffer as in
    the reference (outer(k,k)/sum · 4)."""

    def __init__(self, kernel_1d: Sequence[int], factor: int = 2):
        super().__init__()
        k = make_resample_kernel(kernel_1d) * factor ** 2
        self.register_buffer("kernel", torch.from_numpy(k))
        self.factor = factor
        self.pad = _upsample_pads(len(kernel_1d), factor)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upfirdn2d(x, self.kernel, up=self.factor, down=1,
                         pad=self.pad)


class ModulatedConv2d(nn.Module):
    """Style-modulated conv (see ``ops/modconv.py``).

    ``fused_bias``/``fused_act`` fold the follow-up bias + leaky ReLU
    into the conv's epilogue; on the upsample path that is one
    ``fused_blur4`` pass with the FIR blur and demodulation.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 style_dim: int, *, demodulate: bool = True,
                 upsample: bool = False, downsample: bool = False,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1),
                 dtype: torch.dtype = torch.float32,
                 quantize: str | None = None,
                 rng: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(
            1, out_ch, in_ch, kernel_size, kernel_size, generator=rng))
        self.modulation = EqualLinear(style_dim, in_ch, bias_init=1.0,
                                      dtype=dtype, rng=rng)
        if upsample or downsample:
            self.blur = Blur(blur_kernel, 2 if upsample else 1)
        self.demodulate = demodulate
        self.upsample = upsample
        self.downsample = downsample
        self.blur_kernel = tuple(blur_kernel)
        self.dtype = dtype
        self.quantize = quantize
        self.model_axis = None

    def forward(self, x: torch.Tensor, style: torch.Tensor,
                fused_bias: torch.Tensor | None = None,
                fused_act: bool = False) -> torch.Tensor:
        s = self.modulation(style)
        ax = self.model_axis
        if ax is not None:
            # this rank's output channels: demodulation, bias, activation
            # (and the up-conv's fused_blur4) on the slice, then gathered
            x, s = copy_in(x, ax), copy_in(s, ax)
            if fused_bias is not None:
                fused_bias = slice_of(fused_bias, ax)
        if self.upsample:
            out = modulated_conv2d_up_fused(
                x.to(self.dtype), self.weight[0], s, bias=fused_bias,
                activate=fused_act, demodulate=self.demodulate,
                blur_kernel=self.blur_kernel, quantize=self.quantize)
        else:
            out = modulated_conv2d(
                x.to(self.dtype), self.weight[0], s,
                demodulate=self.demodulate, downsample=self.downsample,
                blur_kernel=self.blur_kernel, quantize=self.quantize)
            if fused_act:
                out = fused_leaky_relu(out, fused_bias)
            elif fused_bias is not None:
                out = out + fused_bias.to(out.dtype)
        return out if ax is None else gather_out(out, ax)


class NoiseInjection(nn.Module):
    """``noise.weight`` [1], zero-init (the reference builds it always;
    it is only read when noise injection is on)."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1))


class FusedLeakyReLU(nn.Module):
    """``activate.bias`` [O]: bias + leaky ReLU · sqrt(2)."""

    def __init__(self, channels: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_leaky_relu(x, self.bias)


class StyledConv(nn.Module):
    """ModulatedConv2d + (optional) noise + fused bias / leaky ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 style_dim: int, *, upsample: bool = False,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1),
                 demodulate: bool = True, noise_injection: bool = False,
                 dtype: torch.dtype = torch.float32,
                 quantize: str | None = None,
                 rng: torch.Generator | None = None):
        super().__init__()
        self.conv = ModulatedConv2d(
            in_ch, out_ch, kernel_size, style_dim, demodulate=demodulate,
            upsample=upsample, blur_kernel=blur_kernel, dtype=dtype,
            quantize=quantize, rng=rng)
        self.noise = NoiseInjection()
        self.activate = FusedLeakyReLU(out_ch)
        self.noise_injection = noise_injection

    def forward(self, x: torch.Tensor, style: torch.Tensor,
                noise: torch.Tensor | None = None,
                rng: torch.Generator | None = None) -> torch.Tensor:
        """``noise``: explicit NHWC [B, H, W, 1]; else drawn from ``rng``
        when noise injection is on."""
        if not self.noise_injection:
            # bias + leaky ReLU fused into the conv epilogue (one kernel
            # pass with the blur on the upsample path)
            return self.conv(x, style, fused_bias=self.activate.bias,
                             fused_act=True)
        out = self.conv(x, style)
        if noise is None:
            b, h, w, _ = out.shape
            noise = torch.randn((b, h, w, 1), generator=rng,
                                device=out.device, dtype=out.dtype)
        out = out + self.noise.weight.to(out.dtype) * noise.to(out.dtype)
        return self.activate(out)


class ToRGB(nn.Module):
    """1x1 modulated conv (demod off) + bias + upsampled skip."""

    def __init__(self, in_ch: int, style_dim: int, *, upsample: bool = True,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1),
                 dtype: torch.dtype = torch.float32,
                 rng: torch.Generator | None = None):
        super().__init__()
        self.conv = ModulatedConv2d(in_ch, 3, 1, style_dim, demodulate=False,
                                    dtype=dtype, rng=rng)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1))
        if upsample:
            self.upsample = Upsample(blur_kernel)

    def forward(self, x: torch.Tensor, style: torch.Tensor,
                skip: torch.Tensor | None = None) -> torch.Tensor:
        out = self.conv(x, style)
        out = out + self.bias.reshape(3).to(out.dtype)
        if skip is not None:
            out = out + self.upsample(skip)
        return out


class ConvLayer(nn.Sequential):
    """Discriminator conv unit: [Blur +] EqualConv2d [+ leaky ReLU]
    (``transeditor_tpu/nn/layers.py::ConvLayer``).

    Indexed as the reference ``Sequential``: with ``downsample`` the blur
    is ``0`` (``{prefix}.0.kernel``), then the conv (``.1.weight``, stride
    2, no padding) and the activation (``.2.bias``); without it the conv
    is ``0`` and the activation ``1``.  The activation holds the bias;
    without one (the res blocks' skip) ``bias`` says whether the conv
    carries it.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, *,
                 downsample: bool = False,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1),
                 bias: bool = True, activate: bool = True,
                 dtype: torch.dtype = torch.float32,
                 rng: torch.Generator | None = None):
        layers = []
        if downsample:
            p = (len(blur_kernel) - 2) + (kernel_size - 1)
            layers.append(Blur(blur_kernel, pad=((p + 1) // 2, p // 2)))
            stride, padding = 2, 0
        else:
            stride, padding = 1, kernel_size // 2
        layers.append(EqualConv2d(in_ch, out_ch, kernel_size, stride=stride,
                                  padding=padding,
                                  bias=bias and not activate, dtype=dtype,
                                  rng=rng))
        if activate:
            layers.append(FusedLeakyReLU(out_ch))
        super().__init__(*layers)
