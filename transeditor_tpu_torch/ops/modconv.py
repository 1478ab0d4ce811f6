"""StyleGAN2 modulated convolution with the scale-in / scale-out identity.

    conv(x, scale * w * s_in)[b,o] * demod[b,o]
      == demod[b,o] * scale * conv(x * s_in[b], w)[b,o]

so the card sees one batched convolution with shared weights, and
modulation / demodulation are rank-1 scalings (as
``transeditor_tpu/ops/modconv.py``).  ``demod`` is computed in float32
from ``style² @ Σ w²`` and cast to the compute dtype.

Images are NHWC; weights are in the reference / PyTorch layout
``[O, I, kh, kw]``.  ``x.permute(0, 3, 1, 2)`` of a contiguous NHWC
tensor is a channels-last NCHW view, and cuDNN returns channels-last,
so the permutes around each conv move no data.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from transeditor_tpu_torch.ops.fused_blur import fused_blur4
from transeditor_tpu_torch.ops.precision import conv_precision
from transeditor_tpu_torch.ops.quant import quantized_conv
from transeditor_tpu_torch.ops.resample import blur


def _conv(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
          padding: int = 0, transpose: bool = False) -> torch.Tensor:
    """NHWC conv with an [O, I, kh, kw] weight.  ``transpose=True`` is
    the stride-2 transposed conv (padding 0): ``F.conv_transpose2d``
    takes the [I, O, kh, kw] weight unflipped, which is the JAX
    flipped-kernel ``lhs_dilation`` conv; output [B, 2H+k-2, ...]."""
    conv_precision(x.dtype)
    xc = x.permute(0, 3, 1, 2)
    if transpose:
        wt = w.transpose(0, 1).contiguous(memory_format=torch.channels_last)
        y = F.conv_transpose2d(xc, wt, stride=stride)
    else:
        wc = w.contiguous(memory_format=torch.channels_last)
        y = F.conv2d(xc, wc, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1).contiguous()


def _demod(weight32: torch.Tensor, style32: torch.Tensor, scale: float,
           eps: float) -> torch.Tensor:
    """rsqrt(scale² · (s² @ Σ_{kh,kw} w²) + eps), float32 [B, O]."""
    wsq = (weight32 * weight32).sum(dim=(2, 3)).t()          # [I, O]
    return torch.rsqrt((scale * scale) * ((style32 * style32) @ wsq) + eps)


def modulated_conv2d_up_fused(
    x: torch.Tensor,
    weight: torch.Tensor,
    style: torch.Tensor,
    bias: torch.Tensor | None = None,
    activate: bool = False,
    demodulate: bool = True,
    blur_kernel: Sequence[int] = (1, 3, 3, 1),
    eps: float = 1e-8,
    quantize: str | None = None,
) -> torch.Tensor:
    """Upsampling modulated conv: stride-2 transposed conv, then blur ->
    demod -> bias -> leaky ReLU in one ``fused_blur4`` pass (the kernel
    on CUDA, its plain version on the CPU).  Demod commutes with the
    per-channel FIR, so applying it after the blur is exact.

    When autograd records (training), ``fused_blur4`` goes through its
    ``autograd.Function``: the backward to the conv output, demod and
    bias is the same kernel in its adjoint configuration plus a
    recompute of the blur, differentiable again for the path-length
    regulariser.  Under ``no_grad`` / ``inference_mode`` it launches the
    kernel directly.

    ``quantize="int8"`` runs the transposed conv through
    ``ops/quant.py::quantized_conv`` (the int8 kernel on CUDA); its
    output goes on to ``fused_blur4`` unchanged."""
    if len(blur_kernel) != 4:
        raise ValueError("the fused up-conv takes a 4-tap blur kernel")
    _, in_ch, kh, kw = weight.shape
    scale = 1.0 / math.sqrt(in_ch * kh * kw)
    dtype = x.dtype
    style32 = style.float()
    w32 = weight.float()

    demod = None
    if demodulate:
        demod = _demod(w32, style32, scale, eps).to(dtype)

    xs = x * style32.to(dtype)[:, None, None, :]
    if quantize == "int8":
        out = quantized_conv(xs, w32 * scale, dtype, stride=2,
                             transpose=True)
    else:
        out = _conv(xs, (w32 * scale).to(dtype), stride=2, transpose=True)

    p = (len(blur_kernel) - 2) - (kh - 1)
    pad = ((p + 1) // 2 + 1, p // 2 + 1)
    k1 = np.asarray(blur_kernel, np.float64)
    taps = tuple((k1 / k1.sum() * 2.0).tolist())           # per-axis up gain
    return fused_blur4(out, taps, pad, scale=demod, bias=bias, act=activate)


def modulated_conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    style: torch.Tensor,
    *,
    demodulate: bool = True,
    upsample: bool = False,
    downsample: bool = False,
    blur_kernel: Sequence[int] = (1, 3, 3, 1),
    eps: float = 1e-8,
    quantize: str | None = None,
) -> torch.Tensor:
    """Modulated (optionally demodulated / resampling) conv.

    Args:
      x: [B, H, W, I] input features (NHWC).
      weight: [O, I, kh, kw] shared filter, unit-variance init.
      style: [B, I] per-sample input-channel scales.
      demodulate: apply the rsqrt(sum w^2) output normalisation.
      upsample / downsample: stride-2 resampling with the StyleGAN2 FIR
        blur placement (the unfused chain; the generator's up-convs use
        ``modulated_conv2d_up_fused``).
      quantize: "int8" runs each conv through ``ops/quant.py``.

    Returns:
      [B, H', W', O].
    """
    _, in_ch, kh, kw = weight.shape
    scale = 1.0 / math.sqrt(in_ch * kh * kw)
    dtype = x.dtype
    style32 = style.float()
    w32 = weight.float()

    demod = None
    if demodulate:
        demod = _demod(w32, style32, scale, eps).to(dtype)[:, None, None, :]

    xs = x * style32.to(dtype)[:, None, None, :]
    if quantize == "int8":
        ws = w32 * scale

        def conv(inp, **kw):
            return quantized_conv(inp, ws, dtype, **kw)
    else:
        w = (w32 * scale).to(dtype)

        def conv(inp, **kw):
            return _conv(inp, w, **kw)

    if upsample:
        out = conv(xs, stride=2, transpose=True)
        if demod is not None:
            out = out * demod
        k = len(blur_kernel)
        p = (k - 2) - (kh - 1)
        pad = ((p + 1) // 2 + 1, p // 2 + 1)
        return blur(out, blur_kernel, pad=pad, upsample_factor=2)
    if downsample:
        k = len(blur_kernel)
        p = (k - 2) + (kh - 1)
        pad = ((p + 1) // 2, p // 2)
        out = conv(blur(xs, blur_kernel, pad=pad), stride=2, padding=0)
    else:
        out = conv(xs, padding=kh // 2)
    if demod is not None:
        out = out * demod
    return out
