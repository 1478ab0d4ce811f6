"""Fused 4-tap FIR blur + conv epilogue: the hand-written Hopper kernel.

    y = leaky_relu( FIR4x4(x) * scale[b,c] + bias[c] ) * sqrt(2)

FIR4x4 is the separable 4-tap blur (true convolution, 'valid' over the
input padded by ``pad``); scale, bias and the activation are each
optional.  It is the post-upsample chain of every upsampling
``StyledConv`` (``ops/modconv.py::modulated_conv2d_up_fused``): blur ->
demodulation -> bias -> leaky ReLU, with demod moved after the blur,
which is exact because it commutes with the per-channel FIR.

It replaces ``transeditor_tpu/ops/pallas_blur.py::fused_blur4`` (the
``pl.pallas_call`` at :131).  The kernel, ``csrc/fused_blur4.cu``,
is built with ``nvcc`` for ``sm_90a`` at first use (``ops/cuda_build.py``)
and bound with ``ctypes``; its note gives the bound (memory: ~62 MB per
256px bf16 image over the six calls) and what the design does about it.

``fused_blur4`` runs the kernel for a CUDA tensor and the plain torch
version, ``fused_blur4_plain``, only for a CPU tensor.  There is no
shape gate and no fallback on the card: any C, H, W in float32 or
bfloat16 goes to the kernel, and anything else raises.  Forward only.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Sequence

import torch
import torch.nn.functional as F

from transeditor_tpu_torch.ops.precision import conv_precision

_SQRT2 = math.sqrt(2.0)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class LaunchCounter:
    """Thread-safe count of kernel launches (serving runs forwards on
    several threads)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        return self._n


launches = LaunchCounter()   # launches of the CUDA kernel, nowhere else


def _library() -> ctypes.CDLL:
    from transeditor_tpu_torch.ops.cuda_build import load_library
    lib = load_library("fused_blur4")
    fn = lib.teb_fused_blur4
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_float] * 4 + [ctypes.c_int, ctypes.c_void_p])
        lib.teb_error_string.restype = ctypes.c_char_p
        lib.teb_error_string.argtypes = [ctypes.c_int]
    return lib


def build() -> None:
    """Compile and load the kernel library now (it is otherwise built at
    the first CUDA call)."""
    _library()


def _out_size(x: torch.Tensor, pad: Sequence[int]) -> tuple[int, int]:
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC [B,H,W,C], got shape "
                         f"{tuple(x.shape)}")
    _, h, w, _ = x.shape
    ho, wo = h + pad[0] + pad[1] - 3, w + pad[0] + pad[1] - 3
    if ho <= 0 or wo <= 0:
        raise ValueError(f"pad {tuple(pad)} leaves no output for input "
                         f"{tuple(x.shape)}")
    return ho, wo


def _check_epilogue(x, scale, bias):
    b, _, _, c = x.shape
    if scale is not None and tuple(scale.shape) != (b, c):
        raise ValueError(f"scale must be [B,C]={(b, c)}, got "
                         f"{tuple(scale.shape)}")
    if bias is not None and tuple(bias.shape) != (c,):
        raise ValueError(f"bias must be [C]={(c,)}, got {tuple(bias.shape)}")


def fused_blur4_plain(x: torch.Tensor, taps: Sequence[float],
                      pad: Sequence[int] = (1, 1),
                      scale: torch.Tensor | None = None,
                      bias: torch.Tensor | None = None,
                      act: bool = False) -> torch.Tensor:
    """Plain torch version: a depthwise ``F.conv2d`` in float32, then the
    epilogue in float32, rounded once to ``x.dtype``."""
    if len(taps) != 4:
        raise ValueError(f"need 4 taps, got {len(taps)}")
    _out_size(x, pad)
    _check_epilogue(x, scale, bias)
    c = x.shape[-1]
    t = torch.tensor([float(v) for v in taps[::-1]], dtype=torch.float32,
                     device=x.device)                 # flipped: true conv
    weight = torch.outer(t, t).reshape(1, 1, 4, 4).expand(c, 1, 4, 4)
    p0, p1 = pad
    x32 = F.pad(x.float(), (0, 0, p0, p1, p0, p1))
    conv_precision(torch.float32)
    y = F.conv2d(x32.permute(0, 3, 1, 2), weight.contiguous(), groups=c)
    y = y.permute(0, 2, 3, 1)
    if scale is not None:
        y = y * scale.float()[:, None, None, :]
    if bias is not None:
        y = y + bias.float()
    if act:
        y = F.leaky_relu(y, 0.2) * _SQRT2
    return y.to(x.dtype).contiguous()


def fused_blur4(x: torch.Tensor, taps: Sequence[float],
                pad: Sequence[int] = (1, 1),
                scale: torch.Tensor | None = None,
                bias: torch.Tensor | None = None,
                act: bool = False) -> torch.Tensor:
    """Fused FIR4 blur + optional scale [B,C] + bias [C] + leaky ReLU.

    x: NHWC [B, H, W, C], float32 or bfloat16, contiguous.
    taps: 4 per-axis filter taps (already normalised and gained).
    pad: spatial pad (p0, p1) as in upfirdn2d; out = in + p0 + p1 - 3.

    A CPU tensor takes ``fused_blur4_plain``; a CUDA tensor launches the
    kernel or raises.
    """
    if x.device.type == "cpu":
        return fused_blur4_plain(x, taps, pad, scale, bias, act)
    if x.device.type != "cuda":
        raise ValueError(f"fused_blur4 runs on cuda or cpu, got {x.device}")
    if len(taps) != 4:
        raise ValueError(f"need 4 taps, got {len(taps)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_blur4 takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_blur4 needs a contiguous NHWC tensor")
    ho, wo = _out_size(x, pad)
    _check_epilogue(x, scale, bias)
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    b, h, w, c = x.shape
    # the kernel reads float32 epilogue vectors: tiny [B,C] / [C] casts
    scale32 = None if scale is None else scale.float().contiguous()
    bias32 = None if bias is None else bias.float().contiguous()
    out = torch.empty((b, ho, wo, c), dtype=x.dtype, device=x.device)
    tf = [float(v) for v in taps[::-1]]               # flipped: true conv
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.teb_fused_blur4(
            x.data_ptr(), out.data_ptr(),
            None if scale32 is None else scale32.data_ptr(),
            None if bias32 is None else bias32.data_ptr(),
            _DTYPE_CODE[x.dtype], b, h, w, c, ho, wo, int(pad[0]),
            *tf, int(bool(act)), stream)
    if rc != 0:
        raise RuntimeError("fused_blur4 launch failed: "
                           + lib.teb_error_string(rc).decode())
    launches.add()
    return out
