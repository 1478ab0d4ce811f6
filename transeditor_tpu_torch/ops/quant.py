"""Int8 quantisation for the synthesis convs: the opt-in
``ModelConfig.quantize="int8"`` mode (``transeditor_tpu/ops/quant.py``).

The mode exists because int8 ought to run at twice the bf16 rate: on an
H100 the dense int8 tensor cores are rated at 1,979 TOP/s against 989
TFLOP/s for bf16.  The design is the JAX package's:

  * weights: symmetric per-output-channel int8, quantised on the fly from
    the float32 master weights, ``sw[o] = max(amax, 1e-12) / 127``;
  * activations: symmetric dynamic per-sample int8 (the modulation
    ``x * s_in[b]`` makes per-sample ranges differ);
  * accumulation in int32, dequantised by the rank-1 factor
    ``sx[b] * sw[o]`` (the float32 product formed first).

Demodulation, bias and activation stay with the caller
(``ops/modconv.py``), so the surrounding arithmetic is the bf16 path's.
Activation quantisation is plain torch (``amax``, division, ``round``
half to even, clamp, cast), as XLA fuses it in JAX.

``conv2d_int8`` is the convolution.  A CUDA tensor launches the
hand-written kernel ``csrc/conv2d_int8.cu`` (built with ``nvcc`` for
``sm_90a`` at first use, bound with ``ctypes``) or raises; a CPU tensor
takes ``conv2d_int8_plain``, which casts the int8 operands to float64
and runs ``F.conv2d`` / ``F.conv_transpose2d``.  That is exact: every
product is at most 127², and the sums (at most 9 · 512 · 127² ≈ 7.4e7)
lie far below 2⁵³.  Float32 would not be exact.  The kernel's note gives
its bound and what the design does about it.

int8 tensors carry no gradient; as in JAX, the mode is for sampling.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from transeditor_tpu_torch.ops.fused_blur import LaunchCounter

_OUT_KIND = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}
_CHANNEL_STEP = 16           # the kernel's 16-byte copies of a pixel's row


# launches of the CUDA kernel, nowhere else, by mode ("stride1",
# "strided", "transposed") in the counter's path field
launches = LaunchCounter()


# ------------------------------------------------------------- quantisation

def quantize_weight_per_oc(w: torch.Tensor):
    """[O, I, kh, kw] -> (int8 weights, float32 scale [O]).

    Symmetric per output channel: ``sw[o] = max(amax(|w[o]|), 1e-12)/127``.
    """
    w32 = w.float()
    amax = w32.abs().amax(dim=(1, 2, 3))
    sw = torch.clamp_min(amax, 1e-12) / 127.0
    wq = torch.clamp(torch.round(w32 / sw[:, None, None, None]), -127, 127)
    return wq.to(torch.int8).contiguous(), sw


def quantize_act_per_sample(x: torch.Tensor):
    """[B, H, W, C] -> (int8, float32 scale [B]) with per-sample amax."""
    x32 = x.float()
    amax = x32.abs().amax(dim=(1, 2, 3))
    sx = torch.clamp_min(amax, 1e-12) / 127.0
    xq = torch.clamp(torch.round(x32 / sx[:, None, None, None]), -127, 127)
    # elementwise ops keep a permuted input's strides: the kernel reads a
    # dense NHWC tensor
    return xq.to(torch.int8).contiguous(), sx


# ------------------------------------------------------------ convolution

def _mode(stride: int, transpose: bool) -> str:
    if transpose:
        return "transposed"
    return "stride1" if stride == 1 else "strided"


def out_size(h: int, k: int, stride: int, padding: int,
             transpose: bool) -> int:
    """Output extent along one axis."""
    if transpose:
        return (h - 1) * stride + k
    return (h + 2 * padding - k) // stride + 1


def _check(xq: torch.Tensor, wq: torch.Tensor, stride: int, padding: int,
           transpose: bool) -> tuple[int, int]:
    if xq.dim() != 4 or wq.dim() != 4:
        raise ValueError(f"need NHWC x and [O, I, kh, kw] w, got "
                         f"{tuple(xq.shape)} and {tuple(wq.shape)}")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"conv2d_int8 takes int8 operands, got {xq.dtype} "
                        f"and {wq.dtype}")
    if xq.shape[3] != wq.shape[1]:
        raise ValueError(f"x has {xq.shape[3]} channels, w takes "
                         f"{wq.shape[1]}")
    if transpose and (stride != 2 or padding != 0):
        raise ValueError("the transposed mode is stride 2 with pad 0")
    _, h, w_, _ = xq.shape
    ho = out_size(h, wq.shape[2], stride, padding, transpose)
    wo = out_size(w_, wq.shape[3], stride, padding, transpose)
    if ho <= 0 or wo <= 0:
        raise ValueError(f"no output for x {tuple(xq.shape)}, w "
                         f"{tuple(wq.shape)}, stride {stride}, pad {padding}")
    return ho, wo


def conv2d_int8_plain(xq: torch.Tensor, wq: torch.Tensor, *,
                      stride: int = 1, padding: int = 0,
                      transpose: bool = False) -> torch.Tensor:
    """Plain version: int8 NHWC ⊛ int8 [O, I, kh, kw] -> int32 NHWC, in
    float64 (exact; see the module note)."""
    _check(xq, wq, stride, padding, transpose)
    x64 = xq.permute(0, 3, 1, 2).to(torch.float64).contiguous()
    w64 = wq.to(torch.float64)
    if transpose:
        y = F.conv_transpose2d(x64, w64.transpose(0, 1).contiguous(),
                               stride=stride)
    else:
        y = F.conv2d(x64, w64.contiguous(), stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1).to(torch.int32).contiguous()


def dequantize_plain(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """``float(acc) * (sx[b] * sw[o])`` in float32, then ``out_dtype``."""
    deq = sx.float()[:, None, None, None] * sw.float()[None, None, None, :]
    return (acc.float() * deq).to(out_dtype)


class _CPlan(ctypes.Structure):
    """``struct TeiPlan`` in csrc/conv2d_int8.cu, field for field."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "B", "H", "W", "Ip", "O", "kh", "kw", "Ho", "Wo", "stride", "pad",
        "transpose", "out_kind")]


_lib: ctypes.CDLL | None = None     # loaded once, with its entry point typed


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from transeditor_tpu_torch.ops.cuda_build import load_library
        lib = load_library("conv2d_int8")
        lib.tei_conv2d_int8.restype = ctypes.c_int
        lib.tei_conv2d_int8.argtypes = (
            [ctypes.POINTER(_CPlan)] + [ctypes.c_void_p] * 6)
        lib.tei_error_string.restype = ctypes.c_char_p
        lib.tei_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def build() -> None:
    """Compile and load the kernel library now (it is otherwise built at
    the first CUDA call)."""
    _library()


def pack_operands(xq: torch.Tensor, wq: torch.Tensor):
    """(x [B, H, W, Ip], w [O, kh, kw, Ip]) as the kernel reads them: the
    weights repacked tap-major, both zero-padded to ``Ip``, a multiple of
    16 channels (exact for integer sums), x copied only when it must be
    padded or is not 16-byte aligned."""
    i = xq.shape[3]
    ip = -(-i // _CHANNEL_STEP) * _CHANNEL_STEP
    w = wq.permute(0, 2, 3, 1)
    if ip != i:
        w = F.pad(w, (0, ip - i))
    if ip != i:
        xq = F.pad(xq, (0, ip - i))
    elif xq.data_ptr() % 16:
        xq = xq.clone()          # a fresh allocation is aligned
    return xq, w.contiguous()


def prepare(xq: torch.Tensor, wq: torch.Tensor, *, stride: int,
            padding: int, transpose: bool, out_dtype: torch.dtype):
    """(plan, x, w): the kernel's geometry and its packed operands for
    operands that ``conv2d_int8`` has checked."""
    ho, wo = _check(xq, wq, stride, padding, transpose)
    b, h, w_, _ = xq.shape
    o, _, kh, kw = wq.shape
    x, w = pack_operands(xq, wq)
    plan = _CPlan(b, h, w_, x.shape[3], o, kh, kw, ho, wo, stride, padding,
                  int(transpose), _OUT_KIND[out_dtype])
    return plan, x, w


_DTYPE_OF_KIND = {v: k for k, v in _OUT_KIND.items()}


def launch(plan: _CPlan, x: torch.Tensor, w: torch.Tensor,
           sx: torch.Tensor | None = None,
           sw: torch.Tensor | None = None) -> torch.Tensor:
    """Run the kernel on ``prepare``'s plan and packed CUDA operands;
    allocates only the output.  Exposed so that a caller can time the
    kernel without the packing."""
    y = torch.empty((plan.B, plan.Ho, plan.Wo, plan.O),
                    dtype=_DTYPE_OF_KIND[plan.out_kind], device=x.device)
    fn = (_lib or _library()).tei_conv2d_int8
    args = (ctypes.byref(plan), x.data_ptr(), w.data_ptr(),
            None if sx is None else sx.data_ptr(),
            None if sw is None else sw.data_ptr(), y.data_ptr())
    index = x.device.index
    if index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream(index).cuda_stream)
    else:
        with torch.cuda.device(index):
            rc = fn(*args, torch.cuda.current_stream(index).cuda_stream)
    if rc != 0:
        raise RuntimeError("conv2d_int8 launch failed: "
                           + _library().tei_error_string(rc).decode())
    launches.add(_mode(plan.stride, bool(plan.transpose)))
    return y


def conv2d_int8(xq: torch.Tensor, wq: torch.Tensor, *, stride: int = 1,
                padding: int = 0, transpose: bool = False,
                sx: torch.Tensor | None = None,
                sw: torch.Tensor | None = None,
                out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Int8 NHWC ⊛ int8 [O, I, kh, kw] with int32 accumulation.

    ``transpose=True`` is the stride-2 transposed conv of the up-convs
    (output ``2H + kh - 2``), as ``F.conv_transpose2d`` with the weight
    unflipped, which is the JAX package's flipped-kernel lhs-dilated conv.
    With ``out_dtype`` int32 it returns the sums; float32 or bfloat16
    dequantises by ``sx`` [B] and ``sw`` [O] (float32).  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises.
    """
    if out_dtype not in _OUT_KIND:
        raise TypeError(f"out_dtype must be int32, float32 or bfloat16, "
                        f"got {out_dtype}")
    if out_dtype != torch.int32 and (sx is None or sw is None):
        raise ValueError("a dequantised output needs sx and sw")
    if xq.device.type == "cpu":
        acc = conv2d_int8_plain(xq, wq, stride=stride, padding=padding,
                                transpose=transpose)
        return acc if out_dtype == torch.int32 else \
            dequantize_plain(acc, sx, sw, out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"conv2d_int8 runs on cuda or cpu, got {xq.device}")
    _check(xq, wq, stride, padding, transpose)
    if not (xq.is_contiguous() and wq.is_contiguous()):
        raise ValueError("conv2d_int8 needs contiguous operands")
    operands = [("w", wq)]
    if out_dtype != torch.int32:
        for name, s, n in (("sx", sx, xq.shape[0]), ("sw", sw, wq.shape[0])):
            if s.dtype != torch.float32 or tuple(s.shape) != (n,):
                raise ValueError(f"{name} must be float32 [{n}], got "
                                 f"{s.dtype} {tuple(s.shape)}")
            if not s.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
            operands.append((name, s))
    for name, t in operands:
        if t.device != xq.device:
            raise ValueError(f"{name} is on {t.device}, x on {xq.device}")
    plan, x, w = prepare(xq, wq, stride=stride, padding=padding,
                         transpose=transpose, out_dtype=out_dtype)
    if out_dtype == torch.int32:
        sx = sw = None
    return launch(plan, x, w, sx, sw)


def quantized_conv(xs: torch.Tensor, weight_scaled: torch.Tensor,
                   out_dtype: torch.dtype, *, stride: int = 1,
                   padding: int = 0, transpose: bool = False
                   ) -> torch.Tensor:
    """quantize(xs) ⊛ quantize(weight) -> dequantised ``out_dtype``.

    ``xs`` is the style-modulated input (x * s_in[b]), NHWC;
    ``weight_scaled`` [O, I, kh, kw] already carries the equalized-lr
    scale, which folds into the per-channel weight scales."""
    wq, sw = quantize_weight_per_oc(weight_scaled)
    xq, sx = quantize_act_per_sample(xs)
    return conv2d_int8(xq, wq, stride=stride, padding=padding,
                       transpose=transpose, sx=sx, sw=sw,
                       out_dtype=out_dtype)
