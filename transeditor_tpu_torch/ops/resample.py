"""Upsample -> FIR filter -> downsample (``upfirdn2d``) as torch ops.

Same semantics as ``transeditor_tpu/ops/resample.py``:

  1. zero-stuff the input by ``up`` (each sample followed by ``up-1``
     zeros, in both spatial dims),
  2. pad by ``pad[0]`` before / ``pad[1]`` after (negative pad crops),
  3. convolve (true convolution) with the FIR kernel,
  4. keep every ``down``-th output sample.

  out = (in * up + pad0 + pad1 - kernel) // down + 1       (each dim)

Images are NHWC.  A 2-D kernel is one depthwise ``F.conv2d``
(``groups=C``) over the stuffed, padded input; 1-D taps take the
separable path, one depthwise pass per axis.  ``blur`` (the
discriminator's) sums shifted slices instead, because R1 differentiates
it twice.  Everything is ordinary autograd, so first and second
derivatives come for free.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from transeditor_tpu_torch.ops.precision import conv_precision


def make_resample_kernel(k: Sequence[float]) -> np.ndarray:
    """Normalised 2-D FIR kernel: outer(k, k) / sum (numpy, float32)."""
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    return k / k.sum()


def _as_kernel(kernel, x: torch.Tensor) -> torch.Tensor:
    if isinstance(kernel, torch.Tensor):
        return kernel.to(device=x.device, dtype=x.dtype)
    return torch.as_tensor(np.asarray(kernel, np.float32), device=x.device,
                           dtype=x.dtype)


def _upfirdn_core(x: torch.Tensor, k2d: torch.Tensor, up: tuple[int, int],
                  down: tuple[int, int],
                  pad: tuple[int, int, int, int]) -> torch.Tensor:
    """NHWC upfirdn with a [kh, kw] kernel; per-axis up/down/pad."""
    up_y, up_x = up
    down_y, down_x = down
    pad_y0, pad_y1, pad_x0, pad_x1 = pad
    n, h, w, c = x.shape
    if up_y > 1 or up_x > 1:
        x = x.reshape(n, h, 1, w, 1, c)
        x = F.pad(x, (0, 0, 0, up_x - 1, 0, 0, 0, up_y - 1))
        x = x.reshape(n, h * up_y, w * up_x, c)
    x = F.pad(x, (0, 0, pad_x0, pad_x1, pad_y0, pad_y1))
    kh, kw = k2d.shape
    # true convolution == correlation with the flipped kernel
    weight = torch.flip(k2d, (0, 1)).reshape(1, 1, kh, kw).expand(
        c, 1, kh, kw).contiguous()
    conv_precision(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, stride=(down_y, down_x),
                 groups=c)
    return y.permute(0, 2, 3, 1).contiguous()


def upfirdn2d(x: torch.Tensor, kernel, up: int = 1, down: int = 1,
              pad: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Apply upfirdn to an NHWC tensor. ``pad`` may be negative.

    Args:
      x: [N, H, W, C] input.
      kernel: [kh, kw] FIR filter (numpy, sequence or tensor), or 1-D
        taps [k] meaning the separable filter outer(k, k).
      up / down: integer resampling factors (same in both dims).
      pad: (before, after) padding applied to both spatial dims.

    Returns:
      [N, H', W', C] with H' = (H*up + pad0 + pad1 - kh)//down + 1.
    """
    k = _as_kernel(kernel, x)
    p0, p1 = pad
    if k.ndim == 1:
        y = _upfirdn_core(x, k[:, None], (up, 1), (down, 1), (p0, p1, 0, 0))
        return _upfirdn_core(y, k[None, :], (1, up), (1, down),
                             (0, 0, p0, p1))
    return _upfirdn_core(x, k, (up, up), (down, down), (p0, p1, p0, p1))


def _upsample_pads(k_len: int, factor: int) -> tuple[int, int]:
    """Pad for the reference ``Upsample``."""
    p = k_len - factor
    return ((p + 1) // 2 + factor - 1, p // 2)


def _downsample_pads(k_len: int, factor: int) -> tuple[int, int]:
    """Pad for the reference ``Downsample``."""
    p = k_len - factor
    return ((p + 1) // 2, p // 2)


def upsample_2d(x: torch.Tensor, kernel_1d=(1, 3, 3, 1),
                factor: int = 2) -> torch.Tensor:
    """FIR upsample; kernel gain factor**2."""
    kernel = make_resample_kernel(kernel_1d) * (factor ** 2)
    pad = _upsample_pads(len(kernel_1d), factor)
    return upfirdn2d(x, kernel, up=factor, down=1, pad=pad)


def downsample_2d(x: torch.Tensor, kernel_1d=(1, 3, 3, 1),
                  factor: int = 2) -> torch.Tensor:
    """FIR downsample."""
    pad = _downsample_pads(len(kernel_1d), factor)
    return upfirdn2d(x, make_resample_kernel(kernel_1d), up=1,
                     down=factor, pad=pad)


def blur(x: torch.Tensor, kernel_1d=(1, 3, 3, 1), pad=(0, 0),
         upsample_factor: int = 1) -> torch.Tensor:
    """Plain FIR blur with explicit pad: the filter outer(k, k) / sum,
    times ``upsample_factor**2``, as ``upfirdn2d`` with up = down = 1.

    Computed per axis as a sum of shifted slices in float32, rounded once
    to ``x.dtype``, not as a depthwise ``F.conv2d``: PyTorch's double
    backward of a grouped convolution loops over the groups, which made
    R1 through the discriminator's blurs take seconds a step at 256px
    (``PERF.md``).  The derivatives of slices, of any order, are slices.
    """
    k = np.asarray(kernel_1d, np.float64)
    taps = (k / k.sum() * upsample_factor)[::-1]    # flipped: true conv
    p0, p1 = pad
    y = F.pad(x.float(), (0, 0, p0, p1, p0, p1))
    n = len(taps)
    for axis in (2, 1):                             # W, then H
        size = y.shape[axis] - n + 1
        acc = None
        for i, t in enumerate(taps.tolist()):
            term = y.narrow(axis, i, size) * t
            acc = term if acc is None else acc + term
        y = acc
    return y.to(x.dtype)
