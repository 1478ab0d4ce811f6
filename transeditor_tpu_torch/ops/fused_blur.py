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
and bound with ``ctypes``; its note gives the bound (bytes: ~62 MB per
256px bf16 image over the six calls) and what the design does about it.

Two paths, both hand-written kernels, chosen per shape by ``plan_tiles``:

- ``"tma"``: a persistent grid whose blocks stream input rows through a
  shared-memory ring filled by TMA tile loads.  Every shape whose
  channel row is a multiple of 16 bytes and whose input is 16-byte
  aligned takes it, the six main-path shapes among them.
- ``"general"``: one thread per channel vector (or element) and output
  column, walking 8 rows with plain loads, for the shapes TMA cannot
  describe (``C * itemsize`` not a multiple of 16, a misaligned view).

``fused_blur4`` runs the kernel for a CUDA tensor and the plain torch
version, ``fused_blur4_plain``, only for a CPU tensor.  There is no
fallback on the card: any C, H, W in float32 or bfloat16 goes to a
kernel, and anything else raises.

Gradients, to any order, come from ``_FusedBlur4``, an
``autograd.Function`` whose backward runs the same kernel.  With
``g = gy * act'(y)`` (``act'`` is sqrt(2) where ``y >= 0`` and
0.2 * sqrt(2) elsewhere, taken from ``y`` as a constant):

    grad_x = fused_blur4(g, taps[::-1], pad=(3-p0, 3-p1), scale=s)
    grad_s = sum_{h,w} g * fused_blur4(x, taps, pad)
    grad_b = sum_{b,h,w} g

The first is the adjoint (the transposed FIR: flipped taps, the pad
that maps the output size back to the input size), the second a
recompute of the blur alone.  Both call ``_FusedBlur4`` themselves and
the rest is differentiable torch, so the double backward of the path
regulariser goes through the kernel too (the adjoint of the adjoint is
the forward).  ``launches`` counts each launch by path and by role:
``forward``, ``adjoint`` or ``recompute``.

``fused_blur4`` takes the ``Function`` only when grad mode is on and
an input requires grad; otherwise (serving under ``inference_mode``,
the discriminator step's ``no_grad`` fakes) it calls the kernel
directly.  The CPU runs the same backward, with the plain version in
place of each launch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import threading
from typing import Sequence

import torch
import torch.nn.functional as F

from transeditor_tpu_torch.ops.precision import conv_precision

_SQRT2 = math.sqrt(2.0)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}

# Geometry of the TMA path (see plan_tiles).  On an H100 one block of 256
# computing threads on each SM ran faster than two, a grid of even rounds
# faster than a full last round, and a larger ring or wider channel
# chunks did not pay (PERF.md).
SM_COUNT = 132               # H100 SXM; the wrapper asks the device
_CHUNK_BYTES = 128           # channels of one tile: a 128-byte line a pixel
_MAX_CONSUMERS = 256         # computing threads; one more warp loads
_RING_BYTES = 48 * 1024      # shared memory of one block's ring, at most
_MIN_STAGES, _MAX_STAGES = 3, 16
_CONSUMERS_PER_SM = 256      # persistent grid: blocks an SM, by their threads
_BOX_MAX = 256               # TMA: each box dim
_SMEM_LIMIT = 232_448        # bytes of shared memory a block may use
_SMEM_SM = 233_472           # ... and all blocks of an SM together


class LaunchCounter:
    """Thread-safe count of kernel launches, in all, by path and by role
    (``forward``, ``adjoint``, ``recompute``); serving runs forwards on
    several threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: dict[tuple[str, str], int] = {}

    def add(self, path: str, role: str = "forward") -> None:
        with self._lock:
            key = (role, path)
            self._counts[key] = self._counts.get(key, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self._counts = {}

    def _sum_by(self, index: int) -> dict[str, int]:
        with self._lock:
            out: dict[str, int] = {}
            for key, n in self._counts.items():
                out[key[index]] = out.get(key[index], 0) + n
            return out

    @property
    def value(self) -> int:
        return sum(self.by_path.values())

    @property
    def by_path(self) -> dict[str, int]:
        return self._sum_by(1)

    @property
    def by_role(self) -> dict[str, int]:
        return self._sum_by(0)

    @property
    def by_role_path(self) -> dict[str, dict[str, int]]:
        """{role: {path: launches}}."""
        with self._lock:
            out: dict[str, dict[str, int]] = {}
            for (role, path), n in self._counts.items():
                out.setdefault(role, {})[path] = n
            return out


launches = LaunchCounter()   # launches of the CUDA kernels, nowhere else


@dataclasses.dataclass(frozen=True, eq=False)   # hashed by identity: cheap
class TilePlan:
    """How one call is cut up.  On the TMA path a tile is (batch b, a
    segment of ``seg`` output rows, a strip of ``wt`` output columns, a
    chunk of ``cc`` channels); each of the ring's ``stages`` slots holds
    one input row of ``wt + 3`` columns.  The general path uses only the
    shape fields."""

    path: str                     # "tma" or "general"
    dtype: torch.dtype
    B: int
    H: int
    W: int
    C: int
    Ho: int
    Wo: int
    p0: int
    cc: int = 0
    wt: int = 0
    seg: int = 0
    stages: int = 0
    n_chunk: int = 0
    n_strip: int = 0
    n_seg: int = 0
    n_tiles: int = 0
    grid: int = 0
    threads: int = 0
    smem: int = 0

    def tile(self, i: int) -> tuple[int, int, int, int, int, int]:
        """(b, oy0, rows out, ox0, columns out, c0) of tile ``i``, in the
        kernel's order (``decode_tile`` in the .cu)."""
        chunk = i % self.n_chunk
        i //= self.n_chunk
        strip = i % self.n_strip
        i //= self.n_strip
        seg = i % self.n_seg
        b = i // self.n_seg
        oy0, ox0 = seg * self.seg, strip * self.wt
        return (b, oy0, min(self.seg, self.Ho - oy0), ox0,
                min(self.wt, self.Wo - ox0), chunk * self.cc)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=512)
def plan_tiles(B: int, H: int, W: int, C: int, dtype: torch.dtype,
               pad: tuple[int, int], aligned: bool = True,
               n_sm: int = SM_COUNT) -> TilePlan:
    """Choose the path and the tile and ring geometry for one shape.

    ``aligned``: the input's address is a multiple of 16 bytes.  Cached
    per shape; the kernel receives the plan's fields as ints.
    """
    p0, p1 = pad
    Ho, Wo = H + p0 + p1 - 3, W + p0 + p1 - 3
    item = _ITEMSIZE[dtype]
    shape = dict(dtype=dtype, B=B, H=H, W=W, C=C, Ho=Ho, Wo=Wo, p0=p0)
    vec = 16 // item
    if (not aligned or C % vec or B * H * W * C * item >= 1 << 40
            or max(B, H, W) >= 1 << 31):
        return TilePlan("general", **shape)

    # 16-byte channel vectors a tile: a 128-byte line, or the largest
    # divisor of the pixel's vectors below that.
    nv = C // vec
    nvec = max(d for d in range(1, _CHUNK_BYTES // 16 + 1) if nv % d == 0)
    cc = nvec * vec
    n_chunk = C // cc
    wt = min(Wo, _MAX_CONSUMERS // nvec, _BOX_MAX - 3)
    n_strip = _cdiv(Wo, wt)
    wt = _cdiv(Wo, n_strip)                 # even strips
    consumers = _cdiv(wt * nvec, 32) * 32
    per_sm = max(1, _CONSUMERS_PER_SM // consumers)

    # Row segments: the busiest block reads (rounds of tiles) x (rows a
    # tile + its 3-row halo); take the split that makes that least, the
    # longest segments among equals.
    base = B * n_strip * n_chunk
    blocks = per_sm * n_sm
    seg = min((_cdiv(Ho, n) for n in range(1, Ho + 1)),
              key=lambda r: (_cdiv(base * _cdiv(Ho, r), blocks) * (r + 3),
                             -r))
    n_seg = _cdiv(Ho, seg)

    slot = _cdiv((wt + 3) * cc * item, 128) * 128
    ring = min(_RING_BYTES, _SMEM_SM // per_sm - 1024)
    stages = min(max(ring // slot, _MIN_STAGES), _MAX_STAGES)
    smem = stages * slot + 16 * stages + 128   # + barriers, + alignment
    if smem > _SMEM_LIMIT:
        return TilePlan("general", **shape)

    n_tiles = B * n_seg * n_strip * n_chunk
    grid = min(n_tiles, per_sm * n_sm)
    grid = _cdiv(n_tiles, _cdiv(n_tiles, grid))    # even rounds of tiles
    return TilePlan("tma", cc=cc, wt=wt, seg=seg, stages=stages,
                    n_chunk=n_chunk, n_strip=n_strip, n_seg=n_seg,
                    n_tiles=n_tiles, grid=grid, threads=consumers + 32,
                    smem=smem, **shape)


class _CPlan(ctypes.Structure):
    """``struct Plan`` in csrc/fused_blur4.cu, field for field."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "path", "dtype", "B", "H", "W", "C", "Ho", "Wo", "p0", "cc", "wt",
        "seg", "stages", "n_chunk", "n_strip", "n_seg", "n_tiles",
        "grid", "threads", "smem")]


@functools.lru_cache(maxsize=512)
def _c_plan(plan: TilePlan) -> _CPlan:
    fields = dataclasses.asdict(plan)
    fields["path"] = 1 if plan.path == "tma" else 0
    fields["dtype"] = _DTYPE_CODE[plan.dtype]
    return _CPlan(**{name: fields[name] for name, _ in _CPlan._fields_})


_lib: ctypes.CDLL | None = None     # loaded once, with its entry points typed


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from transeditor_tpu_torch.ops.cuda_build import load_library
        lib = load_library("fused_blur4")
        lib.teb_fused_blur4.restype = ctypes.c_int
        lib.teb_fused_blur4.argtypes = (
            [ctypes.POINTER(_CPlan)] + [ctypes.c_void_p] * 3
            + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
            + [ctypes.c_float] * 4 + [ctypes.c_int, ctypes.c_void_p])
        lib.teb_error_string.restype = ctypes.c_char_p
        lib.teb_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def build() -> None:
    """Compile and load the kernel library now (it is otherwise built at
    the first CUDA call)."""
    _library()


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def _epilogue_operand(t: torch.Tensor | None):
    """(tensor the kernel reads, 1 if bfloat16): float32 and bfloat16 go
    as they are; other types are cast to float32."""
    if t is None:
        return None, 0
    if t.dtype not in _DTYPE_CODE:
        t = t.float()
    return t.contiguous(), _DTYPE_CODE[t.dtype]


def launch(plan: TilePlan, x: torch.Tensor, taps: Sequence[float],
           scale: torch.Tensor | None = None,
           bias: torch.Tensor | None = None,
           act: bool = False, role: str = "forward") -> torch.Tensor:
    """Run ``plan``'s kernel on CUDA tensors that ``fused_blur4`` has
    checked; allocates only the output.  Exposed so that a caller can
    time one path against the other at the same shape.  ``role`` only
    labels the launch in ``launches``."""
    out = torch.empty((plan.B, plan.Ho, plan.Wo, plan.C), dtype=x.dtype,
                      device=x.device)
    scale, scale_bf16 = _epilogue_operand(scale)
    bias, bias_bf16 = _epilogue_operand(bias)
    t0, t1, t2, t3 = (float(v) for v in taps[::-1])   # flipped: true conv
    fn = (_lib or _library()).teb_fused_blur4
    args = (_c_plan(plan), x.data_ptr(), out.data_ptr(),
            None if scale is None else scale.data_ptr(), scale_bf16,
            None if bias is None else bias.data_ptr(), bias_bf16,
            t0, t1, t2, t3, int(bool(act)))
    index = x.device.index
    if index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream(index).cuda_stream)
    else:
        with torch.cuda.device(index):
            rc = fn(*args, torch.cuda.current_stream(index).cuda_stream)
    if rc != 0:
        raise RuntimeError("fused_blur4 launch failed: "
                           + _library().teb_error_string(rc).decode())
    launches.add(plan.path, role)
    return out


def _blur(x: torch.Tensor, taps: tuple, pad: tuple[int, int],
          scale: torch.Tensor | None, bias: torch.Tensor | None, act: bool,
          role: str) -> torch.Tensor:
    """One call without autograd: the plain version for a CPU tensor,
    the kernel (or an error) for a CUDA tensor."""
    if x.device.type == "cpu":
        return fused_blur4_plain(x, taps, pad, scale, bias, act)
    if x.device.type != "cuda":
        raise ValueError(f"fused_blur4 runs on cuda or cpu, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_blur4 takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_blur4 needs a contiguous NHWC tensor")
    _out_size(x, pad)
    _check_epilogue(x, scale, bias)
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    b, h, w, c = x.shape
    plan = plan_tiles(b, h, w, c, x.dtype, pad, x.data_ptr() % 16 == 0,
                      _sm_count(x.device.index))
    return launch(plan, x, taps, scale, bias, act, role)


def _call(x, taps, pad, scale, bias, act, role):
    """Through ``_FusedBlur4`` when autograd must record the call, else
    straight to ``_blur`` (written out: it runs on every serving call)."""
    if torch.is_grad_enabled() and (
            x.requires_grad
            or (scale is not None and scale.requires_grad)
            or (bias is not None and bias.requires_grad)):
        return _FusedBlur4.apply(x, scale, bias, taps, pad, act, role)
    return _blur(x, taps, pad, scale, bias, act, role)


class _FusedBlur4(torch.autograd.Function):
    """``fused_blur4`` with a backward made of ``fused_blur4`` calls (see
    the module docstring), differentiable again."""

    @staticmethod
    def forward(ctx, x, scale, bias, taps, pad, act, role):
        y = _blur(x, taps, pad, scale, bias, act, role)
        need_s = ctx.needs_input_grad[1]
        ctx.save_for_backward(x if need_s else None, y if act else None,
                              scale)
        ctx.taps, ctx.pad, ctx.act = taps, pad, act
        ctx.x_dtype = x.dtype
        ctx.bias_dtype = None if bias is None else bias.dtype
        return y

    @staticmethod
    def backward(ctx, gy):
        # float32 throughout, each gradient rounded once to its input's
        # type, as autograd of the plain version does; a no-op in float32
        x, y, scale = ctx.saved_tensors
        taps, (p0, p1) = ctx.taps, ctx.pad
        g = gy.float()
        if ctx.act:
            # the activation's slope at y, a constant: lrelu'' = 0
            g = g * torch.where(y.detach() >= 0, _SQRT2, 0.2 * _SQRT2)
        grad_x = grad_s = grad_b = None
        if ctx.needs_input_grad[0]:
            grad_x = _call(g.contiguous(), taps[::-1], (3 - p0, 3 - p1),
                           scale, None, False, "adjoint").to(ctx.x_dtype)
        if ctx.needs_input_grad[1]:
            blurred = _call(x.float(), taps, (p0, p1), None, None, False,
                            "recompute")
            grad_s = (g * blurred).sum(dim=(1, 2)).to(scale.dtype)
        if ctx.needs_input_grad[2]:
            grad_b = g.sum(dim=(0, 1, 2)).to(ctx.bias_dtype)
        return grad_x, grad_s, grad_b, None, None, None, None


def fused_blur4(x: torch.Tensor, taps: Sequence[float],
                pad: Sequence[int] = (1, 1),
                scale: torch.Tensor | None = None,
                bias: torch.Tensor | None = None,
                act: bool = False) -> torch.Tensor:
    """Fused FIR4 blur + optional scale [B,C] + bias [C] + leaky ReLU.

    x: NHWC [B, H, W, C], float32 or bfloat16, contiguous.
    taps: 4 per-axis filter taps (already normalised and gained).
    pad: spatial pad (p0, p1) as in upfirdn2d; out = in + p0 + p1 - 3.

    A CPU tensor takes ``fused_blur4_plain``; a CUDA tensor launches a
    kernel or raises.  Differentiable to any order in x, scale and bias,
    by the same kernel.
    """
    if len(taps) != 4:
        raise ValueError(f"need 4 taps, got {len(taps)}")
    return _call(x, tuple(taps), (int(pad[0]), int(pad[1])), scale, bias,
                 act, "forward")
