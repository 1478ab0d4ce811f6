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

``conv2d_int8`` is the convolution.  A CUDA tensor launches one of two
hand-written kernels (built with ``nvcc`` for ``sm_90a`` at first use,
bound with ``ctypes``) or raises; ``plan_conv`` chooses between them by
geometry, cached like ``ops/fused_blur.py::plan_tiles``:

  * ``"wgmma"`` (``csrc/conv2d_int8_wgmma.cu``): TMA-fed, warp-
    specialised ``wgmma`` s8 on a persistent grid that walks a work list
    (``work_items``, heaviest first), with an exact split of K where too
    few work items would leave SMs idle.  It takes the stride-1 and the
    stride-2 transposed convs with a kernel larger than 1x1 and ``O`` a
    multiple of 8: every main-path shape at every batch.
  * ``"general"`` (``csrc/conv2d_int8.cu``, the first design: ``mma.sync``
    with a ``cp.async`` ring): the rest -- the stride-2 pad-0 downsample, a
    1x1 kernel, ``O`` not a multiple of 8.

A CPU tensor takes ``conv2d_int8_plain``, which casts the int8 operands
to float64 and runs ``F.conv2d`` / ``F.conv_transpose2d``.  That is
exact: every product is at most 127², and the sums (at most 9 · 512 ·
127² ≈ 7.4e7) lie far below 2⁵³.  Float32 would not be exact.  Both
kernels are bit-equal to it; their notes give the bound and what each
design does about it.

int8 tensors carry no gradient; as in JAX, the mode is for sampling.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from transeditor_tpu_torch.ops.fused_blur import LaunchCounter, _sm_count

_OUT_KIND = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}
_CHANNEL_STEP = 16           # the kernel's 16-byte copies of a pixel's row


# launches of the CUDA kernels, nowhere else: by path ("wgmma",
# "general") in the counter's path field and by mode ("stride1",
# "strided", "transposed") in its role field
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


# ------------------------------------------------ the two kernel paths

SM_COUNT = 132                # H100 SXM; the wrapper asks the device
TILE_M = 128                  # output pixels a work item: a box's rows
TILE_N = 128                  # output channels a work item
WIDE = 256                    # either, for a bfloat16 output with K whole
STEP_BYTES = 128              # bytes of K a step: one tap, 128 channels
_SMEM_LIMIT = 232_448         # a block's shared memory on an H100
_MAX_STAGES = 6
_WIDE_MIN_STEPS = 4           # K steps every item needs to take a wide tile
_MAX_SPLIT = 8
_MAX_DIM = 1 << 31
# The split's cost model, in units of a 128 x 128 x 128 int8 product
# (about 0.28 us at the card's int8 rate): a 128-wide work item's
# epilogue; the reduction pass's launch; device-memory bytes moved in a
# unit's time.
_EPILOGUE_STEPS = 1.0
_REDUCE_STEPS = 8.0
_BYTES_PER_STEP = 0.9e6


@dataclasses.dataclass(frozen=True)
class Phase:
    """Outputs ``(qy*so + py, qx*so + px)`` for ``qy < Hq, qx < Wq``, over
    ``taps`` taps of the kernel (``make_phase`` in the .cu files)."""

    py: int
    px: int
    so: int
    Hq: int
    Wq: int
    taps: int


def phases(Ho: int, Wo: int, kh: int, kw: int, transpose: bool
           ) -> list[Phase]:
    """The stride-1 conv is one phase; the stride-2 transposed conv four
    sub-pixel phases, each a plain conv over its own taps."""
    if not transpose:
        return [Phase(0, 0, 1, Ho, Wo, kh * kw)]
    return [Phase(py, px, 2, (Ho - py + 1) // 2, (Wo - px + 1) // 2,
                  ((kh - py + 1) // 2) * ((kw - px + 1) // 2))
            for py in (0, 1) for px in (0, 1)]


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """One conv's kernel path and, for ``"wgmma"``, its geometry: the
    output pixels and channels a work item (``tile_m x tile_n``), each
    phase's box of output pixels ``(nb, th, tw)`` (at most ``tile_m``),
    the K split, the work items, the grid and the ring's depth."""

    path: str                 # "wgmma" or "general"
    B: int
    H: int
    W: int
    Ip: int
    O: int
    kh: int
    kw: int
    Ho: int
    Wo: int
    stride: int
    pad: int
    transpose: bool
    out_kind: int
    boxes: tuple = ()
    tile_m: int = TILE_M
    tile_n: int = TILE_N
    split: int = 1
    n_items: int = 0
    grid: int = 0
    stages: int = 0
    smem: int = 0

    @property
    def nchunk(self) -> int:
        """K steps a tap: 128-channel chunks of ``Ip``."""
        return -(-self.Ip // STEP_BYTES)

    @property
    def phases(self) -> list[Phase]:
        return phases(self.Ho, self.Wo, self.kh, self.kw, self.transpose)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)
def pixel_box(B: int, Hq: int, Wq: int,
              rows: int = TILE_M) -> tuple[int, int, int]:
    """``(nb, th, tw)``: images, rows and columns of a work item's box of
    output pixels, ``nb * th * tw <= rows``, the box that covers the
    ``B x Hq x Wq`` grid in the fewest items (the widest among equals)."""
    best = None
    for tw in range(1, min(Wq, rows) + 1):
        for th in range(1, min(Hq, rows // tw) + 1):
            nb = min(B, rows // (tw * th))
            key = (_cdiv(B, nb) * _cdiv(Hq, th) * _cdiv(Wq, tw), -tw, -th)
            if best is None or key < best[0]:
                best = (key, (nb, th, tw))
    return best[1]


def _pieces(k: int, split: int) -> list[int]:
    return [k // split + (i < k % split) for i in range(split)]


def _makespan(weights: list[float], grid: int) -> float:
    """The busiest block's work when block g takes items g, g + grid, ...
    of ``weights`` (sorted heaviest first), as the kernel walks them."""
    loads = [0.0] * grid
    for i, w in enumerate(weights):
        loads[i % grid] += w
    return max(loads)


def _choose_split(units: list[int], width: float, out_elems: int,
                  out_bytes: int, n_sm: int) -> tuple[float, int]:
    """(modelled time, K split) by the cost model above (``units``: each
    work item's K steps, ``width``: its tile's width over 128): split
    only where too few work items keep the SMs busy and the reduction
    pass costs less than it saves."""
    most = 1 if len(units) >= 4 * n_sm else min(_MAX_SPLIT, min(units))
    best = None
    for split in range(1, most + 1):
        weights = sorted(((p + _EPILOGUE_STEPS) * width for k in units
                          for p in _pieces(k, split)), reverse=True)
        t = _makespan(weights, min(len(weights), n_sm))
        if split > 1:
            t += _REDUCE_STEPS + (split * 4 * out_elems + out_bytes) \
                / _BYTES_PER_STEP
        if best is None or t < best[0]:
            best = (t, split)
    return best


def _wgmma_takes(B, H, W, Ip, O, kh, kw, stride, transpose) -> bool:
    """What the wgmma path can describe: stride 1 or the stride-2
    transposed conv, a kernel larger than 1x1 (a 1x1 conv is a plain
    GEMM, on no main path), O a multiple of 8 (16-byte output rows for
    the TMA store), sizes within TMA's 32-bit coordinates and the int32
    workspace's byte strides within its 2^40."""
    return ((stride == 1 or transpose) and kh * kw > 1 and O % 8 == 0
            and max(B, H, W, Ip, O) < _MAX_DIM
            and B * (2 * H + kh) * (2 * W + kw) * O * 4 * _MAX_SPLIT
            < 1 << 40)


@functools.lru_cache(maxsize=512)
def plan_conv(B: int, H: int, W: int, Ip: int, O: int, kh: int, kw: int,
              stride: int, pad: int, transpose: bool, out_kind: int,
              n_sm: int = SM_COUNT, general: bool = False) -> ConvPlan:
    """Choose the path for one geometry and, for the wgmma path, its
    boxes, split, work items and ring.  ``general`` asks for the general
    path whatever the shape (to time one path against the other).
    Cached per geometry; ``work_items`` gives the list."""
    ho = out_size(H, kh, stride, pad, transpose)
    wo = out_size(W, kw, stride, pad, transpose)
    shape = dict(B=B, H=H, W=W, Ip=Ip, O=O, kh=kh, kw=kw, Ho=ho, Wo=wo,
                 stride=stride, pad=pad, transpose=bool(transpose),
                 out_kind=out_kind)
    if general or not _wgmma_takes(B, H, W, Ip, O, kh, kw, stride,
                                   transpose):
        return ConvPlan("general", **shape)
    phs = phases(ho, wo, kh, kw, transpose)
    nchunk = _cdiv(Ip, STEP_BYTES)
    esz = 2 if out_kind == _OUT_KIND[torch.bfloat16] else 4
    out_elems = B * ho * wo * O

    def tiling(tile_m, tile_n):
        """(boxes, each work item's K steps) for an M x N tile."""
        boxes = tuple(pixel_box(B, f.Hq, f.Wq, tile_m) for f in phs)
        return boxes, [f.taps * nchunk
                       for f, (nb, th, tw) in zip(phs, boxes)
                       for _ in range(_cdiv(B, nb) * _cdiv(f.Hq, th)
                                      * _cdiv(f.Wq, tw) * _cdiv(O, tile_n))]

    # A wide tile reads each activation box (128 x 256) or each weight
    # tile (256 x 128) from L2 half as often, which the model does not
    # count: it wins within 5%.  Its 4-byte staging would crowd out the
    # ring, so it stages bfloat16 only, with K whole; and its ring is 3
    # stages deep, too shallow for items of fewer than 4 K steps (on an
    # H100 the 128x128 -> 257x257 transposed conv, 2-8 steps an item, ran
    # slower on it).
    tile_m = tile_n = TILE_M
    boxes, work = tiling(tile_m, tile_n)
    t, split = _choose_split(work, 1.0, out_elems, out_elems * esz, n_sm)
    if esz == 2 and min(work) >= _WIDE_MIN_STEPS:
        wide_m, wide_n = (TILE_M, WIDE) if O >= WIDE else (WIDE, TILE_N)
        wide_boxes, wide_work = tiling(wide_m, wide_n)
        t_wide, split_wide = _choose_split(
            wide_work, wide_m * wide_n / (TILE_M * TILE_N), out_elems,
            out_elems * esz, n_sm)
        if split_wide == 1 and t_wide <= 1.05 * t:
            tile_m, tile_n, boxes, work, split = (wide_m, wide_n, wide_boxes,
                                                  wide_work, 1)
    store_esz = 4 if split > 1 else esz          # int32 partial sums
    fixed = 1024 + store_esz * tile_n // 128 * tile_m * 128
    stage = (tile_m + tile_n) * STEP_BYTES + 16   # + its two barriers
    stages = min(_MAX_STAGES, (_SMEM_LIMIT - fixed) // stage)
    n_items = len(work) * split
    return ConvPlan("wgmma", boxes=boxes, tile_m=tile_m, tile_n=tile_n,
                    split=split, n_items=n_items, grid=min(n_items, n_sm),
                    stages=stages, smem=fixed + stages * stage, **shape)


@functools.lru_cache(maxsize=512)
def work_items(plan: ConvPlan) -> torch.Tensor:
    """The wgmma path's work list, int32 ``[n_items, 8]`` on the CPU:
    ``(phase, b0, y0, x0, n0, k0, k1, s)`` -- a box of the phase's output
    pixels at (b0, y0, x0), ``tile_n`` output channels from n0, K steps
    [k0, k1) (step k is tap ``k // nchunk``, row-major over the phase's
    taps, and its 128-channel chunk ``k % nchunk``), split slice s.
    Heaviest first; among equals by phase, box and channels (channels
    fastest, so blocks that run together read the same pixels)."""
    if plan.path != "wgmma":
        raise ValueError("only the wgmma path has a work list")
    parts = []
    for z, (f, (nb, th, tw)) in enumerate(zip(plan.phases, plan.boxes)):
        grids = np.meshgrid(np.arange(0, plan.B, nb),
                            np.arange(0, f.Hq, th), np.arange(0, f.Wq, tw),
                            np.arange(0, plan.O, plan.tile_n),
                            np.arange(plan.split), indexing="ij")
        b0, y0, x0, n0, s = (g.reshape(-1) for g in grids)
        k = f.taps * plan.nchunk
        sizes = np.asarray(_pieces(k, plan.split))
        k1 = np.cumsum(sizes)[s]
        parts.append(np.stack([np.full_like(s, z), b0, y0, x0, n0,
                               k1 - sizes[s], k1, s], axis=1))
    items = np.concatenate(parts)
    order = np.argsort(-(items[:, 6] - items[:, 5]), kind="stable")
    return torch.from_numpy(items[order].astype(np.int32))


class _CPlan(ctypes.Structure):
    """``struct TeiPlan`` in csrc/conv2d_int8.cu, field for field."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "B", "H", "W", "Ip", "O", "kh", "kw", "Ho", "Wo", "stride", "pad",
        "transpose", "out_kind")]


class _CWgmmaPlan(ctypes.Structure):
    """``struct TewPlan`` in csrc/conv2d_int8_wgmma.cu, field for field."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "B", "H", "W", "Ip", "O", "kh", "kw", "Ho", "Wo", "pad",
        "transpose", "out_kind", "split", "tile_m", "tile_n", "n_items",
        "grid", "stages", "smem")]
    _fields_ += [(name, ctypes.c_int * 4) for name in ("nb", "th", "tw")]


@functools.lru_cache(maxsize=512)
def _c_plan(plan: ConvPlan):
    f = dataclasses.asdict(plan)
    f["transpose"] = int(plan.transpose)
    if plan.path == "general":
        return _CPlan(**{n: f[n] for n, _ in _CPlan._fields_})
    boxes = list(plan.boxes) + [plan.boxes[0]] * (4 - len(plan.boxes))
    for i, name in enumerate(("nb", "th", "tw")):
        f[name] = (ctypes.c_int * 4)(*(box[i] for box in boxes))
    return _CWgmmaPlan(**{n: f[n] for n, _ in _CWgmmaPlan._fields_})


@functools.lru_cache(maxsize=512)
def _device_items(plan: ConvPlan, device: torch.device) -> torch.Tensor:
    """``work_items(plan)`` on ``device``, copied there once."""
    return work_items(plan).to(device)


_libs: dict = {}     # path -> its library, loaded once with entry points typed


def _library(path: str) -> ctypes.CDLL:
    lib = _libs.get(path)
    if lib is None:
        from transeditor_tpu_torch.ops.cuda_build import load_library
        if path == "general":
            lib = load_library("conv2d_int8")
            lib.tei_conv2d_int8.argtypes = (
                [ctypes.POINTER(_CPlan)] + [ctypes.c_void_p] * 6)
            fn, err = lib.tei_conv2d_int8, lib.tei_error_string
        else:
            lib = load_library("conv2d_int8_wgmma")
            lib.tew_conv2d_int8.argtypes = (
                [ctypes.POINTER(_CWgmmaPlan)] + [ctypes.c_void_p] * 8)
            fn, err = lib.tew_conv2d_int8, lib.tew_error_string
        fn.restype = ctypes.c_int
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        _libs[path] = lib
    return lib


LIBRARIES = ("conv2d_int8_wgmma", "conv2d_int8")   # csrc/<name>.cu


def build() -> None:
    """Compile and load both kernel libraries now (they are otherwise
    built at the first CUDA call)."""
    for path in ("wgmma", "general"):
        _library(path)


def pack_operands(xq: torch.Tensor, wq: torch.Tensor):
    """(x [B, H, W, Ip], w [O, kh, kw, Ip]) as the kernels read them: the
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
            padding: int, transpose: bool, out_dtype: torch.dtype,
            general: bool = False):
    """(plan, x, w): the kernel path with its geometry, and the packed
    operands, for operands that ``conv2d_int8`` has checked.
    ``general`` takes the general path whatever the shape."""
    _check(xq, wq, stride, padding, transpose)
    b, h, w_, _ = xq.shape
    o, _, kh, kw = wq.shape
    x, w = pack_operands(xq, wq)
    n_sm = _sm_count(x.device.index) if x.is_cuda else SM_COUNT
    plan = plan_conv(b, h, w_, x.shape[3], o, kh, kw, stride, padding,
                     bool(transpose), _OUT_KIND[out_dtype], n_sm, general)
    return plan, x, w


_DTYPE_OF_KIND = {v: k for k, v in _OUT_KIND.items()}


def launch(plan: ConvPlan, x: torch.Tensor, w: torch.Tensor,
           sx: torch.Tensor | None = None,
           sw: torch.Tensor | None = None) -> torch.Tensor:
    """Run the plan's kernel on ``prepare``'s packed CUDA operands;
    allocates the output and, when the plan splits K, the int32
    workspace.  Exposed so that a caller can time the kernels without
    the packing, and one path against the other."""
    y = torch.empty((plan.B, plan.Ho, plan.Wo, plan.O),
                    dtype=_DTYPE_OF_KIND[plan.out_kind], device=x.device)
    lib = _libs.get(plan.path) or _library(plan.path)
    ptrs = (x.data_ptr(), w.data_ptr(),
            None if sx is None else sx.data_ptr(),
            None if sw is None else sw.data_ptr(), y.data_ptr())
    if plan.path == "general":
        fn, err, extra = lib.tei_conv2d_int8, lib.tei_error_string, ()
    else:
        ws = None if plan.split == 1 else torch.empty(
            (plan.split, *y.shape), dtype=torch.int32, device=x.device)
        fn, err = lib.tew_conv2d_int8, lib.tew_error_string
        extra = (None if ws is None else ws.data_ptr(),
                 _device_items(plan, x.device).data_ptr())
    args = (ctypes.byref(_c_plan(plan)), *ptrs, *extra)
    index = x.device.index
    if index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream(index).cuda_stream)
    else:
        with torch.cuda.device(index):
            rc = fn(*args, torch.cuda.current_stream(index).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv2d_int8 ({plan.path} path) launch failed: "
                           + err(rc).decode())
    launches.add(plan.path, _mode(plan.stride, plan.transpose))
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
    takes the plain version; a CUDA tensor launches the kernel of the
    path ``plan_conv`` chooses, or raises.
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
