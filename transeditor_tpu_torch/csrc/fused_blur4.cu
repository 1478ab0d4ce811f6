// Fused 4-tap FIR blur + conv epilogue for Hopper (sm_90a).
//
//   y[b,oy,ox,c] = act( sum_{dy,dx} t[dy] t[dx] x[b, oy+dy-p0, ox+dx-p0, c]
//                       * scale[b,c] + bias[c] )
//   act(v) = sqrt(2) * (v >= 0 ? v : 0.2 v)      (optional)
//
// x and y are NHWC.  `t` holds the flipped per-axis taps (true
// convolution), passed by value; rows and columns of x outside the image
// read as zero, so the input is never padded in memory.  Sums, scale,
// bias and activation are float32: the horizontal 4-tap sum of each input
// row first, then the vertical sum of four of them; the result is rounded
// once to the output type (float32 or bfloat16).  scale ([B, C]) and bias
// ([C]) are read as float32 or bfloat16, each as it is given.
//
// Replaces transeditor_tpu/ops/pallas_blur.py::fused_blur4 (the
// pl.pallas_call at :131), which ran the same chain on TPU VMEM tiles
// after copying a padded input through jnp.pad.
//
// Bound on the H100: bytes.  Each output element needs 8 multiply-adds
// (4 per axis) against 2 bytes read and 2 written in bfloat16, far below
// the card's ~20 float32 operations per byte, so the least time is the
// bytes moved -- each input read once and each output written once --
// over 3.35 TB/s.  For one 256px image in bfloat16 the six calls of a
// forward move about 62 MB, about 18.5 us.
//
// The first design (kept below as the general path) gave one thread a
// 16-byte channel vector at one output column and had it walk 8 output
// rows with plain loads.  It reached 45% of the bound at batch 64: every
// input vector went through the load path about 4 x 11/8 times (four
// neighbouring columns, a 3-row halo per 8-row tile), each thread had
// only one row of loads in flight, and nothing overlapped one block's
// tail with the next block's loads.
//
// The TMA design moves each byte from device memory about once and keeps
// many bytes in flight:
//  - a block owns a tile (batch b, a segment of output rows, a strip of
//    wt output columns, a chunk of cc channels, 128 bytes of them);
//  - one producer thread fills a ring of `stages` shared-memory slots,
//    one input row of (wt+3) columns x cc channels each, with TMA
//    tile loads (cp.async.bulk.tensor over a 4-D map of (C, W, H, B)),
//    each slot with a `full` mbarrier that expects the whole box's bytes.
//    TMA fills coordinates outside the tensor with zeros, so the p0 halo
//    and the ragged right and bottom edges need no checks and no pad;
//  - consumer threads, one per (output column, 16-byte channel vector),
//    take the horizontal sum from shared memory, keep the vertical
//    window of four row sums in registers (the row loop is unrolled by
//    four, so the window rotates without moves; slot and phase advance by
//    counting, with no division) and store 16 bytes each.  Each consumer
//    warp releases a slot through its `empty` mbarrier as soon as it has
//    the row's horizontal sums, before the vertical sum, epilogue and
//    store, so the ring refills while it computes;
//  - the grid is persistent, about 256 consumers on each SM (one block
//    of 288 threads at the larger shapes; one such block an SM measured
//    faster than two): each block walks tiles blockIdx.x, +grid, ..., and
//    the ring runs on across tile boundaries, so one tile's epilogue
//    overlaps the next tile's loads.
// A segment re-reads 3 halo rows and a strip 3 halo columns, so about
// 1 + 3/wt + 3/seg of the input is read.  The geometry is chosen in
// Python (ops/fused_blur.py::plan_tiles) and passed in a Plan.  On the
// H100 this design reaches 75-86% of the bound at the four larger shapes
// of a 256px forward at batch 64 in bfloat16 (PERF.md).
//
// Shapes TMA cannot describe -- C * sizeof(T) not a multiple of 16 bytes,
// or an input pointer that is not 16-byte aligned -- take the general
// path: the first design, one element per thread where vectors do not fit.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <atomic>
#include <climits>
#include <cstdint>
#include <cstdio>

// Mirrors ops/fused_blur.py::_CPlan; the tile and ring fields are set
// only for the TMA path.  Outside the anonymous namespace: the exported
// entry point takes it.
struct TebPlan {
  int path;                         // 0 general, 1 TMA
  int dtype;                        // 0 float32, 1 bfloat16
  int B, H, W, C, Ho, Wo, p0;
  int cc, wt, seg, stages;          // tile and ring geometry
  int n_chunk, n_strip, n_seg, n_tiles;
  int grid, threads, smem;
};

namespace {

using Plan = TebPlan;

constexpr int kRows = 8;          // general path: output rows per thread
constexpr int kThreads = 256;     // general path: threads per block
constexpr int kMaxThreads = 288;  // TMA path: 256 consumers + 1 producer warp
constexpr float kSqrt2 = 1.41421356237309515f;

struct Taps {
  float t[4];
};

// Epilogue operands; a null pointer means none.  *_bf16: element type.
struct Epi {
  const void* scale;
  const void* bias;
  int scale_bf16, bias_bf16, act;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float load_epi(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

template <int VEC>
__device__ __forceinline__ void load_epilogue(const Epi& epi, int b, int C,
                                              int c, float (&sc)[VEC],
                                              float (&bi)[VEC]) {
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    sc[v] = epi.scale != nullptr
                ? load_epi(epi.scale, (size_t)b * C + c + v, epi.scale_bf16)
                : 1.f;
    bi[v] = epi.bias != nullptr ? load_epi(epi.bias, c + v, epi.bias_bf16)
                                : 0.f;
  }
}

// Vertical 4-tap sum of the horizontal sums of four input rows, oldest
// first, then the epilogue and one rounding.
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> vertical(
    const float (&t)[4], const float (&h0)[VEC], const float (&h1)[VEC],
    const float (&h2)[VEC], const float (&h3)[VEC], const float (&sc)[VEC],
    const float (&bi)[VEC], int act) {
  Pack<T, VEC> o;
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    float s = t[0] * h0[v];
    s = fmaf(t[1], h1[v], s);
    s = fmaf(t[2], h2[v], s);
    s = fmaf(t[3], h3[v], s);
    s = s * sc[v] + bi[v];
    if (act) s = (s >= 0.f ? s : 0.2f * s) * kSqrt2;
    o.v[v] = from_float<T>(s);
  }
  return o;
}

// ------------------------------------------------------------ general path

// Horizontal 4-tap sum of input row `row` at columns ix0..ix0+3.
template <typename T, int VEC>
__device__ __forceinline__ void row_sum(const T* __restrict__ row, int ix0,
                                        int W, int C, const float (&t)[4],
                                        float (&acc)[VEC]) {
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
#pragma unroll
  for (int dx = 0; dx < 4; ++dx) {
    const int ix = ix0 + dx;
    if (ix < 0 || ix >= W) continue;
    const Pack<T, VEC> p =
        *reinterpret_cast<const Pack<T, VEC>*>(row + (size_t)ix * C);
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = fmaf(t[dx], to_float(p.v[v]), acc[v]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void input_row(const T* __restrict__ xc, int iy,
                                          int H, int W, int C, int ix0,
                                          const float (&t)[4],
                                          float (&acc)[VEC]) {
  if (iy < 0 || iy >= H) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
    return;
  }
  row_sum<T, VEC>(xc + (size_t)iy * W * C, ix0, W, C, t, acc);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
fused_blur4_kernel(const T* __restrict__ x, T* __restrict__ y, Epi epi,
                   int B, int H, int W, int C, int Ho, int Wo, int p0,
                   Taps taps) {
  const int ncv = C / VEC;
  const int ntile = (Ho + kRows - 1) / kRows;
  const long long total = (long long)B * ntile * Wo * ncv;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;

  const int cv = (int)(idx % ncv);
  long long r = idx / ncv;
  const int ox = (int)(r % Wo);
  r /= Wo;
  const int tile = (int)(r % ntile);
  const int b = (int)(r / ntile);
  const int c = cv * VEC;

  const float t[4] = {taps.t[0], taps.t[1], taps.t[2], taps.t[3]};
  float sc[VEC], bi[VEC];
  load_epilogue<VEC>(epi, b, C, c, sc, bi);

  const T* xc = x + (size_t)b * H * W * C + c;
  T* yc = y + (size_t)b * Ho * Wo * C + c;
  const int oy0 = tile * kRows;
  const int oy1 = min(oy0 + kRows, Ho);
  const int ix0 = ox - p0;

  // horizontal sums of the four input rows under the current output row
  float h0[VEC], h1[VEC], h2[VEC], h3[VEC];
  input_row<T, VEC>(xc, oy0 - p0, H, W, C, ix0, t, h0);
  input_row<T, VEC>(xc, oy0 - p0 + 1, H, W, C, ix0, t, h1);
  input_row<T, VEC>(xc, oy0 - p0 + 2, H, W, C, ix0, t, h2);
  for (int oy = oy0; oy < oy1; ++oy) {
    input_row<T, VEC>(xc, oy - p0 + 3, H, W, C, ix0, t, h3);
    *reinterpret_cast<Pack<T, VEC>*>(yc + ((size_t)oy * Wo + ox) * C) =
        vertical<T, VEC>(t, h0, h1, h2, h3, sc, bi, epi.act);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      h0[v] = h1[v];
      h1[v] = h2[v];
      h2[v] = h3[v];
    }
  }
}

template <typename T, int VEC>
cudaError_t launch_general(const Plan& p, const void* x, void* y, Epi epi,
                           Taps taps, cudaStream_t stream) {
  const long long ntile = (p.Ho + kRows - 1) / kRows;
  const long long total = (long long)p.B * ntile * p.Wo * (p.C / VEC);
  if (total == 0) return cudaSuccess;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  fused_blur4_kernel<T, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), epi, p.B, p.H, p.W, p.C,
      p.Ho, p.Wo, p.p0, taps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_general(const Plan& p, const void* x, void* y, Epi epi,
                             Taps taps, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) &
       15) == 0;
  if (aligned && p.C % VEC == 0)
    return launch_general<T, VEC>(p, x, y, epi, taps, stream);
  return launch_general<T, 1>(p, x, y, epi, taps, stream);
}

// ---------------------------------------------------------------- TMA path

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t"
      ".reg .pred P1;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n\t"
      "DONE:\n\t"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c, int w,
                                            int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::
          "r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c),
      "r"(w), "r"(h), "r"(b)
      : "memory");
}

struct Tile {
  int b, oy0, rows_out, ox0, c0;
};

// Tile order: channel chunk fastest, then strip, segment, batch (as
// ops/fused_blur.py::TilePlan.tile).  Blocks that run together read
// neighbouring chunks of the same pixels.
__device__ __forceinline__ Tile decode_tile(int t, const Plan& p) {
  Tile r;
  const int chunk = t % p.n_chunk;
  t /= p.n_chunk;
  const int strip = t % p.n_strip;
  t /= p.n_strip;
  const int seg = t % p.n_seg;
  r.b = t / p.n_seg;
  r.c0 = chunk * p.cc;
  r.ox0 = strip * p.wt;
  r.oy0 = seg * p.seg;
  r.rows_out = min(p.seg, p.Ho - r.oy0);
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
fused_blur4_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                       T* __restrict__ y, Plan p, Epi epi, Taps taps) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ unsigned char smem_raw[];
  // TMA destinations need 128-byte alignment; the plan leaves 128 spare
  unsigned char* smem = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  const uint32_t slot_bytes = (uint32_t)((p.wt + 3) * p.cc * sizeof(T));
  const int slot_stride = (int)((slot_bytes + 127) & ~127u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.stages * slot_stride);
  uint64_t* empty = full + p.stages;
  const int consumers = p.threads - 32;             // the last warp loads

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Slot s and the parity ph of its current use walk the ring in the same
  // order in the producer and the consumers, across tiles.
  int s = 0;
  uint32_t ph = 0;
  if (threadIdx.x >= consumers) {                    // producer warp
    if (threadIdx.x == consumers) {
      bool wrapped = false;                          // every slot used once
      for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
        const Tile tl = decode_tile(tile, p);
        for (int j = 0; j < tl.rows_out + 3; ++j) {
          if (wrapped) mbar_wait(&empty[s], ph ^ 1);
          mbar_expect_tx(&full[s], slot_bytes);
          tma_load_4d(smem + s * slot_stride, &xmap, &full[s], tl.c0,
                      tl.ox0 - p.p0, tl.oy0 - p.p0 + j, tl.b);
          if (++s == p.stages) {
            s = 0;
            ph ^= 1;
            wrapped = true;
          }
        }
      }
    }
    return;
  }

  const int nvec = p.cc / VEC;
  const int v = threadIdx.x % nvec;
  const int col = threadIdx.x / nvec;
  const bool active = col < p.wt;   // the rest only keep the barriers' count
  const int offset = col * p.cc + v * VEC;          // in a slot, elements
  const float t[4] = {taps.t[0], taps.t[1], taps.t[2], taps.t[3]};
  // h[j % 4]: horizontal sums of input row j of the tile.  The row loop is
  // unrolled by four so that the window's roles rotate without moves.
  float h[4][VEC];
  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    const Tile tl = decode_tile(tile, p);
    const int c = tl.c0 + v * VEC;
    const int ox = tl.ox0 + col;
    const bool store = active && ox < p.Wo;
    float sc[VEC], bi[VEC];
    load_epilogue<VEC>(epi, tl.b, p.C, c, sc, bi);
    T* yc = y + (((size_t)tl.b * p.Ho + tl.oy0) * p.Wo + ox) * p.C + c;
    const size_t out_row = (size_t)p.Wo * p.C;
    const int n_in = tl.rows_out + 3;
    for (int j0 = 0; j0 < n_in; j0 += 4) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + q;                        // input row of the tile
        if (j >= n_in) break;
        mbar_wait(&full[s], ph);
        if (active) {
          const T* src =
              reinterpret_cast<const T*>(smem + s * slot_stride) + offset;
#pragma unroll
          for (int e = 0; e < VEC; ++e) h[q][e] = 0.f;
#pragma unroll
          for (int dx = 0; dx < 4; ++dx) {
            const Pack<T, VEC> px =
                *reinterpret_cast<const Pack<T, VEC>*>(src + dx * p.cc);
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              h[q][e] = fmaf(t[dx], to_float(px.v[e]), h[q][e]);
          }
        }
        __syncwarp();
        if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[s]);
        if (++s == p.stages) {
          s = 0;
          ph ^= 1;
        }
        if (active && j >= 3) {
          const Pack<T, VEC> o = vertical<T, VEC>(
              t, h[(q + 1) & 3], h[(q + 2) & 3], h[(q + 3) & 3], h[q], sc,
              bi, epi.act);
          if (store)
            *reinterpret_cast<Pack<T, VEC>*>(yc + (size_t)(j - 3) * out_row) =
                o;
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// does not link libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// Codes below 0 are this file's own (see teb_error_string).
constexpr int kErrNoEncoder = -1;
constexpr int kErrEncodeBase = -1000;   // -1000 - CUresult

template <typename T>
int launch_tma(const Plan& p, const void* x, void* y, Epi epi, Taps taps,
               cudaStream_t stream) {
  if (p.n_tiles == 0) return cudaSuccess;
  if (p.threads > kMaxThreads || p.threads % 32 != 0 || p.threads < 64)
    return cudaErrorInvalidConfiguration;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return kErrNoEncoder;
  const cuuint64_t e = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)p.C, (cuuint64_t)p.W,
                              (cuuint64_t)p.H, (cuuint64_t)p.B};
  const cuuint64_t strides[3] = {p.C * e, (cuuint64_t)p.W * p.C * e,
                                 (cuuint64_t)p.H * p.W * p.C * e};
  const cuuint32_t box[4] = {(cuuint32_t)p.cc, (cuuint32_t)(p.wt + 3), 1,
                             1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  CUtensorMap map;
  const CUresult r = encode(
      &map,
      p.dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                   : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      4, const_cast<void*>(x), dims, strides, box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kErrEncodeBase - (int)r;

  // Above 48 KB a block's dynamic shared memory must be allowed first;
  // done once per device for the largest size asked.
  static std::atomic<int> allowed[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (p.smem > 48 * 1024 && p.smem > allowed[dev].load()) {
    err = cudaFuncSetAttribute(fused_blur4_tma_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               p.smem);
    if (err != cudaSuccess) return err;
    allowed[dev].store(p.smem);
  }
  fused_blur4_tma_kernel<T><<<p.grid, p.threads, p.smem, stream>>>(
      map, static_cast<T*>(y), p, epi, taps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the plan's path on `stream`.  scale ([B, C]) and bias ([C]) may
// be null; *_bf16 says whether each is bfloat16 (else float32).  Returns
// 0, a cudaError_t, or one of this file's negative codes.
int teb_fused_blur4(const TebPlan* plan, const void* x, void* y,
                    const void* scale, int scale_bf16, const void* bias,
                    int bias_bf16, float t0, float t1, float t2, float t3,
                    int act, void* stream) {
  const TebPlan& p = *plan;
  const Taps taps = {{t0, t1, t2, t3}};
  const Epi epi = {scale, bias, scale_bf16, bias_bf16, act};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.path == 1) {
    if (p.dtype == 0) return launch_tma<float>(p, x, y, epi, taps, s);
    if (p.dtype == 1) return launch_tma<__nv_bfloat16>(p, x, y, epi, taps, s);
  } else if (p.path == 0) {
    if (p.dtype == 0) return dispatch_general<float>(p, x, y, epi, taps, s);
    if (p.dtype == 1)
      return dispatch_general<__nv_bfloat16>(p, x, y, epi, taps, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* teb_error_string(int code) {
  static thread_local char buf[96];
  if (code == kErrNoEncoder)
    return "cuTensorMapEncodeTiled not found through cudaGetDriverEntryPoint";
  if (code <= kErrEncodeBase) {
    snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled failed: CUresult %d",
             kErrEncodeBase - code);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
