// Int8 convolution with exact int32 accumulation for Hopper (sm_90a).
//
//   acc[b,oy,ox,o] = sum_{ky,kx,i} x[b,iy,ix,i] * w[o,ky,kx,i]   (int32)
//   y = acc                                        (out_kind 0, int32)
//   y = round(float(acc) * (sx[b] * sw[o]))        (1: float32, 2: bfloat16)
//
// x is int8 NHWC [B, H, W, Ip] and w int8 [O, kh, kw, Ip]; Ip is a
// multiple of 16 (the wrapper zero-pads the channels, which is exact for
// integer sums).  Three modes, as ops/quant.py::conv2d_int8 names them:
//  - stride s with pad p:   iy = oy*s - p + ky (s = 1 for the 3x3 convs,
//    s = 2 with p = 0 for the downsample);
//  - transposed, stride 2:  out[oy] = sum_{2*iy + ky = oy} x[iy] w[ky],
//    output 2H + kh - 2 (lhs dilation 2 with pad kh-1 over the flipped
//    kernel, which is how the JAX package writes it).
// The dequantised epilogue is bit-equal to the plain version: the f32
// product sx[b]*sw[o] is formed first (__fmul_rn), the int32 sum converted
// with __int2float_rn and multiplied with __fmul_rn, then rounded once to
// bfloat16 with __float2bfloat16_rn.
//
// Replaces transeditor_tpu/ops/quant.py::conv2d_int8, which the JAX
// package leaves to XLA (lax.conv_general_dilated with int32
// accumulation); it has no Pallas predecessor and PyTorch has no int8
// convolution on CUDA.
//
// Bound on the H100: max(2*MACs / 1.979e15, bytes / 3.35e12), counting the
// MACs whose input lies inside the image (for the transposed mode only the
// products with a real input pixel, a quarter of the dilated gather's) and
// each input, weight and output byte once.  For the 256px generator's 13
// convs in bfloat16 out that is ~45 GMAC an image: operations bound at
// every shape above 8x8, about 2.9 ms an image batch of 64.
//
// Design (right and simple first): an implicit GEMM over (output pixels x
// output channels) with K = taps x Ip.
//  - A block computes a 128 x 128 tile of (pixels, channels) with 8 warps,
//    each a 64 x 32 sub-tile of m16n8k32 s8 tensor-core products
//    (mma.sync) accumulated in int32 registers.
//  - K runs in steps of 64 bytes: one tap (ky, kx) and 64 input channels.
//    Each step's A tile (128 pixels x 64 channels, gathered through the
//    tap's offset) and B tile (128 output channels x 64) go to shared
//    memory with 16-byte cp.async copies whose zero fill gives the
//    padding, the image border and the ragged tile edges; a 4-stage ring
//    keeps three steps in flight while one is multiplied.  Rows are 80
//    bytes apart, so ldmatrix reads them without bank conflicts.
//  - The transposed mode runs as four sub-pixel phases (blockIdx.z = the
//    output row and column parity): each phase is a plain convolution over
//    its own taps (4, 2, 2 and 1 of a 3x3 kernel), so no product is spent
//    on the zeros of the dilated input.
// What it leaves of the bound: mma.sync reaches only part of Hopper's int8
// rate (wgmma is the only way to all of it), and the gather, the ring and
// the epilogue are not overlapped across tiles.  A wgmma / TMA redesign is
// a later step (ROADMAP, Queue 2).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>

// Mirrors ops/quant.py::_CPlan.  Outside the anonymous namespace: the
// exported entry point takes it.
struct TeiPlan {
  int B, H, W, Ip;        // input, NHWC int8
  int O, kh, kw;          // weights [O, kh, kw, Ip] int8
  int Ho, Wo;             // output, NHWC
  int stride, pad, transpose;
  int out_kind;           // 0 int32, 1 float32, 2 bfloat16
};

namespace {

constexpr int BM = 128;           // output pixels a block
constexpr int BN = 128;           // output channels a block
constexpr int BK = 64;            // bytes of K a step
constexpr int LDS = 80;           // shared-memory row stride, bytes
constexpr int STAGES = 4;
constexpr int THREADS = 256;
constexpr int STAGE_BYTES = (BM + BN) * LDS;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;

// The geometry of one phase: outputs (qy*so + py, qx*so + px) for qy < Hq,
// qx < Wq; tap j along y is ky = ky0 + j*kstep with input row
// iy = qy*a + cy0 + j*cstep (the same along x).
struct Phase {
  int py, px, so, Hq, Wq, a;
  int ny, nx, ky0, kx0, kstep, cy0, cx0, cstep;
};

__device__ __forceinline__ Phase make_phase(const TeiPlan& p, int z) {
  Phase f;
  if (p.transpose) {
    f.py = z >> 1;
    f.px = z & 1;
    f.so = 2;
    f.Hq = (p.Ho - f.py + 1) / 2;
    f.Wq = (p.Wo - f.px + 1) / 2;
    f.a = 1;
    f.ny = (p.kh - f.py + 1) / 2;
    f.nx = (p.kw - f.px + 1) / 2;
    f.ky0 = f.py;
    f.kx0 = f.px;
    f.kstep = 2;
    f.cy0 = 0;
    f.cx0 = 0;
    f.cstep = -1;
  } else {
    f.py = f.px = 0;
    f.so = 1;
    f.Hq = p.Ho;
    f.Wq = p.Wo;
    f.a = p.stride;
    f.ny = p.kh;
    f.nx = p.kw;
    f.ky0 = f.kx0 = 0;
    f.kstep = 1;
    f.cy0 = f.cx0 = -p.pad;
    f.cstep = 1;
  }
  return f;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One output element: the int32 sum, or its dequantised value.
__device__ __forceinline__ void store(const TeiPlan& p, void* y, size_t i,
                                      int acc, float s) {
  if (p.out_kind == 0) {
    static_cast<int*>(y)[i] = acc;
  } else {
    const float v = __fmul_rn(__int2float_rn(acc), s);
    if (p.out_kind == 1)
      static_cast<float*>(y)[i] = v;
    else
      static_cast<__nv_bfloat16*>(y)[i] = __float2bfloat16_rn(v);
  }
}

__global__ void __launch_bounds__(THREADS)
conv2d_int8_kernel(TeiPlan p, const int8_t* __restrict__ x,
                   const int8_t* __restrict__ w,
                   const float* __restrict__ sx, const float* __restrict__ sw,
                   void* __restrict__ y) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Phase f = make_phase(p, blockIdx.z);
  const int M = p.B * f.Hq * f.Wq;
  const int m0 = blockIdx.x * BM;
  if (m0 >= M) return;                       // a phase with fewer pixels
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  // This thread's two copy rows of each tile and its 16-byte column.
  const int crow = tid >> 2, ccol = (tid & 3) * 16;
  int qb[2], qyy[2], qxx[2];
  bool mvalid[2], nvalid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + crow + r * 64;
    mvalid[r] = m < M;
    const int mm = mvalid[r] ? m : 0;
    qb[r] = mm / (f.Hq * f.Wq);
    const int rem = mm - qb[r] * f.Hq * f.Wq;
    qyy[r] = rem / f.Wq;
    qxx[r] = rem - qyy[r] * f.Wq;
    nvalid[r] = n0 + crow + r * 64 < p.O;
  }
  const int nchunk = (p.Ip + BK - 1) / BK;
  const int KT = f.ny * f.nx * nchunk;

  auto load_stage = [&](int slot, int kt) {
    const int tap = kt / nchunk;
    const int ic = (kt - tap * nchunk) * BK + ccol;
    const int jy = tap / f.nx, jx = tap - jy * f.nx;
    const int ky = f.ky0 + jy * f.kstep, kx = f.kx0 + jx * f.kstep;
    const int cy = f.cy0 + jy * f.cstep, cx = f.cx0 + jx * f.cstep;
    const bool kvalid = ic < p.Ip;
    unsigned char* sa = smem + slot * STAGE_BYTES;
    unsigned char* sb = sa + BM * LDS;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = crow + r * 64;
      const int iy = qyy[r] * f.a + cy, ix = qxx[r] * f.a + cx;
      const bool va = kvalid && mvalid[r] && iy >= 0 && iy < p.H && ix >= 0 &&
                      ix < p.W;
      const int8_t* src =
          va ? x + ((size_t)(qb[r] * p.H + iy) * p.W + ix) * p.Ip + ic : x;
      cp_async16(smem_addr(sa + row * LDS + ccol), src, va ? 16 : 0);
      const bool vb = kvalid && nvalid[r];
      const int8_t* wsrc =
          vb ? w + ((size_t)((n0 + row) * p.kh + ky) * p.kw + kx) * p.Ip + ic
             : w;
      cp_async16(smem_addr(sb + row * LDS + ccol), wsrc, vb ? 16 : 0);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }

  const int wm = warp >> 2, wn = warp & 3;   // 2 x 4 warps of 64 x 32
  // ldmatrix row addresses: A by (lane % 16, lane / 16); B by
  // (lane % 8 + 8 * (lane / 16), (lane / 8) % 2)
  const int a_row = wm * 64 + (lane & 15), a_col = (lane >> 4) * 16;
  const int b_row = wn * 32 + (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) * 16;

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int pre = kt + STAGES - 1;
    if (pre < KT) load_stage(pre % STAGES, pre);
    cp_async_commit();

    const unsigned char* sa = smem + (kt % STAGES) * STAGE_BYTES;
    const unsigned char* sb = sa + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(smem_addr(sa + (a_row + mt * 16) * LDS + kk + a_col),
                    af[mt]);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4(smem_addr(sb + (b_row + np * 16) * LDS + kk + b_col),
                    bf[np]);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_s8(acc[mt][nt], af[mt], bf[nt >> 1][(nt & 1) * 2],
                 bf[nt >> 1][(nt & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  // Epilogue: c0, c1 at (row g, channels 2t, 2t+1); c2, c3 at row g + 8.
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 64 + mt * 16 + g + h * 8;
      if (m >= M) continue;
      const int b = m / (f.Hq * f.Wq);
      const int rem = m - b * f.Hq * f.Wq;
      const int qy = rem / f.Wq, qx = rem - (rem / f.Wq) * f.Wq;
      const int oy = qy * f.so + f.py, ox = qx * f.so + f.px;
      const size_t base = ((size_t)(b * p.Ho + oy) * p.Wo + ox) * p.O;
      const float sxb = p.out_kind ? sx[b] : 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int o = n0 + wn * 32 + nt * 8 + t * 2;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (o + e >= p.O) continue;
          const float s = p.out_kind ? __fmul_rn(sxb, sw[o + e]) : 0.f;
          store(p, y, base + o + e, acc[mt][nt][h * 2 + e], s);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`.  sx ([B]) and sw ([O]) are float32 and
// read only when out_kind is 1 or 2.  Returns 0 or a cudaError_t.
int tei_conv2d_int8(const TeiPlan* plan, const void* x, const void* w,
                    const void* sx, const void* sw, void* y, void* stream) {
  const TeiPlan& p = *plan;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv2d_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  int max_m = 0;
  const int phases = p.transpose ? 4 : 1;
  for (int z = 0; z < phases; ++z) {
    const int py = p.transpose ? z >> 1 : 0, px = p.transpose ? z & 1 : 0;
    const int hq = p.transpose ? (p.Ho - py + 1) / 2 : p.Ho;
    const int wq = p.transpose ? (p.Wo - px + 1) / 2 : p.Wo;
    const int m = p.B * hq * wq;
    if (m > max_m) max_m = m;
  }
  const dim3 grid((max_m + BM - 1) / BM, (p.O + BN - 1) / BN, phases);
  conv2d_int8_kernel<<<grid, THREADS, SMEM_BYTES,
                       static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(sx), static_cast<const float*>(sw), y);
  return (int)cudaGetLastError();
}

const char* tei_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
