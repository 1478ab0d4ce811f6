// Int8 convolution for Hopper (sm_90a) on wgmma: the main path of
// ops/quant.py::conv2d_int8.  It computes exactly what conv2d_int8.cu
// computes (that file is the general path, for the shapes this one cannot
// describe):
//
//   acc[b,oy,ox,o] = sum_{ky,kx,i} x[b,iy,ix,i] * w[o,ky,kx,i]   (int32)
//   y = acc                                        (int32 out)
//   y = round(float(acc) * (sx[b] * sw[o]))        (float32, bfloat16 out)
//
// with the same dequantising arithmetic: __fmul_rn(__int2float_rn(acc),
// __fmul_rn(sx[b], sw[o])), rounded once by __float2bfloat16_rn, so the
// output is bit-equal to ops/quant.py::conv2d_int8_plain and
// dequantize_plain.  Two modes: stride 1 with any pad, and the stride-2
// transposed conv as four sub-pixel phases (each a plain convolution over
// its own 4, 2, 2 or 1 taps of a 3x3 kernel).
//
// Replaces transeditor_tpu/ops/quant.py:70 (conv2d_int8), which the JAX
// package leaves to XLA; PyTorch has no int8 convolution on CUDA.
//
// Bound on the H100: max(2 * useful MACs / 1,979 TOP/s, bytes / 3.35
// TB/s), each input, weight and output byte counted once: about 2.97 ms
// for the 13 convs of a 256px forward at batch 64 in bfloat16 out,
// operations-bound at every shape above 8x8 but close to bytes-bound at
// the two largest, whose bfloat16 output is most of 1.6 GB moved.
//
// What held the general path at 17% of that bound, and what this design
// does about each:
//  - mma.sync reaches part of the int8 rate: here two consumer
//    warpgroups each issue wgmma.mma_async m64nNk32 s8 on their half of
//    an M x N (pixels x output channels) tile, both operands K-major
//    from 128-byte-swizzled shared memory, sums in int32 registers.  The
//    tile is 128 x 128; for a bfloat16 output whose K is not split it is
//    128 x 256 where O >= 256 (each activation box is read from L2 half
//    as often) and 256 x 128 where O < 256 (each weight tile is).
//  - every thread copied with its own address arithmetic and a block
//    barrier closed each K step: here one producer thread keeps a ring
//    of 3-6 stages full with TMA tile loads, full / empty mbarriers
//    between it and the consumers, no block barrier in the main loop.
//    A K step is one tap x 128 input channels.  The activations' tile
//    is one box (128 channels, tw, th, nb) of a 4-D map over
//    [B, H, W, Ip] at the tap's signed offset: TMA's zero fill of what
//    lies outside the tensor *is* the padding, the image border and a
//    channel count under 128.  The weights' tile is a box (128, 1, N)
//    of a 3-D map over [O, kh * kw, Ip].  Each stage holds one of each.
//  - a non-persistent grid left the epilogue alone and the small maps'
//    SMs idle: here one block an SM walks a list of work items (built
//    and cached by the wrapper, ordered heaviest first, so phases of
//    4, 2, 2 and 1 taps balance out); the producer runs on into the next
//    item while the consumers write this one's output to shared memory
//    and one thread stores it with TMA (a per-phase 5-D map whose H and
//    W strides are doubled for a transposed phase, so every-other-pixel
//    output is a plain box; clipping gives the ragged edges).
//  - too few tiles at 4x4 and 8x8: the wrapper may split K into S
//    pieces.  Each piece stores its int32 partial sums in slice s of a
//    workspace [S, B, Ho, Wo, O] and a second small pass adds the S
//    slices and applies the epilogue; int32 addition is exact, so the
//    result is bit-equal whatever the order.
// The wrapper's plan (ops/quant.py::plan_conv) chooses the tile, each
// phase's box (nb, th, tw) of at most M pixels to waste the fewest rows,
// the split, the grid and the ring depth, and passes them in a TewPlan.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <type_traits>

// Mirrors ops/quant.py::_CWgmmaPlan.  Outside the anonymous namespace:
// the exported entry point takes it.
struct TewPlan {
  int B, H, W, Ip, O, kh, kw, Ho, Wo, pad, transpose;
  int out_kind;                // y: 0 int32, 1 float32, 2 bfloat16
  int split;                   // K pieces; > 1 stores int32 to the workspace
  int tile_m;                  // output pixels a work item: 128 or 256
  int tile_n;                  // output channels a work item: 128 or 256
  int n_items, grid, stages, smem;
  int nb[4], th[4], tw[4];     // each phase's box of output pixels
};

namespace {

constexpr int kBK = 128;                  // bytes of K a step
constexpr int kThreads = 288;             // 2 consumer warpgroups + producer
constexpr int kConsumers = 256;

struct Maps {
  CUtensorMap a[4];    // activations, one per phase (its own box)
  CUtensorMap y[4];    // output or workspace, one per phase
  CUtensorMap w;       // weights
};

// The taps of phase z (outputs (2qy + py, 2qx + px) of a transposed conv,
// all outputs of a stride-1 one): nx taps along x; tap j along y is
// ky = ky0 + j*kstep, reading input row qy + cy0 + j*cstep (along x alike).
struct Phase {
  int nx, ky0, kx0, kstep, cy0, cx0, cstep;
};

__device__ __forceinline__ Phase make_phase(const TewPlan& p, int z) {
  Phase f;
  if (p.transpose) {
    const int py = z >> 1, px = z & 1;
    f.nx = (p.kw - px + 1) / 2;
    f.ky0 = py;
    f.kx0 = px;
    f.kstep = 2;
    f.cy0 = f.cx0 = 0;
    f.cstep = -1;
  } else {
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
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::
          "r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_5d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5, %6}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until the committed stores have read their shared-memory source.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// A K-major operand of 8-row groups of 128-byte rows, 128-byte swizzle:
// start address >> 4, leading offset 1 (unused by this layout), stride
// between 8-row groups 1024 bytes, layout type 1 (SWIZZLE_128B).
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t addr = smem_addr(tile);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d[64 x N] (+)= a[64 x 32] . b[N x 32]^T, s8 x s8 -> s32, N = 128 or
// 256.  Thread t of the warpgroup holds rows 16*(t/32) + (t%32)/4 (+8) and
// columns 8j + 2(t%4) (+1): d[4j + 2h + e] at (row + 8h, 8j + 2(t%4) + e).
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, %128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The dequantised value, as the general path and the plain version form it.
__device__ __forceinline__ float dequant(int acc, float s) {
  return __fmul_rn(__int2float_rn(acc), s);
}

// Two neighbouring output channels of one row into the staged box.
template <typename T>
__device__ __forceinline__ void stage_pair(unsigned char* at, int a0, int a1,
                                           float s0, float s1);
template <>
__device__ __forceinline__ void stage_pair<int>(unsigned char* at, int a0,
                                                int a1, float, float) {
  *reinterpret_cast<int2*>(at) = make_int2(a0, a1);
}
template <>
__device__ __forceinline__ void stage_pair<float>(unsigned char* at, int a0,
                                                  int a1, float s0,
                                                  float s1) {
  *reinterpret_cast<float2*>(at) = make_float2(dequant(a0, s0),
                                               dequant(a1, s1));
}
template <>
__device__ __forceinline__ void stage_pair<__nv_bfloat16>(unsigned char* at,
                                                          int a0, int a1,
                                                          float s0,
                                                          float s1) {
  __nv_bfloat162 v;
  v.x = __float2bfloat16_rn(dequant(a0, s0));
  v.y = __float2bfloat16_rn(dequant(a1, s1));
  *reinterpret_cast<__nv_bfloat162*>(at) = v;
}

// Work item i: (phase, b0, y0, x0) and (n0, k0, k1, s) -- a box of at most
// BM of the phase's output pixels at (b0, y0, x0), output channels
// n0..n0+BN-1, K steps [k0, k1), split slice s.  K step k is tap k / nchunk
// (row-major over the phase's taps) and input channels 128 * (k % nchunk)
// on.  Each consumer warpgroup owns BM / 2 rows: BM / 128 m64 products a
// k32 step, BM / 128 x BN / 2 int32 sums a thread.
template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv2d_int8_wgmma_kernel(const __grid_constant__ Maps maps, const TewPlan p,
                         const int4* __restrict__ items,
                         const float* __restrict__ sx,
                         const float* __restrict__ sw) {
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: align the ring to that
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  constexpr int kTileA = BM * kBK;
  constexpr int kStage = kTileA + BN * kBK;
  constexpr int kRows = BM / 2;                // rows a consumer warpgroup
  constexpr int kM64 = kRows / 64;
  constexpr int kEsz = sizeof(T);
  constexpr int kBoxes = BN * kEsz / 128;      // staged boxes a tile
  constexpr int kBox = BM * 128;               // bytes a staged box
  unsigned char* staged = smem + p.stages * kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(staged + kBoxes * kBox);
  uint64_t* empty = full + p.stages;
  const int nchunk = (p.Ip + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);          // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Slot s and the parity ph of its current use walk the ring in the same
  // order in the producer and the consumers, across items.
  int s = 0;
  uint32_t ph = 0;
  if (threadIdx.x >= kConsumers) {                   // producer warp
    if (threadIdx.x == kConsumers) {
      for (int it = blockIdx.x; it < p.n_items; it += gridDim.x) {
        const int4 h = items[2 * it], t = items[2 * it + 1];
        const Phase f = make_phase(p, h.x);
        const uint32_t bytes =
            (uint32_t)(p.nb[h.x] * p.th[h.x] * p.tw[h.x]) * kBK + BN * kBK;
        for (int k = t.y; k < t.z; ++k) {
          const int tap = k / nchunk, c = (k - tap * nchunk) * kBK;
          const int jy = tap / f.nx, jx = tap - jy * f.nx;
          const int ky = f.ky0 + jy * f.kstep, kx = f.kx0 + jx * f.kstep;
          const int cy = f.cy0 + jy * f.cstep, cx = f.cx0 + jx * f.cstep;
          mbar_wait(&empty[s], ph ^ 1);    // a fresh barrier passes parity 1
          mbar_expect_tx(&full[s], bytes);
          unsigned char* st = smem + s * kStage;
          tma_load_4d(st, &maps.a[h.x], &full[s], c, h.w + cx, h.z + cy, h.y);
          tma_load_3d(st + kTileA, &maps.w, &full[s], c, ky * p.kw + kx, t.x);
          if (++s == p.stages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7;                   // consumer warpgroup
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const bool leader = (threadIdx.x & 127) == 0;
  int acc[kM64][BN / 2];
#pragma unroll
  for (int m = 0; m < kM64; ++m)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[m][i] = 0;
  for (int it = blockIdx.x; it < p.n_items; it += gridDim.x) {
    const int4 h = items[2 * it], t = items[2 * it + 1];
    const int z = h.x;

    // main loop: keep one step's wgmmas in flight, free the slot before
    int prev = -1;
    for (int k = t.y; k < t.z; ++k) {
      mbar_wait(&full[s], ph);
      const unsigned char* st = smem + s * kStage;
      const uint64_t da = sw128_desc(st + wg * kRows * kBK);
      const uint64_t db = sw128_desc(st + kTileA);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)         // +32 bytes: +2 in the
#pragma unroll                                      // address field, and
        for (int m = 0; m < kM64; ++m)              // 64 rows +512
          wgmma_s8(acc[m], da + 512 * m + 2 * kk, db + 2 * kk,
                   (k > t.y || kk > 0) ? 1 : 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (prev >= 0 && leader) mbar_arrive(&empty[prev]);
      prev = s;
      if (++s == p.stages) {
        s = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
    if (prev >= 0 && leader) mbar_arrive(&empty[prev]);

    // epilogue: registers -> staged boxes (128-byte swizzle, as the store
    // map reads them) -> TMA store by one thread
    const int rows = p.th[z] * p.tw[z];
    float sxr[kM64][2] = {};
    const int r0 = wg * kRows + warp * 16 + (lane >> 2);
    if (p.split == 1 && p.out_kind != 0) {
#pragma unroll
      for (int m = 0; m < kM64; ++m)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int b = h.y + (r0 + 64 * m + 8 * hh) / rows;
          sxr[m][hh] = b < p.B ? sx[b] : 0.f;
        }
    }
    if (threadIdx.x == 0) bulk_wait_read();        // the last item's stores
    consumers_sync();
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      const int o = t.x + col;
      float2 swv = make_float2(0.f, 0.f);
      if (p.split == 1 && p.out_kind != 0 && o < p.O)
        swv = *reinterpret_cast<const float2*>(sw + o);
      const int byte = col * kEsz;
      const int box = byte >> 7, chunk = (byte & 127) >> 4;
#pragma unroll
      for (int m = 0; m < kM64; ++m)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = r0 + 64 * m + 8 * hh;
          unsigned char* at = staged + box * kBox + r * 128 +
                              ((chunk ^ (r & 7)) << 4) + (byte & 15);
          stage_pair<T>(at, acc[m][4 * j + 2 * hh],
                        acc[m][4 * j + 2 * hh + 1],
                        __fmul_rn(sxr[m][hh], swv.x),
                        __fmul_rn(sxr[m][hh], swv.y));
        }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumers_sync();
    if (threadIdx.x == 0) {
#pragma unroll
      for (int b = 0; b < kBoxes; ++b)
        tma_store_5d(&maps.y[z], staged + b * kBox, t.x + b * (128 / kEsz),
                     h.w, h.z, h.y, t.w);
      bulk_commit();
    }
  }
  if (threadIdx.x == 0) bulk_wait();
}

// Split K: y[i] = epilogue(sum_s ws[s][i]) over the B*Ho*Wo*O outputs, four
// a thread (O is a multiple of 8).
template <typename T>
__global__ void __launch_bounds__(256)
conv2d_int8_split_reduce_kernel(const int* __restrict__ ws, int split,
                                long long n, long long per_image, int O,
                                const float* __restrict__ sx,
                                const float* __restrict__ sw,
                                T* __restrict__ y) {
  const long long i =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  int4 a = *reinterpret_cast<const int4*>(ws + i);
  for (int s = 1; s < split; ++s) {
    const int4 v = *reinterpret_cast<const int4*>(ws + s * n + i);
    a.x += v.x;
    a.y += v.y;
    a.z += v.z;
    a.w += v.w;
  }
  if constexpr (std::is_same_v<T, int>) {
    *reinterpret_cast<int4*>(y + i) = a;
  } else {
    const int acc[4] = {a.x, a.y, a.z, a.w};
    const float sxb = sx[i / per_image];
    const int o = (int)(i % O);
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = dequant(acc[e], __fmul_rn(sxb, sw[o + e]));
    if constexpr (std::is_same_v<T, float>) {
      *reinterpret_cast<float4*>(y + i) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      __nv_bfloat162 lo, hi;
      lo.x = __float2bfloat16_rn(v[0]);
      lo.y = __float2bfloat16_rn(v[1]);
      hi.x = __float2bfloat16_rn(v[2]);
      hi.y = __float2bfloat16_rn(v[3]);
      reinterpret_cast<__nv_bfloat162*>(y + i)[0] = lo;
      reinterpret_cast<__nv_bfloat162*>(y + i)[1] = hi;
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// does not link libcuda (as in fused_blur4.cu).
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

// Codes below 0 are this file's own (see tew_error_string).
constexpr int kErrNoEncoder = -1;
constexpr int kErrEncodeBase = -1000;   // -1000 - (10000 * map + CUresult)

int encode(EncodeTiled fn, CUtensorMap* map, CUtensorMapDataType type,
           int rank, const void* base, const cuuint64_t* dims,
           const cuuint64_t* strides, const cuuint32_t* box, int which) {
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r =
      fn(map, type, rank, const_cast<void*>(base), dims, strides, box, ones,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncodeBase - (10000 * which + (int)r);
}

template <typename T, int BM, int BN>
int set_smem(const TewPlan& p) {
  // Above 48 KB a block's dynamic shared memory must be allowed first;
  // done once per device for the largest size asked.
  static std::atomic<int> allowed[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (p.smem > allowed[dev].load()) {
    err = cudaFuncSetAttribute(conv2d_int8_wgmma_kernel<T, BM, BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               p.smem);
    if (err != cudaSuccess) return err;
    allowed[dev].store(p.smem);
  }
  return 0;
}

template <typename T, int BM, int BN>
int launch_main(const TewPlan& p, const Maps& maps, const void* items,
                const float* sx, const float* sw, cudaStream_t stream) {
  const int rc = set_smem<T, BM, BN>(p);
  if (rc != 0) return rc;
  conv2d_int8_wgmma_kernel<T, BM, BN><<<p.grid, kThreads, p.smem, stream>>>(
      maps, p, static_cast<const int4*>(items), sx, sw);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_reduce(const TewPlan& p, const int* ws, const float* sx,
                  const float* sw, void* y, cudaStream_t stream) {
  const long long per_image = (long long)p.Ho * p.Wo * p.O;
  const long long n = per_image * p.B;
  const long long threads = n / 4;
  conv2d_int8_split_reduce_kernel<T>
      <<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
          ws, p.split, n, per_image, p.O, sx, sw, static_cast<T*>(y));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the wgmma path on `stream`: the main kernel and, when the plan
// splits K, the reduction pass.  items: the plan's int32 [n_items, 8] work
// list on the device; ws: int32 [split, B, Ho, Wo, O] when split > 1, else
// unused.  sx ([B]) and sw ([O]) are float32, read only for a float
// output.  Returns 0, a cudaError_t, or one of this file's negative codes.
int tew_conv2d_int8(const TewPlan* plan, const void* x, const void* w,
                    const void* sx, const void* sw, void* y, void* ws,
                    const void* items, void* stream) {
  const TewPlan& p = *plan;
  if (p.n_items == 0) return cudaSuccess;
  // a tile of 256 pixels or channels stages bfloat16 only (its 4-byte
  // staging would leave too little shared memory for the ring)
  const int wide = (p.tile_m == 256) + (p.tile_n == 256);
  if (p.out_kind < 0 || p.out_kind > 2 || p.split < 1 ||
      (p.split > 1 && ws == nullptr) ||
      (p.tile_m != 128 && p.tile_m != 256) ||
      (p.tile_n != 128 && p.tile_n != 256) ||
      (wide > 0 && (wide > 1 || p.split > 1 || p.out_kind != 2)))
    return cudaErrorInvalidValue;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kErrNoEncoder;
  const int phases = p.transpose ? 4 : 1;
  const bool split = p.split > 1;
  const int kind = split ? 0 : p.out_kind;            // what the kernel stores
  const cuuint64_t esz = kind == 2 ? 2 : 4;
  const CUtensorMapDataType ytype =
      kind == 0 ? CU_TENSOR_MAP_DATA_TYPE_INT32
                : kind == 1 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  unsigned char* target = static_cast<unsigned char*>(split ? ws : y);
  Maps maps;
  int rc;
  const cuuint64_t ip = p.Ip, taps = (cuuint64_t)p.kh * p.kw;
  {
    const cuuint64_t dims[3] = {ip, taps, (cuuint64_t)p.O};
    const cuuint64_t strides[2] = {ip, taps * ip};
    const cuuint32_t box[3] = {kBK, 1, (cuuint32_t)p.tile_n};
    rc = encode(fn, &maps.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, w, dims,
                strides, box, 0);
    if (rc != 0) return rc;
  }
  const cuuint64_t o = p.O, wo = p.Wo, img = (cuuint64_t)p.Ho * p.Wo * p.O;
  for (int z = 0; z < phases; ++z) {
    const int py = p.transpose ? z >> 1 : 0, px = p.transpose ? z & 1 : 0;
    const cuuint64_t so = p.transpose ? 2 : 1;
    const cuuint64_t hq = p.transpose ? (p.Ho - py + 1) / 2 : p.Ho;
    const cuuint64_t wq = p.transpose ? (p.Wo - px + 1) / 2 : p.Wo;
    const cuuint32_t nb = p.nb[z], th = p.th[z], tw = p.tw[z];
    {
      const cuuint64_t dims[4] = {ip, (cuuint64_t)p.W, (cuuint64_t)p.H,
                                  (cuuint64_t)p.B};
      const cuuint64_t strides[3] = {ip, ip * p.W, ip * p.W * p.H};
      const cuuint32_t box[4] = {kBK, tw, th, nb};
      rc = encode(fn, &maps.a[z], CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, x, dims,
                  strides, box, 1 + z);
      if (rc != 0) return rc;
    }
    {
      const cuuint64_t dims[5] = {o, wq, hq, (cuuint64_t)p.B,
                                  (cuuint64_t)p.split};
      const cuuint64_t strides[4] = {so * o * esz, so * wo * o * esz,
                                     img * esz, img * p.B * esz};
      const cuuint32_t box[5] = {(cuuint32_t)(128 / esz), tw, th, nb, 1};
      rc = encode(fn, &maps.y[z], ytype, 5,
                  target + ((py * wo + px) * o) * esz, dims, strides, box,
                  5 + z);
      if (rc != 0) return rc;
    }
  }
  for (int z = phases; z < 4; ++z) {      // unused; keep the bytes defined
    maps.a[z] = maps.a[0];
    maps.y[z] = maps.y[0];
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fsx = static_cast<const float*>(sx);
  const float* fsw = static_cast<const float*>(sw);
  using bf16 = __nv_bfloat16;
  if (kind == 0)
    rc = launch_main<int, 128, 128>(p, maps, items, fsx, fsw, st);
  else if (kind == 1)
    rc = launch_main<float, 128, 128>(p, maps, items, fsx, fsw, st);
  else if (p.tile_n == 256)
    rc = launch_main<bf16, 128, 256>(p, maps, items, fsx, fsw, st);
  else if (p.tile_m == 256)
    rc = launch_main<bf16, 256, 128>(p, maps, items, fsx, fsw, st);
  else
    rc = launch_main<bf16, 128, 128>(p, maps, items, fsx, fsw, st);
  if (rc != 0 || !split) return rc;
  const int* iws = static_cast<const int*>(ws);
  if (p.out_kind == 0) return launch_reduce<int>(p, iws, fsx, fsw, y, st);
  if (p.out_kind == 1) return launch_reduce<float>(p, iws, fsx, fsw, y, st);
  return launch_reduce<__nv_bfloat16>(p, iws, fsx, fsw, y, st);
}

const char* tew_error_string(int code) {
  static thread_local char buf[128];
  static const char* names[9] = {"weights", "activations phase 0",
                                 "activations phase 1", "activations phase 2",
                                 "activations phase 3", "output phase 0",
                                 "output phase 1", "output phase 2",
                                 "output phase 3"};
  if (code == kErrNoEncoder)
    return "cuTensorMapEncodeTiled not found through cudaGetDriverEntryPoint";
  if (code <= kErrEncodeBase) {
    const int rest = kErrEncodeBase - code;
    const int which = rest / 10000;
    snprintf(buf, sizeof(buf),
             "cuTensorMapEncodeTiled failed for the %s map: CUresult %d",
             which < 9 ? names[which] : "?", rest % 10000);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
