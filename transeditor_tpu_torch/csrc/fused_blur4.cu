// Fused 4-tap FIR blur + conv epilogue for Hopper (sm_90a).
//
//   y[b,oy,ox,c] = act( sum_{dy,dx} t[dy] t[dx] x[b, oy+dy-p0, ox+dx-p0, c]
//                       * scale[b,c] + bias[c] )
//   act(v) = sqrt(2) * (v >= 0 ? v : 0.2 v)      (optional)
//
// x and y are NHWC.  `t` holds the flipped per-axis taps (true
// convolution), passed by value; rows and columns of x outside the image
// read as zero, so the input is never padded in memory.  Sums, scale,
// bias and activation are float32; the result is rounded once to the
// output type (float32 or bfloat16).
//
// Replaces transeditor_tpu/ops/pallas_blur.py::fused_blur4 (the
// pl.pallas_call at :131), which ran the same chain on TPU VMEM tiles
// after copying a padded input through jnp.pad.
//
// Bound on the H100: memory.  Each output element needs 8 multiply-adds
// (4 per axis) against 2 bytes read and 2 written in bfloat16, far below
// the card's ~20 float32 operations per byte, so the least time is the
// bytes moved -- each input read once and each output written once --
// over 3.35 TB/s.  For one 256px image in bfloat16 the six calls of a
// forward move about 62 MB, about 18.5 us.
//
// What this simple design does about it: one thread owns a vector of
// channels (16 bytes: 8 bf16 or 4 f32) at one output column and walks
// kRows output rows down it.  Neighbouring threads take neighbouring
// channel vectors, so every load and store is a full 16-byte access and
// a warp reads whole contiguous runs.  The thread keeps the horizontal
// 4-tap sums of the last four input rows in registers, so each input row
// it touches is loaded once per output column (4 loads), not once per
// output row; the overlap between neighbouring columns is left to the
// L1/L2 caches.  Shapes whose channel count is not a multiple of the
// vector width, or whose pointers are not 16-byte aligned, take the same
// kernel one element at a time.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kRows = 8;       // output rows per thread
constexpr int kThreads = 256;  // threads per block
constexpr float kSqrt2 = 1.41421356237309515f;

struct Taps {
  float t[4];
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
fused_blur4_kernel(const T* __restrict__ x, T* __restrict__ y,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, int B, int H, int W, int C,
                   int Ho, int Wo, int p0, Taps taps, int act) {
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
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    sc[v] = scale != nullptr ? scale[(size_t)b * C + c + v] : 1.f;
    bi[v] = bias != nullptr ? bias[c + v] : 0.f;
  }

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
      h0[v] = h1[v];
      h1[v] = h2[v];
      h2[v] = h3[v];
    }
    *reinterpret_cast<Pack<T, VEC>*>(yc + ((size_t)oy * Wo + ox) * C) = o;
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, void* y, const float* scale,
                   const float* bias, int B, int H, int W, int C, int Ho,
                   int Wo, int p0, Taps taps, int act, cudaStream_t stream) {
  const long long ntile = (Ho + kRows - 1) / kRows;
  const long long total = (long long)B * ntile * Wo * (C / VEC);
  if (total == 0) return cudaSuccess;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  fused_blur4_kernel<T, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), scale, bias, B, H, W, C,
      Ho, Wo, p0, taps, act);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  scale ([B, C] float32) and bias
// ([C] float32) may be null.  Returns the cudaError_t of the launch.
int teb_fused_blur4(const void* x, void* y, const float* scale,
                    const float* bias, int dtype, int B, int H, int W, int C,
                    int Ho, int Wo, int p0, float t0, float t1, float t2,
                    float t3, int act, void* stream) {
  const Taps taps = {{t0, t1, t2, t3}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) &
       15) == 0;
  if (dtype == 0) {
    if (aligned && C % 4 == 0)
      return launch<float, 4>(x, y, scale, bias, B, H, W, C, Ho, Wo, p0, taps,
                              act, s);
    return launch<float, 1>(x, y, scale, bias, B, H, W, C, Ho, Wo, p0, taps,
                            act, s);
  }
  if (dtype == 1) {
    if (aligned && C % 8 == 0)
      return launch<__nv_bfloat16, 8>(x, y, scale, bias, B, H, W, C, Ho, Wo,
                                      p0, taps, act, s);
    return launch<__nv_bfloat16, 1>(x, y, scale, bias, B, H, W, C, Ho, Wo,
                                    p0, taps, act, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* teb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
