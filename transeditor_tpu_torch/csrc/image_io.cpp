// Host-side image decoding helpers for the data pipeline
// (transeditor_tpu_torch/utils/image.py), built with g++ at first use.
//
//   teimg_png_unfilter - undo PNG row filtering (None, Sub, Up, Average,
//                        Paeth), one row after another, as libpng does;
//   teimg_resample     - one separable pass of Pillow's fixed-point
//                        resampling (Resample.c, 8 bits a channel): each
//                        output pixel a weighted sum of a window of input
//                        pixels, rounded and clipped to 8 bits.
//
// A plain C interface, called through ctypes (which releases the GIL, so
// the pipeline's reader threads run these in parallel).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;    // Pillow's PRECISION_BITS

inline uint8_t clip8(int32_t v) {
  if (v >= (1 << kPrecisionBits << 8)) return 255;
  if (v <= 0) return 0;
  return static_cast<uint8_t>(v >> kPrecisionBits);
}

inline int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

}  // namespace

extern "C" {

// rows: [h, 1 + n] as stored in the PNG stream (a filter byte, then n =
// width * bpp filtered bytes); out: [h, n].  bpp: bytes a pixel.
// Returns 0, or 1 + the index of the first row whose filter type is not
// 0-4 (out is then incomplete).
long teimg_png_unfilter(const uint8_t* rows, long h, long n, long bpp,
                        uint8_t* out) {
  std::vector<uint8_t> zero(static_cast<size_t>(n), 0);
  for (long y = 0; y < h; ++y) {
    const uint8_t* src = rows + y * (n + 1);
    const uint8_t filter = src[0];
    ++src;
    uint8_t* dst = out + y * n;
    const uint8_t* up = y ? out + (y - 1) * n : zero.data();
    switch (filter) {
      case 0:
        std::memcpy(dst, src, static_cast<size_t>(n));
        break;
      case 1:
        for (long i = 0; i < n; ++i)
          dst[i] = static_cast<uint8_t>(src[i] + (i >= bpp ? dst[i - bpp] : 0));
        break;
      case 2:
        for (long i = 0; i < n; ++i)
          dst[i] = static_cast<uint8_t>(src[i] + up[i]);
        break;
      case 3:
        for (long i = 0; i < n; ++i) {
          const int a = i >= bpp ? dst[i - bpp] : 0;
          dst[i] = static_cast<uint8_t>(src[i] + ((a + up[i]) >> 1));
        }
        break;
      case 4:
        for (long i = 0; i < n; ++i) {
          const int a = i >= bpp ? dst[i - bpp] : 0;
          const int c = i >= bpp ? up[i - bpp] : 0;
          dst[i] = static_cast<uint8_t>(src[i] + paeth(a, up[i], c));
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

// in: [outer, n_in, inner] uint8; out: [outer, n_out, inner] uint8.
// Output index j along the middle axis reads input indices bounds[2j] ..
// bounds[2j] + bounds[2j + 1] - 1 with the weights wts[j * ksize ..]
// (fixed point, kPrecisionBits fraction bits).  The horizontal pass of an
// [H, W, C] image is outer = H, inner = C; the vertical one outer = 1,
// inner = W * C.
void teimg_resample(const uint8_t* in, uint8_t* out, long outer, long n_in,
                    long n_out, long inner, const int32_t* bounds,
                    const int32_t* wts, long ksize) {
  std::vector<int32_t> acc(static_cast<size_t>(inner));
  for (long o = 0; o < outer; ++o) {
    const uint8_t* plane = in + o * n_in * inner;
    for (long j = 0; j < n_out; ++j) {
      const int32_t* k = wts + j * ksize;
      const long xmin = bounds[2 * j], xsize = bounds[2 * j + 1];
      for (long i = 0; i < inner; ++i) acc[i] = 1 << (kPrecisionBits - 1);
      for (long x = 0; x < xsize; ++x) {
        const uint8_t* src = plane + (xmin + x) * inner;
        const int32_t w = k[x];
        for (long i = 0; i < inner; ++i) acc[i] += src[i] * w;
      }
      uint8_t* dst = out + (o * n_out + j) * inner;
      for (long i = 0; i < inner; ++i) dst[i] = clip8(acc[i]);
    }
  }
}

}  // extern "C"
