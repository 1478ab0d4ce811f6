// Host-side image decoding helpers for the data pipeline
// (transeditor_tpu_torch/utils/image.py), built with g++ at first use.
//
//   teimg_png_unfilter - undo PNG row filtering (None, Sub, Up, Average,
//                        Paeth), one row after another, as libpng does;
//   teimg_resample     - one separable pass of Pillow's fixed-point
//                        resampling (Resample.c, 8 bits a channel): each
//                        output pixel a weighted sum of a window of input
//                        pixels, rounded and clipped to 8 bits;
//   teimg_bmp_info,    - read a Windows BMP as Pillow 12.1 does: BI_RGB at
//   teimg_bmp_decode     1, 4 and 8 bits (palette), 16 (5-5-5), 24 and 32
//                        bits, BI_BITFIELDS at 16, 24 and 32 bits in
//                        the layouts Pillow reads, and
//                        BI_RLE8 / BI_RLE4 at 1, 4 and 8 bits (Pillow's
//                        BmpRleDecoder, quirk for quirk), rows bottom-up
//                        or top-down, as RGB.  A channel of k mask bits
//                        becomes v * 255 / (2^k - 1), as Pillow's
//                        unpackers scale 5- and 6-bit fields.
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

uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
uint32_t le32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (static_cast<uint32_t>(p[3]) << 24);
}

// Error codes of the BMP reader (utils/image.py names them).
enum BmpError : long {
  kBmpOk = 0,
  kBmpNotBmp = 1,         // no "BM" signature, or a header cut short
  kBmpHeader = 2,         // an info-header size this reader does not know
  kBmpCompressed = 3,     // JPEG, PNG or another compression Pillow refuses
  kBmpDepth = 4,          // a bit depth the compression does not allow
  kBmpTruncated = 5,      // pixel rows past the file's end
  kBmpSize = 6,           // a side zero or beyond 2^15, or a bomb
  kBmpRleShort = 7,       // an RLE stream that ends before the image does
  kBmpRleMode1 = 8,       // RLE with a black-and-white palette (mode "1")
  kBmpRleDelta = 9,       // an RLE delta escape cut short
  kBmpPalette = 10,       // a palette of more than 256 colours
  kBmpBitfields = 11,     // a bitfields layout Pillow does not read
};

struct Bmp {
  long width = 0, height = 0;   // height > 0
  bool top_down = false;
  long bpp = 0, compression = 0;
  long pixels = 0;              // offset of the first stored row
  long stride = 0;              // bytes a stored row (padded to 4)
  uint32_t masks[3] = {0, 0, 0};
  const uint8_t* palette = nullptr;
  long palette_entry = 4, colors = 0;
  bool gray = false;            // palette entry i is (i, i, i): mode "L"
};

// Pillow reads BI_BITFIELDS in these layouts only (BmpImagePlugin's
// SUPPORTED): 5-6-5 and 5-5-5 at 16 bits, BGR at 24, seven 8-bit
// orders at 32 (with alpha from a V3+ header) and all-zero masks, read
// as BGRA.
bool pil_bitfields(long bpp, uint32_t* m, uint32_t a) {
  if (bpp == 16)
    return m[2] == 0x1F && ((m[0] == 0xF800 && m[1] == 0x7E0) ||
                            (m[0] == 0x7C00 && m[1] == 0x3E0));
  if (bpp == 24) return m[0] == 0xFF0000 && m[1] == 0xFF00 && m[2] == 0xFF;
  static const uint32_t k32[8][4] = {
      {0xFF0000, 0xFF00, 0xFF, 0x0},
      {0xFF000000, 0xFF0000, 0xFF00, 0x0},
      {0xFF000000, 0xFF00, 0xFF, 0x0},
      {0xFF000000, 0xFF0000, 0xFF00, 0xFF},
      {0xFF, 0xFF00, 0xFF0000, 0xFF000000},
      {0xFF0000, 0xFF00, 0xFF, 0xFF000000},
      {0xFF000000, 0xFF00, 0xFF, 0xFF0000},
      {0x0, 0x0, 0x0, 0x0}};
  for (const auto& k : k32)
    if (m[0] == k[0] && m[1] == k[1] && m[2] == k[2] && a == k[3]) {
      if (!m[0]) {                              // "BGRA"
        m[0] = 0xFF0000; m[1] = 0xFF00; m[2] = 0xFF;
      }
      return true;
    }
  return false;
}

long parse_bmp(const uint8_t* d, long size, Bmp* b) {
  if (size < 26 || d[0] != 'B' || d[1] != 'M') return kBmpNotBmp;
  const long header = le32(d + 14);
  if (14 + header > size) return kBmpNotBmp;
  const uint8_t* h = d + 18;
  long colors = 0;
  if (header == 12) {                           // BITMAPCOREHEADER
    b->width = le16(h);
    b->height = static_cast<int16_t>(le16(h + 2));
    b->bpp = le16(h + 6);
    b->palette_entry = 3;
  } else if (header == 40 || header == 52 || header == 56 || header == 64 ||
             header == 108 || header == 124) {
    b->width = static_cast<int32_t>(le32(h));
    b->height = static_cast<int32_t>(le32(h + 4));
    b->bpp = le16(h + 10);
    b->compression = le32(h + 12);
    colors = le32(h + 28);
  } else {
    return kBmpHeader;
  }
  b->top_down = b->height < 0;
  if (b->top_down) b->height = -b->height;
  // beyond 2^15 a side, or PIL's decompression-bomb limit (twice
  // MAX_IMAGE_PIXELS): an RLE stream can claim any size
  if (b->width <= 0 || b->height <= 0 || b->width > 32768 ||
      b->height > 32768 || b->width * b->height > 2 * 89478485L)
    return kBmpSize;
  const long comp = b->compression;
  // 1, 2: BI_RLE8, BI_RLE4; 3: BI_BITFIELDS
  if (comp < 0 || comp > 3) return kBmpCompressed;
  const long bpp = b->bpp;
  if (bpp != 1 && bpp != 4 && bpp != 8 && bpp != 16 && bpp != 24 &&
      bpp != 32)
    return kBmpDepth;
  // RLE runs hold palette indices (any depth of a palette image)
  if ((comp == 1 || comp == 2) && bpp > 8) return kBmpDepth;
  if (comp == 3 && bpp != 16 && bpp != 24 && bpp != 32) return kBmpDepth;
  long after = 14 + header;                     // palette or masks follow
  if (comp == 3) {
    uint32_t alpha = 0;
    if (header == 40) {                         // masks after the header
      if (after + 12 > size) return kBmpTruncated;
      for (int c = 0; c < 3; ++c) b->masks[c] = le32(d + after + 4 * c);
      after += 12;
    } else {
      for (int c = 0; c < 3; ++c) b->masks[c] = le32(h + 36 + 4 * c);
      if (header >= 56) alpha = le32(h + 48);
    }
    if (!pil_bitfields(bpp, b->masks, alpha)) return kBmpBitfields;
  } else if (bpp == 16) {
    b->masks[0] = 0x7C00; b->masks[1] = 0x03E0; b->masks[2] = 0x001F;
  } else if (bpp >= 24) {
    b->masks[0] = 0xFF0000; b->masks[1] = 0xFF00; b->masks[2] = 0xFF;
  }
  b->pixels = le32(d + 10);
  if (bpp <= 8) {
    b->colors = colors > 0 ? colors : 1L << bpp;
    if (b->colors > 256) return kBmpPalette;
    // a palette image whose pixel offset omits its palette: Pillow
    // reads the pixels after 4 bytes an entry
    if (b->pixels == 14 + header) b->pixels += 4 * b->colors;
    // Pillow reads the palette up to the file's end (entries past it
    // are missing: black, and not gray)
    const long avail = (size - after) / b->palette_entry;
    b->palette = d + after;
    b->gray = avail >= b->colors;
    if (b->colors > avail) b->colors = avail > 0 ? avail : 0;
    // Pillow's grayscale test: entries (i, i, i), or black and white
    for (long i = 0; b->gray && i < b->colors; ++i) {
      const uint8_t* e = b->palette + i * b->palette_entry;
      const long v = b->colors == 2 ? 255 * i : i;
      if (e[0] != v || e[1] != v || e[2] != v) b->gray = false;
    }
  }
  b->stride = (b->width * bpp + 31) / 32 * 4;
  if (comp == 1 || comp == 2) {
    if (b->colors == 2 && b->gray) return kBmpRleMode1;
    if (b->pixels > size) b->pixels = size;     // an empty stream
    return kBmpOk;
  }
  if (b->pixels < 0 || b->pixels + b->stride * b->height > size)
    return kBmpTruncated;
  return kBmpOk;
}

// Pillow's BmpRleDecoder: indices in stored order (rows bottom-up unless
// top_down), as many as w * h; the count it produced is returned (less
// than w * h: "not enough image data").  Its quirks kept: an encoded run
// is clipped to the row, an absolute one is not; end-of-line and delta
// fill with index 0; a delta escape skips two bytes and reads (right, up)
// from the next two; an RLE4 absolute run of odd length n reads n / 2
// bytes (n - 1 pixels) but moves x by n; an absolute run ends on an even
// file offset.  -1: a delta escape cut short (Pillow raises).
long bmp_rle(const uint8_t* d, long size, long pos, long w, long h,
             bool rle4, uint8_t* idx) {
  const long total = w * h;
  long n = 0, x = 0;
  auto put = [&](uint8_t v, long count) {
    const long k = count < total - n ? count : total - n;
    if (k > 0) std::memset(idx + n, v, static_cast<size_t>(k));
    n += count;
  };
  while (n < total) {
    if (pos + 2 > size) break;
    long num = d[pos];
    const uint8_t byte = d[pos + 1];
    pos += 2;
    if (num) {                                  // encoded run
      if (x + num > w) num = w - x > 0 ? w - x : 0;
      for (long i = 0; i < num; ++i)
        put(rle4 ? (i % 2 ? byte & 15 : byte >> 4) : byte, 1);
      x += num;
    } else if (byte == 0) {                     // end of line
      if (n % w) put(0, w - n % w);
      x = 0;
    } else if (byte == 1) {                     // end of bitmap
      break;
    } else if (byte == 2) {                     // delta
      if (pos + 2 > size) break;
      pos += 2;
      if (pos + 2 > size) return -1;
      put(0, d[pos] + d[pos + 1] * w);
      pos += 2;
      x = n % w;
    } else {                                    // absolute run
      const long want = rle4 ? byte / 2 : byte;
      const long got = want < size - pos ? want : size - pos;
      for (long i = 0; i < got; ++i) {
        const uint8_t v = d[pos + i];
        if (rle4) {
          put(v >> 4, 1);
          put(v & 15, 1);
        } else {
          put(v, 1);
        }
      }
      pos += got;
      if (got < want) break;
      x += byte;
      if (pos % 2) ++pos;
    }
  }
  return n;
}

// One palette index as RGB: the palette entry (stored B, G, R); past the
// palette black, or in mode "L" (a gray palette) the index as gray.
inline void palette_rgb(const Bmp& b, long idx, uint8_t* dst) {
  if (idx >= b.colors) {
    dst[0] = dst[1] = dst[2] = b.gray ? static_cast<uint8_t>(idx) : 0;
  } else {
    const uint8_t* e = b.palette + idx * b.palette_entry;
    dst[0] = e[2]; dst[1] = e[1]; dst[2] = e[0];
  }
}

// v of the mask's bits, scaled to 8 bits.
inline uint8_t channel(uint32_t v, uint32_t mask) {
  if (!mask) return 0;
  int shift = 0;
  while (!((mask >> shift) & 1)) ++shift;
  const uint32_t m = mask >> shift;
  const uint64_t top = m;                       // 2^bits - 1 for a run
  return static_cast<uint8_t>(((v & mask) >> shift) * 255ull / top);
}

}  // namespace

extern "C" {

// info: [width, height, bits a pixel, compression].  Returns a BmpError
// (info is filled as far as the header was read).
long teimg_bmp_info(const uint8_t* data, long size, long* info) {
  Bmp b;
  const long rc = parse_bmp(data, size, &b);
  info[0] = b.width; info[1] = b.height; info[2] = b.bpp;
  info[3] = b.compression;
  return rc;
}

// out: [height, width, 3] uint8 RGB, top row first.  Returns a BmpError.
long teimg_bmp_decode(const uint8_t* data, long size, uint8_t* out) {
  Bmp b;
  const long rc = parse_bmp(data, size, &b);
  if (rc != kBmpOk) return rc;
  const long w = b.width, bpp = b.bpp;
  if (b.compression == 1 || b.compression == 2) {
    std::vector<uint8_t> idx(static_cast<size_t>(w * b.height));
    const long n = bmp_rle(data, size, b.pixels, w, b.height,
                           b.compression == 2, idx.data());
    if (n < 0) return kBmpRleDelta;
    if (n < w * b.height) return kBmpRleShort;
    for (long y = 0; y < b.height; ++y) {
      const long stored = b.top_down ? y : b.height - 1 - y;
      for (long x = 0; x < w; ++x)
        palette_rgb(b, idx[stored * w + x], out + (y * w + x) * 3);
    }
    return kBmpOk;
  }
  for (long y = 0; y < b.height; ++y) {
    const long stored = b.top_down ? y : b.height - 1 - y;
    const uint8_t* row = data + b.pixels + stored * b.stride;
    uint8_t* dst = out + y * w * 3;
    for (long x = 0; x < w; ++x, dst += 3) {
      if (bpp <= 8) {
        const long bit = x * bpp;
        const long idx = (row[bit / 8] >> (8 - bpp - bit % 8)) &
                         ((1 << bpp) - 1);
        palette_rgb(b, idx, dst);
        continue;
      }
      const uint8_t* p = row + x * (bpp / 8);
      const uint32_t v = bpp == 16 ? le16(p)
                         : bpp == 24 ? (p[0] | (p[1] << 8) | (p[2] << 16))
                                     : le32(p);
      for (int c = 0; c < 3; ++c) dst[c] = channel(v, b.masks[c]);
    }
  }
  return kBmpOk;
}

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
