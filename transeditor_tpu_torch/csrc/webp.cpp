// The port's WebP decoder: a .webp file to the RGB that PIL's
// Image.open(path).convert("RGB") gives, with no image library.
//
// PIL reads WebP through libwebp's WebPAnimDecoder (also for a still
// image): frame 1 decoded as non-premultiplied RGBA on a zeroed canvas at
// the frame's offset.  This file does the same in plain integer C++:
//   * the container as libwebp's demuxer parses and validates it: RIFF
//     "WEBP" with a VP8 / VP8L chunk, or VP8X with ALPH + VP8 / VP8L or
//     ANIM + ANMF frames; ICCP, EXIF, XMP and unknown chunks skipped;
//   * VP8L, lossless (RFC 9649): prefix codes (simple and normal, with
//     the code-length code), the meta prefix-code image, LZ77 with the
//     120-entry distance map, the colour cache, and the predictor,
//     cross-colour, subtract-green and colour-indexing transforms;
//   * VP8, lossy key frames (RFC 6386): the boolean decoder, segments,
//     token partitions, coefficient probabilities, dequantisation, intra
//     prediction, the IDCT / WHT and the simple and normal loop filters;
//     then libwebp's two stages that the RFC leaves open, its "fancy"
//     9-3-3-1 chroma upsampler (dsp/upsampling.c) and its fixed-point
//     YUV -> RGB (dsp/yuv.h, VP8YuvToRgb);
//   * ALPH (raw or VP8L-compressed) is decoded, so that a corrupt chunk
//     is refused where libwebp refuses it, and then dropped, as
//     convert("RGB") drops alpha.
// Where libwebp's choices decide which corrupt streams are refused (its
// end-of-stream rules, its checks on sizes and chunk order), they are
// copied; every refusal is a negative code that utils/image.py names.
//
// C ABI: teimg_webp_info, teimg_webp_decode.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

namespace webp {

enum : long {
  OK = 0,
  E_CONTAINER = -1,   // not RIFF "WEBP", or a chunk layout libwebp rejects
  E_TRUNCATED = -2,   // the file ends before its RIFF size says
  E_VP8 = -3,         // a corrupt or truncated VP8 (lossy) bitstream
  E_VP8L = -4,        // a corrupt or truncated VP8L (lossless) bitstream
  E_ALPHA = -5,       // a corrupt ALPH chunk
  E_TOO_LARGE = -6,   // more pixels than PIL opens or than the data holds
  E_NO_FRAME = -7,    // no image (an animation without a frame)
  E_ARGS = -8,
};

struct Fail {
  long code;
};

[[noreturn]] static void fail(long code) { throw Fail{code}; }

// PIL refuses an image of more than twice Image.MAX_IMAGE_PIXELS
// (DecompressionBombError); so does this reader, before it allocates.
// That is the only cap a VP8L image has: with one-symbol prefix codes
// and colour-cache hits a pixel costs no bits, so a few bytes can hold
// a valid 16383 x 16383 image, and its size cannot be bounded by the
// file's bytes.  A VP8 frame can (see parse_header).
constexpr uint64_t kMaxPixels = 2ull * 89478485ull;

static inline uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
static inline uint32_t le24(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16);
}
static inline uint32_t le32(const uint8_t* p) {
  return le24(p) | (uint32_t(p[3]) << 24);
}

// ===========================================================================
// VP8L: lossless (RFC 9649; libwebp's vp8l_dec.c, huffman_utils.c)

namespace vp8l {

// Bits are read least significant first.  libwebp's reader reports the
// end of the stream once more bits were consumed than it holds, counting
// a stream shorter than its 64-bit window as 64 bits long.
struct BitReader {
  std::vector<uint8_t> buf;   // the data, then 8 zero bytes
  size_t len, pos = 0;        // pos: bits consumed
  BitReader(const uint8_t* p, size_t n) : buf(p, p + n), len(n) {
    buf.resize(n + 8, 0);
  }
  uint64_t window() const {   // the next 57 or more bits
    const size_t byte = pos >> 3;
    if (byte > len) return 0;
    const uint8_t* p = buf.data() + byte;
    const uint64_t v = uint64_t(p[0]) | uint64_t(p[1]) << 8 |
                       uint64_t(p[2]) << 16 | uint64_t(p[3]) << 24 |
                       uint64_t(p[4]) << 32 | uint64_t(p[5]) << 40 |
                       uint64_t(p[6]) << 48 | uint64_t(p[7]) << 56;
    return v >> (pos & 7);
  }
  uint32_t peek(int n) const {
    return uint32_t(window() & ((uint64_t(1) << n) - 1));
  }
  uint32_t read(int n) {
    if (n == 0) return 0;
    const uint32_t v = peek(n);
    pos += size_t(n);
    return v;
  }
  bool eos() const { return pos > std::max<size_t>(8 * len, 64); }
};

struct Code {
  uint8_t bits;    // bits consumed (a root entry over 8: a sub-table's)
  uint32_t value;  // the symbol, or the sub-table's offset from here
};

using Table = std::vector<Code>;

// reverse(reverse(key, len) + 1, len)
static inline uint32_t next_key(uint32_t key, int len) {
  uint32_t step = 1u << (len - 1);
  while (key & step) step >>= 1;
  return step ? (key & (step - 1)) + step : key;
}

static inline void replicate(Table& t, size_t base, int step, int end,
                             Code c) {
  do {
    end -= step;
    t[base + size_t(end)] = c;
  } while (end > 0);
}

static int next_table_bits(const int* count, int len, int root_bits) {
  int left = 1 << (len - root_bits);
  while (len < 15) {
    left -= count[len];
    if (left <= 0) break;
    ++len;
    left <<= 1;
  }
  return len - root_bits;
}

// huffman_utils.c's BuildHuffmanTable: a root table of root_bits and
// second-level tables.  False for an empty, over-subscribed or incomplete
// code; one symbol alone is a code of no bits.
static bool build(Table& t, const int* lengths, int n, int root_bits) {
  int count[16] = {0}, offset[16];
  for (int s = 0; s < n; ++s) {
    if (lengths[s] > 15) return false;
    ++count[lengths[s]];
  }
  if (count[0] == n) return false;
  offset[1] = 0;
  for (int len = 1; len < 15; ++len) {
    if (count[len] > (1 << len)) return false;
    offset[len + 1] = offset[len] + count[len];
  }
  std::vector<uint32_t> sorted(static_cast<size_t>(n));
  for (int s = 0; s < n; ++s)
    if (lengths[s] > 0) sorted[size_t(offset[lengths[s]]++)] = uint32_t(s);
  t.assign(size_t(1) << root_bits, Code{0, 0});
  if (offset[15] == 1) {
    for (auto& c : t) c = Code{0, sorted[0]};
    return true;
  }
  const uint32_t mask = (1u << root_bits) - 1;
  uint32_t low = 0xffffffffu, key = 0;
  int num_nodes = 1, num_open = 1, table_size = 1 << root_bits, sym = 0;
  size_t table = 0;
  for (int len = 1, step = 2; len <= root_bits; ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return false;
    for (; count[len] > 0; --count[len]) {
      replicate(t, key, step, table_size,
                Code{uint8_t(len), sorted[size_t(sym++)]});
      key = next_key(key, len);
    }
  }
  for (int len = root_bits + 1, step = 2; len <= 15; ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return false;
    for (; count[len] > 0; --count[len]) {
      if ((key & mask) != low) {
        table += size_t(table_size);
        const int bits = next_table_bits(count, len, root_bits);
        table_size = 1 << bits;
        t.resize(table + size_t(table_size));
        low = key & mask;
        t[low] = Code{uint8_t(bits + root_bits), uint32_t(table - low)};
      }
      replicate(t, table + (key >> root_bits), step, table_size,
                Code{uint8_t(len - root_bits), sorted[size_t(sym++)]});
      key = next_key(key, len);
    }
  }
  return num_nodes == 2 * offset[15] - 1;
}

static inline uint32_t read_symbol(const Table& t, BitReader& br,
                                   int root_bits = 8) {
  uint32_t v = br.peek(15);
  size_t i = v & ((1u << root_bits) - 1);
  const int nbits = t[i].bits - root_bits;
  if (nbits > 0) {
    br.pos += size_t(root_bits);
    i += t[i].value + ((v >> root_bits) & ((1u << nbits) - 1));
  }
  br.pos += t[i].bits;
  return t[i].value;
}

enum { GREEN = 0, RED = 1, BLUE = 2, ALPHA = 3, DIST = 4 };
static const int kAlphabet[5] = {256 + 24, 256, 256, 256, 40};
static const uint8_t kCodeLengthOrder[19] = {
    17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

// (xi, yi) of the first 120 distance codes, as 16 * yi + 8 - xi
static const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a,
    0x38, 0x05, 0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04,
    0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45,
    0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d,
    0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e,
    0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b, 0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e,
    0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d,
    0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

static inline int sub_sample(int size, int bits) {
  return (size + (1 << bits) - 1) >> bits;
}

struct Group {
  Table t[5];
};

struct Transform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

enum { PREDICTOR = 0, CROSS_COLOR = 1, SUBTRACT_GREEN = 2, COLOR_INDEXING = 3 };

struct Decoder {
  BitReader br;
  long err;                    // the code of a refusal
  Transform transforms[4];
  int n_transforms = 0;
  unsigned seen = 0;
  // the level-0 image's codes (kept to decide libwebp's 8-bit alpha path)
  int cache_bits0 = 0;
  std::vector<Group> groups0;

  Decoder(const uint8_t* p, size_t n, long code) : br(p, n), err(code) {}

  void check() const {
    if (br.eos()) fail(err);
  }

  // ReadHuffmanCode: one prefix code of `alphabet` symbols
  void read_code(int alphabet, Table& t) {
    std::vector<int> lengths(size_t(alphabet), 0);
    bool ok;
    if (br.read(1)) {  // simple: one or two symbols of length 1
      const int num = int(br.read(1)) + 1;
      const int first8 = int(br.read(1));
      int s = int(br.read(first8 ? 8 : 1));
      if (s < alphabet) lengths[size_t(s)] = 1;
      if (num == 2) {
        s = int(br.read(8));
        if (s < alphabet) lengths[size_t(s)] = 1;
      }
      ok = true;
    } else {
      int cl_lengths[19] = {0};
      const int num_codes = int(br.read(4)) + 4;
      for (int i = 0; i < num_codes; ++i)
        cl_lengths[kCodeLengthOrder[i]] = int(br.read(3));
      ok = read_code_lengths(cl_lengths, alphabet, lengths.data());
    }
    if (!ok || br.eos() || !build(t, lengths.data(), alphabet, 8)) fail(err);
  }

  bool read_code_lengths(const int* cl_lengths, int n, int* lengths) {
    Table t;
    if (!build(t, cl_lengths, 19, 7)) return false;
    int max_symbol = n;
    if (br.read(1)) {
      const int nbits = 2 + 2 * int(br.read(3));
      max_symbol = 2 + int(br.read(nbits));
      if (max_symbol > n) return false;
    }
    int prev = 8, sym = 0;
    while (sym < n) {
      if (max_symbol-- == 0) break;
      const int len = int(read_symbol(t, br, 7));
      if (len < 16) {
        lengths[sym++] = len;
        if (len) prev = len;
      } else {
        static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
        int repeat = int(br.read(kExtra[len - 16])) + kOffset[len - 16];
        if (sym + repeat > n) return false;
        const int v = len == 16 ? prev : 0;
        while (repeat-- > 0) lengths[sym++] = v;
      }
    }
    return true;
  }

  // ReadHuffmanCodes: the meta prefix-code image (level 0 only) and the
  // groups of five codes it indexes
  void read_codes(int xsize, int ysize, int cache_bits, bool level0,
                  std::vector<Group>& groups, std::vector<uint32_t>& image,
                  int& image_bits) {
    int n_groups = 1;
    image_bits = 0;
    if (level0 && br.read(1)) {
      image_bits = int(br.read(3)) + 2;
      image = decode_stream(sub_sample(xsize, image_bits),
                            sub_sample(ysize, image_bits), false);
      for (auto& v : image) {
        v = (v >> 8) & 0xffff;
        n_groups = std::max(n_groups, int(v) + 1);
      }
    }
    groups.clear();
    for (int g = 0; g < n_groups; ++g) {
      groups.emplace_back();
      for (int j = 0; j < 5; ++j) {
        const int alphabet =
            kAlphabet[j] + (j == 0 && cache_bits ? 1 << cache_bits : 0);
        read_code(alphabet, groups.back().t[j]);
      }
    }
  }

  void read_transform(int& xsize, int ysize) {
    const int type = int(br.read(2));
    if (seen & (1u << type)) fail(err);  // each transform at most once
    seen |= 1u << type;
    Transform& tr = transforms[n_transforms++];
    tr.type = type;
    tr.xsize = xsize;
    tr.ysize = ysize;
    if (type == PREDICTOR || type == CROSS_COLOR) {
      tr.bits = int(br.read(3)) + 2;
      tr.data = decode_stream(sub_sample(xsize, tr.bits),
                              sub_sample(ysize, tr.bits), false);
    } else if (type == COLOR_INDEXING) {
      const int n = int(br.read(8)) + 1;
      tr.bits = n > 16 ? 0 : n > 4 ? 1 : n > 2 ? 2 : 3;
      xsize = sub_sample(tr.xsize, tr.bits);
      std::vector<uint32_t> map = decode_stream(n, 1, false);
      // the palette is delta-coded, byte by byte; past its end: 0
      tr.data.assign(size_t(1) << (8 >> tr.bits), 0);
      tr.data[0] = map[0];
      for (int i = 1; i < n; ++i) {
        uint32_t v = 0;
        for (int s = 0; s < 32; s += 8)
          v |= (((map[size_t(i)] >> s) + (tr.data[size_t(i - 1)] >> s)) &
                0xff) << s;
        tr.data[size_t(i)] = v;
      }
    }
  }

  // DecodeImageStream: a sub-image (entropy image, transform data,
  // palette) or, at level 0, the image itself before its transforms
  std::vector<uint32_t> decode_stream(int xsize, int ysize, bool level0,
                                      bool alpha = false) {
    int width = xsize;
    if (level0)
      while (br.read(1)) read_transform(width, ysize);
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = int(br.read(4));
      if (cache_bits < 1 || cache_bits > 11) fail(err);
    }
    std::vector<Group> groups;
    std::vector<uint32_t> image;
    int image_bits = 0;
    read_codes(width, ysize, cache_bits, level0, groups, image, image_bits);
    check();
    // libwebp decodes an alpha plane that only indexes a palette and
    // whose red, blue and alpha codes have one symbol each on its 8-bit
    // path, which accepts a stream whose last code runs past its end
    bool eight_bit = false;
    if (alpha && n_transforms == 1 && transforms[0].type == COLOR_INDEXING &&
        cache_bits == 0) {
      eight_bit = true;
      for (const auto& g : groups)
        if (g.t[RED][0].bits || g.t[BLUE][0].bits || g.t[ALPHA][0].bits)
          eight_bit = false;
    }
    return decode_pixels(width, ysize, cache_bits, groups, image,
                         image_bits, eight_bit);
  }

  int copy_value(int sym) {
    if (sym < 4) return sym + 1;
    const int extra = (sym - 2) >> 1;
    const int offset = (2 + (sym & 1)) << extra;
    return offset + int(br.read(extra)) + 1;
  }

  std::vector<uint32_t> decode_pixels(int w, int h, int cache_bits,
                                      const std::vector<Group>& groups,
                                      const std::vector<uint32_t>& image,
                                      int image_bits, bool eight_bit) {
    const size_t end = size_t(w) * size_t(h);
    std::vector<uint32_t> data(end);
    std::vector<uint32_t> cache(cache_bits ? size_t(1) << cache_bits : 0);
    const int image_w = image_bits ? sub_sample(w, image_bits) : 0;
    const int len_limit = 256 + 24;
    const int cache_limit = len_limit + int(cache.size());
    size_t pos = 0, cached = 0;
    int col = 0, row = 0;
    auto insert = [&]() {
      if (cache_bits)
        for (; cached < pos; ++cached)
          cache[(0x1e35a7bdu * data[cached]) >> (32 - cache_bits)] =
              data[cached];
    };
    while (pos < end) {
      if (eight_bit && br.eos()) fail(err);
      const Group& g =
          groups[image_bits ? image[size_t(row >> image_bits) * image_w +
                                    size_t(col >> image_bits)]
                            : 0];
      const int code = int(read_symbol(g.t[GREEN], br));
      if (code < 256) {
        const uint32_t r = read_symbol(g.t[RED], br);
        const uint32_t b = read_symbol(g.t[BLUE], br);
        const uint32_t a = read_symbol(g.t[ALPHA], br);
        data[pos++] = (a << 24) | (r << 16) | (uint32_t(code) << 8) | b;
        if (++col >= w) {
          col = 0;
          ++row;
        }
      } else if (code < len_limit) {
        const int length = copy_value(code - 256);
        const int dist_code = copy_value(int(read_symbol(g.t[DIST], br)));
        int dist;
        if (dist_code > 120) {
          dist = dist_code - 120;
        } else {
          const int d = kCodeToPlane[dist_code - 1];
          dist = std::max((d >> 4) * w + 8 - (d & 15), 1);
        }
        if (pos < size_t(dist) || end - pos < size_t(length)) fail(err);
        for (int k = 0; k < length; ++k, ++pos) data[pos] = data[pos - dist];
        col += length;
        while (col >= w) {
          col -= w;
          ++row;
        }
      } else if (code < cache_limit) {
        insert();
        data[pos++] = cache[size_t(code - len_limit)];
        if (++col >= w) {
          col = 0;
          ++row;
        }
      } else {
        fail(err);
      }
      insert();
    }
    if (!eight_bit) check();
    return data;
  }

  // the inverse transforms, last read first applied
  std::vector<uint32_t> untransform(std::vector<uint32_t> px) {
    for (int i = n_transforms - 1; i >= 0; --i) {
      const Transform& tr = transforms[i];
      const int w = tr.xsize, h = tr.ysize;
      if (tr.type == PREDICTOR) {
        predict(tr, px);
      } else if (tr.type == CROSS_COLOR) {
        const int tw = sub_sample(w, tr.bits);
        for (int y = 0; y < h; ++y)
          for (int x = 0; x < w; ++x) {
            const uint32_t m = tr.data[size_t(y >> tr.bits) * tw +
                                       size_t(x >> tr.bits)];
            const int8_t g2r = int8_t(m), g2b = int8_t(m >> 8),
                         r2b = int8_t(m >> 16);
            uint32_t& p = px[size_t(y) * w + x];
            const int8_t green = int8_t(p >> 8);
            int red = (p >> 16) & 0xff, blue = p & 0xff;
            red = (red + ((int(g2r) * green) >> 5)) & 0xff;
            blue += (int(g2b) * green) >> 5;
            blue = (blue + ((int(r2b) * int8_t(red)) >> 5)) & 0xff;
            p = (p & 0xff00ff00u) | (uint32_t(red) << 16) | uint32_t(blue);
          }
      } else if (tr.type == SUBTRACT_GREEN) {
        for (auto& p : px) {
          const uint32_t g = (p >> 8) & 0xff;
          const uint32_t rb = ((p & 0x00ff00ffu) + ((g << 16) | g)) &
                              0x00ff00ffu;
          p = (p & 0xff00ff00u) | rb;
        }
      } else {  // COLOR_INDEXING, with pixel bundling below 17 colours
        const int packed_w = sub_sample(w, tr.bits);
        std::vector<uint32_t> out(size_t(w) * h);
        const int bpp = 8 >> tr.bits;
        const uint32_t mask = (1u << bpp) - 1;
        for (int y = 0; y < h; ++y)
          for (int x = 0; x < w; ++x) {
            const uint32_t packed =
                (px[size_t(y) * packed_w + (x >> tr.bits)] >> 8) & 0xff;
            const int shift = (x & ((1 << tr.bits) - 1)) * bpp;
            out[size_t(y) * w + x] = tr.data[(packed >> shift) & mask];
          }
        px.swap(out);
      }
    }
    return px;
  }

  static inline uint32_t add(uint32_t a, uint32_t b) {
    const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
    const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
    return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
  }
  static inline uint32_t avg2(uint32_t a, uint32_t b) {
    return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
  }
  static inline int ch(uint32_t v, int s) { return int((v >> s) & 0xff); }
  static inline uint32_t select(uint32_t t, uint32_t l, uint32_t tl) {
    int pa_minus_pb = 0;
    for (int s = 0; s < 32; s += 8)
      pa_minus_pb += std::abs(ch(l, s) - ch(tl, s)) -
                     std::abs(ch(t, s) - ch(tl, s));
    return pa_minus_pb <= 0 ? t : l;
  }
  static inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
  static inline uint32_t clamp_full(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8)
      out |= uint32_t(clip255(ch(a, s) + ch(b, s) - ch(c, s))) << s;
    return out;
  }
  static inline uint32_t clamp_half(uint32_t a, uint32_t b) {
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8) {
      const int x = ch(a, s), y = ch(b, s);
      out |= uint32_t(clip255(x + (x - y) / 2)) << s;   // C division
    }
    return out;
  }

  static void predict(const Transform& tr, std::vector<uint32_t>& px) {
    const int w = tr.xsize, h = tr.ysize;
    const int tw = sub_sample(w, tr.bits);
    uint32_t* p = px.data();
    p[0] = add(p[0], 0xff000000u);
    for (int x = 1; x < w; ++x) p[x] = add(p[x], p[x - 1]);
    for (int y = 1; y < h; ++y) {
      uint32_t* row = p + size_t(y) * w;
      const uint32_t* top = row - w;
      row[0] = add(row[0], top[0]);
      for (int x = 1; x < w; ++x) {
        const int mode =
            (tr.data[size_t(y >> tr.bits) * tw + size_t(x >> tr.bits)] >> 8) &
            0xf;
        // TR of the last column is the first pixel of this row, the
        // next one in memory
        const uint32_t L = row[x - 1], T = top[x], TR = top[x + 1],
                       TL = top[x - 1];
        uint32_t pred;
        switch (mode) {
          case 1: pred = L; break;
          case 2: pred = T; break;
          case 3: pred = TR; break;
          case 4: pred = TL; break;
          case 5: pred = avg2(avg2(L, TR), T); break;
          case 6: pred = avg2(L, TL); break;
          case 7: pred = avg2(L, T); break;
          case 8: pred = avg2(TL, T); break;
          case 9: pred = avg2(T, TR); break;
          case 10: pred = avg2(avg2(L, TL), avg2(T, TR)); break;
          case 11: pred = select(T, L, TL); break;
          case 12: pred = clamp_full(L, T, TL); break;
          case 13: pred = clamp_half(avg2(L, T), TL); break;
          default: pred = 0xff000000u; break;   // 0, and 14 / 15 as 0
        }
        row[x] = add(row[x], pred);
      }
    }
  }
};

// A VP8L bitstream (with its 5-byte header) -> [h][w] ARGB.
static std::vector<uint32_t> decode(const uint8_t* d, size_t n, int& w,
                                    int& h) {
  Decoder dec(d, n, E_VP8L);
  BitReader& br = dec.br;
  if (n < 5 || br.read(8) != 0x2f) fail(E_VP8L);
  w = int(br.read(14)) + 1;
  h = int(br.read(14)) + 1;
  br.read(1);                       // alpha_is_used: a hint
  if (br.read(3) != 0) fail(E_VP8L);  // version
  if (uint64_t(w) * uint64_t(h) > kMaxPixels) fail(E_TOO_LARGE);
  return dec.untransform(dec.decode_stream(w, h, true));
}

// The VP8L-compressed alpha of an ALPH chunk: an image stream without
// header, of the frame's size; decoded for its refusals only.
static void decode_alpha(const uint8_t* d, size_t n, int w, int h) {
  Decoder dec(d, n, E_ALPHA);
  dec.decode_stream(w, h, true, true);
}

}  // namespace vp8l

// ===========================================================================
// VP8: lossy key frames (RFC 6386; libwebp's vp8_dec.c, tree_dec.c,
// quant_dec.c, frame_dec.c and dsp/dec.c)

namespace vp8 {

// The constant tables of RFC 6386: default coefficient probabilities
// (13.5), their update probabilities (13.4), the key-frame subblock mode
// probabilities (11.5, indexed [above][left] in the mode order below) and
// the quantiser steps (14.1).
static const uint8_t kCoeffsProba0[4 * 8 * 3 * 11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
static const uint8_t kCoeffsUpdateProba[4 * 8 * 3 * 11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
static const uint8_t kBModesProba[10 * 10 * 9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};
static const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
static const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

// subblock modes; the 16x16 and chroma modes share the first four
enum {
  B_DC = 0, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU,
  DC_NOTOP = 10, DC_NOLEFT, DC_NOTOPLEFT   // DC at the frame's edges
};

static const int8_t kYModesIntra4[18] = {
    -B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6, -B_HE, 5,
    -B_RD, -B_VR, -B_LD, 7, -B_VL, 8, -B_HD, -B_HU};
static const uint8_t kZigzag[16] = {0, 1,  4,  8,  5, 2,  3,  6,
                                    9, 12, 13, 10, 7, 11, 14, 15};
static const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6,
                                   6, 6, 6, 6, 6, 6, 7, 0};
static const uint8_t kCat3[] = {173, 148, 140, 0};
static const uint8_t kCat4[] = {176, 155, 140, 135, 0};
static const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
static const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177,
                                153, 140, 133, 130, 129, 0};
static const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// The boolean decoder, as libwebp's bit_reader: it loads a byte when its
// window runs dry, and past the last byte it loads one zero byte and
// marks the end of the data; a frame whose reading got there is refused.
struct BoolDec {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 254;   // the range less one
  bool eof = false;

  void init(const uint8_t* p, size_t n) {
    buf = p;
    end = p + n;
    value = 0;
    bits = -8;
    range = 254;
    eof = false;
    load();
  }
  void load() {
    if (buf < end) {
      bits += 8;
      value = *buf++ | (value << 8);
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * uint32_t(prob)) >> 8;
    const uint32_t v = uint32_t(value >> pos);
    const int b = v > split;
    if (b) {
      r -= split;
      value -= uint64_t(split + 1) << pos;
    } else {
      r = split + 1;
    }
    int shift = 0;
    while ((r << shift) < 128) ++shift;
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return b;
  }
  // a sign at probability 1/2 (VP8GetSigned: one shift always)
  int sign(int v) {
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = range >> 1;
    const uint32_t val = uint32_t(value >> pos);
    const int32_t mask = int32_t(split - val) >> 31;   // -1 if val > split
    bits -= 1;
    range += uint32_t(mask);
    range |= 1;
    value -= uint64_t((split + 1) & uint32_t(mask)) << pos;
    return (v ^ mask) - mask;
  }
  uint32_t get(int n) {
    uint32_t v = 0;
    while (n-- > 0) v |= uint32_t(bit(0x80)) << n;
    return v;
  }
  int get_signed(int n) {
    const int v = int(get(n));
    return bit(0x80) ? -v : v;
  }
};

constexpr int BPS = 32;   // the stride of the prediction buffers

struct FInfo {
  uint8_t limit = 0, ilevel = 0, inner = 0, hev = 0;
};

struct MBInfo {   // what the mode parsing gives one macroblock
  uint8_t segment = 0, skip = 0, is_i4x4 = 0, uvmode = 0;
  uint8_t imodes[16] = {};
};

static inline uint8_t clip8(int v) {
  return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
}

static inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
static inline int mul2(int a) { return (a * 35468) >> 16; }

// TransformOne: the inverse DCT of one 4x4 block, added to dst
static void idct_add(const int16_t* in, uint8_t* dst) {
  int C[16];
  int* tmp = C;
  for (int i = 0; i < 4; ++i, ++in, tmp += 4) {   // vertical pass
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]);
    const int d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i, ++tmp, dst += BPS) {   // horizontal pass
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]);
    const int d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
  }
}

// TransformWHT: the Y2 block's inverse Walsh-Hadamard transform, into
// the DC of the sixteen luma blocks
static void wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i, out += 64) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = int16_t((a0 + a1) >> 3);
    out[16] = int16_t((a3 + a2) >> 3);
    out[32] = int16_t((a0 - a1) >> 3);
    out[48] = int16_t((a3 - a2) >> 3);
  }
}

// --- intra prediction (dsp/dec.c) -------------------------------------------

#define DST(x, y) dst[(x) + (y) * BPS]
static inline uint8_t avg3(int a, int b, int c) {
  return uint8_t((a + 2 * b + c + 2) >> 2);
}
static inline uint8_t avg2(int a, int b) { return uint8_t((a + b + 1) >> 1); }

static void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  for (int y = 0; y < size; ++y, dst += BPS)
    for (int x = 0; x < size; ++x)
      dst[x] = clip8(top[x] + dst[-1] - top[-1]);
}

static void fill(uint8_t* dst, int v, int size) {
  for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, v, size_t(size));
}

// 16x16 luma (size 16) and 8x8 chroma (size 8) modes
static void predict_block(uint8_t* dst, int mode, int size) {
  const int shift = size == 16 ? 5 : 4;
  switch (mode) {
    case B_DC: {
      int dc = size;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      fill(dst, dc >> shift, size);
      break;
    }
    case DC_NOTOP: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      fill(dst, dc >> (shift - 1), size);
      break;
    }
    case DC_NOLEFT: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[j - BPS];
      fill(dst, dc >> (shift - 1), size);
      break;
    }
    case DC_NOTOPLEFT:
      fill(dst, 0x80, size);
      break;
    case B_TM:
      true_motion(dst, size);
      break;
    case B_VE:
      for (int j = 0; j < size; ++j)
        std::memcpy(dst + j * BPS, dst - BPS, size_t(size));
      break;
    case B_HE:
      for (int j = 0; j < size; ++j)
        std::memset(dst + j * BPS, dst[j * BPS - 1], size_t(size));
      break;
  }
}

static void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  switch (mode) {
    case B_DC: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill(dst, int(dc >> 3), 4);
      break;
    }
    case B_TM:
      true_motion(dst, 4);
      break;
    case B_VE: {
      const uint8_t v[4] = {avg3(top[-1], top[0], top[1]),
                            avg3(top[0], top[1], top[2]),
                            avg3(top[1], top[2], top[3]),
                            avg3(top[2], top[3], top[4])};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, v, 4);
      break;
    }
    case B_HE: {
      const int A = dst[-1 - BPS], B = dst[-1], C = dst[-1 + BPS],
                D = dst[-1 + 2 * BPS], E = dst[-1 + 3 * BPS];
      std::memset(dst, avg3(A, B, C), 4);
      std::memset(dst + BPS, avg3(B, C, D), 4);
      std::memset(dst + 2 * BPS, avg3(C, D, E), 4);
      std::memset(dst + 3 * BPS, avg3(D, E, E), 4);
      break;
    }
    case B_RD: {
      const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS], X = dst[-1 - BPS], A = top[0],
                B = top[1], C = top[2], D = top[3];
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    }
    case B_LD: {
      const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4],
                F = top[5], G = top[6], H = top[7];
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    }
    case B_VR: {
      const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
                X = dst[-1 - BPS], A = top[0], B = top[1], C = top[2],
                D = top[3];
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    }
    case B_VL: {
      const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4],
                F = top[5], G = top[6], H = top[7];
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    }
    case B_HU: {
      const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS];
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) =
          uint8_t(L);
      break;
    }
    case B_HD: {
      const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS], X = dst[-1 - BPS], A = top[0],
                B = top[1], C = top[2];
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    }
  }
}
#undef DST

// --- the loop filters (dsp/dec.c; RFC 6386 section 15) ----------------------

static inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
static inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

static inline void filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

static inline void filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

static inline void filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

static inline bool hev(const uint8_t* p, int step, int thresh) {
  return std::abs(p[-2 * step] - p[-step]) > thresh ||
         std::abs(p[step] - p[0]) > thresh;
}

static inline bool needs_filter(const uint8_t* p, int step, int t) {
  return 4 * std::abs(p[-step] - p[0]) + std::abs(p[-2 * step] - p[step]) <=
         t;
}

static inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
         std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
         std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// the simple filter across one edge of `size` pixels: hstride steps
// across the edge, vstride along it
static void simple_edge(uint8_t* p, int hstride, int vstride, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (needs_filter(p, hstride, t2)) filter2(p, hstride);
}

// the normal filter: 6-tap on macroblock edges, 4-tap inside
static void normal_edge(uint8_t* p, int hstride, int vstride, int size,
                        int thresh, int ithresh, int hev_t, bool mb_edge) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (!needs_filter2(p, hstride, t2, ithresh)) continue;
    if (hev(p, hstride, hev_t))
      filter2(p, hstride);
    else if (mb_edge)
      filter6(p, hstride);
    else
      filter4(p, hstride);
  }
}

// --- the frame --------------------------------------------------------------

struct Frame {
  int w = 0, h = 0, mbw = 0, mbh = 0;
  std::vector<uint8_t> y, u, v;   // whole macroblocks, unfiltered, then not
  int ys = 0, uvs = 0;            // their strides
};

struct Decoder {
  const uint8_t* data;
  size_t size;        // the chunk's bytes as libwebp hands them on
  size_t declared;    // the chunk's payload size as its header says
  BoolDec br, parts[8];
  int num_parts = 1;
  // segments
  // libwebp's ResetSegmentHeader: segment values are absolute until a
  // segment header says otherwise
  bool use_segment = false, update_map = false, absolute_delta = true;
  int quantizer[4] = {}, filter_strength[4] = {};
  uint8_t seg_probs[3] = {255, 255, 255};
  // the filter header
  bool simple = false, use_lf_delta = false;
  int level = 0, sharpness = 0, filter_type = 0;
  int ref_lf_delta[4] = {}, mode_lf_delta[4] = {};
  // dequantisation per segment: {dc, ac} for Y1, Y2 and chroma
  int y1[4][2], y2[4][2], uvq[4][2];
  uint8_t proba[4][8][3][11];
  bool use_skip = false;
  int skip_p = 0;
  FInfo fstrengths[4][2];
  Frame f;

  Decoder(const uint8_t* d, size_t n, size_t decl)
      : data(d), size(n), declared(decl) {}

  void parse_header() {
    // VP8GetInfo: a visible key frame with the start code, a known
    // profile, a first partition inside the chunk, and a non-zero size
    if (size < 10) fail(E_VP8);
    const uint32_t bits = le24(data);
    const bool key = !(bits & 1);
    const int profile = (bits >> 1) & 7, show = (bits >> 4) & 1;
    const uint32_t p0 = bits >> 5;
    if (!key || profile > 3 || !show || p0 >= declared) fail(E_VP8);
    if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) fail(E_VP8);
    f.w = int(le16(data + 6) & 0x3fff);
    f.h = int(le16(data + 8) & 0x3fff);
    if (f.w == 0 || f.h == 0) fail(E_VP8);
    f.mbw = (f.w + 15) >> 4;
    f.mbh = (f.h + 15) >> 4;
    if (p0 > size - 10) fail(E_VP8);
    // each macroblock costs at least one bit of the first partition
    // (its modes), so a larger frame is corrupt: refused before anything
    // is allocated
    if (uint64_t(f.mbw) * f.mbh > 8 * uint64_t(p0) + 64) fail(E_TOO_LARGE);
    br.init(data + 10, p0);
    br.get(1);   // colour space
    br.get(1);   // clamping type
    // segment header
    use_segment = br.get(1);
    if (use_segment) {
      update_map = br.get(1);
      if (br.get(1)) {   // update the segment data
        absolute_delta = br.get(1);
        for (int s = 0; s < 4; ++s)
          quantizer[s] = br.get(1) ? br.get_signed(7) : 0;
        for (int s = 0; s < 4; ++s)
          filter_strength[s] = br.get(1) ? br.get_signed(6) : 0;
      }
      if (update_map)
        for (int s = 0; s < 3; ++s)
          seg_probs[s] = uint8_t(br.get(1) ? br.get(8) : 255u);
    }
    if (br.eof) fail(E_VP8);
    // filter header
    simple = br.get(1);
    level = int(br.get(6));
    sharpness = int(br.get(3));
    use_lf_delta = br.get(1);
    if (use_lf_delta && br.get(1)) {
      for (int i = 0; i < 4; ++i)
        if (br.get(1)) ref_lf_delta[i] = br.get_signed(6);
      for (int i = 0; i < 4; ++i)
        if (br.get(1)) mode_lf_delta[i] = br.get_signed(6);
    }
    filter_type = level == 0 ? 0 : simple ? 1 : 2;
    if (br.eof) fail(E_VP8);
    // the token partitions
    const uint8_t* buf = data + 10 + p0;
    const size_t buf_size = size - 10 - p0;
    num_parts = 1 << br.get(2);
    const size_t last = size_t(num_parts - 1);
    if (buf_size < 3 * last) fail(E_VP8);
    const uint8_t* start = buf + 3 * last;
    size_t left = buf_size - 3 * last;
    for (size_t p = 0; p < last; ++p) {
      size_t psize = le24(buf + 3 * p);
      if (psize > left) psize = left;
      parts[p].init(start, psize);
      start += psize;
      left -= psize;
    }
    parts[last].init(start, left);
    if (start >= buf + buf_size) fail(E_VP8);
    parse_quant();
    br.get(1);   // refresh_entropy_probs: one frame, so unused
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p) {
            const int i = ((t * 8 + b) * 3 + c) * 11 + p;
            proba[t][b][c][p] = uint8_t(br.bit(kCoeffsUpdateProba[i])
                                            ? br.get(8)
                                            : kCoeffsProba0[i]);
          }
    use_skip = br.get(1);
    if (use_skip) skip_p = int(br.get(8));
    if (filter_type > 0) precompute_filters();
  }

  void parse_quant() {
    const int q0 = int(br.get(7));
    const int dy1_dc = br.get(1) ? br.get_signed(4) : 0;
    const int dy2_dc = br.get(1) ? br.get_signed(4) : 0;
    const int dy2_ac = br.get(1) ? br.get_signed(4) : 0;
    const int duv_dc = br.get(1) ? br.get_signed(4) : 0;
    const int duv_ac = br.get(1) ? br.get_signed(4) : 0;
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int s = 0; s < 4; ++s) {
      int q;
      if (use_segment) {
        q = quantizer[s];
        if (!absolute_delta) q += q0;
      } else {
        q = q0;
      }
      y1[s][0] = kDcTable[clip(q + dy1_dc, 127)];
      y1[s][1] = kAcTable[clip(q, 127)];
      y2[s][0] = kDcTable[clip(q + dy2_dc, 127)] * 2;
      // x * 155 / 100 for every x of the table
      y2[s][1] = std::max((kAcTable[clip(q + dy2_ac, 127)] * 101581) >> 16, 8);
      uvq[s][0] = kDcTable[clip(q + duv_dc, 117)];
      uvq[s][1] = kAcTable[clip(q + duv_ac, 127)];
    }
  }

  void precompute_filters() {
    for (int s = 0; s < 4; ++s) {
      int base = level;
      if (use_segment) {
        base = filter_strength[s];
        if (!absolute_delta) base += level;
      }
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FInfo& fi = fstrengths[s][i4x4];
        int lvl = base;
        if (use_lf_delta) {
          lvl += ref_lf_delta[0];
          if (i4x4) lvl += mode_lf_delta[0];
        }
        lvl = lvl < 0 ? 0 : lvl > 63 ? 63 : lvl;
        if (lvl > 0) {
          int ilevel = lvl;
          if (sharpness > 0) {
            ilevel >>= sharpness > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
          }
          if (ilevel < 1) ilevel = 1;
          fi.ilevel = uint8_t(ilevel);
          fi.limit = uint8_t(2 * lvl + ilevel);
          fi.hev = uint8_t(lvl >= 40 ? 2 : lvl >= 15 ? 1 : 0);
        } else {
          fi.limit = 0;
        }
        fi.inner = uint8_t(i4x4);
      }
    }
  }

  void parse_modes(MBInfo& b, uint8_t* top, uint8_t* left) {
    b.segment = 0;
    if (update_map)
      b.segment = uint8_t(!br.bit(seg_probs[0]) ? br.bit(seg_probs[1])
                                                : br.bit(seg_probs[2]) + 2);
    b.skip = use_skip ? uint8_t(br.bit(skip_p)) : 0;
    b.is_i4x4 = !br.bit(145);
    if (!b.is_i4x4) {
      const int ymode = br.bit(156) ? (br.bit(128) ? B_TM : B_HE)
                                    : (br.bit(163) ? B_VE : B_DC);
      b.imodes[0] = uint8_t(ymode);
      std::memset(top, ymode, 4);
      std::memset(left, ymode, 4);
    } else {
      uint8_t* modes = b.imodes;
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* prob = kBModesProba + (top[x] * 10 + ymode) * 9;
          int i = kYModesIntra4[br.bit(prob[0])];
          while (i > 0) i = kYModesIntra4[2 * i + br.bit(prob[i])];
          ymode = -i;
          top[x] = uint8_t(ymode);
        }
        std::memcpy(modes, top, 4);
        modes += 4;
        left[y] = uint8_t(ymode);
      }
    }
    b.uvmode = uint8_t(!br.bit(142)   ? B_DC
                       : !br.bit(114) ? B_VE
                       : br.bit(183)  ? B_TM
                                      : B_HE);
  }

  int large_value(BoolDec& tb, const uint8_t* p) {
    int v;
    if (!tb.bit(p[3])) {
      v = !tb.bit(p[4]) ? 2 : 3 + tb.bit(p[5]);
    } else if (!tb.bit(p[6])) {
      if (!tb.bit(p[7])) {
        v = 5 + tb.bit(159);
      } else {
        v = 7 + 2 * tb.bit(165);
        v += tb.bit(145);
      }
    } else {
      const int bit1 = tb.bit(p[8]);
      const int bit0 = tb.bit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab)
        v += v + tb.bit(*tab);
      v += 3 + (8 << cat);
    }
    return v;
  }

  // GetCoeffs: one block's tokens from coefficient n on; returns the
  // position after the last coded one
  int coeffs(BoolDec& tb, int t, int ctx, const int* dq, int n, int16_t* out) {
    const uint8_t* p = proba[t][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!tb.bit(p[0])) return n;
      while (!tb.bit(p[1])) {
        p = proba[t][kBands[++n]][0];
        if (n == 16) return 16;
      }
      int v;
      const int next = kBands[n + 1];
      if (!tb.bit(p[2])) {
        v = 1;
        p = proba[t][next][1];
      } else {
        v = large_value(tb, p);
        p = proba[t][next][2];
      }
      out[kZigzag[n]] = int16_t(tb.sign(v) * dq[n > 0]);
    }
    return 16;
  }

  // ParseResiduals: the 25 blocks of one macroblock; returns whether all
  // of its coefficients (after the WHT) are zero
  bool residuals(BoolDec& tb, const MBInfo& b, uint8_t& tnz_mb,
                 uint8_t& tdc_mb, uint8_t& lnz_mb, uint8_t& ldc_mb,
                 int16_t* dst) {
    std::memset(dst, 0, 384 * sizeof(int16_t));
    const int s = b.segment;
    int first, t_ac;
    if (!b.is_i4x4) {
      int16_t dc[16] = {0};
      const int ctx = tdc_mb + ldc_mb;
      const int nz = coeffs(tb, 1, ctx, y2[s], 0, dc);
      tdc_mb = ldc_mb = nz > 0;
      if (nz > 1) {
        wht(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 256; i += 16) dst[i] = int16_t(dc0);
      }
      first = 1;
      t_ac = 0;
    } else {
      first = 0;
      t_ac = 3;
    }
    bool any = false;
    uint32_t tnz = tnz_mb & 0x0f, lnz = lnz_mb & 0x0f;
    for (int y = 0; y < 4; ++y) {
      uint32_t l = lnz & 1;
      for (int x = 0; x < 4; ++x) {
        const int ctx = int(l + (tnz & 1));
        const int nz = coeffs(tb, t_ac, ctx, y1[s], first, dst);
        l = nz > first;
        tnz = (tnz >> 1) | (l << 7);
        any |= nz > 1 || dst[0] != 0;
        dst += 16;
      }
      tnz >>= 4;
      lnz = (lnz >> 1) | (l << 7);
    }
    uint32_t out_t = tnz, out_l = lnz >> 4;
    for (int c = 0; c < 4; c += 2) {
      tnz = tnz_mb >> (4 + c);
      lnz = lnz_mb >> (4 + c);
      for (int y = 0; y < 2; ++y) {
        uint32_t l = lnz & 1;
        for (int x = 0; x < 2; ++x) {
          const int ctx = int(l + (tnz & 1));
          const int nz = coeffs(tb, 2, ctx, uvq[s], 0, dst);
          l = nz > 0;
          tnz = (tnz >> 1) | (l << 3);
          any |= nz > 1 || dst[0] != 0;
          dst += 16;
        }
        tnz >>= 2;
        lnz = (lnz >> 1) | (l << 5);
      }
      out_t |= (tnz << 4) << c;
      out_l |= (lnz & 0xf0) << c;
    }
    tnz_mb = uint8_t(out_t);
    lnz_mb = uint8_t(out_l);
    return !any;
  }

  // predict and add the residuals of macroblock (mx, my) from the
  // unfiltered frame, as frame_dec.c's ReconstructRow does in its cache:
  // 127 above the frame, 129 left of it, and for 4x4 prediction the four
  // pixels above-right of the macroblock (the last one above repeated on
  // the right edge) also for its lower rows of subblocks
  void reconstruct(int mx, int my, const MBInfo& b, const int16_t* coeffs) {
    uint8_t ybuf[BPS * 17], ubuf[BPS * 9], vbuf[BPS * 9];
    uint8_t* const yd = ybuf + BPS + 8;
    uint8_t* const ud = ubuf + BPS + 8;
    uint8_t* const vd = vbuf + BPS + 8;
    uint8_t* const yf = f.y.data() + size_t(my) * 16 * f.ys + mx * 16;
    uint8_t* const uf = f.u.data() + size_t(my) * 8 * f.uvs + mx * 8;
    uint8_t* const vf = f.v.data() + size_t(my) * 8 * f.uvs + mx * 8;
    // top row (with the top-left corner and, for luma, 4 more to the right)
    if (my > 0) {
      std::memcpy(yd - BPS, yf - f.ys, 16);
      std::memcpy(ud - BPS, uf - f.uvs, 8);
      std::memcpy(vd - BPS, vf - f.uvs, 8);
      if (mx > 0) {
        yd[-BPS - 1] = yf[-f.ys - 1];
        ud[-BPS - 1] = uf[-f.uvs - 1];
        vd[-BPS - 1] = vf[-f.uvs - 1];
      } else {
        yd[-BPS - 1] = ud[-BPS - 1] = vd[-BPS - 1] = 129;
      }
      if (mx < f.mbw - 1)
        std::memcpy(yd - BPS + 16, yf - f.ys + 16, 4);
      else
        std::memset(yd - BPS + 16, yf[-f.ys + 15], 4);
    } else {
      std::memset(yd - BPS - 1, 127, 21);
      std::memset(ud - BPS - 1, 127, 9);
      std::memset(vd - BPS - 1, 127, 9);
    }
    for (int j = 0; j < 16; ++j)
      yd[j * BPS - 1] = mx > 0 ? yf[j * f.ys - 1] : 129;
    for (int j = 0; j < 8; ++j) {
      ud[j * BPS - 1] = mx > 0 ? uf[j * f.uvs - 1] : 129;
      vd[j * BPS - 1] = mx > 0 ? vf[j * f.uvs - 1] : 129;
    }
    auto nonzero = [](const int16_t* c) {
      for (int k = 0; k < 16; ++k)
        if (c[k]) return true;
      return false;
    };
    if (b.is_i4x4) {
      uint8_t* const tr = yd - BPS + 16;
      for (int r = 1; r < 4; ++r) std::memcpy(tr + 4 * r * BPS, tr, 4);
      for (int n = 0; n < 16; ++n) {
        uint8_t* const dst = yd + (n & 3) * 4 + (n >> 2) * 4 * BPS;
        predict4(dst, b.imodes[n]);
        if (nonzero(coeffs + n * 16)) idct_add(coeffs + n * 16, dst);
      }
    } else {
      predict_block(yd, edge_mode(mx, my, b.imodes[0]), 16);
      for (int n = 0; n < 16; ++n)
        if (nonzero(coeffs + n * 16))
          idct_add(coeffs + n * 16, yd + (n & 3) * 4 + (n >> 2) * 4 * BPS);
    }
    const int uvmode = edge_mode(mx, my, b.uvmode);
    predict_block(ud, uvmode, 8);
    predict_block(vd, uvmode, 8);
    for (int n = 0; n < 4; ++n) {
      const int off = (n & 1) * 4 + (n >> 1) * 4 * BPS;
      if (nonzero(coeffs + 256 + n * 16)) idct_add(coeffs + 256 + n * 16, ud + off);
      if (nonzero(coeffs + 320 + n * 16)) idct_add(coeffs + 320 + n * 16, vd + off);
    }
    for (int j = 0; j < 16; ++j) std::memcpy(yf + j * f.ys, yd + j * BPS, 16);
    for (int j = 0; j < 8; ++j) {
      std::memcpy(uf + j * f.uvs, ud + j * BPS, 8);
      std::memcpy(vf + j * f.uvs, vd + j * BPS, 8);
    }
  }

  static int edge_mode(int mx, int my, int mode) {
    if (mode != B_DC) return mode;
    if (mx == 0) return my == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
    return my == 0 ? DC_NOTOP : B_DC;
  }

  void filter_mb(int mx, int my, const FInfo& fi) {
    const int limit = fi.limit;
    if (limit == 0) return;
    uint8_t* const yp = f.y.data() + size_t(my) * 16 * f.ys + mx * 16;
    const int ys = f.ys;
    if (filter_type == 1) {
      if (mx > 0) simple_edge(yp, 1, ys, limit + 4);
      if (fi.inner)
        for (int k = 1; k < 4; ++k) simple_edge(yp + 4 * k, 1, ys, limit);
      if (my > 0) simple_edge(yp, ys, 1, limit + 4);
      if (fi.inner)
        for (int k = 1; k < 4; ++k)
          simple_edge(yp + 4 * k * ys, ys, 1, limit);
      return;
    }
    uint8_t* const up = f.u.data() + size_t(my) * 8 * f.uvs + mx * 8;
    uint8_t* const vp = f.v.data() + size_t(my) * 8 * f.uvs + mx * 8;
    const int uvs = f.uvs, il = fi.ilevel, hv = fi.hev;
    if (mx > 0) {
      normal_edge(yp, 1, ys, 16, limit + 4, il, hv, true);
      normal_edge(up, 1, uvs, 8, limit + 4, il, hv, true);
      normal_edge(vp, 1, uvs, 8, limit + 4, il, hv, true);
    }
    if (fi.inner) {
      for (int k = 1; k < 4; ++k)
        normal_edge(yp + 4 * k, 1, ys, 16, limit, il, hv, false);
      normal_edge(up + 4, 1, uvs, 8, limit, il, hv, false);
      normal_edge(vp + 4, 1, uvs, 8, limit, il, hv, false);
    }
    if (my > 0) {
      normal_edge(yp, ys, 1, 16, limit + 4, il, hv, true);
      normal_edge(up, uvs, 1, 8, limit + 4, il, hv, true);
      normal_edge(vp, uvs, 1, 8, limit + 4, il, hv, true);
    }
    if (fi.inner) {
      for (int k = 1; k < 4; ++k)
        normal_edge(yp + 4 * k * ys, ys, 1, 16, limit, il, hv, false);
      normal_edge(up + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
      normal_edge(vp + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
    }
  }

  void decode() {
    parse_header();
    f.ys = f.mbw * 16;
    f.uvs = f.mbw * 8;
    f.y.assign(size_t(f.ys) * f.mbh * 16, 0);
    f.u.assign(size_t(f.uvs) * f.mbh * 8, 0);
    f.v.assign(size_t(f.uvs) * f.mbh * 8, 0);
    std::vector<uint8_t> intra_t(size_t(4) * f.mbw, B_DC);
    std::vector<uint8_t> tnz(size_t(f.mbw), 0), tdc(size_t(f.mbw), 0);
    std::vector<MBInfo> row(size_t(f.mbw));
    std::vector<FInfo> finfo(size_t(f.mbw) * f.mbh);
    std::vector<int16_t> coeffs(384);
    for (int my = 0; my < f.mbh; ++my) {
      uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
      for (int mx = 0; mx < f.mbw; ++mx)
        parse_modes(row[size_t(mx)], &intra_t[size_t(4) * mx], intra_l);
      if (br.eof) fail(E_VP8);
      BoolDec& tb = parts[my & (num_parts - 1)];
      uint8_t lnz = 0, ldc = 0;
      for (int mx = 0; mx < f.mbw; ++mx) {
        const MBInfo& b = row[size_t(mx)];
        bool skip = b.skip;
        if (!skip) {
          skip = residuals(tb, b, tnz[size_t(mx)], tdc[size_t(mx)], lnz,
                           ldc, coeffs.data());
        } else {
          std::fill(coeffs.begin(), coeffs.end(), int16_t(0));
          lnz = tnz[size_t(mx)] = 0;
          if (!b.is_i4x4) ldc = tdc[size_t(mx)] = 0;
        }
        if (filter_type > 0) {
          FInfo& fi = finfo[size_t(my) * f.mbw + mx];
          fi = fstrengths[b.segment][b.is_i4x4];
          fi.inner |= !skip;
        }
        if (tb.eof) fail(E_VP8);
        reconstruct(mx, my, b, coeffs.data());
      }
    }
    if (filter_type > 0)
      for (int my = 0; my < f.mbh; ++my)
        for (int mx = 0; mx < f.mbw; ++mx)
          filter_mb(mx, my, finfo[size_t(my) * f.mbw + mx]);
  }
};

// --- YUV -> RGB (dsp/yuv.h) and the fancy upsampler (dsp/upsampling.c) -----

static inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
static inline uint8_t yuv_clip(int v) {
  return uint8_t((v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255);
}
static inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = yuv_clip(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgb[1] = yuv_clip(mult_hi(y, 19077) - mult_hi(u, 6419) -
                    mult_hi(v, 13320) + 8708);
  rgb[2] = yuv_clip(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// UpsampleRgbLinePair: two luma rows (bottom may be null) between two
// chroma rows, each chroma sample weighted 9-3-3-1 with its neighbours
static void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y,
                          const uint8_t* top_u, const uint8_t* top_v,
                          const uint8_t* cur_u, const uint8_t* cur_v,
                          uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  auto load = [](int u, int v) { return uint32_t(u) | (uint32_t(v) << 16); };
  const int last_pair = (len - 1) >> 1;
  uint32_t tl = load(top_u[0], top_v[0]);
  uint32_t l = load(cur_u[0], cur_v[0]);
  {
    const uint32_t uv0 = (3 * tl + l + 0x00020002u) >> 2;
    yuv_to_rgb(top_y[0], uv0 & 0xff, uv0 >> 16, top_dst);
  }
  if (bottom_y) {
    const uint32_t uv0 = (3 * l + tl + 0x00020002u) >> 2;
    yuv_to_rgb(bottom_y[0], uv0 & 0xff, uv0 >> 16, bottom_dst);
  }
  for (int x = 1; x <= last_pair; ++x) {
    const uint32_t t = load(top_u[x], top_v[x]);
    const uint32_t uv = load(cur_u[x], cur_v[x]);
    const uint32_t avg = tl + t + l + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t + l)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl + uv)) >> 3;
    {
      const uint32_t uv0 = (diag_12 + tl) >> 1;
      const uint32_t uv1 = (diag_03 + t) >> 1;
      yuv_to_rgb(top_y[2 * x - 1], uv0 & 0xff, (uv0 >> 16) & 0xff,
                 top_dst + (2 * x - 1) * 3);
      yuv_to_rgb(top_y[2 * x], uv1 & 0xff, (uv1 >> 16) & 0xff,
                 top_dst + (2 * x) * 3);
    }
    if (bottom_y) {
      const uint32_t uv0 = (diag_03 + l) >> 1;
      const uint32_t uv1 = (diag_12 + uv) >> 1;
      yuv_to_rgb(bottom_y[2 * x - 1], uv0 & 0xff, (uv0 >> 16) & 0xff,
                 bottom_dst + (2 * x - 1) * 3);
      yuv_to_rgb(bottom_y[2 * x], uv1 & 0xff, (uv1 >> 16) & 0xff,
                 bottom_dst + (2 * x) * 3);
    }
    tl = t;
    l = uv;
  }
  if (!(len & 1)) {
    {
      const uint32_t uv0 = (3 * tl + l + 0x00020002u) >> 2;
      yuv_to_rgb(top_y[len - 1], uv0 & 0xff, uv0 >> 16,
                 top_dst + (len - 1) * 3);
    }
    if (bottom_y) {
      const uint32_t uv0 = (3 * l + tl + 0x00020002u) >> 2;
      yuv_to_rgb(bottom_y[len - 1], uv0 & 0xff, uv0 >> 16,
                 bottom_dst + (len - 1) * 3);
    }
  }
}

// the frame, cropped to w x h, as RGB into out (row stride `stride`
// bytes), as io_dec.c's EmitFancyRGB emits it
static void to_rgb(const Frame& f, uint8_t* out, size_t stride) {
  const int w = f.w, h = f.h;
  const uint8_t* y = f.y.data();
  const uint8_t* u = f.u.data();
  const uint8_t* v = f.v.data();
  upsample_pair(y, nullptr, u, v, u, v, out, nullptr, w);
  int k = 1;
  for (; 2 * k <= h - 1; ++k)
    upsample_pair(y + size_t(2 * k - 1) * f.ys, y + size_t(2 * k) * f.ys,
                  u + size_t(k - 1) * f.uvs, v + size_t(k - 1) * f.uvs,
                  u + size_t(k) * f.uvs, v + size_t(k) * f.uvs,
                  out + (2 * k - 1) * stride, out + (2 * k) * stride, w);
  if (!(h & 1) && h > 1) {
    const int c = h / 2 - 1;
    upsample_pair(y + size_t(h - 1) * f.ys, nullptr, u + size_t(c) * f.uvs,
                  v + size_t(c) * f.uvs, u + size_t(c) * f.uvs,
                  v + size_t(c) * f.uvs, out + (h - 1) * stride, nullptr, w);
  }
}

}  // namespace vp8

// ===========================================================================
// The container (libwebp's demux.c: ParseSingleImage, ParseVP8X,
// StoreFrame, ParseAnimationFrame and the IsValid* checks)

enum : uint32_t {
  ANIMATION_FLAG = 0x02, XMP_FLAG = 0x04, EXIF_FLAG = 0x08,
  ALPHA_FLAG = 0x10, ICCP_FLAG = 0x20, ALL_VALID_FLAGS = 0x3e,
};
constexpr uint32_t kMaxChunkPayload = ~0u - 8 - 1;

static inline bool is(const uint8_t* p, const char* tag) {
  return std::memcmp(p, tag, 4) == 0;
}

struct FrameData {
  int x = 0, y = 0, w = 0, h = 0;
  bool lossless = false;
  const uint8_t* img = nullptr;   // the image chunk's payload
  size_t img_size = 0;            // its bytes, padding included
  size_t img_declared = 0;        // its size field
  const uint8_t* alpha = nullptr; // the ALPH payload, if decoded
  size_t alpha_size = 0;
  bool found = false;
};

struct Container {
  const uint8_t* d;
  size_t end;                    // riff_end: nothing past it is read
  size_t pos = 12;
  uint32_t flags = 0;
  int cw = 0, ch = 0;            // the canvas
  int n_frames = 0;
  FrameData first;

  Container(const uint8_t* data, size_t size) : d(data) {
    if (size < 20) fail(size >= 12 && is(data, "RIFF") ? E_TRUNCATED
                                                       : E_CONTAINER);
    if (!is(d, "RIFF") || !is(d + 8, "WEBP")) fail(E_CONTAINER);
    const uint32_t riff = le32(d + 4);
    if (riff < 8 || riff > kMaxChunkPayload) fail(E_CONTAINER);
    end = size_t(riff) + 8;
    if (size < end) fail(E_TRUNCATED);   // libwebp's demuxer wants it all
    if (is(d + 12, "VP8 ") || is(d + 12, "VP8L")) {
      FrameData f;
      store_frame(f, 0);
      if (!f.found) fail(E_CONTAINER);
      cw = f.w;
      ch = f.h;
      add(f);
    } else if (is(d + 12, "VP8X")) {
      parse_vp8x();
    } else {
      fail(E_CONTAINER);   // PIL does not take it for a WebP file
    }
    if (n_frames == 0) fail(E_NO_FRAME);
    if (uint64_t(cw) * uint64_t(ch) > kMaxPixels) fail(E_TOO_LARGE);
  }

  size_t left() const { return end - pos; }

  void add(const FrameData& f) {
    if (n_frames++ == 0) first = f;
  }

  // StoreFrame: an optional ALPH chunk, then one VP8 or VP8L chunk;
  // stops (without reading it) at any other chunk
  void store_frame(FrameData& f, size_t min_size) {
    if (left() < 8 || left() < min_size) fail(E_CONTAINER);
    int alpha_chunks = 0, image_chunks = 0;
    for (;;) {
      const size_t start = pos;
      const uint8_t* c = d + pos;
      const uint32_t size = le32(c + 4);
      if (size > kMaxChunkPayload) fail(E_CONTAINER);
      const size_t padded = size_t(size) + (size & 1);
      if (padded > left() - 8) fail(E_CONTAINER);   // past the RIFF's end
      bool stop = false;
      if (is(c, "ALPH") && alpha_chunks == 0) {
        ++alpha_chunks;
        f.alpha = c + 8;
        f.alpha_size = size;
        pos += 8 + padded;
      } else if ((is(c, "VP8 ") || is(c, "VP8L")) && image_chunks == 0) {
        const bool lossless = is(c, "VP8L");
        if (lossless && alpha_chunks) fail(E_CONTAINER);
        ++image_chunks;
        f.lossless = lossless;
        f.img = c + 8;
        f.img_size = padded;
        f.img_declared = size;
        features(f);
        f.found = true;
        pos += 8 + padded;
      } else {
        stop = true;
        pos = start;
      }
      if (stop || pos == end) break;
      if (left() < 8) fail(E_CONTAINER);
    }
    if (!f.found && alpha_chunks) fail(E_CONTAINER);   // ALPH, no image
  }

  // WebPGetFeatures on the image chunk: its header's size
  static void features(FrameData& f) {
    const uint8_t* p = f.img;
    if (f.lossless) {
      if (f.img_declared < 5 || p[0] != 0x2f || (p[4] >> 5) != 0)
        fail(E_VP8L);
      const uint32_t bits = le32(p + 1);
      f.w = int(bits & 0x3fff) + 1;
      f.h = int((bits >> 14) & 0x3fff) + 1;
    } else {
      if (f.img_declared < 10) fail(E_VP8);
      const uint32_t bits = le24(p);
      if ((bits & 1) || ((bits >> 1) & 7) > 3 || !((bits >> 4) & 1) ||
          (bits >> 5) >= f.img_declared)
        fail(E_VP8);
      if (p[3] != 0x9d || p[4] != 0x01 || p[5] != 0x2a) fail(E_VP8);
      f.w = int(le16(p + 6) & 0x3fff);
      f.h = int(le16(p + 8) & 0x3fff);
      if (f.w == 0 || f.h == 0) fail(E_VP8);
    }
  }

  void parse_vp8x() {
    const uint32_t size = le32(d + 16);
    if (size > kMaxChunkPayload || size < 10) fail(E_CONTAINER);
    const size_t padded = size_t(size) + (size & 1);
    pos = 20;
    if (padded > left()) fail(E_CONTAINER);
    flags = d[pos];
    cw = int(le24(d + pos + 4)) + 1;
    ch = int(le24(d + pos + 7)) + 1;
    if (uint64_t(cw) * uint64_t(ch) >= (uint64_t(1) << 32)) fail(E_CONTAINER);
    pos += padded;
    if (flags & ~ALL_VALID_FLAGS) fail(E_CONTAINER);
    const bool animation = flags & ANIMATION_FLAG;
    if (left() < 8) fail(pos == end ? E_NO_FRAME : E_CONTAINER);
    int anim_chunks = 0;
    bool still = false;
    for (;;) {
      const uint8_t* c = d + pos;
      const uint32_t csize = le32(c + 4);
      if (csize > kMaxChunkPayload) fail(E_CONTAINER);
      const size_t cpad = size_t(csize) + (csize & 1);
      if (cpad > left() - 8) fail(E_CONTAINER);   // past the RIFF's end
      if (is(c, "VP8X")) fail(E_CONTAINER);
      if (is(c, "ALPH") || is(c, "VP8 ") || is(c, "VP8L")) {
        if (anim_chunks > 0 || animation || still) fail(E_CONTAINER);
        still = true;
        FrameData f;
        store_frame(f, 8);
        if (!f.found) fail(E_CONTAINER);
        // the demuxer drops an ALPH chunk that the flags do not announce
        if (!(flags & ALPHA_FLAG)) f.alpha = nullptr;
        if (f.w != cw || f.h != ch) fail(E_CONTAINER);
        add(f);
      } else if (is(c, "ANIM")) {
        if (cpad < 6) fail(E_CONTAINER);
        ++anim_chunks;
        pos += 8 + cpad;
      } else if (is(c, "ANMF")) {
        if (anim_chunks == 0) fail(E_CONTAINER);
        parse_frame(cpad, animation);
      } else {   // ICCP, EXIF, XMP and unknown chunks
        pos += 8 + cpad;
      }
      if (pos == end) break;
      if (left() < 8) fail(E_CONTAINER);
    }
  }

  void parse_frame(size_t padded, bool animation) {
    if (padded < 16) fail(E_CONTAINER);
    const uint8_t* h = d + pos + 8;
    FrameData f;
    f.x = 2 * int(le24(h));
    f.y = 2 * int(le24(h + 3));
    const uint64_t fw = le24(h + 6) + 1ull, fh = le24(h + 9) + 1ull;
    if (fw * fh >= (uint64_t(1) << 32)) fail(E_CONTAINER);
    pos += 8 + 16;
    const size_t payload = padded - 16, start = pos;
    store_frame(f, payload);
    if (pos - start > payload) fail(E_CONTAINER);
    if (animation && f.found) {
      if (f.x + f.w > cw || f.y + f.h > ch) fail(E_CONTAINER);
      add(f);
    }
  }
};

// ALPH: the header byte, then raw or VP8L-compressed alpha (ALPHInit)
static void check_alpha(const uint8_t* a, size_t n, int w, int h) {
  if (n <= 1) fail(E_ALPHA);
  const int method = a[0] & 3, pre = (a[0] >> 4) & 3, rsrv = a[0] >> 6;
  if (method > 1 || pre > 1 || rsrv != 0) fail(E_ALPHA);
  if (method == 0) {
    if (n - 1 < size_t(w) * size_t(h)) fail(E_ALPHA);
  } else {
    vp8l::decode_alpha(a + 1, n - 1, w, h);
  }
}

// The first frame, decoded into `rgb` ([ch][cw][3], zeroed first) at its
// offset on the canvas.
static void decode_first(const Container& c, uint8_t* rgb) {
  const FrameData& f = c.first;
  const size_t stride = size_t(c.cw) * 3;
  std::memset(rgb, 0, stride * size_t(c.ch));
  uint8_t* out = rgb + size_t(f.y) * stride + size_t(f.x) * 3;
  if (f.lossless) {
    int w, h;
    const std::vector<uint32_t> px = vp8l::decode(f.img, f.img_size, w, h);
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const uint32_t p = px[size_t(y) * w + x];
        uint8_t* o = out + y * stride + size_t(x) * 3;
        o[0] = uint8_t(p >> 16);
        o[1] = uint8_t(p >> 8);
        o[2] = uint8_t(p);
      }
    return;
  }
  vp8::Decoder dec(f.img, f.img_size, f.img_declared);
  dec.decode();
  if (f.alpha) check_alpha(f.alpha, f.alpha_size, f.w, f.h);
  vp8::to_rgb(dec.f, out, stride);
}

}  // namespace webp

extern "C" {

// info: [canvas width, canvas height].  Returns 0 or a negative
// webp:: code.
long teimg_webp_info(const uint8_t* data, long size, long* info) {
  if (!data || size < 0 || !info) return webp::E_ARGS;
  try {
    const webp::Container c(data, size_t(size));
    info[0] = c.cw;
    info[1] = c.ch;
    return webp::OK;
  } catch (const webp::Fail& f) {
    return f.code;
  } catch (const std::bad_alloc&) {
    return webp::E_TOO_LARGE;
  }
}

// rgb: [canvas height, canvas width, 3] uint8 (teimg_webp_info's size):
// frame 1 on a black canvas, as PIL's convert("RGB") gives it.
long teimg_webp_decode(const uint8_t* data, long size, uint8_t* rgb) {
  if (!data || size < 0 || !rgb) return webp::E_ARGS;
  try {
    const webp::Container c(data, size_t(size));
    webp::decode_first(c, rgb);
    return webp::OK;
  } catch (const webp::Fail& f) {
    return f.code;
  } catch (const std::bad_alloc&) {
    return webp::E_TOO_LARGE;
  }
}

}  // extern "C"
