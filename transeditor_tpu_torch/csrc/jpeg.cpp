// The port's JPEG codec: 8-bit decode to RGB of every frame type
// libjpeg-turbo reads, baseline encode from RGB; integer only, no
// library.
//
// Both directions reproduce libjpeg-turbo's default results bit for bit
// (the library the JAX package's native runtime links, and PIL's):
//   * decode = jpeg_read_header + out_color_space JCS_RGB with the
//     defaults: Huffman (SOF0-2) or arithmetic (SOF9-10, jdarith.c with
//     jaricom.c's Qe table, DAC conditioning) entropy decoding,
//     sequential or progressive; dequantisation and the ISLOW IDCT as
//     libjpeg-turbo's SIMD code (which PIL and the JAX binding run)
//     computes them, the "fancy" upsampling of jdsample.c (h2v1, h1v2,
//     h2v2), the fixed-point YCbCr->RGB of jdcolor.c; grayscale is
//     replicated;
//   * on request only, as PIL (libjpeg-turbo 3.1) reads an image file:
//     - 4-component (CMYK / YCCK) decode: out_color_space JCS_CMYK
//       (YCCK through jdcolor.c's ycck_cmyk_convert), PIL's inverted
//       "CMYK;I" unpacking (Adobe polarity, assumed for every CMYK
//       JPEG), then Pillow's cmyk2rgb (Convert.c);
//     - 8-bit lossless (SOF3, Huffman): jdlhuff.c's difference
//       categories 0-16, jdpred.c's predictors 1-7 with the first-row
//       rule at the start of the scan and after each restart (as
//       jddiffct.c walks its iMCU rows), the point transform's left
//       shift, upsampling by replication (no fancy upsampling in
//       lossless mode) and no colour conversion (samples as stored);
//   * encode = jpeg_set_defaults + jpeg_set_quality(q, TRUE): JFIF
//     APP0 1.01, the Annex K tables scaled by jpeg_quality_scaling, 4:2:0
//     YCbCr by jccolor.c / jcsample.c, the ISLOW FDCT of jfdctint.c,
//     libjpeg-turbo's reciprocal quantisation, the standard Huffman
//     tables.
//
// What it refuses (each a distinct negative code, named by
// data/native.py): what libjpeg-turbo refuses (hierarchical frames,
// lossless arithmetic coding (SOF11), precisions other than 8, lossless
// frames whose colour space would need converting, a lossless restart
// interval that is not a whole number of MCU rows), lossless frames
// unless asked for (libjpeg-turbo 2.1, the JAX binding's, refuses them),
// 2 components (4 unless asked for), sampling ratios other than 1 or 2
// per axis in DCT frames, progressive files whose scans leave
// coefficients 1-9 unrefined (libjpeg would apply block smoothing), and
// any truncated or corrupt stream on which libjpeg warns and pads or
// substitutes data (a bad Huffman code, data past a marker, a bad
// arithmetic code).
//
// C ABI: teio_jpeg_decode, teio_jpeg_decode_pil, teio_jpeg_encode.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

namespace jpeg {

enum : int {
  OK = 0,
  E_CORRUPT = -1,      // malformed marker segment
  E_SIZE = -2,         // the frame's size is not the caller's
  E_NOT_JPEG = -3,     // no SOI at the start
  E_TRUNCATED = -4,    // data ends before the image does (or no EOI)
  E_ARITHMETIC = -5,   // SOF11: lossless arithmetic coding
  E_PRECISION = -6,    // 12-bit or other non-8-bit samples
  E_LOSSLESS = -7,     // SOF3 where not asked for (LMDB records)
  E_COMPONENTS = -8,   // not 1 or 3 components (nor 4 when allowed)
  E_SAMPLING = -9,     // a sampling ratio other than 1 or 2 per axis
  E_HUFFMAN = -10,     // no Huffman code matches the data
  E_TABLE = -11,       // a scan uses a missing or invalid table
  E_SMOOTHING = -12,   // progressive scans leave coefficients 1-9 coarse
  E_TOO_LARGE = -13,   // more blocks than the stream could hold
  E_PROGRESSION = -14, // invalid progressive scan parameters
  E_NO_IMAGE = -15,    // EOI before a frame and a scan
  E_COEFFICIENT = -16, // a run of coefficients past the end of a block
  E_ARGS = -17,        // encode: bad size or buffer
  E_HIERARCHICAL = -18,  // SOF5-7, SOF13-15, DHP, EXP
  E_ARITH_CODE = -19,  // arithmetic data libjpeg warns on and drops
  E_CONVERSION = -20,  // lossless: a colour space that needs converting
  E_RESTART = -21,     // lossless: restarts not at whole MCU rows
};

struct Fail {
  int code;
};

[[noreturn]] static void fail(int code) { throw Fail{code}; }

// zigzag index -> natural (row-major) index
static const uint8_t kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// ---------------------------------------------------------------------------
// The standard tables (ITU T.81 Annex K; libjpeg's jcparam.c, jstdhuff.c)

static const uint8_t kLumaQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
static const uint8_t kChromaQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

struct StdHuff {
  uint8_t bits[17];  // bits[l]: number of codes of length l (bits[0] unused)
  uint8_t vals[162];
  int n;
};

static const StdHuff kDcLuma = {
    {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11},
    12};
static const StdHuff kDcChroma = {
    {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11},
    12};
static const StdHuff kAcLuma = {
    {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
     0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
     0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
     0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
     0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
     0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
     0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
     0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
     0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
     0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
     0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
     0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
     0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    162};
static const StdHuff kAcChroma = {
    {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
     0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
     0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
     0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
     0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
     0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
     0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
     0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
     0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
     0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
     0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
     0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
     0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    162};

// ---------------------------------------------------------------------------
// ISLOW constants (jidctint.c / jfdctint.c)

constexpr int CONST_BITS = 13, PASS1_BITS = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
                  FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
                  FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
                  FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
                  FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

static inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

// ===========================================================================
// Decoder

// the colour conversions' fixed-point tables
struct Tables {
  int cr_r[256], cb_b[256], cr_g[256], cb_g[256];  // jdcolor.c
  int y_r[256], y_g[256], y_b[256];                // jccolor.c
  int cb_r[256], cb_g_e[256], cbcr_b[256], cr_g_e[256], cr_b[256];
  Tables() {
    constexpr int SCALEBITS = 16;
    constexpr int64_t ONE_HALF = int64_t(1) << (SCALEBITS - 1);
    auto fix = [](double v) { return int64_t(v * 65536.0 + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = int((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = int((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = int(-fix(0.71414) * x);
      cb_g[i] = int(-fix(0.34414) * x + ONE_HALF);
    }
    constexpr int64_t CBCR_OFFSET = int64_t(128) << SCALEBITS;
    for (int i = 0; i < 256; ++i) {
      y_r[i] = int(fix(0.29900) * i);
      y_g[i] = int(fix(0.58700) * i);
      y_b[i] = int(fix(0.11400) * i + ONE_HALF);
      cb_r[i] = int(-fix(0.16874) * i);
      cb_g_e[i] = int(-fix(0.33126) * i);
      // B=>Cb and R=>Cr share a table (0.5 with a 0.5-epsilon fudge)
      cbcr_b[i] = int(fix(0.50000) * i + CBCR_OFFSET + ONE_HALF - 1);
      cr_g_e[i] = int(-fix(0.41869) * i);
      cr_b[i] = int(-fix(0.08131) * i);
    }
  }
};

static const Tables& tables() {
  static const Tables t;
  return t;
}

static inline uint8_t clamp255(int v) {
  return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
}

struct DHuff {
  bool present = false;
  bool valid = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
  int32_t maxcode[17] = {};
  int32_t valoffset[17] = {};
  uint16_t look[512] = {};  // 9-bit lookahead: (length << 8) | symbol
  int max_sym = 0;          // a DC table's symbols are 0-15 (0-16 lossless)

  // libjpeg's jpeg_make_d_derived_tbl; false where it would ERREXIT
  bool derive() {
    uint8_t size[257];
    uint32_t code_of[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l)
      for (int i = 0; i < bits[l]; ++i) size[p++] = uint8_t(l);
    size[p] = 0;
    const int n = p;
    uint32_t code = 0;
    int si = size[0];
    p = 0;
    while (size[p]) {
      while (size[p] == si) code_of[p++] = code++;
      if (code >= (uint32_t(1) << si)) return false;
      code <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l]) {
        valoffset[l] = p - int32_t(code_of[p]);
        p += bits[l];
        maxcode[l] = int32_t(code_of[p - 1]);
      } else {
        maxcode[l] = -1;
      }
    }
    std::memset(look, 0, sizeof look);
    p = 0;
    for (int l = 1; l <= 9; ++l)
      for (int i = 0; i < bits[l]; ++i, ++p) {
        uint32_t lb = code_of[p] << (9 - l);
        for (int c = 1 << (9 - l); c > 0; --c)
          look[lb++] = uint16_t((l << 8) | vals[p]);
      }
    max_sym = 0;
    for (int i = 0; i < n; ++i) max_sym = std::max<int>(max_sym, vals[i]);
    return true;
  }
};

// Entropy-coded data: bytes with FF00 stuffing, ending at a marker.
// Bits past the marker read as zeros, but consuming one is an error:
// a valid stream never needs them.
struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;  // left-aligned
  int n = 0;         // valid bits in acc
  bool hit = false;  // reached a marker (p at its FF) or the end

  Bits(const uint8_t* p_, const uint8_t* e_) : p(p_), end(e_) {}

  void fill() {
    while (n <= 56 && !hit) {
      if (p >= end) {
        hit = true;
        break;
      }
      uint8_t b = *p;
      if (b == 0xFF) {
        const uint8_t* q = p + 1;
        while (q < end && *q == 0xFF) ++q;  // fill bytes
        if (q >= end) {
          hit = true;
          break;
        }
        if (*q != 0x00) {  // a marker: leave p on its FF
          p = q - 1;
          hit = true;
          break;
        }
        p = q + 1;         // FF (FF...) 00: one FF data byte
      } else {
        ++p;
      }
      acc |= uint64_t(b) << (56 - n);
      n += 8;
    }
  }
  void skip(int k) {
    acc <<= k;
    n -= k;
  }
  int get(int k) {
    if (k == 0) return 0;
    if (n < k) fill();
    if (n < k) fail(E_TRUNCATED);
    int v = int(acc >> (64 - k));
    skip(k);
    return v;
  }
  int bit() { return get(1); }
  int decode(const DHuff& t) {
    if (n < 16) fill();
    uint32_t look = uint32_t(acc >> 48);
    uint16_t e = t.look[look >> 7];
    int len, sym;
    if (e >> 8) {
      len = e >> 8;
      sym = e & 0xFF;
    } else {
      int32_t code = 0;
      for (len = 10; len <= 16; ++len) {
        code = int32_t(look >> (16 - len));
        if (code <= t.maxcode[len]) break;
      }
      if (len > 16) fail(n < 16 ? E_TRUNCATED : E_HUFFMAN);
      sym = t.vals[(code + t.valoffset[len]) & 0xFF];
    }
    if (len > n) fail(E_TRUNCATED);
    skip(len);
    return sym;
  }
  void reset() {
    acc = 0;
    n = 0;
    hit = false;
  }
};

// ITU T.81 Table D.2 (jaricom.c's jpeg_aritab): Qe << 16 | Next_Index_MPS
// << 8 | Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed
// probability 0.5 of T.851
static const uint32_t kQe[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171};

// jdarith.c's decoder (T.81 D.2): the C and A registers and the byte
// feed.  At a marker (p left on its FF) or at the end of the data it
// reads zeros: arithmetic-coded data may end before its last decisions.
struct Arith {
  const uint8_t* p;
  const uint8_t* end;
  int64_t c = 0, a = 0;
  int ct = -16;          // bits left in c's low byte; -16: two bytes due
  bool at_marker = false;

  Arith(const uint8_t* p_, const uint8_t* e_) : p(p_), end(e_) {}

  void restart() {
    c = a = 0;
    ct = -16;
    at_marker = false;
  }

  int byte() {
    if (at_marker) return 0;
    if (p >= end) {
      at_marker = true;
      return 0;
    }
    const int b = *p++;
    if (b != 0xFF) return b;
    while (p < end && *p == 0xFF) ++p;  // fill bytes
    if (p < end && *p == 0x00) {        // FF 00: one FF data byte
      ++p;
      return 0xFF;
    }
    --p;  // on the marker's (last) FF, or at the end
    at_marker = true;
    return 0;
  }

  // one binary decision with statistics bin *st
  int decode(uint8_t* st) {
    while (a < 0x8000) {  // renormalise, D.2.6
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;  // two bytes read
      }
      a <<= 1;
    }
    int sv = *st;
    uint32_t qe = kQe[sv & 0x7F];
    const uint8_t nl = uint8_t(qe & 0xFF);
    qe >>= 8;
    const uint8_t nm = uint8_t(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < int64_t(qe)) {  // conditional LPS exchange
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {  // conditional MPS exchange
      if (a < int64_t(qe)) {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

static inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v + (-(1 << s) + 1) : v;
}

// the next marker at or after p (skipping stray bytes, as libjpeg's
// next_marker does with a warning); p ends past its code; -1 at the end
static int next_marker(const uint8_t*& p, const uint8_t* end) {
  while (p < end) {
    if (*p != 0xFF) {
      ++p;
      continue;
    }
    const uint8_t* q = p + 1;
    while (q < end && *q == 0xFF) ++q;
    if (q >= end) break;
    if (*q == 0x00) {
      p = q + 1;
      continue;
    }
    p = q + 1;
    return *q;
  }
  p = end;
  return -1;
}

static inline int be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

struct Comp {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;            // tables of the current scan
  int bw = 0, bh = 0;            // blocks holding image samples
  int bwp = 0, bhp = 0;          // blocks stored (whole MCUs)
  int dw = 0, dh = 0;            // samples (downsampled size)
  std::vector<int16_t> coef;     // bhp * bwp blocks, natural order
  int16_t q[64] = {};            // latched at its first scan
  bool latched = false;
  int coef_bits[64];             // progressive: Al of the last scan, -1
  int pred = 0;                  // DC prediction (last_dc_val)
  int dc_context = 0;            // arithmetic: DC conditioning category
  std::vector<uint8_t> samples;  // lossless: dh rows of dw samples
  std::vector<int> undiff;       // lossless: the last row undifferenced
  bool first_row = true;         // lossless: the next row restarts
};

struct Decoder {
  const uint8_t* data;
  const uint8_t* end;
  uint16_t qt[4][64] = {};
  bool qt_present[4] = {};
  DHuff dc[4], ac[4];
  int restart_interval = 0;
  bool have_frame = false, progressive = false, defaults_set = false;
  bool arith = false, lossless = false;
  // arithmetic conditioning (DAC; reset at SOI to L 0, U 1, K 5) and
  // the statistics bins of jdarith.c
  uint8_t dc_L[16], dc_U[16], ac_K[16];
  uint8_t dc_stats[16][64], ac_stats[16][256];
  int W = 0, H = 0, nf = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  Comp comp[4];
  bool jfif = false, adobe = false;
  int adobe_transform = 0;
  int scans = 0;
  int eobrun = 0;
  int expect_w, expect_h;
  bool as_pil;                   // 4 components and lossless decoded

  Decoder(const uint8_t* d, size_t len, int w, int h, bool pil)
      : data(d), end(d + len), expect_w(w), expect_h(h), as_pil(pil) {
    std::memset(dc_L, 0, sizeof dc_L);
    std::memset(dc_U, 1, sizeof dc_U);
    std::memset(ac_K, 5, sizeof ac_K);
  }

  void read_sof(const uint8_t* b, int len, int marker) {
    if (have_frame) fail(E_CORRUPT);
    if (len < 6) fail(E_CORRUPT);
    if (b[0] != 8) fail(E_PRECISION);
    H = be16(b + 1);
    W = be16(b + 3);
    nf = b[5];
    if (len != 6 + 3 * nf) fail(E_CORRUPT);
    if (nf == 0 || H == 0 || W == 0) fail(E_CORRUPT);
    if (nf != 1 && nf != 3 && !(nf == 4 && as_pil)) fail(E_COMPONENTS);
    if (W > 65500 || H > 65500) fail(E_TOO_LARGE);
    if (W != expect_w || H != expect_h) fail(E_SIZE);
    progressive = marker == 0xC2 || marker == 0xCA;
    arith = marker >= 0xC9;
    lossless = marker == 0xC3;
    hmax = vmax = 1;
    for (int i = 0; i < nf; ++i) {
      Comp& c = comp[i];
      c.id = b[6 + 3 * i];
      c.h = b[7 + 3 * i] >> 4;
      c.v = b[7 + 3 * i] & 15;
      c.tq = b[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail(E_CORRUPT);
      // one component: one block an MCU (a lossless scan keeps the
      // frame's factors, which group its rows into iMCU rows)
      if (nf == 1 && !lossless) c.h = c.v = 1;
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    // a data unit is a block of 8x8 samples, or one sample (lossless)
    const int du = lossless ? 1 : 8;
    mcux = (W + du * hmax - 1) / (du * hmax);
    mcuy = (H + du * vmax - 1) / (du * vmax);
    int64_t units = 0;
    for (int i = 0; i < nf; ++i) {
      Comp& c = comp[i];
      // libjpeg upsamples any integral ratio by replication in lossless
      // mode; the fancy upsampling of DCT frames takes 1 or 2
      if (hmax % c.h || vmax % c.v ||
          (!lossless && (hmax / c.h > 2 || vmax / c.v > 2)))
        fail(E_SAMPLING);
      c.dw = int((int64_t(W) * c.h + hmax - 1) / hmax);
      c.dh = int((int64_t(H) * c.v + vmax - 1) / vmax);
      c.bw = (c.dw + du - 1) / du;
      c.bh = (c.dh + du - 1) / du;
      c.bwp = nf > 1 ? mcux * c.h : c.bw;
      c.bhp = nf > 1 ? mcuy * c.v : c.bh;
      units += int64_t(c.bw) * c.bh;
    }
    // A Huffman-coded data unit costs at least one bit.  Arithmetic
    // coding can code one in far less: PIL's decompression-bomb limit
    // (twice MAX_IMAGE_PIXELS) bounds those frames instead.
    if (arith ? int64_t(W) * H > 2 * int64_t(89478485)
              : units > int64_t(end - data) * 8)
      fail(E_TOO_LARGE);
    for (int i = 0; i < nf; ++i) {
      Comp& c = comp[i];
      if (lossless) {
        c.samples.assign(size_t(c.dw) * c.dh, 0);
        continue;
      }
      c.coef.assign(size_t(c.bwp) * c.bhp * 64, 0);
      for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
    }
    have_frame = true;
  }

  void read_dqt(const uint8_t* b, int len) {
    while (len > 0) {
      int pq = b[0] >> 4, tq = b[0] & 15;
      if (tq > 3) fail(E_CORRUPT);
      int need = 1 + 64 * (pq ? 2 : 1);
      if (len < need) fail(E_CORRUPT);
      for (int i = 0; i < 64; ++i)
        qt[tq][kNatural[i]] =
            uint16_t(pq ? be16(b + 1 + 2 * i) : b[1 + i]);
      qt_present[tq] = true;
      b += need;
      len -= need;
    }
  }

  void read_dht(const uint8_t* b, int len) {
    while (len > 16) {
      int idx = b[0];
      DHuff t;
      int count = 0;
      for (int l = 1; l <= 16; ++l) count += (t.bits[l] = b[l]);
      len -= 17;
      b += 17;
      if (count > 256 || count > len) fail(E_CORRUPT);
      std::memcpy(t.vals, b, size_t(count));
      b += count;
      len -= count;
      bool is_ac = idx & 0x10;
      idx &= ~0x10;
      if (idx < 0 || idx > 3) fail(E_CORRUPT);
      t.present = true;
      t.valid = t.derive();
      (is_ac ? ac : dc)[idx] = t;
    }
    if (len != 0) fail(E_CORRUPT);
  }

  void set_std(DHuff& t, const StdHuff& s) {
    if (t.present) return;
    std::memcpy(t.bits, s.bits, 17);
    std::memset(t.vals, 0, sizeof t.vals);
    std::memcpy(t.vals, s.vals, size_t(s.n));
    t.present = true;
    t.valid = t.derive();
  }

  // libjpeg-turbo sets the standard tables into empty slots 0 and 1
  // when its Huffman decoder starts (Motion-JPEG frames omit them)
  void std_tables() {
    if (defaults_set) return;
    set_std(dc[0], kDcLuma);
    set_std(ac[0], kAcLuma);
    set_std(dc[1], kDcChroma);
    set_std(ac[1], kAcChroma);
    defaults_set = true;
  }

  static const DHuff& table(const DHuff* set, int i, int max_sym = 255) {
    if (i > 3 || !set[i].present || !set[i].valid ||
        set[i].max_sym > max_sym)
      fail(E_TABLE);
    return set[i];
  }

  int16_t* block(Comp& c, int by, int bx) {
    return c.coef.data() + (size_t(by) * c.bwp + bx) * 64;
  }

  // --- sequential (baseline / extended Huffman) -------------------------
  void seq_block(Bits& br, Comp& c, int16_t* blk) {
    const DHuff& dct = dc[c.td];
    const DHuff& act = ac[c.ta];
    int s = br.decode(dct);
    if (s) s = extend(br.get(s), s);
    c.pred += s;
    blk[0] = int16_t(c.pred);
    for (int k = 1; k < 64; ++k) {
      int rs = br.decode(act);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) fail(E_COEFFICIENT);
        blk[kNatural[k]] = int16_t(extend(br.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // --- progressive (jdphuff.c) --------------------------------------------
  void dc_first(Bits& br, Comp& c, int16_t* blk, int al) {
    int s = br.decode(dc[c.td]);
    if (s) s = extend(br.get(s), s);
    c.pred += s;
    blk[0] = int16_t(uint32_t(c.pred) << al);
  }

  void dc_refine(Bits& br, int16_t* blk, int al) {
    if (br.bit()) blk[0] = int16_t(blk[0] | (1 << al));
  }

  void ac_first(Bits& br, Comp& c, int16_t* blk, int ss, int se, int al) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    const DHuff& act = ac[c.ta];
    for (int k = ss; k <= se; ++k) {
      int rs = br.decode(act);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > se) fail(E_COEFFICIENT);
        s = extend(br.get(s), s);
        blk[kNatural[k]] = int16_t(uint32_t(s) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.get(r);
        --eobrun;
        break;
      }
    }
  }

  void ac_refine(Bits& br, Comp& c, int16_t* blk, int ss, int se, int al) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    auto correct = [&](int16_t& coef) {
      if (br.bit() && (coef & p1) == 0)
        coef = int16_t(coef >= 0 ? coef + p1 : coef + m1);
    };
    if (eobrun == 0) {
      const DHuff& act = ac[c.ta];
      for (; k <= se; ++k) {
        int rs = br.decode(act);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          // a newly nonzero coefficient is always of size 1
          s = br.bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {
          int16_t& coef = blk[kNatural[k]];
          if (coef != 0) {
            correct(coef);
          } else {
            if (--r < 0) break;
          }
          ++k;
        } while (k <= se);
        if (s) {
          if (k > se) fail(E_COEFFICIENT);
          blk[kNatural[k]] = int16_t(s);
        }
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t& coef = blk[kNatural[k]];
        if (coef != 0) correct(coef);
      }
      --eobrun;
    }
  }

  // the RSTn marker at or after p (stray bytes before it skipped, as
  // libjpeg's next_marker does with a warning); returns the data after it
  const uint8_t* expect_restart(const uint8_t* p, int n) {
    const int mk = next_marker(p, end);
    if (mk < 0) fail(E_TRUNCATED);
    if (mk != 0xD0 + n) fail(E_CORRUPT);
    return p;
  }

  // a DCT scan's MCUs in order, a restart every restart_interval MCUs:
  // cd.restart(n) reads RSTn and resets, cd.unit(c, blk) decodes one
  // block of component c
  template <class Coder>
  void walk_mcus(Coder& cd, Comp** sc, int ns) {
    const bool interleaved = ns > 1;
    const int64_t total = interleaved ? int64_t(mcux) * mcuy
                                      : int64_t(sc[0]->bw) * sc[0]->bh;
    int to_go = restart_interval, next_rst = 0;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_interval) {
        if (to_go == 0) {
          cd.restart(next_rst);
          next_rst = (next_rst + 1) & 7;
          to_go = restart_interval;
        }
        --to_go;
      }
      if (interleaved) {
        const int my = int(m / mcux), mx = int(m % mcux);
        for (int i = 0; i < ns; ++i) {
          Comp& c = *sc[i];
          for (int yy = 0; yy < c.v; ++yy)
            for (int xx = 0; xx < c.h; ++xx)
              cd.unit(c, block(c, my * c.v + yy, mx * c.h + xx));
        }
      } else {
        Comp& c = *sc[0];
        cd.unit(c, block(c, int(m / c.bw), int(m % c.bw)));
      }
    }
  }

  struct HuffmanScan {
    Decoder& d;
    Bits br;
    Comp** sc;
    int ns, ss, se, ah, al;
    void restart(int n) {
      br.reset();
      br.p = d.expect_restart(br.p, n);
      for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
      d.eobrun = 0;
    }
    void unit(Comp& c, int16_t* blk) {
      if (!d.progressive)
        d.seq_block(br, c, blk);
      else if (ss == 0)
        ah ? d.dc_refine(br, blk, al) : d.dc_first(br, c, blk, al);
      else
        ah ? d.ac_refine(br, c, blk, ss, se, al)
           : d.ac_first(br, c, blk, ss, se, al);
    }
  };

  // --- arithmetic (jdarith.c) -------------------------------------------
  struct ArithScan {
    Decoder& d;
    Arith ar;
    Comp** sc;
    int ns, ss, se, ah, al;
    uint8_t fixed = 113;  // the bin of fixed probability 0.5 (T.851)

    // start_pass / process_restart: statistics, DC predictions and
    // contexts of the scan's tables zeroed, the registers refilled
    void reset() {
      for (int i = 0; i < ns; ++i) {
        Comp& c = *sc[i];
        if (!d.progressive || (ss == 0 && ah == 0)) {
          std::memset(d.dc_stats[c.td], 0, sizeof d.dc_stats[0]);
          c.pred = 0;
          c.dc_context = 0;
        }
        if (!d.progressive || ss)
          std::memset(d.ac_stats[c.ta], 0, sizeof d.ac_stats[0]);
      }
      ar.restart();
    }
    void restart(int n) {
      ar.p = d.expect_restart(ar.p, n);
      reset();
    }

    // F.2.4.1: a DC difference, its context updated
    int dc_diff(Comp& c) {
      const int tbl = c.td;
      uint8_t* st = d.dc_stats[tbl] + c.dc_context;
      if (ar.decode(st) == 0) {
        c.dc_context = 0;
        return 0;
      }
      const int sign = ar.decode(st + 1);
      st += 2 + sign;
      int m = ar.decode(st);
      if (m != 0) {
        st = d.dc_stats[tbl] + 20;  // X1
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) fail(E_ARITH_CODE);
          ++st;
        }
      }
      if (m < (1 << d.dc_L[tbl]) >> 1)
        c.dc_context = 0;            // zero difference category
      else if (m > (1 << d.dc_U[tbl]) >> 1)
        c.dc_context = 12 + sign * 4;  // large
      else
        c.dc_context = 4 + sign * 4;   // small
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      ++v;
      return sign ? -v : v;
    }

    // F.2.4.2: coefficients k0..k1 (zigzag) until EOB, scaled by 2^al
    void ac_coefs(Comp& c, int16_t* blk, int k0, int k1, int shift) {
      const int tbl = c.ta;
      for (int k = k0; k <= k1; ++k) {
        uint8_t* st = d.ac_stats[tbl] + 3 * (k - 1);
        if (ar.decode(st)) break;  // EOB
        while (ar.decode(st + 1) == 0) {
          st += 3;
          if (++k > k1) fail(E_ARITH_CODE);
        }
        const int sign = ar.decode(&fixed);
        st += 2;
        int m = ar.decode(st);
        if (m != 0 && ar.decode(st)) {
          m <<= 1;
          st = d.ac_stats[tbl] + (k <= d.ac_K[tbl] ? 189 : 217);
          while (ar.decode(st)) {
            if ((m <<= 1) == 0x8000) fail(E_ARITH_CODE);
            ++st;
          }
        }
        int v = m;
        st += 14;
        while (m >>= 1)
          if (ar.decode(st)) v |= m;
        ++v;
        if (sign) v = -v;
        blk[kNatural[k]] = int16_t(uint32_t(v) << shift);
      }
    }

    void ac_refine(Comp& c, int16_t* blk) {
      const int tbl = c.ta;
      const int p1 = 1 << al, m1 = -p1;
      int kex = se;  // the previous stage's end of block
      while (kex > 0 && !blk[kNatural[kex]]) --kex;
      for (int k = ss; k <= se; ++k) {
        uint8_t* st = d.ac_stats[tbl] + 3 * (k - 1);
        if (k > kex && ar.decode(st)) break;  // EOB
        for (;;) {
          int16_t& coef = blk[kNatural[k]];
          if (coef) {  // previously nonzero: a correction bit
            if (ar.decode(st + 2)) coef = int16_t(coef + (coef < 0 ? m1 : p1));
            break;
          }
          if (ar.decode(st + 1)) {  // newly nonzero
            coef = int16_t(ar.decode(&fixed) ? m1 : p1);
            break;
          }
          st += 3;
          if (++k > se) fail(E_ARITH_CODE);
        }
      }
    }

    void unit(Comp& c, int16_t* blk) {
      if (!d.progressive) {
        c.pred = (c.pred + dc_diff(c)) & 0xFFFF;
        blk[0] = int16_t(c.pred);
        ac_coefs(c, blk, 1, 63, 0);
      } else if (ss == 0) {
        if (ah == 0) {
          c.pred = (c.pred + dc_diff(c)) & 0xFFFF;
          blk[0] = int16_t(uint32_t(c.pred) << al);
        } else if (ar.decode(&fixed)) {
          blk[0] = int16_t(blk[0] | (1 << al));
        }
      } else if (ah == 0) {
        ac_coefs(c, blk, ss, se, al);
      } else {
        ac_refine(c, blk);
      }
    }
  };

  // --- lossless (jddiffct.c, jdlhuff.c, jdpred.c) -------------------------
  static int sample_diff(Bits& br, const DHuff& t) {
    const int s = br.decode(t);
    if (s == 0) return 0;
    if (s == 16) return 32768;  // category 16 takes no extra bits
    return extend(br.get(s), s);
  }

  // one row of component c from its differences: the first row after
  // the scan's start or a restart from the left and 2^(P - Pt - 1), the
  // others by the scan's predictor (the first column from above); then
  // the point transform's left shift
  static void undifference(Comp& c, const int* diff, int y, int psv,
                           int al) {
    std::vector<int>& row = c.undiff;   // the row above, then this one
    const int w = c.dw;
    int ra;
    if (c.first_row) {
      ra = (diff[0] + (1 << (8 - al - 1))) & 0xFFFF;
      row[0] = ra;
      for (int x = 1; x < w; ++x) row[x] = ra = (diff[x] + ra) & 0xFFFF;
      c.first_row = false;
    } else {
      int rb = row[0], rc;
      row[0] = ra = (diff[0] + rb) & 0xFFFF;
      for (int x = 1; x < w; ++x) {
        rc = rb;
        rb = row[x];
        int p;
        switch (psv) {
          case 1: p = ra; break;
          case 2: p = rb; break;
          case 3: p = rc; break;
          case 4: p = ra + rb - rc; break;
          case 5: p = ra + ((rb - rc) >> 1); break;
          case 6: p = rb + ((ra - rc) >> 1); break;
          default: p = (ra + rb) >> 1; break;
        }
        row[x] = ra = (diff[x] + p) & 0xFFFF;
      }
    }
    uint8_t* out = c.samples.data() + size_t(y) * w;
    for (int x = 0; x < w; ++x) out[x] = uint8_t(row[x] << al);
  }

  // iMCU row by iMCU row, as jddiffct.c's decompress_data: the
  // differences of its MCU rows (a restart before any of them resets
  // the prediction of the whole iMCU row), then its rows undifferenced
  const uint8_t* read_lossless(const uint8_t* p, Comp** sc, int ns,
                               int psv, int al) {
    Bits br(p, end);
    const bool inter = ns > 1;
    const int mcus_row = inter ? mcux : sc[0]->dw;
    if (restart_interval % mcus_row) fail(E_RESTART);
    const int rows_per_restart = restart_interval / mcus_row;
    std::vector<int> diff[4];
    int stride[4];
    for (int i = 0; i < ns; ++i) {
      Comp& c = *sc[i];
      stride[i] = inter ? mcux * c.h : c.dw;
      diff[i].assign(size_t(stride[i]) * c.v, 0);
      c.undiff.assign(size_t(c.dw), 0);
      c.first_row = true;
    }
    const int imcu_rows = (H + vmax - 1) / vmax;
    int rows_to_go = rows_per_restart, next_rst = 0;
    for (int r = 0; r < imcu_rows; ++r) {
      const Comp& c0 = *sc[0];
      const int mcu_rows = inter ? 1 : std::min(c0.v, c0.dh - r * c0.v);
      bool reset = false;
      for (int y = 0; y < mcu_rows; ++y) {
        if (restart_interval && rows_to_go == 0) {
          br.reset();
          br.p = expect_restart(br.p, next_rst);
          next_rst = (next_rst + 1) & 7;
          rows_to_go = rows_per_restart;
          reset = true;
        }
        for (int mx = 0; mx < mcus_row; ++mx) {
          if (!inter) {
            diff[0][size_t(y) * stride[0] + mx] =
                sample_diff(br, dc[c0.td]);
            continue;
          }
          for (int i = 0; i < ns; ++i) {
            const Comp& c = *sc[i];
            for (int yy = 0; yy < c.v; ++yy)
              for (int xx = 0; xx < c.h; ++xx)
                diff[i][size_t(yy) * stride[i] + mx * c.h + xx] =
                    sample_diff(br, dc[c.td]);
          }
        }
        --rows_to_go;
      }
      for (int i = 0; i < ns; ++i) {
        Comp& c = *sc[i];
        if (reset) c.first_row = true;
        const int rows = std::min(c.v, c.dh - r * c.v);
        for (int y = 0; y < rows; ++y)
          undifference(c, &diff[i][size_t(y) * stride[i]], r * c.v + y, psv,
                       al);
      }
    }
    return br.p;
  }

  const uint8_t* read_sos(const uint8_t* b, int len, const uint8_t* after) {
    if (!have_frame) fail(E_CORRUPT);
    if (len < 1) fail(E_CORRUPT);
    int ns = b[0];
    if (len != 1 + 2 * ns + 3 || ns < 1 || ns > 4) fail(E_CORRUPT);
    Comp* sc[4];
    for (int i = 0; i < ns; ++i) {
      int cid = b[1 + 2 * i], tb = b[2 + 2 * i];
      Comp* found = nullptr;
      for (int j = 0; j < nf; ++j)
        if (comp[j].id == cid) found = &comp[j];
      if (!found) fail(E_CORRUPT);
      for (int j = 0; j < i; ++j)
        if (sc[j] == found) fail(E_CORRUPT);
      found->td = tb >> 4;
      found->ta = tb & 15;
      sc[i] = found;
    }
    const uint8_t* t = b + 1 + 2 * ns;
    int ss = t[0], se = t[1], ah = t[2] >> 4, al = t[2] & 15;
    if (ns > 1) {
      int per_mcu = 0;
      for (int i = 0; i < ns; ++i) per_mcu += sc[i]->h * sc[i]->v;
      if (per_mcu > 10) fail(E_SAMPLING);
    }
    ++scans;
    if (lossless) {
      // jdlossls.c: Ss selects the predictor, Al is the point transform
      if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al > 7)
        fail(E_PROGRESSION);
      // no default tables here: jdlhuff.c requires the file's own
      for (int i = 0; i < ns; ++i) table(dc, sc[i]->td, 16);
      return read_lossless(after, sc, ns, ss, al);
    }
    if (!arith) std_tables();
    if (progressive) {
      bool bad = false;
      if (ss == 0) {
        if (se != 0) bad = true;
      } else {
        if (ss > se || se > 63 || ns != 1) bad = true;
      }
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) fail(E_PROGRESSION);
      for (int i = 0; i < ns; ++i) {
        if (!arith) {
          if (ss == 0) {
            if (ah == 0) table(dc, sc[i]->td, 15);
          } else {
            table(ac, sc[i]->ta);
          }
        }
        for (int k = ss; k <= se; ++k) sc[i]->coef_bits[k] = al;
      }
    } else {
      ss = 0;  // libjpeg only warns on other values in a sequential scan
      se = 63;
      ah = al = 0;
      if (!arith)
        for (int i = 0; i < ns; ++i) {
          table(dc, sc[i]->td, 15);
          table(ac, sc[i]->ta);
        }
    }
    for (int i = 0; i < ns; ++i) {
      Comp& c = *sc[i];
      if (c.latched) continue;
      if (!qt_present[c.tq]) fail(E_TABLE);
      for (int k = 0; k < 64; ++k) c.q[k] = int16_t(qt[c.tq][k]);
      c.latched = true;
    }
    eobrun = 0;
    if (arith) {
      ArithScan as{*this, Arith(after, end), sc, ns, ss, se, ah, al};
      as.reset();
      walk_mcus(as, sc, ns);
      return as.ar.p;
    }
    for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
    HuffmanScan hs{*this, Bits(after, end), sc, ns, ss, se, ah, al};
    walk_mcus(hs, sc, ns);
    return hs.br.p;
  }

  // DAC: arithmetic conditioning; L <= U for a DC table (jdmarker.c)
  void read_dac(const uint8_t* b, int len) {
    if (len % 2) fail(E_CORRUPT);
    for (; len > 0; b += 2, len -= 2) {
      const int index = b[0], val = b[1];
      if (index >= 32) fail(E_CORRUPT);
      if (index >= 16) {
        ac_K[index - 16] = uint8_t(val);
        continue;
      }
      dc_L[index] = uint8_t(val & 15);
      dc_U[index] = uint8_t(val >> 4);
      if (dc_L[index] > dc_U[index]) fail(E_CORRUPT);
    }
  }

  // libjpeg-turbo's smoothing_ok: it smooths (so differs from a plain
  // IDCT) when every DC is known and one of coefficients 1-9 is not
  // refined to its last bit
  bool would_smooth() const {
    static const int pos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (int i = 0; i < nf; ++i) {
      const Comp& c = comp[i];
      if (!c.latched) return false;
      for (int k = 0; k < 10; ++k)
        if (c.q[pos[k]] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  void parse() {
    if (end - data < 2 || data[0] != 0xFF || data[1] != 0xD8)
      fail(E_NOT_JPEG);
    const uint8_t* p = data + 2;
    for (;;) {
      int m = next_marker(p, end);
      if (m < 0) fail(E_TRUNCATED);
      if (m == 0xD9) break;                              // EOI
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;  // TEM, RSTn
      if (m == 0xD8) fail(E_CORRUPT);                    // a second SOI
      if (end - p < 2) fail(E_TRUNCATED);
      int seglen = be16(p);
      if (seglen < 2) fail(E_CORRUPT);
      if (end - p < seglen) fail(E_TRUNCATED);
      const uint8_t* b = p + 2;
      const int len = seglen - 2;
      p += seglen;
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2: case 0xC9: case 0xCA:
          read_sof(b, len, m);
          break;
        case 0xC3:
          if (!as_pil) fail(E_LOSSLESS);
          read_sof(b, len, m);
          break;
        case 0xCB:
          fail(E_ARITHMETIC);
        case 0xC5: case 0xC6: case 0xC7: case 0xCD: case 0xCE: case 0xCF:
        case 0xDE: case 0xDF:
          fail(E_HIERARCHICAL);
        case 0xC4:
          read_dht(b, len);
          break;
        case 0xDB:
          read_dqt(b, len);
          break;
        case 0xDD:
          if (len != 2) fail(E_CORRUPT);
          restart_interval = be16(b);
          break;
        case 0xDA:
          p = read_sos(b, len, p);
          break;
        case 0xE0:
          if (len >= 14 && std::memcmp(b, "JFIF\0", 5) == 0) jfif = true;
          break;
        case 0xEE:
          if (len >= 12 && std::memcmp(b, "Adobe", 5) == 0) {
            adobe = true;
            adobe_transform = b[11];
          }
          break;
        case 0xCC:
          read_dac(b, len);
          break;
        case 0xDC:  // DNL
        case 0xFE:  // COM
          break;
        default:
          if (m >= 0xE0 && m <= 0xEF) break;  // APPn
          fail(E_CORRUPT);                    // an unknown marker
      }
    }
    if (!have_frame || scans == 0) fail(E_NO_IMAGE);
    if (progressive && would_smooth()) fail(E_SMOOTHING);
    // libjpeg-turbo converts no colour space in lossless mode: a JFIF
    // frame, or an Adobe one with a transform, would be YCbCr / YCCK
    if (lossless && ((nf == 3 && jfif) || (nf > 1 && adobe && adobe_transform)))
      fail(E_CONVERSION);
  }

  // jpeg_read_header's default_decompress_parms, for 3 components
  bool is_ycc() const {
    if (jfif) return true;
    if (adobe) return adobe_transform != 0;
    if (comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66)
      return false;  // 'R', 'G', 'B'
    return true;
  }

  // --- pixels ---------------------------------------------------------------
  // The ISLOW IDCT as libjpeg-turbo's SIMD code computes it
  // (jidctint-sse2.asm / -avx2.asm, which PIL and the JAX binding run):
  // jidctint.c's arithmetic, with 16-bit lanes where those have them.
  // Dequantisation keeps the low 16 bits of the product (pmullw), the
  // input sums in0 +- in4, in7 + in3, in5 + in1 wrap to 16 bits, the
  // products and their sums are 32-bit, each pass's results saturate to
  // 16 bits (packssdw) and the output to 8 (packsswb) before the +128.
  // A block whose rows 1-7 are all zero takes the shortcut of the first
  // pass, in0 << 2 in 16 bits.  For any coefficients a valid stream holds
  // this is jidctint.c's result; on corrupt data (coefficients overflow
  // 16 bits) it is the SIMD result, which the C code's wrap-around range
  // limit would not give.
  static inline int16_t wrap16(int32_t v) { return int16_t(uint16_t(v)); }
  static inline int16_t sat16(int32_t v) {
    return int16_t(v > 32767 ? 32767 : (v < -32768 ? -32768 : v));
  }
  // pmullw: the low 16 bits of a coefficient times its quantiser
  static inline int16_t dequant(int16_t c, int16_t q) {
    return int16_t(uint16_t(uint32_t(int32_t(c)) * uint16_t(q)));
  }
  // a 32-bit lane (uint32_t: paddd / psubd wrap) descaled by n (psrad)
  static inline int32_t descale32(uint32_t v, int n) {
    return int32_t(v + (uint32_t(1) << (n - 1))) >> n;
  }
  // pmaddwd: a * ka + b * kb, 16-bit inputs and constants, 32-bit lanes
  static inline uint32_t madd(int32_t a, int32_t ka, int32_t b, int32_t kb) {
    return uint32_t(a * ka) + uint32_t(b * kb);
  }

  // one 8-point pass over in[0..7] (16-bit), as the SIMD "dodct"
  static inline __attribute__((always_inline)) void idct_1d(
      const int16_t* in, uint32_t* out) {
    // even part
    const uint32_t tmp3e = madd(in[2], FIX_0_541196100 + FIX_0_765366865,
                                in[6], FIX_0_541196100);
    const uint32_t tmp2e = madd(in[2], FIX_0_541196100, in[6],
                                FIX_0_541196100 - FIX_1_847759065);
    const uint32_t tmp0e = uint32_t(int32_t(wrap16(in[0] + in[4]))
                                    * (1 << CONST_BITS));
    const uint32_t tmp1e = uint32_t(int32_t(wrap16(in[0] - in[4]))
                                    * (1 << CONST_BITS));
    const uint32_t tmp10 = tmp0e + tmp3e, tmp13 = tmp0e - tmp3e;
    const uint32_t tmp11 = tmp1e + tmp2e, tmp12 = tmp1e - tmp2e;
    // odd part: (in7, in1) and (in5, in3) paired, z3 = in7 + in3 and
    // z4 = in5 + in1 in 16 bits
    const int s3 = wrap16(in[7] + in[3]), s4 = wrap16(in[5] + in[1]);
    const uint32_t z3 = madd(s3, FIX_1_175875602 - FIX_1_961570560, s4,
                             FIX_1_175875602);
    const uint32_t z4 = madd(s3, FIX_1_175875602, s4,
                             FIX_1_175875602 - FIX_0_390180644);
    const uint32_t tmp0 = madd(in[7], FIX_0_298631336 - FIX_0_899976223,
                               in[1], -FIX_0_899976223) + z3;
    const uint32_t tmp3 = madd(in[7], -FIX_0_899976223, in[1],
                               FIX_1_501321110 - FIX_0_899976223) + z4;
    const uint32_t tmp1 = madd(in[5], FIX_2_053119869 - FIX_2_562915447,
                               in[3], -FIX_2_562915447) + z4;
    const uint32_t tmp2 = madd(in[5], -FIX_2_562915447, in[3],
                               FIX_3_072711026 - FIX_2_562915447) + z3;
    out[0] = tmp10 + tmp3;
    out[7] = tmp10 - tmp3;
    out[1] = tmp11 + tmp2;
    out[6] = tmp11 - tmp2;
    out[2] = tmp12 + tmp1;
    out[5] = tmp12 - tmp1;
    out[3] = tmp13 + tmp0;
    out[4] = tmp13 - tmp0;
  }

  static void idct(const int16_t* in, const int16_t* q, uint8_t* out,
                   int stride) {
    int16_t ws[64];  // pass 1's 16-bit results, ws[8 * row + col]
    bool col_ac[8], ac = false;
    for (int col = 0; col < 8; ++col) {
      const int16_t* ip = in + col;
      col_ac[col] = (ip[8] | ip[16] | ip[24] | ip[32] | ip[40] | ip[48] |
                     ip[56]) != 0;
      ac |= col_ac[col];
    }
    for (int col = 0; col < 8; ++col) {
      const int16_t in0 = dequant(in[col], q[col]);
      if (!col_ac[col]) {
        // rows 1-7 of the whole block zero: the shortcut, in0 << 2 in 16
        // bits; of this column only: the full pass's result, saturated
        const int16_t v = ac ? sat16(in0 * (1 << PASS1_BITS))
                             : wrap16(in0 * (1 << PASS1_BITS));
        for (int r = 0; r < 8; ++r) ws[8 * r + col] = v;
        continue;
      }
      int16_t c[8];
      uint32_t o[8];
      c[0] = in0;
      for (int r = 1; r < 8; ++r)
        c[r] = dequant(in[8 * r + col], q[8 * r + col]);
      idct_1d(c, o);
      for (int r = 0; r < 8; ++r)
        ws[8 * r + col] = sat16(descale32(o[r], CONST_BITS - PASS1_BITS));
    }
    // packssdw then packsswb: saturation to 8 bits alone
    auto pixel = [](uint32_t v) {
      const int32_t s = descale32(v, CONST_BITS + PASS1_BITS + 3);
      return uint8_t((s < -128 ? -128 : (s > 127 ? 127 : s)) + 128);
    };
    for (int row = 0; row < 8; ++row) {
      const int16_t* w = ws + 8 * row;
      uint8_t* op = out + size_t(row) * stride;
      if (!(w[1] | w[2] | w[3] | w[4] | w[5] | w[6] | w[7])) {
        std::memset(op, pixel(uint32_t(w[0] * (1 << CONST_BITS))), 8);
        continue;
      }
      uint32_t o[8];
      idct_1d(w, o);
      for (int x = 0; x < 8; ++x) op[x] = pixel(o[x]);
    }
  }

  // one output row of component c, upsampled to full width (jdsample.c
  // with do_fancy_upsampling; rows outside the plane repeat its edge)
  void upsample_row(const Comp& c, const uint8_t* plane, int stride, int y,
                    uint8_t* out) const {
    const int rh = hmax / c.h, rv = vmax / c.v;
    const int dw = c.dw;
    if (lossless) {  // int_upsample: no fancy upsampling in lossless mode
      const uint8_t* in = plane + size_t(y / rv) * stride;
      for (int x = 0; x < W; ++x) out[x] = in[x / rh];
      return;
    }
    if (rv == 1) {
      const uint8_t* in = plane + size_t(y) * stride;
      if (rh == 1) {
        std::memcpy(out, in, size_t(dw));
      } else if (dw > 2) {  // h2v1_fancy_upsample
        int v = in[0];
        out[0] = uint8_t(v);
        out[1] = uint8_t((v * 3 + in[1] + 2) >> 2);
        for (int x = 1; x < dw - 1; ++x) {
          v = in[x] * 3;
          out[2 * x] = uint8_t((v + in[x - 1] + 1) >> 2);
          out[2 * x + 1] = uint8_t((v + in[x + 1] + 2) >> 2);
        }
        v = in[dw - 1];
        out[2 * dw - 2] = uint8_t((v * 3 + in[dw - 2] + 1) >> 2);
        out[2 * dw - 1] = uint8_t(v);
      } else {  // h2v1_upsample
        for (int x = 0; x < dw; ++x) out[2 * x] = out[2 * x + 1] = in[x];
      }
      return;
    }
    const int near = y >> 1;
    const bool lower = y & 1;
    const int far = std::min(std::max(lower ? near + 1 : near - 1, 0),
                             c.dh - 1);
    const uint8_t* in0 = plane + size_t(near) * stride;
    const uint8_t* in1 = plane + size_t(far) * stride;
    if (rh == 1) {  // h1v2_fancy_upsample
      const int bias = lower ? 2 : 1;
      for (int x = 0; x < dw; ++x)
        out[x] = uint8_t((in0[x] * 3 + in1[x] + bias) >> 2);
    } else if (dw > 2) {  // h2v2_fancy_upsample
      int this_sum = in0[0] * 3 + in1[0];
      int next_sum = in0[1] * 3 + in1[1];
      out[0] = uint8_t((this_sum * 4 + 8) >> 4);
      out[1] = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
      int last_sum = this_sum;
      this_sum = next_sum;
      for (int x = 1; x < dw - 1; ++x) {
        next_sum = in0[x + 1] * 3 + in1[x + 1];
        out[2 * x] = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
        out[2 * x + 1] = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
      }
      out[2 * dw - 2] = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
      out[2 * dw - 1] = uint8_t((this_sum * 4 + 7) >> 4);
    } else {  // h2v2_upsample
      for (int x = 0; x < dw; ++x) out[2 * x] = out[2 * x + 1] = in0[x];
    }
  }

  void render(uint8_t* rgb) {
    std::vector<uint8_t> planes[4];
    int stride[4];
    for (int i = 0; i < nf; ++i) {
      Comp& c = comp[i];
      if (lossless) {
        stride[i] = c.dw;
        planes[i].swap(c.samples);
        continue;
      }
      stride[i] = c.bw * 8;
      planes[i].assign(size_t(stride[i]) * c.bh * 8, 0);
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
          idct(block(c, by, bx), c.q,
               planes[i].data() + size_t(by) * 8 * stride[i] + bx * 8,
               stride[i]);
    }
    const Tables& t = tables();
    std::vector<uint8_t> rows(size_t(4) * (W + 2));
    uint8_t* r[4] = {rows.data(), rows.data() + (W + 2),
                     rows.data() + 2 * (W + 2), rows.data() + 3 * (W + 2)};
    const bool ycc = nf == 3 && !lossless && is_ycc();
    // default_decompress_parms: Adobe transform 0 is CMYK, any other
    // YCCK; no Adobe marker, CMYK
    const bool ycck = nf == 4 && adobe && adobe_transform != 0;
    for (int y = 0; y < H; ++y) {
      for (int i = 0; i < nf; ++i)
        upsample_row(comp[i], planes[i].data(), stride[i], y, r[i]);
      uint8_t* o = rgb + size_t(y) * W * 3;
      if (nf == 1) {
        for (int x = 0; x < W; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] =
            r[0][x];
      } else if (nf == 4) {
        for (int x = 0; x < W; ++x) {
          int c = r[0][x], m = r[1][x], yl = r[2][x];
          if (ycck) {  // ycck_cmyk_convert: 255 - the YCbCr->RGB result
            const int yy = c, cb = m, cr = yl;
            c = clamp255(255 - (yy + t.cr_r[cr]));
            m = clamp255(255 - (yy + ((t.cb_g[cb] + t.cr_g[cr]) >> 16)));
            yl = clamp255(255 - (yy + t.cb_b[cb]));
          }
          // "CMYK;I" inverts the four samples; cmyk2rgb then gives
          // nk - c * nk / 255 with nk = 255 - k, here the stored K
          const int nk = r[3][x];
          auto muldiv255 = [](int a, int b) {
            const int v = a * b + 128;
            return ((v >> 8) + v) >> 8;
          };
          o[3 * x] = clamp255(nk - muldiv255(255 - c, nk));
          o[3 * x + 1] = clamp255(nk - muldiv255(255 - m, nk));
          o[3 * x + 2] = clamp255(nk - muldiv255(255 - yl, nk));
        }
      } else if (ycc) {
        for (int x = 0; x < W; ++x) {
          int yy = r[0][x], cb = r[1][x], cr = r[2][x];
          o[3 * x] = clamp255(yy + t.cr_r[cr]);
          o[3 * x + 1] = clamp255(yy + ((t.cb_g[cb] + t.cr_g[cr]) >> 16));
          o[3 * x + 2] = clamp255(yy + t.cb_b[cb]);
        }
      } else {
        for (int x = 0; x < W; ++x) {
          o[3 * x] = r[0][x];
          o[3 * x + 1] = r[1][x];
          o[3 * x + 2] = r[2][x];
        }
      }
    }
  }
};

// ===========================================================================
// Encoder

struct EHuff {
  uint16_t code[256];
  uint8_t size[256];
  explicit EHuff(const StdHuff& s) {
    std::memset(code, 0, sizeof code);
    std::memset(size, 0, sizeof size);
    uint32_t c = 0;
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < s.bits[l]; ++i, ++p) {
        code[s.vals[p]] = uint16_t(c++);
        size[s.vals[p]] = uint8_t(l);
      }
      c <<= 1;
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int n = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t bits, int k) {
    acc = (acc << k) | (bits & ((1u << k) - 1));
    n += k;
    while (n >= 8) {
      n -= 8;
      uint8_t b = uint8_t(acc >> n);
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
    }
  }
  void flush() {  // pad the last byte with ones
    if (n) put(0x7F, 8 - n);
  }
};

// jcdctmgr.c's compute_reciprocal with 16-bit DCTELEMs (libjpeg-turbo's
// SIMD build): q = ((|x| + corr) * recip) >> shift, sign restored
struct Divisor {
  uint32_t recip, corr;
  int shift;
  explicit Divisor(uint32_t d) {
    int b = 31 - __builtin_clz(d);
    int r = 16 + b;
    uint64_t fq = (uint64_t(1) << r) / d, fr = (uint64_t(1) << r) % d;
    uint32_t c = d / 2;
    if (fr == 0) {
      fq >>= 1;
      --r;
    } else if (fr <= d / 2) {
      ++c;
    } else {
      ++fq;
    }
    recip = uint32_t(fq);
    corr = c;
    shift = r;
  }
  int16_t apply(int x) const {
    if (x < 0)
      return int16_t(-int((uint32_t(-x + int(corr)) * recip) >> shift));
    return int16_t((uint32_t(x + int(corr)) * recip) >> shift);
  }
};

static void fdct_islow(int16_t* d) {
  int16_t* p = d;
  for (int row = 0; row < 8; ++row, p += 8) {
    int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int64_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int64_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int16_t((tmp10 + tmp11) * (1 << PASS1_BITS));
    p[4] = int16_t((tmp10 - tmp11) * (1 << PASS1_BITS));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    const int sh = CONST_BITS - PASS1_BITS;
    p[2] = int16_t(descale(z1 + tmp13 * FIX_0_765366865, sh));
    p[6] = int16_t(descale(z1 + tmp12 * -FIX_1_847759065, sh));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = int16_t(descale(tmp4 + z1 + z3, sh));
    p[5] = int16_t(descale(tmp5 + z2 + z4, sh));
    p[3] = int16_t(descale(tmp6 + z2 + z3, sh));
    p[1] = int16_t(descale(tmp7 + z1 + z4, sh));
  }
  p = d;
  for (int col = 0; col < 8; ++col, ++p) {
    int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int64_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int64_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int16_t(descale(tmp10 + tmp11, PASS1_BITS));
    p[32] = int16_t(descale(tmp10 - tmp11, PASS1_BITS));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    const int sh = CONST_BITS + PASS1_BITS;
    p[16] = int16_t(descale(z1 + tmp13 * FIX_0_765366865, sh));
    p[48] = int16_t(descale(z1 + tmp12 * -FIX_1_847759065, sh));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = int16_t(descale(tmp4 + z1 + z3, sh));
    p[40] = int16_t(descale(tmp5 + z2 + z4, sh));
    p[24] = int16_t(descale(tmp6 + z2 + z3, sh));
    p[8] = int16_t(descale(tmp7 + z1 + z4, sh));
  }
}

struct Encoder {
  int W, H;
  uint8_t qlum[64], qchr[64];
  std::vector<Divisor> dlum, dchr;
  EHuff dc0{kDcLuma}, ac0{kAcLuma}, dc1{kDcChroma}, ac1{kAcChroma};

  Encoder(int w, int h, int quality) : W(w), H(h) {
    quality = std::min(100, std::max(1, quality));
    int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
    for (int i = 0; i < 64; ++i) {
      long a = (long(kLumaQuant[i]) * scale + 50) / 100;
      long b = (long(kChromaQuant[i]) * scale + 50) / 100;
      qlum[i] = uint8_t(std::min(255L, std::max(1L, a)));
      qchr[i] = uint8_t(std::min(255L, std::max(1L, b)));
    }
    for (int i = 0; i < 64; ++i) {
      dlum.emplace_back(uint32_t(qlum[i]) << 3);
      dchr.emplace_back(uint32_t(qchr[i]) << 3);
    }
  }

  // FDCT + quantisation of the 8x8 block at (x0, y0) of a plane
  void block(const uint8_t* plane, int stride, int x0, int y0,
             const std::vector<Divisor>& div, int16_t* out) const {
    int16_t ws[64];
    for (int r = 0; r < 8; ++r)
      for (int c = 0; c < 8; ++c)
        ws[8 * r + c] =
            int16_t(plane[size_t(y0 + r) * stride + x0 + c] - 128);
    fdct_islow(ws);
    for (int i = 0; i < 64; ++i) out[i] = div[i].apply(ws[i]);
  }

  static void code_block(BitWriter& bw, const int16_t* blk, int& last_dc,
                         const EHuff& dct, const EHuff& act) {
    int temp = blk[0] - last_dc, temp2 = temp;
    last_dc = blk[0];
    if (temp < 0) {
      temp = -temp;
      --temp2;
    }
    int nbits = 0;
    while (temp) {
      ++nbits;
      temp >>= 1;
    }
    bw.put(dct.code[nbits], dct.size[nbits]);
    if (nbits) bw.put(uint32_t(temp2), nbits);
    int r = 0;
    for (int k = 1; k < 64; ++k) {
      temp = blk[kNatural[k]];
      if (temp == 0) {
        ++r;
        continue;
      }
      while (r > 15) {
        bw.put(act.code[0xF0], act.size[0xF0]);
        r -= 16;
      }
      temp2 = temp;
      if (temp < 0) {
        temp = -temp;
        --temp2;
      }
      nbits = 1;
      while ((temp >>= 1)) ++nbits;
      int i = (r << 4) + nbits;
      bw.put(act.code[i], act.size[i]);
      bw.put(uint32_t(temp2), nbits);
      r = 0;
    }
    if (r > 0) bw.put(act.code[0], act.size[0]);
  }

  static void marker(std::vector<uint8_t>& o, int m, int len) {
    o.push_back(0xFF);
    o.push_back(uint8_t(m));
    o.push_back(uint8_t(len >> 8));
    o.push_back(uint8_t(len & 0xFF));
  }

  static void dht(std::vector<uint8_t>& o, const StdHuff& s, int index) {
    marker(o, 0xC4, 2 + 1 + 16 + s.n);
    o.push_back(uint8_t(index));
    o.insert(o.end(), s.bits + 1, s.bits + 17);
    o.insert(o.end(), s.vals, s.vals + s.n);
  }

  void headers(std::vector<uint8_t>& o) const {
    o.push_back(0xFF);
    o.push_back(0xD8);
    static const uint8_t jfif[] = {'J', 'F', 'I', 'F', 0, 1, 1, 0,
                                   0,   1,   0,   1,   0, 0};
    marker(o, 0xE0, 16);
    o.insert(o.end(), jfif, jfif + sizeof jfif);
    const uint8_t* qs[2] = {qlum, qchr};
    for (int t = 0; t < 2; ++t) {
      marker(o, 0xDB, 67);
      o.push_back(uint8_t(t));
      for (int i = 0; i < 64; ++i) o.push_back(qs[t][kNatural[i]]);
    }
    marker(o, 0xC0, 17);
    const uint8_t sof[] = {8, uint8_t(H >> 8), uint8_t(H), uint8_t(W >> 8),
                           uint8_t(W), 3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11,
                           1};
    o.insert(o.end(), sof, sof + sizeof sof);
    dht(o, kDcLuma, 0x00);
    dht(o, kAcLuma, 0x10);
    dht(o, kDcChroma, 0x01);
    dht(o, kAcChroma, 0x11);
    marker(o, 0xDA, 12);
    const uint8_t sos[] = {3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0};
    o.insert(o.end(), sos, sos + sizeof sos);
  }

  void encode(const uint8_t* rgb, std::vector<uint8_t>& o) const {
    const Tables& t = tables();
    const int lbw = (W + 7) / 8, lbh = (H + 7) / 8;     // luma blocks
    const int cbw = (W + 15) / 16, cbh = (H + 15) / 16;  // chroma = MCUs
    const int lw = lbw * 8, lh = lbh * 8;
    const int cw = cbw * 8, ch = cbh * 8;
    // the colour-converted image, edges repeated (expand_right_edge;
    // the prep controller repeats the last row to an even count)
    const int fw = cw * 2, fh = H + (H & 1);
    std::vector<uint8_t> Y(size_t(lw) * lh), Cb(size_t(fw) * fh),
        Cr(size_t(fw) * fh);
    for (int y = 0; y < fh; ++y) {
      const uint8_t* row = rgb + size_t(std::min(y, H - 1)) * W * 3;
      for (int x = 0; x < fw; ++x) {
        const uint8_t* px = row + size_t(std::min(x, W - 1)) * 3;
        int r = px[0], g = px[1], b = px[2];
        size_t i = size_t(y) * fw + x;
        Cb[i] = uint8_t((t.cb_r[r] + t.cb_g_e[g] + t.cbcr_b[b]) >> 16);
        Cr[i] = uint8_t((t.cbcr_b[r] + t.cr_g_e[g] + t.cr_b[b]) >> 16);
        if (x < lw && y < lh)
          Y[size_t(y) * lw + x] =
              uint8_t((t.y_r[r] + t.y_g[g] + t.y_b[b]) >> 16);
      }
    }
    for (int y = fh; y < lh; ++y)  // luma rows past the image
      std::memcpy(&Y[size_t(y) * lw], &Y[size_t(H - 1) * lw], size_t(lw));
    // h2v2_downsample, then the last real row repeated to whole blocks
    std::vector<uint8_t> dcb(size_t(cw) * ch), dcr(size_t(cw) * ch);
    const int crows = fh / 2;
    for (int pl = 0; pl < 2; ++pl) {
      const std::vector<uint8_t>& src = pl ? Cr : Cb;
      std::vector<uint8_t>& dst = pl ? dcr : dcb;
      for (int y = 0; y < crows; ++y) {
        const uint8_t* r0 = &src[size_t(2 * y) * fw];
        const uint8_t* r1 = r0 + fw;
        int bias = 1;
        for (int x = 0; x < cw; ++x) {
          dst[size_t(y) * cw + x] = uint8_t(
              (r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias)
              >> 2);
          bias ^= 3;
        }
      }
      for (int y = crows; y < ch; ++y)
        std::memcpy(&dst[size_t(y) * cw], &dst[size_t(crows - 1) * cw],
                    size_t(cw));
    }

    headers(o);
    BitWriter bw(o);
    int last[3] = {0, 0, 0};
    int16_t blk[6][64];
    for (int my = 0; my < cbh; ++my) {
      for (int mx = 0; mx < cbw; ++mx) {
        // luma: up to 2x2 real blocks; the rest dummy blocks (AC 0, the
        // DC of the block before it), as jccoefct.c's compress_data
        const int cols = mx < cbw - 1 ? 2 : (lbw % 2 ? lbw % 2 : 2);
        const int rows = my < cbh - 1 ? 2 : (lbh % 2 ? lbh % 2 : 2);
        for (int yy = 0; yy < 2; ++yy) {
          int16_t* row = blk[2 * yy];
          if (yy < rows) {
            for (int xx = 0; xx < cols; ++xx)
              block(Y.data(), lw, (2 * mx + xx) * 8, (2 * my + yy) * 8, dlum,
                    row + 64 * xx);
            for (int xx = cols; xx < 2; ++xx) {
              std::memset(row + 64 * xx, 0, 64 * sizeof(int16_t));
              row[64 * xx] = row[64 * (xx - 1)];
            }
          } else {
            const int16_t dc = blk[2 * yy - 1][0];
            for (int xx = 0; xx < 2; ++xx) {
              std::memset(row + 64 * xx, 0, 64 * sizeof(int16_t));
              row[64 * xx] = dc;
            }
          }
        }
        block(dcb.data(), cw, mx * 8, my * 8, dchr, blk[4]);
        block(dcr.data(), cw, mx * 8, my * 8, dchr, blk[5]);
        for (int b = 0; b < 4; ++b) code_block(bw, blk[b], last[0], dc0, ac0);
        code_block(bw, blk[4], last[1], dc1, ac1);
        code_block(bw, blk[5], last[2], dc1, ac1);
      }
    }
    bw.flush();
    o.push_back(0xFF);
    o.push_back(0xD9);
  }
};

}  // namespace jpeg

extern "C" {

static int decode(const uint8_t* buf, long len, uint8_t* out, int w, int h,
                  bool pil) {
  if (!buf || len < 0 || !out) return jpeg::E_ARGS;
  try {
    jpeg::Decoder d(buf, size_t(len), w, h, pil);
    d.parse();
    d.render(out);
    return jpeg::OK;
  } catch (const jpeg::Fail& f) {
    return f.code;
  } catch (const std::bad_alloc&) {
    return jpeg::E_TOO_LARGE;
  }
}

// RGB8 [h, w, 3] into out; 0, or a negative code (see the enum above).
// The frame's size must be (w, h).  What the JAX binding's libjpeg-turbo
// 2.1 reads: 4-component and lossless streams are refused.
int teio_jpeg_decode(const uint8_t* buf, long len, uint8_t* out, int w,
                     int h) {
  return decode(buf, len, out, w, h, false);
}

// As teio_jpeg_decode, and what PIL (libjpeg-turbo 3.1) reads besides:
// 4-component (CMYK / YCCK) and 8-bit lossless streams, decoded to the
// RGB that PIL's convert("RGB") gives them.
int teio_jpeg_decode_pil(const uint8_t* buf, long len, uint8_t* out, int w,
                         int h) {
  return decode(buf, len, out, w, h, true);
}

// RGB8 [h, w, 3] -> JPEG in out (capacity cap); bytes written, -needed
// if cap is too small, or E_ARGS
long teio_jpeg_encode(const uint8_t* rgb, int w, int h, int quality,
                      uint8_t* out, long cap) {
  if (!rgb || w < 1 || h < 1 || w > 65500 || h > 65500 || cap < 0)
    return jpeg::E_ARGS;
  try {
    std::vector<uint8_t> o;
    o.reserve(size_t(w) * h / 4 + 1024);
    jpeg::Encoder(w, h, quality).encode(rgb, o);
    long n = long(o.size());
    if (n > cap) return -n;
    std::memcpy(out, o.data(), size_t(n));
    return n;
  } catch (const std::bad_alloc&) {
    return jpeg::E_ARGS;
  }
}

}  // extern "C"
