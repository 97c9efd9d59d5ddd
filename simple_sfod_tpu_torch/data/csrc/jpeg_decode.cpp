// Baseline JPEG decoder of the PyTorch port: plain C++17, no libjpeg.
//
// It gives the pixels that libjpeg-turbo gives with PIL's default settings
// (ISLOW IDCT, fancy upsampling, RGB out) bit for bit, by following
// libjpeg-turbo's integer code rather than the standard's real arithmetic:
//
//   entropy   jdhuff.c: canonical tables (jpeg_make_d_derived_tbl and its
//             checks), HUFF_EXTEND, DC predictors summed in unsigned int and
//             stored as 16-bit coefficients; a restart drops the bit buffer
//             and resets the predictors; the standard tables (jstdhuff.c)
//             stand in for DC/AC tables 0 and 1 that a file never defines
//   IDCT      jidctint.c:jpeg_idct_islow (CONST_BITS 13, PASS1_BITS 2,
//             DESCALE rounding, the zero-column and zero-row shortcuts) and
//             its output through the 1024-entry range-limit table
//             (jdmaster.c:prepare_range_limit_table), so overflowing values
//             wrap as libjpeg's do
//   upsample  jdsample.c (libjpeg-turbo, not IJG >= 7): h2v1 and h2v2
//             "fancy" triangle filters where the downsampled width is > 2,
//             h1v2 fancy, plain replication otherwise; context rows
//             replicated at the image's top and bottom (jdmainct.c)
//   colour    jdcolor.c: build_ycc_rgb_table (SCALEBITS 16), RGB copied,
//             grey replicated; the colour space guessed as
//             jdapimin.c:default_decompress_parms guesses it
//
// What it decodes: SOF0/SOF1 (8-bit Huffman sequential, 8- and 16-bit
// quantisation tables), 1 or 3 components with integral sampling factors,
// interleaved and non-interleaved scans, restart intervals. Everything else
// is refused with its own code (kProgressive, ...), and so is every file on
// which libjpeg would warn: data that ends early, bytes before a marker, a
// missing or misnumbered restart marker, a Huffman code that is not in its
// table, a sequential scan with progressive parameters. Where libjpeg only
// warns and pads (a truncated file), this decoder refuses.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

namespace {

enum Code : int {
  kOk = 0,
  kNotJpeg = -1,
  kCorrupt = -2,
  kTruncated = -3,
  kNoMemory = -4,
  kProgressive = -5,
  kLossless = -6,
  kHierarchical = -7,
  kArithmetic = -8,
  kPrecision = -9,
  kComponents = -10,
  kFractionalSampling = -11,
  kBadSampling = -12,
};

struct Refusal {
  int code;
};

[[noreturn]] void refuse(int code) { throw Refusal{code}; }

// jutils.c:jpeg_natural_order, with 16 extra entries so that a run past
// coefficient 63 in corrupt data lands on 63, as libjpeg's does
const int kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ---------------------------------------------------------------------------
// Huffman tables
// ---------------------------------------------------------------------------

constexpr int kLookBits = 9;

struct HuffSpec {
  bool defined = false;
  uint8_t bits[17] = {};  // bits[l]: codes of length l
  uint8_t vals[256] = {};
};

// jstdhuff.c: the tables of the JPEG standard's section K.3
const uint8_t kStdDcBits[2][17] = {{0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
                                   {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
const uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdAcBits[2][17] = {{0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
                                   {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
const uint8_t kStdAcVals[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71,
     0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
     0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37,
     0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
     0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
     0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
     0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
     0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
     0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22,
     0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
     0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36,
     0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
     0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
     0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
     0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
     0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
     0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

HuffSpec std_table(bool ac, int slot) {
  HuffSpec s;
  s.defined = true;
  const uint8_t* bits = ac ? kStdAcBits[slot] : kStdDcBits[slot];
  const uint8_t* vals = ac ? kStdAcVals[slot] : kStdDcVals;
  int n = 0;
  for (int l = 1; l <= 16; l++) n += (s.bits[l] = bits[l]);
  memcpy(s.vals, vals, n);
  return s;
}

// jdhuff.c:jpeg_make_d_derived_tbl, with a kLookBits-bit lookahead table
struct Huffman {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint16_t look[1 << kLookBits];  // (length << 8) | symbol, 0: longer code

  void derive(const HuffSpec& s, bool dc) {
    uint8_t size[257];
    uint32_t code[257];
    int p = 0;
    for (int l = 1; l <= 16; l++) {
      int i = s.bits[l];
      if (p + i > 256) refuse(kCorrupt);
      while (i--) size[p++] = static_cast<uint8_t>(l);
    }
    size[p] = 0;
    const int nsym = p;
    uint32_t c = 0;
    int si = size[0];
    p = 0;
    while (size[p]) {
      while (size[p] == si) code[p++] = c++;
      if (c >= (1u << si)) refuse(kCorrupt);
      c <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (s.bits[l]) {
        valoffset[l] = p - static_cast<int32_t>(code[p]);
        p += s.bits[l];
        maxcode[l] = static_cast<int32_t>(code[p - 1]);
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0xFFFFF;
    memcpy(vals, s.vals, 256);
    memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= kLookBits; l++) {
      for (int i = 1; i <= s.bits[l]; i++, p++) {
        const uint32_t first = code[p] << (kLookBits - l);
        for (uint32_t k = 0; k < (1u << (kLookBits - l)); k++)
          look[first + k] = static_cast<uint16_t>((l << 8) | s.vals[p]);
      }
    }
    if (dc) {
      for (int i = 0; i < nsym; i++)
        if (s.vals[i] > 15) refuse(kCorrupt);
    }
  }
};

// ---------------------------------------------------------------------------
// Entropy-coded segment reader (jdhuff.c: jpeg_fill_bit_buffer)
// ---------------------------------------------------------------------------

struct BitReader {
  const uint8_t* data;
  size_t n;
  size_t pos;          // next byte of the segment
  uint64_t buf = 0;    // left-aligned
  int bits = 0;        // bits in buf
  int real = 0;        // of which came from the data (the rest: zero fill)
  bool at_marker = false;  // pos is at the 0xFF of a marker (or the end)

  BitReader(const uint8_t* d, size_t len, size_t p) : data(d), n(len), pos(p) {}

  void fill() {
    while (bits <= 56) {
      uint32_t b = 0;
      if (!at_marker) {
        if (pos >= n) {
          at_marker = true;
        } else if (data[pos] != 0xFF) {
          b = data[pos++];
          real += 8;
        } else {
          size_t q = pos + 1;
          while (q < n && data[q] == 0xFF) q++;  // fill bytes
          if (q < n && data[q] == 0x00) {
            b = 0xFF;
            pos = q + 1;
            real += 8;
          } else {
            at_marker = true;  // a marker (or the end): zeros from here
            pos = q - 1;
          }
        }
      }
      buf |= static_cast<uint64_t>(b) << (56 - bits);
      bits += 8;
    }
  }
  uint32_t peek(int k) {
    if (bits < k) fill();
    return static_cast<uint32_t>(buf >> (64 - k));
  }
  void skip(int k) {
    // consuming zero fill means the data ran out: libjpeg's JWRN_HIT_MARKER
    if (k > real) refuse(kTruncated);
    buf <<= k;
    bits -= k;
    real -= k;
  }
  uint32_t get(int k) {
    const uint32_t v = peek(k);
    skip(k);
    return v;
  }
  int decode(const Huffman& h) {
    const uint32_t look = peek(16);
    const uint16_t e = h.look[look >> (16 - kLookBits)];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    int l = kLookBits + 1;
    for (; l <= 16; l++)
      if (static_cast<int32_t>(look >> (16 - l)) <= h.maxcode[l]) break;
    if (l > 16) refuse(kCorrupt);  // JWRN_HUFF_BAD_CODE
    skip(l);
    return h.vals[(static_cast<int32_t>(look >> (16 - l)) + h.valoffset[l]) & 0xFF];
  }
  int receive_extend(int s) {
    if (s == 0) return 0;
    const int v = static_cast<int>(get(s));
    return v < (1 << (s - 1)) ? v + static_cast<int>(~0u << s) + 1 : v;
  }
};

// ---------------------------------------------------------------------------
// IDCT (jidctint.c:jpeg_idct_islow) and the range-limit table
// ---------------------------------------------------------------------------

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t lshift(int64_t a, int b) { return static_cast<int64_t>(static_cast<uint64_t>(a) << b); }
inline int64_t descale(int64_t x, int n) { return (x + (int64_t{1} << (n - 1))) >> n; }

struct RangeLimit {
  uint8_t idct[1024];  // IDCT_range_limit, indexed by (value & RANGE_MASK)
  uint8_t sample[1024];  // sample_range_limit, indexed by value + 384

  RangeLimit() {
    for (int x = 0; x < 1024; x++) {
      idct[x] = x < 128 ? x + 128 : x < 512 ? 255 : x < 896 ? 0 : x - 896;
      const int v = x - 384;
      sample[x] = v < 0 ? 0 : v > 255 ? 255 : v;
    }
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, size_t stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* ip = in + c;
    const int16_t* qp = q + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      const int dc = static_cast<int>(lshift(static_cast<int64_t>(ip[0]) * qp[0], kPass1Bits));
      for (int r = 0; r < 8; r++) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = static_cast<int64_t>(ip[16]) * qp[16];
    int64_t z3 = static_cast<int64_t>(ip[48]) * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = static_cast<int64_t>(ip[0]) * qp[0];
    z3 = static_cast<int64_t>(ip[32]) * qp[32];
    int64_t tmp0 = lshift(z2 + z3, kConstBits);
    int64_t tmp1 = lshift(z2 - z3, kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = static_cast<int64_t>(ip[56]) * qp[56];
    tmp1 = static_cast<int64_t>(ip[40]) * qp[40];
    tmp2 = static_cast<int64_t>(ip[24]) * qp[24];
    tmp3 = static_cast<int64_t>(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConstBits - kPass1Bits;
    wp[0] = static_cast<int>(descale(tmp10 + tmp3, s));
    wp[56] = static_cast<int>(descale(tmp10 - tmp3, s));
    wp[8] = static_cast<int>(descale(tmp11 + tmp2, s));
    wp[48] = static_cast<int>(descale(tmp11 - tmp2, s));
    wp[16] = static_cast<int>(descale(tmp12 + tmp1, s));
    wp[40] = static_cast<int>(descale(tmp12 - tmp1, s));
    wp[24] = static_cast<int>(descale(tmp13 + tmp0, s));
    wp[32] = static_cast<int>(descale(tmp13 - tmp0, s));
  }
  const uint8_t* rl = kRange.idct;
  for (int r = 0; r < 8; r++) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 && wp[6] == 0 && wp[7] == 0) {
      const uint8_t v = rl[static_cast<int>(descale(wp[0], kPass1Bits + 3)) & 0x3FF];
      memset(op, v, 8);
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = lshift(static_cast<int64_t>(wp[0]) + wp[4], kConstBits);
    int64_t tmp1 = lshift(static_cast<int64_t>(wp[0]) - wp[4], kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConstBits + kPass1Bits + 3;
    op[0] = rl[static_cast<int>(descale(tmp10 + tmp3, s)) & 0x3FF];
    op[7] = rl[static_cast<int>(descale(tmp10 - tmp3, s)) & 0x3FF];
    op[1] = rl[static_cast<int>(descale(tmp11 + tmp2, s)) & 0x3FF];
    op[6] = rl[static_cast<int>(descale(tmp11 - tmp2, s)) & 0x3FF];
    op[2] = rl[static_cast<int>(descale(tmp12 + tmp1, s)) & 0x3FF];
    op[5] = rl[static_cast<int>(descale(tmp12 - tmp1, s)) & 0x3FF];
    op[3] = rl[static_cast<int>(descale(tmp13 + tmp0, s)) & 0x3FF];
    op[4] = rl[static_cast<int>(descale(tmp13 - tmp0, s)) & 0x3FF];
  }
}

// ---------------------------------------------------------------------------
// Upsampling (jdsample.c), one output row of one component at a time
// ---------------------------------------------------------------------------

void h2v1_fancy(const uint8_t* in, int dw, uint8_t* out) {
  int v = in[0];
  out[0] = static_cast<uint8_t>(v);
  out[1] = static_cast<uint8_t>((v * 3 + in[1] + 2) >> 2);
  for (int i = 1; i < dw - 1; i++) {
    v = in[i] * 3;
    out[2 * i] = static_cast<uint8_t>((v + in[i - 1] + 1) >> 2);
    out[2 * i + 1] = static_cast<uint8_t>((v + in[i + 1] + 2) >> 2);
  }
  v = in[dw - 1];
  out[2 * dw - 2] = static_cast<uint8_t>((v * 3 + in[dw - 2] + 1) >> 2);
  out[2 * dw - 1] = static_cast<uint8_t>(v);
}

// near: the component row nearest the output row, far: the next nearest
void h2v2_fancy(const uint8_t* near, const uint8_t* far, int dw, uint8_t* out) {
  int this_sum = near[0] * 3 + far[0];
  int next_sum = near[1] * 3 + far[1];
  out[0] = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
  out[1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
  int last_sum = this_sum;
  this_sum = next_sum;
  for (int i = 1; i < dw - 1; i++) {
    next_sum = near[i + 1] * 3 + far[i + 1];
    out[2 * i] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
    out[2 * i + 1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
    last_sum = this_sum;
    this_sum = next_sum;
  }
  out[2 * dw - 2] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
  out[2 * dw - 1] = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
}

void h1v2_fancy(const uint8_t* near, const uint8_t* far, int dw, int bias, uint8_t* out) {
  for (int i = 0; i < dw; i++) out[i] = static_cast<uint8_t>((near[i] * 3 + far[i] + bias) >> 2);
}

void replicate(const uint8_t* in, int hr, int width, uint8_t* out) {
  for (int x = 0; x < width; x++) out[x] = in[x / hr];
}

// ---------------------------------------------------------------------------
// The decoder
// ---------------------------------------------------------------------------

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int wib = 0, hib = 0;  // width/height in blocks
  int bw = 0, bh = 0;    // blocks allocated (rounded up to h, v)
  int dw = 0, dh = 0;    // downsampled width/height
  bool latched = false;
  int16_t qt[64] = {};   // the latched table, natural order, as ISLOW_MULT_TYPE;
                         // zeros for a component no scan reaches (libjpeg's too)
  std::vector<int16_t> coef;
  std::vector<uint8_t> plane;
};

struct Decoder {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;
  uint16_t qtables[4][64];
  bool qdefined[4] = {false, false, false, false};
  HuffSpec dc[4], ac[4];
  int restart_interval = 0;
  bool saw_sof = false, saw_jfif = false, saw_adobe = false, first_scan = true, multi_scan = false;
  int adobe_transform = 0;
  bool rgb = false;  // the colour space: RGB (else YCbCr or grey)
  int W = 0, H = 0, hmax = 1, vmax = 1;
  std::vector<Component> comps;

  Decoder(const uint8_t* data, size_t len) : d(data), n(len) {}

  uint8_t byte() {
    if (pos >= n) refuse(kTruncated);
    return d[pos++];
  }
  int u16() {
    const int hi = byte();
    return (hi << 8) | byte();
  }

  // jdmarker.c:next_marker, refusing where it would warn (skipped data)
  int next_marker() {
    if (byte() != 0xFF) refuse(kCorrupt);
    int c;
    do c = byte();
    while (c == 0xFF);
    if (c == 0) refuse(kCorrupt);
    return c;
  }

  // a segment's payload: [pos, pos + len), pos moved past it
  size_t segment(int* len) {
    const int length = u16();
    if (length < 2) refuse(kCorrupt);
    if (pos + length - 2 > n) refuse(kTruncated);
    const size_t start = pos;
    pos += length - 2;
    *len = length - 2;
    return start;
  }

  void read_dqt() {
    int len;
    size_t p = segment(&len);
    const size_t end = p + len;
    while (p < end) {
      const int pq = d[p] >> 4, tq = d[p] & 15;
      p++;
      if (tq >= 4 || pq > 1) refuse(kCorrupt);
      if (end - p < static_cast<size_t>(64 * (pq + 1))) refuse(kCorrupt);
      for (int i = 0; i < 64; i++) {
        const int v = pq ? (d[p] << 8) | d[p + 1] : d[p];
        p += pq + 1;
        qtables[tq][kNaturalOrder[i]] = static_cast<uint16_t>(v);
      }
      qdefined[tq] = true;
    }
  }

  void read_dht() {
    int len;
    size_t p = segment(&len);
    while (len > 16) {
      const int index = d[p];
      HuffSpec s;
      s.defined = true;
      int count = 0;
      for (int l = 1; l <= 16; l++) count += (s.bits[l] = d[p + l]);
      p += 17;
      len -= 17;
      if (count > 256 || count > len) refuse(kCorrupt);
      memcpy(s.vals, d + p, count);
      p += count;
      len -= count;
      const int tc = index >> 4, th = index & 15;
      if (tc > 1 || th >= 4) refuse(kCorrupt);
      (tc ? ac : dc)[th] = s;
    }
    if (len != 0) refuse(kCorrupt);
  }

  void read_app(int marker) {
    int len;
    const size_t p = segment(&len);
    const uint8_t* b = d + p;
    if (marker == 0xE0 && len >= 14 && !memcmp(b, "JFIF\0", 5)) saw_jfif = true;
    if (marker == 0xEE && len >= 12 && !memcmp(b, "Adobe", 5)) {
      saw_adobe = true;
      adobe_transform = b[11];
    }
  }

  void read_sof(int marker) {
    switch (marker) {
      case 0xC0: case 0xC1: break;
      case 0xC2: refuse(kProgressive);
      case 0xC3: refuse(kLossless);
      case 0xC5: case 0xC6: case 0xC7: refuse(kHierarchical);
      default: refuse(kArithmetic);  // SOF9-SOF15
    }
    if (saw_sof) refuse(kCorrupt);
    saw_sof = true;
    int len;
    size_t p = segment(&len);
    if (len < 6) refuse(kCorrupt);
    const int precision = d[p];
    H = (d[p + 1] << 8) | d[p + 2];
    W = (d[p + 3] << 8) | d[p + 4];
    const int nc = d[p + 5];
    p += 6;
    if (H == 0 || W == 0 || nc == 0 || len != 6 + 3 * nc) refuse(kCorrupt);
    if (precision != 8) refuse(kPrecision);
    if (nc != 1 && nc != 3) refuse(kComponents);
    if (W > 65500 || H > 65500) refuse(kCorrupt);
    comps.resize(nc);
    for (auto& c : comps) {
      c.id = d[p];
      c.h = d[p + 1] >> 4;
      c.v = d[p + 1] & 15;
      c.tq = d[p + 2];
      p += 3;
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) refuse(kBadSampling);
      hmax = c.h > hmax ? c.h : hmax;
      vmax = c.v > vmax ? c.v : vmax;
    }
    // jdsample.c:jinit_upsampler refuses what is not an integral ratio
    for (const auto& c : comps)
      if (hmax % c.h || vmax % c.v) refuse(kFractionalSampling);
    for (auto& c : comps) {
      c.wib = static_cast<int>((static_cast<int64_t>(W) * c.h + 8 * hmax - 1) / (8 * hmax));
      c.hib = static_cast<int>((static_cast<int64_t>(H) * c.v + 8 * vmax - 1) / (8 * vmax));
      c.dw = static_cast<int>((static_cast<int64_t>(W) * c.h + hmax - 1) / hmax);
      c.dh = static_cast<int>((static_cast<int64_t>(H) * c.v + vmax - 1) / vmax);
      c.bw = (c.wib + c.h - 1) / c.h * c.h;
      c.bh = (c.hib + c.v - 1) / c.v * c.v;
    }
  }

  // jdapimin.c:default_decompress_parms
  void guess_colour_space() {
    if (comps.size() != 3 || saw_jfif) return;
    if (saw_adobe) {
      rgb = adobe_transform == 0;
    } else {
      rgb = comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B';
    }
  }

  void read_sos() {
    if (!saw_sof) refuse(kCorrupt);
    int len;
    size_t p = segment(&len);
    if (len < 1) refuse(kCorrupt);
    const int ns = d[p++];
    if (len != 4 + 2 * ns || ns < 1 || ns > 4) refuse(kCorrupt);
    std::vector<Component*> scan;
    for (int i = 0; i < ns; i++) {
      const int id = d[p], tables = d[p + 1];
      p += 2;
      Component* found = nullptr;
      for (auto& c : comps)
        if (c.id == id) found = &c;
      if (!found) refuse(kCorrupt);
      for (auto* c : scan)
        if (c == found) refuse(kCorrupt);
      found->td = tables >> 4;
      found->ta = tables & 15;
      scan.push_back(found);
    }
    const int ss = d[p], se = d[p + 1], ahal = d[p + 2];
    if (ss != 0 || se != 63 || ahal != 0) refuse(kCorrupt);  // JWRN_NOT_SEQUENTIAL
    if (first_scan) {
      first_scan = false;
      multi_scan = scan.size() < comps.size();
      guess_colour_space();
      for (auto& c : comps) {
        c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
      }
    } else if (!multi_scan) {
      refuse(kCorrupt);  // JERR_EOI_EXPECTED
    }
    int blocks = 0;
    for (auto* c : scan) {
      if (!c->latched) {  // jdinput.c:latch_quant_tables
        if (c->tq >= 4 || !qdefined[c->tq]) refuse(kCorrupt);
        for (int i = 0; i < 64; i++) c->qt[i] = static_cast<int16_t>(qtables[c->tq][i]);
        c->latched = true;
      }
      blocks += c->h * c->v;
    }
    if (scan.size() > 1 && blocks > 10) refuse(kBadSampling);  // JERR_BAD_MCU_SIZE
    decode_scan(scan);
  }

  const HuffSpec& table(HuffSpec* specs, int slot, bool is_ac) {
    if (slot >= 4) refuse(kCorrupt);
    if (!specs[slot].defined) {
      if (slot >= 2) refuse(kCorrupt);
      specs[slot] = std_table(is_ac, slot);
    }
    return specs[slot];
  }

  void decode_scan(const std::vector<Component*>& scan) {
    const int ns = static_cast<int>(scan.size());
    std::vector<Huffman> hdc(ns), hac(ns);
    for (int i = 0; i < ns; i++) {
      hdc[i].derive(table(dc, scan[i]->td, false), true);
      hac[i].derive(table(ac, scan[i]->ta, true), false);
    }
    int mcus_x, mcus_y;
    if (ns == 1) {
      mcus_x = scan[0]->wib;
      mcus_y = scan[0]->hib;
    } else {
      mcus_x = (W + 8 * hmax - 1) / (8 * hmax);
      mcus_y = (H + 8 * vmax - 1) / (8 * vmax);
    }
    BitReader br(d, n, pos);
    int pred[4] = {0, 0, 0, 0};
    int to_go = restart_interval, next_rst = 0;
    const int64_t total = static_cast<int64_t>(mcus_x) * mcus_y;
    for (int64_t m = 0; m < total; m++) {
      if (restart_interval) {
        if (to_go == 0) {
          restart(&br, next_rst);
          next_rst = (next_rst + 1) & 7;
          for (int& p : pred) p = 0;
          to_go = restart_interval;
        }
        to_go--;
      }
      const int my = static_cast<int>(m / mcus_x), mx = static_cast<int>(m % mcus_x);
      for (int i = 0; i < ns; i++) {
        Component* c = scan[i];
        const int bh = ns == 1 ? 1 : c->v, bwid = ns == 1 ? 1 : c->h;
        for (int y = 0; y < bh; y++) {
          for (int x = 0; x < bwid; x++) {
            const size_t by = static_cast<size_t>(my) * bh + y, bx = static_cast<size_t>(mx) * bwid + x;
            decode_block(&br, hdc[i], hac[i], &pred[i], &c->coef[(by * c->bw + bx) * 64]);
          }
        }
      }
    }
    // whole bytes left unread before the marker: libjpeg's extraneous data
    if (br.real >= 8) refuse(kCorrupt);
    pos = br.pos;
  }

  static void decode_block(BitReader* br, const Huffman& hd, const Huffman& ha, int* pred, int16_t* blk) {
    const int s = br->decode(hd);
    const int diff = br->receive_extend(s);
    *pred = static_cast<int>(static_cast<unsigned>(diff) + static_cast<unsigned>(*pred));
    blk[0] = static_cast<int16_t>(*pred);
    for (int k = 1; k < 64; k++) {
      const int rs = br->decode(ha);
      const int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        blk[kNaturalOrder[k]] = static_cast<int16_t>(br->receive_extend(sz));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // jdhuff.c:process_restart + jdmarker.c:read_restart_marker
  void restart(BitReader* br, int expect) {
    if (br->real >= 8) refuse(kCorrupt);  // whole bytes discarded
    size_t p = br->pos;
    if (p >= n) refuse(kTruncated);
    if (d[p] != 0xFF) refuse(kCorrupt);
    while (p < n && d[p] == 0xFF) p++;
    if (p >= n) refuse(kTruncated);
    if (d[p] != 0xD0 + expect) refuse(kCorrupt);  // JWRN_MUST_RESYNC
    *br = BitReader(d, n, p + 1);
  }

  void run() {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) refuse(kNotJpeg);
    pos = 2;
    for (;;) {
      const int m = next_marker();
      if (m == 0xD9) break;  // EOI
      switch (m) {
        case 0xC4: read_dht(); break;
        case 0xDB: read_dqt(); break;
        case 0xDA: read_sos(); break;
        case 0xDD: {
          int len;
          const size_t p = segment(&len);
          if (len != 2) refuse(kCorrupt);
          restart_interval = (d[p] << 8) | d[p + 1];
          break;
        }
        case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC5: case 0xC6: case 0xC7:
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
          read_sof(m);
          break;
        case 0xDE: case 0xDF: refuse(kHierarchical);  // DHP, EXP
        case 0xCC: case 0xDC: case 0xFE: {  // DAC, DNL, COM: skipped
          int len;
          segment(&len);
          break;
        }
        case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4: case 0xD5: case 0xD6: case 0xD7: case 0x01:
          break;  // parameterless
        default:
          if (m >= 0xE0 && m <= 0xEF) {
            read_app(m);
            break;
          }
          refuse(kCorrupt);  // SOI again, JPG, reserved
      }
    }
    if (first_scan) refuse(kCorrupt);  // no image: JERR_NO_IMAGE
  }

  void output(uint8_t* rgb_out) {
    for (auto& c : comps) {
      const size_t stride = static_cast<size_t>(c.bw) * 8;
      c.plane.resize(stride * c.bh * 8);
      for (int by = 0; by < c.hib; by++)
        for (int bx = 0; bx < c.wib; bx++)
          idct_islow(&c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64], c.qt,
                     &c.plane[static_cast<size_t>(by) * 8 * stride + bx * 8], stride);
      std::vector<int16_t>().swap(c.coef);
    }
    const int nc = static_cast<int>(comps.size());
    std::vector<std::vector<uint8_t>> rows(nc);
    for (int i = 0; i < nc; i++) rows[i].resize(static_cast<size_t>(comps[i].bw) * 8 * hmax + 16);
    const uint8_t* row[3] = {nullptr, nullptr, nullptr};
    for (int y = 0; y < H; y++) {
      for (int i = 0; i < nc; i++) row[i] = upsample_row(comps[i], y, rows[i].data());
      uint8_t* o = rgb_out + static_cast<size_t>(y) * W * 3;
      if (nc == 1) {
        for (int x = 0; x < W; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = row[0][x];
      } else if (rgb) {
        for (int x = 0; x < W; x++) {
          o[3 * x] = row[0][x];
          o[3 * x + 1] = row[1][x];
          o[3 * x + 2] = row[2][x];
        }
      } else {
        ycc_rgb_row(row[0], row[1], row[2], W, o);
      }
    }
  }

  // output row y of component c: a row of its plane or `tmp`
  const uint8_t* upsample_row(const Component& c, int y, uint8_t* tmp) const {
    const size_t stride = static_cast<size_t>(c.bw) * 8;
    const uint8_t* plane = c.plane.data();
    const int hr = hmax / c.h, vr = vmax / c.v;
    if (hr == 1 && vr == 1) return plane + y * stride;
    const int r = y / vr;
    const uint8_t* near = plane + r * stride;
    if ((hr == 2 || hr == 1) && vr == 2 && !(hr == 2 && c.dw <= 2)) {
      const bool above = (y & 1) == 0;
      const int rf = above ? (r > 0 ? r - 1 : 0) : (r + 1 < c.dh ? r + 1 : c.dh - 1);
      const uint8_t* far = plane + rf * stride;
      if (hr == 2) {
        h2v2_fancy(near, far, c.dw, tmp);
      } else {
        h1v2_fancy(near, far, c.dw, above ? 1 : 2, tmp);
      }
      return tmp;
    }
    if (hr == 2 && vr == 1 && c.dw > 2) {
      h2v1_fancy(near, c.dw, tmp);
      return tmp;
    }
    replicate(near, hr, W, tmp);
    return tmp;
  }

  // jdcolor.c:ycc_rgb_convert with build_ycc_rgb_table's tables
  static void ycc_rgb_row(const uint8_t* yp, const uint8_t* cbp, const uint8_t* crp, int w, uint8_t* o) {
    struct Tables {
      int cr_r[256], cb_b[256];
      int64_t cr_g[256], cb_g[256];
      Tables() {
        constexpr int kScale = 16;
        constexpr int64_t kHalf = int64_t{1} << (kScale - 1);
        auto fix = [](double x) { return static_cast<int64_t>(x * (1L << kScale) + 0.5); };
        for (int i = 0, x = -128; i < 256; i++, x++) {
          cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kScale);
          cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kScale);
          cr_g[i] = -fix(0.71414) * x;
          cb_g[i] = -fix(0.34414) * x + kHalf;
        }
      }
    };
    static const Tables t;
    const uint8_t* rl = kRange.sample + 384;
    for (int x = 0; x < w; x++) {
      const int yy = yp[x], cb = cbp[x], cr = crp[x];
      o[3 * x] = rl[yy + t.cr_r[cr]];
      o[3 * x + 1] = rl[yy + static_cast<int>((t.cb_g[cb] + t.cr_g[cr]) >> 16)];
      o[3 * x + 2] = rl[yy + t.cb_b[cb]];
    }
  }
};

}  // namespace

extern "C" {

// Decode n bytes of a baseline JPEG file to tightly packed RGB8 [h, w, 3].
// On success *out is malloc'd (release with sfod_image_free) and 0 is
// returned; otherwise a negative code (see the Code enum above).
int sfod_jpeg_decode(const uint8_t* data, int64_t n, uint8_t** out, int32_t* h, int32_t* w) {
  *out = nullptr;
  try {
    Decoder dec(data, static_cast<size_t>(n));
    dec.run();
    uint8_t* buf = static_cast<uint8_t*>(malloc(static_cast<size_t>(dec.H) * dec.W * 3));
    if (!buf) return kNoMemory;
    dec.output(buf);
    *out = buf;
    *h = dec.H;
    *w = dec.W;
    return kOk;
  } catch (const Refusal& r) {
    return r.code;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}

}  // extern "C"
