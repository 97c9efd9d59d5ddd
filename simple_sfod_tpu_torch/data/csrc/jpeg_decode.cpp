// JPEG decoder of the PyTorch port: plain C++17, no libjpeg.
//
// It gives the pixels that libjpeg-turbo 3.1 gives with PIL's default
// settings (ISLOW IDCT, fancy upsampling, block smoothing, RGB out; CMYK out
// and Pillow's conversion for 4 components) bit for bit, by following
// libjpeg-turbo's integer code rather than the standard's real arithmetic:
//
//   Huffman   jdhuff.c: canonical tables (jpeg_make_d_derived_tbl and its
//             checks), HUFF_EXTEND, DC predictors summed in unsigned int and
//             stored as 16-bit coefficients; a restart drops the bit buffer
//             and resets the predictors; the standard tables (jstdhuff.c)
//             stand in for DC/AC tables 0 and 1 that a sequential file never
//             defines
//   arith     jdarith.c: the QM-coder (arith_decode over jaricom.c's Qe
//             table, the fixed 0.5 bin), decode_mcu and the progressive
//             decode_mcu_DC_first, _AC_first, _DC_refine and _AC_refine; the
//             DAC segment's conditioning (L, U, Kx); a restart resets the
//             statistics of the scan's tables, the DC predictions and the
//             coder; a marker inside the data feeds zeros, as the standard
//             allows
//   progress  jdphuff.c: decode_mcu_DC_first, _DC_refine, _AC_first and
//             _AC_refine with the EOB run (reset with the predictors at a
//             restart), the scan checks of start_pass_phuff_decoder and its
//             coef_bits progression; coefficients collect across scans in
//             the whole-image buffer and are transformed once, after EOI
//   smoothing jdcoefct.c:decompress_smooth_data and smoothing_ok of
//             libjpeg-turbo >= 2.1 (not IJG's 3x3 rule): a 5x5 neighbourhood
//             of DC values estimates AC01..AC30 (and, with no AC scan at all,
//             the DC itself) of a progressive file whose scans leave any of
//             them unrefined, from the ten latched coef_bits; rows are walked
//             as that code walks them, image_block_rows quirk included
//   lossless  jdlossls.c, jddiffct.c and jdlhuff.c of libjpeg-turbo 3
//             (SOF3): Huffman-coded sample differences (symbol 16 = 32768),
//             predictors 1-7 over the iMCU row after its MCU rows are read,
//             the first row of the scan and of each restart interval
//             predicted from 1 << (P - Pt - 1) and its left neighbour, the
//             point transform; no IDCT and no fancy upsampling
//             (jdsample.c's do_fancy needs a DCT block > 1)
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
//             grey replicated, YCCK to CMYK (ycck_cmyk_convert), CMYK kept;
//             the colour space guessed as jdapimin.c:default_decompress_parms
//             guesses it (RGB for a 3-component lossless file without JFIF
//             or Adobe marker). Pillow reads 4 components as inverted CMYK
//             ("CMYK;I", JpegImagePlugin.py) and its convert("RGB") is
//             Convert.c:cmyk2rgb
//
// What it decodes: SOF0/SOF1 (8-bit Huffman sequential, 8- and 16-bit
// quantisation tables), SOF2 (8-bit Huffman progressive), SOF9 and SOF10
// (8-bit arithmetic-coded sequential and progressive) and SOF3 (8-bit
// lossless, Huffman); 1, 3 or 4 components with integral sampling factors,
// interleaved and non-interleaved scans, restart intervals. Everything else
// is refused with its own code (kArithLossless for SOF11, kHierarchical for
// SOF5-7 and SOF13-15, kPrecision, ...), and so is every file on which
// libjpeg would warn (data that ends early, bytes before a marker, a
// missing or misnumbered restart marker, a Huffman code that is not in its
// table, an arithmetic code that overflows its magnitude or its band
// (JWRN_ARITH_BAD_CODE), a sequential scan with progressive parameters, a
// progression out of order (JWRN_BOGUS_PROGRESSION, kBadProgression)),
// a truncated file included, which libjpeg pads. The one warning decoded
// rather than refused is JWRN_ADOBE_XFORM, an Adobe transform code that
// libjpeg does not know: libjpeg warns and assumes YCbCr (3 components) or
// YCCK (4), and so does this decoder, which decodes the file as Pillow
// does. A lossless file whose colour space needs a
// conversion (YCbCr, YCCK) is refused as libjpeg-turbo refuses it
// (JERR_CONVERSION_NOTIMPL: it converts no colour lossily in lossless mode).

#include <algorithm>
#include <climits>
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
  kBadProgression = -5,
  kLosslessScan = -6,
  kHierarchical = -7,
  kArithLossless = -8,
  kPrecision = -9,
  kComponents = -10,
  kFractionalSampling = -11,
  kBadSampling = -12,
  kLosslessColour = -14,
  kTiffSampling = -15,
  kTiffTables = -16,
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

  // dc: symbols are magnitude categories, at most 15 (16 in lossless
  // mode, where 16 codes the difference 32768)
  void derive(const HuffSpec& s, bool dc, bool lossless = false) {
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
        if (s.vals[i] > (lossless ? 16 : 15)) refuse(kCorrupt);
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
// Arithmetic decoding (jdarith.c, jaricom.c)
// ---------------------------------------------------------------------------

// jaricom.c:jpeg_aritab, the JPEG standard's Table D.2: Qe, Next_Index_LPS,
// Next_Index_MPS, Switch_MPS; entry 113 is the fixed 0.5 estimate of T.851
struct QeEntry {
  uint16_t qe;
  uint8_t nlps, nmps, sw;
};
const QeEntry kQe[114] = {
    {0x5a1d, 1, 1, 1},     {0x2586, 14, 2, 0},    {0x1114, 16, 3, 0},    {0x080b, 18, 4, 0},
    {0x03d8, 20, 5, 0},    {0x01da, 23, 6, 0},    {0x00e5, 25, 7, 0},    {0x006f, 28, 8, 0},
    {0x0036, 30, 9, 0},    {0x001a, 33, 10, 0},   {0x000d, 35, 11, 0},   {0x0006, 9, 12, 0},
    {0x0003, 10, 13, 0},   {0x0001, 12, 13, 0},   {0x5a7f, 15, 15, 1},   {0x3f25, 36, 16, 0},
    {0x2cf2, 38, 17, 0},   {0x207c, 39, 18, 0},   {0x17b9, 40, 19, 0},   {0x1182, 42, 20, 0},
    {0x0cef, 43, 21, 0},   {0x09a1, 45, 22, 0},   {0x072f, 46, 23, 0},   {0x055c, 48, 24, 0},
    {0x0406, 49, 25, 0},   {0x0303, 51, 26, 0},   {0x0240, 52, 27, 0},   {0x01b1, 54, 28, 0},
    {0x0144, 56, 29, 0},   {0x00f5, 57, 30, 0},   {0x00b7, 59, 31, 0},   {0x008a, 60, 32, 0},
    {0x0068, 62, 33, 0},   {0x004e, 63, 34, 0},   {0x003b, 32, 35, 0},   {0x002c, 33, 9, 0},
    {0x5ae1, 37, 37, 1},   {0x484c, 64, 38, 0},   {0x3a0d, 65, 39, 0},   {0x2ef1, 67, 40, 0},
    {0x261f, 68, 41, 0},   {0x1f33, 69, 42, 0},   {0x19a8, 70, 43, 0},   {0x1518, 72, 44, 0},
    {0x1177, 73, 45, 0},   {0x0e74, 74, 46, 0},   {0x0bfb, 75, 47, 0},   {0x09f8, 77, 48, 0},
    {0x0861, 78, 49, 0},   {0x0706, 79, 50, 0},   {0x05cd, 48, 51, 0},   {0x04de, 50, 52, 0},
    {0x040f, 50, 53, 0},   {0x0363, 51, 54, 0},   {0x02d4, 52, 55, 0},   {0x025c, 53, 56, 0},
    {0x01f8, 54, 57, 0},   {0x01a4, 55, 58, 0},   {0x0160, 56, 59, 0},   {0x0125, 57, 60, 0},
    {0x00f6, 58, 61, 0},   {0x00cb, 59, 62, 0},   {0x00ab, 61, 63, 0},   {0x008f, 61, 32, 0},
    {0x5b12, 65, 65, 1},   {0x4d04, 80, 66, 0},   {0x412c, 81, 67, 0},   {0x37d8, 82, 68, 0},
    {0x2fe8, 83, 69, 0},   {0x293c, 84, 70, 0},   {0x2379, 86, 71, 0},   {0x1edf, 87, 72, 0},
    {0x1aa9, 87, 73, 0},   {0x174e, 72, 74, 0},   {0x1424, 72, 75, 0},   {0x119c, 74, 76, 0},
    {0x0f6b, 74, 77, 0},   {0x0d51, 75, 78, 0},   {0x0bb6, 77, 79, 0},   {0x0a40, 77, 48, 0},
    {0x5832, 80, 81, 1},   {0x4d1c, 88, 82, 0},   {0x438e, 89, 83, 0},   {0x3bdd, 90, 84, 0},
    {0x34ee, 91, 85, 0},   {0x2eae, 92, 86, 0},   {0x299a, 93, 87, 0},   {0x2516, 86, 71, 0},
    {0x5570, 88, 89, 1},   {0x4ca9, 95, 90, 0},   {0x44d9, 96, 91, 0},   {0x3e22, 97, 92, 0},
    {0x3824, 99, 93, 0},   {0x32b4, 99, 94, 0},   {0x2e17, 93, 86, 0},   {0x56a8, 95, 96, 1},
    {0x4f46, 101, 97, 0},  {0x47e5, 102, 98, 0},  {0x41cf, 103, 99, 0},  {0x3c3d, 104, 100, 0},
    {0x375e, 99, 93, 0},   {0x5231, 105, 102, 0}, {0x4c0f, 106, 103, 0}, {0x4639, 107, 104, 0},
    {0x415e, 103, 99, 0},  {0x5627, 105, 106, 1}, {0x50e7, 108, 107, 0}, {0x4b85, 109, 103, 0},
    {0x5597, 110, 109, 0}, {0x504f, 111, 107, 0}, {0x5a10, 110, 111, 1}, {0x5522, 112, 109, 0},
    {0x59eb, 112, 111, 1}, {0x5a1d, 113, 113, 0}};

constexpr int kDcStatBins = 64, kAcStatBins = 256, kArithTables = 16;

// jdarith.c: the C and A registers, the bit counter ct (-16: two bytes to
// read before the first decision) and get_byte's view of the segment
struct ArithReader {
  const uint8_t* data;
  size_t n;
  size_t pos;                // next byte of the segment
  int64_t c = 0, a = 0;
  int ct = -16;
  bool at_marker = false;    // pos is at the 0xFF of the marker that ended the data

  ArithReader(const uint8_t* d, size_t len, size_t p) : data(d), n(len), pos(p) {}

  // the next data byte; zeros once a marker is reached (cinfo->unread_marker)
  int next_byte() {
    if (at_marker) return 0;
    if (pos >= n) refuse(kTruncated);  // libjpeg: JWRN_JPEG_EOF
    const int b = data[pos++];
    if (b != 0xFF) return b;
    size_t q = pos;
    while (q < n && data[q] == 0xFF) q++;  // fill bytes
    if (q >= n) refuse(kTruncated);
    if (data[q] == 0x00) {
      pos = q + 1;
      return 0xFF;
    }
    at_marker = true;
    pos = q - 1;
    return 0;
  }

  // arith_decode: one binary decision with the adaptive estimate *st
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | next_byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;  // the two initial bytes read
      }
      a <<= 1;
    }
    int sv = *st;
    const QeEntry& e = kQe[sv & 0x7F];
    const int64_t qe = e.qe;
    const int nl = (e.sw << 7) | e.nlps, nm = e.nmps;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {  // conditional LPS exchange
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {  // conditional MPS exchange
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
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
  int wib = 0, hib = 0;  // width/height in blocks (in samples for lossless)
  int bw = 0, bh = 0;    // blocks allocated (rounded up to h, v)
  int dw = 0, dh = 0;    // downsampled width/height
  bool latched = false;  // its quantisation table latched (a DCT scan reached it)
  bool scanned = false;  // a scan reached it
  int16_t qt[64] = {};   // the latched table, natural order, as ISLOW_MULT_TYPE;
                         // zeros for a component no scan reaches (libjpeg's too)
  uint16_t qv[64] = {};  // the same, as JQUANT_TBL's unsigned quantval
  int coef_bits[64];     // progressive: Al of the last scan of each coefficient
                         // (zigzag order), -1 before its first (cinfo->coef_bits)
  std::vector<int16_t> coef;

  Component() { std::fill(coef_bits, coef_bits + 64, -1); }
  std::vector<uint8_t> plane;
  // jdinput.c: last_row_height, the rows of the last iMCU row
  int last_row_height() const { return hib % v ? hib % v : v; }
};

struct Decoder {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;
  uint16_t qtables[4][64];
  bool qdefined[4] = {false, false, false, false};
  HuffSpec dc[4], ac[4];
  // arithmetic conditioning (DAC), libjpeg's defaults L 0, U 1, Kx 5
  uint8_t dc_L[kArithTables], dc_U[kArithTables], ac_K[kArithTables];
  // arithmetic statistics and DC state (jdarith.c's entropy decoder)
  uint8_t dc_stats[kArithTables][kDcStatBins], ac_stats[kArithTables][kAcStatBins];
  uint8_t fixed_bin[4] = {113, 0, 0, 0};
  int last_dc[4] = {0, 0, 0, 0}, dc_context[4] = {0, 0, 0, 0};
  int restart_interval = 0;
  bool saw_sof = false, saw_jfif = false, saw_adobe = false, first_scan = true, multi_scan = false;
  bool progressive = false, arithmetic = false, lossless = false;
  int adobe_transform = 0;
  // kRaw: the components as stored (a TIFF's JCS_UNKNOWN)
  enum Colour { kGrey, kYCbCr, kRGB, kCMYK, kYCCK, kRaw } colour = kGrey;
  int forced_colour = -1;  // the colour space a TIFF sets over the markers' guess
  int W = 0, H = 0, hmax = 1, vmax = 1;
  std::vector<Component> comps;

  Decoder(const uint8_t* data, size_t len) : d(data), n(len) {
    std::fill(dc_L, dc_L + kArithTables, 0);
    std::fill(dc_U, dc_U + kArithTables, 1);
    std::fill(ac_K, ac_K + kArithTables, 5);
  }

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

  // jdmarker.c:get_dac
  void read_dac() {
    int len;
    size_t p = segment(&len);
    while (len > 0) {
      if (len < 2) refuse(kCorrupt);  // JERR_BAD_LENGTH
      const int index = d[p], val = d[p + 1];
      p += 2;
      len -= 2;
      if (index >= 2 * kArithTables) refuse(kCorrupt);  // JERR_DAC_INDEX
      if (index >= kArithTables) {
        ac_K[index - kArithTables] = static_cast<uint8_t>(val);
      } else {
        dc_L[index] = static_cast<uint8_t>(val & 15);
        dc_U[index] = static_cast<uint8_t>(val >> 4);
        if (dc_L[index] > dc_U[index]) refuse(kCorrupt);  // JERR_DAC_VALUE
      }
    }
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
      case 0xC2: progressive = true; break;
      case 0xC3: lossless = true; break;
      case 0xC9: arithmetic = true; break;
      case 0xCA: arithmetic = progressive = true; break;
      case 0xCB: refuse(kArithLossless);
      default: refuse(kHierarchical);  // SOF5-7, SOF13-15
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
    if (nc != 1 && nc != 3 && nc != 4) refuse(kComponents);
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
    const int64_t unit = lossless ? 1 : 8;  // samples a block is wide
    for (auto& c : comps) {
      c.wib = static_cast<int>((static_cast<int64_t>(W) * c.h + unit * hmax - 1) / (unit * hmax));
      c.hib = static_cast<int>((static_cast<int64_t>(H) * c.v + unit * vmax - 1) / (unit * vmax));
      c.dw = static_cast<int>((static_cast<int64_t>(W) * c.h + hmax - 1) / hmax);
      c.dh = static_cast<int>((static_cast<int64_t>(H) * c.v + vmax - 1) / vmax);
      c.bw = (c.wib + c.h - 1) / c.h * c.h;
      c.bh = (c.hib + c.v - 1) / c.v * c.v;
    }
  }

  // jdapimin.c:default_decompress_parms (libjpeg-turbo 3: a 3-component
  // lossless file without JFIF or Adobe marker is taken for RGB)
  void guess_colour_space() {
    if (forced_colour >= 0) {
      colour = static_cast<Colour>(forced_colour);
    } else if (comps.size() == 4) {
      colour = saw_adobe && adobe_transform != 0 ? kYCCK : kCMYK;
    } else if (comps.size() == 3) {
      const bool rgb = saw_jfif    ? false
                       : saw_adobe ? adobe_transform == 0
                                   : lossless || (comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B');
      colour = rgb ? kRGB : kYCbCr;
    }
    // jdcolor.c:jinit_color_deconverter converts no colour in lossless mode
    if (lossless && (colour == kYCbCr || colour == kYCCK)) refuse(kLosslessColour);
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
    const int ss = d[p], se = d[p + 1], ah = d[p + 2] >> 4, al = d[p + 2] & 15;
    if (!progressive && !lossless && (ss != 0 || se != 63 || ah != 0 || al != 0))
      refuse(kCorrupt);  // JWRN_NOT_SEQUENTIAL
    if (first_scan) {
      first_scan = false;
      multi_scan = progressive || scan.size() < comps.size();
      guess_colour_space();
      for (auto& c : comps) {
        if (lossless) {
          c.plane.assign(static_cast<size_t>(c.bw) * c.bh, 0);
        } else {
          c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
        }
      }
    } else if (!multi_scan) {
      refuse(kCorrupt);  // JERR_EOI_EXPECTED
    }
    int blocks = 0;
    for (auto* c : scan) {
      if (!lossless && !c->latched) {  // jdinput.c:latch_quant_tables
        if (c->tq >= 4 || !qdefined[c->tq]) refuse(kCorrupt);
        for (int i = 0; i < 64; i++) {
          c->qv[i] = qtables[c->tq][i];
          c->qt[i] = static_cast<int16_t>(qtables[c->tq][i]);
        }
        c->latched = true;
      }
      c->scanned = true;
      blocks += c->h * c->v;
    }
    if (scan.size() > 1 && blocks > 10) refuse(kBadSampling);  // JERR_BAD_MCU_SIZE
    if (lossless) {
      decode_lossless_scan(scan, ss, se, ah, al);
      return;
    }
    if (progressive) check_progression(scan, ss, se, ah, al);
    if (arithmetic) {
      decode_arith_scan(scan, ss, se, ah, al);
    } else {
      decode_scan(scan, ss, se, ah, al);
    }
  }

  // jdphuff.c:start_pass_phuff_decoder (and jdarith.c:start_pass):
  // JERR_BAD_PROGRESSION, and the coef_bits checks where libjpeg warns
  // (JWRN_BOGUS_PROGRESSION)
  static void check_progression(const std::vector<Component*>& scan, int ss, int se, int ah, int al) {
    const bool dc_band = ss == 0;
    bool bad = dc_band ? se != 0 : (ss > se || se > 63 || scan.size() != 1);
    if (ah != 0 && al != ah - 1) bad = true;
    if (al > 13) bad = true;
    if (bad) refuse(kBadProgression);
    for (auto* c : scan) {
      if (!dc_band && c->coef_bits[0] < 0) refuse(kBadProgression);  // AC before the first DC scan
      for (int k = ss; k <= se; k++) {
        if (ah != std::max(c->coef_bits[k], 0)) refuse(kBadProgression);
        c->coef_bits[k] = al;
      }
    }
  }

  // jdcoefct.c:smoothing_ok: libjpeg-turbo smooths the blocks of a
  // progressive image whose scans leave any of the first nine AC
  // coefficients unrefined, when every component has its DC and nonzero
  // quantisers for the ten coefficients
  bool smoothing_ok() const {
    if (!progressive) return false;
    bool useful = false;
    for (const auto& c : comps) {
      if (!c.latched || c.coef_bits[0] < 0) return false;
      for (int k = 0; k < 10; k++)
        if (c.qv[kNaturalOrder[k]] == 0) return false;
      for (int k = 1; k < 10; k++) useful = useful || c.coef_bits[k] != 0;
    }
    return useful;
  }

  const HuffSpec& table(HuffSpec* specs, int slot, bool is_ac) {
    if (slot >= 4) refuse(kCorrupt);
    if (!specs[slot].defined) {
      // jdphuff.c and jdlhuff.c load no standard tables: JERR_NO_HUFF_TABLE
      if (slot >= 2 || progressive || lossless) refuse(kCorrupt);
      specs[slot] = std_table(is_ac, slot);
    }
    return specs[slot];
  }

  // the MCU grid of a scan: (MCUs across, MCUs down)
  std::pair<int, int> mcu_grid(const std::vector<Component*>& scan) const {
    if (scan.size() == 1) return {scan[0]->wib, scan[0]->hib};
    const int unit = lossless ? 1 : 8;
    return {(W + unit * hmax - 1) / (unit * hmax), (H + unit * vmax - 1) / (unit * vmax)};
  }

  // each block of a DCT scan in MCU order: at_restart(k) before the MCU that
  // starts the k-th restart interval, block(i, coefficients) for the blocks
  // of component scan[i] in the MCU
  template <class AtRestart, class Block>
  void each_block(const std::vector<Component*>& scan, AtRestart at_restart, Block block) {
    const int ns = static_cast<int>(scan.size());
    const auto [mcus_x, mcus_y] = mcu_grid(scan);
    int to_go = restart_interval, next_rst = 0;
    const int64_t total = static_cast<int64_t>(mcus_x) * mcus_y;
    for (int64_t m = 0; m < total; m++) {
      if (restart_interval) {
        if (to_go == 0) {
          at_restart(next_rst);
          next_rst = (next_rst + 1) & 7;
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
            block(i, &c->coef[(by * c->bw + bx) * 64]);
          }
        }
      }
    }
  }

  void decode_scan(const std::vector<Component*>& scan, int ss, int se, int ah, int al) {
    const int ns = static_cast<int>(scan.size());
    // the tables a scan reads: both (sequential), DC (a first DC scan), AC
    // (an AC scan), none (a DC refinement)
    const bool dc_band = ss == 0;
    const bool need_dc = !progressive || (dc_band && ah == 0), need_ac = !progressive || !dc_band;
    std::vector<Huffman> hdc(ns), hac(ns);
    for (int i = 0; i < ns; i++) {
      if (need_dc) hdc[i].derive(table(dc, scan[i]->td, false), true);
      if (need_ac) hac[i].derive(table(ac, scan[i]->ta, true), false);
    }
    BitReader br(d, n, pos);
    int pred[4] = {0, 0, 0, 0};
    unsigned eobrun = 0;
    auto at_restart = [&](int expect) {
      if (br.real >= 8) refuse(kCorrupt);  // whole bytes discarded
      br = BitReader(d, n, after_restart_marker(br.pos, expect));
      for (int& p : pred) p = 0;
      eobrun = 0;
    };
    each_block(scan, at_restart, [&](int i, int16_t* blk) {
      if (!progressive) {
        decode_block(&br, hdc[i], hac[i], &pred[i], blk);
      } else if (dc_band) {
        if (ah == 0) {
          dc_first(&br, hdc[i], &pred[i], blk, al);
        } else if (br.get(1)) {  // decode_mcu_DC_refine
          blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
        }
      } else if (ah == 0) {
        ac_first(&br, hac[i], blk, ss, se, al, &eobrun);
      } else {
        ac_refine(&br, hac[i], blk, ss, se, al, &eobrun);
      }
    });
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

  // jdphuff.c:decode_mcu_DC_first
  static void dc_first(BitReader* br, const Huffman& hd, int* pred, int16_t* blk, int al) {
    const int diff = br->receive_extend(br->decode(hd));
    if ((*pred >= 0 && diff > INT_MAX - *pred) || (*pred < 0 && diff < INT_MIN - *pred))
      refuse(kCorrupt);  // JERR_BAD_DCT_COEF
    *pred += diff;
    blk[0] = static_cast<int16_t>(static_cast<uint32_t>(*pred) << al);
  }

  // jdphuff.c:decode_mcu_AC_first (an AC scan codes one block an MCU)
  static void ac_first(BitReader* br, const Huffman& ha, int16_t* blk, int ss, int se, int al, unsigned* eobrun) {
    if (*eobrun > 0) {
      (*eobrun)--;
      return;
    }
    for (int k = ss; k <= se; k++) {
      const int rs = br->decode(ha);
      const int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNaturalOrder[k]] = static_cast<int16_t>(static_cast<uint32_t>(br->receive_extend(s)) << al);
      } else if (r == 15) {
        k += 15;  // ZRL
      } else {  // EOBr: this block and the next 2^r - 1 + (r more bits) end their band here
        *eobrun = (1u << r) - 1;
        if (r) *eobrun += br->get(r);
        break;
      }
    }
  }

  // jdphuff.c:decode_mcu_AC_refine: a correction bit for every nonzero
  // coefficient passed, newly nonzero ones +-2^Al
  static void ac_refine(BitReader* br, const Huffman& ha, int16_t* blk, int ss, int se, int al, unsigned* eobrun) {
    const int p1 = 1 << al, m1 = -p1;
    auto correct = [&](int16_t* c) {
      if (br->get(1) && (*c & p1) == 0) *c = static_cast<int16_t>(*c >= 0 ? *c + p1 : *c + m1);
    };
    int k = ss;
    if (*eobrun == 0) {
      for (; k <= se; k++) {
        const int rs = br->decode(ha);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) refuse(kCorrupt);  // JWRN_HUFF_BAD_CODE
          s = br->get(1) ? p1 : m1;
        } else if (r != 15) {
          *eobrun = 1u << r;
          if (r) *eobrun += br->get(r);
          break;
        }
        do {
          int16_t* c = &blk[kNaturalOrder[k]];
          if (*c != 0) {
            correct(c);
          } else if (--r < 0) {
            break;  // the zero that the new coefficient takes
          }
          k++;
        } while (k <= se);
        if (s) blk[kNaturalOrder[k]] = static_cast<int16_t>(s);
      }
    }
    if (*eobrun > 0) {
      for (; k <= se; k++) {
        int16_t* c = &blk[kNaturalOrder[k]];
        if (*c != 0) correct(c);
      }
      (*eobrun)--;
    }
  }

  // jdmarker.c:read_restart_marker at p, the first byte not read as data:
  // the marker must follow at once and be RST<expect>; -> the position after it
  size_t after_restart_marker(size_t p, int expect) const {
    if (p >= n) refuse(kTruncated);
    if (d[p] != 0xFF) refuse(kCorrupt);
    while (p < n && d[p] == 0xFF) p++;
    if (p >= n) refuse(kTruncated);
    if (d[p] != 0xD0 + expect) refuse(kCorrupt);  // JWRN_MUST_RESYNC
    return p + 1;
  }

  // -------------------------------------------------------------------------
  // arithmetic-coded scans (jdarith.c)
  // -------------------------------------------------------------------------

  // start_pass and process_restart: the statistics of the scan's tables
  // cleared, the DC predictions and contexts reset
  void arith_reset_stats(const std::vector<Component*>& scan, int ss, int ah) {
    for (size_t i = 0; i < scan.size(); i++) {
      if (!progressive || (ss == 0 && ah == 0)) {
        memset(dc_stats[scan[i]->td], 0, kDcStatBins);
        last_dc[i] = 0;
        dc_context[i] = 0;
      }
      if (!progressive || ss != 0) memset(ac_stats[scan[i]->ta], 0, kAcStatBins);
    }
  }

  void decode_arith_scan(const std::vector<Component*>& scan, int ss, int se, int ah, int al) {
    arith_reset_stats(scan, ss, ah);
    ArithReader ar(d, n, pos);
    auto at_restart = [&](int expect) {
      ar = ArithReader(d, n, after_restart_marker(ar.pos, expect));
      arith_reset_stats(scan, ss, ah);
    };
    each_block(scan, at_restart, [&](int i, int16_t* blk) {
      Component* c = scan[i];
      if (!progressive) {  // decode_mcu
        arith_dc(&ar, i, c->td);
        blk[0] = static_cast<int16_t>(last_dc[i]);
        arith_ac(&ar, c->ta, blk, 1, 63, 0);
      } else if (ss == 0 && ah == 0) {  // decode_mcu_DC_first
        arith_dc(&ar, i, c->td);
        blk[0] = static_cast<int16_t>(static_cast<uint32_t>(last_dc[i]) << al);
      } else if (ss == 0) {  // decode_mcu_DC_refine
        if (ar.decode(fixed_bin)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
      } else if (ah == 0) {  // decode_mcu_AC_first
        arith_ac(&ar, c->ta, blk, ss, se, al);
      } else {
        arith_ac_refine(&ar, c->ta, blk, ss, se, al);
      }
    });
    pos = ar.pos;  // at the marker, or at bytes that next_marker refuses
  }

  // Figures F.19-F.24: the DC difference of scan component i, summed into
  // last_dc[i] (modulo 2^16), its conditioning category updated
  void arith_dc(ArithReader* ar, int i, int tbl) {
    uint8_t* st = dc_stats[tbl] + dc_context[i];
    if (ar->decode(st) == 0) {
      dc_context[i] = 0;
      return;
    }
    const int sign = ar->decode(st + 1);
    st += 2 + sign;
    int m = ar->decode(st);
    if (m != 0) {
      st = dc_stats[tbl] + 20;  // X1
      while (ar->decode(st)) {
        if ((m <<= 1) == 0x8000) refuse(kCorrupt);  // JWRN_ARITH_BAD_CODE: magnitude overflow
        st++;
      }
    }
    if (m < ((1 << dc_L[tbl]) >> 1)) {
      dc_context[i] = 0;
    } else if (m > ((1 << dc_U[tbl]) >> 1)) {
      dc_context[i] = 12 + sign * 4;
    } else {
      dc_context[i] = 4 + sign * 4;
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar->decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    last_dc[i] = (last_dc[i] + v) & 0xFFFF;
  }

  // Figure F.20 over the band [ss, se]: the AC coefficients up to the EOB
  void arith_ac(ArithReader* ar, int tbl, int16_t* blk, int ss, int se, int al) {
    uint8_t* stats = ac_stats[tbl];
    for (int k = ss; k <= se; k++) {
      uint8_t* st = stats + 3 * (k - 1);
      if (ar->decode(st)) break;  // EOB
      while (ar->decode(st + 1) == 0) {
        st += 3;
        if (++k > se) refuse(kCorrupt);  // JWRN_ARITH_BAD_CODE: spectral overflow
      }
      const int sign = ar->decode(fixed_bin);
      st += 2;
      int m = ar->decode(st);
      if (m != 0 && ar->decode(st)) {
        m <<= 1;
        st = stats + (k <= ac_K[tbl] ? 189 : 217);
        while (ar->decode(st)) {
          if ((m <<= 1) == 0x8000) refuse(kCorrupt);  // JWRN_ARITH_BAD_CODE: magnitude overflow
          st++;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar->decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kNaturalOrder[k]] = static_cast<int16_t>(static_cast<uint32_t>(v) << al);
    }
  }

  // decode_mcu_AC_refine
  void arith_ac_refine(ArithReader* ar, int tbl, int16_t* blk, int ss, int se, int al) {
    uint8_t* stats = ac_stats[tbl];
    const int p1 = 1 << al, m1 = -p1;
    int kex = se;  // the previous stage's end of block
    for (; kex > 0; kex--)
      if (blk[kNaturalOrder[kex]]) break;
    for (int k = ss; k <= se; k++) {
      uint8_t* st = stats + 3 * (k - 1);
      if (k > kex && ar->decode(st)) break;  // EOB
      for (;;) {
        int16_t* c = &blk[kNaturalOrder[k]];
        if (*c) {  // a coefficient nonzero before: its correction bit
          if (ar->decode(st + 2)) *c = static_cast<int16_t>(*c + (*c < 0 ? m1 : p1));
          break;
        }
        if (ar->decode(st + 1)) {  // newly nonzero
          *c = static_cast<int16_t>(ar->decode(fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) refuse(kCorrupt);  // JWRN_ARITH_BAD_CODE: spectral overflow
      }
    }
  }

  // -------------------------------------------------------------------------
  // lossless scans (jddiffct.c, jdlhuff.c, jdlossls.c)
  // -------------------------------------------------------------------------

  void decode_lossless_scan(const std::vector<Component*>& scan, int psv, int se, int ah, int pt) {
    if (psv < 1 || psv > 7 || se != 0 || ah != 0 || pt >= 8) refuse(kLosslessScan);
    const int ns = static_cast<int>(scan.size());
    std::vector<Huffman> hdc(ns);
    for (int i = 0; i < ns; i++) hdc[i].derive(table(dc, scan[i]->td, false), true, true);
    const auto [mcus_x, mcus_y] = mcu_grid(scan);
    // jdlossls.c:predict_start_pass: whole MCU rows between restarts
    if (restart_interval % mcus_x) refuse(kLosslessScan);
    const int rst_rows = restart_interval / mcus_x;
    const int total = (H + vmax - 1) / vmax;  // iMCU rows
    // per component: the differences of the iMCU row being read (v rows,
    // dummy samples included), the last undifferenced row, the row being
    // undifferenced, and whether the next row is a first row
    std::vector<std::vector<int>> diff(ns), prev(ns), cur(ns);
    std::vector<int> rowlen(ns);
    std::vector<bool> first(ns, true);
    for (int i = 0; i < ns; i++) {
      rowlen[i] = mcus_x * (ns == 1 ? 1 : scan[i]->h);
      diff[i].assign(static_cast<size_t>(rowlen[i]) * scan[i]->v, 0);
      prev[i].assign(scan[i]->wib, 0);
      cur[i].assign(scan[i]->wib, 0);
    }
    BitReader br(d, n, pos);
    int rows_to_go = rst_rows, next_rst = 0;
    for (int im = 0; im < total; im++) {
      // decompress_data: the MCU rows of the iMCU row, restarts before them
      const int mcu_rows = ns > 1 ? 1 : (im < total - 1 ? scan[0]->v : scan[0]->last_row_height());
      for (int yo = 0; yo < mcu_rows; yo++) {
        if (restart_interval) {
          if (rows_to_go == 0) {
            if (br.real >= 8) refuse(kCorrupt);
            br = BitReader(d, n, after_restart_marker(br.pos, next_rst));
            next_rst = (next_rst + 1) & 7;
            rows_to_go = rst_rows;
            std::fill(first.begin(), first.end(), true);  // predict_start_pass
          }
          rows_to_go--;
        }
        for (int mx = 0; mx < mcus_x; mx++) {
          for (int i = 0; i < ns; i++) {  // jdlhuff.c:decode_mcus
            const int bh = ns == 1 ? 1 : scan[i]->v, bwid = ns == 1 ? 1 : scan[i]->h;
            for (int y = 0; y < bh; y++) {
              int* row = &diff[i][static_cast<size_t>(ns == 1 ? yo : y) * rowlen[i]];
              for (int x = 0; x < bwid; x++) {
                const int s = br.decode(hdc[i]);
                row[mx * bwid + x] = s == 16 ? 32768 : br.receive_extend(s);
              }
            }
          }
        }
      }
      // undifference and scale the rows that are not dummy
      for (int i = 0; i < ns; i++) {
        Component* c = scan[i];
        const int rows = im < total - 1 ? c->v : c->last_row_height();
        for (int r = 0; r < rows; r++) {
          undifference(&diff[i][static_cast<size_t>(r) * rowlen[i]], prev[i].data(), cur[i].data(), c->wib,
                       first[i] ? 0 : psv, pt);
          first[i] = false;
          uint8_t* out = &c->plane[(static_cast<size_t>(im) * c->v + r) * c->bw];
          for (int x = 0; x < c->wib; x++) out[x] = static_cast<uint8_t>(cur[i][x] << pt);
          prev[i].swap(cur[i]);
        }
      }
    }
    if (br.real >= 8) refuse(kCorrupt);
    pos = br.pos;
  }

  // jdlossls.c: jpeg_undifference_first_row (psv 0: the left neighbour, the
  // first sample from 1 << (P - Pt - 1)) and jpeg_undifference1..7
  static void undifference(const int* diff, const int* prev, int* out, int w, int psv, int pt) {
    if (psv == 0) {
      int ra = (diff[0] + (1 << (8 - pt - 1))) & 0xFFFF;
      out[0] = ra;
      for (int x = 1; x < w; x++) out[x] = ra = (diff[x] + ra) & 0xFFFF;
      return;
    }
    int rb = prev[0];
    int ra = (diff[0] + rb) & 0xFFFF;
    out[0] = ra;
    for (int x = 1; x < w; x++) {
      const int rc = rb;
      rb = prev[x];
      int p = 0;
      switch (psv) {
        case 1: p = ra; break;
        case 2: p = rb; break;
        case 3: p = rc; break;
        case 4: p = ra + rb - rc; break;
        case 5: p = ra + ((rb - rc) >> 1); break;
        case 6: p = rb + ((ra - rc) >> 1); break;
        default: p = (ra + rb) >> 1; break;
      }
      out[x] = ra = (diff[x] + p) & 0xFFFF;
    }
  }

  int out_channels() const { return colour == kRaw ? static_cast<int>(comps.size()) : 3; }

  // a tables-only stream (a TIFF's JPEGTables: SOI, DQT and DHT segments,
  // EOI), read as jpeg_read_header(require_image = FALSE) reads it
  void run_tables() {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) refuse(kTiffTables);
    pos = 2;
    for (;;) {
      const int m = next_marker();
      if (m == 0xD9) return;
      if (m == 0xC4) {
        read_dht();
      } else if (m == 0xDB) {
        read_dqt();
      } else if (m == 0xFE || (m >= 0xE0 && m <= 0xEF)) {
        int len;
        segment(&len);
      } else {
        refuse(kTiffTables);  // libtiff: "Bogus JPEGTables field"
      }
    }
  }

  void run() {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) refuse(kNotJpeg);
    pos = 2;
    for (;;) {
      const int m = next_marker();
      if (m == 0xD9) break;  // EOI
      switch (m) {
        case 0xC4: read_dht(); break;
        case 0xCC: read_dac(); break;
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
        case 0xDC: case 0xFE: {  // DNL, COM: skipped
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
    if (lossless)
      for (const auto& c : comps)
        if (!c.scanned) refuse(kCorrupt);  // its samples would be libjpeg's uninitialised buffer
  }

  void output(uint8_t* rgb_out) {
    const bool smooth = smoothing_ok();
    for (auto& c : comps) {
      if (lossless) continue;  // the scans wrote the samples
      const size_t stride = static_cast<size_t>(c.bw) * 8;
      c.plane.resize(stride * c.bh * 8);
      if (smooth) {
        smooth_idct(c);
      } else {
        for (int by = 0; by < c.hib; by++)
          for (int bx = 0; bx < c.wib; bx++)
            idct_islow(&c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64], c.qt,
                       &c.plane[static_cast<size_t>(by) * 8 * stride + bx * 8], stride);
      }
      std::vector<int16_t>().swap(c.coef);
    }
    const int nc = static_cast<int>(comps.size());
    std::vector<std::vector<uint8_t>> rows(nc);
    for (int i = 0; i < nc; i++) rows[i].resize(static_cast<size_t>(comps[i].bw) * 8 * hmax + 16);
    const uint8_t* row[4] = {nullptr, nullptr, nullptr, nullptr};
    for (int y = 0; y < H; y++) {
      for (int i = 0; i < nc; i++) row[i] = upsample_row(comps[i], y, rows[i].data());
      uint8_t* o = rgb_out + static_cast<size_t>(y) * W * out_channels();
      switch (colour) {
        case kRaw:
          for (int x = 0; x < W; x++)
            for (int i = 0; i < nc; i++) o[nc * x + i] = row[i][x];
          break;
        case kGrey:
          for (int x = 0; x < W; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = row[0][x];
          break;
        case kRGB:
          for (int x = 0; x < W; x++) {
            o[3 * x] = row[0][x];
            o[3 * x + 1] = row[1][x];
            o[3 * x + 2] = row[2][x];
          }
          break;
        case kYCbCr:
          ycc_rgb_row(row[0], row[1], row[2], W, o);
          break;
        case kCMYK:
        case kYCCK:
          cmyk_rgb_row(row, W, colour == kYCCK, o);
          break;
      }
    }
  }

  // jdcoefct.c:decompress_smooth_data (libjpeg-turbo >= 2.1) for one
  // component: its blocks into c.plane, each transformed from a copy whose
  // zero low-frequency coefficients are estimated from the 5x5 DC values
  // around it
  void smooth_idct(Component& c) const {
    const size_t stride = static_cast<size_t>(c.bw) * 8;
    const int* cb = c.coef_bits;  // the latch: cinfo->coef_bits[0..9] after the last scan
    bool change_dc = true;
    for (int k = 1; k < 10; k++) change_dc = change_dc && cb[k] == -1;
    // Q00, Q01, Q10, Q20, Q11, Q02, Q03, Q12, Q21, Q30 by coef_bits index
    int64_t q[10];
    for (int k = 0; k < 10; k++) q[k] = c.qv[kNaturalOrder[k]];
    const int total = (H + 8 * vmax - 1) / (8 * vmax);  // total_iMCU_rows
    const int64_t q00 = q[0];
    int16_t ws[64];
    for (int im = 0; im < total; im++) {
      const int block_rows = im < total - 1 ? c.v : c.last_row_height();
      const int image_block_rows = block_rows * total;  // as libjpeg-turbo computes it
      for (int br = 0; br < block_rows; br++) {
        const int ibr = im * block_rows + br;  // image_block_row, likewise
        const int cur = im * c.v + br;         // the block row it reads
        const int prv = ibr > 0 ? cur - 1 : cur;
        const int pp = ibr > 1 ? cur - 2 : prv;
        const int nxt = ibr < image_block_rows - 1 ? cur + 1 : cur;
        const int nn = ibr < image_block_rows - 2 ? cur + 2 : nxt;
        const int16_t* rowp[5];
        const int rix[5] = {pp, prv, cur, nxt, nn};
        for (int r = 0; r < 5; r++) rowp[r] = &c.coef[static_cast<size_t>(rix[r]) * c.bw * 64];
        // DC[r][k]: the DC of row r (pp .. nn), column k - 2 relative to the block
        int DC[5][5];
        for (int r = 0; r < 5; r++)
          for (int k = 0; k < 5; k++) DC[r][k] = rowp[r][0];
        const int last_col = c.wib - 1;
        for (int bn = 0; bn < c.wib; bn++) {
          memcpy(ws, rowp[2] + static_cast<size_t>(bn) * 64, sizeof(ws));
          if (bn == 0 && bn < last_col)
            for (int r = 0; r < 5; r++) DC[r][3] = DC[r][4] = rowp[r][64];
          if (bn + 1 < last_col)
            for (int r = 0; r < 5; r++) DC[r][4] = rowp[r][static_cast<size_t>(bn + 2) * 64];
          // libjpeg-turbo's names: DC01..DC05 the first row, DC11..DC15 this row
          const int DC01 = DC[0][0], DC02 = DC[0][1], DC03 = DC[0][2], DC04 = DC[0][3], DC05 = DC[0][4];
          const int DC06 = DC[1][0], DC07 = DC[1][1], DC08 = DC[1][2], DC09 = DC[1][3], DC10 = DC[1][4];
          const int DC11 = DC[2][0], DC12 = DC[2][1], DC13 = DC[2][2], DC14 = DC[2][3], DC15 = DC[2][4];
          const int DC16 = DC[3][0], DC17 = DC[3][1], DC18 = DC[3][2], DC19 = DC[3][3], DC20 = DC[3][4];
          const int DC21 = DC[4][0], DC22 = DC[4][1], DC23 = DC[4][2], DC24 = DC[4][3], DC25 = DC[4][4];
          // an estimate where the coefficient is still zero and not known to
          // be exact, clamped below 2^Al
          auto estimate = [&](int k, int pos, int64_t sum) {
            const int al = cb[k];
            if (al == 0 || ws[pos] != 0) return;
            const int64_t num = q00 * sum, qk = q[k];
            int pred;
            if (num >= 0) {
              pred = static_cast<int>(((qk << 7) + num) / (qk << 8));
              if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
            } else {
              pred = static_cast<int>(((qk << 7) - num) / (qk << 8));
              if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
              pred = -pred;
            }
            ws[pos] = static_cast<int16_t>(pred);
          };
          estimate(1, 1, change_dc ? -DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 + 3 * DC10 -
                                         3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 -
                                         13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24 + DC25
                                   : -7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15);
          estimate(2, 8, change_dc ? -DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 + 38 * DC08 +
                                         13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 +
                                         DC21 + 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25
                                   : -7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23);
          estimate(3, 16, change_dc ? DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 - 5 * DC14 +
                                          2 * DC17 + 7 * DC18 + 2 * DC19 + DC23
                                    : -DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23);
          estimate(4, 9, change_dc ? -DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 - DC25
                                   : DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 - DC24 + DC04 -
                                         DC06 + 10 * DC07 - 10 * DC09);
          estimate(5, 2, change_dc ? 2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 + 7 * DC14 +
                                         DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19
                                   : -DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15);
          if (change_dc) {
            estimate(6, 3, DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19);
            estimate(7, 10, DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19);
            estimate(8, 17, DC07 - 3 * DC12 + DC17 - DC09 + 3 * DC14 - DC19);
            estimate(9, 24, DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19);
            // the DC itself, always replaced
            const int64_t num = q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 + 6 * DC07 +
                                       42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 + 152 * DC13 +
                                       42 * DC14 - 8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 -
                                       6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25);
            const int pred = num >= 0 ? static_cast<int>(((q00 << 7) + num) / (q00 << 8))
                                      : -static_cast<int>(((q00 << 7) - num) / (q00 << 8));
            ws[0] = static_cast<int16_t>(pred);
          }
          idct_islow(ws, c.qt, &c.plane[static_cast<size_t>(cur) * 8 * stride + bn * 8], stride);
          for (int r = 0; r < 5; r++)
            for (int k = 0; k < 4; k++) DC[r][k] = DC[r][k + 1];
        }
      }
    }
  }

  // output row y of component c: a row of its plane or `tmp`
  const uint8_t* upsample_row(const Component& c, int y, uint8_t* tmp) const {
    const size_t stride = static_cast<size_t>(c.bw) * (lossless ? 1 : 8);
    const uint8_t* plane = c.plane.data();
    const int hr = hmax / c.h, vr = vmax / c.v;
    if (hr == 1 && vr == 1) return plane + y * stride;
    const int r = y / vr;
    const uint8_t* near = plane + r * stride;
    // jdsample.c: fancy upsampling only with a DCT block > 1 (not lossless)
    if (!lossless && (hr == 2 || hr == 1) && vr == 2 && !(hr == 2 && c.dw <= 2)) {
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
    if (!lossless && hr == 2 && vr == 1 && c.dw > 2) {
      h2v1_fancy(near, c.dw, tmp);
      return tmp;
    }
    replicate(near, hr, W, tmp);
    return tmp;
  }

  // jdcolor.c:build_ycc_rgb_table
  struct YccTables {
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    YccTables() {
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

  static const YccTables& ycc_tables() {
    static const YccTables t;
    return t;
  }

  // jdcolor.c:ycc_rgb_convert
  static void ycc_rgb_row(const uint8_t* yp, const uint8_t* cbp, const uint8_t* crp, int w, uint8_t* o) {
    const YccTables& t = ycc_tables();
    const uint8_t* rl = kRange.sample + 384;
    for (int x = 0; x < w; x++) {
      const int yy = yp[x], cb = cbp[x], cr = crp[x];
      o[3 * x] = rl[yy + t.cr_r[cr]];
      o[3 * x + 1] = rl[yy + static_cast<int>((t.cb_g[cb] + t.cr_g[cr]) >> 16)];
      o[3 * x + 2] = rl[yy + t.cb_b[cb]];
    }
  }

  // libjpeg's CMYK (jdcolor.c:ycck_cmyk_convert first for YCCK), read by
  // Pillow as inverted CMYK and converted by Convert.c:cmyk2rgb: with
  // c' = 255 - c and nk = 255 - k' = k, each channel is
  // nk - MULDIV255(c', nk)
  static void cmyk_rgb_row(const uint8_t* const* row, int w, bool ycck, uint8_t* o) {
    const YccTables& t = ycc_tables();
    const uint8_t* rl = kRange.sample + 384;
    for (int x = 0; x < w; x++) {
      int cmy[3] = {row[0][x], row[1][x], row[2][x]};
      if (ycck) {
        const int yy = cmy[0], cb = cmy[1], cr = cmy[2];
        cmy[0] = rl[255 - (yy + t.cr_r[cr])];
        cmy[1] = rl[255 - (yy + static_cast<int>((t.cb_g[cb] + t.cr_g[cr]) >> 16))];
        cmy[2] = rl[255 - (yy + t.cb_b[cb])];
      }
      const int nk = row[3][x];
      for (int ch = 0; ch < 3; ch++) {
        const int tmp = (255 - cmy[ch]) * nk + 128;
        o[3 * x + ch] = static_cast<uint8_t>(nk - (((tmp >> 8) + tmp) >> 8));
      }
    }
  }
};

}  // namespace

extern "C" {

// Decode n bytes of a JPEG file to tightly packed RGB8 [h, w, 3].
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

// Decode one strip or tile of a JPEG-compressed TIFF (compression 7) as
// libtiff's tif_jpeg.c has libjpeg decode it: the JPEGTables tag's tables
// (nt bytes, or none) read first, then the strip's abbreviated stream.
// to_rgb: YCbCr in one plane converted to RGB (JPEGCOLORMODE_RGB; libtiff
// leaves libjpeg's fancy upsampling on); 0: the components as stored
// (JCS_UNKNOWN), interleaved. The first component's sampling factors
// must be (hs, vs) (unchecked when hs is 0), the others' 1x1, as
// JPEGPreDecode requires. On success *out is malloc'd [h, w, nc] (release
// with sfod_image_free) and 0 is returned; otherwise a negative code.
int sfod_jpeg_decode_tiff(const uint8_t* tables, int64_t nt, const uint8_t* data, int64_t n, int32_t to_rgb,
                          int32_t hs, int32_t vs, uint8_t** out, int32_t* h, int32_t* w, int32_t* nc) {
  *out = nullptr;
  try {
    Decoder dec(data, static_cast<size_t>(n));
    if (nt > 0) {
      Decoder t(tables, static_cast<size_t>(nt));
      t.run_tables();
      memcpy(dec.qtables, t.qtables, sizeof(dec.qtables));
      for (int i = 0; i < 4; i++) {
        dec.qdefined[i] = t.qdefined[i];
        dec.dc[i] = t.dc[i];
        dec.ac[i] = t.ac[i];
      }
    }
    dec.forced_colour = to_rgb ? Decoder::kYCbCr : Decoder::kRaw;
    dec.run();
    if (to_rgb && dec.comps.size() != 3) return kComponents;
    for (size_t i = 0; i < dec.comps.size(); i++) {
      const int want_h = i == 0 && hs > 0 ? hs : i == 0 && hs == 0 ? dec.comps[0].h : 1;
      const int want_v = i == 0 && hs > 0 ? vs : i == 0 && hs == 0 ? dec.comps[0].v : 1;
      if (dec.comps[i].h != want_h || dec.comps[i].v != want_v) return kTiffSampling;
    }
    const int channels = dec.out_channels();
    uint8_t* buf = static_cast<uint8_t*>(malloc(static_cast<size_t>(dec.H) * dec.W * channels));
    if (!buf) return kNoMemory;
    dec.output(buf);
    *out = buf;
    *h = dec.H;
    *w = dec.W;
    *nc = channels;
    return kOk;
  } catch (const Refusal& r) {
    return r.code;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}

}  // extern "C"
