// The port's lossless WebP (VP8L) decoder and the ALPH plane of a lossy
// WebP frame, as libwebp 1.6 decodes them (src/dec/vp8l_dec.c,
// src/utils/huffman_utils.c, src/dsp/lossless.c, src/dec/alpha_dec.c,
// src/dsp/filters.c), with no libwebp linked:
//
//   sfod_webp_vp8l_decode  a VP8L chunk's payload -> RGB8 [h, w, 3] or RGBA8
//   sfod_webp::alpha_plane an ALPH chunk's payload -> the alpha plane of a
//                          w x h lossy frame (used by webp_vp8.cpp)
//   sfod_webp_vp8l_transforms  the transforms a VP8L stream uses
//
// The bit reader is libwebp's (64-bit window, bytes shifted in as bits are
// used, the end of the stream flagged once more bits were used than there
// are), so a damaged stream ends, or decodes to the same pixels, where
// libwebp's does. Prefix codes are built into libwebp's two-level tables
// (8 root bits) and checked as it checks them: a code that is not complete
// is refused unless it has a single symbol, which then takes no bits.
// Transforms (predictor with its 14 modes, cross-colour, subtract-green,
// colour indexing with pixel bundling) are undone in reverse order of
// reading; the colour cache takes every pixel in order, literal, copied or
// looked up. An ALPH plane is raw or VP8L-coded (green channel, no
// header), then unfiltered (none, horizontal, vertical, gradient);
// alpha dithering stays off, as in WebPDecode's defaults.

#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

namespace sfod_webp {

// the error codes shared with webp_vp8.cpp (data/native_codec.py names them)
enum Status {
  kOk = 0,
  kNoMemory = -5,
  kAlphaHeader = -6,
  kAlphaShort = -7,
  kLosslessHeader = -8,
  kLosslessCorrupt = -9,
  kLosslessShort = -10,
};

int alpha_plane(const uint8_t* data, size_t size, int width, int height, uint8_t* out);

}  // namespace sfod_webp

namespace {

using namespace sfod_webp;

constexpr int kNumLiteralCodes = 256;
constexpr int kNumLengthCodes = 24;
constexpr int kLenCodeLimit = kNumLiteralCodes + kNumLengthCodes;
constexpr int kMaxCacheBits = 11;
constexpr int kAlphabetSize[5] = {kLenCodeLimit, 256, 256, 256, 40};
constexpr int kMaxAlphabet = kLenCodeLimit + (1 << kMaxCacheBits);
constexpr int kRootBits = 8;
constexpr int kLengthsTableBits = 7;
constexpr int kMaxCodeLength = 15;
constexpr int kNumCodeLengthCodes = 19;
constexpr uint8_t kCodeLengthCodeOrder[kNumCodeLengthCodes] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                                               7, 8, 9, 10, 11, 12, 13, 14, 15};
constexpr int kCodeLengthLiterals = 16;
constexpr int kCodeLengthExtraBits[3] = {2, 3, 7};
constexpr int kCodeLengthRepeatOffsets[3] = {3, 3, 11};
constexpr int kDefaultCodeLength = 8;
constexpr uint32_t kHashMul = 0x1e35a7bdu;
enum { GREEN = 0, RED = 1, BLUE = 2, ALPHA = 3, DIST = 4 };
enum { PREDICTOR = 0, CROSS_COLOR = 1, SUBTRACT_GREEN = 2, COLOR_INDEXING = 3 };

// the 120 short distance codes: (yoffset << 4) | (8 - xoffset)
constexpr uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a, 0x38, 0x05, 0x37, 0x39, 0x15, 0x1b,
    0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45,
    0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d, 0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d,
    0x68, 0x02, 0x67, 0x69, 0x12, 0x1e, 0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b,
    0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d,
    0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

// libwebp's VP8LBitReader: val holds the next 64 bits from bit_pos on
struct BitReader {
  uint64_t val = 0;
  const uint8_t* buf = nullptr;
  size_t len = 0, pos = 0;
  int bit_pos = 0;
  int eos = 0;

  void init(const uint8_t* start, size_t length) {
    len = length;
    val = 0;
    bit_pos = 0;
    eos = 0;
    size_t n = length < 8 ? length : 8;
    for (size_t i = 0; i < n; ++i) val |= static_cast<uint64_t>(start[i]) << (8 * i);
    pos = n;
    buf = start;
  }
  bool at_end() const { return eos || (pos == len && bit_pos > 64); }
  void set_end() {
    eos = 1;
    bit_pos = 0;
  }
  void shift_bytes() {
    while (bit_pos >= 8 && pos < len) {
      val >>= 8;
      val |= static_cast<uint64_t>(buf[pos]) << 56;
      ++pos;
      bit_pos -= 8;
    }
    if (at_end()) set_end();
  }
  uint32_t prefetch() const { return static_cast<uint32_t>(val >> (bit_pos & 63)); }
  void fill() {
    if (bit_pos >= 32) shift_bytes();
  }
  uint32_t read(int n) {
    if (!eos && n <= 24) {
      const uint32_t v = prefetch() & ((1u << n) - 1);
      bit_pos += n;
      shift_bytes();
      return v;
    }
    set_end();
    return 0;
  }
};

struct HuffCode {
  uint8_t bits;
  uint16_t value;
};

// huffman_utils.c's GetNextKey: reverse(reverse(key, len) + 1, len)
inline uint32_t next_key(uint32_t key, int len) {
  uint32_t step = 1u << (len - 1);
  while (key & step) step >>= 1;
  return step ? (key & (step - 1)) + step : key;
}

inline void replicate(HuffCode* table, int step, int end, HuffCode code) {
  do {
    end -= step;
    table[end] = code;
  } while (end > 0);
}

inline int next_table_bits(const int* count, int len, int root_bits) {
  int left = 1 << (len - root_bits);
  while (len < kMaxCodeLength) {
    left -= count[len];
    if (left <= 0) break;
    ++len;
    left <<= 1;
  }
  return len - root_bits;
}

// huffman_utils.c's BuildHuffmanTable into `table` (root_bits root entries
// and the second-level tables after them). false where libwebp returns 0.
bool build_table(std::vector<HuffCode>& table, int root_bits, const int* lengths, int n) {
  int count[kMaxCodeLength + 1] = {0};
  int offset[kMaxCodeLength + 1];
  for (int s = 0; s < n; ++s) {
    if (lengths[s] > kMaxCodeLength) return false;
    ++count[lengths[s]];
  }
  if (count[0] == n) return false;
  offset[1] = 0;
  for (int len = 1; len < kMaxCodeLength; ++len) {
    if (count[len] > (1 << len)) return false;
    offset[len + 1] = offset[len] + count[len];
  }
  std::vector<uint16_t> sorted(n);
  for (int s = 0; s < n; ++s) {
    if (lengths[s] > 0) sorted[offset[lengths[s]]++] = static_cast<uint16_t>(s);
  }
  // the second-level tables' sizes, from a dry run
  int total = 1 << root_bits;
  {
    int cnt[kMaxCodeLength + 1];
    std::memcpy(cnt, count, sizeof(cnt));
    uint32_t key = 0, low = 0xffffffffu, mask = total - 1;
    for (int len = 1; len <= root_bits; ++len)
      for (; cnt[len] > 0; --cnt[len]) key = next_key(key, len);
    for (int len = root_bits + 1; len <= kMaxCodeLength; ++len) {
      for (; cnt[len] > 0; --cnt[len]) {
        if ((key & mask) != low) {
          total += 1 << next_table_bits(cnt, len, root_bits);
          low = key & mask;
        }
        key = next_key(key, len);
      }
    }
  }
  table.assign(total, HuffCode{0, 0});
  if (offset[kMaxCodeLength] == 1) {  // one symbol: a code of no bits
    replicate(table.data(), 1, 1 << root_bits, HuffCode{0, sorted[0]});
    return true;
  }
  HuffCode* root = table.data();
  HuffCode* tab = root;
  int symbol = 0;
  uint32_t low = 0xffffffffu, mask = (1u << root_bits) - 1, key = 0;
  int num_nodes = 1, num_open = 1;
  int table_bits = root_bits, table_size = 1 << table_bits;
  int step = 2;
  for (int len = 1; len <= root_bits; ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return false;
    for (; count[len] > 0; --count[len]) {
      replicate(&tab[key], step, table_size, HuffCode{static_cast<uint8_t>(len), sorted[symbol++]});
      key = next_key(key, len);
    }
  }
  step = 2;
  for (int len = root_bits + 1; len <= kMaxCodeLength; ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return false;
    for (; count[len] > 0; --count[len]) {
      if ((key & mask) != low) {
        tab += table_size;
        table_bits = next_table_bits(count, len, root_bits);
        table_size = 1 << table_bits;
        low = key & mask;
        root[low].bits = static_cast<uint8_t>(table_bits + root_bits);
        root[low].value = static_cast<uint16_t>((tab - root) - low);
      }
      replicate(&tab[key >> root_bits], step, table_size,
                HuffCode{static_cast<uint8_t>(len - root_bits), sorted[symbol++]});
      key = next_key(key, len);
    }
  }
  return num_nodes == 2 * offset[kMaxCodeLength] - 1;
}

inline int read_symbol(const HuffCode* table, BitReader& br) {
  uint32_t val = br.prefetch();
  table += val & ((1u << kRootBits) - 1);
  const int nbits = table->bits - kRootBits;
  if (nbits > 0) {
    br.bit_pos += kRootBits;
    val = br.prefetch();
    table += table->value;
    table += val & ((1u << nbits) - 1);
  }
  br.bit_pos += table->bits;
  return table->value;
}

struct Group {
  std::vector<HuffCode> trees[5];
  bool stored = true;
};

// one entropy-coded image's codes (libwebp's VP8LMetadata)
struct Codes {
  int cache_bits = 0;
  int huffman_bits = 0;
  int huffman_xsize = 0;
  std::vector<uint32_t> huffman_image;
  std::vector<Group> groups;

  const Group& group_at(int x, int y) const {
    if (huffman_bits == 0) return groups[0];
    return groups[huffman_image[static_cast<size_t>(huffman_xsize) * (y >> huffman_bits) + (x >> huffman_bits)]];
  }
};

struct Transform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

struct Decoder {
  BitReader br;
  int status = kOk;
  std::vector<Transform> transforms;
  unsigned seen = 0;

  bool fail(int code) {
    if (status == kOk) status = code;
    return false;
  }
  bool corrupt() { return fail(br.at_end() ? kLosslessShort : kLosslessCorrupt); }

  bool read_code_lengths(const int* cl_lengths, int num_symbols, int* lengths);
  bool read_code(int alphabet_size, int* lengths, std::vector<HuffCode>* table);
  bool read_codes(int xsize, int ysize, int cache_bits, bool allow_meta, Codes& codes);
  bool read_transform(int* xsize, int ysize);
  bool decode_stream(int xsize, int ysize, bool level0, Codes& codes, std::vector<uint32_t>* sub_image,
                     int* coded_xsize);
  bool decode_pixels(const Codes& codes, uint32_t* data, int width, int height);
  bool decode_alpha_8b(const Codes& codes, uint8_t* data, int width, int height);
  void inverse_transforms(std::vector<uint32_t>& pix) const;
};

bool Decoder::read_code_lengths(const int* cl_lengths, int num_symbols, int* lengths) {
  std::vector<HuffCode> table;
  if (!build_table(table, kLengthsTableBits, cl_lengths, kNumCodeLengthCodes)) return corrupt();
  int max_symbol;
  if (br.read(1)) {
    const int length_nbits = 2 + 2 * static_cast<int>(br.read(3));
    max_symbol = 2 + static_cast<int>(br.read(length_nbits));
    if (max_symbol > num_symbols) return corrupt();
  } else {
    max_symbol = num_symbols;
  }
  int prev = kDefaultCodeLength;
  int symbol = 0;
  while (symbol < num_symbols) {
    if (max_symbol-- == 0) break;
    br.fill();
    const HuffCode& p = table[br.prefetch() & ((1u << kLengthsTableBits) - 1)];
    br.bit_pos += p.bits;
    const int code_len = p.value;
    if (code_len < kCodeLengthLiterals) {
      lengths[symbol++] = code_len;
      if (code_len != 0) prev = code_len;
    } else {
      const int slot = code_len - kCodeLengthLiterals;
      int repeat = static_cast<int>(br.read(kCodeLengthExtraBits[slot])) + kCodeLengthRepeatOffsets[slot];
      if (symbol + repeat > num_symbols) return corrupt();
      const int length = code_len == 16 ? prev : 0;
      while (repeat-- > 0) lengths[symbol++] = length;
    }
  }
  return true;
}

// vp8l_dec.c's ReadHuffmanCode; table == nullptr checks the code only
bool Decoder::read_code(int alphabet_size, int* lengths, std::vector<HuffCode>* table) {
  bool ok;
  const int simple = static_cast<int>(br.read(1));
  std::memset(lengths, 0, alphabet_size * sizeof(int));
  if (simple) {
    const int num_symbols = static_cast<int>(br.read(1)) + 1;
    const int first_symbol_len_code = static_cast<int>(br.read(1));
    int symbol = static_cast<int>(br.read(first_symbol_len_code == 0 ? 1 : 8));
    lengths[symbol] = 1;
    if (num_symbols == 2) {
      symbol = static_cast<int>(br.read(8));
      lengths[symbol] = 1;
    }
    ok = true;
  } else {
    int cl[kNumCodeLengthCodes] = {0};
    const int num_codes = static_cast<int>(br.read(4)) + 4;
    for (int i = 0; i < num_codes; ++i) cl[kCodeLengthCodeOrder[i]] = static_cast<int>(br.read(3));
    ok = read_code_lengths(cl, alphabet_size, lengths);
  }
  ok = ok && !br.eos;
  if (!ok) return corrupt();
  std::vector<HuffCode> scratch;
  if (!build_table(table ? *table : scratch, kRootBits, lengths, alphabet_size)) return corrupt();
  return true;
}

bool Decoder::read_codes(int xsize, int ysize, int cache_bits, bool allow_meta, Codes& codes) {
  int num_groups_max = 1;
  bool mapped = false;
  codes.cache_bits = cache_bits;
  if (allow_meta && br.read(1)) {
    const int bits = 2 + static_cast<int>(br.read(3));
    const int hx = subsample(xsize, bits), hy = subsample(ysize, bits);
    Codes sub;
    std::vector<uint32_t> image;
    if (!decode_stream(hx, hy, false, sub, &image, nullptr)) return false;
    codes.huffman_bits = bits;
    codes.huffman_xsize = hx;
    for (auto& px : image) {
      px = (px >> 8) & 0xffff;
      if (static_cast<int>(px) >= num_groups_max) num_groups_max = static_cast<int>(px) + 1;
    }
    codes.huffman_image = std::move(image);
    // libwebp keeps only the groups the image uses when their count looks
    // too large (the others are read and checked, then dropped)
    mapped = num_groups_max > 1000 || static_cast<int64_t>(num_groups_max) > static_cast<int64_t>(xsize) * ysize;
  }
  if (br.eos) return corrupt();
  codes.groups.resize(num_groups_max);
  if (mapped) {
    for (auto& g : codes.groups) g.stored = false;
    for (uint32_t g : codes.huffman_image) codes.groups[g].stored = true;
  }
  std::vector<int> lengths(kMaxAlphabet, 0);
  for (auto& g : codes.groups) {
    for (int j = 0; j < 5; ++j) {
      int alphabet = kAlphabetSize[j];
      if (j == 0 && cache_bits > 0) alphabet += 1 << cache_bits;
      if (!read_code(alphabet, lengths.data(), g.stored ? &g.trees[j] : nullptr)) return false;
    }
  }
  return true;
}

bool Decoder::read_transform(int* xsize, int ysize) {
  const int type = static_cast<int>(br.read(2));
  if (seen & (1u << type)) return corrupt();
  seen |= 1u << type;
  Transform t;
  t.type = type;
  t.xsize = *xsize;
  t.ysize = ysize;
  Codes sub;
  switch (type) {
    case PREDICTOR:
    case CROSS_COLOR:
      t.bits = 2 + static_cast<int>(br.read(3));
      if (!decode_stream(subsample(t.xsize, t.bits), subsample(ysize, t.bits), false, sub, &t.data, nullptr))
        return false;
      break;
    case COLOR_INDEXING: {
      const int num_colors = static_cast<int>(br.read(8)) + 1;
      const int bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
      *xsize = subsample(t.xsize, bits);
      t.bits = bits;
      std::vector<uint32_t> palette;
      if (!decode_stream(num_colors, 1, false, sub, &palette, nullptr)) return false;
      // the palette is coded as differences; entries past it are transparent black
      const int final_colors = 1 << (8 >> bits);
      t.data.assign(final_colors, 0);
      uint8_t* nd = reinterpret_cast<uint8_t*>(t.data.data());
      const uint8_t* od = reinterpret_cast<const uint8_t*>(palette.data());
      std::memcpy(nd, od, 4);
      for (int i = 4; i < 4 * num_colors; ++i) nd[i] = static_cast<uint8_t>(od[i] + nd[i - 4]);
      break;
    }
    default:
      break;
  }
  transforms.push_back(std::move(t));
  return true;
}

// vp8l_dec.c's DecodeImageStream: a sub-image is decoded here into
// *sub_image; at level 0 only the header is read and *coded_xsize is the
// width that the pixels are coded at (after colour-indexing bundling)
bool Decoder::decode_stream(int xsize, int ysize, bool level0, Codes& codes, std::vector<uint32_t>* sub_image,
                            int* coded_xsize) {
  if (level0) {
    while (br.read(1)) {
      if (!read_transform(&xsize, ysize)) return false;
    }
  }
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = static_cast<int>(br.read(4));
    if (cache_bits < 1 || cache_bits > kMaxCacheBits) return corrupt();
  }
  if (!read_codes(xsize, ysize, cache_bits, level0, codes)) return false;
  if (level0) {
    *coded_xsize = xsize;
    return true;
  }
  sub_image->assign(static_cast<size_t>(xsize) * ysize, 0);
  if (!decode_pixels(codes, sub_image->data(), xsize, ysize)) return false;
  if (br.eos) return corrupt();
  return true;
}

inline int copy_count(int symbol, BitReader& br) {
  if (symbol < 4) return symbol + 1;
  const int extra = (symbol - 2) >> 1;
  const int offset = (2 + (symbol & 1)) << extra;
  return offset + static_cast<int>(br.read(extra)) + 1;
}

inline int plane_to_distance(int xsize, int plane_code) {
  if (plane_code > 120) return plane_code - 120;
  const int dist_code = kCodeToPlane[plane_code - 1];
  const int yoffset = dist_code >> 4;
  const int xoffset = 8 - (dist_code & 0xf);
  const int dist = yoffset * xsize + xoffset;
  return dist >= 1 ? dist : 1;
}

struct ColorCache {
  std::vector<uint32_t> colors;
  int shift = 32;
  explicit ColorCache(int bits) : colors(bits ? (1u << bits) : 0, 0), shift(32 - bits) {}
  void insert(uint32_t argb) { colors[(argb * kHashMul) >> shift] = argb; }
};

// vp8l_dec.c's DecodeImageData, non-incremental: the stream ending before
// the last pixel, or within it, is an error
bool Decoder::decode_pixels(const Codes& codes, uint32_t* data, int width, int height) {
  const int cache_size = codes.cache_bits ? 1 << codes.cache_bits : 0;
  const int cache_limit = kLenCodeLimit + cache_size;
  ColorCache cache(codes.cache_bits);
  const int mask = codes.huffman_bits ? (1 << codes.huffman_bits) - 1 : ~0;
  uint32_t* src = data;
  uint32_t* const end = data + static_cast<size_t>(width) * height;
  uint32_t* last_cached = src;
  int col = 0, row = 0;
  const Group* g = &codes.group_at(0, 0);
  while (src < end) {
    if ((col & mask) == 0) g = &codes.group_at(col, row);
    br.fill();
    const int code = read_symbol(g->trees[GREEN].data(), br);
    if (br.at_end()) break;
    if (code < kNumLiteralCodes || (code >= kLenCodeLimit && code < cache_limit)) {
      if (code < kNumLiteralCodes) {
        const int red = read_symbol(g->trees[RED].data(), br);
        br.fill();
        const int blue = read_symbol(g->trees[BLUE].data(), br);
        const int alpha = read_symbol(g->trees[ALPHA].data(), br);
        if (br.at_end()) break;
        *src = (static_cast<uint32_t>(alpha) << 24) | (red << 16) | (code << 8) | blue;
      } else {
        while (last_cached < src) cache.insert(*last_cached++);
        *src = cache.colors[code - kLenCodeLimit];
      }
      ++src;
      ++col;
      if (col >= width) {
        col = 0;
        ++row;
        if (cache_size)
          while (last_cached < src) cache.insert(*last_cached++);
      }
    } else if (code < kLenCodeLimit) {
      const int length = copy_count(code - kNumLiteralCodes, br);
      const int dist_symbol = read_symbol(g->trees[DIST].data(), br);
      br.fill();
      const int dist = plane_to_distance(width, copy_count(dist_symbol, br));
      if (br.at_end()) break;
      if (src - data < static_cast<std::ptrdiff_t>(dist) || end - src < static_cast<std::ptrdiff_t>(length))
        return fail(kLosslessCorrupt);
      for (int i = 0; i < length; ++i) src[i] = src[i - dist];
      src += length;
      col += length;
      while (col >= width) {
        col -= width;
        ++row;
      }
      if (col & mask) g = &codes.group_at(col, row);
      if (cache_size)
        while (last_cached < src) cache.insert(*last_cached++);
    } else {
      return fail(kLosslessCorrupt);
    }
  }
  br.eos = br.at_end();
  if (br.eos) return fail(kLosslessShort);
  return true;
}

// vp8l_dec.c's DecodeAlphaData: a palette-only alpha stream decoded one
// byte a pixel; here the stream may end within the last pixel
bool Decoder::decode_alpha_8b(const Codes& codes, uint8_t* data, int width, int height) {
  const int mask = codes.huffman_bits ? (1 << codes.huffman_bits) - 1 : ~0;
  const int64_t end = static_cast<int64_t>(width) * height;
  int64_t pos = 0;
  int col = 0, row = 0;
  const Group* g = &codes.group_at(0, 0);
  while (!br.eos && pos < end) {
    if ((col & mask) == 0) g = &codes.group_at(col, row);
    br.fill();
    const int code = read_symbol(g->trees[GREEN].data(), br);
    if (code < kNumLiteralCodes) {
      data[pos++] = static_cast<uint8_t>(code);
      if (++col >= width) {
        col = 0;
        ++row;
      }
    } else if (code < kLenCodeLimit) {
      const int length = copy_count(code - kNumLiteralCodes, br);
      const int dist_symbol = read_symbol(g->trees[DIST].data(), br);
      br.fill();
      const int dist = plane_to_distance(width, copy_count(dist_symbol, br));
      if (pos < dist || end - pos < length) return fail(kLosslessCorrupt);
      for (int i = 0; i < length; ++i) data[pos + i] = data[pos + i - dist];
      pos += length;
      col += length;
      while (col >= width) {
        col -= width;
        ++row;
      }
      if (pos < end && (col & mask)) g = &codes.group_at(col, row);
    } else {
      return fail(kLosslessCorrupt);
    }
    br.eos = br.at_end();
  }
  br.eos = br.at_end();
  if (br.eos && pos < end) return fail(kLosslessShort);
  return true;
}

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }
inline uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }
inline int add_sub_full(int a, int b, int c) { return static_cast<int>(clip255(static_cast<uint32_t>(a + b - c))); }
inline uint32_t clamped_add_subtract_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  const int a = add_sub_full(c0 >> 24, c1 >> 24, c2 >> 24);
  const int r = add_sub_full((c0 >> 16) & 0xff, (c1 >> 16) & 0xff, (c2 >> 16) & 0xff);
  const int g = add_sub_full((c0 >> 8) & 0xff, (c1 >> 8) & 0xff, (c2 >> 8) & 0xff);
  const int b = add_sub_full(c0 & 0xff, c1 & 0xff, c2 & 0xff);
  return (static_cast<uint32_t>(a) << 24) | (r << 16) | (g << 8) | b;
}
inline int add_sub_half(int a, int b) { return static_cast<int>(clip255(static_cast<uint32_t>(a + (a - b) / 2))); }
inline uint32_t clamped_add_subtract_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  const int a = add_sub_half(ave >> 24, c2 >> 24);
  const int r = add_sub_half((ave >> 16) & 0xff, (c2 >> 16) & 0xff);
  const int g = add_sub_half((ave >> 8) & 0xff, (c2 >> 8) & 0xff);
  const int b = add_sub_half(ave & 0xff, c2 & 0xff);
  return (static_cast<uint32_t>(a) << 24) | (r << 16) | (g << 8) | b;
}
inline int sub3(int a, int b, int c) {
  const int pb = b - c, pa = a - c;
  return std::abs(pb) - std::abs(pa);
}
inline uint32_t select(uint32_t a, uint32_t b, uint32_t c) {
  const int pa_minus_pb = sub3(a >> 24, b >> 24, c >> 24) + sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
                          sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) + sub3(a & 0xff, b & 0xff, c & 0xff);
  return pa_minus_pb <= 0 ? a : b;
}

// lossless.c's predictors: left, the row above (top[x], with top[x + 1]
// running into the current row past the right edge)
inline uint32_t predict(int mode, uint32_t left, const uint32_t* top) {
  switch (mode) {
    case 1: return left;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(left, top[1]), top[0]);
    case 6: return average2(left, top[-1]);
    case 7: return average2(left, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(left, top[-1]), average2(top[0], top[1]));
    case 11: return select(top[0], left, top[-1]);
    case 12: return clamped_add_subtract_full(left, top[0], top[-1]);
    case 13: return clamped_add_subtract_half(left, top[0], top[-1]);
    default: return 0xff000000u;  // 0, and 14 and 15 as libwebp maps them
  }
}

inline int color_delta(int8_t pred, int8_t color) { return (static_cast<int>(pred) * color) >> 5; }

void Decoder::inverse_transforms(std::vector<uint32_t>& pix) const {
  for (int n = static_cast<int>(transforms.size()) - 1; n >= 0; --n) {
    const Transform& t = transforms[n];
    const int w = t.xsize, h = t.ysize;
    switch (t.type) {
      case SUBTRACT_GREEN:
        for (auto& p : pix) {
          const uint32_t green = (p >> 8) & 0xff;
          uint32_t rb = p & 0x00ff00ffu;
          rb += (green << 16) | green;
          p = (p & 0xff00ff00u) | (rb & 0x00ff00ffu);
        }
        break;
      case PREDICTOR: {
        uint32_t* out = pix.data();
        out[0] = add_pixels(out[0], 0xff000000u);
        for (int x = 1; x < w; ++x) out[x] = add_pixels(out[x], out[x - 1]);
        const int tiles_per_row = subsample(w, t.bits);
        for (int y = 1; y < h; ++y) {
          uint32_t* row = out + static_cast<size_t>(y) * w;
          const uint32_t* top = row - w;
          const uint32_t* modes = t.data.data() + static_cast<size_t>(y >> t.bits) * tiles_per_row;
          row[0] = add_pixels(row[0], top[0]);
          for (int x = 1; x < w; ++x) {
            const int mode = (modes[x >> t.bits] >> 8) & 0xf;
            row[x] = add_pixels(row[x], predict(mode, row[x - 1], top + x));
          }
        }
        break;
      }
      case CROSS_COLOR: {
        const int tiles_per_row = subsample(w, t.bits);
        for (int y = 0; y < h; ++y) {
          uint32_t* row = pix.data() + static_cast<size_t>(y) * w;
          const uint32_t* codes = t.data.data() + static_cast<size_t>(y >> t.bits) * tiles_per_row;
          for (int x = 0; x < w; ++x) {
            const uint32_t code = codes[x >> t.bits];
            const int8_t g2r = static_cast<int8_t>(code & 0xff), g2b = static_cast<int8_t>((code >> 8) & 0xff),
                         r2b = static_cast<int8_t>((code >> 16) & 0xff);
            const uint32_t argb = row[x];
            const int8_t green = static_cast<int8_t>(argb >> 8);
            int new_red = (argb >> 16) & 0xff;
            int new_blue = argb & 0xff;
            new_red += color_delta(g2r, green);
            new_red &= 0xff;
            new_blue += color_delta(g2b, green);
            new_blue += color_delta(r2b, static_cast<int8_t>(new_red));
            new_blue &= 0xff;
            row[x] = (argb & 0xff00ff00u) | (static_cast<uint32_t>(new_red) << 16) | static_cast<uint32_t>(new_blue);
          }
        }
        break;
      }
      case COLOR_INDEXING: {
        const int packed_w = subsample(w, t.bits);
        std::vector<uint32_t> out(static_cast<size_t>(w) * h);
        const int bits_per_pixel = 8 >> t.bits;
        const int count_mask = (1 << t.bits) - 1;
        const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
        for (int y = 0; y < h; ++y) {
          const uint32_t* src = pix.data() + static_cast<size_t>(y) * packed_w;
          uint32_t* dst = out.data() + static_cast<size_t>(y) * w;
          uint32_t packed = 0;
          for (int x = 0; x < w; ++x) {
            if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
            dst[x] = t.data[packed & bit_mask];
            packed >>= bits_per_pixel;
          }
        }
        pix.swap(out);
        break;
      }
      default:
        break;
    }
  }
}

// filters.c's unfilters; prev == nullptr on the first row
void unfilter(int filter, const uint8_t* prev, uint8_t* row, int width) {
  if (filter == 1 || ((filter == 2 || filter == 3) && prev == nullptr)) {
    uint8_t pred = (prev == nullptr) ? 0 : prev[0];
    for (int i = 0; i < width; ++i) {
      row[i] = static_cast<uint8_t>(pred + row[i]);
      pred = row[i];
    }
  } else if (filter == 2) {
    for (int i = 0; i < width; ++i) row[i] = static_cast<uint8_t>(prev[i] + row[i]);
  } else if (filter == 3) {
    uint8_t top = prev[0], top_left = top, left = top;
    for (int i = 0; i < width; ++i) {
      top = prev[i];
      const int g = left + top - top_left;
      const int pred = (g & ~0xff) == 0 ? g : g < 0 ? 0 : 255;
      left = static_cast<uint8_t>(row[i] + pred);
      top_left = top;
      row[i] = left;
    }
  }
}

// a level-0 stream: header, codes and pixels, transforms undone -> ARGB
int decode_argb(Decoder& d, int width, int height, std::vector<uint32_t>& argb) {
  Codes codes;
  int coded_w = width;
  if (!d.decode_stream(width, height, true, codes, nullptr, &coded_w)) return d.status;
  argb.assign(static_cast<size_t>(width) * height, 0);
  if (!d.decode_pixels(codes, argb.data(), coded_w, height)) return d.status;
  d.inverse_transforms(argb);
  return kOk;
}

}  // namespace

namespace sfod_webp {

int alpha_plane(const uint8_t* data, size_t size, int width, int height, uint8_t* out) {
  if (size <= 1) return kAlphaHeader;
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3, pre = (data[0] >> 4) & 3, rsrv = data[0] >> 6;
  if (method > 1 || pre > 1 || rsrv != 0) return kAlphaHeader;
  const size_t npix = static_cast<size_t>(width) * height;
  if (method == 0) {
    if (size - 1 < npix) return kAlphaShort;
    std::memcpy(out, data + 1, npix);
  } else {
    try {
      Decoder d;
      d.br.init(data + 1, size - 1);
      Codes codes;
      int coded_w = width;
      if (!d.decode_stream(width, height, true, codes, nullptr, &coded_w)) return d.status;
      bool eight_bit = d.transforms.size() == 1 && d.transforms[0].type == COLOR_INDEXING && codes.cache_bits == 0;
      for (const auto& g : codes.groups) {
        if (g.stored && (g.trees[RED][0].bits > 0 || g.trees[BLUE][0].bits > 0 || g.trees[ALPHA][0].bits > 0))
          eight_bit = false;
      }
      std::vector<uint32_t> argb(npix, 0);
      if (eight_bit) {
        std::vector<uint8_t> idx(static_cast<size_t>(coded_w) * height, 0);
        if (!d.decode_alpha_8b(codes, idx.data(), coded_w, height)) return d.status;
        for (size_t i = 0; i < idx.size(); ++i) argb[i] = static_cast<uint32_t>(idx[i]) << 8;
      } else if (!d.decode_pixels(codes, argb.data(), coded_w, height)) {
        return d.status;
      }
      d.inverse_transforms(argb);
      for (size_t i = 0; i < npix; ++i) out[i] = static_cast<uint8_t>(argb[i] >> 8);
    } catch (const std::bad_alloc&) {
      return kNoMemory;
    }
  }
  if (filter != 0) {
    const uint8_t* prev = nullptr;
    for (int y = 0; y < height; ++y) {
      uint8_t* row = out + static_cast<size_t>(y) * width;
      unfilter(filter, prev, row, width);
      prev = row;
    }
  }
  return kOk;
}

}  // namespace sfod_webp

extern "C" {

// Decode a VP8L chunk's payload (its pad byte included, as libwebp's
// demuxer hands it over) into out [h, w, channels], RGB (3) or RGBA (4); h
// and w are the frame's size as its header gives it. 0, or a Status code.
int32_t sfod_webp_vp8l_decode(const uint8_t* data, int64_t n, uint8_t* out, int32_t channels, int32_t h, int32_t w) {
  if (n < 5 || data[0] != 0x2f || (data[4] >> 5) != 0) return kLosslessHeader;
  try {
    Decoder d;
    d.br.init(data, static_cast<size_t>(n));
    if (d.br.read(8) != 0x2f) return kLosslessHeader;
    const int width = static_cast<int>(d.br.read(14)) + 1;
    const int height = static_cast<int>(d.br.read(14)) + 1;
    d.br.read(1);  // alpha_is_used: a hint, the pixels carry their alpha
    if (d.br.read(3) != 0 || d.br.eos || width != w || height != h) return kLosslessHeader;
    std::vector<uint32_t> argb;
    const int rc = decode_argb(d, width, height, argb);
    if (rc != kOk) return rc;
    const size_t npix = static_cast<size_t>(width) * height;
    for (size_t i = 0; i < npix; ++i, out += channels) {
      const uint32_t p = argb[i];
      out[0] = static_cast<uint8_t>(p >> 16);
      out[1] = static_cast<uint8_t>(p >> 8);
      out[2] = static_cast<uint8_t>(p);
      if (channels == 4) out[3] = static_cast<uint8_t>(p >> 24);
    }
    return kOk;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}

// The transforms a VP8L stream uses, as a mask of 1 << type (predictor 0,
// cross-colour 1, subtract-green 2, colour indexing 3), read from its
// header; width 0 reads a VP8L chunk's payload, else a lossless ALPH
// stream (no header) of that width and height. A Status code on failure.
int32_t sfod_webp_vp8l_transforms(const uint8_t* data, int64_t n, int32_t width, int32_t height) {
  try {
    Decoder d;
    d.br.init(data, static_cast<size_t>(n));
    if (width == 0) {
      if (n < 5 || d.br.read(8) != 0x2f) return kLosslessHeader;
      width = static_cast<int32_t>(d.br.read(14)) + 1;
      height = static_cast<int32_t>(d.br.read(14)) + 1;
      d.br.read(1);
      if (d.br.read(3) != 0 || d.br.eos) return kLosslessHeader;
    }
    Codes codes;
    int coded_w = width;
    if (!d.decode_stream(width, height, true, codes, nullptr, &coded_w)) return d.status;
    return static_cast<int32_t>(d.seen);
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}

}  // extern "C"
