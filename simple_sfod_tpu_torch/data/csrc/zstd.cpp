// TIFF's ZSTD compression (50000): one zstd frame a strip or tile (RFC
// 8878), decoded as libtiff's tif_zstd.c has libzstd 1.5 decode it
// (ZSTD_decompressStream over the strip's bytes until the strip is full,
// the input is used up or the frame ends; any error fails the strip):
//
//   frame     the header (descriptor, window descriptor, dictionary ID,
//             content size), blocks, the optional XXH64 checksum. A frame
//             with a dictionary ID fails (libtiff loads no dictionary:
//             libzstd's dictionary_wrong), and so does a window above
//             ZSTD_WINDOWLOG_LIMIT_DEFAULT (2^27 + 1 bytes; libzstd's
//             frameParameter_windowTooLarge). A skippable frame is skipped;
//             libzstd then reports the end of a frame, and libtiff stops
//             there, as it stops after the first frame: a second frame in
//             the strip is never read
//   blocks    raw, RLE and compressed, each at most min(window, 128 KiB).
//             libzstd decodes a block whole before it hands its bytes out,
//             and goes on to the next block once a block's bytes fill the
//             strip exactly: so the block that completes the strip is
//             checked whole, and, where it ends the strip exactly, the block
//             (or the frame's content size and checksum) after it too
//   literals  raw, RLE, Huffman-coded with 1 or 4 streams, and treeless
//             (the previous Huffman table of the frame); the Huffman
//             description FSE-compressed or as direct 4-bit weights, held
//             to HUF_readStats' checks; the streams read as libzstd reads
//             them (its single- or double-symbol decoder, as
//             HUF_selectDecoder picks and a treeless block inherits, and
//             the fast four-stream loops where it takes them), so that a
//             damaged stream fails where libzstd's fails
//   sequences predefined, RLE, FSE-compressed and repeat modes for the
//             literal length, offset and match length codes
//             (FSE_readNCount's checks), the three repeated offsets, the
//             bitstream consumed exactly, every offset held to the frame's
//             output so far

#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

namespace {

enum Code {
  kNotZstd = -1,      // no zstd or skippable frame magic (libzstd: prefix_unknown)
  kCorrupt = -2,      // corruption_detected and the other data errors
  kShort = -3,        // the frame or the data ends before the strip does
  kDictionary = -4,   // a dictionary ID (dictionary_wrong)
  kWindow = -5,       // a window above 2^27 + 1 (frameParameter_windowTooLarge)
  kChecksum = -6,     // checksum_wrong
  kNoMemory = -7,
};

struct Fail {
  int code;
};

[[noreturn]] void fail(int code) { throw Fail{code}; }

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

uint64_t le(const uint8_t* p, int bytes) {
  uint64_t v = 0;
  for (int i = 0; i < bytes; i++) v |= static_cast<uint64_t>(p[i]) << (8 * i);
  return v;
}

// ---------------------------------------------------------------------------
// XXH64 (the frame's content checksum is its low 32 bits, seed 0)
// ---------------------------------------------------------------------------

uint64_t xxh64(const uint8_t* p, size_t n) {
  constexpr uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull, P3 = 1609587929392839161ull,
                     P4 = 9650029242287828579ull, P5 = 2870177450012600261ull;
  auto rotl = [](uint64_t x, int r) { return (x << r) | (x >> (64 - r)); };
  auto round = [&](uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; };
  auto merge = [&](uint64_t acc, uint64_t v) { return (acc ^ round(0, v)) * P1 + P4; };
  size_t i = 0;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; i + 32 <= n; i += 32) {
      v1 = round(v1, le(p + i, 8));
      v2 = round(v2, le(p + i + 8, 8));
      v3 = round(v3, le(p + i + 16, 8));
      v4 = round(v4, le(p + i + 24, 8));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge(merge(merge(merge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += n;
  for (; i + 8 <= n; i += 8) h = rotl(h ^ round(0, le(p + i, 8)), 27) * P1 + P4;
  if (i + 4 <= n) {
    h = rotl(h ^ (le(p + i, 4) * P1), 23) * P2 + P3;
    i += 4;
  }
  for (; i < n; i++) h = rotl(h ^ (p[i] * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------------------
// Bitstreams
// ---------------------------------------------------------------------------

// read backwards from the end, past the last byte's highest set bit; bits
// before the stream's start read as 0, and reading them is an overflow. A
// stream of libzstd's fast Huffman decoder (`window` bytes before the stream
// readable, as its bit reader's start is the first stream's) reads on into
// those bytes, and past them as its 64-bit bit container wraps
struct BackBits {
  const uint8_t* p = nullptr;
  int64_t size = 0;
  int64_t pos = 0;  // bits left
  bool wrap = false;

  void init(const uint8_t* data, int64_t n, int64_t window = 0) {
    if (n < 1) fail(kCorrupt);
    p = data - window;
    size = n + window;
    wrap = window > 0;
    const uint8_t last = data[n - 1];
    if (last == 0) fail(kCorrupt);  // no end mark
    pos = (size - 1) * 8 + highbit(last);
  }
  // the nb bits below position `at` (nb <= 56)
  uint64_t bits_below(int64_t at, int nb) const {
    const int64_t low = at - nb;
    if (low >= 0 && (low >> 3) + 8 <= size) {  // within the stream: one load
      uint64_t v;
      memcpy(&v, p + (low >> 3), 8);
      return (v >> (low & 7)) & ((uint64_t{1} << nb) - 1);
    }
    if (nb == 0) return 0;
    if (wrap && at <= 0) at = 64 - ((64 - at) & 63);  // BIT_lookBitsFast's shift, taken modulo 64
    const int64_t lo = at - nb;
    if (lo < 0) {
      if (at <= 0) return 0;
      return bits_below(at, static_cast<int>(at)) << (-lo);
    }
    const int64_t byte = lo >> 3;
    uint64_t v;
    if (byte + 8 <= size) {
      memcpy(&v, p + byte, 8);
    } else {
      v = 0;
      for (int64_t i = byte; i < size; i++) v |= static_cast<uint64_t>(p[i]) << (8 * (i - byte));
    }
    return (v >> (lo & 7)) & ((uint64_t{1} << nb) - 1);
  }
  uint64_t peek(int nb) const { return bits_below(pos, nb); }
  void skip(int nb) { pos -= nb; }
  uint64_t read(int nb) {
    const uint64_t v = peek(nb);
    pos -= nb;
    return v;
  }
  bool overflowed() const { return pos < 0; }
  bool finished() const { return pos == 0; }
};

// ---------------------------------------------------------------------------
// FSE
// ---------------------------------------------------------------------------

struct FseEntry {
  uint16_t symbol;
  uint8_t bits;
  uint16_t base;
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> t;
};

// FSE_readNCount: the normalised counts of up to max_symbol + 1 symbols
// from src; returns the header's size in bytes
size_t read_ncount(const uint8_t* src, size_t n, int max_symbol, int max_log, std::vector<int>* norm, int* log) {
  std::vector<uint8_t> buf(src, src + n);
  buf.resize(n + 8, 0);
  size_t bit = 0;
  auto get = [&](int nb) {
    uint32_t v = static_cast<uint32_t>(le(buf.data() + (bit >> 3), 5) >> (bit & 7)) & ((1u << nb) - 1);
    return v;
  };
  *log = static_cast<int>(get(4)) + 5;
  bit += 4;
  if (*log > 15 || *log > max_log) fail(kCorrupt);
  int remaining = (1 << *log) + 1, threshold = 1 << *log, nbits = *log + 1, sym = 0;
  norm->assign(max_symbol + 1, 0);
  bool prev0 = false;
  while (remaining > 1 && sym <= max_symbol) {
    if (prev0) {
      for (;;) {
        const uint32_t r = get(2);
        bit += 2;
        sym += static_cast<int>(r);
        if (r != 3) break;
      }
      if (sym > max_symbol) fail(kCorrupt);
    }
    const int max = (2 * threshold - 1) - remaining;
    int count;
    const uint32_t low = get(nbits - 1);
    if (static_cast<int>(low) < max) {
      count = static_cast<int>(low);
      bit += nbits - 1;
    } else {
      count = static_cast<int>(get(nbits));
      if (count >= threshold) count -= max;
      bit += nbits;
    }
    count--;
    remaining -= count < 0 ? -count : count;
    (*norm)[sym++] = count;
    prev0 = count == 0;
    while (remaining < threshold && remaining > 1) {
      nbits--;
      threshold >>= 1;
    }
  }
  if (remaining != 1) fail(kCorrupt);
  const size_t used = (bit + 7) >> 3;
  if (used > n) fail(kCorrupt);
  norm->resize(sym);
  return used;
}

void build_fse(const std::vector<int>& norm, int log, FseTable* out) {
  const int size = 1 << log;
  out->log = log;
  out->t.assign(size, FseEntry{0, 0, 0});
  std::vector<int> next(norm.size());
  int high = size - 1;
  for (size_t s = 0; s < norm.size(); s++) {
    if (norm[s] == -1) {
      out->t[high--].symbol = static_cast<uint16_t>(s);
      next[s] = 1;
    } else {
      next[s] = norm[s];
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (size_t s = 0; s < norm.size(); s++)
    for (int i = 0; i < norm[s]; i++) {
      out->t[pos].symbol = static_cast<uint16_t>(s);
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  if (pos != 0) fail(kCorrupt);
  for (int u = 0; u < size; u++) {
    FseEntry& e = out->t[u];
    const int x = next[e.symbol]++;
    e.bits = static_cast<uint8_t>(log - highbit(static_cast<uint32_t>(x)));
    e.base = static_cast<uint16_t>((x << e.bits) - size);
  }
}

void rle_fse(int symbol, FseTable* out) {
  out->log = 0;
  out->t.assign(1, FseEntry{static_cast<uint16_t>(symbol), 0, 0});
}

// ---------------------------------------------------------------------------
// Huffman literals
// ---------------------------------------------------------------------------

struct Huffman {
  int max_bits = 0;
  std::vector<uint8_t> symbol, bits;  // by the next max_bits bits
};

// HUF_readStats and the decoding table; returns the description's size
size_t read_huffman(const uint8_t* src, size_t n, Huffman* h) {
  if (n < 1) fail(kCorrupt);
  const int head = src[0];
  std::vector<uint8_t> w;
  size_t used;
  if (head >= 128) {  // direct: head - 127 weights, 4 bits each
    const int count = head - 127;
    used = 1 + (count + 1) / 2;
    if (used > n) fail(kCorrupt);
    if (count >= 256) fail(kCorrupt);
    for (int i = 0; i < count; i++)
      w.push_back(static_cast<uint8_t>(i & 1 ? src[1 + i / 2] & 15 : src[1 + i / 2] >> 4));
  } else {  // FSE-compressed, head bytes
    used = 1 + static_cast<size_t>(head);
    if (used > n) fail(kCorrupt);
    std::vector<int> norm;
    int log;
    const size_t hs = read_ncount(src + 1, head, 255, 6, &norm, &log);
    FseTable t;
    build_fse(norm, log, &t);
    BackBits br;
    br.init(src + 1 + hs, head - static_cast<int64_t>(hs));
    uint32_t s1 = static_cast<uint32_t>(br.read(log)), s2 = static_cast<uint32_t>(br.read(log));
    // FSE_decompress_usingDTable_generic's tail: alternate the two states
    // until the stream overflows, then emit the other state's symbol
    for (;;) {
      if (w.size() > 253) fail(kCorrupt);
      w.push_back(static_cast<uint8_t>(t.t[s1].symbol));
      s1 = t.t[s1].base + static_cast<uint32_t>(br.read(t.t[s1].bits));
      if (br.overflowed()) {
        w.push_back(static_cast<uint8_t>(t.t[s2].symbol));
        break;
      }
      if (w.size() > 253) fail(kCorrupt);
      w.push_back(static_cast<uint8_t>(t.t[s2].symbol));
      s2 = t.t[s2].base + static_cast<uint32_t>(br.read(t.t[s2].bits));
      if (br.overflowed()) {
        w.push_back(static_cast<uint8_t>(t.t[s1].symbol));
        break;
      }
    }
  }
  uint32_t total = 0;
  int rank[13] = {};
  for (uint8_t x : w) {
    if (x > 12) fail(kCorrupt);
    rank[x]++;
    total += (1u << x) >> 1;
  }
  if (total == 0) fail(kCorrupt);
  const int log = highbit(total) + 1;
  if (log > 12) fail(kCorrupt);
  const uint32_t rest = (1u << log) - total;
  if (rest != (1u << highbit(rest))) fail(kCorrupt);
  const int last = highbit(rest) + 1;
  w.push_back(static_cast<uint8_t>(last));
  rank[last]++;
  if (rank[1] < 2 || (rank[1] & 1)) fail(kCorrupt);
  h->max_bits = log;
  h->symbol.assign(size_t{1} << log, 0);
  h->bits.assign(size_t{1} << log, 0);
  // entries in order of weight, then symbol: 2^(w-1) entries each
  uint32_t start[14] = {};
  for (int k = 1; k <= 12; k++) start[k + 1] = start[k] + (static_cast<uint32_t>(rank[k]) << (k - 1));
  for (size_t s = 0; s < w.size(); s++) {
    const int x = w[s];
    if (!x) continue;
    const uint32_t len = 1u << (x - 1);
    for (uint32_t i = 0; i < len; i++) {
      h->symbol[start[x] + i] = static_cast<uint8_t>(s);
      h->bits[start[x] + i] = static_cast<uint8_t>(log + 1 - x);
    }
    start[x] += len;
  }
  return used;
}

inline uint8_t huffman_symbol(const Huffman& h, BackBits* br) {
  const uint32_t k = static_cast<uint32_t>(br->peek(h.max_bits));
  br->skip(h.bits[k]);
  return h.symbol[k];
}

// the length of the code at the reading position
inline int huffman_length(const Huffman& h, const BackBits& br) {
  return h.bits[static_cast<uint32_t>(br.peek(h.max_bits))];
}

// one lookup of libzstd's double-symbol table (HUF_readDTableX2, built at
// 11 bits for a tree of at most 11, else at 12): the symbol at the reading
// position, and the one after it where both codes fit in the lookup; the
// number of symbols written
inline int huffman_pair(const Huffman& h, BackBits* br, uint8_t* out) {
  const int target = h.max_bits <= 11 ? 11 : 12;
  const int first = huffman_length(h, *br);
  out[0] = huffman_symbol(h, br);
  if (first + huffman_length(h, *br) > target) return 1;
  out[1] = huffman_symbol(h, br);
  return 2;
}

// one Huffman stream of count symbols, consumed exactly (libzstd's
// single-stream decoder and its four-stream fallback). The double-symbol
// decoder (x2) reads its last symbol through a pair lookup
// (HUF_decodeLastSymbolX2): it skips both codes, clamped at the stream's
// start, so a stream that ends within the second code passes
void huffman_stream(const Huffman& h, const uint8_t* src, int64_t n, uint8_t* out, size_t count, bool x2) {
  BackBits br;
  br.init(src, n);
  for (size_t i = 0; i + 1 < count; i++) out[i] = huffman_symbol(h, &br);
  if (count > 0) {
    const int first = huffman_length(h, br);
    const int second = h.bits[static_cast<uint32_t>(br.bits_below(br.pos - first, h.max_bits))];
    if (!x2 || first + second > (h.max_bits <= 11 ? 11 : 12)) {
      out[count - 1] = huffman_symbol(h, &br);
    } else {  // a pair: both codes skipped if any bit is left, then clamped
      out[count - 1] = h.symbol[static_cast<uint32_t>(br.peek(h.max_bits))];
      if (br.pos > 0) br.pos = br.pos - first - second < 0 ? 0 : br.pos - first - second;
    }
  }
  if (!br.finished()) fail(kCorrupt);
}

// four streams as libzstd's fast decoders (HUF_decompress4X1_ and
// HUF_decompress4X2_usingDTable_internal_fast, taken on x86-64 when each
// stream is at least 8 bytes and the table at most 11 bits) decode them:
// rounds of 5 lookups a stream (one symbol each for X1; one or two for X2,
// whose rounds run while every stream has 10 symbols a round left) while
// stream 1 has 7 bytes a round in hand and no stream's reading head has
// passed the one before it, a stream whose head then went a byte past its
// own start refused (HUF_initRemainingDStream); then each stream to its
// segment's end with no check of where it ends, reading on into the bytes
// before it (its bit reader starts at the first stream's jump table) and,
// past them, as the bit container wraps. src: the jump table, then the
// streams
// HUF_selectDecoder: whether libzstd decodes size literals from csize
// bytes with its double-symbol decoder (X2) rather than X1
bool huffman_x2(size_t size, size_t csize) {
  static const uint16_t kTime[16][2][2] = {
      {{0, 0}, {1, 1}},         {{0, 0}, {1, 1}},         {{150, 216}, {381, 119}},  {{170, 205}, {514, 112}},
      {{177, 199}, {539, 110}}, {{197, 194}, {644, 107}}, {{221, 192}, {735, 107}},  {{256, 189}, {881, 106}},
      {{359, 188}, {1167, 109}}, {{582, 187}, {1570, 114}}, {{688, 187}, {1712, 122}}, {{825, 186}, {1965, 136}},
      {{976, 185}, {2131, 150}}, {{1180, 186}, {2070, 175}}, {{1377, 185}, {1731, 202}}, {{1412, 185}, {1695, 202}}};
  const uint32_t q = csize >= size ? 15 : static_cast<uint32_t>(csize * 16 / size);
  const uint32_t d256 = static_cast<uint32_t>(size >> 8);
  const uint32_t t0 = kTime[q][0][0] + kTime[q][0][1] * d256;
  uint32_t t1 = kTime[q][1][0] + kTime[q][1][1] * d256;
  t1 += t1 >> 5;
  return t1 < t0;
}

void huffman_fast(const Huffman& h, const uint8_t* src, const int64_t* len, uint8_t* out, size_t size, size_t seg,
                  bool x2) {
  BackBits br[4];
  int64_t start[4];
  size_t op[4], oend[4];
  int64_t at = 6;
  for (int i = 0; i < 4; i++) {
    start[i] = at;
    br[i].init(src + at, len[i], at);
    at += len[i];
    op[i] = seg * i;
    oend[i] = i < 3 ? seg * (i + 1) : size;
  }
  auto ip = [&](int i) { return (br[i].pos + 7) / 8 - 8; };  // its 8-byte container, from the jump table
  for (;;) {
    size_t iters = static_cast<size_t>(ip(0) > 0 ? ip(0) : 0) / 7;
    for (int i = x2 ? 0 : 3; i < 4; i++) {
      const size_t oiters = (oend[i] - op[i]) / (x2 ? 10 : 5);
      iters = oiters < iters ? oiters : iters;
    }
    if (iters == 0) break;
    bool crossed = false;
    for (int i = 1; i < 4; i++) crossed |= ip(i) < ip(i - 1);
    if (crossed) break;
    const size_t olimit = op[3] + iters * 5;
    do {
      for (int i = 0; i < 4; i++)
        for (int k = 0; k < 5; k++) {
          if (x2)
            op[i] += huffman_pair(h, &br[i], out + op[i]);
          else
            out[op[i]++] = huffman_symbol(h, &br[i]);
        }
    } while (op[3] < olimit);
  }
  for (int i = 0; i < 4; i++) {
    if (ip(i) < start[i] - 8) fail(kCorrupt);
    while (op[i] < oend[i]) out[op[i]++] = huffman_symbol(h, &br[i]);
  }
}

// ---------------------------------------------------------------------------
// Sequences
// ---------------------------------------------------------------------------

const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,  15,  16,   17,   18,   19,   20,
                              21, 22, 23, 24, 25, 26, 27, 28, 29, 30,  31,  32,  33,  34,   35,   37,   39,   41,
                              43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                            2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

const FseTable& default_table(int which) {
  static const FseTable* tables = [] {
    auto* t = new FseTable[3];
    build_fse(std::vector<int>(kLLDefault, kLLDefault + 36), 6, &t[0]);
    build_fse(std::vector<int>(kOFDefault, kOFDefault + 29), 5, &t[1]);
    build_fse(std::vector<int>(kMLDefault, kMLDefault + 53), 6, &t[2]);
    return t;
  }();
  return tables[which];
}

// ---------------------------------------------------------------------------
// The frame
// ---------------------------------------------------------------------------

struct Frame {
  std::vector<uint8_t> out;  // the frame's output so far (its whole history)
  size_t block_max = 0;
  Huffman huf;
  bool have_huf = false;
  bool huf_x2 = false;  // the table's decoder (libzstd keeps it for treeless blocks)
  FseTable tables[3];    // LL, OF, ML: built or RLE tables
  int mode[3] = {-1, -1, -1};  // the table in force: -1 none, 0 predefined, 1 built or RLE
  uint64_t rep[3] = {1, 4, 8};

  void literals(const uint8_t* src, size_t n, std::vector<uint8_t>* lit, size_t* used) {
    if (n < 2) fail(kCorrupt);  // MIN_CBLOCK_SIZE
    const int type = src[0] & 3, fmt = (src[0] >> 2) & 3;
    if (type < 2) {  // raw or RLE
      size_t hs, size;
      if (fmt == 0 || fmt == 2) {
        hs = 1;
        size = src[0] >> 3;
      } else if (fmt == 1) {
        hs = 2;
        size = le(src, 2) >> 4;
      } else {
        hs = 3;
        if (n < 3 + (type == 1 ? 1 : 0)) fail(kCorrupt);
        size = le(src, 3) >> 4;
      }
      if (size > block_max) fail(kCorrupt);
      if (type == 0) {
        if (hs + size > n) fail(kCorrupt);
        lit->assign(src + hs, src + hs + size);
        *used = hs + size;
      } else {
        if (hs + 1 > n) fail(kCorrupt);
        lit->assign(size, src[hs]);
        *used = hs + 1;
      }
      return;
    }
    if (n < 5) fail(kCorrupt);
    if (type == 3 && !have_huf) fail(kCorrupt);  // treeless without a previous table
    const uint64_t lhc = le(src, 5);
    size_t hs, size, csize;
    const bool single = fmt == 0;
    if (fmt < 2) {
      hs = 3;
      size = (lhc >> 4) & 0x3FF;
      csize = (lhc >> 14) & 0x3FF;
    } else if (fmt == 2) {
      hs = 4;
      size = (lhc >> 4) & 0x3FFF;
      csize = (lhc >> 18) & 0x3FFF;
    } else {
      hs = 5;
      size = (lhc >> 4) & 0x3FFFF;
      csize = (lhc >> 22) & 0x3FFFF;
    }
    if (size > block_max) fail(kCorrupt);
    if (!single && size < 6) fail(kCorrupt);
    if (csize + hs > n) fail(kCorrupt);
    const uint8_t* p = src + hs;
    size_t rest = csize;
    if (type == 2) {
      const size_t th = read_huffman(p, rest, &huf);
      if (th >= rest) fail(kCorrupt);
      p += th;
      rest -= th;
      have_huf = true;
      // a single stream's table is always X1 (HUF_decompress1X1_DCtx_wksp);
      // four streams' as HUF_selectDecoder picks
      huf_x2 = !single && huffman_x2(size, csize);
    }
    lit->resize(size);
    if (single) {
      huffman_stream(huf, p, static_cast<int64_t>(rest), lit->data(), size, huf_x2);
    } else {
      if (rest < 10) fail(kCorrupt);
      const size_t l1 = le(p, 2), l2 = le(p + 2, 2), l3 = le(p + 4, 2);
      if (l1 + l2 + l3 + 6 > rest) fail(kCorrupt);
      const size_t l4 = rest - 6 - l1 - l2 - l3;
      const size_t seg = (size + 3) / 4;
      if (seg * 3 > size) fail(kCorrupt);
      const uint8_t* s = p + 6;
      if (l1 >= 8 && l2 >= 8 && l3 >= 8 && l4 >= 8 && huf.max_bits <= 11) {
        const int64_t len[4] = {static_cast<int64_t>(l1), static_cast<int64_t>(l2), static_cast<int64_t>(l3),
                                static_cast<int64_t>(l4)};
        huffman_fast(huf, p, len, lit->data(), size, seg, huf_x2);
      } else {
        huffman_stream(huf, s, static_cast<int64_t>(l1), lit->data(), seg, huf_x2);
        huffman_stream(huf, s + l1, static_cast<int64_t>(l2), lit->data() + seg, seg, huf_x2);
        huffman_stream(huf, s + l1 + l2, static_cast<int64_t>(l3), lit->data() + 2 * seg, seg, huf_x2);
        huffman_stream(huf, s + l1 + l2 + l3, static_cast<int64_t>(l4), lit->data() + 3 * seg, size - 3 * seg,
                       huf_x2);
      }
    }
    *used = hs + csize;
  }

  // ZSTD_buildSeqTable for field k (0 LL, 1 OF, 2 ML) in mode m
  size_t seq_table(int k, int m, const uint8_t* src, size_t n) {
    static const int kMax[3] = {35, 31, 52}, kLog[3] = {9, 8, 9};
    switch (m) {
      case 0:  // predefined
        mode[k] = 0;
        return 0;
      case 1:  // RLE
        if (n < 1) fail(kCorrupt);
        if (src[0] > kMax[k]) fail(kCorrupt);
        rle_fse(src[0], &tables[k]);
        mode[k] = 1;
        return 1;
      case 2: {  // FSE-compressed
        std::vector<int> norm;
        int log;
        const size_t used = read_ncount(src, n, kMax[k], kLog[k], &norm, &log);
        build_fse(norm, log, &tables[k]);
        mode[k] = 1;
        return used;
      }
      default:  // repeat
        if (mode[k] < 0) fail(kCorrupt);
        return 0;
    }
  }
  const FseTable& table(int k) const { return mode[k] == 0 ? default_table(k) : tables[k]; }

  void compressed_block(const uint8_t* src, size_t n) {
    std::vector<uint8_t> lit;
    size_t used;
    literals(src, n, &lit, &used);
    const uint8_t* p = src + used;
    const uint8_t* end = src + n;
    if (p >= end) fail(kCorrupt);  // MIN_SEQUENCES_SIZE
    uint32_t nseq = *p++;
    if (nseq > 0x7F) {
      if (nseq == 0xFF) {
        if (end - p < 2) fail(kCorrupt);
        nseq = static_cast<uint32_t>(le(p, 2)) + 0x7F00;
        p += 2;
      } else {
        if (p >= end) fail(kCorrupt);
        nseq = ((nseq - 0x80) << 8) + *p++;
      }
    }
    const size_t start = out.size();
    if (nseq == 0) {
      if (p != end) fail(kCorrupt);
      out.insert(out.end(), lit.begin(), lit.end());
      return;
    }
    if (p >= end) fail(kCorrupt);
    const uint8_t modes = *p++;
    if (modes & 3) fail(kCorrupt);
    p += seq_table(0, modes >> 6, p, static_cast<size_t>(end - p));
    p += seq_table(1, (modes >> 4) & 3, p, static_cast<size_t>(end - p));
    p += seq_table(2, (modes >> 2) & 3, p, static_cast<size_t>(end - p));
    if (p > end) fail(kCorrupt);
    BackBits br;
    br.init(p, end - p);
    const FseTable &tl = table(0), &to = table(1), &tm = table(2);
    uint32_t sl = static_cast<uint32_t>(br.read(tl.log));
    uint32_t so = static_cast<uint32_t>(br.read(to.log));
    uint32_t sm = static_cast<uint32_t>(br.read(tm.log));
    size_t lit_pos = 0;
    // the block's bytes written in place after the history: at most
    // block_max of them (checked before each write)
    out.resize(start + block_max);
    uint8_t* o = out.data();
    size_t w = start;
    for (uint32_t i = 0; i < nseq; i++) {
      const int ll_code = tl.t[sl].symbol, of_code = to.t[so].symbol, ml_code = tm.t[sm].symbol;
      if (of_code > 31) fail(kCorrupt);
      const uint64_t of_value = (uint64_t{1} << of_code) + br.read(of_code);
      const uint64_t ml = kMLBase[ml_code] + br.read(kMLBits[ml_code]);
      const uint64_t ll = kLLBase[ll_code] + br.read(kLLBits[ll_code]);
      uint64_t offset;
      if (of_value > 3) {
        offset = of_value - 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      } else {
        const int idx = static_cast<int>(of_value) - 1 + (ll == 0);
        if (idx == 0) {
          offset = rep[0];
        } else {
          offset = idx == 3 ? rep[0] - 1 : rep[idx];
          if (offset == 0) offset = UINT64_MAX;  // libzstd: 0 is corrupt, caught below
          if (idx != 1) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = offset;
        }
      }
      if (i + 1 < nseq) {  // the states, LL, ML, then OF
        sl = tl.t[sl].base + static_cast<uint32_t>(br.read(tl.t[sl].bits));
        sm = tm.t[sm].base + static_cast<uint32_t>(br.read(tm.t[sm].bits));
        so = to.t[so].base + static_cast<uint32_t>(br.read(to.t[so].bits));
      }
      if (ll > lit.size() - lit_pos) fail(kCorrupt);
      if (w - start + ll + ml > block_max) fail(kCorrupt);
      memcpy(o + w, lit.data() + lit_pos, ll);
      lit_pos += ll;
      w += ll;
      if (offset > w) fail(kCorrupt);
      if (offset >= ml)
        memcpy(o + w, o + w - offset, ml);
      else
        for (size_t k = 0; k < ml; k++) o[w + k] = o[w - offset + k];
      w += ml;
    }
    if (!br.finished()) fail(kCorrupt);
    if (w - start + (lit.size() - lit_pos) > block_max) fail(kCorrupt);
    memcpy(o + w, lit.data() + lit_pos, lit.size() - lit_pos);
    out.resize(w + lit.size() - lit_pos);
  }
};

}  // namespace

extern "C" {

// Decode one strip or tile of TIFF ZSTD data into exactly cap bytes.
// Returns cap, or a negative code: -1 not a zstd frame, -2 corrupt data,
// -3 the frame or the data ends before the strip does (libtiff: "Not enough
// data"), -4 a frame that needs a dictionary, -5 a window above 2^27 + 1
// bytes, -6 a content checksum that does not match, -7 out of memory.
int64_t sfod_zstd_decode(const uint8_t* d, int64_t n64, uint8_t* out, int64_t cap) {
  const size_t n = static_cast<size_t>(n64);
  const size_t need = static_cast<size_t>(cap);
  Frame f;
  try {
    if (n < 4) fail(kShort);
    const uint32_t magic = static_cast<uint32_t>(le(d, 4));
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) fail(kShort);  // a skippable frame: libtiff stops after it
    if (magic != 0xFD2FB528u) fail(kNotZstd);
    if (n < 5) fail(kShort);
    const uint8_t fhd = d[4];
    if (fhd & 0x08) fail(kCorrupt);  // reserved bit
    const bool single = fhd & 0x20, checksum = fhd & 0x04;
    const int dict_bytes = (fhd & 3) == 3 ? 4 : fhd & 3;
    const int fcs_code = fhd >> 6;
    const int fcs_bytes = fcs_code == 0 ? (single ? 1 : 0) : 1 << fcs_code;
    const size_t header = 5 + !single + dict_bytes + fcs_bytes;
    if (n < header) fail(kShort);
    size_t pos = 5;
    uint64_t window = 0;
    if (!single) {
      const uint8_t wd = d[pos++];
      const int wlog = 10 + (wd >> 3);
      if (wlog > 31) fail(kWindow);
      window = uint64_t{1} << wlog;
      window += (window >> 3) * (wd & 7);
    }
    const uint64_t dict_id = le(d + pos, dict_bytes);
    pos += dict_bytes;
    uint64_t fcs = UINT64_MAX;
    if (fcs_bytes) {
      fcs = le(d + pos, fcs_bytes) + (fcs_bytes == 2 ? 256 : 0);
      pos += fcs_bytes;
    }
    if (single) window = fcs;
    if (dict_id != 0) fail(kDictionary);
    // libzstd decodes a frame whose content size fits the output in one
    // pass, where its window limit does not apply
    const bool one_pass = fcs != UINT64_MAX && fcs <= need;
    if (!one_pass && (window < 1024 ? 1024 : window) > (uint64_t{1} << 27) + 1) fail(kWindow);
    f.block_max = static_cast<size_t>(window < 131072 ? window : 131072);
    f.out.reserve(need + 131072);
    bool filled = false;  // the strip filled exactly at a block's end
    for (;;) {
      if (n - pos < 3) fail(kShort);
      const uint32_t bh = static_cast<uint32_t>(le(d + pos, 3));
      pos += 3;
      const bool last = bh & 1;
      const int type = (bh >> 1) & 3;
      const size_t size = bh >> 3;
      if (type == 3) fail(kCorrupt);
      if (size > f.block_max) fail(kCorrupt);
      if (type == 1) {  // RLE: one byte, size times
        if (n - pos < 1) fail(kShort);
        f.out.insert(f.out.end(), size, d[pos]);
        pos += 1;
      } else if (n - pos < size) {
        if (type == 0) f.out.insert(f.out.end(), d + pos, d + n);  // a raw block is handed out as it arrives
        fail(kShort);
      } else {
        if (type == 0)
          f.out.insert(f.out.end(), d + pos, d + pos + size);
        else
          f.compressed_block(d + pos, size);
        pos += size;
      }
      if (last && fcs != UINT64_MAX && f.out.size() != fcs) fail(kCorrupt);
      if (fcs != UINT64_MAX && f.out.size() > fcs && fcs <= f.block_max * 2 + window + 64) fail(kCorrupt);
      // a block whose bytes overrun the strip cannot be handed out whole:
      // libzstd stops there. One that fills it exactly is handed out, and
      // libzstd goes on to the next block
      if (f.out.size() > need) break;
      if (f.out.size() == need) filled = true;
      if (last) {
        if (checksum) {
          if (n - pos < 4) fail(kShort);
          if (static_cast<uint32_t>(xxh64(f.out.data(), f.out.size())) != le(d + pos, 4)) fail(kChecksum);
        }
        break;
      }
    }
    (void)filled;
    if (f.out.size() < need) fail(kShort);
    memcpy(out, f.out.data(), need);
    return cap;
  } catch (const Fail& e) {
    // input that runs out after the strip is full leaves libtiff content
    if (e.code == kShort && f.out.size() >= need) {
      memcpy(out, f.out.data(), need);
      return cap;
    }
    return e.code;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}

}  // extern "C"
