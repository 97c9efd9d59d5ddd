// TIFF's LZMA compression (34925): one .xz stream a strip or tile, decoded
// as libtiff's tif_lzma.c has liblzma decode it (lzma_stream_decoder with
// no flags, then lzma_code until the strip's bytes are out), after "The .xz
// File Format" 1.2.1 and liblzma 5.8's decoders:
//
//   stream   the 12-byte header (magic, flags, CRC32), then blocks; the
//            index marks the stream's end. libtiff stops once the strip's
//            bytes are out, and liblzma's later checks then no longer
//            matter (libtiff reads a failed lzma_code as a success when its
//            output is full). So the decoder stops there too: the index,
//            the footer and any concatenated stream are never reached by a
//            strip that is complete, and a strip that is not complete by
//            the stream's end fails either way ("Not enough data")
//   block    the header (size, flags, the optional compressed and
//            uncompressed sizes, up to four filters, zero padding, CRC32),
//            the data through the filter chain, padding to four bytes and
//            the check (None, CRC32, CRC64 or SHA-256; the other check IDs
//            are skipped by their size, as liblzma skips what it does not
//            know), each verified when a block ends before the strip does
//   LZMA2    lzma2_decoder.c: control bytes with their dictionary and
//            state resets and new properties, uncompressed chunks, the
//            chunk sizes held to what the LZMA decoder used
//   LZMA     lzma_decoder.c: the range decoder (normalised before each
//            bit, its first byte 0, finished with code 0 at each chunk's
//            end), literals at any lc/lp/pb that LZMA2 allows (lc + lp <=
//            4), matched literals, matches and the four repeated
//            distances, every distance held to the dictionary
//   Delta    delta_decoder.c, distance 1 to 256
//   BCJ      simple/*.c's decoders: x86, PowerPC, IA-64, ARM, ARM-Thumb,
//            SPARC, ARM64 and RISC-V, with the optional start offset. Each
//            gives the same bytes however its input is split, so the block's
//            output is filtered whole, decoded 16 bytes past the strip's end
//            where the block goes on (liblzma decodes ahead until a whole
//            instruction is in hand); a block's last bytes that make no
//            whole instruction pass unfiltered
//
// The non-last filters, up to three in any order, undo the chain in reverse.

#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

namespace {

enum Code {
  kNotXz = -1,       // no .xz magic (liblzma: LZMA_FORMAT_ERROR)
  kCorrupt = -2,     // LZMA_DATA_ERROR or LZMA_OPTIONS_ERROR
  kShort = -3,       // the stream or the data ends before the strip does
  kNoMemory = -5,
  kCheck = -6,       // a block's check does not match its data
};

struct Fail {
  int code;
};

[[noreturn]] void fail(int code) { throw Fail{code}; }

// ---------------------------------------------------------------------------
// Checks: CRC32 (IEEE, reflected), CRC64 (ECMA-182, reflected), SHA-256
// ---------------------------------------------------------------------------

struct CrcTables {
  uint32_t t32[256];
  uint64_t t64[256];
  CrcTables() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      uint64_t d = i;
      for (int k = 0; k < 8; k++) {
        c = c & 1 ? (c >> 1) ^ 0xEDB88320u : c >> 1;
        d = d & 1 ? (d >> 1) ^ 0xC96C5795D7870F42ull : d >> 1;
      }
      t32[i] = c;
      t64[i] = d;
    }
  }
};

const CrcTables& crc_tables() {
  static const CrcTables t;
  return t;
}

uint32_t crc32(const uint8_t* p, size_t n) {
  const auto& t = crc_tables().t32;
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++) c = t[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return ~c;
}

uint64_t crc64(const uint8_t* p, size_t n) {
  const auto& t = crc_tables().t64;
  uint64_t c = ~0ull;
  for (size_t i = 0; i < n; i++) c = t[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return ~c;
}

void sha256(const uint8_t* p, size_t n, uint8_t digest[32]) {
  static const uint32_t k[64] = {
      0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
      0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174,
      0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
      0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967,
      0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13, 0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
      0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
      0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
      0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208, 0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};
  uint32_t h[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a, 0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  auto rotr = [](uint32_t x, int r) { return (x >> r) | (x << (32 - r)); };
  auto block = [&](const uint8_t* b) {
    uint32_t w[64];
    for (int i = 0; i < 16; i++)
      w[i] = (uint32_t{b[4 * i]} << 24) | (uint32_t{b[4 * i + 1]} << 16) | (uint32_t{b[4 * i + 2]} << 8) | b[4 * i + 3];
    for (int i = 16; i < 64; i++) {
      const uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
      const uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], bb = h[1], c = h[2], d = h[3], e = h[4], f = h[5], g = h[6], hh = h[7];
    for (int i = 0; i < 64; i++) {
      const uint32_t t1 = hh + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) + ((e & f) ^ (~e & g)) + k[i] + w[i];
      const uint32_t t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) + ((a & bb) ^ (a & c) ^ (bb & c));
      hh = g, g = f, f = e, e = d + t1, d = c, c = bb, bb = a, a = t1 + t2;
    }
    h[0] += a, h[1] += bb, h[2] += c, h[3] += d, h[4] += e, h[5] += f, h[6] += g, h[7] += hh;
  };
  size_t i = 0;
  for (; i + 64 <= n; i += 64) block(p + i);
  uint8_t tail[128] = {};
  const size_t rest = n - i;
  memcpy(tail, p + i, rest);
  tail[rest] = 0x80;
  const size_t len = rest + 9 <= 64 ? 64 : 128;
  const uint64_t bits = static_cast<uint64_t>(n) * 8;
  for (int b = 0; b < 8; b++) tail[len - 1 - b] = static_cast<uint8_t>(bits >> (8 * b));
  block(tail);
  if (len == 128) block(tail + 64);
  for (int j = 0; j < 8; j++)
    for (int b = 0; b < 4; b++) digest[4 * j + b] = static_cast<uint8_t>(h[j] >> (24 - 8 * b));
}

uint32_t le32(const uint8_t* p) {
  return uint32_t{p[0]} | (uint32_t{p[1]} << 8) | (uint32_t{p[2]} << 16) | (uint32_t{p[3]} << 24);
}

// ---------------------------------------------------------------------------
// LZMA (lzma_decoder.c) over a dictionary that is the block's whole output
// ---------------------------------------------------------------------------

constexpr int kStates = 12, kPosStatesMax = 16, kProbInit = 1024;
constexpr int kLenLowBits = 3, kLenMidBits = 3, kLenHighBits = 8;
constexpr int kMatchLenMin = 2;
constexpr int kDistStates = 4, kDistSlots = 64, kDistModelStart = 4, kDistModelEnd = 14;
constexpr int kFullDistances = 1 << (kDistModelEnd / 2), kAlignBits = 4;

struct LenCoder {
  uint16_t choice, choice2;
  uint16_t low[kPosStatesMax][1 << kLenLowBits];
  uint16_t mid[kPosStatesMax][1 << kLenMidBits];
  uint16_t high[1 << kLenHighBits];
};

// the block's input [p, end) read by the range decoder; `exhausted` ends the
// decode: the strip cannot be completed from what is there
struct Input {
  const uint8_t* d;
  size_t pos, end;
};

struct Lzma2 {
  // the dictionary: every byte the block has produced since the last
  // dictionary reset starts at dict_start
  uint8_t* buf = nullptr;  // the block's LZMA2 output (before Delta), `limit` bytes
  size_t op = 0;           // the bytes of it written
  size_t limit = 0;        // how far op may grow (the strip's need)
  size_t dict_start = 0;
  uint32_t dict_size = 0;

  // range decoder
  uint32_t range = 0, code = 0;
  // LZMA state
  int lc = 0, lp = 0, pb = 0;
  int state = 0;
  uint32_t rep[4] = {0, 0, 0, 0};
  std::vector<uint16_t> literal;
  uint16_t is_match[kStates][kPosStatesMax], is_rep[kStates], is_rep0[kStates], is_rep1[kStates],
      is_rep2[kStates], is_rep0_long[kStates][kPosStatesMax];
  uint16_t dist_slot[kDistStates][kDistSlots];
  uint16_t dist_special[kFullDistances - kDistModelEnd];
  uint16_t dist_align[1 << kAlignBits];
  LenCoder match_len, rep_len;
  // a match cut by the strip's end: how much of it is still to copy
  uint32_t pending = 0;

  Input* in = nullptr;

  void reset_state() {
    literal.assign(static_cast<size_t>(0x300) << (lc + lp), kProbInit);
    auto fill = [](uint16_t* p, size_t count) { std::fill(p, p + count, static_cast<uint16_t>(kProbInit)); };
    fill(&is_match[0][0], sizeof(is_match) / 2);
    fill(is_rep, kStates);
    fill(is_rep0, kStates);
    fill(is_rep1, kStates);
    fill(is_rep2, kStates);
    fill(&is_rep0_long[0][0], sizeof(is_rep0_long) / 2);
    fill(&dist_slot[0][0], sizeof(dist_slot) / 2);
    fill(dist_special, sizeof(dist_special) / 2);
    fill(dist_align, sizeof(dist_align) / 2);
    fill(reinterpret_cast<uint16_t*>(&match_len), sizeof(LenCoder) / 2);
    fill(reinterpret_cast<uint16_t*>(&rep_len), sizeof(LenCoder) / 2);
    state = 0;
    rep[0] = rep[1] = rep[2] = rep[3] = 0;
  }

  size_t full() const {
    const size_t f = op - dict_start;
    return f < dict_size ? f : dict_size;
  }

  // rc_normalize, before every bit as liblzma does it
  void normalize() {
    if (range < (1u << 24)) {
      if (in->pos >= in->end) fail(kShort);
      range <<= 8;
      code = (code << 8) | in->d[in->pos++];
    }
  }
  int bit(uint16_t* p) {
    normalize();
    const uint32_t bound = (range >> 11) * *p;
    if (code < bound) {
      range = bound;
      *p += static_cast<uint16_t>((2048 - *p) >> 5);
      return 0;
    }
    range -= bound;
    code -= bound;
    *p -= static_cast<uint16_t>(*p >> 5);
    return 1;
  }
  uint32_t tree(uint16_t* probs, int bits) {
    uint32_t m = 1;
    for (int i = 0; i < bits; i++) m = (m << 1) | bit(&probs[m]);
    return m - (1u << bits);
  }
  uint32_t reverse_tree(uint16_t* probs, int bits) {
    uint32_t m = 1, sym = 0;
    for (int i = 0; i < bits; i++) {
      const int b = bit(&probs[m]);
      m = (m << 1) | b;
      sym |= static_cast<uint32_t>(b) << i;
    }
    return sym;
  }
  uint32_t direct(int bits) {
    uint32_t v = 0;
    for (int i = 0; i < bits; i++) {
      normalize();
      range >>= 1;
      const uint32_t t = code >= range;
      if (t) code -= range;
      v = (v << 1) | t;
    }
    return v;
  }
  uint32_t length(LenCoder& lc_, int pos_state) {
    if (!bit(&lc_.choice)) return kMatchLenMin + tree(lc_.low[pos_state], kLenLowBits);
    if (!bit(&lc_.choice2)) return kMatchLenMin + 8 + tree(lc_.mid[pos_state], kLenMidBits);
    return kMatchLenMin + 16 + tree(lc_.high, kLenHighBits);
  }

  uint8_t back(uint32_t dist) const { return buf[op - dist - 1]; }

  // copy `len` bytes from distance dist, stopping at the chunk's end `stop`
  void copy(uint32_t dist, uint32_t len, size_t stop) {
    const size_t n = stop - op < len ? stop - op : len;
    const uint8_t* from = buf + op - dist - 1;
    uint8_t* to = buf + op;
    if (dist + 1 >= n)
      memcpy(to, from, n);
    else
      for (size_t i = 0; i < n; i++) to[i] = from[i];
    op += n;
    pending = len - static_cast<uint32_t>(n);
  }

  // one LZMA chunk: decode until buf reaches `chunk_end` (the chunk's
  // uncompressed end) or the strip's limit; returns true when the chunk is
  // complete (and checks the range decoder finished at code 0)
  bool chunk(size_t chunk_end) {
    const size_t stop = chunk_end < limit ? chunk_end : limit;
    if (pending) copy(rep[0], pending, stop);
    const uint32_t pos_mask = (1u << pb) - 1;
    while (op < stop) {
      const size_t pos = op - dict_start;
      const uint32_t ps = static_cast<uint32_t>(pos) & pos_mask;
      if (!bit(&is_match[state][ps])) {
        const uint32_t prev = pos ? buf[op - 1] : 0;
        uint16_t* probs = &literal[0x300 * (((pos & ((1u << lp) - 1)) << lc) + (prev >> (8 - lc)))];
        uint32_t sym = 1;
        if (state < 7) {
          while (sym < 0x100) sym = (sym << 1) | bit(&probs[sym]);
        } else {
          uint32_t match_byte = back(rep[0]);
          uint32_t offset = 0x100;
          while (sym < 0x100) {
            match_byte <<= 1;
            const uint32_t match_bit = match_byte & offset;
            const uint32_t i = offset + match_bit + sym;
            const int bt = bit(&probs[i]);
            sym = (sym << 1) | bt;
            offset &= bt ? match_bit : ~match_bit;
          }
        }
        buf[op++] = static_cast<uint8_t>(sym);
        state = state < 4 ? 0 : state < 10 ? state - 3 : state - 6;
        continue;
      }
      uint32_t len;
      if (bit(&is_rep[state])) {
        if (full() == 0) fail(kCorrupt);  // a repeated match in an empty dictionary
        if (!bit(&is_rep0[state])) {
          if (!bit(&is_rep0_long[state][ps])) {  // short rep: one byte at rep0
            state = state < 7 ? 9 : 11;
            buf[op] = back(rep[0]);
            op++;
            continue;
          }
        } else {
          uint32_t dist;
          if (!bit(&is_rep1[state])) {
            dist = rep[1];
          } else {
            if (!bit(&is_rep2[state])) {
              dist = rep[2];
            } else {
              dist = rep[3];
              rep[3] = rep[2];
            }
            rep[2] = rep[1];
          }
          rep[1] = rep[0];
          rep[0] = dist;
        }
        state = state < 7 ? 8 : 11;
        len = length(rep_len, ps);
      } else {
        rep[3] = rep[2];
        rep[2] = rep[1];
        rep[1] = rep[0];
        len = length(match_len, ps);
        state = state < 7 ? 7 : 10;
        const uint32_t ds = len - kMatchLenMin < kDistStates - 1 ? len - kMatchLenMin : kDistStates - 1;
        const uint32_t slot = tree(dist_slot[ds], 6);
        if (slot < kDistModelStart) {
          rep[0] = slot;
        } else {
          const int limit_bits = static_cast<int>(slot >> 1) - 1;
          uint32_t dist = (2 | (slot & 1)) << limit_bits;
          if (slot < kDistModelEnd) {
            dist += reverse_tree(dist_special + dist - slot - 1, limit_bits) ;
          } else {
            dist += direct(limit_bits - kAlignBits) << kAlignBits;
            dist += reverse_tree(dist_align, kAlignBits);
          }
          rep[0] = dist;
        }
      }
      // rep0 == UINT32_MAX is the end-of-payload marker, which LZMA2 does
      // not allow; it fails the distance test below as liblzma fails it
      if (rep[0] >= full()) fail(kCorrupt);
      copy(rep[0], len, stop);
    }
    if (op < chunk_end) return false;  // the strip's limit came first
    if (pending) fail(kCorrupt);  // a match runs past the chunk's end
    normalize();
    if (code != 0) fail(kCorrupt);
    return true;
  }
};

// reverse_tree over dist_special needs 1-based indexing from the slot's base
// (liblzma: probs = dist_special + dist - slot - 1, bits walked from m = 1)

// lzma_vli_decode over a bounded buffer
bool vli(const uint8_t* p, size_t end, size_t* pos, uint64_t* out) {
  uint64_t v = 0;
  for (int i = 0; i < 9; i++) {
    if (*pos >= end) return false;
    const uint8_t b = p[(*pos)++];
    v |= static_cast<uint64_t>(b & 0x7F) << (7 * i);
    if (!(b & 0x80)) {
      if (i > 0 && b == 0) return false;  // not the shortest form
      *out = v;
      return true;
    }
  }
  return false;
}

const int kCheckSizes[16] = {0, 4, 4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 32, 64, 64, 64};

// ---------------------------------------------------------------------------
// The BCJ filters (liblzma's simple/*.c), decoding a block's whole output
// that starts at stream position `pos` (the filter's start offset)
// ---------------------------------------------------------------------------

uint32_t rd32le(const uint8_t* p) { return le32(p); }
uint32_t rd32be(const uint8_t* p) {
  return (uint32_t{p[0]} << 24) | (uint32_t{p[1]} << 16) | (uint32_t{p[2]} << 8) | uint32_t{p[3]};
}
void wr32le(uint8_t* p, uint32_t v) {
  for (int i = 0; i < 4; i++) p[i] = static_cast<uint8_t>(v >> (8 * i));
}

void bcj_x86(uint32_t pos, uint8_t* b, size_t size) {
  static const bool kAllowed[8] = {true, true, true, false, true, false, false, false};
  static const uint32_t kBit[8] = {0, 1, 2, 2, 3, 3, 3, 3};
  auto ms_byte = [](uint32_t v) { return ((v + 1) & 0xFE) == 0; };
  if (size < 5) return;
  uint32_t prev_mask = 0, prev_pos = pos - 5;
  for (size_t i = 0; i <= size - 5;) {
    if (b[i] != 0xE8 && b[i] != 0xE9) {
      i++;
      continue;
    }
    const uint32_t offset = pos + static_cast<uint32_t>(i) - prev_pos;
    prev_pos = pos + static_cast<uint32_t>(i);
    if (offset > 5) {
      prev_mask = 0;
    } else {
      for (uint32_t k = 0; k < offset; k++) prev_mask = (prev_mask & 0x77) << 1;
    }
    uint32_t hi = b[i + 4];
    if (ms_byte(hi) && kAllowed[(prev_mask >> 1) & 7] && (prev_mask >> 1) < 0x10) {
      uint32_t src = (hi << 24) | (uint32_t{b[i + 3]} << 16) | (uint32_t{b[i + 2]} << 8) | b[i + 1], dest;
      for (;;) {
        dest = src - (pos + static_cast<uint32_t>(i) + 5);
        if (prev_mask == 0) break;
        const uint32_t k = kBit[prev_mask >> 1];
        if (!ms_byte((dest >> (24 - k * 8)) & 0xFF)) break;
        src = dest ^ ((1u << (32 - k * 8)) - 1);
      }
      b[i + 4] = static_cast<uint8_t>(~(((dest >> 24) & 1) - 1));
      b[i + 3] = static_cast<uint8_t>(dest >> 16);
      b[i + 2] = static_cast<uint8_t>(dest >> 8);
      b[i + 1] = static_cast<uint8_t>(dest);
      i += 5;
      prev_mask = 0;
    } else {
      i++;
      prev_mask |= 1;
      if (ms_byte(hi)) prev_mask |= 0x10;
    }
  }
}

void bcj_powerpc(uint32_t pos, uint8_t* b, size_t size) {
  for (size_t i = 0; i + 4 <= size; i += 4) {
    if ((b[i] >> 2) != 0x12 || (b[i + 3] & 3) != 1) continue;
    const uint32_t src = ((uint32_t{b[i]} & 3) << 24) | (uint32_t{b[i + 1]} << 16) | (uint32_t{b[i + 2]} << 8) |
                         (uint32_t{b[i + 3]} & ~3u);
    const uint32_t dest = src - (pos + static_cast<uint32_t>(i));
    b[i] = static_cast<uint8_t>(0x48 | ((dest >> 24) & 3));
    b[i + 1] = static_cast<uint8_t>(dest >> 16);
    b[i + 2] = static_cast<uint8_t>(dest >> 8);
    b[i + 3] = static_cast<uint8_t>((b[i + 3] & 3) | (dest & 0xFF & ~3u));
  }
}

void bcj_ia64(uint32_t pos, uint8_t* b, size_t size) {
  static const uint32_t kBranch[32] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                       4, 4, 6, 6, 0, 0, 7, 7, 4, 4, 0, 0, 4, 4, 0, 0};
  for (size_t i = 0; i + 16 <= size; i += 16) {
    const uint32_t mask = kBranch[b[i] & 0x1F];
    for (uint32_t slot = 0, bit_pos = 5; slot < 3; slot++, bit_pos += 41) {
      if (!((mask >> slot) & 1)) continue;
      const size_t at = i + (bit_pos >> 3);
      const uint32_t res = bit_pos & 7;
      uint64_t ins = 0;
      for (int j = 0; j < 6; j++) ins |= static_cast<uint64_t>(b[at + j]) << (8 * j);
      uint64_t norm = ins >> res;
      if (((norm >> 37) & 0xF) != 0x5 || ((norm >> 9) & 0x7) != 0) continue;
      uint32_t src = static_cast<uint32_t>((norm >> 13) & 0xFFFFF);
      src |= static_cast<uint32_t>((norm >> 36) & 1) << 20;
      src <<= 4;
      uint32_t dest = src - (pos + static_cast<uint32_t>(i));
      dest >>= 4;
      norm &= ~(static_cast<uint64_t>(0x8FFFFF) << 13);
      norm |= static_cast<uint64_t>(dest & 0xFFFFF) << 13;
      norm |= static_cast<uint64_t>(dest & 0x100000) << (36 - 20);
      ins &= (uint64_t{1} << res) - 1;
      ins |= norm << res;
      for (int j = 0; j < 6; j++) b[at + j] = static_cast<uint8_t>(ins >> (8 * j));
    }
  }
}

void bcj_arm(uint32_t pos, uint8_t* b, size_t size) {
  for (size_t i = 0; i + 4 <= size; i += 4) {
    if (b[i + 3] != 0xEB) continue;
    const uint32_t src = ((uint32_t{b[i + 2]} << 16) | (uint32_t{b[i + 1]} << 8) | b[i]) << 2;
    const uint32_t dest = (src - (pos + static_cast<uint32_t>(i) + 8)) >> 2;
    b[i + 2] = static_cast<uint8_t>(dest >> 16);
    b[i + 1] = static_cast<uint8_t>(dest >> 8);
    b[i] = static_cast<uint8_t>(dest);
  }
}

void bcj_armthumb(uint32_t pos, uint8_t* b, size_t size) {
  for (size_t i = 0; i + 4 <= size; i += 2) {
    if ((b[i + 1] & 0xF8) != 0xF0 || (b[i + 3] & 0xF8) != 0xF8) continue;
    const uint32_t src = (((uint32_t{b[i + 1]} & 7) << 19) | (uint32_t{b[i]} << 11) | ((uint32_t{b[i + 3]} & 7) << 8) |
                          b[i + 2]) << 1;
    const uint32_t dest = (src - (pos + static_cast<uint32_t>(i) + 4)) >> 1;
    b[i + 1] = static_cast<uint8_t>(0xF0 | ((dest >> 19) & 7));
    b[i] = static_cast<uint8_t>(dest >> 11);
    b[i + 3] = static_cast<uint8_t>(0xF8 | ((dest >> 8) & 7));
    b[i + 2] = static_cast<uint8_t>(dest);
    i += 2;
  }
}

void bcj_sparc(uint32_t pos, uint8_t* b, size_t size) {
  for (size_t i = 0; i + 4 <= size; i += 4) {
    if (!((b[i] == 0x40 && (b[i + 1] & 0xC0) == 0) || (b[i] == 0x7F && (b[i + 1] & 0xC0) == 0xC0))) continue;
    const uint32_t src = rd32be(b + i) << 2;
    uint32_t dest = (src - (pos + static_cast<uint32_t>(i))) >> 2;
    dest = (((0 - ((dest >> 22) & 1)) << 22) & 0x3FFFFFFF) | (dest & 0x3FFFFF) | 0x40000000;
    for (int k = 0; k < 4; k++) b[i + k] = static_cast<uint8_t>(dest >> (24 - 8 * k));
  }
}

void bcj_arm64(uint32_t pos, uint8_t* b, size_t size) {
  for (size_t i = 0; i + 4 <= size; i += 4) {
    uint32_t pc = pos + static_cast<uint32_t>(i);
    uint32_t ins = rd32le(b + i);
    if ((ins >> 26) == 0x25) {  // BL
      pc = 0u - (pc >> 2);
      wr32le(b + i, 0x94000000u | ((ins + pc) & 0x03FFFFFF));
    } else if ((ins & 0x9F000000u) == 0x90000000u) {  // ADRP
      const uint32_t src = ((ins >> 29) & 3) | ((ins >> 3) & 0x001FFFFC);
      if ((src + 0x00020000) & 0x001C0000) continue;
      pc = 0u - (pc >> 12);
      const uint32_t dest = src + pc;
      ins &= 0x9000001Fu;
      ins |= (dest & 3) << 29;
      ins |= (dest & 0x0003FFFC) << 3;
      ins |= (0u - (dest & 0x00020000)) & 0x00E00000;
      wr32le(b + i, ins);
    }
  }
}

void bcj_riscv(uint32_t pos, uint8_t* b, size_t size) {
  if (size < 8) return;
  for (size_t i = 0; i <= size - 8; i += 2) {
    uint32_t ins = b[i];
    if (ins == 0xEF) {  // JAL
      const uint32_t b1 = b[i + 1];
      if (b1 & 0x0D) continue;
      const uint32_t b2 = b[i + 2], b3 = b[i + 3];
      uint32_t addr = ((b1 & 0xF0) << 13) | (b2 << 9) | (b3 << 1);
      addr -= pos + static_cast<uint32_t>(i);
      b[i + 1] = static_cast<uint8_t>((b1 & 0x0F) | ((addr >> 8) & 0xF0));
      b[i + 2] = static_cast<uint8_t>(((addr >> 16) & 0x0F) | ((addr >> 7) & 0x10) | ((addr << 4) & 0xE0));
      b[i + 3] = static_cast<uint8_t>(((addr >> 4) & 0x7F) | ((addr >> 13) & 0x80));
      i += 4 - 2;
    } else if ((ins & 0x7F) == 0x17) {  // AUIPC
      ins |= uint32_t{b[i + 1]} << 8 | uint32_t{b[i + 2]} << 16 | uint32_t{b[i + 3]} << 24;
      uint32_t ins2;
      if (ins & 0xE80) {  // rd is not x0 or x2: a "fake" pair, or nothing
        ins2 = rd32le(b + i + 4);
        if (((ins << 8) ^ (ins2 - 3)) & 0xF8003) {
          i += 6 - 2;
          continue;
        }
        const uint32_t addr = (ins & 0xFFFFF000) + (ins2 >> 20);
        ins = 0x17 | (2 << 7) | (ins2 << 12);
        ins2 = addr;
      } else {  // rd is x0 or x2: a real pair, or nothing
        const uint32_t rs1 = ins >> 27;
        if (static_cast<uint32_t>(ins - 0x3117) << 18 >= (rs1 & 0x1D)) {
          i += 4 - 2;
          continue;
        }
        uint32_t addr = rd32be(b + i + 4);
        addr -= pos + static_cast<uint32_t>(i);
        ins2 = (ins >> 12) | (addr << 20);
        ins = 0x17 | (rs1 << 7) | ((addr + 0x800) & 0xFFFFF000);
      }
      wr32le(b + i, ins);
      wr32le(b + i + 4, ins2);
      i += 8 - 2;
    }
  }
}

// a non-last filter: its ID and its property (Delta's distance, a BCJ
// filter's start offset)
struct Filter {
  int id;
  uint32_t prop;
};

// undo one filter over a block's whole output
void unfilter(const Filter& f, uint8_t* b, size_t size) {
  switch (f.id) {
    case 0x03:
      for (size_t i = f.prop; i < size; i++) b[i] = static_cast<uint8_t>(b[i] + b[i - f.prop]);
      break;
    case 0x04: bcj_x86(f.prop, b, size); break;
    case 0x05: bcj_powerpc(f.prop, b, size); break;
    case 0x06: bcj_ia64(f.prop, b, size); break;
    case 0x07: bcj_arm(f.prop, b, size); break;
    case 0x08: bcj_armthumb(f.prop, b, size); break;
    case 0x09: bcj_sparc(f.prop, b, size); break;
    case 0x0A: bcj_arm64(f.prop, b, size); break;
    default: bcj_riscv(f.prop, b, size);
  }
}

struct Block {
  uint64_t compressed = UINT64_MAX, uncompressed = UINT64_MAX;
  Filter chain[3];  // the non-last filters, in the header's order
  int filters = 0;
  bool bcj = false;  // a BCJ filter among them
  uint32_t dict_size = 0;
  size_t data = 0;  // where the compressed data starts
};

Block block_header(const uint8_t* d, size_t n, size_t pos) {
  Block blk;
  const size_t size = (static_cast<size_t>(d[pos]) + 1) * 4;
  if (pos + size > n) fail(kShort);
  const uint8_t* h = d + pos;
  if (crc32(h, size - 4) != le32(h + size - 4)) fail(kCorrupt);
  if (h[1] & 0x3C) fail(kCorrupt);
  const size_t end = size - 4;
  size_t p = 2;
  if (h[1] & 0x40) {
    if (!vli(h, end, &p, &blk.compressed) || blk.compressed == 0) fail(kCorrupt);
  }
  if (h[1] & 0x80) {
    if (!vli(h, end, &p, &blk.uncompressed)) fail(kCorrupt);
  }
  const int filters = (h[1] & 3) + 1;
  bool lzma2 = false;
  for (int i = 0; i < filters; i++) {
    uint64_t id, props;
    if (!vli(h, end, &p, &id) || !vli(h, end, &p, &props) || props > end - p) fail(kCorrupt);
    const uint8_t* pr = h + p;
    p += props;
    const bool last = i == filters - 1;
    if (id == 0x21) {  // LZMA2: the last filter, one property byte
      if (!last || props != 1 || pr[0] > 40) fail(kCorrupt);
      blk.dict_size = pr[0] == 40 ? UINT32_MAX : (2u | (pr[0] & 1u)) << (pr[0] / 2 + 11);
      lzma2 = true;
    } else if (id == 0x03) {  // Delta: one property byte, distance - 1
      if (last || props != 1) fail(kCorrupt);
      blk.chain[blk.filters++] = Filter{3, pr[0] + 1u};
    } else if (id >= 0x04 && id <= 0x0B) {  // BCJ: no properties, or a 4-byte start offset
      if (last || (props != 0 && props != 4)) fail(kCorrupt);
      blk.chain[blk.filters++] = Filter{static_cast<int>(id), props ? le32(pr) : 0u};
      blk.bcj = true;
    } else {
      fail(kCorrupt);  // liblzma: LZMA_OPTIONS_ERROR
    }
  }
  if (!lzma2) fail(kCorrupt);
  for (; p < end; p++)
    if (h[p]) fail(kCorrupt);
  blk.data = pos + size;
  return blk;
}

// one block: its data into out[*produced ..], at most cap bytes in all;
// returns the position after the block, or 0 when the strip is complete
size_t block(const uint8_t* d, size_t n, size_t pos, int check, uint8_t* out, int64_t cap, int64_t* produced) {
  const Block blk = block_header(d, n, pos);
  const size_t need = static_cast<size_t>(cap - *produced);
  const size_t want = need + (blk.bcj ? 16 : 0);  // a BCJ filter's look-ahead
  size_t limit = want;
  if (blk.uncompressed != UINT64_MAX && blk.uncompressed < limit) limit = static_cast<size_t>(blk.uncompressed);
  Input in{d, blk.data, n};
  if (blk.compressed != UINT64_MAX && blk.compressed < n - blk.data) in.end = blk.data + blk.compressed;
  std::vector<uint8_t> buf(limit);
  Lzma2 z;
  z.buf = buf.data();
  z.limit = limit;
  z.in = &in;
  z.dict_size = blk.dict_size < 4096 ? 4096 : (blk.dict_size + 15) & ~15u;
  bool need_dict_reset = true, need_props = true, ended = false;
  auto emit = [&]() {  // the block's output so far through the other filters into out
    for (int i = blk.filters - 1; i >= 0; i--) unfilter(blk.chain[i], buf.data(), z.op);
    const size_t n = z.op < need ? z.op : need;
    memcpy(out + *produced, buf.data(), n);
    *produced += static_cast<int64_t>(n);
  };
  try {
    while (!ended) {
      if (z.op >= want) break;
      if (in.pos >= in.end) fail(kShort);
      const uint32_t control = d[in.pos++];
      if (control == 0) {
        ended = true;
        break;
      }
      if (control >= 0xE0 || control == 1) {
        need_props = true;
        need_dict_reset = true;
      } else if (need_dict_reset) {
        fail(kCorrupt);
      }
      if (need_dict_reset) {
        need_dict_reset = false;
        z.dict_start = z.op;
        z.pending = 0;
      }
      if (control >= 0x80) {
        if (in.end - in.pos < 4) fail(kShort);
        const uint32_t usize = ((control & 0x1F) << 16) + (uint32_t{d[in.pos]} << 8) + d[in.pos + 1] + 1;
        const uint32_t csize = (uint32_t{d[in.pos + 2]} << 8) + d[in.pos + 3] + 1;
        in.pos += 4;
        if (control >= 0xC0) {
          if (in.pos >= in.end) fail(kShort);
          uint32_t props = d[in.pos++];
          if (props > (4 * 5 + 4) * 9 + 8) fail(kCorrupt);
          z.pb = static_cast<int>(props / 45);
          props -= static_cast<uint32_t>(z.pb) * 45;
          z.lp = static_cast<int>(props / 9);
          z.lc = static_cast<int>(props - static_cast<uint32_t>(z.lp) * 9);
          if (z.lc + z.lp > 4) fail(kCorrupt);
          need_props = false;
          z.reset_state();
        } else if (need_props) {
          fail(kCorrupt);
        } else if (control >= 0xA0) {
          z.reset_state();
        }
        z.pending = 0;
        // the range decoder's five init bytes, the first of them 0
        const size_t start = in.pos;
        if (in.pos >= in.end) fail(kShort);
        if (d[in.pos] != 0) fail(kCorrupt);
        if (in.end - in.pos < 5) fail(kShort);
        z.code = 0;
        for (int i = 0; i < 5; i++) z.code = (z.code << 8) | d[in.pos++];
        z.range = 0xFFFFFFFFu;
        const size_t chunk_end = z.op + usize;
        if (!z.chunk(chunk_end)) break;  // the strip's bytes are out
        if (in.pos - start != csize) fail(kCorrupt);
      } else {  // an uncompressed chunk
        if (control > 2) fail(kCorrupt);
        if (in.end - in.pos < 2) fail(kShort);
        const uint32_t csize = (uint32_t{d[in.pos]} << 8) + d[in.pos + 1] + 1;
        in.pos += 2;
        const size_t room = z.limit - z.op;
        const size_t take = csize < room ? csize : room;
        const size_t have = in.end - in.pos < take ? in.end - in.pos : take;
        memcpy(buf.data() + z.op, d + in.pos, have);
        z.op += have;
        in.pos += have;
        if (have < take) fail(kShort);
        if (take < csize) break;  // the strip's bytes are out
      }
    }
  } catch (const Fail& f) {
    emit();
    if (*produced >= cap) return 0;
    throw;
  }
  emit();
  if (*produced >= cap) return 0;
  if (!ended) fail(kCorrupt);  // the block's uncompressed size came before its end marker
  // the sizes the header gives, padding, the check
  const uint64_t comp = in.pos - blk.data;
  if ((blk.compressed != UINT64_MAX && comp != blk.compressed) ||
      (blk.uncompressed != UINT64_MAX && z.op != blk.uncompressed))
    fail(kCorrupt);
  size_t p = in.pos;
  for (uint64_t c = comp; c & 3; c++) {
    if (p >= n) fail(kShort);
    if (d[p++]) fail(kCorrupt);
  }
  const size_t cs = static_cast<size_t>(kCheckSizes[check]);
  if (p + cs > n) fail(kShort);
  const uint8_t* data = out + (*produced - static_cast<int64_t>(z.op));
  if (check == 1 && crc32(data, z.op) != le32(d + p)) fail(kCheck);
  if (check == 4) {
    const uint64_t c = crc64(data, z.op);
    for (int i = 0; i < 8; i++)
      if (d[p + i] != static_cast<uint8_t>(c >> (8 * i))) fail(kCheck);
  }
  if (check == 10) {
    uint8_t dg[32];
    sha256(data, z.op, dg);
    if (memcmp(dg, d + p, 32) != 0) fail(kCheck);
  }
  return p + cs;
}

}  // namespace

extern "C" {

// Decode one strip or tile of TIFF LZMA data (an .xz stream) into exactly
// cap bytes. Returns cap, or a negative code: -1 not an .xz stream, -2
// corrupt data or options liblzma refuses, -3 the stream or the data ends
// before the strip does (libtiff: "Not enough data"), -5 out of memory,
// -6 a block's check does not match.
int64_t sfod_xz_decode(const uint8_t* d, int64_t n64, uint8_t* out, int64_t cap) {
  const size_t n = static_cast<size_t>(n64);
  int64_t produced = 0;
  try {
    static const uint8_t kMagic[6] = {0xFD, '7', 'z', 'X', 'Z', 0};
    if (n < 12) fail(n < 6 || memcmp(d, kMagic, n < 6 ? n : 6) == 0 ? kShort : kNotXz);
    if (memcmp(d, kMagic, 6) != 0) fail(kNotXz);
    if (crc32(d + 6, 2) != le32(d + 8)) fail(kCorrupt);
    if (d[6] != 0 || (d[7] & 0xF0)) fail(kCorrupt);
    const int check = d[7] & 0x0F;
    size_t pos = 12;
    while (produced < cap) {
      if (pos >= n) fail(kShort);
      if (d[pos] == 0) fail(kShort);  // the index: the stream ends here
      pos = block(d, n, pos, check, out, cap, &produced);
      if (pos == 0) break;
    }
    return cap;
  } catch (const Fail& f) {
    return produced >= cap ? cap : f.code;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}

}  // extern "C"
