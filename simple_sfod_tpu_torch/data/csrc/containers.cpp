// The sequential codecs of the image containers that the port reads beside
// PNG and JPEG (data/native_codec.py parses the containers and maps the
// samples to RGB; these loops are the part that cannot be vectorised):
//
//   sfod_gif_lzw   GIF's LZW (GifDecode.c in Pillow): codes LSB first, from
//                  the minimum code size + 1 bits up to 12, clear and end
//                  codes, a full table kept until the next clear
//   sfod_tiff_lzw  TIFF's LZW (libtiff tif_lzw.c, new style): codes MSB
//                  first, 9 to 12 bits, the width growing one code early;
//                  256 clears, 257 ends
//   sfod_packbits  TIFF's PackBits (libtiff tif_packbits.c)
//   sfod_bmp_rle   BMP's RLE8 and RLE4 as Pillow 12's BmpRleDecoder reads
//                  them (BmpImagePlugin.py), quirks included: a delta escape
//                  reads two bytes more than its own two, an absolute run of
//                  RLE4 takes count // 2 bytes, and the word alignment after
//                  an absolute run follows the file offset
//
// Every call releases the GIL (ctypes), so decode threads scale.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kMaxBits = 12;
constexpr int kTableSize = 1 << kMaxBits;

// an LZW string table: prefix code, last byte, first byte, length
struct LzwTable {
  uint16_t prefix[kTableSize + 1024];
  uint8_t suffix[kTableSize + 1024];
  uint8_t first[kTableSize + 1024];
  uint32_t length[kTableSize + 1024];

  void init(int roots) {
    for (int i = 0; i < roots; i++) {
      prefix[i] = 0;
      suffix[i] = first[i] = static_cast<uint8_t>(i);
      length[i] = 1;
    }
  }
  // the string of `code` written at out[0 .. length), at most cap bytes of it
  void write(int code, uint8_t* out, int64_t cap) const {
    for (int64_t k = length[code] - 1; k >= 0; k--) {
      if (k < cap) out[k] = suffix[code];
      code = prefix[code];
    }
  }
};

}  // namespace

extern "C" {

// Decode a GIF image's LZW data (the sub-blocks joined) into at most npix
// palette indices. Returns the number of indices written: it stops at the
// end code, at the end of the data or at npix; -1 for a code beyond the
// table, -2 for a minimum code size outside 1..11.
int64_t sfod_gif_lzw(const uint8_t* data, int64_t n, int32_t min_size, uint8_t* out, int64_t npix) {
  if (min_size < 1 || min_size > 11) return -2;
  static thread_local LzwTable t;
  const int clear = 1 << min_size, end = clear + 1;
  t.init(clear);
  int size = min_size + 1, next = end + 1, prev = -1;
  uint32_t acc = 0;
  int bits = 0;
  int64_t pos = 0, written = 0;
  while (written < npix) {
    while (bits < size && pos < n) {
      acc |= static_cast<uint32_t>(data[pos++]) << bits;
      bits += 8;
    }
    if (bits < size) break;  // the data ran out
    const int code = static_cast<int>(acc & ((1u << size) - 1));
    acc >>= size;
    bits -= size;
    if (code == clear) {
      size = min_size + 1;
      next = end + 1;
      prev = -1;
      continue;
    }
    if (code == end) break;
    if (prev < 0) {  // the first code after a clear
      if (code >= clear) return -1;
      out[written++] = static_cast<uint8_t>(code);
      prev = code;
      continue;
    }
    if (code > next || (code == next && next >= kTableSize)) return -1;
    const int first = code < next ? t.first[code] : t.first[prev];
    if (next < kTableSize) {
      t.prefix[next] = static_cast<uint16_t>(prev);
      t.suffix[next] = static_cast<uint8_t>(first);
      t.first[next] = t.first[prev];
      t.length[next] = t.length[prev] + 1;
      next++;
      if (next == (1 << size) && size < kMaxBits) size++;
    }
    const int64_t room = npix - written;
    t.write(code, out + written, room);
    written += t.length[code] < room ? t.length[code] : room;
    prev = code;
  }
  return written;
}

// Decode a TIFF strip or tile of LZW data into exactly cap bytes. Returns
// cap, or -1 for a code beyond the table, -2 for the old-style (LSB-first)
// coding, -3 when the codes end before cap bytes (libtiff: "Not enough
// data").
int64_t sfod_tiff_lzw(const uint8_t* data, int64_t n, uint8_t* out, int64_t cap) {
  if (n >= 2 && data[0] == 0 && (data[1] & 1)) return -2;  // tif_lzw.c: LZWPreDecode's compat test
  static thread_local LzwTable t;
  t.init(256);
  constexpr int kClear = 256, kEoi = 257, kFirst = 258;
  int size = 9, next = kFirst, prev = -1;
  uint64_t acc = 0;
  int bits = 0;
  int64_t pos = 0, written = 0;
  while (written < cap) {
    while (bits < size && pos < n) {
      acc = (acc << 8) | data[pos++];
      bits += 8;
    }
    if (bits < size) break;
    const int code = static_cast<int>((acc >> (bits - size)) & ((1u << size) - 1));
    bits -= size;
    if (code == kClear) {
      size = 9;
      next = kFirst;
      prev = -1;
      continue;
    }
    if (code == kEoi) break;
    if (prev < 0) {
      if (code > kClear) return -1;
      out[written++] = static_cast<uint8_t>(code);
      prev = code;
      continue;
    }
    if (code > next || next >= kTableSize + 1024) return -1;
    const int first = code < next ? t.first[code] : t.first[prev];
    t.prefix[next] = static_cast<uint16_t>(prev);
    t.suffix[next] = static_cast<uint8_t>(first);
    t.first[next] = t.first[prev];
    t.length[next] = t.length[prev] + 1;
    next++;
    if (next > (1 << size) - 2 && size < kMaxBits) size++;  // one code early
    const int64_t room = cap - written;
    t.write(code, out + written, room);
    written += t.length[code] < room ? t.length[code] : room;
    prev = code;
  }
  return written == cap ? cap : -3;
}

// Decode PackBits into exactly cap bytes. Returns cap, or -3 when the data
// ends first.
int64_t sfod_packbits(const uint8_t* data, int64_t n, uint8_t* out, int64_t cap) {
  int64_t pos = 0, written = 0;
  while (written < cap && pos < n) {
    const int h = static_cast<int8_t>(data[pos++]);
    if (h >= 0) {  // h + 1 literal bytes
      for (int k = 0; k <= h && pos < n && written < cap; k++) out[written++] = data[pos++];
    } else if (h != -128) {  // the next byte 1 - h times
      if (pos >= n) break;
      const uint8_t b = data[pos++];
      for (int k = 0; k < 1 - h && written < cap; k++) out[written++] = b;
    }
  }
  return written == cap ? cap : -3;
}

// Pillow's BmpRleDecoder over the n bytes of data that start at offset
// file_pos of the file: the stream of w x h palette indices it builds (rows
// bottom-up or top-down as the header says, which the caller applies), its
// first w * h bytes written to out. Returns the stream's length (shorter
// than w * h: Pillow's "not enough image data"), or -1 where Pillow's
// decoder raises (a delta escape cut short).
int64_t sfod_bmp_rle(const uint8_t* data, int64_t n, int64_t file_pos, int32_t w, int32_t h, int32_t rle4,
                     uint8_t* out) {
  const int64_t dest = static_cast<int64_t>(w) * h;
  std::vector<uint8_t> s;
  s.reserve(static_cast<size_t>(dest) + 512);
  int64_t pos = 0, x = 0;
  auto pad_to = [&](int64_t len) { s.resize(static_cast<size_t>(len), 0); };
  while (static_cast<int64_t>(s.size()) < dest) {
    if (pos + 2 > n) break;
    int64_t count = data[pos];
    const uint8_t b = data[pos + 1];
    pos += 2;
    if (count) {  // encoded mode
      if (x + count > w) count = x < w ? w - x : 0;
      for (int64_t k = 0; k < count; k++) s.push_back(rle4 ? ((k & 1) ? (b & 15) : (b >> 4)) : b);
      x += count;
    } else if (b == 0) {  // end of line
      const int64_t len = static_cast<int64_t>(s.size());
      if (len % w) pad_to(len + (w - len % w));
      x = 0;
    } else if (b == 1) {  // end of bitmap
      break;
    } else if (b == 2) {  // delta: Pillow reads two bytes, then right and up from the two after them
      if (pos + 2 > n) break;
      pos += 2;
      if (pos + 2 > n) return -1;
      const int64_t right = data[pos], up = data[pos + 1];
      pos += 2;
      pad_to(static_cast<int64_t>(s.size()) + right + up * w);
      x = static_cast<int64_t>(s.size()) % w;
    } else {  // absolute mode
      const int64_t want = rle4 ? b / 2 : b;
      const int64_t got = pos + want <= n ? want : n - pos;
      for (int64_t k = 0; k < got; k++) {
        const uint8_t v = data[pos + k];
        if (rle4) {
          s.push_back(v >> 4);
          s.push_back(v & 15);
        } else {
          s.push_back(v);
        }
      }
      pos += got;
      if (got < want) break;
      x += b;
      if ((file_pos + pos) % 2) pos++;  // word alignment, by the file's offset
    }
  }
  const int64_t len = static_cast<int64_t>(s.size());
  memcpy(out, s.data(), static_cast<size_t>(len < dest ? len : dest));
  return len;
}

}  // extern "C"
