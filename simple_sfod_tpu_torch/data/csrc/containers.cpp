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
//   sfod_ycbcr_units  TIFF's YCbCr data units to RGB as libtiff's RGBA
//                  interface converts them (tif_getimage.c's putcontig8bit
//                  YCbCr routines over TIFFYCbCrtoRGB's tables, given)
//   sfod_lab_rgb   8-bit CIELab to RGB as Pillow 12's convert("RGB") gives it:
//                  LittleCMS 2.17's optimised Lab -> sRGB transform, a 33^3
//                  16-bit table (given) read by cmsintrp.c's
//                  TetrahedralInterp16, FROM_16_TO_8 on the way out
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

// Convert a strip's or tile's YCbCr data units (rows of `across` units of
// hs * vs luma samples, then Cb and Cr) to rows x width RGB pixels, out_stride
// bytes a row: each pixel its own Y with its unit's Cb and Cr (chroma
// replicated), converted by tif_color.c:TIFFYCbCrtoRGB over the tables
// TIFFYCbCrToRGBInit builds (y_tab, cr_r, cb_b, cr_g, cb_g, 256 entries each).
void sfod_ycbcr_units(const uint8_t* units, int32_t across, int32_t hs, int32_t vs, int32_t rows, int32_t width,
                      const int32_t* y_tab, const int32_t* cr_r, const int32_t* cb_b, const int32_t* cr_g,
                      const int32_t* cb_g, uint8_t* out, int64_t out_stride) {
  const int unit = hs * vs + 2;
  auto clamp = [](int32_t v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); };
  for (int32_t r = 0; r < rows; r++) {
    const uint8_t* row_units = units + static_cast<int64_t>(r / vs) * across * unit;
    uint8_t* o = out + r * out_stride;
    for (int32_t x = 0; x < width; x++) {
      const uint8_t* u = row_units + static_cast<int64_t>(x / hs) * unit;
      const int32_t yv = y_tab[u[(r % vs) * hs + x % hs]];
      const int cb = u[hs * vs], cr = u[hs * vs + 1];
      o[3 * x] = clamp(yv + cr_r[cr]);
      o[3 * x + 1] = clamp(yv + ((cb_g[cb] + cr_g[cr]) >> 16));
      o[3 * x + 2] = clamp(yv + cb_b[cb]);
    }
  }
}

// Convert n pixels of Pillow's "LAB" (L, a + 128, b + 128: the file's
// signed a* and b* with their top bit flipped) to RGB through LittleCMS's
// table clut [33][33][33][3] (L slowest): each channel widened as
// FROM_8_TO_16, the cell found as _cmsToFixedDomain finds it, the
// tetrahedron chosen and summed as TetrahedralInterp16 does, the result
// narrowed as FROM_16_TO_8.
void sfod_lab_rgb(const uint8_t* lab, int64_t n, const uint16_t* clut, uint8_t* out) {
  constexpr int kGrid = 33, kOut = 3;
  const int opta[3] = {kGrid * kGrid * kOut, kGrid * kOut, kOut};
  for (int64_t i = 0; i < n; i++) {
    int x0[3], r[3], one[3];
    for (int c = 0; c < 3; c++) {
      const int in = lab[3 * i + c] * 257;
      const int a = in * (kGrid - 1);
      const int f = a + (a + 0x7FFF) / 0xFFFF;  // _cmsToFixedDomain
      x0[c] = f >> 16;
      r[c] = f & 0xFFFF;
      one[c] = in == 0xFFFF ? 0 : opta[c];
    }
    const uint16_t* t = clut + x0[0] * opta[0] + x0[1] * opta[1] + x0[2] * opta[2];
    const int rx = r[0], ry = r[1], rz = r[2];
    int X1 = one[0], Y1 = one[1], Z1 = one[2];
    int kind;
    if (rx >= ry) {
      if (ry >= rz) {
        Y1 += X1, Z1 += Y1, kind = 0;
      } else if (rz >= rx) {
        X1 += Z1, Y1 += X1, kind = 1;
      } else {
        Z1 += X1, Y1 += Z1, kind = 2;
      }
    } else {
      if (rx >= rz) {
        X1 += Y1, Z1 += X1, kind = 3;
      } else if (ry >= rz) {
        Z1 += Y1, X1 += Z1, kind = 4;
      } else {
        Y1 += Z1, X1 += Y1, kind = 5;
      }
    }
    for (int k = 0; k < kOut; k++) {
      int c1 = t[X1 + k], c2 = t[Y1 + k], c3 = t[Z1 + k];
      const int c0 = t[k];
      switch (kind) {
        case 0: c3 -= c2, c2 -= c1, c1 -= c0; break;
        case 1: c2 -= c1, c1 -= c3, c3 -= c0; break;
        case 2: c2 -= c3, c3 -= c1, c1 -= c0; break;
        case 3: c3 -= c1, c1 -= c2, c2 -= c0; break;
        case 4: c1 -= c3, c3 -= c2, c2 -= c0; break;
        default: c1 -= c2, c2 -= c3, c3 -= c0; break;
      }
      // cmsS15Fixed16Number arithmetic: int32, wrapping as it does
      const int32_t rest = static_cast<int32_t>(static_cast<uint32_t>(c1) * rx + static_cast<uint32_t>(c2) * ry +
                                                static_cast<uint32_t>(c3) * rz + 0x8001u);
      const uint32_t v = static_cast<uint16_t>(c0 + ((rest + (rest >> 16)) >> 16));
      out[3 * i + k] = static_cast<uint8_t>((v * 65281u + 8388608u) >> 24);
    }
  }
}

}  // extern "C"
