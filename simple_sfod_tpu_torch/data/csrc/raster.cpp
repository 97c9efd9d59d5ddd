// The per-pixel loops of the raster containers the port reads beside PNG,
// JPEG, BMP, GIF, TIFF and WebP (data/raster_formats.py parses their
// headers and maps the samples to RGB; each loop follows the Pillow 12.1
// decoder the JAX package reaches through PIL, damaged data included):
//
//   sfod_pcx_rle   PCX's run-length lines (PcxDecode.c): a byte with its two
//                  high bits set repeats the next byte (count & 0x3F) times,
//                  any other byte is a literal; a run that passes the end of
//                  its line is an overrun (Pillow drops the rest and fails
//                  the image)
//   sfod_tga_rle   TGA's run-length packets (TgaRleDecode.c): a run of one
//                  pixel repeated, which may not pass the end of its line, or
//                  a literal of pixels, which runs on into the next lines
//   sfod_sgi_rle   SGI's run-length rows (SgiRleDecode.c): the offset and
//                  length tables, each row of each channel expanded into the
//                  interleaved row buffer, 8- or 16-bit atoms, the quirks of
//                  expandrow kept (a length counts chunks, not bytes; a
//                  nonzero last chunk ends the whole image without error; a
//                  row that ends early keeps the previous row's samples)
//   sfod_qoi       QOI's ops as Pillow's QoiDecoder reads them
//
// Every call releases the GIL (ctypes), so decode threads scale.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// expandrow / expandrow2: one channel of one row into the interleaved row
// buffer (every z-th atom of BPC bytes). Returns 0, -1 (overrun) or 1 (a
// nonzero last chunk: decoding ends there).
template <int BPC>
int sgi_expand(uint8_t* dest, const uint8_t* src, int64_t n, int z, int xsize, const uint8_t* end) {
  int x = 0;
  const int step = z * BPC;
  for (; n > 0; n--) {
    if (src + (BPC - 1) > end) return -1;
    uint8_t pixel = src[BPC - 1];
    src += BPC;
    if (n == 1 && pixel != 0) return 1;
    int count = pixel & 0x7F;
    if (!count) return 0;
    if (x + count > xsize) return -1;
    x += count;
    if (pixel & 0x80) {
      if (src + (BPC == 1 ? count : 2 * count) > end) return -1;
      for (; count > 0; count--, src += BPC, dest += step) {
        dest[0] = src[0];
        if (BPC == 2) dest[1] = src[1];
      }
    } else {
      if (src + (BPC == 1 ? 0 : 2) > end) return -1;
      for (; count > 0; count--, dest += step) {
        dest[0] = src[0];
        if (BPC == 2) dest[1] = src[1];
      }
      src += BPC;
    }
  }
  return 0;
}

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

}  // namespace

namespace {

template <int CH>
int32_t qoi_ops(const uint8_t* src, int64_t n, int64_t npix, uint8_t* out) {
  uint8_t seen[64][4] = {};  // an index never written reads as 0, 0, 0, 0
  uint8_t px[4] = {0, 0, 0, 255};
  int64_t p = 0;
  uint8_t* o = out;
  uint8_t* const stop = out + npix * CH;
  while (o < stop) {
    if (p >= n) return -1;
    const uint8_t b = src[p++];
    if (b == 0xFE) {
      if (n - p < 3) return -1;
      px[0] = src[p];
      px[1] = src[p + 1];
      px[2] = src[p + 2];
      p += 3;
    } else if (b == 0xFF) {
      if (n - p < 4) return -1;
      memcpy(px, src + p, 4);
      p += 4;
    } else if (b < 0x40) {
      memcpy(px, seen[b], 4);
    } else if (b < 0x80) {
      px[0] = static_cast<uint8_t>(px[0] + ((b >> 4) & 3) - 2);
      px[1] = static_cast<uint8_t>(px[1] + ((b >> 2) & 3) - 2);
      px[2] = static_cast<uint8_t>(px[2] + (b & 3) - 2);
    } else if (b < 0xC0) {
      if (p >= n) return -1;
      const uint8_t b2 = src[p++];
      const int dg = (b & 63) - 32;
      px[0] = static_cast<uint8_t>(px[0] + dg + ((b2 >> 4) & 15) - 8);
      px[1] = static_cast<uint8_t>(px[1] + dg);
      px[2] = static_cast<uint8_t>(px[2] + dg + (b2 & 15) - 8);
    } else {  // a run of the previous pixel: the index is left as it is
      for (int run = (b & 63) + 1; run > 0 && o < stop; run--, o += CH) memcpy(o, px, CH);
      continue;
    }
    memcpy(seen[(px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) % 64], px, 4);
    memcpy(o, px, CH);
    o += CH;
  }
  return 0;
}

}  // namespace

extern "C" {

// Decode PCX lines of line_bytes bytes each into out[rows * line_bytes].
// Returns the number of complete lines (rows on success; fewer when the
// data ends first), or -1 for a run past the end of a line.
int64_t sfod_pcx_rle(const uint8_t* src, int64_t n, int64_t line_bytes, int64_t rows, uint8_t* out) {
  int64_t x = 0, y = 0, p = 0;
  if (line_bytes <= 0 || rows <= 0) return 0;
  uint8_t* line = out;
  while (y < rows) {
    if (p >= n) return y;
    uint8_t b = src[p];
    if ((b & 0xC0) == 0xC0) {
      if (n - p < 2) return y;
      int count = b & 0x3F;
      if (x + count > line_bytes) return -1;
      memset(line + x, src[p + 1], count);
      x += count;
      p += 2;
    } else {
      line[x++] = b;
      p++;
    }
    if (x >= line_bytes) {
      x = 0;
      y++;
      line += line_bytes;
    }
  }
  return y;
}

// Decode TGA RLE packets of depth-byte pixels into lines of line_bytes
// bytes, in the order the file stores them. Returns the complete lines, or
// -1 for a run past the end of a line.
int64_t sfod_tga_rle(const uint8_t* src, int64_t n, int32_t depth, int64_t line_bytes, int64_t rows, uint8_t* out) {
  int64_t x = 0, y = 0, p = 0;
  if (line_bytes <= 0 || rows <= 0 || depth <= 0) return 0;
  while (y < rows) {
    if (p >= n) return y;
    int64_t count = static_cast<int64_t>(depth) * ((src[p] & 0x7F) + 1);
    if (src[p] & 0x80) {
      if (n - p < 1 + depth) return y;
      if (x + count > line_bytes) return -1;
      uint8_t* line = out + y * line_bytes;
      for (int64_t i = 0; i < count; i += depth) memcpy(line + x + i, src + p + 1, depth);
      x += count;
      p += 1 + depth;
      if (x >= line_bytes) {
        x = 0;
        y++;
      }
    } else {
      if (n - p < 1 + count) return y;
      const uint8_t* lit = src + p + 1;
      p += 1 + count;
      while (count > 0 && y < rows) {  // a literal runs on into the next lines
        int64_t k = count < line_bytes - x ? count : line_bytes - x;
        memcpy(out + y * line_bytes + x, lit, k);
        lit += k;
        count -= k;
        x += k;
        if (x >= line_bytes) {
          x = 0;
          y++;
        }
      }
    }
  }
  return y;
}

// Decode an SGI RLE image from buf, the file after its 512-byte header
// (bufsize bytes), into out: ysize rows of xsize * bands atoms of bpc
// bytes, interleaved, in the order of the tables (row 0 is the bottom row).
// Rows the decoder never reaches stay as given (zero). Returns 0, 1 (ended
// early by a nonzero last chunk, as Pillow ends it: no error), -1 (an
// overrun: an offset before the data, a chunk past the buffer or a run past
// the row) or -2 (the tables do not fit the file).
int32_t sfod_sgi_rle(const uint8_t* buf, int64_t bufsize, int32_t xsize, int32_t ysize, int32_t bands, int32_t bpc,
                     uint8_t* out) {
  const int64_t tablen = static_cast<int64_t>(bands) * ysize;
  if (bufsize < 8 * tablen) return -2;
  const int64_t row_bytes = static_cast<int64_t>(xsize) * bands * bpc;
  std::vector<uint8_t> row(static_cast<size_t>(row_bytes), 0);
  const uint8_t* end = buf + bufsize - 1;
  for (int32_t r = 0; r < ysize; r++) {
    for (int32_t c = 0; c < bands; c++) {
      const int64_t k = r + static_cast<int64_t>(c) * ysize;
      uint32_t off = be32(buf + 4 * k), len = be32(buf + 4 * (tablen + k));
      if (off < 512) return -1;  // a length is not checked: expandrow stops at the buffer's end
      off -= 512;
      uint8_t* dest = row.data() + static_cast<int64_t>(c) * bpc;
      int status = bpc == 1 ? sgi_expand<1>(dest, buf + off, len, bands, xsize, end)
                            : sgi_expand<2>(dest, buf + off, len, bands, xsize, end);
      if (status == -1) return -1;
      if (status == 1) return 1;
    }
    memcpy(out + r * row_bytes, row.data(), row_bytes);
  }
  return 0;
}

// Decode QOI ops from src into npix pixels of `channels` (3 or 4) bytes.
// Returns 0, or -1 when the data ends before the last pixel.
int32_t sfod_qoi(const uint8_t* src, int64_t n, int64_t npix, int32_t channels, uint8_t* out) {
  return channels == 3 ? qoi_ops<3>(src, n, npix, out) : qoi_ops<4>(src, n, npix, out);
}

}  // extern "C"
