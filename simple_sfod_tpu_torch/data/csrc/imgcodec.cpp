// Host image codec of the PyTorch port: the repo's native/imgcodec.cpp with
// its PNG decoder replaced and its JPEG decoder made optional, so that the
// library builds with nothing but a C++17 compiler.
//
//   sfod_resize_bilinear  Pillow-BILINEAR-bit-exact resample (fixed-point,
//                         two passes, uint8 intermediate), as native/
//   sfod_png_unfilter     PNG scanline reconstruction (filter types 0-4);
//                         the caller inflates the IDAT stream (Python's
//                         zlib) and maps the colour type to RGB
//   sfod_jpeg_decode      libjpeg decode (from memory) with PIL's default
//                         settings, built
//                         only where <jpeglib.h> is found (-DSFOD_WITH_JPEG
//                         -ljpeg); otherwise it returns kNoJpeg
//   sfod_codec_features   bit 0: JPEG decode was built in
//
// Every call releases the GIL (ctypes), so decode threads scale.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#ifndef SFOD_WITH_JPEG
#define SFOD_WITH_JPEG 0
#endif

#if SFOD_WITH_JPEG
#include <csetjmp>
#include <jpeglib.h>
#endif

namespace {

constexpr int kNoJpeg = -10;

// ---------------------------------------------------------------------------
// Pillow-exact BILINEAR resample (8 bits per channel fixed-point path)
// ---------------------------------------------------------------------------

constexpr int PRECISION_BITS = 32 - 8 - 2;  // Pillow Resample.c

inline double bilinear_filter(double x) {
  if (x < 0.0) x = -x;
  return x < 1.0 ? 1.0 - x : 0.0;
}

inline uint8_t clip8(int32_t in) {
  if (in >= (1 << (PRECISION_BITS + 8))) return 255;
  if (in <= 0) return 0;
  return static_cast<uint8_t>(in >> PRECISION_BITS);
}

// Pillow precompute_coeffs for the triangle (support=1.0) filter, followed by
// normalize_coeffs_8bpc quantisation. Returns ksize.
int precompute_coeffs(int in_size, int out_size, std::vector<int>* bounds,
                      std::vector<int32_t>* kk_fixed) {
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 1.0 * filterscale;  // BILINEAR support = 1.0
  int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;

  bounds->assign(out_size * 2, 0);
  std::vector<double> kk(static_cast<size_t>(out_size) * ksize, 0.0);
  for (int xx = 0; xx < out_size; xx++) {
    double center = (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);  // Pillow rounds
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &kk[static_cast<size_t>(xx) * ksize];
    int x = 0;
    for (; x < xmax; x++) {
      double w = bilinear_filter((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (x = 0; x < xmax; x++) {
      if (ww != 0.0) k[x] /= ww;
    }
    (*bounds)[xx * 2 + 0] = xmin;
    (*bounds)[xx * 2 + 1] = xmax;
  }
  kk_fixed->assign(kk.size(), 0);
  for (size_t i = 0; i < kk.size(); i++) {
    (*kk_fixed)[i] = kk[i] < 0
                         ? static_cast<int32_t>(-0.5 + kk[i] * (1 << PRECISION_BITS))
                         : static_cast<int32_t>(0.5 + kk[i] * (1 << PRECISION_BITS));
  }
  return ksize;
}

// Horizontal pass: [h, w, c] -> [h, nw, c]
void resample_horizontal(const uint8_t* src, int h, int w, int c, uint8_t* dst,
                         int nw, int ksize, const std::vector<int>& bounds,
                         const std::vector<int32_t>& kk) {
  for (int yy = 0; yy < h; yy++) {
    const uint8_t* line = src + static_cast<size_t>(yy) * w * c;
    uint8_t* out = dst + static_cast<size_t>(yy) * nw * c;
    for (int xx = 0; xx < nw; xx++) {
      int xmin = bounds[xx * 2 + 0];
      int xmax = bounds[xx * 2 + 1];
      const int32_t* k = &kk[static_cast<size_t>(xx) * ksize];
      for (int ch = 0; ch < c; ch++) {
        int32_t ss = 1 << (PRECISION_BITS - 1);
        for (int x = 0; x < xmax; x++) {
          ss += line[(x + xmin) * c + ch] * k[x];
        }
        out[xx * c + ch] = clip8(ss);
      }
    }
  }
}

// Vertical pass: [h, w, c] -> [nh, w, c]
void resample_vertical(const uint8_t* src, int h, int w, int c, uint8_t* dst,
                       int nh, int ksize, const std::vector<int>& bounds,
                       const std::vector<int32_t>& kk) {
  for (int yy = 0; yy < nh; yy++) {
    int ymin = bounds[yy * 2 + 0];
    int ymax = bounds[yy * 2 + 1];
    const int32_t* k = &kk[static_cast<size_t>(yy) * ksize];
    uint8_t* out = dst + static_cast<size_t>(yy) * w * c;
    for (int xx = 0; xx < w; xx++) {
      for (int ch = 0; ch < c; ch++) {
        int32_t ss = 1 << (PRECISION_BITS - 1);
        for (int y = 0; y < ymax; y++) {
          ss += src[(static_cast<size_t>(y + ymin) * w + xx) * c + ch] * k[y];
        }
        out[xx * c + ch] = clip8(ss);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// JPEG decode (libjpeg, PIL-default settings: ISLOW DCT, fancy upsampling)
// ---------------------------------------------------------------------------

#if SFOD_WITH_JPEG

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

int decode_jpeg(const uint8_t* data, size_t n, uint8_t** out, int32_t* h, int32_t* w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  // volatile: modified between setjmp and longjmp — non-volatile locals are
  // indeterminate in the longjmp path (C standard; libjpeg example.c does
  // the same), which under -O3 can mean freeing a stale register value
  uint8_t* volatile buf = nullptr;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    free(buf);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data), static_cast<unsigned long>(n));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;  // libjpeg converts YCbCr/grayscale
  jpeg_start_decompress(&cinfo);
  const int W = cinfo.output_width, H = cinfo.output_height;
  if (cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  buf = static_cast<uint8_t*>(malloc(static_cast<size_t>(H) * W * 3));
  if (!buf) {
    jpeg_destroy_decompress(&cinfo);
    return -4;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = buf + static_cast<size_t>(cinfo.output_scanline) * W * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *out = buf;
  *h = H;
  *w = W;
  return 0;
}

#endif  // SFOD_WITH_JPEG

// ---------------------------------------------------------------------------
// PNG scanline reconstruction (PNG spec, section 9: filter method 0)
// ---------------------------------------------------------------------------

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}


}  // namespace

extern "C" {

int sfod_codec_features() { return SFOD_WITH_JPEG ? 1 : 0; }

// Decode n bytes of a JPEG file to tightly-packed RGB8. On success *out is
// malloc'd (release with sfod_image_free). Returns 0, kNoJpeg when built
// without libjpeg, or a negative error code (unsupported/corrupt).
int sfod_jpeg_decode(const uint8_t* data, int64_t n, uint8_t** out, int32_t* h, int32_t* w) {
#if SFOD_WITH_JPEG
  return decode_jpeg(data, static_cast<size_t>(n), out, h, w);
#else
  (void)data;
  (void)n;
  (void)out;
  (void)h;
  (void)w;
  return kNoJpeg;
#endif
}

// Reconstruct h filtered scanlines (each a filter-type byte and `stride`
// bytes) from `src` into `dst` [h, stride]; bpp is the filter unit in bytes.
// Returns 0, or -1 for an unknown filter type.
int sfod_png_unfilter(const uint8_t* src, int32_t h, int32_t stride, int32_t bpp,
                      uint8_t* dst) {
  for (int32_t y = 0; y < h; y++) {
    const uint8_t* line = src + static_cast<size_t>(y) * (stride + 1);
    const uint8_t ft = line[0];
    line++;
    uint8_t* out = dst + static_cast<size_t>(y) * stride;
    const uint8_t* prev = y > 0 ? out - stride : nullptr;
    for (int32_t x = 0; x < stride; x++) {
      const int a = x >= bpp ? out[x - bpp] : 0;
      const int b = prev ? prev[x] : 0;
      const int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
      int v;
      switch (ft) {
        case 0: v = 0; break;
        case 1: v = a; break;
        case 2: v = b; break;
        case 3: v = (a + b) >> 1; break;
        case 4: v = paeth(a, b, c); break;
        default: return -1;
      }
      out[x] = static_cast<uint8_t>(line[x] + v);
    }
  }
  return 0;
}

// Pillow-BILINEAR-bit-exact resize: src [h, w, c] uint8 -> dst [nh, nw, c]
// (caller-allocated). Two-pass fixed-point with a uint8 intermediate, exactly
// like Pillow's ImagingResample. Returns 0.
int sfod_resize_bilinear(const uint8_t* src, int32_t h, int32_t w, int32_t c,
                         uint8_t* dst, int32_t nh, int32_t nw) {
  if (h <= 0 || w <= 0 || c <= 0 || nh <= 0 || nw <= 0) return -1;
  const bool need_h = nw != w;
  const bool need_v = nh != h;
  std::vector<int> bounds;
  std::vector<int32_t> kk;
  if (!need_h && !need_v) {
    memcpy(dst, src, static_cast<size_t>(h) * w * c);
    return 0;
  }
  std::vector<uint8_t> tmp;
  const uint8_t* cur = src;
  int cur_h = h, cur_w = w;
  if (need_h) {
    int ksize = precompute_coeffs(w, nw, &bounds, &kk);
    if (need_v) {
      tmp.resize(static_cast<size_t>(h) * nw * c);
      resample_horizontal(cur, h, w, c, tmp.data(), nw, ksize, bounds, kk);
      cur = tmp.data();
    } else {
      resample_horizontal(cur, h, w, c, dst, nw, ksize, bounds, kk);
      return 0;
    }
    cur_w = nw;
  }
  int ksize = precompute_coeffs(cur_h, nh, &bounds, &kk);
  resample_vertical(cur, cur_h, cur_w, c, dst, nh, ksize, bounds, kk);
  return 0;
}

void sfod_image_free(void* p) { free(p); }

}  // extern "C"
