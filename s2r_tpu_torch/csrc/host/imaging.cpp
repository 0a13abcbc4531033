// Host imaging for the data pipeline's PIL route: PNG decoding, and
// Pillow's BILINEAR resample and GaussianBlur, bit for bit.
//
// Replaces what s2r_tpu/data/{transforms,datasets,hostcrop}.py take from PIL
// (Image.open().convert("RGB"), np.asarray(Image.open()), Image.resize with
// BILINEAR and box=, ImageFilter.GaussianBlur).  The card's machine has
// neither PIL nor libpng; it has g++ and zlib.
//
// - PNG: png.h, shared with the native pipeline (pipeline.cpp): the chunks
//   walked and their CRCs checked, the IDAT stream inflated by zlib, the
//   scanlines unfiltered (None, Sub, Up, Average, Paeth) pass by pass for
//   Adam7 files, and each row expanded into what np.asarray(Image.open(p))
//   gives (raw: palette indices, gray values, [.., 2] gray+alpha, [.., 4]
//   RGBA) or what .convert("RGB") gives (rgb).  Gray and palette at 1/2/4/8
//   bits, RGB, gray+alpha and RGBA at 8; 16-bit RGB and RGBA raw and rgb,
//   16-bit gray+alpha rgb, as their high bytes; data/imaging.py refuses the
//   16-bit cases where Pillow gives other bytes.
// - BILINEAR: Pillow's Resample.c.  Each axis has a triangle filter whose
//   support widens by the scale when it downscales; coefficients normalized
//   in double, then rounded half away from zero to 22-bit fixed point
//   (PRECISION_BITS = 32 - 8 - 2); the horizontal pass first, into a
//   clipped uint8 intermediate over the rows the vertical pass reads, then
//   the vertical pass.  The box corners arrive as float, as Pillow parses
//   them, and their difference is taken in float.
// - GaussianBlur: Pillow's BoxBlur.c, an extended box blur of three passes
//   along rows, then three along columns, edges clamped; the box radius from
//   the Gaussian radius by _gaussian_blur_radius in float, the weights
//   ww = 2^24 / (2r + 1) and fw for the two fractional end taps in 24-bit
//   fixed point.
//
// Built with g++ -O3 -std=c++17 -shared -fPIC -pthread -ffp-contract=off
// -lz and no -march: a fused multiply-add would move a double coefficient by an ulp
// and the fixed-point rounding after it, so the bits would stop being
// Pillow's (s2r_tpu_torch/ops/kernels/build.py).  Every entry returns 0 on
// success and a positive code the Python side turns into an error.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include "jpeg.h"
#include "png.h"

namespace {

// -------------------------------------------------- Pillow Resample.c ---

constexpr int PRECISION_BITS = 32 - 8 - 2;

double bilinear_filter(double x) {
  if (x < 0.0) x = -x;
  if (x < 1.0) return 1.0 - x;
  return 0.0;
}

struct Coeffs {
  int ksize = 0;
  std::vector<int> bounds;    // (first source index, count) an output
  std::vector<int32_t> kk;    // fixed point, ksize an output
};

Coeffs precompute_coeffs(int64_t in_size, float in0, float in1,
                         int64_t out_size) {
  Coeffs c;
  double filterscale, scale;
  filterscale = scale = (double)(in1 - in0) / out_size;
  if (filterscale < 1.0) filterscale = 1.0;
  const double support = 1.0 * filterscale;  // BILINEAR's support is 1
  c.ksize = (int)std::ceil(support) * 2 + 1;
  std::vector<double> kk((size_t)(out_size * c.ksize), 0.0);
  c.bounds.resize((size_t)(out_size * 2));
  for (int64_t xx = 0; xx < out_size; ++xx) {
    const double center = in0 + (xx + 0.5) * scale;
    double ww = 0.0;
    const double ss = 1.0 / filterscale;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > in_size) xmax = (int)in_size;
    xmax -= xmin;
    double* k = &kk[(size_t)(xx * c.ksize)];
    for (int x = 0; x < xmax; ++x) {
      const double w = bilinear_filter((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; ++x)
      if (ww != 0.0) k[x] /= ww;
    c.bounds[(size_t)(xx * 2)] = xmin;
    c.bounds[(size_t)(xx * 2 + 1)] = xmax;
  }
  c.kk.resize(kk.size());
  for (size_t i = 0; i < kk.size(); ++i)
    c.kk[i] = kk[i] < 0 ? (int)(-0.5 + kk[i] * (1 << PRECISION_BITS))
                        : (int)(0.5 + kk[i] * (1 << PRECISION_BITS));
  return c;
}

inline uint8_t clip8(int in) {
  if (in >= (1 << PRECISION_BITS << 8)) return 255;
  if (in <= 0) return 0;
  return (uint8_t)(in >> PRECISION_BITS);
}

// ------------------------------------------------- Pillow BoxBlur.c ---

float gaussian_blur_radius(float radius, int passes) {
  float sigma2, L, l, a;
  sigma2 = radius * radius / passes;
  L = std::sqrt(12.0 * sigma2 + 1.0);
  l = std::floor((L - 1.0) / 2.0);
  a = (2 * l + 1) * (l * (l + 1) - 3 * sigma2);
  a /= 6 * (sigma2 - (l + 1) * (l + 1));
  return l + a;
}

// One extended-box pass along `n` positions `step` elements apart, for
// `lanes` neighbouring lanes at once (the channels of a row, or whole rows
// for a pass down the columns): out[x] = (ww * sum in[x-r .. x+r] + fw *
// (in[x-r-1] + in[x+r+1]) + 2^23) >> 24, indices clamped to the line.
void box_pass(const uint8_t* in, uint8_t* out, int64_t n, int64_t step,
              int64_t lanes, int radius, uint32_t ww, uint32_t fw,
              std::vector<uint32_t>& acc) {
  const int64_t last = n - 1;
  auto at = [&](int64_t i) {
    return in + (i < 0 ? 0 : (i > last ? last : i)) * step;
  };
  acc.assign((size_t)lanes, 0);
  for (int64_t i = -radius - 1; i < radius; ++i) {  // the window of x = -1
    const uint8_t* p = at(i);
    for (int64_t l = 0; l < lanes; ++l) acc[l] += p[l];
  }
  for (int64_t x = 0; x < n; ++x) {
    const uint8_t* add = at(x + radius);
    const uint8_t* sub = at(x - radius - 1);
    const uint8_t* far = at(x + radius + 1);
    uint8_t* o = out + x * step;
    for (int64_t l = 0; l < lanes; ++l) {
      acc[l] += add[l];
      acc[l] -= sub[l];
      const uint32_t bulk = acc[l] * ww + (uint32_t)(sub[l] + far[l]) * fw;
      o[l] = (uint8_t)((bulk + (1u << 23)) >> 24);
    }
  }
}

// Geometry.c's COORD and FLOOR.
inline int coord(double v) { return v < 0.0 ? -1 : (int)v; }
inline int floor_int(double v) {
  return v < 0.0 ? (int)std::floor(v) : (int)v;
}

// Pillow's bilinear_filter8 / bilinear_filter32RGB at the source point
// (xin, yin) of uint8 [h, w, c]; false outside the image.
bool bilinear_at(const uint8_t* in, int64_t h, int64_t w, int64_t c,
                 double xin, double yin, uint8_t* out) {
  if (xin < 0.0 || xin >= w || yin < 0.0 || yin >= h) return false;
  xin -= 0.5;
  yin -= 0.5;
  const int x = floor_int(xin), y = floor_int(yin);
  const double dx = xin - x, dy = yin - y;
  auto clip = [](int64_t v, int64_t n) {
    return v < 0 ? 0 : v < n ? v : n - 1;
  };
  const int64_t x0 = clip(x, w) * c, x1 = clip(x + 1, w) * c;
  const uint8_t* r0 = in + clip(y, h) * w * c;
  const bool below = y + 1 >= 0 && y + 1 < h;
  const uint8_t* r1 = in + (int64_t)(y + 1) * w * c;
  for (int64_t b = 0; b < c; ++b) {
    double v1 = r0[x0 + b] + (r0[x1 + b] - r0[x0 + b]) * dx;
    if (below) {
      const double v2 = r1[x0 + b] + (r1[x1 + b] - r1[x0 + b]) * dx;
      v1 = v1 + (v2 - v1) * dy;
    }
    out[b] = (uint8_t)v1;
  }
  return true;
}

}  // namespace

extern "C" {

// Pillow's Image.transform(size, AFFINE, a, NEAREST or BILINEAR) of uint8
// [h, w, c] into out [h, w, c], the fill 0 (fillcolor None): the output
// pixel (x, y) reads the source at a[0..2] . (x + .5, y + .5, 1),
// a[3..5] . (the same) (Geometry.c).  BILINEAR: ImagingGenericTransform
// with bilinear_filter8 / bilinear_filter32RGB (doubles, truncated to
// 8 bits).  NEAREST: ImagingScaleAffine for a matrix without shear,
// else affine_fixed (16.16 fixed point) where the four corners fit it,
// else the double loop of ImagingTransformAffine.
int s2r_affine(const uint8_t* in, int64_t h, int64_t w, int64_t c,
               const double* a, int bilinear, uint8_t* out) {
  std::memset(out, 0, (size_t)(h * w * c));
  if (bilinear) {
    for (int64_t y = 0; y < h; ++y) {
      for (int64_t x = 0; x < w; ++x) {
        const double xi = x + 0.5, yi = y + 0.5;
        const double xx = a[0] * xi + a[1] * yi + a[2];
        const double yy = a[3] * xi + a[4] * yi + a[5];
        bilinear_at(in, h, w, c, xx, yy, out + (y * w + x) * c);
      }
    }
    return 0;
  }
  if (a[1] == 0 && a[3] == 0) {  // ImagingScaleAffine
    std::vector<int64_t> xin((size_t)w, -1);
    double xo = a[2] + a[0] * 0.5, yo = a[5] + a[4] * 0.5;
    for (int64_t x = 0; x < w; ++x) {
      const int xi = coord(xo);
      if (xi >= 0 && xi < w) xin[x] = xi;
      xo += a[0];
    }
    for (int64_t y = 0; y < h; ++y) {
      const int yi = coord(yo);
      if (yi >= 0 && yi < h)
        for (int64_t x = 0; x < w; ++x)
          if (xin[x] >= 0)
            std::memcpy(out + (y * w + x) * c, in + (yi * w + xin[x]) * c,
                        (size_t)c);
      yo += a[4];
    }
    return 0;
  }
  auto fits = [&](double x, double y) {
    return std::fabs(x * a[0] + y * a[1] + a[2]) < 32768.0 &&
           std::fabs(x * a[3] + y * a[4] + a[5]) < 32768.0;
  };
  if (fits(0, 0) && fits((double)w, (double)h) && fits(0, (double)h) &&
      fits((double)w, 0)) {  // affine_fixed
    auto fix = [](double v) { return floor_int(v * 65536.0 + 0.5); };
    const int a0 = fix(a[0]), a1 = fix(a[1]), a3 = fix(a[3]), a4 = fix(a[4]);
    int a2 = fix(a[2] + a[1] * 0.5 + a[0] * 0.5);
    int a5 = fix(a[5] + a[4] * 0.5 + a[3] * 0.5);
    for (int64_t y = 0; y < h; ++y) {
      int xx = a2, yy = a5;
      for (int64_t x = 0; x < w; ++x) {
        const int xi = xx >> 16;
        if (xi >= 0 && xi < w) {
          const int yi = yy >> 16;
          if (yi >= 0 && yi < h)
            std::memcpy(out + (y * w + x) * c, in + (yi * w + xi) * c,
                        (size_t)c);
        }
        xx += a0;
        yy += a3;
      }
      a2 += a1;
      a5 += a4;
    }
    return 0;
  }
  double xo = a[2] + a[1] * 0.5 + a[0] * 0.5;
  double yo = a[5] + a[4] * 0.5 + a[3] * 0.5;
  for (int64_t y = 0; y < h; ++y) {
    double xx = xo, yy = yo;
    for (int64_t x = 0; x < w; ++x) {
      const int xi = coord(xx);
      if (xi >= 0 && xi < w) {
        const int yi = coord(yy);
        if (yi >= 0 && yi < h)
          std::memcpy(out + (y * w + x) * c, in + (yi * w + xi) * c,
                      (size_t)c);
      }
      xx += a[0];
      yy += a[3];
    }
    xo += a[1];
    yo += a[4];
  }
  return 0;
}


// The header of a PNG file's bytes: hdr[0..4] = width, height, bit depth,
// color type, interlace.  Returns 0 or a png.h error code.
int s2r_png_header(const uint8_t* data, int64_t len, int64_t* hdr) {
  png::Header hd;
  const int err = png::read(data, (size_t)len, hd, nullptr);
  if (err) return err;
  hdr[0] = hd.w;
  hdr[1] = hd.h;
  hdr[2] = hd.depth;
  hdr[3] = hd.color;
  hdr[4] = hd.interlace;
  return 0;
}

// Decode a PNG file's bytes into out (out_len bytes: h x w x the channels
// of `mode`, png.h kRaw 0 or kRgb 1).  Returns 0 or a png.h error code.
int s2r_png_read(const uint8_t* data, int64_t len, int mode, uint8_t* out,
                 int64_t out_len) {
  png::Header hd;
  std::vector<uint8_t> raw;
  int err = png::read(data, (size_t)len, hd, &raw);
  if (err) return err;
  if (!png::mode_ok(mode, hd.color, hd.depth)) return png::kErrUnsupported;
  if (out_len != hd.h * hd.w * png::out_channels(mode, hd.color, hd.depth))
    return png::kErrLength;
  return png::decode(raw.data(), (int64_t)raw.size(), hd, mode, out);
}

// The header of a JPEG file's bytes: hdr[0..3] = width, height,
// components, progressive.  Returns 0 or a jpeg.h error code.
int s2r_jpeg_header(const uint8_t* data, int64_t len, int64_t* hdr) {
  jpeg::Frame f;
  const int err = jpeg::parse(data, (size_t)len, f, true);
  if (err) return err;
  hdr[0] = f.w;
  hdr[1] = f.h;
  hdr[2] = f.ncomp;
  hdr[3] = f.progressive;
  return 0;
}

// Decode a JPEG file's bytes into out (out_len = h x w x 3 bytes), as
// Image.open(p).convert("RGB").  Returns 0 or a jpeg.h error code.
int s2r_jpeg_read(const uint8_t* data, int64_t len, uint8_t* out,
                  int64_t out_len) {
  return jpeg::decode_rgb(data, (size_t)len, out, out_len);
}

// Pillow's BILINEAR resample of uint8 [ih, iw, c] to [oh, ow, c] from the
// source window (x0, y0, x1, y1): ImagingResampleInner.  The caller takes
// Pillow's shortcuts (a same-size resize is a copy, an integer box of the
// output's size a crop) and checks the box.
int s2r_resize_bilinear(const uint8_t* in, int64_t ih, int64_t iw, int64_t c,
                        uint8_t* out, int64_t oh, int64_t ow, float x0,
                        float y0, float x1, float y1) {
  if (ih <= 0 || iw <= 0 || oh <= 0 || ow <= 0 || c <= 0) return 1;
  const bool need_h = ow != iw || x0 != 0.0f || x1 != (float)ow;
  const bool need_v = oh != ih || y0 != 0.0f || y1 != (float)oh;
  const Coeffs hc = precompute_coeffs(iw, x0, x1, ow);
  Coeffs vc = precompute_coeffs(ih, y0, y1, oh);
  const int ybox_first = vc.bounds[0];
  const int ybox_last = vc.bounds[(size_t)(oh * 2 - 2)]
                        + vc.bounds[(size_t)(oh * 2 - 1)];
  std::vector<uint8_t> tmp;
  const uint8_t* src = in;
  int64_t src_w = iw;
  if (need_h) {
    for (int64_t i = 0; i < oh; ++i) vc.bounds[(size_t)(i * 2)] -= ybox_first;
    const int64_t th = ybox_last - ybox_first;
    uint8_t* dst = need_v ? (tmp.resize((size_t)(th * ow * c)), tmp.data())
                          : out;
    for (int64_t yy = 0; yy < th; ++yy) {
      const uint8_t* line = in + (yy + ybox_first) * iw * c;
      uint8_t* o = dst + yy * ow * c;
      for (int64_t xx = 0; xx < ow; ++xx) {
        const int xmin = hc.bounds[(size_t)(xx * 2)];
        const int xmax = hc.bounds[(size_t)(xx * 2 + 1)];
        const int32_t* k = &hc.kk[(size_t)(xx * hc.ksize)];
        for (int64_t b = 0; b < c; ++b) {
          int ss = 1 << (PRECISION_BITS - 1);
          for (int x = 0; x < xmax; ++x)
            ss += line[(x + xmin) * c + b] * k[x];
          o[xx * c + b] = clip8(ss);
        }
      }
    }
    src = tmp.data();
    src_w = ow;
  }
  if (need_v) {
    for (int64_t yy = 0; yy < oh; ++yy) {
      const int ymin = vc.bounds[(size_t)(yy * 2)];
      const int ymax = vc.bounds[(size_t)(yy * 2 + 1)];
      const int32_t* k = &vc.kk[(size_t)(yy * vc.ksize)];
      uint8_t* o = out + yy * src_w * c;
      for (int64_t e = 0; e < src_w * c; ++e) {
        int ss = 1 << (PRECISION_BITS - 1);
        for (int y = 0; y < ymax; ++y)
          ss += src[(y + ymin) * src_w * c + e] * k[y];
        o[e] = clip8(ss);
      }
    }
  } else if (!need_h) {
    std::memcpy(out, in, (size_t)(ih * iw * c));
  }
  return 0;
}

// Pillow's GaussianBlur(radius) of uint8 [h, w, c] into out (both radii
// equal, three passes): ImagingGaussianBlur -> ImagingBoxBlur.
int s2r_gaussian_blur(const uint8_t* in, int64_t h, int64_t w, int64_t c,
                      float radius, uint8_t* out) {
  if (h <= 0 || w <= 0 || c <= 0) return 1;
  const int passes = 3;
  const float box = gaussian_blur_radius(radius, passes);
  const size_t total = (size_t)(h * w * c);
  if (box == 0.0f) {
    std::memcpy(out, in, total);
    return 0;
  }
  const int r = (int)box;
  const uint32_t ww = (uint32_t)((uint32_t)(1 << 24) / (box * 2 + 1));
  const uint32_t fw = ((1 << 24) - (r * 2 + 1) * ww) / 2;
  std::vector<uint8_t> a(in, in + total), b(total);
  std::vector<uint32_t> acc;
  for (int p = 0; p < passes; ++p) {  // along each row
    for (int64_t y = 0; y < h; ++y)
      box_pass(a.data() + y * w * c, b.data() + y * w * c, w, c, c, r, ww, fw,
               acc);
    a.swap(b);
  }
  for (int p = 0; p < passes; ++p) {  // down the columns, a row at a time
    box_pass(a.data(), b.data(), h, w * c, w * c, r, ww, fw, acc);
    a.swap(b);
  }
  std::memcpy(out, a.data(), total);
  return 0;
}

}  // extern "C"
