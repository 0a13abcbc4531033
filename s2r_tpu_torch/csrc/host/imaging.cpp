// Host imaging for the data pipeline: PNG unfiltering and pixel expansion,
// and Pillow's BILINEAR resample and GaussianBlur, bit for bit.
//
// Replaces what s2r_tpu/data/{transforms,datasets,hostcrop}.py take from PIL
// (Image.open().convert("RGB"), np.asarray(Image.open()), Image.resize with
// BILINEAR and box=, ImageFilter.GaussianBlur) and the decode half of
// s2r_tpu/native/src/pipeline.cpp, which needs libpng.  The card's machine
// has neither PIL nor libpng; it has g++.
//
// - PNG: the caller inflates the concatenated IDAT chunks (Python's zlib,
//   which releases the GIL) and passes the IHDR fields; s2r_png_decode
//   unfilters the scanlines (None, Sub, Up, Average, Paeth) two rows at a
//   time and expands each into the output: what np.asarray(Image.open(p))
//   gives (raw: palette indices, gray values, [.., 2] gray+alpha, [.., 4]
//   RGBA) or what .convert("RGB") gives (rgb).  8-bit gray, RGB, palette,
//   gray+alpha and RGBA; 1/2/4-bit gray and palette.  The caller refuses
//   16-bit and interlaced files.
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
// Built with g++ -O3 -std=c++17 -shared -fPIC -pthread -ffp-contract=off and
// no -march: a fused multiply-add would move a double coefficient by an ulp
// and the fixed-point rounding after it, so the bits would stop being
// Pillow's (s2r_tpu_torch/ops/kernels/build.py).  Every entry returns 0 on
// success and a positive code the Python side turns into an error.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------- PNG ---

int channels_of(int color_type) {
  switch (color_type) {
    case 0: return 1;  // gray
    case 2: return 3;  // RGB
    case 3: return 1;  // palette
    case 4: return 2;  // gray + alpha
    case 6: return 4;  // RGBA
    default: return 0;
  }
}

bool depth_ok(int color_type, int depth) {
  if (color_type == 0 || color_type == 3)
    return depth == 1 || depth == 2 || depth == 4 || depth == 8;
  return depth == 8;
}

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  if (pb <= pc) return (uint8_t)b;
  return (uint8_t)c;
}

// Undo one scanline's filter in place: cur holds the filtered bytes, prev
// the previous unfiltered row (zeros for the first).
bool unfilter(int type, uint8_t* cur, const uint8_t* prev, int64_t n,
              int64_t bpp) {
  switch (type) {
    case 0: return true;
    case 1:
      for (int64_t i = bpp; i < n; ++i) cur[i] = (uint8_t)(cur[i] + cur[i - bpp]);
      return true;
    case 2:
      for (int64_t i = 0; i < n; ++i) cur[i] = (uint8_t)(cur[i] + prev[i]);
      return true;
    case 3:
      for (int64_t i = 0; i < n; ++i) {
        int left = i >= bpp ? cur[i - bpp] : 0;
        cur[i] = (uint8_t)(cur[i] + ((left + prev[i]) >> 1));
      }
      return true;
    case 4:
      for (int64_t i = 0; i < n; ++i) {
        int left = i >= bpp ? cur[i - bpp] : 0;
        int upleft = i >= bpp ? prev[i - bpp] : 0;
        cur[i] = (uint8_t)(cur[i] + paeth(left, prev[i], upleft));
      }
      return true;
    default: return false;
  }
}

// Pillow's unpackers scale low-depth gray to 0..255 ("L;2", "L;4"); 1-bit
// gray is mode "1", whose array is 0/1 and whose RGB is 0/255.
inline int gray_scale(int depth, bool rgb) {
  switch (depth) {
    case 1: return rgb ? 255 : 1;
    case 2: return 85;
    case 4: return 17;
    default: return 1;
  }
}

void expand_row(const uint8_t* row, int64_t w, int color_type, int depth,
                const uint8_t* palette, bool rgb, uint8_t* out) {
  const int ch = channels_of(color_type);
  if (depth < 8) {  // gray or palette, one sample a pixel
    const int mask = (1 << depth) - 1, scale = gray_scale(depth, rgb);
    for (int64_t x = 0; x < w; ++x) {
      const int64_t bit = x * depth;
      const int v = (row[bit >> 3] >> (8 - depth - (bit & 7))) & mask;
      if (color_type == 3) {
        if (rgb) std::memcpy(out + 3 * x, palette + 3 * v, 3);
        else out[x] = (uint8_t)v;
      } else if (rgb) {
        out[3 * x] = out[3 * x + 1] = out[3 * x + 2] = (uint8_t)(v * scale);
      } else {
        out[x] = (uint8_t)(v * scale);
      }
    }
    return;
  }
  if (!rgb) {  // the samples as they are; palette indices stay indices
    std::memcpy(out, row, (size_t)(w * ch));
    return;
  }
  for (int64_t x = 0; x < w; ++x) {
    const uint8_t* p = row + x * ch;
    uint8_t* o = out + 3 * x;
    switch (color_type) {
      case 3: std::memcpy(o, palette + 3 * p[0], 3); break;
      case 0:
      case 4: o[0] = o[1] = o[2] = p[0]; break;  // alpha dropped
      default: o[0] = p[0]; o[1] = p[1]; o[2] = p[2];  // RGB, RGBA
    }
  }
}

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

}  // namespace

extern "C" {

// Decode the inflated IDAT stream of a non-interlaced PNG of h x w pixels
// into out: [h, w] or [h, w, channels] raw samples (rgb 0), or [h, w, 3]
// RGB (rgb 1).  palette: 768 bytes, the PLTE entries and Pillow's fill for
// the rest (palette images only).  Returns 1 for a color type or depth it
// does not take, 2 for a stream of the wrong length, 3 for an unknown
// filter type.
int s2r_png_decode(const uint8_t* data, int64_t len, int64_t h, int64_t w,
                   int color_type, int depth, const uint8_t* palette, int rgb,
                   uint8_t* out) {
  const int ch = channels_of(color_type);
  if (ch == 0 || !depth_ok(color_type, depth)) return 1;
  const int64_t bits = (int64_t)ch * depth;
  const int64_t rowbytes = (w * bits + 7) / 8;
  const int64_t bpp = bits >= 8 ? bits / 8 : 1;
  if (len != h * (rowbytes + 1)) return 2;
  const int64_t out_row = w * (rgb ? 3 : ch);
  std::vector<uint8_t> rows((size_t)(2 * rowbytes), 0);
  uint8_t* prev = rows.data();
  uint8_t* cur = rows.data() + rowbytes;
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* src = data + y * (rowbytes + 1);
    std::memcpy(cur, src + 1, (size_t)rowbytes);
    if (!unfilter(src[0], cur, prev, rowbytes, bpp)) return 3;
    expand_row(cur, w, color_type, depth, palette, rgb != 0,
               out + y * out_row);
    std::swap(prev, cur);
  }
  return 0;
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
