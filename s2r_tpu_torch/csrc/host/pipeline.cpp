// The native host pipeline of the data path (--data-backend native): PNG
// decode, PIL-style resize, label remap, normalization, and the threaded
// train and eval batch loaders, one C call a batch.
//
// The port's copy of s2r_tpu/native/src/pipeline.cpp.  The resampling,
// flip, blur, splitmix64 stream, the order of the draws (flip, short size,
// x1, y1, blur coin, then one radius an image), the resized frame's size
// taken from the source frame, the forced draws, emit_u8 and rectangular
// crops are that file's, line for line.  Two things differ:
// - Decode: png.h (shared with imaging.cpp) in place of libpng, which the
//   card's machine does not have: zlib inflates inside the pool, then the
//   port's unfiltering and pixel expansion.  Images decode as libpng's RGB
//   (strip_16, palette_to_rgb, strip_alpha, gray_to_rgb); labels as its one
//   channel, except that a palette label gives its indices (the JAX
//   package's palette_to_rgb + rgb_to_gray gives the luma of the palette
//   colours: ROADMAP C.12).
// - Failures: a batch call returns the 1-based index of the first item that
//   failed, and writes fail[0] = which file of the item (0 the image, 1 the
//   label, 2 the target) and fail[1] = the png.h error code, so the caller
//   names the file.
//
// Built with g++ -O3 -std=c++17 -shared -fPIC -pthread -ffp-contract=off
// -lz and no -march (s2r_tpu_torch/ops/kernels/build.py).  The JAX library
// builds with -march=native, where g++ may fuse a multiply-add in the blur
// and normalize: there the two libraries may differ by rounding
// (tests/test_torch_port_native.py states by how much).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include "png.h"

extern "C" {

// ---------------------------------------------------------------------------
// PNG decode
// ---------------------------------------------------------------------------

// Width and height of a PNG byte buffer.  Returns 0 or a png.h error code.
int s2r_png_info(const uint8_t* data, size_t len, int* w, int* h) {
  png::Header hd;
  const int err = png::read(data, len, hd, nullptr);
  if (err) return err;
  *w = (int)hd.w;
  *h = (int)hd.h;
  return 0;
}

// Decode a PNG byte buffer into out (w*h*force_channels bytes; query the
// size first with s2r_png_info).  force_channels: 1 (one channel: gray,
// luma of RGB, or palette indices) or 3 (RGB).  Returns 0 or a png.h error
// code; fills *w, *h.
int s2r_png_decode(const uint8_t* data, size_t len, int force_channels,
                   uint8_t* out, int* w, int* h) {
  if (force_channels != 1 && force_channels != 3) return png::kErrUnsupported;
  const int mode = force_channels == 3 ? png::kRgb : png::kGray;
  png::Header hd;
  std::vector<uint8_t> raw;
  int err = png::read(data, len, hd, &raw);
  if (!err) err = png::decode(raw.data(), (int64_t)raw.size(), hd, mode, out);
  if (err) return err;
  *w = (int)hd.w;
  *h = (int)hd.h;
  return 0;
}

// ---------------------------------------------------------------------------
// Resize — PIL-compatible
// ---------------------------------------------------------------------------

// PIL BILINEAR: triangle filter with support scaled by the downscale factor,
// separable horizontal-then-vertical passes (Pillow Resample.c semantics,
// float accumulation).
static void resample_1d_weights(int in_size, int out_size, double support_base,
                                std::vector<int>& bounds,
                                std::vector<double>& weights, int& ksize) {
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = support_base * filterscale;
  ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  bounds.resize(out_size * 2);
  weights.assign(static_cast<size_t>(out_size) * ksize, 0.0);
  for (int i = 0; i < out_size; ++i) {
    double center = (i + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* w = &weights[static_cast<size_t>(i) * ksize];
    double total = 0.0;
    for (int x = 0; x < xmax; ++x) {
      double arg = (x + xmin - center + 0.5) / filterscale;
      double val = arg < 0 ? 1.0 + arg : 1.0 - arg;  // triangle
      if (val < 0) val = 0;
      w[x] = val;
      total += val;
    }
    if (total != 0.0) {
      for (int x = 0; x < xmax; ++x) w[x] /= total;
    }
    bounds[i * 2] = xmin;
    bounds[i * 2 + 1] = xmax;
  }
}

// Pillow 8bpc fixed-point coefficients: normalized double weights quantized
// to int32 at PRECISION_BITS, accumulated in int with a rounding bias, u8
// intermediate between the passes (Pillow Resample.c semantics, bit-exact).
static const int kPrecisionBits = 32 - 8 - 2;

static void coefs_int(int in_size, int out_size, std::vector<int>& bounds,
                      std::vector<int32_t>& kk, int& ksize) {
  std::vector<double> w;
  resample_1d_weights(in_size, out_size, 1.0, bounds, w, ksize);
  kk.assign(static_cast<size_t>(out_size) * ksize, 0);
  for (int i = 0; i < out_size; ++i) {
    size_t off = static_cast<size_t>(i) * ksize;
    for (int j = 0; j < bounds[i * 2 + 1]; ++j) {
      double v = w[off + j] * (1 << kPrecisionBits);
      kk[off + j] = static_cast<int32_t>(v < 0 ? v - 0.5 : v + 0.5);
    }
  }
}

static inline uint8_t clip8(int64_t v) {
  v >>= kPrecisionBits;
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// uint8 HWC bilinear resize (any channel count), Pillow-bit-exact.
int s2r_resize_bilinear_u8(const uint8_t* src, int sw, int sh, int ch,
                           uint8_t* dst, int dw, int dh) {
  std::vector<int> hb, vb;
  std::vector<int32_t> hk_, vk_;
  int hk, vk;
  coefs_int(sw, dw, hb, hk_, hk);
  coefs_int(sh, dh, vb, vk_, vk);

  // horizontal pass: (sh, sw, ch) -> (sh, dw, ch), u8 intermediate
  std::vector<uint8_t> tmp(static_cast<size_t>(sh) * dw * ch);
  for (int y = 0; y < sh; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * sw * ch;
    uint8_t* trow = &tmp[static_cast<size_t>(y) * dw * ch];
    for (int x = 0; x < dw; ++x) {
      int xmin = hb[x * 2], xmax = hb[x * 2 + 1];
      const int32_t* w = &hk_[static_cast<size_t>(x) * hk];
      for (int c = 0; c < ch; ++c) {
        int64_t acc = 1 << (kPrecisionBits - 1);
        for (int k = 0; k < xmax; ++k) {
          acc += static_cast<int64_t>(row[(xmin + k) * ch + c]) * w[k];
        }
        trow[x * ch + c] = clip8(acc);
      }
    }
  }
  // vertical pass: (sh, dw, ch) -> (dh, dw, ch)
  for (int y = 0; y < dh; ++y) {
    int ymin = vb[y * 2], ymax = vb[y * 2 + 1];
    const int32_t* w = &vk_[static_cast<size_t>(y) * vk];
    uint8_t* drow = dst + static_cast<size_t>(y) * dw * ch;
    for (int x = 0; x < dw; ++x) {
      for (int c = 0; c < ch; ++c) {
        int64_t acc = 1 << (kPrecisionBits - 1);
        for (int k = 0; k < ymax; ++k) {
          acc += static_cast<int64_t>(
                     tmp[(static_cast<size_t>(ymin + k) * dw + x) * ch + c]) *
                 w[k];
        }
        drow[x * ch + c] = clip8(acc);
      }
    }
  }
  return 0;
}

// PIL NEAREST: src index = floor((i + 0.5) * scale) clamped.
int s2r_resize_nearest_u8(const uint8_t* src, int sw, int sh, int ch,
                          uint8_t* dst, int dw, int dh) {
  double xs = static_cast<double>(sw) / dw;
  double ys = static_cast<double>(sh) / dh;
  std::vector<int> xmap(dw);
  for (int x = 0; x < dw; ++x) {
    int v = static_cast<int>((x + 0.5) * xs);
    xmap[x] = std::min(v, sw - 1);
  }
  for (int y = 0; y < dh; ++y) {
    int sy = std::min(static_cast<int>((y + 0.5) * ys), sh - 1);
    const uint8_t* srow = src + static_cast<size_t>(sy) * sw * ch;
    uint8_t* drow = dst + static_cast<size_t>(y) * dw * ch;
    for (int x = 0; x < dw; ++x) {
      std::memcpy(drow + static_cast<size_t>(x) * ch,
                  srow + static_cast<size_t>(xmap[x]) * ch, ch);
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Pixel ops
// ---------------------------------------------------------------------------

void s2r_remap_u8(const uint8_t* in, uint8_t* out, size_t n,
                  const uint8_t* lut) {
  for (size_t i = 0; i < n; ++i) out[i] = lut[in[i]];
}

// (x/255 - mean) / std, RGB interleaved -> float32 HWC
void s2r_normalize_f32(const uint8_t* rgb, size_t npix, const float* mean,
                       const float* stdv, float* out) {
  float scale[3], bias[3];
  for (int c = 0; c < 3; ++c) {
    scale[c] = 1.0f / (255.0f * stdv[c]);
    bias[c] = -mean[c] / stdv[c];
  }
  for (size_t i = 0; i < npix; ++i) {
    for (int c = 0; c < 3; ++c) {
      out[i * 3 + c] = rgb[i * 3 + c] * scale[c] + bias[c];
    }
  }
}

static bool read_file(const char* path, std::vector<uint8_t>& buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  buf.resize(n);
  size_t got = std::fread(buf.data(), 1, n, f);
  std::fclose(f);
  return got == static_cast<size_t>(n);
}

// Read and decode the PNG file at `path` into img (w x h x the channels of
// `mode`).  Returns 0 or a png.h error code.
static int load_png(const char* path, int mode, std::vector<uint8_t>& buf,
                    std::vector<uint8_t>& raw, std::vector<uint8_t>& img,
                    int* w, int* h) {
  if (!read_file(path, buf)) return png::kErrRead;
  png::Header hd;
  const int err = png::decode_file(buf.data(), buf.size(), mode, hd, raw, img);
  if (err) return err;
  *w = (int)hd.w;
  *h = (int)hd.h;
  return 0;
}

// The first failure of a batch: its 1-based item, which file, and the code.
struct Failure {
  std::atomic<int> item{0};
  int what = 0, code = 0;
  bool set(int i, int which, int err) {  // true: this call recorded it
    int none = 0;
    if (!item.compare_exchange_strong(none, i + 1)) return false;
    what = which;
    code = err;
    return true;
  }
  int report(int32_t* fail) const {
    const int i = item.load();
    if (i && fail) {
      fail[0] = what;
      fail[1] = code;
    }
    return i;
  }
};

// ---------------------------------------------------------------------------
// Windowed resample: emit only the crop window of resize(src -> (ow, oh))
// padded right/bottom with `fill` — the RandomScaleCrop composition
// (custom_transforms.py:108-147) without materializing the full resized
// frame.  Output is (crop_h, crop_w, ch) at offset (x1, y1) of the padded
// resized frame.
// ---------------------------------------------------------------------------

static void resample_window_bilinear_u8(const uint8_t* src, int sw, int sh,
                                        int ch, int ow, int oh, int x1,
                                        int y1, int cw, int crop_h,
                                        uint8_t fill, uint8_t* dst) {
  std::vector<int> hb, vb;
  std::vector<int32_t> hk_, vk_;
  int hk, vk;
  coefs_int(sw, ow, hb, hk_, hk);
  coefs_int(sh, oh, vb, vk_, vk);

  int cx_lo = x1, cx_hi = std::min(x1 + cw, ow);  // real (non-pad) out cols
  int cy_lo = y1, cy_hi = std::min(y1 + crop_h, oh);
  int ncols = std::max(cx_hi - cx_lo, 0);
  int nrows = std::max(cy_hi - cy_lo, 0);

  if (nrows > 0 && ncols > 0) {
    // source row span feeding the needed output rows
    int row_lo = sh, row_hi = 0;
    for (int y = cy_lo; y < cy_hi; ++y) {
      row_lo = std::min(row_lo, vb[y * 2]);
      row_hi = std::max(row_hi, vb[y * 2] + vb[y * 2 + 1]);
    }
    // horizontal pass restricted to needed cols and rows (u8 intermediate,
    // identical per-pixel math to the full-frame pass -> bit-exact window)
    std::vector<uint8_t> tmp(static_cast<size_t>(row_hi - row_lo) * ncols *
                             ch);
    for (int y = row_lo; y < row_hi; ++y) {
      const uint8_t* row = src + static_cast<size_t>(y) * sw * ch;
      uint8_t* trow = &tmp[static_cast<size_t>(y - row_lo) * ncols * ch];
      for (int x = 0; x < ncols; ++x) {
        int ox = cx_lo + x;
        int xmin = hb[ox * 2], xmax = hb[ox * 2 + 1];
        const int32_t* w = &hk_[static_cast<size_t>(ox) * hk];
        for (int c = 0; c < ch; ++c) {
          int64_t acc = 1 << (kPrecisionBits - 1);
          for (int k = 0; k < xmax; ++k) {
            acc += static_cast<int64_t>(row[(xmin + k) * ch + c]) * w[k];
          }
          trow[x * ch + c] = clip8(acc);
        }
      }
    }
    // vertical pass into the destination window
    for (int y = cy_lo; y < cy_hi; ++y) {
      int ymin = vb[y * 2], ymax = vb[y * 2 + 1];
      const int32_t* w = &vk_[static_cast<size_t>(y) * vk];
      uint8_t* drow = dst + static_cast<size_t>(y - y1) * cw * ch;
      for (int x = 0; x < ncols; ++x) {
        for (int c = 0; c < ch; ++c) {
          int64_t acc = 1 << (kPrecisionBits - 1);
          for (int k = 0; k < ymax; ++k) {
            acc += static_cast<int64_t>(
                       tmp[(static_cast<size_t>(ymin - row_lo + k) * ncols +
                            x) * ch + c]) * w[k];
          }
          drow[x * ch + c] = clip8(acc);
        }
      }
    }
  }
  // right/bottom pad fill
  for (int y = 0; y < crop_h; ++y) {
    uint8_t* drow = dst + static_cast<size_t>(y) * cw * ch;
    int real_cols = (y1 + y < oh) ? ncols : 0;
    if (real_cols < cw) {
      std::memset(drow + static_cast<size_t>(real_cols) * ch, fill,
                  static_cast<size_t>(cw - real_cols) * ch);
    }
  }
}

static void resample_window_nearest_u8(const uint8_t* src, int sw, int sh,
                                       int ch, int ow, int oh, int x1, int y1,
                                       int cw, int crop_h, uint8_t fill,
                                       uint8_t* dst) {
  double xs = static_cast<double>(sw) / ow;
  double ys = static_cast<double>(sh) / oh;
  for (int y = 0; y < crop_h; ++y) {
    uint8_t* drow = dst + static_cast<size_t>(y) * cw * ch;
    int oy = y1 + y;
    if (oy >= oh) {
      std::memset(drow, fill, static_cast<size_t>(cw) * ch);
      continue;
    }
    int sy = std::min(static_cast<int>((oy + 0.5) * ys), sh - 1);
    const uint8_t* srow = src + static_cast<size_t>(sy) * sw * ch;
    for (int x = 0; x < cw; ++x) {
      int ox = x1 + x;
      if (ox >= ow) {
        std::memset(drow + static_cast<size_t>(x) * ch, fill,
                    static_cast<size_t>(cw - x) * ch);
        break;
      }
      int sx = std::min(static_cast<int>((ox + 0.5) * xs), sw - 1);
      std::memcpy(drow + static_cast<size_t>(x) * ch,
                  srow + static_cast<size_t>(sx) * ch, ch);
    }
  }
}

// Separable Gaussian blur, sigma = PIL GaussianBlur radius, clamped edges.
// (Approximate vs Pillow's implementation; augmentation parity is asserted
// at the distribution/mIoU level, SURVEY.md §7 hard-part 4.)
static void gaussian_blur_u8(uint8_t* img, int w, int h, int ch,
                             double sigma) {
  if (sigma <= 1e-3) return;
  int k = std::max(1, static_cast<int>(std::ceil(sigma * 3.0)));
  std::vector<float> kern(2 * k + 1);
  double s2 = 2.0 * sigma * sigma, total = 0.0;
  for (int i = -k; i <= k; ++i) {
    kern[i + k] = static_cast<float>(std::exp(-(double)i * i / s2));
    total += kern[i + k];
  }
  for (auto& v : kern) v = static_cast<float>(v / total);
  std::vector<float> tmp(static_cast<size_t>(w) * h * ch);
  for (int y = 0; y < h; ++y) {   // horizontal
    const uint8_t* row = img + static_cast<size_t>(y) * w * ch;
    float* trow = &tmp[static_cast<size_t>(y) * w * ch];
    for (int x = 0; x < w; ++x) {
      for (int c = 0; c < ch; ++c) {
        float acc = 0.f;
        for (int i = -k; i <= k; ++i) {
          int xx = std::min(std::max(x + i, 0), w - 1);
          acc += row[xx * ch + c] * kern[i + k];
        }
        trow[x * ch + c] = acc;
      }
    }
  }
  for (int y = 0; y < h; ++y) {   // vertical
    uint8_t* drow = img + static_cast<size_t>(y) * w * ch;
    for (int x = 0; x < w; ++x) {
      for (int c = 0; c < ch; ++c) {
        float acc = 0.f;
        for (int i = -k; i <= k; ++i) {
          int yy = std::min(std::max(y + i, 0), h - 1);
          acc += tmp[(static_cast<size_t>(yy) * w + x) * ch + c] * kern[i + k];
        }
        int v = static_cast<int>(std::lround(acc));
        drow[x * ch + c] = static_cast<uint8_t>(std::min(255, std::max(0, v)));
      }
    }
  }
}

static void hflip_u8(uint8_t* img, int w, int h, int ch) {
  std::vector<uint8_t> px(ch);
  for (int y = 0; y < h; ++y) {
    uint8_t* row = img + static_cast<size_t>(y) * w * ch;
    for (int x = 0; x < w / 2; ++x) {
      uint8_t* a = row + static_cast<size_t>(x) * ch;
      uint8_t* b = row + static_cast<size_t>(w - 1 - x) * ch;
      std::memcpy(px.data(), a, ch);
      std::memcpy(a, b, ch);
      std::memcpy(b, px.data(), ch);
    }
  }
}

// splitmix64 — deterministic per-sample augmentation RNG
static inline uint64_t sm64(uint64_t& s) {
  uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}
static inline double rng01(uint64_t& s) {
  return (sm64(s) >> 11) * (1.0 / 9007199254740992.0);
}
static inline int rng_int(uint64_t& s, int lo, int hi) {  // inclusive
  return lo + static_cast<int>(sm64(s) % static_cast<uint64_t>(hi - lo + 1));
}

// ---------------------------------------------------------------------------
// Threaded TRAIN batch pipeline — the full paired train-path per sample
// (reference worker pipeline, custom_transforms.py:7-147 composed per
// gtav2cityscapes.py:66-74):
//   decode src/lbl/tgt -> joint hflip(p=.5) -> RandomScaleCrop(base, crop)
//   -> GaussianBlur(p=.5, radius U(0,1), per image) -> normalize/remap.
// Label remap happens after crop (LUT commutes with NEAREST resize; pad
// fill 255 maps to 255).  tgt_paths may be null (source-only / gta5 path:
// outputs go to out_src/out_lbl only).
// `forced` (nullable, n*4 i32: flip, short_size, x1, y1) pins the geometric
// draws for cross-implementation tests; blur is skipped in forced mode.
// `emit_u8`: skip normalization and write u8 RGB into out_src/out_tgt
// (reinterpreted as uint8*) and u8 labels into out_lbl; the consumer
// normalizes on the device (data/device_aug.py normalize_u8_batch).
// Returns 0 on success, else the 1-based index of the first failed item
// (fail: which file, the code).
// ---------------------------------------------------------------------------

int s2r_train_batch(const char** src_paths, const char** lbl_paths,
                    const char** tgt_paths, int n, int base_size, int crop_h,
                    int crop_w, const uint8_t* lut, const float* mean,
                    const float* stdv, const uint64_t* seeds,
                    int blur_enable, const int32_t* forced, int emit_u8,
                    float* out_src, int32_t* out_lbl, float* out_tgt,
                    int nthreads, int32_t* fail) {
  std::atomic<int> next(0);
  Failure failed;
  auto worker = [&]() {
    std::vector<uint8_t> buf, raw, simg, slbl, timg, win, lwin;
    int i = -1;
    try {
      while (true) {
        i = next.fetch_add(1);
        if (i >= n || failed.item.load()) return;
        uint64_t rs = seeds ? seeds[i] : 0x243f6a8885a308d3ULL + i;
        int w = 0, h = 0, wl = 0, hl = 0, wt = 0, ht = 0;

        int err = load_png(src_paths[i], png::kRgb, buf, raw, simg, &w, &h);
        if (err) {
          failed.set(i, 0, err);
          return;
        }
        err = load_png(lbl_paths[i], png::kGray, buf, raw, slbl, &wl, &hl);
        if (err) {
          failed.set(i, 1, err);
          return;
        }
        bool has_tgt = tgt_paths && tgt_paths[i] && tgt_paths[i][0];
        if (has_tgt) {
          err = load_png(tgt_paths[i], png::kRgb, buf, raw, timg, &wt, &ht);
          if (err) {
            failed.set(i, 2, err);
            return;
          }
        }

        // --- joint geometric draws (order fixed for reproducibility) ---
        int flip, short_size, x1, y1;
        if (forced) {
          flip = forced[i * 4];
          short_size = forced[i * 4 + 1];
          x1 = forced[i * 4 + 2];
          y1 = forced[i * 4 + 3];
        } else {
          flip = rng01(rs) < 0.5;
          short_size = rng_int(rs, base_size / 2, base_size * 2);
        }
        // resized dims derive from the FIRST dict entry (src image) — all
        // entries resize to the same (ow, oh) like the reference
        int ow, oh;
        if (h > w) {
          ow = short_size;
          oh = static_cast<int>(1.0 * h * ow / w);
        } else {
          oh = short_size;
          ow = static_cast<int>(1.0 * w * oh / h);
        }
        int W = ow + std::max(crop_w - ow, 0);
        int H = oh + std::max(crop_h - oh, 0);
        if (!forced) {
          x1 = rng_int(rs, 0, W - crop_w);
          y1 = rng_int(rs, 0, H - crop_h);
        }

        if (flip) {
          hflip_u8(simg.data(), w, h, 3);
          hflip_u8(slbl.data(), wl, hl, 1);
          if (has_tgt) hflip_u8(timg.data(), wt, ht, 3);
        }

        win.resize(static_cast<size_t>(crop_h) * crop_w * 3);
        lwin.resize(static_cast<size_t>(crop_h) * crop_w);
        size_t npix = static_cast<size_t>(crop_h) * crop_w;

        double blur_coin = forced ? 1.0 : rng01(rs);
        resample_window_bilinear_u8(simg.data(), w, h, 3, ow, oh, x1, y1,
                                    crop_w, crop_h, 0, win.data());
        if (!forced && blur_enable && blur_coin < 0.5) {
          gaussian_blur_u8(win.data(), crop_w, crop_h, 3, rng01(rs));
        }
        if (emit_u8) {
          std::memcpy(reinterpret_cast<uint8_t*>(out_src) + static_cast<size_t>(i) * npix * 3,
                      win.data(), npix * 3);
        } else {
          s2r_normalize_f32(win.data(), npix, mean, stdv,
                            out_src + static_cast<size_t>(i) * npix * 3);
        }

        resample_window_nearest_u8(slbl.data(), wl, hl, 1, ow, oh, x1, y1,
                                   crop_w, crop_h, 255, lwin.data());
        if (emit_u8) {  // trainIds fit u8 (0..18, 255)
          uint8_t* ldst = reinterpret_cast<uint8_t*>(out_lbl) +
                          static_cast<size_t>(i) * npix;
          for (size_t p = 0; p < npix; ++p) ldst[p] = lut[lwin[p]];
        } else {
          int32_t* ldst = out_lbl + static_cast<size_t>(i) * npix;
          for (size_t p = 0; p < npix; ++p) ldst[p] = lut[lwin[p]];
        }

        if (has_tgt) {
          resample_window_bilinear_u8(timg.data(), wt, ht, 3, ow, oh, x1, y1,
                                      crop_w, crop_h, 0, win.data());
          if (!forced && blur_enable && blur_coin < 0.5) {
            gaussian_blur_u8(win.data(), crop_w, crop_h, 3, rng01(rs));
          }
          if (emit_u8) {
            std::memcpy(reinterpret_cast<uint8_t*>(out_tgt) + static_cast<size_t>(i) * npix * 3,
                        win.data(), npix * 3);
          } else {
            s2r_normalize_f32(win.data(), npix, mean, stdv,
                              out_tgt + static_cast<size_t>(i) * npix * 3);
          }
        }
      }
    } catch (const std::exception&) {  // an allocation of this item failed
      failed.set(i, 0, png::kErrAlloc);
    }
  };
  int nt = std::max(1, std::min(nthreads, n));
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failed.report(fail);
}

// ---------------------------------------------------------------------------
// Threaded batch eval pipeline:
//   per item: read file -> decode PNG -> resize to (crop, crop)
//   image: bilinear + normalize -> out_images[i]  [crop, crop, 3] f32
//   label: nearest + LUT remap  -> out_labels[i]  [crop, crop]   i32
// An item without a label (null or empty path) keeps the caller's fill.
// Returns 0 on success, else the 1-based index of the first failed item
// (fail: which file, the code).
// ---------------------------------------------------------------------------

int s2r_eval_batch(const char** img_paths, const char** lbl_paths, int n,
                   int crop, const uint8_t* lut, const float* mean,
                   const float* stdv, float* out_images, int32_t* out_labels,
                   int nthreads, int32_t* fail) {
  std::atomic<int> next(0);
  Failure failed;
  auto worker = [&]() {
    std::vector<uint8_t> buf, raw, img, lbl, rimg, rlbl;
    int i = -1;
    try {
      while (true) {
        i = next.fetch_add(1);
        if (i >= n || failed.item.load()) return;
        int w = 0, h = 0;
        // image
        int err = load_png(img_paths[i], png::kRgb, buf, raw, img, &w, &h);
        if (err) {
          failed.set(i, 0, err);
          return;
        }
        rimg.resize(static_cast<size_t>(crop) * crop * 3);
        s2r_resize_bilinear_u8(img.data(), w, h, 3, rimg.data(), crop, crop);
        s2r_normalize_f32(rimg.data(), static_cast<size_t>(crop) * crop, mean,
                          stdv,
                          out_images + static_cast<size_t>(i) * crop * crop * 3);
        // label (optional)
        if (lbl_paths && lbl_paths[i] && lbl_paths[i][0]) {
          err = load_png(lbl_paths[i], png::kGray, buf, raw, lbl, &w, &h);
          if (err) {
            failed.set(i, 1, err);
            return;
          }
          rlbl.resize(static_cast<size_t>(crop) * crop);
          s2r_resize_nearest_u8(lbl.data(), w, h, 1, rlbl.data(), crop, crop);
          int32_t* dst = out_labels + static_cast<size_t>(i) * crop * crop;
          for (size_t p = 0; p < static_cast<size_t>(crop) * crop; ++p) {
            dst[p] = lut[rlbl[p]];
          }
        }
      }
    } catch (const std::exception&) {  // an allocation of this item failed
      failed.set(i, 0, png::kErrAlloc);
    }
  };
  int nt = std::max(1, std::min(nthreads, n));
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failed.report(fail);
}

}  // extern "C"
