// The PNG reader of the host libraries (imaging.cpp, pipeline.cpp): the
// chunk walk, the inflate of the IDAT stream (zlib), Adam7, unfiltering, and
// the expansion of each row into the samples a caller asks for.  Neither
// the card's machine nor the port needs libpng or PIL.
//
// Modes of the output:
// - kRaw: np.asarray(Image.open(p), np.uint8): palette indices stay
//   indices, gray at 1/2/4 bits is Pillow's "1" (0/1), "L;2" (x85) and
//   "L;4" (x17), other files their samples ([h, w, channels]).  At 16 bits
//   RGB and RGBA give their high bytes (Pillow's "RGB;16B", "RGBA;16B"),
//   gray its low bytes (Pillow's "I;16", cast to uint8), and gray+alpha
//   Pillow's RGBA ("LA;16B": the gray's high byte thrice, the alpha's).
// - kRgb: Image.open(p).convert("RGB"), which is also what libpng gives
//   with palette_to_rgb, expand_gray_1_2_4_to_8, strip_alpha, gray_to_rgb
//   and strip_16 (the high byte of each 16-bit sample).
// - kPilRgb: kRgb but for 16-bit gray, which Pillow opens as "I;16" and
//   converts to min(v, 255) (the PIL route's convert("RGB")).
// - kGray: libpng's one channel as the JAX package's native pipeline asks
//   for it (strip_16, expand_gray_1_2_4_to_8, strip_alpha, rgb_to_gray with
//   red 0.299 and green 0.114 as it passes them: integer coefficients 9797
//   and 3735 of 32768, blue the rest, truncated at 8 bits and rounded at 16
//   as libpng computes them when the file has no gAMA or sRGB chunk), except
//   that a palette file gives its indices, as np.asarray(Image.open(p))
//   does: libpng's palette_to_rgb would give the luma of the palette colours
//   (ROADMAP C.12).  Where an 8-bit RGB(A) file's gamma (a gAMA chunk, or
//   an sRGB chunk's 45455, before PLTE and IDAT) is more than 5% from 1,
//   libpng converts in linear light: each sample of a pixel whose samples
//   differ through a table to gamma 1, the sum rounded, back through a
//   table to the file's gamma (png_do_rgb_to_gray, png_build_gamma_table:
//   tables of floor(255 * pow(i / 255, g) + .5) for the reciprocal gammas
//   libpng rounds in 1e-5 units); a 16-bit one would take libpng's 16-bit
//   tables, which the reader refuses.
//
// Each function returns 0 or one of the codes of kErr* below.

#pragma once

#include <zlib.h>

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <memory>
#include <vector>

namespace {
namespace png {

enum Mode { kRaw = 0, kRgb = 1, kGray = 2, kPilRgb = 3 };

enum Err {
  kErrUnsupported = 1,  // a color type or depth the mode does not take
  kErrLength = 2,       // the inflated stream has the wrong length
  kErrFilter = 3,       // an unknown filter type
  kErrSignature = 4,    // not a PNG file
  kErrChunk = 5,        // a chunk runs past the end or fails its CRC
  kErrHeader = 6,       // no IHDR or no IDAT, or an IHDR out of range
  kErrInflate = 7,      // zlib refused the stream
  kErrRead = 8,         // the file could not be read
  kErrAlloc = 9,        // too large to decode in memory
};

// Deflate expands a stream at most 1032-fold: a header that asks for more
// image bytes than this file could inflate to is broken, and is refused
// before anything is allocated for it.
constexpr int64_t kMaxInflate = 1100;

struct Header {
  int64_t w = 0, h = 0;
  int depth = 0, color = 0, interlace = 0;
  int64_t gamma = 0;     // the file's gamma in 1e-5 (gAMA, sRGB), 0: none
  uint8_t palette[768];  // the PLTE entries, then black (Pillow's fill)
};

// libpng's gamma arithmetic (png.c), in 1e-5 units: significance at 5%,
// the rounded reciprocals, and the 8-bit correction table.
constexpr int64_t kFp1 = 100000, kGammaThreshold = 5000;
inline bool gamma_significant(int64_t g) {
  return g < kFp1 - kGammaThreshold || g > kFp1 + kGammaThreshold;
}
inline int64_t reciprocal(int64_t a) {
  const double r = std::floor(1E10 / (double)a + .5);
  return r <= 2147483647. && r >= -2147483648. ? (int64_t)r : 0;
}
inline int64_t reciprocal2(int64_t a, int64_t b) {
  double r = 1E15 / (double)a;
  r /= (double)b;
  r = std::floor(r + .5);
  return r <= 2147483647. && r >= -2147483648. ? (int64_t)r : 0;
}
inline void gamma_table8(int64_t g, uint8_t* table) {
  for (int i = 0; i < 256; ++i) {
    table[i] = (uint8_t)i;
    if (gamma_significant(g) && i > 0 && i < 255)
      table[i] = (uint8_t)std::floor(
          255 * std::pow(i / 255., (double)g * .00001) + .5);
  }
}

// The tables of an 8-bit rgb_to_gray with gamma: to linear light, back,
// and for pixels whose samples are equal.
struct GrayGamma {
  uint8_t to_1[256], from_1[256], same[256];
  explicit GrayGamma(int64_t file_gamma) {
    const int64_t screen = reciprocal(file_gamma);
    gamma_table8(reciprocal2(file_gamma, screen), same);
    gamma_table8(screen, to_1);
    gamma_table8(reciprocal(screen), from_1);
  }
};

// Whether kGray of a file with this header takes libpng's gamma path.
inline bool gray_gamma(const Header& hd) {
  return (hd.color == 2 || hd.color == 6) && hd.gamma != 0 &&
         (gamma_significant(hd.gamma) ||
          gamma_significant(reciprocal(hd.gamma)));
}

inline int channels_of(int color) {
  switch (color) {
    case 0: return 1;  // gray
    case 2: return 3;  // RGB
    case 3: return 1;  // palette
    case 4: return 2;  // gray + alpha
    case 6: return 4;  // RGBA
    default: return 0;
  }
}

// The depths the PNG specification allows for each color type.
inline bool depth_ok(int color, int depth) {
  switch (color) {
    case 0: return depth == 1 || depth == 2 || depth == 4 || depth == 8 ||
                   depth == 16;
    case 3: return depth == 1 || depth == 2 || depth == 4 || depth == 8;
    case 2: case 4: case 6: return depth == 8 || depth == 16;
    default: return false;
  }
}

// Channels of kRaw's output: Pillow gives 16-bit gray+alpha as RGBA.
inline int raw_channels(int color, int depth) {
  return color == 4 && depth == 16 ? 4 : channels_of(color);
}

// Channels of a mode's output for a file of `color`.
inline int out_channels(int mode, int color, int depth) {
  if (mode == kRgb || mode == kPilRgb) return 3;
  if (mode == kGray) return 1;
  return raw_channels(color, depth);
}

// Whether `mode` takes files of this color type and depth.
inline bool mode_ok(int mode, int color, int depth) {
  if (!depth_ok(color, depth)) return false;
  return mode == kRaw || mode == kRgb || mode == kGray || mode == kPilRgb;
}


inline uint32_t be32(const uint8_t* p) {
  return (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 |
         (uint32_t)p[3];
}

inline int64_t rowbytes(int64_t w, int bits) { return (w * bits + 7) / 8; }

// Adam7: (x0, y0, dx, dy) of each pass; one pass of step 1 without it.
constexpr int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                              {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                              {0, 1, 1, 2}};
constexpr int kFlat[1][4] = {{0, 0, 1, 1}};

inline int64_t pass_extent(int64_t n, int start, int step) {
  return n > start ? (n - start + step - 1) / step : 0;
}

// Bytes of the inflated stream of a file with this header.
inline int64_t stream_bytes(const Header& hd) {
  const int bits = channels_of(hd.color) * hd.depth;
  const int npass = hd.interlace ? 7 : 1;
  int64_t total = 0;
  for (int p = 0; p < npass; ++p) {
    const int* ps = hd.interlace ? kAdam7[p] : kFlat[0];
    const int64_t pw = pass_extent(hd.w, ps[0], ps[2]);
    const int64_t ph = pass_extent(hd.h, ps[1], ps[3]);
    if (pw > 0 && ph > 0) total += ph * (rowbytes(pw, bits) + 1);
  }
  return total;
}

// Walk the chunks of `data`: the header (IHDR, PLTE), and with `raw` the
// IDAT stream inflated into it.  Without `raw` the walk stops after IHDR.
inline int read(const uint8_t* data, size_t len, Header& hd,
                std::vector<uint8_t>* raw) {
  static const uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  if (len < 8 || std::memcmp(data, kSig, 8) != 0) return kErrSignature;
  std::memset(hd.palette, 0, sizeof(hd.palette));
  bool have_ihdr = false, have_idat = false, have_plte = false;
  bool have_gama = false, have_srgb = false;
  hd.gamma = 0;
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  int64_t want = 0;
  int zret = Z_OK, err = 0;
  size_t pos = 8;
  while (pos + 12 <= len) {
    const uint32_t n = be32(data + pos);
    const uint8_t* kind = data + pos + 4;
    const uint8_t* body = data + pos + 8;
    if ((uint64_t)pos + 12 + n > len) { err = kErrChunk; break; }
    const uint32_t crc = (uint32_t)crc32(crc32(0L, kind, 4), body, n);
    if (crc != be32(body + n)) { err = kErrChunk; break; }
    if (std::memcmp(kind, "IHDR", 4) == 0) {
      if (n != 13 || have_ihdr) { err = kErrHeader; break; }
      hd.w = be32(body);
      hd.h = be32(body + 4);
      hd.depth = body[8];
      hd.color = body[9];
      hd.interlace = body[12];
      if (hd.w <= 0 || hd.h <= 0 || hd.w > 0x7fffffff || hd.h > 0x7fffffff ||
          hd.w * hd.h > (int64_t{1} << 50) || hd.interlace > 1) {
        err = kErrHeader;
        break;
      }
      have_ihdr = true;
      if (raw == nullptr) break;
      if (!depth_ok(hd.color, hd.depth)) { err = kErrUnsupported; break; }
      want = stream_bytes(hd);
      if (want / kMaxInflate > (int64_t)len) { err = kErrLength; break; }
      try {
        raw->resize((size_t)want + 1);  // a byte over: a longer stream shows
      } catch (const std::exception&) {
        err = kErrAlloc;
        break;
      }
      if (inflateInit(&zs) != Z_OK) { err = kErrInflate; break; }
      zs.next_out = raw->data();
      zs.avail_out = (uInt)(want + 1);
    } else if (std::memcmp(kind, "PLTE", 4) == 0) {
      std::memcpy(hd.palette, body, n < 768 ? n : 768);
      have_plte = true;
    } else if (std::memcmp(kind, "gAMA", 4) == 0) {
      // libpng takes the first in range before PLTE and IDAT; sRGB's wins
      const int64_t g = n == 4 ? be32(body) : 0;
      if (!have_plte && !have_idat && !have_gama && !have_srgb && g >= 16 &&
          g <= 625000000) {
        hd.gamma = g;
        have_gama = true;
      }
    } else if (std::memcmp(kind, "sRGB", 4) == 0) {
      if (!have_plte && !have_idat && !have_srgb && n == 1) {
        hd.gamma = 45455;  // PNG_GAMMA_sRGB_INVERSE
        have_srgb = true;
      }
    } else if (std::memcmp(kind, "IDAT", 4) == 0 && raw != nullptr) {
      if (!have_ihdr) { err = kErrHeader; break; }
      have_idat = true;
      if (zret != Z_STREAM_END && n > 0) {
        zs.next_in = const_cast<uint8_t*>(body);
        zs.avail_in = n;
        zret = inflate(&zs, Z_NO_FLUSH);
        if (zret != Z_OK && zret != Z_STREAM_END &&
            !(zret == Z_BUF_ERROR && zs.avail_out == 0)) {
          err = kErrInflate;
          break;
        }
        if (zs.avail_out == 0) { err = kErrLength; break; }
      }
    } else if (std::memcmp(kind, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + (size_t)n;
  }
  if (raw != nullptr && have_ihdr && want > 0) {
    const int64_t got = (int64_t)zs.total_out;
    inflateEnd(&zs);
    if (!err && !have_idat) err = kErrHeader;
    if (!err && zret != Z_STREAM_END) err = got < want ? kErrLength
                                                       : kErrInflate;
    if (!err && got != want) err = kErrLength;
    if (!err) raw->resize((size_t)want);  // drops the byte over
  }
  if (!err && !have_ihdr) err = kErrHeader;
  return err;
}

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  if (pb <= pc) return (uint8_t)b;
  return (uint8_t)c;
}

// Undo one scanline's filter in place: cur holds the filtered bytes, prev
// the previous unfiltered row of its pass (zeros for the first).
inline bool unfilter(int type, uint8_t* cur, const uint8_t* prev, int64_t n,
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
// gray is mode "1", whose array is 0/1 and whose RGB is 0/255.  libpng's
// expand_gray_1_2_4_to_8 scales as Pillow's RGB does.
inline int gray_scale(int depth, bool raw) {
  switch (depth) {
    case 1: return raw ? 1 : 255;
    case 2: return 85;
    case 4: return 17;
    default: return 1;
  }
}

// libpng's rgb_to_gray(0.299, 0.114) in integers of 32768.
constexpr uint32_t kRedCoeff = 29900u * 32768u / 100000u;    // 9797
constexpr uint32_t kGreenCoeff = 11400u * 32768u / 100000u;  // 3735
constexpr uint32_t kBlueCoeff = 32768u - kRedCoeff - kGreenCoeff;

// Sample `s` of pixel x in an unfiltered row of `ch` samples a pixel at
// `depth` bits: the value, and at 16 bits the whole 16-bit value.
inline uint32_t sample(const uint8_t* row, int64_t x, int ch, int s,
                       int depth) {
  if (depth == 8) return row[x * ch + s];
  if (depth == 16) {
    const uint8_t* p = row + 2 * (x * ch + s);
    return (uint32_t)p[0] << 8 | p[1];
  }
  const int64_t bit = x * depth;  // one sample a pixel below 8 bits
  return (row[bit >> 3] >> (8 - depth - (bit & 7))) & ((1 << depth) - 1);
}

// Expand one unfiltered row of w pixels into out (w pixels of the mode's
// channels).
inline void expand_row(const uint8_t* row, int64_t w, const Header& hd,
                       int mode, const GrayGamma* gg, uint8_t* out) {
  const int color = hd.color, depth = hd.depth, ch = channels_of(color);
  if (mode == kPilRgb && !(depth == 16 && color == 0)) mode = kRgb;
  const int shift = depth == 16 ? 8 : 0;  // 16 bits: the high byte
  if (mode == kRaw && depth == 8) {  // the samples as they are
    std::memcpy(out, row, (size_t)(w * ch));
    return;
  }
  for (int64_t x = 0; x < w; ++x) {
    if (color == 3) {
      const uint32_t v = sample(row, x, 1, 0, depth);
      if (mode == kRgb) std::memcpy(out + 3 * x, hd.palette + 3 * v, 3);
      else out[x] = (uint8_t)v;
    } else if ((mode == kRaw || mode == kPilRgb) && depth == 16 &&
               color == 0) {
      const uint32_t v = sample(row, x, 1, 0, depth);  // Pillow's "I;16"
      if (mode == kPilRgb)
        out[3 * x] = out[3 * x + 1] = out[3 * x + 2] =
            (uint8_t)(v < 255 ? v : 255);
      else
        out[x] = (uint8_t)v;  // the low byte
    } else if (mode == kRaw && depth == 16 && color == 4) {  // "LA;16B"
      out[4 * x] = out[4 * x + 1] = out[4 * x + 2] =
          (uint8_t)(sample(row, x, 2, 0, depth) >> 8);
      out[4 * x + 3] = (uint8_t)(sample(row, x, 2, 1, depth) >> 8);
    } else if (color == 0 || color == 4) {
      uint32_t v = sample(row, x, ch, 0, depth);
      v = depth < 8 ? v * gray_scale(depth, mode == kRaw) : v >> shift;
      if (mode == kRgb) out[3 * x] = out[3 * x + 1] = out[3 * x + 2] = (uint8_t)v;
      else out[x] = (uint8_t)v;  // kGray, or kRaw gray below 8 bits
    } else {  // RGB, RGBA
      const uint32_t r = sample(row, x, ch, 0, depth);
      const uint32_t g = sample(row, x, ch, 1, depth);
      const uint32_t b = sample(row, x, ch, 2, depth);
      if (mode == kGray) {
        uint32_t v;
        if (depth == 16) {
          v = ((kRedCoeff * r + kGreenCoeff * g + kBlueCoeff * b + 16384) >>
               15) >> 8;
        } else if (gg != nullptr) {  // in linear light
          v = (r == g && r == b)
                  ? gg->same[r]
                  : gg->from_1[(kRedCoeff * gg->to_1[r] +
                                kGreenCoeff * gg->to_1[g] +
                                kBlueCoeff * gg->to_1[b] + 16384) >> 15];
        } else {
          v = (r == g && r == b) ? r
              : (kRedCoeff * r + kGreenCoeff * g + kBlueCoeff * b) >> 15;
        }
        out[x] = (uint8_t)v;
      } else {
        const int oc = mode == kRgb ? 3 : ch;
        for (int s = 0; s < oc; ++s)
          out[oc * x + s] = (uint8_t)(sample(row, x, ch, s, depth) >> shift);
      }
    }
  }
}

// Decode the inflated stream `raw` of a file with header `hd` into out,
// h x w pixels of out_channels(mode, color, depth) samples.
inline int decode(const uint8_t* raw, int64_t len, const Header& hd, int mode,
                  uint8_t* out) {
  if (!mode_ok(mode, hd.color, hd.depth)) return kErrUnsupported;
  if (len != stream_bytes(hd)) return kErrLength;
  const int bits = channels_of(hd.color) * hd.depth;
  const int64_t bpp = bits >= 8 ? bits / 8 : 1;
  const int oc = out_channels(mode, hd.color, hd.depth);
  const bool linear = mode == kGray && gray_gamma(hd);
  if (linear && hd.depth == 16) return kErrUnsupported;  // 16-bit tables
  std::unique_ptr<GrayGamma> tables;
  if (linear) tables.reset(new GrayGamma(hd.gamma));
  const GrayGamma* gg = tables.get();
  const int npass = hd.interlace ? 7 : 1;
  const int64_t max_row = rowbytes(hd.w, bits);
  std::vector<uint8_t> rows, pixels;
  try {
    rows.resize((size_t)(2 * max_row));
    if (hd.interlace) pixels.resize((size_t)(hd.w * oc));
  } catch (const std::exception&) {
    return kErrAlloc;
  }
  const uint8_t* src = raw;
  for (int p = 0; p < npass; ++p) {
    const int* ps = hd.interlace ? kAdam7[p] : kFlat[0];
    const int64_t pw = pass_extent(hd.w, ps[0], ps[2]);
    const int64_t ph = pass_extent(hd.h, ps[1], ps[3]);
    if (pw == 0 || ph == 0) continue;
    const int64_t rb = rowbytes(pw, bits);
    uint8_t* prev = rows.data();
    uint8_t* cur = rows.data() + max_row;
    std::memset(prev, 0, (size_t)rb);
    for (int64_t r = 0; r < ph; ++r, src += rb + 1) {
      std::memcpy(cur, src + 1, (size_t)rb);
      if (!unfilter(src[0], cur, prev, rb, bpp)) return kErrFilter;
      const int64_t y = ps[1] + r * ps[3];
      if (!hd.interlace) {
        expand_row(cur, pw, hd, mode, gg, out + y * hd.w * oc);
      } else {
        expand_row(cur, pw, hd, mode, gg, pixels.data());
        uint8_t* orow = out + y * hd.w * oc;
        for (int64_t i = 0; i < pw; ++i)
          std::memcpy(orow + (ps[0] + i * ps[2]) * oc, &pixels[i * oc],
                      (size_t)oc);
      }
      std::swap(prev, cur);
    }
  }
  return 0;
}

// Read, inflate and decode a whole PNG file's bytes into `out` (resized to
// h x w x out_channels); `raw` is the caller's scratch.
inline int decode_file(const uint8_t* data, size_t len, int mode, Header& hd,
                       std::vector<uint8_t>& raw, std::vector<uint8_t>& out) {
  int err = read(data, len, hd, &raw);
  if (err) return err;
  if (!mode_ok(mode, hd.color, hd.depth)) return kErrUnsupported;
  try {
    out.resize((size_t)(hd.h * hd.w * out_channels(mode, hd.color,
                                                    hd.depth)));
  } catch (const std::exception&) {
    return kErrAlloc;
  }
  return decode(raw.data(), (int64_t)raw.size(), hd, mode, out.data());
}

}  // namespace png
}  // namespace
