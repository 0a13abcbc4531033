// The JPEG reader of the host library (imaging.cpp): Image.open(p).convert(
// "RGB") of a JPEG file as Pillow computes it through libjpeg-turbo's
// default decompression, bit for bit, without libjpeg (the card's machine
// has none):
//
// - baseline and extended sequential Huffman scans (SOF0, SOF1) and
//   progressive Huffman scans (SOF2: DC and AC first passes, successive
//   approximation refinement, EOB runs), 8-bit samples, one component
//   (gray, given to RGB as Pillow's convert replicates it) or three
//   (YCbCr, or RGB under an Adobe marker with transform 0 or component
//   ids 'R' 'G' 'B', as libjpeg guesses the color space), any sampling
//   factors 1-4 whose ratios are integral, restart intervals, any size;
// - the ISLOW integer IDCT (jidctint.c: 13-bit constants, two descaling
//   passes, the output saturated at 8 bits as the x86 SIMD build does);
// - libjpeg's "fancy" upsampling (jdsample.c): h2v1 and h2v2 triangle
//   filters with their alternating biases where the component is wider
//   than 2 samples (box replication otherwise), h1v2, and box replication
//   for the other integral ratios; the rows above the first and below the
//   last real row are copies of them, as libjpeg's context rows are;
// - the YCbCr->RGB tables of jdcolor.c (16-bit fixed point).
//
// A progressive file whose first ten coefficients are not all at full
// precision after its last scan would be block-smoothed by libjpeg
// (jdcoefct.c smoothing_ok): refused, as are arithmetic coding,
// lossless and hierarchical files, 12-bit samples, 2 or 4 components
// (CMYK/YCCK), a DNL marker, and scans without Huffman tables (which
// libjpeg would take from the standard ones).
//
// Each function returns 0 or one of the codes of kErr* below.

#pragma once

#include <cstdint>
#include <cstring>
#include <new>
#include <stdexcept>
#include <vector>

namespace {
namespace jpeg {

enum Err {
  kErrUnsupported = 1,  // a kind of JPEG the reader refuses (above)
  kErrData = 2,         // the entropy-coded data is broken or truncated
  kErrSignature = 4,    // not a JPEG file
  kErrMarker = 5,       // a marker segment runs past the end or is broken
  kErrHeader = 6,       // no frame, no scan, or a table a scan needs
  kErrAlloc = 9,        // too large to decode in memory
};

// The zigzag order: natural index of the k-th coefficient, with 16 more
// entries of 63 so a corrupt run cannot index past the block.
constexpr int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huff {
  bool defined = false;
  int32_t maxcode[18];    // largest code of each length, -1 for none
  int32_t valoffset[18];  // value index of a length's first code - code
  uint8_t vals[256];
  uint16_t look[1 << kLookBits];  // (length << 8) | value, 0: longer

  bool build(const uint8_t* counts, const uint8_t* values, int nvals) {
    int total = 0;
    for (int l = 1; l <= 16; ++l) total += counts[l - 1];
    if (total > 256 || total != nvals) return false;
    std::memcpy(vals, values, nvals);
    std::memset(look, 0, sizeof(look));
    int32_t code = 0;
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
      const int n = counts[l - 1];
      if (n) {
        valoffset[l] = p - code;
        if (l <= kLookBits) {
          for (int i = 0; i < n; ++i) {
            const int c = (code + i) << (kLookBits - l);
            for (int j = 0; j < (1 << (kLookBits - l)); ++j)
              look[c + j] = (uint16_t)(l << 8 | vals[p + i]);
          }
        }
        code += n;
        p += n;
        maxcode[l] = code - 1;
      } else {
        maxcode[l] = -1;
      }
      if (code > (1 << l)) return false;  // more codes than the length holds
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
    return true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;          // the scan's DC and AC tables
  int64_t bw = 0, bh = 0;      // blocks stored: the MCU grid's
  int64_t wb = 0, hb = 0;      // blocks holding samples (width_in_blocks)
  int64_t dw = 0, dh = 0;      // samples (downsampled_width, _height)
  int dc_pred = 0;
  int coef_bits[64];
  std::vector<int16_t> coef;   // [bh][bw][64], natural order
  std::vector<uint8_t> plane;  // [hb*8][wb*8] after the IDCT
};

struct Frame {
  int64_t w = 0, h = 0;
  int ncomp = 0, hmax = 1, vmax = 1;
  bool progressive = false;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int64_t mcux = 0, mcuy = 0;
  int restart = 0;
  Component comp[3];
  uint16_t quant[4][64];  // natural order
  bool quant_defined[4] = {false, false, false, false};
  Huff dc[4], ac[4];
};

inline int be16(const uint8_t* p) { return p[0] << 8 | p[1]; }

// The bits of one scan's entropy-coded segment.  Stuffed zero bytes are
// dropped; at a marker the reader stops and gives zeros, as libjpeg does.
struct Bits {
  const uint8_t* data;
  size_t len, pos;
  uint64_t buf = 0;
  int nbits = 0;
  bool at_marker = false;

  void fill() {
    while (nbits <= 56) {
      uint8_t b = 0;
      if (!at_marker && pos < len) {
        b = data[pos];
        if (b == 0xFF) {
          // fill bytes (0xFF 0xFF ...) precede a marker; 0xFF 0x00 is a
          // stuffed 0xFF
          size_t q = pos + 1;
          while (q < len && data[q] == 0xFF) ++q;
          if (q < len && data[q] == 0x00) {
            pos = q + 1;
          } else {
            at_marker = true;
            pos = q - 1;  // at the marker's last 0xFF
            b = 0;
          }
        } else {
          ++pos;
        }
      }
      buf |= (uint64_t)b << (56 - nbits);
      nbits += 8;
    }
  }
  int get(int n) {  // n in 1..16
    if (nbits < n) fill();
    const int v = (int)(buf >> (64 - n));
    buf <<= n;
    nbits -= n;
    return v;
  }
  int peek9() {
    if (nbits < kLookBits) fill();
    return (int)(buf >> (64 - kLookBits));
  }
  void skip(int n) {
    buf <<= n;
    nbits -= n;
  }
};

inline int decode(Bits& b, const Huff& t) {
  const int look = t.look[b.peek9()];
  if (look) {
    b.skip(look >> 8);
    return look & 0xFF;
  }
  int l = kLookBits;
  int32_t code = b.get(l);
  while (l <= 16 && code > t.maxcode[l]) {
    code = code << 1 | b.get(1);
    ++l;
  }
  if (l > 16) return -1;  // no such code
  return t.vals[(t.valoffset[l] + code) & 0xFF];
}

inline int extend(int x, int s) {
  return x < (1 << (s - 1)) ? x + (int)((unsigned)-1 << s) + 1 : x;
}

struct Scan {
  int n = 0;
  int idx[4];
  int ss = 0, se = 63, ah = 0, al = 0;
};

// One block of a scan.  Returns false on a code that no table holds.
inline bool block_sequential(Bits& b, Frame& f, Component& c, int16_t* blk) {
  const Huff& dc = f.dc[c.td];
  const Huff& ac = f.ac[c.ta];
  int s = decode(b, dc);
  if (s < 0 || s > 16) return false;
  if (s) c.dc_pred += extend(b.get(s), s);
  blk[0] = (int16_t)c.dc_pred;
  for (int k = 1; k < 64; ++k) {
    const int rs = decode(b, ac);
    if (rs < 0) return false;
    const int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      const int v = extend(b.get(s), s);
      blk[kNatural[k]] = (int16_t)v;
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
  return true;
}

inline bool block_dc_first(Bits& b, Frame& f, Component& c, int16_t* blk,
                           int al) {
  int s = decode(b, f.dc[c.td]);
  if (s < 0 || s > 16) return false;
  if (s) c.dc_pred += extend(b.get(s), s);
  blk[0] = (int16_t)((unsigned)c.dc_pred << al);
  return true;
}

inline void block_dc_refine(Bits& b, int16_t* blk, int al) {
  if (b.get(1)) blk[0] = (int16_t)(blk[0] | (1 << al));
}

// `eobrun`: the blocks of the current EOB run still to skip.
inline bool block_ac_first(Bits& b, const Huff& ac, int16_t* blk,
                           const Scan& sc, int& eobrun) {
  if (eobrun > 0) {
    --eobrun;
    return true;
  }
  for (int k = sc.ss; k <= sc.se; ++k) {
    const int rs = decode(b, ac);
    if (rs < 0) return false;
    int r = rs >> 4;
    const int s = rs & 15;
    if (s) {
      k += r;
      const int v = extend(b.get(s), s);
      blk[kNatural[k]] = (int16_t)((unsigned)v << sc.al);
    } else {
      if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += b.get(r);
        --eobrun;
        break;
      }
    }
  }
  return true;
}

inline bool block_ac_refine(Bits& b, const Huff& ac, int16_t* blk,
                            const Scan& sc, int& eobrun) {
  const int p1 = 1 << sc.al;
  const int m1 = (int)((unsigned)-1 << sc.al);
  int k = sc.ss;
  if (eobrun == 0) {
    for (; k <= sc.se; ++k) {
      const int rs = decode(b, ac);
      if (rs < 0) return false;
      int r = rs >> 4;
      int s = rs & 15;
      if (s) {
        s = b.get(1) ? p1 : m1;  // libjpeg warns where s != 1
      } else if (r != 15) {
        eobrun = 1 << r;
        if (r) eobrun += b.get(r);
        break;
      }
      do {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) {
          if (b.get(1) && (*coef & p1) == 0)
            *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
        } else if (--r < 0) {
          break;
        }
        ++k;
      } while (k <= sc.se);
      if (s) blk[kNatural[k]] = (int16_t)s;
    }
  }
  if (eobrun > 0) {
    for (; k <= sc.se; ++k) {
      int16_t* coef = blk + kNatural[k];
      if (*coef != 0 && b.get(1) && (*coef & p1) == 0)
        *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
    }
    --eobrun;
  }
  return true;
}

// Past a restart marker RSTn at or after `pos` (fill bytes allowed); false
// when the next marker is another.
inline bool take_restart(const uint8_t* data, size_t len, size_t& pos,
                         int n) {
  while (pos < len && data[pos] != 0xFF) ++pos;  // the rest of the bits
  while (pos < len && data[pos] == 0xFF) ++pos;
  if (pos >= len || data[pos] != 0xD0 + n) return false;
  ++pos;
  return true;
}

// Decode one scan's entropy-coded data starting at `pos`; on return `pos`
// is at the marker that ends it.
inline int decode_scan(const uint8_t* data, size_t len, size_t& pos,
                       Frame& f, const Scan& sc) {
  Bits b{data, len, pos};
  int eobrun = 0;
  for (int i = 0; i < sc.n; ++i) f.comp[sc.idx[i]].dc_pred = 0;
  const bool dc = sc.ss == 0;
  for (int i = 0; i < sc.n; ++i) {  // the tables the scan reads
    const Component& c = f.comp[sc.idx[i]];
    const bool need_dc = !f.progressive || (dc && sc.ah == 0);
    const bool need_ac = !f.progressive || !dc;
    if ((need_dc && !f.dc[c.td].defined) || (need_ac && !f.ac[c.ta].defined))
      return kErrUnsupported;  // libjpeg's standard tables: not taken
  }
  int64_t mcus_x, mcus_y;
  if (sc.n == 1) {
    const Component& c = f.comp[sc.idx[0]];
    mcus_x = c.wb;
    mcus_y = c.hb;
  } else {
    mcus_x = f.mcux;
    mcus_y = f.mcuy;
  }
  const int64_t total = mcus_x * mcus_y;
  int restarts = 0;
  for (int64_t m = 0; m < total; ++m) {
    if (f.restart && m > 0 && m % f.restart == 0) {
      size_t p = b.pos;
      if (!take_restart(data, len, p, restarts & 7)) return kErrData;
      ++restarts;
      b = Bits{data, len, p};
      eobrun = 0;
      for (int i = 0; i < sc.n; ++i) f.comp[sc.idx[i]].dc_pred = 0;
    }
    const int64_t mx = m % mcus_x, my = m / mcus_x;
    for (int i = 0; i < sc.n; ++i) {
      Component& c = f.comp[sc.idx[i]];
      const int bh = sc.n == 1 ? 1 : c.v, bwd = sc.n == 1 ? 1 : c.h;
      for (int yy = 0; yy < bh; ++yy) {
        for (int xx = 0; xx < bwd; ++xx) {
          const int64_t by = sc.n == 1 ? my : my * c.v + yy;
          const int64_t bx = sc.n == 1 ? mx : mx * c.h + xx;
          int16_t* blk = &c.coef[((size_t)by * c.bw + bx) * 64];
          bool ok = true;
          if (!f.progressive) {
            ok = block_sequential(b, f, c, blk);
          } else if (dc) {
            if (sc.ah == 0) ok = block_dc_first(b, f, c, blk, sc.al);
            else block_dc_refine(b, blk, sc.al);
          } else if (sc.ah == 0) {
            ok = block_ac_first(b, f.ac[c.ta], blk, sc, eobrun);
          } else {
            ok = block_ac_refine(b, f.ac[c.ta], blk, sc, eobrun);
          }
          if (!ok) return kErrData;
        }
      }
    }
  }
  // the marker that ends the scan (bits of padding before it)
  size_t p = b.pos;
  while (p < len) {
    if (data[p] == 0xFF && p + 1 < len && data[p + 1] != 0x00 &&
        data[p + 1] != 0xFF && !(data[p + 1] >= 0xD0 && data[p + 1] <= 0xD7))
      break;
    ++p;
  }
  pos = p;
  return 0;
}

// ---------------------------------------------------------------- IDCT ---

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F0_298631336 = 2446, F0_390180644 = 3196,
                  F0_541196100 = 4433, F0_765366865 = 6270,
                  F0_899976223 = 7373, F1_175875602 = 9633,
                  F1_501321110 = 12299, F1_847759065 = 15137,
                  F1_961570560 = 16069, F2_053119869 = 16819,
                  F2_562915447 = 20995, F3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + ((int64_t)1 << (n - 1))) >> n;
}

inline uint8_t clamp8(int64_t v) {
  return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

// jidctint.c jpeg_idct_islow: one dequantized block to 8x8 samples.
inline void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                       int64_t stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* col = in + c;
    const uint16_t* qc = q + c;
    if (!col[8] && !col[16] && !col[24] && !col[32] && !col[40] &&
        !col[48] && !col[56]) {
      const int dcval = (int)col[0] * (int)qc[0] * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dcval;
      continue;
    }
    int64_t z2 = (int64_t)col[16] * qc[16], z3 = (int64_t)col[48] * qc[48];
    int64_t z1 = (z2 + z3) * F0_541196100;
    int64_t tmp2 = z1 + z3 * -F1_847759065;
    int64_t tmp3 = z1 + z2 * F0_765366865;
    z2 = (int64_t)col[0] * qc[0];
    z3 = (int64_t)col[32] * qc[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)col[56] * qc[56];
    tmp1 = (int64_t)col[40] * qc[40];
    tmp2 = (int64_t)col[24] * qc[24];
    tmp3 = (int64_t)col[8] * qc[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1_175875602;
    tmp0 *= F0_298631336;
    tmp1 *= F2_053119869;
    tmp2 *= F3_072711026;
    tmp3 *= F1_501321110;
    z1 *= -F0_899976223;
    z2 *= -F2_562915447;
    z3 *= -F1_961570560;
    z4 *= -F0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits - kPass1Bits;
    ws[0 * 8 + c] = (int)descale(tmp10 + tmp3, n);
    ws[7 * 8 + c] = (int)descale(tmp10 - tmp3, n);
    ws[1 * 8 + c] = (int)descale(tmp11 + tmp2, n);
    ws[6 * 8 + c] = (int)descale(tmp11 - tmp2, n);
    ws[2 * 8 + c] = (int)descale(tmp12 + tmp1, n);
    ws[5 * 8 + c] = (int)descale(tmp12 - tmp1, n);
    ws[3 * 8 + c] = (int)descale(tmp13 + tmp0, n);
    ws[4 * 8 + c] = (int)descale(tmp13 - tmp0, n);
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0_541196100;
    int64_t tmp2 = z1 + z3 * -F1_847759065;
    int64_t tmp3 = z1 + z2 * F0_765366865;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << kConstBits);
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1_175875602;
    tmp0 *= F0_298631336;
    tmp1 *= F2_053119869;
    tmp2 *= F3_072711026;
    tmp3 *= F1_501321110;
    z1 *= -F0_899976223;
    z2 *= -F2_562915447;
    z3 *= -F1_961570560;
    z4 *= -F0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits + kPass1Bits + 3;
    o[0] = clamp8(descale(tmp10 + tmp3, n) + 128);
    o[7] = clamp8(descale(tmp10 - tmp3, n) + 128);
    o[1] = clamp8(descale(tmp11 + tmp2, n) + 128);
    o[6] = clamp8(descale(tmp11 - tmp2, n) + 128);
    o[2] = clamp8(descale(tmp12 + tmp1, n) + 128);
    o[5] = clamp8(descale(tmp12 - tmp1, n) + 128);
    o[3] = clamp8(descale(tmp13 + tmp0, n) + 128);
    o[4] = clamp8(descale(tmp13 - tmp0, n) + 128);
  }
}

// ----------------------------------------------------------- upsample ---

// Row y of a component plane, the rows outside [0, dh) being copies of
// the first and the last real row (libjpeg's context rows).
inline const uint8_t* row_of(const Component& c, int64_t y) {
  if (y < 0) y = 0;
  if (y >= c.dh) y = c.dh - 1;
  return c.plane.data() + (size_t)y * (c.wb * 8);
}

// Component `c` at full size: `h` rows of the image's `w` samples (and up
// to one more) at `out`, `stride` apart.
inline void upsample(const Component& c, int rh, int rv, int64_t h,
                     int64_t w, int64_t stride, uint8_t* out) {
  const int64_t dw = c.dw;
  for (int64_t y = 0; y < h; ++y) {
    uint8_t* o = out + (size_t)y * stride;
    const int64_t iy = y / rv;
    const uint8_t* in0 = row_of(c, iy);
    if (rh == 1 && rv == 1) {
      std::memcpy(o, in0, (size_t)w);
    } else if (rh == 2 && rv == 1 && dw > 2) {  // h2v1_fancy_upsample
      int v = in0[0];
      o[0] = (uint8_t)v;
      o[1] = (uint8_t)((v * 3 + in0[1] + 2) >> 2);
      for (int64_t x = 1; x < dw - 1; ++x) {
        v = in0[x] * 3;
        o[2 * x] = (uint8_t)((v + in0[x - 1] + 1) >> 2);
        o[2 * x + 1] = (uint8_t)((v + in0[x + 1] + 2) >> 2);
      }
      v = in0[dw - 1];
      o[2 * dw - 2] = (uint8_t)((v * 3 + in0[dw - 2] + 1) >> 2);
      o[2 * dw - 1] = (uint8_t)v;
    } else if (rh == 1 && rv == 2) {  // h1v2_fancy_upsample
      const bool above = (y & 1) == 0;
      const uint8_t* in1 = row_of(c, above ? iy - 1 : iy + 1);
      const int bias = above ? 1 : 2;
      for (int64_t x = 0; x < dw; ++x)
        o[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
    } else if (rh == 2 && rv == 2 && dw > 2) {  // h2v2_fancy_upsample
      const uint8_t* in1 = row_of(c, (y & 1) == 0 ? iy - 1 : iy + 1);
      int this_sum = in0[0] * 3 + in1[0];
      int next_sum = in0[1] * 3 + in1[1];
      o[0] = (uint8_t)((this_sum * 4 + 8) >> 4);
      o[1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
      int last_sum = this_sum;
      this_sum = next_sum;
      for (int64_t x = 1; x < dw - 1; ++x) {
        next_sum = in0[x + 1] * 3 + in1[x + 1];
        o[2 * x] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
        o[2 * x + 1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
      }
      o[2 * dw - 2] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
      o[2 * dw - 1] = (uint8_t)((this_sum * 4 + 7) >> 4);
    } else {  // box replication (h2v1, h2v2 at 2 samples or fewer; others)
      const uint8_t* src = c.plane.data() + (size_t)iy * (c.wb * 8);
      for (int64_t x = 0; x < w; ++x) o[x] = src[x / rh];
    }
  }
}

// ------------------------------------------------------------- frame ---

inline int read_frame(const uint8_t* d, size_t len, Frame& f, size_t p) {
  const int seg = be16(d + p);
  if (seg < 8 || p + seg > len) return kErrMarker;
  if (d[p + 2] != 8) return kErrUnsupported;  // 12-bit samples
  f.h = be16(d + p + 3);
  f.w = be16(d + p + 5);
  f.ncomp = d[p + 7];
  if (f.h == 0) return kErrUnsupported;  // the height comes in a DNL
  if (f.w == 0) return kErrHeader;
  if (f.ncomp != 1 && f.ncomp != 3) return kErrUnsupported;  // CMYK/YCCK
  if (seg != 8 + 3 * f.ncomp) return kErrMarker;
  for (int i = 0; i < f.ncomp; ++i) {
    Component& c = f.comp[i];
    const uint8_t* q = d + p + 8 + 3 * i;
    c.id = q[0];
    c.h = q[1] >> 4;
    c.v = q[1] & 15;
    c.tq = q[2];
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
      return kErrHeader;
    if (c.h > f.hmax) f.hmax = c.h;
    if (c.v > f.vmax) f.vmax = c.v;
  }
  f.mcux = (f.w + 8 * f.hmax - 1) / (8 * f.hmax);
  f.mcuy = (f.h + 8 * f.vmax - 1) / (8 * f.vmax);
  for (int i = 0; i < f.ncomp; ++i) {
    Component& c = f.comp[i];
    if (f.hmax % c.h || f.vmax % c.v) return kErrUnsupported;
    c.dw = (f.w * c.h + f.hmax - 1) / f.hmax;
    c.dh = (f.h * c.v + f.vmax - 1) / f.vmax;
    c.wb = (c.dw + 7) / 8;
    c.hb = (c.dh + 7) / 8;
    c.bw = f.mcux * c.h;
    c.bh = f.mcuy * c.v;
    for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
    c.coef.assign((size_t)c.bw * c.bh * 64, 0);
  }
  return 0;
}

// Walk the markers: tables, the frame, every scan.  `header_only` stops
// at the frame.
inline int parse(const uint8_t* d, size_t len, Frame& f, bool header_only) {
  if (len < 4 || d[0] != 0xFF || d[1] != 0xD8) return kErrSignature;
  size_t p = 2;
  bool have_frame = false, have_scan = false;
  while (true) {
    while (p < len && d[p] != 0xFF) ++p;  // libjpeg skips such bytes
    while (p < len && d[p] == 0xFF) ++p;
    if (p >= len) return have_scan ? kErrData : kErrHeader;
    const int m = d[p++];
    if (m == 0xD9) break;                 // EOI
    if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;  // TEM, RSTn
    if (p + 2 > len) return kErrMarker;
    const int seg = be16(d + p);
    if (seg < 2 || p + seg > len) return kErrMarker;
    if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
      if (have_frame) return kErrHeader;
      f.progressive = m == 0xC2;
      const int err = read_frame(d, len, f, p);
      if (err) return err;
      have_frame = true;
      if (header_only) return 0;
    } else if (m == 0xC3 || (m >= 0xC5 && m <= 0xCF && m != 0xC8) ||
               m == 0xDC) {
      return kErrUnsupported;  // lossless, hierarchical, arithmetic, DNL
    } else if (m == 0xC4) {   // DHT
      size_t q = p + 2;
      while (q < p + seg) {
        if (q + 17 > p + seg) return kErrMarker;
        const int tc = d[q] >> 4, th = d[q] & 15;
        if (tc > 1 || th > 3) return kErrMarker;
        int n = 0;
        for (int i = 0; i < 16; ++i) n += d[q + 1 + i];
        if (q + 17 + n > p + seg) return kErrMarker;
        Huff& t = tc ? f.ac[th] : f.dc[th];
        if (!t.build(d + q + 1, d + q + 17, n)) return kErrMarker;
        q += 17 + n;
      }
    } else if (m == 0xDB) {  // DQT
      size_t q = p + 2;
      while (q < p + seg) {
        const int pq = d[q] >> 4, tq = d[q] & 15;
        if (pq > 1 || tq > 3) return kErrMarker;
        const size_t n = pq ? 128 : 64;
        if (q + 1 + n > p + seg) return kErrMarker;
        for (int k = 0; k < 64; ++k)
          f.quant[tq][kNatural[k]] =
              pq ? (uint16_t)be16(d + q + 1 + 2 * k) : d[q + 1 + k];
        f.quant_defined[tq] = true;
        q += 1 + n;
      }
    } else if (m == 0xDD) {  // DRI
      if (seg != 4) return kErrMarker;
      f.restart = be16(d + p + 2);
    } else if (m == 0xE0) {  // APP0: JFIF
      if (seg >= 16 && std::memcmp(d + p + 2, "JFIF\0", 5) == 0)
        f.jfif = true;
    } else if (m == 0xEE) {  // APP14: Adobe
      if (seg >= 14 && std::memcmp(d + p + 2, "Adobe", 5) == 0) {
        f.adobe = true;
        f.adobe_transform = d[p + 13];
      }
    } else if (m == 0xDA) {  // SOS
      if (!have_frame) return kErrHeader;
      Scan sc;
      sc.n = d[p + 2];
      if (sc.n < 1 || sc.n > f.ncomp || seg != 6 + 2 * sc.n)
        return kErrMarker;
      int blocks = 0;
      for (int i = 0; i < sc.n; ++i) {
        const int id = d[p + 3 + 2 * i];
        int ci = -1;
        for (int j = 0; j < f.ncomp; ++j)
          if (f.comp[j].id == id) ci = j;
        if (ci < 0) return kErrHeader;
        sc.idx[i] = ci;
        Component& c = f.comp[ci];
        c.td = d[p + 4 + 2 * i] >> 4;
        c.ta = d[p + 4 + 2 * i] & 15;
        if (c.td > 3 || c.ta > 3) return kErrHeader;
        if (!f.quant_defined[c.tq]) return kErrHeader;
        blocks += c.h * c.v;
      }
      if (sc.n > 1 && blocks > 10) return kErrHeader;
      const uint8_t* t = d + p + 3 + 2 * sc.n;
      sc.ss = t[0];
      sc.se = t[1];
      sc.ah = t[2] >> 4;
      sc.al = t[2] & 15;
      if (f.progressive) {
        if (sc.ss > sc.se || sc.se > 63 || sc.al > 13 || sc.ah > 13)
          return kErrHeader;
        if (sc.ss == 0 ? sc.se != 0 : sc.n != 1) return kErrHeader;
        for (int i = 0; i < sc.n; ++i) {
          Component& c = f.comp[sc.idx[i]];
          for (int k = sc.ss; k <= sc.se; ++k) c.coef_bits[k] = sc.al;
        }
      } else {
        sc.ss = 0;
        sc.se = 63;
        sc.ah = sc.al = 0;
        for (int i = 0; i < sc.n; ++i)
          for (int k = 0; k < 64; ++k) f.comp[sc.idx[i]].coef_bits[k] = 0;
      }
      size_t q = p + seg;
      const int err = decode_scan(d, len, q, f, sc);
      if (err) return err;
      have_scan = true;
      p = q;
      continue;
    }
    p += seg;
  }
  if (!have_frame || !have_scan) return kErrHeader;
  return 0;
}

// jdcolor.c's YCbCr->RGB tables.
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    constexpr int kScale = 16;
    constexpr int64_t kHalf = (int64_t)1 << (kScale - 1);
    auto fix = [](double x) {
      return (int64_t)(x * (1L << kScale) + 0.5);
    };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = (int)((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = (int)((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
  }
};

// The file as uint8 [h, w, 3] (Image.open(p).convert("RGB")).
inline int decode_rgb(const uint8_t* d, size_t len, uint8_t* out,
                      int64_t out_size) {
  Frame f;
  try {
    int err = parse(d, len, f, false);
    if (err) return err;
    if (out_size != f.w * f.h * 3) return kErrData;
    if (f.progressive) {  // libjpeg would smooth blocks (jdcoefct.c)
      for (int i = 0; i < f.ncomp; ++i)
        for (int k = 0; k < 10; ++k)
          if (f.comp[i].coef_bits[k] != 0) return kErrUnsupported;
    }
    for (int i = 0; i < f.ncomp; ++i) {
      Component& c = f.comp[i];
      const int64_t stride = c.wb * 8;
      c.plane.assign((size_t)stride * c.hb * 8, 0);
      const uint16_t* q = f.quant[c.tq];
      for (int64_t by = 0; by < c.hb; ++by)
        for (int64_t bx = 0; bx < c.wb; ++bx)
          idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], q,
                     c.plane.data() + (size_t)by * 8 * stride + bx * 8,
                     stride);
      std::vector<int16_t>().swap(c.coef);
    }
    const int64_t w = f.w, h = f.h;
    if (f.ncomp == 1) {
      const Component& c = f.comp[0];
      for (int64_t y = 0; y < h; ++y) {
        const uint8_t* in = c.plane.data() + (size_t)y * (c.wb * 8);
        uint8_t* o = out + (size_t)y * w * 3;
        for (int64_t x = 0; x < w; ++x) o[3 * x] = o[3 * x + 1] =
            o[3 * x + 2] = in[x];
      }
      return 0;
    }
    // libjpeg's guess of the color space (jdapimin.c)
    bool ycc = true;
    if (!f.jfif && f.adobe) {
      ycc = f.adobe_transform != 0;
    } else if (!f.jfif) {
      ycc = !(f.comp[0].id == 'R' && f.comp[1].id == 'G' &&
              f.comp[2].id == 'B');
    }
    const int64_t wpad = w + 2;  // a fancy row writes 2 * ceil(w / 2)
    std::vector<uint8_t> full[3];
    for (int i = 0; i < 3; ++i) {
      const Component& c = f.comp[i];
      full[i].assign((size_t)wpad * h, 0);
      upsample(c, f.hmax / c.h, f.vmax / c.v, h, w, wpad, full[i].data());
      std::vector<uint8_t>().swap(f.comp[i].plane);
    }
    static const YccTables tab;
    for (int64_t y = 0; y < h; ++y) {
      const uint8_t* p0 = full[0].data() + (size_t)y * wpad;
      const uint8_t* p1 = full[1].data() + (size_t)y * wpad;
      const uint8_t* p2 = full[2].data() + (size_t)y * wpad;
      uint8_t* o = out + (size_t)y * w * 3;
      for (int64_t x = 0; x < w; ++x) {
        if (!ycc) {
          o[3 * x] = p0[x];
          o[3 * x + 1] = p1[x];
          o[3 * x + 2] = p2[x];
          continue;
        }
        const int yv = p0[x], cb = p1[x], cr = p2[x];
        o[3 * x] = clamp8(yv + tab.cr_r[cr]);
        o[3 * x + 1] = clamp8(yv + ((tab.cb_g[cb] + tab.cr_g[cr]) >> 16));
        o[3 * x + 2] = clamp8(yv + tab.cb_b[cb]);
      }
    }
  } catch (const std::bad_alloc&) {
    return kErrAlloc;
  } catch (const std::length_error&) {
    return kErrAlloc;
  }
  return 0;
}

}  // namespace jpeg
}  // namespace
