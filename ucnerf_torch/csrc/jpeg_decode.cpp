// Baseline JPEG decoder for the port's scene loaders (host code, no GPU).
//
// The JAX package decodes SCARED and Hamlyn frames through PIL, which runs
// libjpeg-turbo with its defaults.  The card's machine has no image
// library, so this file decodes the same files to the same pixels:
//   - sequential Huffman scans, 8-bit samples, 3 components (YCbCr),
//     interleaved or one component per scan, restart intervals;
//   - libjpeg's accurate integer IDCT (jidctint.c, "islow"), with its
//     range-limit table;
//   - fancy upsampling (jdsample.c): the h2v1 and h2v2 triangle filters
//     with their alternating rounding, box upsampling where a chroma plane
//     is two samples wide or less, edge rows replicated (jdmainct.c);
//   - the fixed-point YCbCr -> RGB tables of jdcolor.c.
// Progressive, arithmetic-coded, lossless, 12-bit, grayscale, CMYK and RGB
// (Adobe transform 0) frames, other sampling layouts and corrupt entropy
// data are refused with a message: nothing is guessed.
//
// C interface, bound with ctypes by ucnerf_torch/utils/jpeg.py:
//   int ucn_jpeg_size(data, n, &width, &height, err, errlen)
//   int ucn_jpeg_decode(data, n, out, width, height, err, errlen)
// Both return 0 on success and 1 with a message in err otherwise; out is
// height x width x 3 bytes (RGB, row-major).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Error{msg}; }

const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Huff {
  bool present = false;
  uint8_t vals[256];
  int maxcode[18];   // largest code of each length, -1 if none
  int valoff[17];    // index of the first value of each length minus its code
  uint8_t look_len[512];   // 9-bit lookahead: code length (0: longer)
  uint8_t look_val[512];
};

void build_huff(Huff& h, const uint8_t counts[16], const uint8_t* vals,
                int nvals, bool dc) {
  std::memcpy(h.vals, vals, nvals);
  std::memset(h.look_len, 0, sizeof(h.look_len));
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    int n = counts[len - 1];
    h.valoff[len] = k - code;
    if (n) {
      for (int i = 0; i < n; ++i, ++code, ++k) {
        if (len <= 9) {
          int shift = 9 - len;
          for (int j = 0; j < (1 << shift); ++j) {
            h.look_len[(code << shift) | j] = (uint8_t)len;
            h.look_val[(code << shift) | j] = vals[k];
          }
        }
      }
      h.maxcode[len] = code - 1;
    } else {
      h.maxcode[len] = -1;
    }
    if (code > (1 << len)) fail("bad Huffman table (codes overflow)");
    code <<= 1;
  }
  h.maxcode[17] = 0x7fffffff;
  if (dc)
    for (int i = 0; i < nvals; ++i)
      if (vals[i] > 15) fail("bad DC Huffman table (symbol above 15)");
  h.present = true;
}

// Entropy-coded data reader: byte stuffing, markers, fill bytes.  Past a
// marker it supplies zero bits, as libjpeg does, and counts them: using
// one is corrupt data here.
struct Bits {
  const uint8_t* d;
  size_t n, pos;
  uint64_t buf = 0;
  int cnt = 0;
  int fake = 0;          // zero bits at the tail of buf that are not data
  int marker = 0;        // the marker that stopped the reader, 0 if none

  void fill() {
    while (cnt <= 56) {
      uint8_t b = 0;
      if (!marker) {
        if (pos >= n) {
          marker = 0xD9;   // end of file: act as if EOI came
        } else {
          b = d[pos];
          if (b == 0xFF) {
            size_t p = pos + 1;
            while (p < n && d[p] == 0xFF) ++p;
            if (p < n && d[p] == 0x00) {
              pos = p + 1;
            } else {
              marker = p < n ? d[p] : 0xD9;
              pos = p < n ? p + 1 : n;   // past the marker
            }
          } else {
            ++pos;
          }
        }
      }
      if (marker) {
        b = 0;
        fake += 8;
      }
      buf |= (uint64_t)b << (56 - cnt);
      cnt += 8;
    }
  }
  void consume(int k) {
    buf <<= k;
    cnt -= k;
    if (cnt < fake) fail("entropy-coded data ends early (corrupt file)");
  }
  int get(int k) {
    if (k == 0) return 0;
    if (cnt < k) fill();
    int v = (int)(buf >> (64 - k));
    consume(k);
    return v;
  }
  int decode(const Huff& h) {
    if (cnt < 16) fill();
    int idx = (int)(buf >> (64 - 9));
    int len = h.look_len[idx];
    if (len) {
      int v = h.look_val[idx];
      consume(len);
      return v;
    }
    int code = (int)(buf >> (64 - 9));
    len = 9;
    while (code > h.maxcode[len]) {
      ++len;
      if (len > 16) fail("bad Huffman code (corrupt data)");
      code = (int)(buf >> (64 - len));
    }
    consume(len);
    return h.vals[h.valoff[len] + code];
  }
  // at a restart boundary: drop the bits left in the byte and read RSTn
  void restart(int expect) {
    buf = 0;
    cnt = 0;
    fake = 0;
    if (!marker) {
      while (pos < n && d[pos] != 0xFF) ++pos;   // libjpeg skips to a marker
      while (pos < n && d[pos] == 0xFF) ++pos;
      marker = pos < n ? d[pos++] : 0xD9;
    }
    if (marker != 0xD0 + expect)
      fail("restart marker missing or out of order (corrupt data)");
    marker = 0;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - ((1 << s) - 1) : v;
}

struct Component {
  int id, h, v, tq;
  int bw, bh;            // blocks allocated across and down (MCU padded)
  int dw, dh;            // samples that hold image data (downsampled size)
  std::vector<int16_t> coef;   // bw * bh blocks of 64, natural order
  std::vector<uint8_t> plane;  // (bw * 8) x (bh * 8) samples after the IDCT
  int pred = 0;
  int td = 0, ta = 0;
  bool seen = false;
};

// ---------------------------------------------------------------- IDCT
// jidctint.c (jpeg_idct_islow) with CONST_BITS 13, PASS1_BITS 2.
constexpr int CB = 13, P1 = 2;
constexpr int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270,
                  F0_899 = 7373, F1_175 = 9633, F1_501 = 12299,
                  F1_847 = 15137, F1_961 = 16069, F2_053 = 16819,
                  F2_562 = 20995, F3_072 = 25172;

inline int descale(int64_t x, int n) {
  return (int)((x + ((int64_t)1 << (n - 1))) >> n);
}

struct RangeLimit {
  uint8_t t[1024];   // IDCT output (centred) & 1023 -> sample
  RangeLimit() {
    for (int x = 0; x < 1024; ++x) {
      int j = x + 128;   // index into libjpeg's sample_range_limit
      t[x] = j < 256 ? (uint8_t)j : j < 640 ? 255 : j < 1024 ? 0
                                                               : (uint8_t)(j - 1024);
    }
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
  int ws[64];   // libjpeg's workspace is int; its arithmetic JLONG (64-bit)
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
        ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      int dc = ((int64_t)ip[0] * (int16_t)qp[0]) * (1 << P1);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = (int64_t)ip[16] * (int16_t)qp[16];
    int64_t z3 = (int64_t)ip[48] * (int16_t)qp[48];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * (-F1_847);
    int64_t tmp3 = z1 + z2 * F0_765;
    z2 = (int64_t)ip[0] * (int16_t)qp[0];
    z3 = (int64_t)ip[32] * (int16_t)qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << CB);
    int64_t tmp1 = (z2 - z3) * (1 << CB);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)ip[56] * (int16_t)qp[56];
    tmp1 = (int64_t)ip[40] * (int16_t)qp[40];
    tmp2 = (int64_t)ip[24] * (int16_t)qp[24];
    tmp3 = (int64_t)ip[8] * (int16_t)qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp0 = tmp0 * F0_298;
    tmp1 = tmp1 * F2_053;
    tmp2 = tmp2 * F3_072;
    tmp3 = tmp3 * F1_501;
    z1 = z1 * (-F0_899);
    z2 = z2 * (-F2_562);
    z3 = z3 * (-F1_961);
    z4 = z4 * (-F0_390);
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    wp[0] = descale(tmp10 + tmp3, CB - P1);
    wp[56] = descale(tmp10 - tmp3, CB - P1);
    wp[8] = descale(tmp11 + tmp2, CB - P1);
    wp[48] = descale(tmp11 - tmp2, CB - P1);
    wp[16] = descale(tmp12 + tmp1, CB - P1);
    wp[40] = descale(tmp12 - tmp1, CB - P1);
    wp[24] = descale(tmp13 + tmp0, CB - P1);
    wp[32] = descale(tmp13 - tmp0, CB - P1);
  }
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 &&
        wp[6] == 0 && wp[7] == 0) {
      uint8_t dc = kRange.t[descale(wp[0], P1 + 3) & 1023];
      for (int c = 0; c < 8; ++c) op[c] = dc;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * (-F1_847);
    int64_t tmp3 = z1 + z2 * F0_765;
    int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << CB);
    int64_t tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << CB);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp0 = tmp0 * F0_298;
    tmp1 = tmp1 * F2_053;
    tmp2 = tmp2 * F3_072;
    tmp3 = tmp3 * F1_501;
    z1 = z1 * (-F0_899);
    z2 = z2 * (-F2_562);
    z3 = z3 * (-F1_961);
    z4 = z4 * (-F0_390);
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = CB + P1 + 3;
    op[0] = kRange.t[descale(tmp10 + tmp3, n) & 1023];
    op[7] = kRange.t[descale(tmp10 - tmp3, n) & 1023];
    op[1] = kRange.t[descale(tmp11 + tmp2, n) & 1023];
    op[6] = kRange.t[descale(tmp11 - tmp2, n) & 1023];
    op[2] = kRange.t[descale(tmp12 + tmp1, n) & 1023];
    op[5] = kRange.t[descale(tmp12 - tmp1, n) & 1023];
    op[3] = kRange.t[descale(tmp13 + tmp0, n) & 1023];
    op[4] = kRange.t[descale(tmp13 - tmp0, n) & 1023];
  }
}

// ---------------------------------------------------------------- decoder
struct Decoder {
  const uint8_t* d;
  size_t n, pos = 0;
  int width = 0, height = 0, hmax = 1, vmax = 1;
  bool frame = false, jfif = false, adobe = false;
  int adobe_transform = -1;
  int restart_interval = 0;
  uint16_t qt[4][64];
  bool qt_present[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  std::vector<Component> comps;

  Decoder(const uint8_t* data, size_t size) : d(data), n(size) {}

  int u8() {
    if (pos >= n) fail("file ends inside a marker segment");
    return d[pos++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  // the next marker code; skips fill bytes (and, as libjpeg does, stray
  // bytes between segments)
  int next_marker() {
    while (pos < n && d[pos] != 0xFF) ++pos;
    while (pos < n && d[pos] == 0xFF) ++pos;
    if (pos >= n) fail("file ends before the end-of-image marker");
    return d[pos++];
  }

  void read_sof() {
    if (frame) fail("more than one frame header");
    int len = u16();
    size_t end = pos + len - 2;
    int precision = u8();
    if (precision != 8)
      fail(std::to_string(precision) + "-bit samples (this decoder reads "
           "8-bit frames)");
    height = u16();
    width = u16();
    int nc = u8();
    if (height == 0) fail("frame height 0 (DNL marker) is not supported");
    if (width == 0) fail("frame width 0");
    if (nc == 1) fail("grayscale frame (this decoder reads 3-component YCbCr)");
    if (nc == 4) fail("CMYK/YCCK frame (this decoder reads 3-component YCbCr)");
    if (nc != 3) fail(std::to_string(nc) + " components (this decoder reads 3)");
    comps.resize(3);
    for (auto& c : comps) {
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("bad component parameters in the frame header");
      if (c.h > hmax) hmax = c.h;
      if (c.v > vmax) vmax = c.v;
    }
    if (pos != end) fail("bad frame header length");
    int mcux = (width + 8 * hmax - 1) / (8 * hmax);
    int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      int rh = hmax / c.h, rv = vmax / c.v;
      bool ok = (hmax % c.h == 0) && (vmax % c.v == 0) &&
                ((rh == 1 && rv == 1) || (rh == 2 && rv == 1) ||
                 (rh == 2 && rv == 2));
      if (!ok)
        fail("sampling factors " + std::to_string(c.h) + "x" +
             std::to_string(c.v) + " of " + std::to_string(hmax) + "x" +
             std::to_string(vmax) + " (this decoder reads 4:4:4, 4:2:2 "
             "and 4:2:0)");
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = (int)(((long)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((long)height * c.v + vmax - 1) / vmax);
    }
    frame = true;
  }

  void read_dqt() {
    int len = u16();
    size_t end = pos + len - 2;
    while (pos < end) {
      int pq = u8();
      int t = pq & 15, prec = pq >> 4;
      if (t > 3 || prec > 1) fail("bad quantization table");
      for (int k = 0; k < 64; ++k)
        qt[t][kNatural[k]] = (uint16_t)(prec ? u16() : u8());
      qt_present[t] = true;
    }
    if (pos != end) fail("bad quantization table length");
  }

  void read_dht() {
    int len = u16();
    size_t end = pos + len - 2;
    while (pos < end) {
      int tc = u8();
      int cls = tc >> 4, t = tc & 15;
      if (cls > 1 || t > 3) fail("bad Huffman table header");
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i] = (uint8_t)u8();
      if (total > 256) fail("bad Huffman table (more than 256 symbols)");
      uint8_t vals[256];
      for (int i = 0; i < total; ++i) vals[i] = (uint8_t)u8();
      build_huff(cls ? ac[t] : dc[t], counts, vals, total, cls == 0);
    }
    if (pos != end) fail("bad Huffman table length");
  }

  void read_app(int marker) {
    int len = u16();
    size_t end = pos + len - 2;
    if (end > n) fail("file ends inside a marker segment");
    if (marker == 0xE0 && len >= 7 && std::memcmp(d + pos, "JFIF\0", 5) == 0)
      jfif = true;
    if (marker == 0xEE && len >= 14 && std::memcmp(d + pos, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = d[pos + 11];
    }
    pos = end;
  }

  void decode_block(Bits& bits, Component& c, int16_t* blk) {
    const Huff& hd = dc[c.td];
    const Huff& ha = ac[c.ta];
    int s = bits.decode(hd);
    int diff = s ? extend(bits.get(s), s) : 0;
    c.pred += diff;
    blk[0] = (int16_t)c.pred;
    for (int k = 1; k < 64;) {
      int rs = bits.decode(ha);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) fail("AC coefficient index past 63 (corrupt data)");
        blk[kNatural[k]] = (int16_t)extend(bits.get(s), s);
        ++k;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
  }

  void read_sos() {
    if (!frame) fail("scan before the frame header");
    int len = u16();
    size_t end = pos + len - 2;
    int ns = u8();
    if (ns < 1 || ns > 3) fail("bad scan header");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      int cid = u8(), t = u8();
      Component* found = nullptr;
      for (auto& c : comps)
        if (c.id == cid) found = &c;
      if (!found) fail("scan names a component the frame lacks");
      found->td = t >> 4;
      found->ta = t & 15;
      if (found->td > 3 || found->ta > 3) fail("bad scan table selectors");
      if (!dc[found->td].present || !ac[found->ta].present)
        fail("scan uses a Huffman table that was not defined");
      if (found->seen) fail("a component appears in two scans");
      found->seen = true;
      sc.push_back(found);
    }
    int ss = u8(), se = u8(), ahal = u8();
    if (ss != 0 || se != 63 || ahal != 0)
      fail("spectral selection or successive approximation in a "
           "sequential scan (corrupt header)");
    if (pos != end) fail("bad scan header length");

    for (auto& c : comps)
      if (c.coef.empty()) c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    Bits bits{d, n, pos};
    int mcus_x, mcus_y;
    if (ns == 1) {   // non-interleaved: one block per MCU, no MCU padding
      mcus_x = (sc[0]->dw + 7) / 8;
      mcus_y = (sc[0]->dh + 7) / 8;
    } else {
      mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
      mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
    }
    for (auto* c : sc) c->pred = 0;
    int total = mcus_x * mcus_y, rst = 0;
    for (int m = 0; m < total; ++m) {
      if (restart_interval && m && m % restart_interval == 0) {
        bits.restart(rst);
        rst = (rst + 1) & 7;
        for (auto* c : sc) c->pred = 0;
      }
      int mx = m % mcus_x, my = m / mcus_x;
      if (ns == 1) {
        Component& c = *sc[0];
        decode_block(bits, c, &c.coef[((size_t)my * c.bw + mx) * 64]);
        continue;
      }
      for (auto* cp : sc) {
        Component& c = *cp;
        for (int v = 0; v < c.v; ++v)
          for (int h = 0; h < c.h; ++h) {
            size_t b = (size_t)(my * c.v + v) * c.bw + mx * c.h + h;
            decode_block(bits, c, &c.coef[b * 64]);
          }
      }
    }
    // resume header parsing at the marker that ended the scan
    if (bits.marker) {
      pos = bits.pos - 2;   // back to the 0xFF of the marker
      while (pos > 0 && d[pos] != 0xFF) --pos;
    } else {
      pos = bits.pos;
    }
  }

  // the whole file, or up to the frame header when header_only
  void parse(bool header_only = false) {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file (no SOI)");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;
      if (header_only && m == 0xDA) fail("no frame header before the scan");
      switch (m) {
        case 0xC0:
        case 0xC1:
          read_sof();
          if (header_only) return;
          break;
        case 0xC2:
        case 0xC6:
        case 0xCA:
        case 0xCE:
          fail("progressive JPEG (this decoder reads sequential files)");
        case 0xC3:
        case 0xC7:
        case 0xCB:
        case 0xCF:
          fail("lossless JPEG (this decoder reads sequential files)");
        case 0xC5:
          fail("hierarchical JPEG (this decoder reads sequential files)");
        case 0xC9:
          fail("arithmetic-coded JPEG (this decoder reads Huffman files)");
        case 0xCC:
          fail("arithmetic-coded JPEG (DAC marker)");
        case 0xC4:
          read_dht();
          break;
        case 0xDB:
          read_dqt();
          break;
        case 0xDD: {
          int len = u16();
          if (len != 4) fail("bad restart interval length");
          restart_interval = u16();
          break;
        }
        case 0xDA:
          read_sos();
          break;
        case 0xDC:
          fail("DNL marker is not supported");
        default:
          if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE) {
            read_app(m);
          } else if (m >= 0xD0 && m <= 0xD7) {
            // a stray restart marker between segments carries no data
          } else {
            int len = u16();
            pos += len - 2;
            if (pos > n) fail("file ends inside a marker segment");
          }
      }
    }
    if (!frame) fail("no frame header");
    for (auto& c : comps)
      if (!c.seen) fail("a component has no scan (file ends early)");
    // colour space as libjpeg's default_decompress_parms decides it
    if (!jfif && adobe && adobe_transform == 0)
      fail("RGB JPEG (Adobe transform 0); this decoder reads YCbCr");
    if (!jfif && !adobe && comps[0].id == 'R' && comps[1].id == 'G' &&
        comps[2].id == 'B')
      fail("RGB JPEG (component ids R, G, B); this decoder reads YCbCr");
  }

  void idct_all() {
    for (auto& c : comps) {
      if (!qt_present[c.tq]) fail("component uses an undefined quantization table");
      int stride = c.bw * 8;
      c.plane.assign((size_t)stride * c.bh * 8, 0);
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
          idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], qt[c.tq],
                     &c.plane[(size_t)by * 8 * stride + bx * 8], stride);
    }
  }

  // one component at full size (width x height), upsampled as jdsample.c
  std::vector<uint8_t> full_plane(const Component& c) const {
    int rh = hmax / c.h, rv = vmax / c.v;
    int stride = c.bw * 8;
    const uint8_t* p = c.plane.data();
    int ow = c.dw * rh;   // upsampled width before the crop to `width`
    std::vector<uint8_t> out((size_t)width * height);
    std::vector<uint8_t> row(ow + 8);
    bool fancy = c.dw > 2;
    for (int y = 0; y < height; ++y) {
      int r = y / rv;
      const uint8_t* in0 = p + (size_t)r * stride;
      if (rh == 1 && rv == 1) {
        std::memcpy(&out[(size_t)y * width], in0, width);
        continue;
      }
      if (!fancy) {   // box: each sample repeated rh x rv times
        for (int x = 0; x < width; ++x) out[(size_t)y * width + x] = in0[x / rh];
        continue;
      }
      uint8_t* o = row.data();
      if (rv == 1) {   // h2v1_fancy_upsample
        int inv = in0[0];
        *o++ = (uint8_t)inv;
        *o++ = (uint8_t)((inv * 3 + in0[1] + 2) >> 2);
        const uint8_t* ip = in0 + 1;
        for (int col = c.dw - 2; col > 0; --col, ++ip) {
          inv = ip[0] * 3;
          *o++ = (uint8_t)((inv + ip[-1] + 1) >> 2);
          *o++ = (uint8_t)((inv + ip[1] + 2) >> 2);
        }
        inv = ip[0];
        *o++ = (uint8_t)((inv * 3 + ip[-1] + 1) >> 2);
        *o++ = (uint8_t)inv;
      } else {         // h2v2_fancy_upsample: context row above or below
        int v = y % 2;
        int r1 = v == 0 ? (r > 0 ? r - 1 : 0) : (r + 1 < c.dh ? r + 1 : c.dh - 1);
        const uint8_t* in1 = p + (size_t)r1 * stride;
        int thiscol = in0[0] * 3 + in1[0];
        int nextcol = in0[1] * 3 + in1[1];
        *o++ = (uint8_t)((thiscol * 4 + 8) >> 4);
        *o++ = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
        int lastcol = thiscol;
        thiscol = nextcol;
        for (int col = c.dw - 2, k = 2; col > 0; --col, ++k) {
          nextcol = in0[k] * 3 + in1[k];
          *o++ = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
          *o++ = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
          lastcol = thiscol;
          thiscol = nextcol;
        }
        *o++ = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
        *o++ = (uint8_t)((thiscol * 4 + 7) >> 4);
      }
      std::memcpy(&out[(size_t)y * width], row.data(), width);
    }
    return out;
  }

  void to_rgb(uint8_t* out) const {
    // jdcolor.c build_ycc_rgb_table, SCALEBITS 16
    const int SB = 16;
    const int32_t half = 1 << (SB - 1);
    auto fix = [](double x) { return (int32_t)(x * (1 << 16) + 0.5); };
    int cr_r[256], cb_b[256];
    int32_t cr_g[256], cb_g[256];
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = (int)((fix(1.40200) * x + half) >> SB);
      cb_b[i] = (int)((fix(1.77200) * x + half) >> SB);
      cr_g[i] = (-fix(0.71414)) * x;
      cb_g[i] = (-fix(0.34414)) * x + half;
    }
    std::vector<uint8_t> Y = full_plane(comps[0]);
    std::vector<uint8_t> Cb = full_plane(comps[1]);
    std::vector<uint8_t> Cr = full_plane(comps[2]);
    auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
    size_t np = (size_t)width * height;
    for (size_t i = 0; i < np; ++i) {
      int y = Y[i], cb = Cb[i], cr = Cr[i];
      out[3 * i + 0] = clamp(y + cr_r[cr]);
      out[3 * i + 1] = clamp(y + (int)((cb_g[cb] + cr_g[cr]) >> SB));
      out[3 * i + 2] = clamp(y + cb_b[cb]);
    }
  }
};

void put_err(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) std::snprintf(err, (size_t)errlen, "%s", msg.c_str());
}

}  // namespace

extern "C" int ucn_jpeg_size(const uint8_t* data, size_t n, int* width,
                             int* height, char* err, int errlen) {
  try {
    Decoder dec(data, n);
    dec.parse(true);
    if (!dec.frame) fail("no frame header");
    *width = dec.width;
    *height = dec.height;
    return 0;
  } catch (const Error& e) {
    put_err(err, errlen, e.msg);
    return 1;
  }
}

extern "C" int ucn_jpeg_decode(const uint8_t* data, size_t n, uint8_t* out,
                               int width, int height, char* err, int errlen) {
  try {
    Decoder dec(data, n);
    dec.parse();
    if (dec.width != width || dec.height != height)
      fail("frame size differs from the buffer's");
    dec.idct_all();
    dec.to_rgb(out);
    return 0;
  } catch (const Error& e) {
    put_err(err, errlen, e.msg);
    return 1;
  } catch (const std::bad_alloc&) {
    put_err(err, errlen, "out of memory");
    return 1;
  }
}
