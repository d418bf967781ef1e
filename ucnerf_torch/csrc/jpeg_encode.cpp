// Baseline JPEG encoder for the port's image pyramids (host code, no GPU).
//
// The JAX package writes downsampled frames (``data/llff.py::minify``)
// through PIL, which runs libjpeg-turbo at its defaults.  The card's
// machine has no image library, so this file encodes the same way:
//   - libjpeg's fixed-point RGB -> YCbCr tables (jccolor.c);
//   - 4:2:0 sampling: luma at full size, chroma by h2v2 averaging with the
//     alternating 1, 2 rounding bias of jcsample.c; edges replicated to the
//     block grid (jcprep.c, jcsample.c), dummy blocks past it with zero AC
//     and the DC of the block before (jccoefct.c);
//   - the accurate integer forward DCT (jfdctint.c, "islow");
//   - libjpeg-turbo's quantization by reciprocal multiplication
//     (jcdctmgr.c ``compute_reciprocal``) of the standard tables scaled by
//     ``jpeg_quality_scaling`` and limited to 8 bits;
//   - the standard Huffman tables (Annex K), one interleaved baseline
//     scan, no restart markers;
//   - the markers in libjpeg's order: SOI, JFIF APP0 (version 1.01, no
//     density unit, 1:1), one DQT per table, SOF0, the four DHTs, SOS.
//
// C interface, bound with ctypes by ucnerf_torch/utils/jpeg.py:
//   long long ucn_jpeg_encode(rgb, width, height, quality, out, cap, err,
//                             errlen)
// rgb is height x width x 3 bytes (RGB, row-major).  Returns the file's
// size in bytes, written to out when it fits in cap (else nothing is
// written and the caller retries with a larger buffer), or -1 with a
// message in err.

#include <algorithm>
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

// Annex K.1, natural order
const int kStdLuma[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kStdChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K.3: code counts of lengths 1..16 and the values
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// ------------------------------------------------------------ colour

// jccolor.c: SCALEBITS 16, Cb and Cr rounded with ONE_HALF - 1
const int64_t kScale = 16;
const int64_t kHalf = int64_t(1) << (kScale - 1);
int64_t fix(double x) { return int64_t(x * (int64_t(1) << kScale) + 0.5); }

struct Planes {
  int w, h;
  std::vector<int> y, cb, cr;   // h x w samples
};

Planes rgb_to_ycc(const uint8_t* rgb, int w, int h) {
  int64_t ry[256], gy[256], by[256], rcb[256], gcb[256], bcb[256], gcr[256],
      bcr[256];
  const int64_t center = int64_t(128) << kScale;
  for (int i = 0; i < 256; ++i) {
    ry[i] = fix(0.29900) * i;
    gy[i] = fix(0.58700) * i;
    by[i] = fix(0.11400) * i + kHalf;
    rcb[i] = -fix(0.16874) * i;
    gcb[i] = -fix(0.33126) * i;
    bcb[i] = fix(0.50000) * i + center + kHalf - 1;   // also R => Cr
    gcr[i] = -fix(0.41869) * i;
    bcr[i] = -fix(0.08131) * i;
  }
  Planes p{w, h, std::vector<int>(size_t(w) * h),
           std::vector<int>(size_t(w) * h), std::vector<int>(size_t(w) * h)};
  for (size_t i = 0; i < size_t(w) * h; ++i) {
    int r = rgb[3 * i], g = rgb[3 * i + 1], b = rgb[3 * i + 2];
    p.y[i] = int((ry[r] + gy[g] + by[b]) >> kScale);
    p.cb[i] = int((rcb[r] + gcb[g] + bcb[b]) >> kScale);
    p.cr[i] = int((bcb[r] + gcr[g] + bcr[b]) >> kScale);
  }
  return p;
}

// A component's samples on its block grid, padded by replication.
struct Comp {
  int w, h;                      // padded size (multiples of 8)
  std::vector<int> s;
  int at(int y, int x) const { return s[size_t(y) * w + x]; }
};

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Luma: full size, columns and rows past the image replicate its edge.
Comp luma(const Planes& p) {
  Comp c{ceil_div(p.w, 8) * 8, ceil_div(p.h, 8) * 8, {}};
  c.s.resize(size_t(c.w) * c.h);
  for (int y = 0; y < c.h; ++y) {
    const int* row = &p.y[size_t(std::min(y, p.h - 1)) * p.w];
    for (int x = 0; x < c.w; ++x) c.s[size_t(y) * c.w + x] = row[std::min(x, p.w - 1)];
  }
  return c;
}

// Chroma, h2v2: the full-size plane replicated to an even height and to
// twice the output width, each 2x2 averaged with bias 1, 2, 1, 2, ...
// along a row, then the last output row replicated to the block grid.
Comp chroma(const std::vector<int>& full, int w, int h) {
  const int bw = ceil_div(w, 16), bh = ceil_div(h, 16);
  const int ow = bw * 8, rows = ceil_div(h, 2);
  Comp c{ow, bh * 8, {}};
  c.s.resize(size_t(c.w) * c.h);
  auto px = [&](int y, int x) {
    return full[size_t(std::min(y, h - 1)) * w + std::min(x, w - 1)];
  };
  for (int oy = 0; oy < c.h; ++oy) {
    const int sy = 2 * std::min(oy, rows - 1);
    int bias = 1;
    for (int ox = 0; ox < ow; ++ox) {
      const int sx = 2 * ox;
      c.s[size_t(oy) * ow + ox] = (px(sy, sx) + px(sy, sx + 1) +
                                   px(sy + 1, sx) + px(sy + 1, sx + 1) +
                                   bias) >> 2;
      bias ^= 3;
    }
  }
  return c;
}

// ------------------------------------------------------------ transform

// jfdctint.c, CONST_BITS 13, PASS1_BITS 2
const int64_t F0_298631336 = 2446, F0_390180644 = 3196, F0_541196100 = 4433,
              F0_765366865 = 6270, F0_899976223 = 7373, F1_175875602 = 9633,
              F1_501321110 = 12299, F1_847759065 = 15137,
              F1_961570560 = 16069, F2_053119869 = 16819,
              F2_562915447 = 20995, F3_072711026 = 25172;
const int kConst = 13, kPass1 = 2;

int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

void fdct_islow(int* d) {
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass == 0 ? 1 : 8, stride = pass == 0 ? 8 : 1;
    for (int i = 0; i < 8; ++i) {
      int* p = d + i * stride;
      int64_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
      int64_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
      int64_t tmp2 = p[2 * step] + p[5 * step], tmp5 = p[2 * step] - p[5 * step];
      int64_t tmp3 = p[3 * step] + p[4 * step], tmp4 = p[3 * step] - p[4 * step];
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      const int sh = pass == 0 ? kConst - kPass1 : kConst + kPass1;
      if (pass == 0) {
        p[0] = int((tmp10 + tmp11) * (1 << kPass1));
        p[4 * step] = int((tmp10 - tmp11) * (1 << kPass1));
      } else {
        p[0] = int(descale(tmp10 + tmp11, kPass1));
        p[4 * step] = int(descale(tmp10 - tmp11, kPass1));
      }
      int64_t z1 = (tmp12 + tmp13) * F0_541196100;
      p[2 * step] = int(descale(z1 + tmp13 * F0_765366865, sh));
      p[6 * step] = int(descale(z1 + tmp12 * -F1_847759065, sh));
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * F1_175875602;
      tmp4 *= F0_298631336;
      tmp5 *= F2_053119869;
      tmp6 *= F3_072711026;
      tmp7 *= F1_501321110;
      z1 *= -F0_899976223;
      z2 *= -F2_562915447;
      z3 *= -F1_961570560;
      z4 *= -F0_390180644;
      z3 += z5;
      z4 += z5;
      p[7 * step] = int(descale(tmp4 + z1 + z3, sh));
      p[5 * step] = int(descale(tmp5 + z2 + z4, sh));
      p[3 * step] = int(descale(tmp6 + z2 + z3, sh));
      p[step] = int(descale(tmp7 + z1 + z4, sh));
    }
  }
}

// jcdctmgr.c compute_reciprocal with 16-bit DCT elements: the quotient
// is ((|x| + corr) * recip) >> shift, the sign restored.
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  if (divisor == 1) return {1, 0, 0};
  int b = 31 - __builtin_clz(divisor);
  int r = 16 + b;
  uint64_t fq = (uint64_t(1) << r) / divisor;
  uint64_t fr = (uint64_t(1) << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2U) {
    c++;
  } else {
    fq++;
  }
  return {uint32_t(fq), c, r};
}

struct Quant {
  int table[64];      // natural order, written to DQT
  Divisor div[64];
};

Quant make_quant(const int* base, int quality) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  const int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  Quant q;
  for (int i = 0; i < 64; ++i) {
    long t = (long(base[i]) * scale + 50L) / 100L;
    if (t <= 0) t = 1;
    if (t > 255) t = 255;            // force_baseline
    q.table[i] = int(t);
    q.div[i] = reciprocal(uint32_t(t) << 3);   // islow output is x8
  }
  return q;
}

void quantize(const int* coef, const Quant& q, int* out) {
  for (int i = 0; i < 64; ++i) {
    const Divisor& d = q.div[i];
    int64_t t = coef[i];
    const bool neg = t < 0;
    if (neg) t = -t;
    uint64_t prod = uint64_t(uint32_t(t + d.corr)) * d.recip;
    int64_t v = int64_t(prod >> d.shift);
    out[i] = int(neg ? -v : v);
  }
}

// ------------------------------------------------------------ entropy

struct HuffTable {
  uint16_t code[256];
  uint8_t size[256];
};

HuffTable make_huff(const uint8_t* bits, const uint8_t* vals) {
  HuffTable t{};
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < bits[len - 1]; ++i, ++k) {
      t.code[vals[k]] = uint16_t(code++);
      t.size[vals[k]] = uint8_t(len);
    }
    code <<= 1;
  }
  return t;
}

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int n = 0;
  void put(uint32_t bits, int len) {
    if (len == 0) return;
    acc = (acc << len) | (bits & ((1u << len) - 1));
    n += len;
    while (n >= 8) {
      uint8_t byte = uint8_t(acc >> (n - 8));
      out.push_back(byte);
      if (byte == 0xFF) out.push_back(0);
      n -= 8;
    }
    acc &= (1u << n) - 1;
  }
  void flush() { put(0x7F, 7 - ((n + 7) % 8)); }
};

void encode_block(BitWriter& bw, const int* q, int& last_dc,
                  const HuffTable& dc, const HuffTable& ac) {
  int temp = q[0] - last_dc, temp2 = temp;
  last_dc = q[0];
  if (temp < 0) {
    temp = -temp;
    temp2--;
  }
  int nbits = 0;
  while (temp) {
    nbits++;
    temp >>= 1;
  }
  bw.put(dc.code[nbits], dc.size[nbits]);
  bw.put(uint32_t(temp2), nbits);
  int r = 0;
  for (int k = 1; k < 64; ++k) {
    temp = q[kNatural[k]];
    if (temp == 0) {
      r++;
      continue;
    }
    while (r > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      r -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      temp2--;
    }
    nbits = 1;
    while ((temp >>= 1)) nbits++;
    const int sym = (r << 4) + nbits;
    bw.put(ac.code[sym], ac.size[sym]);
    bw.put(uint32_t(temp2), nbits);
    r = 0;
  }
  if (r > 0) bw.put(ac.code[0], ac.size[0]);
}

// ------------------------------------------------------------ markers

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back(uint8_t(v >> 8));
  o.push_back(uint8_t(v & 0xFF));
}

void marker(std::vector<uint8_t>& o, uint8_t m, int len) {
  o.push_back(0xFF);
  o.push_back(m);
  put16(o, len);
}

void dqt(std::vector<uint8_t>& o, int index, const Quant& q) {
  marker(o, 0xDB, 67);
  o.push_back(uint8_t(index));
  for (int k = 0; k < 64; ++k) o.push_back(uint8_t(q.table[kNatural[k]]));
}

void dht(std::vector<uint8_t>& o, int klass_index, const uint8_t* bits,
         const uint8_t* vals) {
  int n = 0;
  for (int i = 0; i < 16; ++i) n += bits[i];
  marker(o, 0xC4, 2 + 1 + 16 + n);
  o.push_back(uint8_t(klass_index));
  o.insert(o.end(), bits, bits + 16);
  o.insert(o.end(), vals, vals + n);
}

void block_at(const Comp& c, int by, int bx, int* out) {
  for (int y = 0; y < 8; ++y)
    for (int x = 0; x < 8; ++x)
      out[y * 8 + x] = c.at(by * 8 + y, bx * 8 + x) - 128;
}

std::vector<uint8_t> encode(const uint8_t* rgb, int w, int h, int quality) {
  if (w <= 0 || h <= 0 || w > 65535 || h > 65535)
    fail("image size out of range for baseline JPEG");
  const Planes p = rgb_to_ycc(rgb, w, h);
  const Comp y = luma(p), cb = chroma(p.cb, w, h), cr = chroma(p.cr, w, h);
  const Quant ql = make_quant(kStdLuma, quality),
              qc = make_quant(kStdChroma, quality);
  const HuffTable dcl = make_huff(kDcLumaBits, kDcVals),
                  acl = make_huff(kAcLumaBits, kAcLumaVals),
                  dcc = make_huff(kDcChromaBits, kDcVals),
                  acc = make_huff(kAcChromaBits, kAcChromaVals);

  std::vector<uint8_t> o;
  o.reserve(size_t(w) * h / 2 + 1024);
  o.push_back(0xFF);
  o.push_back(0xD8);
  marker(o, 0xE0, 16);          // JFIF 1.01, density unit 0, 1:1
  const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  o.insert(o.end(), jfif, jfif + 14);
  dqt(o, 0, ql);
  dqt(o, 1, qc);
  marker(o, 0xC0, 17);
  o.push_back(8);
  put16(o, h);
  put16(o, w);
  o.push_back(3);
  const uint8_t sof[9] = {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
  o.insert(o.end(), sof, sof + 9);
  dht(o, 0x00, kDcLumaBits, kDcVals);
  dht(o, 0x10, kAcLumaBits, kAcLumaVals);
  dht(o, 0x01, kDcChromaBits, kDcVals);
  dht(o, 0x11, kAcChromaBits, kAcChromaVals);
  marker(o, 0xDA, 12);
  const uint8_t sos[8] = {3, 1, 0x00, 2, 0x11, 3, 0x11, 0};
  o.insert(o.end(), sos, sos + 8);
  o.push_back(63);
  o.push_back(0);

  const int wb = ceil_div(w, 8), hb = ceil_div(h, 8);   // luma blocks
  const int mcu_w = ceil_div(w, 16), mcu_h = ceil_div(h, 16);
  BitWriter bw{o};
  int dc_y = 0, dc_cb = 0, dc_cr = 0;
  int blk[64], mcu[4][64], q[64];
  for (int my = 0; my < mcu_h; ++my) {
    for (int mx = 0; mx < mcu_w; ++mx) {
      for (int yi = 0; yi < 2; ++yi) {
        for (int xi = 0; xi < 2; ++xi) {
          const int n = yi * 2 + xi, by = 2 * my + yi, bx = 2 * mx + xi;
          if (by >= hb) {          // a dummy row: the DC of block n - 1
            std::memset(mcu[n], 0, sizeof(mcu[n]));
            mcu[n][0] = mcu[yi * 2 - 1][0];
          } else if (bx >= wb) {   // a dummy column: the DC to its left
            std::memset(mcu[n], 0, sizeof(mcu[n]));
            mcu[n][0] = mcu[n - 1][0];
          } else {
            block_at(y, by, bx, blk);
            fdct_islow(blk);
            quantize(blk, ql, mcu[n]);
          }
        }
      }
      for (int n = 0; n < 4; ++n) encode_block(bw, mcu[n], dc_y, dcl, acl);
      for (int ci = 0; ci < 2; ++ci) {
        block_at(ci == 0 ? cb : cr, my, mx, blk);
        fdct_islow(blk);
        quantize(blk, qc, q);
        encode_block(bw, q, ci == 0 ? dc_cb : dc_cr, dcc, acc);
      }
    }
  }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
  return o;
}

}  // namespace

extern "C" long long ucn_jpeg_encode(const uint8_t* rgb, int width,
                                     int height, int quality, uint8_t* out,
                                     long long cap, char* err, int errlen) {
  try {
    std::vector<uint8_t> file = encode(rgb, width, height, quality);
    if (static_cast<long long>(file.size()) <= cap)
      std::memcpy(out, file.data(), file.size());
    return static_cast<long long>(file.size());
  } catch (const Error& e) {
    std::snprintf(err, errlen, "%s", e.msg.c_str());
  } catch (const std::exception& e) {
    std::snprintf(err, errlen, "%s", e.what());
  }
  return -1;
}
