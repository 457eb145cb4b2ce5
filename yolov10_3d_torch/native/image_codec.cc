// Image codec of the port's host data layer (yolov10_3d_torch/data/image_io.py),
// called through ctypes from yolov10_3d_torch/native/image_codec.py.
//
// JPEG decoding gives the pixels libjpeg-turbo 3.1 gives with its defaults
// (the library that cv2 and PIL decode with): baseline and progressive
// Huffman scans, restart intervals, the ISLOW inverse DCT (jidctint.c's
// integer arithmetic), the fancy upsampling of jdsample.c (h2v1, h1v2 and
// h2v2 triangle filters with their rounding biases; replication where
// libjpeg replicates) and jdcolor.c's fixed-point YCbCr->RGB tables.
// JPEG encoding writes the bytes libjpeg-turbo writes with its defaults:
// JFIF 1.01, quality-scaled standard tables, 4:2:0 with jcsample.c's h2v2
// bias, the ISLOW forward DCT (jfdctint.c), jcdctmgr.c's reciprocal
// quantisation and the standard Huffman tables. The PNG unfilter undoes
// the five row filters.
//
// Every stage is also stated in numpy in yolov10_3d_torch/data/codec_rules.py;
// a decode or encode handle exports its coefficient blocks and component
// planes so that each stage can be held to its rule. Errors are returned as
// text: "unsupported: ..." for a valid file that is not decoded here, any
// other text for a file that is not valid.
// image_codec.py builds it with
//   g++ -O3 -shared -fPIC -o image_codec-<hash>.so image_codec.cc
// into yolov10_3d_torch/_build/ at first use.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

const int kNatural[64 + 16] = {  // zigzag index -> natural index (jpeg_natural_order)
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};  // overrun guard

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string& m) { throw Error{m}; }

// ---------------------------------------------------------------- ISLOW IDCT

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// jidctint.c's post-IDCT range limit: a 1024-entry table indexed by x & 1023.
inline uint8_t idct_limit(int64_t x) {
  const int i = static_cast<int>(x & 1023);
  if (i < 128) return static_cast<uint8_t>(i + 128);
  if (i < 512) return 255;
  if (i < 896) return 0;
  return static_cast<uint8_t>(i - 896);
}

// One 8x8 block: coef (natural order) dequantised by q, written to out with
// the given row stride.
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int64_t ws[64];
  for (int c = 0; c < 8; ++c) {  // pass 1: columns
    auto in = [&](int r) { return int64_t(coef[r * 8 + c]) * q[r * 8 + c]; };
    if (!coef[8 + c] && !coef[16 + c] && !coef[24 + c] && !coef[32 + c] && !coef[40 + c] &&
        !coef[48 + c] && !coef[56 + c]) {  // libjpeg's shortcut: the same values
      const int64_t dc = in(0) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
      continue;
    }
    const int64_t z2e = in(2), z3e = in(6);
    int64_t z1 = (z2e + z3e) * FIX_0_541196100;
    const int64_t tmp2e = z1 + z3e * -FIX_1_847759065;
    const int64_t tmp3e = z1 + z2e * FIX_0_765366865;
    const int64_t z0 = in(0), z4v = in(4);
    const int64_t tmp0e = (z0 + z4v) * (int64_t(1) << kConstBits);
    const int64_t tmp1e = (z0 - z4v) * (int64_t(1) << kConstBits);
    const int64_t tmp10 = tmp0e + tmp3e, tmp13 = tmp0e - tmp3e;
    const int64_t tmp11 = tmp1e + tmp2e, tmp12 = tmp1e - tmp2e;
    int64_t tmp0 = in(7), tmp1 = in(5), tmp2 = in(3), tmp3 = in(1);
    z1 = tmp0 + tmp3;
    int64_t z2 = tmp1 + tmp2, z3 = tmp0 + tmp2, z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits - kPass1Bits;
    ws[0 * 8 + c] = static_cast<int32_t>(descale(tmp10 + tmp3, n));
    ws[7 * 8 + c] = static_cast<int32_t>(descale(tmp10 - tmp3, n));
    ws[1 * 8 + c] = static_cast<int32_t>(descale(tmp11 + tmp2, n));
    ws[6 * 8 + c] = static_cast<int32_t>(descale(tmp11 - tmp2, n));
    ws[2 * 8 + c] = static_cast<int32_t>(descale(tmp12 + tmp1, n));
    ws[5 * 8 + c] = static_cast<int32_t>(descale(tmp12 - tmp1, n));
    ws[3 * 8 + c] = static_cast<int32_t>(descale(tmp13 + tmp0, n));
    ws[4 * 8 + c] = static_cast<int32_t>(descale(tmp13 - tmp0, n));
  }
  for (int r = 0; r < 8; ++r) {  // pass 2: rows
    const int64_t* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {  // the same values
      std::memset(o, idct_limit(descale(w[0], kPass1Bits + 3)), 8);
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    const int64_t tmp2e = z1 + z3 * -FIX_1_847759065;
    const int64_t tmp3e = z1 + z2 * FIX_0_765366865;
    const int64_t tmp0e = (w[0] + w[4]) * (int64_t(1) << kConstBits);
    const int64_t tmp1e = (w[0] - w[4]) * (int64_t(1) << kConstBits);
    const int64_t tmp10 = tmp0e + tmp3e, tmp13 = tmp0e - tmp3e;
    const int64_t tmp11 = tmp1e + tmp2e, tmp12 = tmp1e - tmp2e;
    int64_t tmp0 = w[7], tmp1 = w[5], tmp2 = w[3], tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits + kPass1Bits + 3;
    o[0] = idct_limit(descale(tmp10 + tmp3, n));
    o[7] = idct_limit(descale(tmp10 - tmp3, n));
    o[1] = idct_limit(descale(tmp11 + tmp2, n));
    o[6] = idct_limit(descale(tmp11 - tmp2, n));
    o[2] = idct_limit(descale(tmp12 + tmp1, n));
    o[5] = idct_limit(descale(tmp12 - tmp1, n));
    o[3] = idct_limit(descale(tmp13 + tmp0, n));
    o[4] = idct_limit(descale(tmp13 - tmp0, n));
  }
}

// ---------------------------------------------------------------- ISLOW FDCT

// One 8x8 block of samples - 128 (natural order), in place; the output is
// scaled up by 8, as jfdctint.c leaves it.
void fdct_islow(int32_t* d) {
  for (int r = 0; r < 8; ++r) {
    int32_t* p = d + r * 8;
    const int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7], tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    const int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5], tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = static_cast<int32_t>((tmp10 + tmp11) * (1 << kPass1Bits));
    p[4] = static_cast<int32_t>((tmp10 - tmp11) * (1 << kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    const int n = kConstBits - kPass1Bits;
    p[2] = static_cast<int32_t>(descale(z1 + tmp13 * FIX_0_765366865, n));
    p[6] = static_cast<int32_t>(descale(z1 + tmp12 * -FIX_1_847759065, n));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    const int64_t t4 = tmp4 * FIX_0_298631336, t5 = tmp5 * FIX_2_053119869;
    const int64_t t6 = tmp6 * FIX_3_072711026, t7 = tmp7 * FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = static_cast<int32_t>(descale(t4 + z1 + z3, n));
    p[5] = static_cast<int32_t>(descale(t5 + z2 + z4, n));
    p[3] = static_cast<int32_t>(descale(t6 + z2 + z3, n));
    p[1] = static_cast<int32_t>(descale(t7 + z1 + z4, n));
  }
  for (int c = 0; c < 8; ++c) {
    int32_t* p = d + c;
    auto at = [&](int r) -> int32_t& { return p[r * 8]; };
    const int64_t tmp0 = at(0) + at(7), tmp7 = at(0) - at(7), tmp1 = at(1) + at(6), tmp6 = at(1) - at(6);
    const int64_t tmp2 = at(2) + at(5), tmp5 = at(2) - at(5), tmp3 = at(3) + at(4), tmp4 = at(3) - at(4);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    at(0) = static_cast<int32_t>(descale(tmp10 + tmp11, kPass1Bits));
    at(4) = static_cast<int32_t>(descale(tmp10 - tmp11, kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    const int n = kConstBits + kPass1Bits;
    at(2) = static_cast<int32_t>(descale(z1 + tmp13 * FIX_0_765366865, n));
    at(6) = static_cast<int32_t>(descale(z1 + tmp12 * -FIX_1_847759065, n));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    const int64_t t4 = tmp4 * FIX_0_298631336, t5 = tmp5 * FIX_2_053119869;
    const int64_t t6 = tmp6 * FIX_3_072711026, t7 = tmp7 * FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    at(7) = static_cast<int32_t>(descale(t4 + z1 + z3, n));
    at(5) = static_cast<int32_t>(descale(t5 + z2 + z4, n));
    at(3) = static_cast<int32_t>(descale(t6 + z2 + z3, n));
    at(1) = static_cast<int32_t>(descale(t7 + z1 + z4, n));
  }
}

// jcdctmgr.c compute_reciprocal for a divisor of quantval << 3, with 16-bit
// DCT elements: quantised = sign(t) * (((|t| + corr) * recip) >> shift).
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  int b = 0;
  while ((divisor >> (b + 1)) != 0) ++b;  // flss(divisor) - 1
  int r = 16 + b;
  uint64_t fq = (uint64_t(1) << r) / divisor;
  const uint64_t fr = (uint64_t(1) << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2) {
    ++c;
  } else {
    ++fq;
  }
  return {static_cast<uint32_t>(fq), c, r};
}

inline int16_t quantize(int32_t t, const Divisor& dv) {
  const uint32_t a = static_cast<uint32_t>(t < 0 ? -t : t);
  const uint32_t q = static_cast<uint32_t>((uint64_t(a + dv.corr) * dv.recip) >> dv.shift);
  return static_cast<int16_t>(t < 0 ? -static_cast<int32_t>(q) : static_cast<int32_t>(q));
}

// ---------------------------------------------------------------- colour

constexpr int kScaleBits = 16;
constexpr int64_t kOneHalf = int64_t(1) << (kScaleBits - 1);
inline int64_t fix16(double x) { return static_cast<int64_t>(x * 65536.0 + 0.5); }

struct YccTables {  // jdcolor.c build_ycc_rgb_table
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix16(1.40200) * x + kOneHalf) >> kScaleBits);
      cb_b[i] = static_cast<int>((fix16(1.77200) * x + kOneHalf) >> kScaleBits);
      cr_g[i] = -fix16(0.71414) * x;
      cb_g[i] = -fix16(0.34414) * x + kOneHalf;
    }
  }
};

struct RgbYccTables {  // jccolor.c rgb_ycc_start
  int64_t t[8][256];
  RgbYccTables() {
    const int64_t cbcr_offset = int64_t(128) << kScaleBits;
    for (int i = 0; i < 256; ++i) {
      t[0][i] = fix16(0.29900) * i;
      t[1][i] = fix16(0.58700) * i;
      t[2][i] = fix16(0.11400) * i + kOneHalf;
      t[3][i] = -fix16(0.16874) * i;
      t[4][i] = -fix16(0.33126) * i;
      t[5][i] = fix16(0.50000) * i + cbcr_offset + kOneHalf - 1;  // B->Cb and R->Cr
      t[6][i] = -fix16(0.41869) * i;
      t[7][i] = -fix16(0.08131) * i;
    }
  }
};

const YccTables& ycc() {
  static const YccTables t;
  return t;
}
const RgbYccTables& rgbycc() {
  static const RgbYccTables t;
  return t;
}

inline uint8_t clamp255(int64_t v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// ---------------------------------------------------------------- Huffman

struct HuffTable {
  bool present = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
  int maxcode[18];
  int valptr[17];
  int mincode[17];
  uint16_t look[512];  // 9-bit lookahead: (length << 8) | value, 0 = not in 9 bits

  void build() {
    int code = 0, k = 0;
    std::fill(look, look + 512, 0);
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k;
      mincode[l] = code;
      for (int i = 0; i < bits[l]; ++i, ++k, ++code) {
        if (l <= 9) {
          const int base = code << (9 - l);
          for (int j = 0; j < (1 << (9 - l)); ++j) look[base + j] = static_cast<uint16_t>((l << 8) | vals[k]);
        }
      }
      maxcode[l] = bits[l] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    present = true;
  }
};

struct BitReader {
  const uint8_t* d;
  size_t n, pos;
  uint32_t buf = 0;
  int cnt = 0;
  bool marker = false;

  void fill() {
    while (cnt <= 24) {
      uint32_t b = 0;
      if (!marker && pos < n) {
        b = d[pos];
        if (b == 0xFF) {
          const uint8_t nb = pos + 1 < n ? d[pos + 1] : 0xD9;
          if (nb == 0) {
            pos += 2;
          } else {
            marker = true;  // libjpeg feeds zeros past a marker
            b = 0;
          }
        } else {
          ++pos;
        }
      }
      buf |= b << (24 - cnt);
      cnt += 8;
    }
  }
  int peek16() {
    fill();
    return static_cast<int>(buf >> 16);
  }
  void skip(int k) {
    buf <<= k;
    cnt -= k;
  }
  int bits(int k) {
    if (k == 0) return 0;
    fill();
    const int v = static_cast<int>(buf >> (32 - k));
    skip(k);
    return v;
  }
  int bit() { return bits(1); }
  int decode(const HuffTable& h) {
    const int p = peek16();
    const uint16_t e = h.look[p >> 7];
    if (e) {
      skip(e >> 8);
      return e & 255;
    }
    for (int l = 10; l <= 16; ++l) {
      const int code = p >> (16 - l);
      if (code <= h.maxcode[l]) {
        skip(l);
        return h.vals[h.valptr[l] + code - h.mincode[l]];
      }
    }
    skip(16);  // libjpeg: corrupt data, treated as 0
    return 0;
  }
  void reset_at_restart() {
    buf = 0;
    cnt = 0;
    while (pos + 1 < n && !(d[pos] == 0xFF && d[pos + 1] >= 0xD0 && d[pos + 1] <= 0xD7)) ++pos;
    if (pos + 1 < n) pos += 2;
    marker = false;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// ---------------------------------------------------------------- decoder

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;            // blocks allocated (the MCU grid)
  int bw_real = 0, bh_real = 0;  // blocks holding image samples
  int dw = 0, dh = 0;            // downsampled_width / _height
  int dc_tbl = 0, ac_tbl = 0, pred = 0;
  int pw = 0;                  // plane width
  std::vector<int16_t> coef;   // bh * bw blocks, natural order
  std::vector<uint8_t> plane;  // decoding: the IDCT output, (bh * 8) x (bw * 8); encoding:
                               // the downsampled samples, (bh * 8) x (bw_real * 8)
  int coef_bits[64];
};

struct Codec {
  std::string error;
  int H = 0, W = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  bool progressive = false;
  int transform = 0;  // 0 grey, 1 YCbCr, 2 RGB
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  uint16_t q[4][64] = {};
  bool q_present[4] = {};
  HuffTable dc[4], ac[4];
  int restart = 0;
  std::vector<Component> comps;
  std::vector<uint8_t> pixels;  // decoded H x W x 3, or the encoded bytes
};

inline uint16_t be16(const uint8_t* p) { return static_cast<uint16_t>((p[0] << 8) | p[1]); }

struct Decoder {
  Codec& c;
  const uint8_t* d;
  size_t n;
  int64_t max_pixels;  // larger frames are refused before anything is allocated
  size_t pos = 2;
  int eobrun = 0;

  Decoder(Codec& codec, const uint8_t* data, size_t len, int64_t limit)
      : c(codec), d(data), n(len), max_pixels(limit) {}

  int next_marker() {
    while (pos < n && d[pos] != 0xFF) ++pos;  // garbage before a marker is skipped
    while (pos < n && d[pos] == 0xFF) ++pos;
    if (pos >= n) fail("truncated JPEG: no EOI marker");
    return d[pos++];
  }

  const uint8_t* segment(size_t* len) {
    if (pos + 2 > n) fail("truncated JPEG segment");
    const size_t L = be16(d + pos);
    if (L < 2 || pos + L > n) fail("truncated JPEG segment");
    const uint8_t* body = d + pos + 2;
    *len = L - 2;
    pos += L;
    return body;
  }

  void run() {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file");
    bool frame = false;
    for (;;) {
      const int m = next_marker();
      if (m == 0xD9) break;
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      size_t L;
      const uint8_t* s = segment(&L);
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        if (frame) fail("unsupported: more than one frame (hierarchical JPEG)");
        frame = true;
        sof(s, L, m == 0xC2);
      } else if (m == 0xC3 || (m >= 0xC5 && m <= 0xC7) || (m >= 0xC9 && m <= 0xCB) ||
                 (m >= 0xCD && m <= 0xCF)) {
        fail((m >= 0xC9) ? "unsupported: arithmetic-coded JPEG" : "unsupported: lossless or hierarchical JPEG");
      } else if (m == 0xC4) {
        dht(s, L);
      } else if (m == 0xCC) {
        fail("unsupported: arithmetic-coded JPEG");
      } else if (m == 0xDB) {
        dqt(s, L);
      } else if (m == 0xDD) {
        if (L < 2) fail("bad DRI");
        c.restart = be16(s);
      } else if (m == 0xDA) {
        if (!frame) fail("JPEG scan before its frame header");
        sos(s, L);
      } else if (m == 0xE0) {
        if (L >= 5 && std::memcmp(s, "JFIF\0", 5) == 0) c.jfif = true;
      } else if (m == 0xEE) {
        if (L >= 12 && std::memcmp(s, "Adobe", 5) == 0) {
          c.adobe = true;
          c.adobe_transform = s[11];
        }
      }
    }
    if (!frame) fail("JPEG without a frame header");
    finish();
  }

  void sof(const uint8_t* s, size_t L, bool prog) {
    if (L < 6) fail("bad SOF");
    if (s[0] != 8) fail("unsupported: " + std::to_string(s[0]) + "-bit JPEG samples");
    c.progressive = prog;
    c.H = be16(s + 1);
    c.W = be16(s + 3);
    const int nc = s[5];
    if (c.H == 0) fail("unsupported: JPEG height set by a DNL marker");
    if (c.W == 0 || nc == 0 || L < size_t(6 + 3 * nc)) fail("bad SOF");
    if (int64_t(c.W) * c.H > max_pixels)
      fail("JPEG of " + std::to_string(c.W) + "x" + std::to_string(c.H) + " pixels, over the limit of " +
           std::to_string(max_pixels));
    if (nc == 4) fail("unsupported: CMYK or YCCK JPEG");
    if (nc != 1 && nc != 3) fail("unsupported: JPEG with " + std::to_string(nc) + " components");
    c.comps.resize(nc);
    for (int i = 0; i < nc; ++i) {
      Component& k = c.comps[i];
      k.id = s[6 + 3 * i];
      k.h = s[7 + 3 * i] >> 4;
      k.v = s[7 + 3 * i] & 15;
      k.tq = s[8 + 3 * i] & 3;
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4) fail("bad JPEG sampling factors");
      c.hmax = std::max(c.hmax, k.h);
      c.vmax = std::max(c.vmax, k.v);
      std::fill(k.coef_bits, k.coef_bits + 64, -1);
    }
    c.mcux = (c.W + 8 * c.hmax - 1) / (8 * c.hmax);
    c.mcuy = (c.H + 8 * c.vmax - 1) / (8 * c.vmax);
    for (Component& k : c.comps) {
      k.dw = (c.W * k.h + c.hmax - 1) / c.hmax;
      k.dh = (c.H * k.v + c.vmax - 1) / c.vmax;
      k.bw_real = (k.dw + 7) / 8;
      k.bh_real = (k.dh + 7) / 8;
      k.bw = c.mcux * k.h;
      k.bh = c.mcuy * k.v;
      k.coef.assign(size_t(k.bw) * k.bh * 64, 0);
    }
  }

  void dht(const uint8_t* s, size_t L) {
    size_t p = 0;
    while (p < L) {
      if (p + 17 > L) fail("bad DHT");
      const int tc = s[p] >> 4, th = s[p] & 15;
      if (tc > 1 || th > 3) fail("bad DHT table index");
      HuffTable& t = tc ? c.ac[th] : c.dc[th];
      int total = 0;
      for (int i = 1; i <= 16; ++i) total += t.bits[i] = s[p + i];
      if (total > 256 || p + 17 + total > L) fail("bad DHT");
      std::memcpy(t.vals, s + p + 17, total);
      t.build();
      p += 17 + total;
    }
  }

  void dqt(const uint8_t* s, size_t L) {
    size_t p = 0;
    while (p < L) {
      const int pq = s[p] >> 4, tq = s[p] & 15;
      if (tq > 3) fail("bad DQT table index");
      const size_t len = pq ? 128 : 64;
      if (p + 1 + len > L) fail("bad DQT");
      for (int k = 0; k < 64; ++k)
        c.q[tq][kNatural[k]] = pq ? be16(s + p + 1 + 2 * k) : s[p + 1 + k];
      c.q_present[tq] = true;
      p += 1 + len;
    }
  }

  void sos(const uint8_t* s, size_t L) {
    if (L < 1) fail("bad SOS");
    const int ns = s[0];
    if (ns < 1 || ns > 4 || L < size_t(4 + 2 * ns)) fail("bad SOS");
    std::vector<Component*> scomp;
    for (int i = 0; i < ns; ++i) {
      const int id = s[1 + 2 * i];
      Component* k = nullptr;
      for (Component& cc : c.comps)
        if (cc.id == id) k = &cc;
      if (!k) fail("SOS names an unknown component");
      k->dc_tbl = s[2 + 2 * i] >> 4;
      k->ac_tbl = s[2 + 2 * i] & 15;
      if (k->dc_tbl > 3 || k->ac_tbl > 3) fail("bad SOS table index");
      scomp.push_back(k);
    }
    const int ss = s[1 + 2 * ns], se = s[2 + 2 * ns], ah = s[3 + 2 * ns] >> 4, al = s[3 + 2 * ns] & 15;
    if (!c.progressive) {
      if (ss != 0 || se != 63 || ah != 0 || al != 0) fail("bad baseline SOS");
    } else {
      if (se > 63 || ss > se || (ss == 0 && se != 0) || (ss > 0 && ns != 1) || al > 13)
        fail("bad progressive SOS");
    }
    for (Component* k : scomp) {
      for (int i = ss; i <= se; ++i) k->coef_bits[i] = al;
      if (!c.progressive || ss == 0) {
        if (ah == 0 && !c.dc[k->dc_tbl].present) fail("scan uses an undefined DC table");
      }
      if ((!c.progressive || ss > 0) && !c.ac[k->ac_tbl].present) fail("scan uses an undefined AC table");
    }
    BitReader br{d, n, pos};
    for (Component* k : scomp) k->pred = 0;
    eobrun = 0;
    int todo = c.restart;
    auto block_at = [](Component* k, int by, int bx) { return k->coef.data() + (size_t(by) * k->bw + bx) * 64; };
    auto step = [&]() {
      if (c.restart == 0) return;
      if (todo == 0) {
        br.reset_at_restart();
        for (Component* k : scomp) k->pred = 0;
        eobrun = 0;
        todo = c.restart;
      }
      --todo;
    };
    auto decode_block = [&](Component* k, int16_t* blk) {
      if (!c.progressive) {
        baseline_block(br, k, blk);
      } else if (ss == 0) {
        if (ah == 0) {
          const int t = br.decode(c.dc[k->dc_tbl]);
          const int diff = t ? extend(br.bits(t), t) : 0;
          k->pred += diff;
          blk[0] = static_cast<int16_t>(k->pred * (1 << al));
        } else if (br.bit()) {
          blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
        }
      } else if (ah == 0) {
        ac_first(br, c.ac[k->ac_tbl], blk, ss, se, al);
      } else {
        ac_refine(br, c.ac[k->ac_tbl], blk, ss, se, al);
      }
    };
    if (ns == 1) {  // non-interleaved: the component's own blocks
      Component* k = scomp[0];
      for (int by = 0; by < k->bh_real; ++by)
        for (int bx = 0; bx < k->bw_real; ++bx) {
          step();
          decode_block(k, block_at(k, by, bx));
        }
    } else {
      for (int my = 0; my < c.mcuy; ++my)
        for (int mx = 0; mx < c.mcux; ++mx) {
          step();
          for (Component* k : scomp)
            for (int y = 0; y < k->v; ++y)
              for (int x = 0; x < k->h; ++x) decode_block(k, block_at(k, my * k->v + y, mx * k->h + x));
        }
    }
    pos = br.pos;  // the next marker search starts where the entropy data stopped
  }

  void baseline_block(BitReader& br, Component* k, int16_t* blk) {
    const int t = br.decode(c.dc[k->dc_tbl]);
    const int diff = t ? extend(br.bits(t), t) : 0;
    k->pred += diff;
    blk[0] = static_cast<int16_t>(k->pred);
    const HuffTable& at = c.ac[k->ac_tbl];
    for (int i = 1; i < 64;) {
      const int rs = br.decode(at);
      const int r = rs >> 4, s = rs & 15;
      if (s) {
        i += r;
        if (i > 63) break;
        blk[kNatural[i]] = static_cast<int16_t>(extend(br.bits(s), s));
        ++i;
      } else {
        if (r != 15) break;
        i += 16;
      }
    }
  }

  void ac_first(BitReader& br, const HuffTable& at, int16_t* blk, int ss, int se, int al) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      const int rs = br.decode(at);
      const int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) break;
        blk[kNatural[k]] = static_cast<int16_t>(extend(br.bits(s), s) * (1 << al));
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.bits(r);
        --eobrun;
        break;
      }
    }
  }

  void ac_refine(BitReader& br, const HuffTable& at, int16_t* blk, int ss, int se, int al) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    auto refine = [&](int16_t* coef) {
      if (br.bit() && (*coef & p1) == 0) *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
    };
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        const int rs = br.decode(at);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            refine(coef);
          } else {
            if (--r < 0) break;
          }
          ++k;
        } while (k <= se);
        if (s && k <= 63) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) refine(coef);
      }
      --eobrun;
    }
  }

  void finish() {
    const int nc = static_cast<int>(c.comps.size());
    if (c.progressive) {  // libjpeg would smooth blocks whose low AC coefficients are incomplete
      for (const Component& k : c.comps) {
        if (k.coef_bits[0] < 0) fail("progressive JPEG without its DC scan");
        for (int i = 1; i < 10; ++i)
          if (k.coef_bits[i] != 0)
            fail("unsupported: progressive JPEG whose scans leave low-frequency coefficients "
                 "incomplete (libjpeg's block smoothing)");
      }
    }
    for (Component& k : c.comps) {
      if (!c.q_present[k.tq]) fail("component uses an undefined quantisation table");
      const int pw = k.pw = k.bw * 8;
      k.plane.assign(size_t(pw) * k.bh * 8, 0);
      for (int by = 0; by < k.bh; ++by)
        for (int bx = 0; bx < k.bw; ++bx)
          idct_islow(k.coef.data() + (size_t(by) * k.bw + bx) * 64, c.q[k.tq],
                     k.plane.data() + size_t(by) * 8 * pw + bx * 8, pw);
    }
    if (nc == 1) {
      c.transform = 0;
    } else if (c.jfif) {
      c.transform = 1;
    } else if (c.adobe) {
      c.transform = c.adobe_transform == 0 ? 2 : 1;
    } else if (c.comps[0].id == 'R' && c.comps[1].id == 'G' && c.comps[2].id == 'B') {
      c.transform = 2;
    } else {
      c.transform = 1;
    }
    std::vector<std::vector<uint8_t>> full(nc);
    for (int i = 0; i < nc; ++i) full[i] = upsample(c.comps[i]);
    const size_t npix = size_t(c.H) * c.W;
    c.pixels.resize(npix * 3);
    uint8_t* o = c.pixels.data();
    const YccTables& t = ycc();
    for (size_t p = 0; p < npix; ++p, o += 3) {
      if (c.transform == 0) {
        o[0] = o[1] = o[2] = full[0][p];
      } else if (c.transform == 2) {
        o[0] = full[0][p];
        o[1] = full[1][p];
        o[2] = full[2][p];
      } else {
        const int y = full[0][p], cb = full[1][p], cr = full[2][p];
        o[0] = clamp255(y + t.cr_r[cr]);
        o[1] = clamp255(y + ((t.cb_g[cb] + t.cr_g[cr]) >> kScaleBits));
        o[2] = clamp255(y + t.cb_b[cb]);
      }
    }
  }

  // The component at full size, H x W (jdsample.c).
  std::vector<uint8_t> upsample(const Component& k) {
    const int rh = c.hmax / k.h, rv = c.vmax / k.v;
    if (c.hmax % k.h || c.vmax % k.v) fail("unsupported: fractional JPEG sampling ratio");
    const int pw = k.bw * 8, dw = k.dw, dh = k.dh, W = c.W;
    const uint8_t* in = k.plane.data();
    std::vector<uint8_t> out(size_t(c.H) * W);
    const bool fancy_h2 = rh == 2 && dw > 2;
    const bool fancy = (rv == 1 && fancy_h2) || (rh == 1 && rv == 2) || (rv == 2 && fancy_h2);
    std::vector<int> sum(dw + 2);  // a row (or a pair's column sums), edges replicated
    for (int y = 0; y < c.H; ++y) {
      uint8_t* o = out.data() + size_t(y) * W;
      if (rh == 1 && rv == 1) {
        std::memcpy(o, in + size_t(y) * pw, W);
        continue;
      }
      if (!fancy) {  // replication (h2v1/h2v2 at widths <= 2, and other integral ratios)
        const uint8_t* row = in + size_t(y / rv) * pw;
        for (int x = 0; x < W; ++x) o[x] = row[x / rh];
        continue;
      }
      const int i = rv == 2 ? y >> 1 : y;
      const uint8_t* near = in + size_t(i) * pw;
      if (rv == 2) {  // column sums 3 * near + far, far the row above (even y) or below
        const int fr = (y & 1) ? std::min(i + 1, dh - 1) : std::max(i - 1, 0);
        const uint8_t* far = in + size_t(fr) * pw;
        if (rh == 1) {  // h1v2: (sum + 1 or 2) >> 2
          const int bias = (y & 1) ? 2 : 1;
          for (int x = 0; x < W; ++x) o[x] = static_cast<uint8_t>((near[x] * 3 + far[x] + bias) >> 2);
          continue;
        }
        for (int j = 0; j < dw; ++j) sum[j + 1] = near[j] * 3 + far[j];
      } else {
        for (int j = 0; j < dw; ++j) sum[j + 1] = near[j];
      }
      sum[0] = sum[1];
      sum[dw + 1] = sum[dw];
      const int shift = rv == 2 ? 4 : 2, even = rv == 2 ? 8 : 1, odd = rv == 2 ? 7 : 2;
      for (int x = 0; x < W; ++x) {  // h2v1, h2v2: 3 * nearer + further, biases 1, 2 / 8, 7
        const int j = (x >> 1) + 1;
        o[x] = static_cast<uint8_t>((sum[j] * 3 + sum[(x & 1) ? j + 1 : j - 1] + ((x & 1) ? odd : even)) >> shift);
      }
    }
    return out;
  }
};

// ---------------------------------------------------------------- encoder

const uint8_t kStdLuma[64] = {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
                              14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
                              18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
                              49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChroma[64] = {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                                24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
                                99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                                99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
    0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0,
    0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
    0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5,
    0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8,
    0xf9, 0xfa};
const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
    0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0,
    0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
    0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
    0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8,
    0xf9, 0xfa};

struct HuffCode {
  uint16_t code[256] = {};
  uint8_t size[256] = {};
  HuffCode(const uint8_t* bits, const uint8_t* vals) {
    int code_v = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l]; ++i, ++k, ++code_v) {
        code[vals[k]] = static_cast<uint16_t>(code_v);
        size[vals[k]] = static_cast<uint8_t>(l);
      }
      code_v <<= 1;
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t buf = 0;
  int cnt = 0;
  void put(uint32_t v, int n) {
    for (int i = n - 1; i >= 0; --i) {
      buf = (buf << 1) | ((v >> i) & 1);
      if (++cnt == 8) {
        out.push_back(static_cast<uint8_t>(buf));
        if (buf == 0xFF) out.push_back(0);
        buf = 0;
        cnt = 0;
      }
    }
  }
  void flush() {  // pad with one-bits (libjpeg's flush_bits)
    if (cnt) put(0x7F, 8 - cnt);
  }
};

inline int nbits(int v) {
  int a = v < 0 ? -v : v, n = 0;
  while (a) {
    ++n;
    a >>= 1;
  }
  return n;
}

void encode_block(BitWriter& bw, const int16_t* blk, int& pred, const HuffCode& dc, const HuffCode& ac) {
  const int diff = blk[0] - pred;
  pred = blk[0];
  int n = nbits(diff);
  bw.put(dc.code[n], dc.size[n]);
  if (n) bw.put(static_cast<uint32_t>(diff < 0 ? diff - 1 : diff) & ((1u << n) - 1), n);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    const int v = blk[kNatural[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    n = nbits(v);
    const int sym = (run << 4) | n;
    bw.put(ac.code[sym], ac.size[sym]);
    bw.put(static_cast<uint32_t>(v < 0 ? v - 1 : v) & ((1u << n) - 1), n);
    run = 0;
  }
  if (run > 0) bw.put(ac.code[0], ac.size[0]);
}

void quality_table(const uint8_t* basic, int quality, uint16_t* out) {
  quality = std::min(std::max(quality, 1), 100);
  const int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = (long(basic[i]) * scale + 50) / 100;
    t = std::min(std::max(t, 1L), 255L);  // force_baseline
    out[i] = static_cast<uint16_t>(t);
  }
}

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back(static_cast<uint8_t>(v >> 8));
  o.push_back(static_cast<uint8_t>(v & 255));
}

void put_dht(std::vector<uint8_t>& o, int index, const uint8_t* bits, const uint8_t* vals) {
  int total = 0;
  for (int i = 1; i <= 16; ++i) total += bits[i];
  o.push_back(0xFF);
  o.push_back(0xC4);
  put16(o, 2 + 1 + 16 + total);
  o.push_back(static_cast<uint8_t>(index));
  for (int i = 1; i <= 16; ++i) o.push_back(bits[i]);
  for (int i = 0; i < total; ++i) o.push_back(vals[i]);
}

// Baseline 4:2:0 YCbCr of an RGB image (grey: one component), as libjpeg
// writes it with its defaults at `quality`.
void encode(Codec& c, const uint8_t* rgb, int H, int W, int channels, int quality) {
  if (H <= 0 || W <= 0 || H > 65535 || W > 65535) fail("JPEG dimensions out of range");
  const int nc = channels == 1 ? 1 : 3;
  c.H = H;
  c.W = W;
  c.hmax = c.vmax = nc == 3 ? 2 : 1;
  c.mcux = (W + 8 * c.hmax - 1) / (8 * c.hmax);
  c.mcuy = (H + 8 * c.vmax - 1) / (8 * c.vmax);
  quality_table(kStdLuma, quality, c.q[0]);
  quality_table(kStdChroma, quality, c.q[1]);
  c.comps.resize(nc);
  const size_t npix = size_t(H) * W;
  std::vector<std::vector<uint8_t>> full(nc, std::vector<uint8_t>(npix));
  if (nc == 1) {
    std::memcpy(full[0].data(), rgb, npix);
  } else {
    const RgbYccTables& t = rgbycc();
    for (size_t p = 0; p < npix; ++p) {
      const int r = rgb[3 * p], g = rgb[3 * p + 1], b = rgb[3 * p + 2];
      full[0][p] = static_cast<uint8_t>((t.t[0][r] + t.t[1][g] + t.t[2][b]) >> kScaleBits);
      full[1][p] = static_cast<uint8_t>((t.t[3][r] + t.t[4][g] + t.t[5][b]) >> kScaleBits);
      full[2][p] = static_cast<uint8_t>((t.t[5][r] + t.t[6][g] + t.t[7][b]) >> kScaleBits);
    }
  }
  for (int ci = 0; ci < nc; ++ci) {
    Component& k = c.comps[ci];
    k.id = ci + 1;
    k.h = k.v = (ci == 0 && nc == 3) ? 2 : 1;
    k.tq = ci == 0 ? 0 : 1;
    k.dw = (W * k.h + c.hmax - 1) / c.hmax;
    k.dh = (H * k.v + c.vmax - 1) / c.vmax;
    k.bw_real = (k.dw + 7) / 8;
    k.bh_real = (k.dh + 7) / 8;
    k.bw = c.mcux * k.h;
    k.bh = c.mcuy * k.v;
    // jcprepct.c / jcsample.c: rows padded to a multiple of vmax and columns
    // to the downsampler's width by replication, downsampled, then the
    // downsampled rows padded to whole iMCU rows by replication.
    const int pw = k.pw = k.bw_real * 8, rows = c.mcuy * k.v * 8;
    const int rh = c.hmax / k.h, rv = c.vmax / k.v;
    const int in_rows = (H + c.vmax - 1) / c.vmax * c.vmax / rv;  // downsampled rows from image rows
    k.plane.assign(size_t(pw) * rows, 0);
    auto src = [&](int y, int x) -> int {
      return full[ci][size_t(std::min(y, H - 1)) * W + std::min(x, W - 1)];
    };
    for (int y = 0; y < in_rows; ++y) {
      uint8_t* o = k.plane.data() + size_t(y) * pw;
      if (rh == 1 && rv == 1) {
        for (int x = 0; x < pw; ++x) o[x] = static_cast<uint8_t>(src(y, x));
      } else {  // h2v2: bias 1, 2, 1, 2, ...
        for (int x = 0; x < pw; ++x) {
          const int s = src(2 * y, 2 * x) + src(2 * y, 2 * x + 1) + src(2 * y + 1, 2 * x) + src(2 * y + 1, 2 * x + 1);
          o[x] = static_cast<uint8_t>((s + 1 + (x & 1)) >> 2);
        }
      }
    }
    for (int y = in_rows; y < rows; ++y)
      std::memcpy(k.plane.data() + size_t(y) * pw, k.plane.data() + size_t(in_rows - 1) * pw, pw);
    k.coef.assign(size_t(k.bw) * k.bh * 64, 0);
  }
  // jccoefct.c compress_data: real blocks through the FDCT, dummy blocks
  // (past the component's blocks in an MCU) zero with the previous DC.
  Divisor div[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) div[t][i] = reciprocal(uint32_t(c.q[t][i]) << 3);
  for (int my = 0; my < c.mcuy; ++my)
    for (int mx = 0; mx < c.mcux; ++mx)
      for (Component& k : c.comps) {
        const int pw = k.pw;
        for (int y = 0; y < k.v; ++y)
          for (int x = 0; x < k.h; ++x) {
            const int by = my * k.v + y, bx = mx * k.h + x;
            int16_t* blk = k.coef.data() + (size_t(by) * k.bw + bx) * 64;
            if (by >= k.bh_real) {
              const int16_t* prev = x == 0 ? k.coef.data() + (size_t(by - 1) * k.bw + mx * k.h + k.h - 1) * 64 : blk - 64;
              blk[0] = prev[0];
            } else if (bx >= k.bw_real) {
              blk[0] = (blk - 64)[0];
            } else {
              int32_t ws[64];
              for (int r = 0; r < 8; ++r)
                for (int cc = 0; cc < 8; ++cc)
                  ws[r * 8 + cc] = int32_t(k.plane[size_t(by * 8 + r) * pw + bx * 8 + cc]) - 128;
              fdct_islow(ws);
              for (int i = 0; i < 64; ++i) blk[i] = quantize(ws[i], div[k.tq][i]);
            }
          }
      }
  // the file: SOI, JFIF 1.01, DQT, SOF0, DHT, SOS, the scan, EOI
  std::vector<uint8_t>& o = c.pixels;
  o = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  for (int t = 0; t < (nc == 3 ? 2 : 1); ++t) {
    o.push_back(0xFF);
    o.push_back(0xDB);
    put16(o, 67);
    o.push_back(static_cast<uint8_t>(t));
    for (int i = 0; i < 64; ++i) o.push_back(static_cast<uint8_t>(c.q[t][kNatural[i]]));
  }
  o.push_back(0xFF);
  o.push_back(0xC0);
  put16(o, 8 + 3 * nc);
  o.push_back(8);
  put16(o, H);
  put16(o, W);
  o.push_back(static_cast<uint8_t>(nc));
  for (const Component& k : c.comps) {
    o.push_back(static_cast<uint8_t>(k.id));
    o.push_back(static_cast<uint8_t>((k.h << 4) | k.v));
    o.push_back(static_cast<uint8_t>(k.tq));
  }
  put_dht(o, 0x00, kDcLumaBits, kDcVals);
  put_dht(o, 0x10, kAcLumaBits, kAcLumaVals);
  if (nc == 3) {
    put_dht(o, 0x01, kDcChromaBits, kDcVals);
    put_dht(o, 0x11, kAcChromaBits, kAcChromaVals);
  }
  o.push_back(0xFF);
  o.push_back(0xDA);
  put16(o, 6 + 2 * nc);
  o.push_back(static_cast<uint8_t>(nc));
  for (const Component& k : c.comps) {
    o.push_back(static_cast<uint8_t>(k.id));
    o.push_back(static_cast<uint8_t>(k.tq == 0 ? 0x00 : 0x11));
  }
  o.push_back(0);
  o.push_back(63);
  o.push_back(0);
  static const HuffCode dcl(kDcLumaBits, kDcVals), acl(kAcLumaBits, kAcLumaVals);
  static const HuffCode dcc(kDcChromaBits, kDcVals), acc(kAcChromaBits, kAcChromaVals);
  BitWriter bw{o};
  for (Component& k : c.comps) k.pred = 0;
  for (int my = 0; my < c.mcuy; ++my)
    for (int mx = 0; mx < c.mcux; ++mx)
      for (Component& k : c.comps)
        for (int y = 0; y < k.v; ++y)
          for (int x = 0; x < k.h; ++x) {
            const int16_t* blk = k.coef.data() + (size_t(my * k.v + y) * k.bw + mx * k.h + x) * 64;
            if (k.tq == 0) encode_block(bw, blk, k.pred, dcl, acl);
            else encode_block(bw, blk, k.pred, dcc, acc);
          }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
}

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  return static_cast<uint8_t>(pb <= pc ? b : c);
}

}  // namespace

extern "C" {

void* codec_jpeg_decode(const uint8_t* data, long n, long long max_pixels) {
  Codec* c = new Codec;
  try {
    Decoder(*c, data, static_cast<size_t>(n), max_pixels).run();
  } catch (const Error& e) {
    c->error = e.msg;
  } catch (const std::exception& e) {
    c->error = e.what();
  }
  return c;
}

void* codec_jpeg_encode(const uint8_t* rgb, int h, int w, int channels, int quality) {
  Codec* c = new Codec;
  try {
    encode(*c, rgb, h, w, channels, quality);
  } catch (const Error& e) {
    c->error = e.msg;
  } catch (const std::exception& e) {
    c->error = e.what();
  }
  return c;
}

const char* codec_error(void* h) { return static_cast<Codec*>(h)->error.c_str(); }

// info: H, W, components, hmax, vmax, progressive, transform, restart interval
void codec_info(void* h, int* info) {
  const Codec& c = *static_cast<Codec*>(h);
  const int v[8] = {c.H, c.W, static_cast<int>(c.comps.size()), c.hmax, c.vmax, c.progressive,
                    c.transform, c.restart};
  std::memcpy(info, v, sizeof v);
}

// info: id, h, v, tq, bw, bh, bw_real, bh_real, dw, dh, plane width, plane rows
void codec_component(void* h, int ci, int* info) {
  const Codec& c = *static_cast<Codec*>(h);
  const Component& k = c.comps[ci];
  const int rows = k.pw ? static_cast<int>(k.plane.size() / k.pw) : 0;
  const int v[12] = {k.id, k.h, k.v, k.tq, k.bw, k.bh, k.bw_real, k.bh_real, k.dw, k.dh, k.pw, rows};
  std::memcpy(info, v, sizeof v);
}

void codec_copy_coefs(void* h, int ci, int16_t* out) {
  const Component& k = static_cast<Codec*>(h)->comps[ci];
  std::memcpy(out, k.coef.data(), k.coef.size() * sizeof(int16_t));
}

void codec_copy_qtable(void* h, int ci, uint16_t* out) {
  const Codec& c = *static_cast<Codec*>(h);
  std::memcpy(out, c.q[c.comps[ci].tq], 64 * sizeof(uint16_t));
}

void codec_copy_plane(void* h, int ci, uint8_t* out) {
  const Component& k = static_cast<Codec*>(h)->comps[ci];
  std::memcpy(out, k.plane.data(), k.plane.size());
}

long codec_output_size(void* h) { return static_cast<long>(static_cast<Codec*>(h)->pixels.size()); }

void codec_copy_output(void* h, uint8_t* out) {
  const Codec& c = *static_cast<Codec*>(h);
  std::memcpy(out, c.pixels.data(), c.pixels.size());
}

void codec_free(void* h) { delete static_cast<Codec*>(h); }

// PNG rows (each a filter byte then `stride` bytes) unfiltered into out
// (rows x stride); returns -1, or the first row whose filter type is invalid.
int png_unfilter(const uint8_t* raw, int rows, int stride, int bpp, uint8_t* out) {
  for (int y = 0; y < rows; ++y) {
    const uint8_t* in = raw + size_t(y) * (stride + 1);
    uint8_t* o = out + size_t(y) * stride;
    const uint8_t* up = y ? o - stride : nullptr;
    const int ft = in[0];
    ++in;
    switch (ft) {
      case 0:
        std::memcpy(o, in, stride);
        break;
      case 1:
        for (int i = 0; i < stride; ++i) o[i] = static_cast<uint8_t>(in[i] + (i >= bpp ? o[i - bpp] : 0));
        break;
      case 2:
        for (int i = 0; i < stride; ++i) o[i] = static_cast<uint8_t>(in[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int i = 0; i < stride; ++i) {
          const int a = i >= bpp ? o[i - bpp] : 0, b = up ? up[i] : 0;
          o[i] = static_cast<uint8_t>(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int i = 0; i < stride; ++i) {
          const int a = i >= bpp ? o[i - bpp] : 0, b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          o[i] = static_cast<uint8_t>(in[i] + paeth(a, b, c));
        }
        break;
      default:
        return y;
    }
  }
  return -1;
}

}  // extern "C"
