// The host augmentation's image operations (yolov10_3d_torch/data/augment.py),
// called through ctypes from yolov10_3d_torch/native/host_aug.py.
//
// Each entry is, bit for bit, its numpy version in
// yolov10_3d_torch/data/cv2_rules.py (the warps and the HSV pass) or
// yolov10_3d_torch/data/preprocess.py (the resize), which state the rules by
// which cv2 5.0 computes these operations. Images are HWC uint8 with 3
// channels, C-contiguous. The float arithmetic is written out operation by
// operation and built with -ffp-contract=off, so the compiler fuses nothing
// that the rules do not fuse; std::fma is the rules' fused multiply-add.
// host_aug.py builds it with
//   g++ -O3 -shared -fPIC -ffp-contract=off [-mfma] -o host_aug-<hash>.so host_aug.cc
// into yolov10_3d_torch/_build/ at first use.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr int kSimdCols = 16;  // cv2_rules.SIMD_COLS
constexpr int kHsvSimdCols = 32;  // cv2_rules.HSV_SIMD_COLS
constexpr int kCoefBits = 11;  // preprocess._COEF_BITS
constexpr int kHsvShift = 12;  // cv2_rules.HSV_SHIFT

// m0·x + m1·y + m2 in float32, in cv2's order (cv2_rules._mapped).
inline float mapped(float m0, float m1, float m2, float y1, int x, int tail) {
  const float xf = static_cast<float>(x);
  if (x < tail) return std::fma(m0, xf, y1 + m2);
  return std::fma(xf, m0, y1) + m2;
}

inline float clampf(float v, float lo, float hi) { return v < lo ? lo : (v > hi ? hi : v); }

// One output pixel: the bilinear blend of the four taps around (sx, sy),
// taps outside the source reading `fill` (cv2_rules._sample_linear).
inline void sample(const uint8_t* src, int H, int W, float sx, float sy, const float* fill,
                   uint8_t* out) {
  if (!(std::isfinite(sx) && std::isfinite(sy))) sx = sy = -4.0f;
  const float lim = 1073741824.0f;  // 2**30
  sx = clampf(sx, -lim, lim);
  sy = clampf(sy, -lim, lim);
  const float fx = std::floor(sx), fy = std::floor(sy);
  const float ax = sx - fx, ay = sy - fy;
  const long ix = static_cast<long>(fx), iy = static_cast<long>(fy);
  const uint8_t* taps[4];
  if (ix >= 0 && ix + 1 < W && iy >= 0 && iy + 1 < H) {
    taps[0] = src + (iy * W + ix) * 3;
    taps[1] = taps[0] + 3;
    taps[2] = taps[0] + static_cast<long>(W) * 3;
    taps[3] = taps[2] + 3;
    for (int c = 0; c < 3; ++c) {
      const float p0 = taps[0][c], p1 = taps[1][c], p2 = taps[2][c], p3 = taps[3][c];
      const float t0 = std::fma(ax, p1 - p0, p0);
      const float t1 = std::fma(ax, p3 - p2, p2);
      out[c] = static_cast<uint8_t>(clampf(std::nearbyint(std::fma(ay, t1 - t0, t0)), 0.0f,
                                           255.0f));
    }
    return;
  }
  const long ys[2] = {iy, iy + 1}, xs[2] = {ix, ix + 1};
  for (int j = 0; j < 2; ++j)
    for (int i = 0; i < 2; ++i) {
      const bool inside = ys[j] >= 0 && ys[j] < H && xs[i] >= 0 && xs[i] < W;
      taps[2 * j + i] = inside ? src + (ys[j] * W + xs[i]) * 3 : nullptr;
    }
  for (int c = 0; c < 3; ++c) {
    float p[4];
    for (int k = 0; k < 4; ++k) p[k] = taps[k] ? static_cast<float>(taps[k][c]) : fill[c];
    const float t0 = std::fma(ax, p[1] - p[0], p[0]);
    const float t1 = std::fma(ax, p[3] - p[2], p[2]);
    out[c] = static_cast<uint8_t>(clampf(std::nearbyint(std::fma(ay, t1 - t0, t0)), 0.0f,
                                         255.0f));
  }
}

// cv2_rules.invert_affine, as a 3x3 with the last row (0, 0, 1).
void invert_affine(const double* m, double* inv) {
  double d = m[0] * m[4] - m[1] * m[3];
  d = d != 0 ? 1.0 / d : 0.0;
  const double a11 = m[4] * d, a22 = m[0] * d;
  const double a12 = m[1] * -d, a21 = m[3] * -d;
  const double out[9] = {a11, a12, -a11 * m[2] - a12 * m[5],
                         a21, a22, -a21 * m[2] - a22 * m[5], 0.0, 0.0, 1.0};
  for (int i = 0; i < 9; ++i) inv[i] = out[i];
}

// cv2_rules.invert_3x3; returns false for a singular matrix.
bool invert_3x3(const double* m, double* inv) {
  const double det = m[0] * (m[4] * m[8] - m[5] * m[7]) - m[1] * (m[3] * m[8] - m[5] * m[6]) +
                     m[2] * (m[3] * m[7] - m[4] * m[6]);
  if (det == 0) return false;
  const double d = 1.0 / det;
  const double out[9] = {(m[4] * m[8] - m[5] * m[7]) * d, (m[2] * m[7] - m[1] * m[8]) * d,
                         (m[1] * m[5] - m[2] * m[4]) * d, (m[5] * m[6] - m[3] * m[8]) * d,
                         (m[0] * m[8] - m[2] * m[6]) * d, (m[2] * m[3] - m[0] * m[5]) * d,
                         (m[3] * m[7] - m[4] * m[6]) * d, (m[1] * m[6] - m[0] * m[7]) * d,
                         (m[0] * m[4] - m[1] * m[3]) * d};
  for (int i = 0; i < 9; ++i) inv[i] = out[i];
  return true;
}

struct Taps {
  std::vector<int> i0, i1, w0, w1;
};

// preprocess._linear_taps.
Taps linear_taps(int dst, int src, bool edge_weight_one) {
  Taps t;
  t.i0.resize(dst), t.i1.resize(dst), t.w0.resize(dst), t.w1.resize(dst);
  const double scale = 1.0 / (static_cast<double>(dst) / src);
  for (int i = 0; i < dst; ++i) {
    float f = static_cast<float>((i + 0.5) * scale - 0.5);
    long i0 = static_cast<long>(std::floor(f));
    f = f - static_cast<float>(i0);
    if (edge_weight_one) {
      if (i0 < 0) f = 0.0f, i0 = 0;
      if (i0 >= src - 1) f = 0.0f, i0 = src - 1;
    }
    const long i1 = i0 + 1;
    t.i0[i] = static_cast<int>(i0 < 0 ? 0 : (i0 > src - 1 ? src - 1 : i0));
    t.i1[i] = static_cast<int>(i1 < 0 ? 0 : (i1 > src - 1 ? src - 1 : i1));
    const float scale_w = static_cast<float>(1 << kCoefBits);
    t.w0[i] = static_cast<int>(std::nearbyint((1.0f - f) * scale_w));
    t.w1[i] = static_cast<int>(std::nearbyint(f * scale_w));
  }
  return t;
}

}  // namespace

extern "C" {

// cv2.warpAffine (perspective 0, M the forward 2x3 matrix, 6 doubles) or
// cv2.warpPerspective (perspective 1, M the forward 3x3 matrix, 9 doubles)
// of src (H, W, 3) into dst (h, w, 3); INTER_LINEAR, constant border.
// Returns 0, or -1 for a singular perspective matrix.
int warp_u8c3(const uint8_t* src, int H, int W, uint8_t* dst, int h, int w, const double* M,
              int perspective, const uint8_t* border) {
  double inv[9];
  if (perspective) {
    if (!invert_3x3(M, inv)) return -1;
  } else {
    invert_affine(M, inv);
  }
  float m[9];
  for (int i = 0; i < 9; ++i) m[i] = static_cast<float>(inv[i]);
  const float fill[3] = {static_cast<float>(border[0]), static_cast<float>(border[1]),
                         static_cast<float>(border[2])};
  const int tail = (w / kSimdCols) * kSimdCols;
  for (int y = 0; y < h; ++y) {
    const float yf = static_cast<float>(y);
    const float y1x = yf * m[1], y1y = yf * m[4], y1w = yf * m[7];
    uint8_t* row = dst + static_cast<long>(y) * w * 3;
    for (int x = 0; x < w; ++x) {
      float sx = mapped(m[0], m[1], m[2], y1x, x, tail);
      float sy = mapped(m[3], m[4], m[5], y1y, x, tail);
      if (perspective) {
        const float den = mapped(m[6], m[7], m[8], y1w, x, tail);
        sx = sx / den;
        sy = sy / den;
      }
      sample(src, H, W, sx, sy, fill, row + x * 3);
    }
  }
  return 0;
}

// cv2.resize INTER_LINEAR of src (H, W, 3) into dst (h, w, 3).
void resize_linear_u8c3(const uint8_t* src, int H, int W, uint8_t* dst, int h, int w) {
  const Taps tx = linear_taps(w, W, true), ty = linear_taps(h, H, false);
  std::vector<long> rows(static_cast<size_t>(H) * w * 3);
  std::vector<char> done(H, 0);
  auto hrow = [&](int sy) {  // the horizontal pass of source row sy, once
    if (done[sy]) return;
    done[sy] = 1;
    const uint8_t* s = src + static_cast<long>(sy) * W * 3;
    long* r = rows.data() + static_cast<long>(sy) * w * 3;
    for (int x = 0; x < w; ++x)
      for (int c = 0; c < 3; ++c)
        r[x * 3 + c] = static_cast<long>(s[tx.i0[x] * 3 + c]) * tx.w0[x] +
                       static_cast<long>(s[tx.i1[x] * 3 + c]) * tx.w1[x];
  };
  for (int y = 0; y < h; ++y) {
    hrow(ty.i0[y]);
    hrow(ty.i1[y]);
    const long* r0 = rows.data() + static_cast<long>(ty.i0[y]) * w * 3;
    const long* r1 = rows.data() + static_cast<long>(ty.i1[y]) * w * 3;
    const long b0 = ty.w0[y], b1 = ty.w1[y];
    uint8_t* d = dst + static_cast<long>(y) * w * 3;
    for (int k = 0; k < w * 3; ++k) {
      long v = (((b0 * (r0[k] >> 4)) >> 16) + ((b1 * (r1[k] >> 4)) >> 16) + 2) >> 2;
      d[k] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

// RGB -> HSV (cv2's 8-bit rule), the per-channel table lut (256, 3), and
// HSV -> RGB (cv2's 8-bit rule), in place over an (h, w, 3) image.
void hsv_lut_u8c3(uint8_t* img, int h, int w, const uint8_t* lut) {
  int sdiv[256], hdiv[256];
  sdiv[0] = hdiv[0] = 0;
  for (int i = 1; i < 256; ++i) {
    sdiv[i] = static_cast<int>(std::nearbyint((255 << kHsvShift) / static_cast<double>(i)));
    hdiv[i] = static_cast<int>(std::nearbyint((180 << kHsvShift) / (6.0 * i)));
  }
  static const int sectors[6][3] = {{1, 3, 0}, {1, 0, 2}, {3, 0, 1},
                                    {0, 2, 1}, {0, 1, 3}, {2, 1, 0}};  // b, g, r
  const float hscale = static_cast<float>(6.0 / 180), inv255 = static_cast<float>(1.0 / 255);
  const int half = 1 << (kHsvShift - 1);
  const int tail = (w / kHsvSimdCols) * kHsvSimdCols;
  const long n = static_cast<long>(h) * w;
  for (long p = 0; p < n; ++p) {
    uint8_t* px = img + p * 3;
    const bool round_half_even = p % w >= tail;
    const int r = px[0], g = px[1], b = px[2];
    const int v = std::max(std::max(b, g), r);
    const int diff = v - std::min(std::min(b, g), r);
    const int s = (diff * sdiv[v] + half) >> kHsvShift;
    int hh = v == r ? g - b : (v == g ? b - r + 2 * diff : r - g + 4 * diff);
    hh = (hh * hdiv[diff] + half) >> kHsvShift;
    if (hh < 0) hh += 180;
    const int H = lut[hh * 3], S = lut[s * 3 + 1], V = lut[v * 3 + 2];
    const float hf = static_cast<float>(H) * hscale;
    const float sf = static_cast<float>(S) * inv255, vf = static_cast<float>(V) * inv255;
    const float sector = std::floor(hf);
    const float f = hf - sector;
    const float tab[4] = {vf, vf * (1.0f - sf), vf * std::fma(-sf, f, 1.0f),
                          vf * std::fma(-sf, 1.0f - f, 1.0f)};
    const int* sel = sectors[static_cast<int>(sector) % 6];
    for (int c = 0; c < 3; ++c) {  // sel is (b, g, r); the image is RGB
      const float x = tab[sel[2 - c]] * 255.0f;
      px[c] = static_cast<uint8_t>(
          clampf(round_half_even ? std::nearbyint(x) : std::floor(x), 0.0f, 255.0f));
    }
  }
}

}  // extern "C"
