// Pyramidal Lucas-Kanade optical flow of BoT-SORT's camera-motion estimate
// (yolov10_3d_torch/trackers/gmc.py), called through ctypes from
// yolov10_3d_torch/native/optical_flow.py.
//
// It computes what gmc.py's numpy rule ``optical_flow`` states, bit for bit:
// the image pyramid by the 5-tap pyrDown ((sum + 128) >> 8, reflect-101
// border), the unscaled Scharr derivatives of the previous frame's level,
// windows read with 14-bit bilinear weights and CV_DESCALE (the image padded
// by reflection, the derivatives by zeros), integer window sums converted to
// float32 and scaled by 2^-20, and every later step in float32 in the rule's
// order (no contraction: built with -ffp-contract=off). The rule is
// cv2.calcOpticalFlowPyrLK's arithmetic; points are independent, so one
// point at a time here equals the rule's lockstep over all points.
// optical_flow.py builds it with
//   g++ -O3 -shared -fPIC -ffp-contract=off -o optical_flow-<hash>.so optical_flow.cc
// into yolov10_3d_torch/_build/ at first use.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr int kWBits = 14;

struct Plane {
  int h = 0, w = 0;
  std::vector<int32_t> v;
  int32_t at(int y, int x) const { return v[size_t(y) * w + x]; }
};

// numpy's "reflect" padding (BORDER_REFLECT_101) of index i in [0, n)
inline int reflect(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i < n ? i : period - i;
}

Plane pyr_down(const Plane& s) {
  static const int k[5] = {1, 4, 6, 4, 1};
  Plane d;
  d.h = (s.h + 1) / 2;
  d.w = (s.w + 1) / 2;
  std::vector<int64_t> rows(size_t(s.h) * d.w);
  for (int y = 0; y < s.h; ++y)
    for (int x = 0; x < d.w; ++x) {
      int64_t acc = 0;
      for (int j = 0; j < 5; ++j) acc += k[j] * int64_t(s.at(y, reflect(2 * x + j - 2, s.w)));
      rows[size_t(y) * d.w + x] = acc;
    }
  d.v.resize(size_t(d.h) * d.w);
  for (int y = 0; y < d.h; ++y)
    for (int x = 0; x < d.w; ++x) {
      int64_t acc = 0;
      for (int i = 0; i < 5; ++i) acc += k[i] * rows[size_t(reflect(2 * y + i - 2, s.h)) * d.w + x];
      d.v[size_t(y) * d.w + x] = int32_t((acc + 128) >> 8);
    }
  return d;
}

void scharr(const Plane& s, Plane& dx, Plane& dy) {
  const int h = s.h, w = s.w;
  dx.h = dy.h = h;
  dx.w = dy.w = w;
  dx.v.assign(size_t(h) * w, 0);
  dy.v.assign(size_t(h) * w, 0);
  std::vector<int32_t> t0(size_t(h) * w), t1(size_t(h) * w);
  for (int y = 0; y < h; ++y) {
    const int up = y > 0 ? y - 1 : (h > 1 ? 1 : 0);
    const int dn = y < h - 1 ? y + 1 : (h > 1 ? h - 2 : 0);
    for (int x = 0; x < w; ++x) {
      t0[size_t(y) * w + x] = (s.at(up, x) + s.at(dn, x)) * 3 + s.at(y, x) * 10;
      t1[size_t(y) * w + x] = s.at(dn, x) - s.at(up, x);
    }
  }
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      const int l = x > 0 ? x - 1 : (w > 1 ? 1 : 0);
      const int r = x < w - 1 ? x + 1 : (w > 1 ? w - 2 : 0);
      const size_t row = size_t(y) * w;
      dx.v[row + x] = t0[row + r] - t0[row + l];
      dy.v[row + x] = (t1[row + r] + t1[row + l]) * 3 + t1[row + x] * 10;
    }
}

struct Weights {
  int ix, iy;
  int32_t w00, w01, w10, w11;
};

Weights weights(float px, float py) {
  Weights wt;
  wt.ix = int(std::floor(px));
  wt.iy = int(std::floor(py));
  const float a = px - float(wt.ix), b = py - float(wt.iy);
  const float one = 1.0f, s = float(1 << kWBits);
  wt.w00 = int32_t(std::nearbyint((one - a) * (one - b) * s));
  wt.w01 = int32_t(std::nearbyint(a * (one - b) * s));
  wt.w10 = int32_t(std::nearbyint((one - a) * b * s));
  wt.w11 = (1 << kWBits) - wt.w00 - wt.w01 - wt.w10;
  return wt;
}

// a plane padded by ``pad`` on every side: reflected (an image) or zeros (a derivative)
struct Padded {
  int pad, w;
  std::vector<int32_t> v;
  Padded(const Plane& p, int pad_, bool zeros) : pad(pad_), w(p.w + 2 * pad_) {
    const int h = p.h + 2 * pad;
    v.assign(size_t(h) * w, 0);
    std::vector<int> cols(w);  // the source column of each padded column
    for (int x = 0; x < w; ++x) cols[x] = reflect(x - pad, p.w);
    for (int y = 0; y < h; ++y) {
      const int sy = y - pad;
      if (zeros && (sy < 0 || sy >= p.h)) continue;
      const int32_t* src = p.v.data() + size_t(zeros ? sy : reflect(sy, p.h)) * p.w;
      int32_t* dst = v.data() + size_t(y) * w;
      for (int x = 0; x < p.w; ++x) dst[pad + x] = src[x];
      if (!zeros)
        for (int x = 0; x < pad; ++x) {
          dst[x] = src[cols[x]];
          dst[pad + p.w + x] = src[cols[pad + p.w + x]];
        }
    }
  }
};

// the (win x win) window at wt, CV_DESCALE'd by ``bits``
void window(const Padded& p, const Weights& wt, int win, int bits, int32_t* out) {
  const int32_t half = int32_t(1) << (bits - 1);
  const int32_t* row = p.v.data() + size_t(wt.iy + p.pad) * p.w + (wt.ix + p.pad);
  for (int r = 0; r < win; ++r, row += p.w) {
    const int32_t* nxt = row + p.w;
    for (int c = 0; c < win; ++c) {
      const int32_t s = row[c] * wt.w00 + row[c + 1] * wt.w01 + nxt[c] * wt.w10 +
                        nxt[c + 1] * wt.w11;
      out[r * win + c] = (s + half) >> bits;
    }
  }
}

}  // namespace

extern "C" {

// prev, next: (h, w) uint8; pts (n, 2) float32 x, y. Writes out (n, 2) float32
// and status (n) uint8 as gmc.optical_flow returns them.
void lk_flow(const uint8_t* prev, const uint8_t* next, int h, int w, const float* pts, int n,
             int win, int levels, int iters, double eps, double min_eig, float* out,
             uint8_t* status) {
  std::vector<Plane> pi(1), pj(1);
  pi[0].h = pj[0].h = h;
  pi[0].w = pj[0].w = w;
  pi[0].v.assign(prev, prev + size_t(h) * w);
  pj[0].v.assign(next, next + size_t(h) * w);
  int lh = h, lw = w;
  for (int l = 0; l < levels; ++l) {  // cv2's buildOpticalFlowPyramid's stopping rule
    lh = (lh + 1) / 2;
    lw = (lw + 1) / 2;
    if (lw <= win || lh <= win) break;
    pi.push_back(pyr_down(pi.back()));
    pj.push_back(pyr_down(pj.back()));
  }
  const int top = int(pi.size()) - 1;
  const float half = float((win - 1) * 0.5);
  const float scale = 1.0f / float(1 << 20);
  const float two = 2.0f, four = 4.0f, f_min_eig = float(min_eig);
  const float f_eps = 1.1920928955078125e-07f, osc_tol = 0.01f;
  const double e2 = eps * eps;
  const int area = win * win;
  std::vector<int32_t> Iw(area), gx(area), gy(area), Jw(area);
  for (int k = 0; k < n; ++k) status[k] = 1;
  for (int level = top; level >= 0; --level) {
    const Plane& I = pi[level];
    const Plane& J = pj[level];
    Plane dx, dy;
    scharr(I, dx, dy);
    const Padded Ip(I, win + 1, false), Jp(J, win + 1, false), dxp(dx, win + 1, true),
        dyp(dy, win + 1, true);
    const float lscale = 1.0f / float(1 << level);
    for (int k = 0; k < n; ++k) {
      const float px = pts[2 * k] * lscale, py = pts[2 * k + 1] * lscale;
      if (level == top) {
        out[2 * k] = px;
        out[2 * k + 1] = py;
      } else {
        out[2 * k] *= two;
        out[2 * k + 1] *= two;
      }
      const Weights wi = weights(px - half, py - half);
      if (wi.ix < -win || wi.ix >= I.w || wi.iy < -win || wi.iy >= I.h) {
        if (level == 0) status[k] = 0;
        continue;
      }
      window(Ip, wi, win, kWBits - 5, Iw.data());
      window(dxp, wi, win, kWBits, gx.data());
      window(dyp, wi, win, kWBits, gy.data());
      int64_t s11 = 0, s12 = 0, s22 = 0;
      for (int i = 0; i < area; ++i) {
        s11 += int64_t(gx[i]) * gx[i];
        s12 += int64_t(gx[i]) * gy[i];
        s22 += int64_t(gy[i]) * gy[i];
      }
      const float A11 = float(s11) * scale, A12 = float(s12) * scale, A22 = float(s22) * scale;
      const float D = A11 * A22 - A12 * A12;
      const float eig = (A22 + A11 - std::sqrt((A11 - A22) * (A11 - A22) + four * A12 * A12)) /
                        float(2 * win * win);
      if (eig < f_min_eig || D < f_eps) {
        if (level == 0) status[k] = 0;
        continue;
      }
      const float Dinv = 1.0f / D;
      float nx = out[2 * k] - half, ny = out[2 * k + 1] - half;
      float pdx = 0.0f, pdy = 0.0f;
      for (int j = 0; j < iters; ++j) {
        const Weights wj = weights(nx, ny);
        if (wj.ix < -win || wj.ix >= J.w || wj.iy < -win || wj.iy >= J.h) {
          if (level == 0) status[k] = 0;
          break;
        }
        window(Jp, wj, win, kWBits - 5, Jw.data());
        int64_t b1s = 0, b2s = 0;
        for (int i = 0; i < area; ++i) {
          const int64_t diff = int64_t(Jw[i]) - Iw[i];
          b1s += diff * gx[i];
          b2s += diff * gy[i];
        }
        const float b1 = float(b1s) * scale, b2 = float(b2s) * scale;
        const float ddx = (A12 * b2 - A22 * b1) * Dinv;
        const float ddy = (A12 * b1 - A11 * b2) * Dinv;
        nx += ddx;
        ny += ddy;
        float rx = nx + half, ry = ny + half;
        const bool small = double(ddx) * double(ddx) + double(ddy) * double(ddy) <= e2;
        const bool osc = j > 0 && !small && std::fabs(ddx + pdx) < osc_tol &&
                         std::fabs(ddy + pdy) < osc_tol;
        if (osc) {
          rx -= ddx * 0.5f;
          ry -= ddy * 0.5f;
        }
        out[2 * k] = rx;
        out[2 * k + 1] = ry;
        if (small || osc) break;
        pdx = ddx;
        pdy = ddy;
      }
    }
  }
}

}  // extern "C"
