// Rotated BEV intersection and IoU for the KITTI AP40 evaluator
// (yolov10_3d_torch/eval/kitti_eval.py), host code called through ctypes.
//
// The port's copy of yolov10_3d_tpu/native/kitti_iou.cc: a Sutherland-Hodgman
// clip of one rotated rectangle by another, in double, per (i, j) pair; the
// results are float32. yolov10_3d_torch/native/__init__.py builds it with
//   g++ -O3 -shared -fPIC -o kitti_iou-<hash>.so kitti_iou.cc
// into yolov10_3d_torch/_build/ at first use.

#include <cmath>
#include <cstring>

namespace {

struct Pt {
  double x, y;
};

// 4 corners of a rotated rect (cx, cy, l, w, angle); matches
// eval/kitti_eval.py rect_corners (x right, z forward, ry clockwise in x-z)
void rect_corners(const float* b, Pt* out) {
  double cx = b[0], cy = b[1], l = b[2], w = b[3], ry = b[4];
  double c = std::cos(ry), s = std::sin(ry);
  const double dx[4] = {l / 2, l / 2, -l / 2, -l / 2};
  const double dy[4] = {w / 2, -w / 2, -w / 2, w / 2};
  for (int i = 0; i < 4; ++i) {
    out[i].x = cx + dx[i] * c + dy[i] * s;
    out[i].y = cy - dx[i] * s + dy[i] * c;
  }
}

double polygon_area(const Pt* pts, int n) {
  double a = 0;
  for (int i = 0; i < n; ++i) {
    const Pt& p = pts[i];
    const Pt& q = pts[(i + 1) % n];
    a += p.x * q.y - q.x * p.y;
  }
  return std::fabs(a) / 2;
}

// clip convex polygon (pts, n) against the half-plane left of edge a->b
int clip_edge(const Pt* pts, int n, Pt a, Pt b, Pt* out) {
  int m = 0;
  double ex = b.x - a.x, ey = b.y - a.y;
  for (int i = 0; i < n; ++i) {
    const Pt& p = pts[i];
    const Pt& q = pts[(i + 1) % n];
    double dp = ex * (p.y - a.y) - ey * (p.x - a.x);
    double dq = ex * (q.y - a.y) - ey * (q.x - a.x);
    if (dp >= 0) out[m++] = p;
    if ((dp > 0 && dq < 0) || (dp < 0 && dq > 0)) {
      double t = dp / (dp - dq);
      out[m++] = {p.x + t * (q.x - p.x), p.y + t * (q.y - p.y)};
    }
  }
  return m;
}

double rect_intersection(const float* b1, const float* b2) {
  Pt q1[4], q2[4];
  rect_corners(b1, q1);
  rect_corners(b2, q2);
  // orient q2 counter-clockwise for the half-plane test
  double cross = (q2[1].x - q2[0].x) * (q2[2].y - q2[1].y) -
                 (q2[1].y - q2[0].y) * (q2[2].x - q2[1].x);
  if (cross < 0) {
    Pt tmp = q2[1];
    q2[1] = q2[3];
    q2[3] = tmp;
  }
  Pt buf_a[16], buf_b[16];
  std::memcpy(buf_a, q1, sizeof(q1));
  int n = 4;
  Pt* cur = buf_a;
  Pt* nxt = buf_b;
  for (int e = 0; e < 4 && n > 2; ++e) {
    n = clip_edge(cur, n, q2[e], q2[(e + 1) % 4], nxt);
    Pt* t = cur;
    cur = nxt;
    nxt = t;
  }
  if (n < 3) return 0.0;
  return polygon_area(cur, n);
}

}  // namespace

extern "C" {

// boxes1: (n, 5), boxes2: (m, 5) float32; out: (n, m) intersection areas
void rotated_intersection_areas(const float* boxes1, int n, const float* boxes2,
                                int m, float* out) {
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < m; ++j) {
      out[i * m + j] =
          static_cast<float>(rect_intersection(boxes1 + i * 5, boxes2 + j * 5));
    }
  }
}

// criterion: -1 union, 0 area1, 1 area2 (devkit semantics)
void rotated_iou(const float* boxes1, int n, const float* boxes2, int m,
                 int criterion, float* out) {
  for (int i = 0; i < n; ++i) {
    double a1 = boxes1[i * 5 + 2] * boxes1[i * 5 + 3];
    for (int j = 0; j < m; ++j) {
      double a2 = boxes2[j * 5 + 2] * boxes2[j * 5 + 3];
      double inter = rect_intersection(boxes1 + i * 5, boxes2 + j * 5);
      double denom = criterion == -1 ? (a1 + a2 - inter)
                     : criterion == 0 ? a1
                                      : a2;
      out[i * m + j] = denom > 1e-12 ? static_cast<float>(inter / denom) : 0.f;
    }
  }
}

// 3D IoU: boxes (n, 7) = x, y, z, l, h, w, ry (camera frame, y = box bottom)
void iou_3d(const float* g, int n, const float* d, int m, int criterion,
            float* out) {
  for (int i = 0; i < n; ++i) {
    const float* gi = g + i * 7;
    float bev1[5] = {gi[0], gi[2], gi[3], gi[5], gi[6]};
    double v1 = (double)gi[3] * gi[4] * gi[5];
    double y1_hi = gi[1], y1_lo = gi[1] - gi[4];
    for (int j = 0; j < m; ++j) {
      const float* dj = d + j * 7;
      float bev2[5] = {dj[0], dj[2], dj[3], dj[5], dj[6]};
      double v2 = (double)dj[3] * dj[4] * dj[5];
      double y2_hi = dj[1], y2_lo = dj[1] - dj[4];
      double ih = std::fmin(y1_hi, y2_hi) - std::fmax(y1_lo, y2_lo);
      if (ih <= 0) {
        out[i * m + j] = 0.f;
        continue;
      }
      double inter = rect_intersection(bev1, bev2) * ih;
      double denom = criterion == -1 ? (v1 + v2 - inter)
                     : criterion == 0 ? v1
                                      : v2;
      out[i * m + j] = denom > 1e-12 ? static_cast<float>(inter / denom) : 0.f;
    }
  }
}

}  // extern "C"
