"""2D geometry of the solution apps in numpy (port of
``yolov10_3d_tpu/solutions/geometry.py``: containment, segment distance,
polygon centroid and segment intersection, as shapely computes them)."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def point_in_polygon(p: Sequence[float], poly) -> bool:
    """Ray-casting containment test (shapely Polygon.contains equivalent)."""
    x, y = float(p[0]), float(p[1])
    inside = False
    n = len(poly)
    for i in range(n):
        x1, y1 = poly[i]
        x2, y2 = poly[(i + 1) % n]
        if (y1 > y) != (y2 > y):
            xin = (x2 - x1) * (y - y1) / (y2 - y1 + 1e-12) + x1
            if x < xin:
                inside = not inside
    return inside


def point_segment_distance(p, a, b) -> float:
    """Distance from point p to segment ab (shapely Point.distance(LineString))."""
    p, a, b = (np.asarray(v, np.float64) for v in (p, a, b))
    ab = b - a
    t = float(np.clip(np.dot(p - a, ab) / max(np.dot(ab, ab), 1e-12), 0.0, 1.0))
    return float(np.linalg.norm(p - (a + t * ab)))


def polyline_distance(p, pts) -> float:
    """Distance from p to the nearest segment of a polyline."""
    return min(
        point_segment_distance(p, pts[i], pts[i + 1]) for i in range(len(pts) - 1)
    )


def polygon_centroid(poly) -> Tuple[float, float]:
    """Area-weighted centroid (shapely Polygon.centroid); falls back to the
    vertex mean for degenerate (zero-area) rings."""
    pts = np.asarray(poly, np.float64)
    x, y = pts[:, 0], pts[:, 1]
    xn, yn = np.roll(x, -1), np.roll(y, -1)
    cross = x * yn - xn * y
    area = cross.sum() / 2.0
    if abs(area) < 1e-9:
        return float(x.mean()), float(y.mean())
    cx = ((x + xn) * cross).sum() / (6.0 * area)
    cy = ((y + yn) * cross).sum() / (6.0 * area)
    return float(cx), float(cy)


def segments_intersect(p1, p2, q1, q2) -> bool:
    """Proper/improper segment intersection test (used by line counters)."""

    def orient(a, b, c):
        v = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
        return 0 if abs(v) < 1e-12 else (1 if v > 0 else -1)

    def on_seg(a, b, c):
        return (
            min(a[0], b[0]) - 1e-12 <= c[0] <= max(a[0], b[0]) + 1e-12
            and min(a[1], b[1]) - 1e-12 <= c[1] <= max(a[1], b[1]) + 1e-12
        )

    o1, o2 = orient(p1, p2, q1), orient(p1, p2, q2)
    o3, o4 = orient(q1, q2, p1), orient(q1, q2, p2)
    if o1 != o2 and o3 != o4:
        return True
    return (
        (o1 == 0 and on_seg(p1, p2, q1))
        or (o2 == 0 and on_seg(p1, p2, q2))
        or (o3 == 0 and on_seg(q1, q2, p1))
        or (o4 == 0 and on_seg(q1, q2, p2))
    )
