"""Drawing detections and the solution apps' overlays (port of
``yolov10_3d_tpu/utils/plotting.py``: ``COLORS``, ``color_for`` and the
``Annotator``).

The JAX Annotator draws with ``PIL.ImageDraw``; this one draws in numpy by
PIL's rasterisation rules (Pillow 12's ``Draw.c``), so that given the same
calls the image is PIL's pixel for pixel:

- ``rectangle``: an outline of ``width`` rows and columns (Pillow's
  ``ImagingDrawRectangle``: ``width`` horizontal spans at the top and the
  bottom, then ``width`` vertical runs between them, drawn from
  ``y0 + width`` towards ``y1 - width + 1`` without that end row), or a
  filled span of rows; everything clipped to the image;
- ``line`` of width 1: Bresenham's walk without its end point, then the end
  point (Pillow's ``draw_lines``); wider: each segment a quadrilateral
  around it (``ImagingDrawWideLine``: offsets rounded half up and half
  down), filled by the scanline rule of ``polygon_generic`` (float32
  crossings, spans from the crossing rounded half up to the next rounded
  half down, horizontal edges drawn whole); a polyline draws its segments
  one by one, with no joints;
- ``circle``: Pillow's ellipse (``ellipse_new``: the quarter-ellipse walk on
  doubled coordinates that picks, of the three next points, the one
  nearest the curve; spans between an outer and an inner ellipse ``width``
  apart, or filled);
- text in Pillow's bitmap default font (``utils/font.py``), the mask's set
  pixels painted in the text colour.

PIL draws text with FreeType when it has it (Aileron, ``load_default()``);
the port always draws with the bitmap font, which is what PIL draws with
when it has none.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from . import font

COLORS = np.array(
    [
        [255, 56, 56], [255, 157, 151], [255, 112, 31], [255, 178, 29],
        [207, 210, 49], [72, 249, 10], [146, 204, 23], [61, 219, 134],
        [26, 147, 52], [0, 212, 187], [44, 153, 168], [0, 194, 255],
        [52, 69, 147], [100, 115, 255], [0, 24, 236], [132, 56, 255],
    ],
    np.uint8,
)


def color_for(idx: int):
    c = COLORS[int(idx) % len(COLORS)]
    return int(c[0]), int(c[1]), int(c[2])


class Annotator:
    """Boxes, labels and lines over an RGB ndarray; ``result()`` returns it."""

    def __init__(self, img: np.ndarray, line_width: Optional[int] = None, names=None):
        img = np.asarray(img)
        if img.dtype != np.uint8:
            img = (img * 255).clip(0, 255).astype(np.uint8)
        self.im = np.array(img, np.uint8, copy=True, order="C")
        self.lw = line_width or max(round(sum(img.shape[:2]) / 2 * 0.003), 2)
        self.names = names

    # -- PIL's primitives ---------------------------------------------------
    def _hline(self, x0: int, y: int, x1: int, color) -> None:
        H, W = self.im.shape[:2]
        if not 0 <= y < H:
            return
        x0, x1 = min(x0, x1), max(x0, x1)
        if x0 >= W or x1 < 0:
            return
        self.im[y, max(x0, 0):min(x1, W - 1) + 1] = color

    def _point(self, x: int, y: int, color) -> None:
        H, W = self.im.shape[:2]
        if 0 <= x < W and 0 <= y < H:
            self.im[y, x] = color

    def _line(self, x0: int, y0: int, x1: int, y1: int, color) -> None:
        """Pillow's ``line32``: Bresenham from (x0, y0), the end point left out."""
        dx, dy = abs(x1 - x0), abs(y1 - y0)
        xs, ys = (1 if x1 >= x0 else -1), (1 if y1 >= y0 else -1)
        if dx == 0 or dy == 0:
            for _ in range(dx + dy):
                self._point(x0, y0, color)
                x0, y0 = x0 + (xs if dx else 0), y0 + (ys if dy else 0)
        elif dx > dy:
            e = 2 * dy - dx
            for _ in range(dx):
                self._point(x0, y0, color)
                if e >= 0:
                    y0, e = y0 + ys, e - 2 * dx
                e, x0 = e + 2 * dy, x0 + xs
        else:
            e = 2 * dx - dy
            for _ in range(dy):
                self._point(x0, y0, color)
                if e >= 0:
                    x0, e = x0 + xs, e - 2 * dy
                e, y0 = e + 2 * dx, y0 + ys

    def _polygon(self, vertices, color) -> None:
        """Pillow's ``polygon_generic`` fill of a closed polygon of integer
        ``vertices``: horizontal edges drawn whole; on each row the other
        edges' float32 crossings, an edge's last row counted twice below the
        polygon's last, and Pillow's "connect discontiguous corners" step,
        found from PIL 12.1's output (a whole-pixel crossing shared with an
        earlier edge of the same slope sign moves out by one pixel past the
        next row's (on the last row, the previous row's) crossings, rounded
        half away from zero, when it lies more than a pixel beyond both);
        sorted and filled in pairs."""
        f32 = np.float32
        edges = []
        ymin, ymax = self.im.shape[0] - 1, 0
        for (x0, y0), (x1, y1) in zip(vertices, vertices[1:] + vertices[:1]):
            ymin, ymax = min(ymin, y0, y1), max(ymax, y0, y1)
            if y0 == y1:
                self._hline(min(x0, x1), y0, max(x0, x1), color)
                continue
            edges.append((min(y0, y1), max(y0, y1), x0, y0, f32(f32(x1 - x0) / f32(y1 - y0))))

        def cross(e, y):
            return f32(f32(y - e[3]) * e[4] + f32(e[2]))

        ymin, ymax = max(ymin, 0), min(ymax, self.im.shape[0])
        for y in range(ymin, ymax + 1):
            xx = []
            for i, e in enumerate(edges):
                e0, e1, _, _, dx = e
                if not e0 <= y <= e1:
                    continue
                xx.append(cross(e, y))
                if y == e1 and y < ymax:
                    xx.append(xx[-1])
                elif dx != 0 and float(xx[-1]).is_integer():
                    for o in edges[:i]:
                        if (dx > 0 and o[4] <= 0) or (dx < 0 and o[4] >= 0) or xx[-1] != cross(o, y):
                            continue
                        y2 = y - 1 if y == ymax else y + 1
                        if o[0] <= y2 <= o[1]:
                            a, b = cross(e, y2), cross(o, y2)
                            if xx[-1] > a + 1 and xx[-1] > b + 1:
                                xx[-1] = f32(_round_up(float(max(a, b))) + 1)
                            elif xx[-1] < a - 1 and xx[-1] < b - 1:
                                xx[-1] = f32(_round_up(float(min(a, b))) - 1)
                            break
            xx.sort()
            for a, b in zip(xx[0::2], xx[1::2]):
                self._hline(_round_up(float(a)), y, _round_down(float(b)), color)

    def _wide_line(self, x0: int, y0: int, x1: int, y1: int, color, width: int) -> None:
        """Pillow's ``ImagingDrawWideLine``: the quadrilateral around the
        segment, its half-widths rounded up on one side and down on the
        other."""
        dx, dy = x1 - x0, y1 - y0
        if dx == 0 and dy == 0:
            self._point(x0, y0, color)
            return
        big, small = math.hypot(dx, dy), (width - 1) / 2.0
        rmax, rmin = _round_up(small) / big, _round_down(small) / big
        dxmin, dxmax = _round_down(rmin * dy), _round_down(rmax * dy)
        dymin, dymax = _round_down(rmin * dx), _round_down(rmax * dx)
        self._polygon([(x0 - dxmin, y0 + dymax), (x1 - dxmin, y1 + dymax),
                       (x1 + dxmax, y1 - dymin), (x0 + dxmax, y0 - dymin)], color)

    def polyline(self, pts, color, width: int = 1) -> None:
        """``ImageDraw.line(pts, fill=color, width=width)``: each segment in
        turn (one pixel wide: without its end point, the last point after)."""
        c = self._c(color)
        pts = [(int(p[0]), int(p[1])) for p in pts]
        for (x0, y0), (x1, y1) in zip(pts, pts[1:]):
            if width <= 1:
                self._line(x0, y0, x1, y1, c)
            else:
                self._wide_line(x0, y0, x1, y1, c, width)
        if width <= 1 and len(pts) > 1:
            self._point(*pts[-1], c)

    def ellipse(self, xyxy, fill=None, outline=None, width: int = 1) -> None:
        """``ImageDraw.ellipse((x0, y0, x1, y1), fill, outline, width)``."""
        x0, y0, x1, y1 = (int(v) for v in xyxy)
        if x1 < x0 or y1 < y0:
            raise ValueError("ellipse needs x1 >= x0 and y1 >= y0, as PIL does")
        a, b = x1 - x0, y1 - y0
        rings = []
        if fill is not None:
            rings.append((self._c(fill), a + b))  # filled: the ring as wide as the ellipse
        if outline is not None and width != 0 and (fill is None
                                                   or self._c(outline) != self._c(fill)):
            rings.append((self._c(outline), width))
        for c, w in rings:
            for X0, Y, X1 in _ellipse_spans(a, b, w):
                self._hline(x0 + (X0 + a) // 2, y0 + (Y + b) // 2, x0 + (X1 + a) // 2, c)

    def rectangle(self, xyxy, fill=None, outline=None, width: int = 1) -> None:
        """``ImageDraw.rectangle((x0, y0, x1, y1), fill, outline, width)``."""
        x0, y0, x1, y1 = (int(v) for v in xyxy)
        if x1 < x0 or y1 < y0:
            raise ValueError("rectangle needs x1 >= x0 and y1 >= y0, as PIL does")
        if fill is not None:
            H = self.im.shape[0]
            for y in range(max(y0, 0), min(y1, H) + 1):
                self._hline(x0, y, x1, self._c(fill))
        if outline is not None and width != 0 and (fill is None or self._c(outline) != self._c(fill)):
            c = self._c(outline)
            for i in range(width):
                self._hline(x0, y0 + i, x1, c)
                self._hline(x0, y1 - i, x1, c)
                self._line(x1 - i, y0 + width, x1 - i, y1 - width + 1, c)
                self._line(x0 + i, y0 + width, x0 + i, y1 - width + 1, c)

    def draw_text(self, xy, label: str, color) -> None:
        """The bitmap font's mask of ``label`` painted at ``xy``."""
        mask = font.getmask(label)
        x, y = int(xy[0]), int(xy[1])
        H, W = self.im.shape[:2]
        xa, ya, xb, yb = max(x, 0), max(y, 0), min(x + mask.shape[1], W), min(y + mask.shape[0], H)
        if xa < xb and ya < yb:
            region = self.im[ya:yb, xa:xb]
            region[mask[ya - y:yb - y, xa - x:xb - x]] = self._c(color)

    @staticmethod
    def _c(color):
        return tuple(int(v) for v in color)

    # -- the JAX Annotator's surface ----------------------------------------
    def text(self, xy, label: str, txt_color=(255, 255, 255), box_color=None):
        """Text at xy; optional filled background box."""
        if box_color is not None:
            x1, y1, x2, y2 = font.textbbox((int(xy[0]), int(xy[1])), label)
            pad = max(self.lw, 2)
            self.rectangle((x1 - pad, y1 - pad, x2 + pad, y2 + pad), fill=box_color)
        self.draw_text(xy, label, txt_color)

    def box_label(self, xyxy, label: str = "", color=(128, 128, 128), txt_color=(255, 255, 255)):
        p1 = (int(xyxy[0]), int(xyxy[1]))
        p2 = (int(xyxy[2]), int(xyxy[3]))
        self.rectangle((*p1, *p2), outline=color, width=self.lw)
        if label:
            self.text((p1[0], max(p1[1] - 12, 0)), label, txt_color, box_color=color)

    def line(self, p1, p2, color=(128, 128, 128), width: Optional[int] = None):
        """A line from p1 to p2, ``width`` (the line width) pixels wide."""
        self.polyline([p1, p2], color, width or self.lw)

    def circle(self, center, radius: int, color=(255, 0, 255), fill=True):
        x, y = int(center[0]), int(center[1])
        box = (x - radius, y - radius, x + radius, y + radius)
        if fill:
            self.ellipse(box, fill=color)
        else:
            self.ellipse(box, outline=color, width=self.lw)

    # -- the solution apps' drawing -------------------------------------------
    def draw_region(self, reg_pts, color=(255, 0, 255), thickness: int = 5):
        """A counting region (closed when it has 3 points or more) or line."""
        pts = [(int(p[0]), int(p[1])) for p in reg_pts]
        self.polyline(pts + [pts[0]] if len(pts) >= 3 else pts, color, thickness)

    def draw_centroid_and_tracks(self, track, color=(0, 255, 0), track_thickness: int = 2):
        """A track's trail and a dot at its last point."""
        pts = [(int(p[0]), int(p[1])) for p in track]
        if len(pts) >= 2:
            self.polyline(pts, color, track_thickness)
        self.circle(pts[-1], track_thickness * 2 + 1, color)

    def count_labels(self, counts: str, txt_color=(0, 0, 0), color=(255, 255, 255),
                     count_txt_size: int = 2):
        """The in/out count banner at the top centre (``textlength`` of the
        bitmap font: the sum of its advances)."""
        tw = font.text_size(counts)[0]
        self.text(((self.im.shape[1] - tw) / 2, 10), counts, txt_color, box_color=color)

    @staticmethod
    def estimate_pose_angle(a, b, c) -> float:
        """Angle at keypoint b formed by a-b-c, degrees in [0, 180]."""
        a, b, c = (np.asarray(p, np.float64)[:2] for p in (a, b, c))
        ang = math.degrees(
            math.atan2(c[1] - b[1], c[0] - b[0]) - math.atan2(a[1] - b[1], a[0] - b[0])
        )
        ang = abs(ang) % 360
        return 360 - ang if ang > 180 else ang

    def draw_specific_points(self, keypoints, indices, shape=(640, 640), radius: int = 2):
        """Dots at the workout keypoints that are confident and inside."""
        kpts = np.asarray(keypoints)
        for i in indices:
            k = kpts[int(i)]
            if len(k) >= 3 and k[2] < 0.25:
                continue
            if k[0] % shape[0] == 0 or k[1] % shape[1] == 0 or k[0] < 0 or k[1] < 0:
                continue
            self.circle((k[0], k[1]), radius, (0, 255, 0))
        return self.result()

    def plot_angle_and_count_and_stage(self, angle_text, count_text, stage_text, center_kpt,
                                       line_thickness: int = 2):
        """The workout's angle, reps and stage stacked beside a keypoint."""
        x, y = int(center_kpt[0]), int(center_kpt[1])
        for i, txt in enumerate(
            (f"{float(angle_text):.1f} deg", f"reps {count_text}", f"stage {stage_text}")
        ):
            self.text((x + 10, y + i * 14), txt, (0, 0, 0), box_color=(255, 255, 255))

    def plot_distance_and_line(self, distance_m, distance_mm, centroids, line_color=(255, 255, 0),
                               centroid_color=(255, 0, 255)):
        """The distance readout and the line between two centroids."""
        self.text((15, 25), f"Distance M: {distance_m:.2f}m", (0, 0, 0), box_color=(255, 255, 255))
        self.text((15, 45), f"Distance MM: {distance_mm:.2f}mm", (0, 0, 0),
                  box_color=(255, 255, 255))
        self.line(centroids[0], centroids[1], line_color, 3)
        self.circle(centroids[0], 6, centroid_color)
        self.circle(centroids[1], 6, centroid_color)

    def result(self) -> np.ndarray:
        return self.im


def _round_up(f: float) -> int:
    """Pillow's ROUND_UP: to the nearest integer, halves away from zero."""
    return int(math.floor(f + 0.5)) if f >= 0 else -int(math.floor(-f + 0.5))


def _round_down(f: float) -> int:
    """Pillow's ROUND_DOWN: to the nearest integer, halves towards zero."""
    return int(math.ceil(f - 0.5)) if f >= 0 else -int(math.ceil(-f - 0.5))


def _quarter(a: int, b: int):
    """Pillow's ``quarter_next`` walk: the points (x, y) of a quarter
    ellipse of doubled semi-axes a, b from (a, b % 2) to (a % 2, b), each
    step the one of (x, y + 2), (x - 2, y + 2), (x - 2, y) whose
    |a^2 y^2 + b^2 x^2 - a^2 b^2| is least (the first of equals)."""
    if a < 0 or b < 0:
        return
    x, y = a, b % 2
    a2, b2 = a * a, b * b

    def delta(px, py):
        return abs(a2 * py * py + b2 * px * px - a2 * b2)

    while True:
        yield x, y
        if x == a % 2 and y == b:
            return
        nx, ny, nd = x, y + 2, delta(x, y + 2)
        if nx > 1:
            d = delta(x - 2, y + 2)
            if nd > d:
                nx, ny, nd = x - 2, y + 2, d
            if nd > delta(x - 2, y):
                nx, ny = x - 2, y
        x, y = nx, ny


def _ellipse_spans(a: int, b: int, w: int):
    """Pillow's ``ellipse_next``: the (x0, y, x1) spans, in doubled
    coordinates about the centre, of the ring between the ellipse of a
    bounding box a x b and the one ``w`` pixels inside it."""
    outer = _quarter(a, b)
    first = next(outer, None)
    if first is None or w < 1:
        return
    pr, py = first
    inner = _quarter(a - 2 * (w - 1), b - 2 * (w - 1))
    leftmost = a % 2
    pl, finished = leftmost, False
    while not finished:
        y, l, r = py, pl, pr
        nxt = next(((cx, cy) for cx, cy in outer if cy > y), None)
        if nxt is None:
            finished = True
        else:
            pr, py = nxt
        nxt = None
        for cx, cy in inner:
            if cy > y:
                nxt = cx
                break
            l = cx
        pl = leftmost if nxt is None else nxt
        spans = []
        if (l > 0 or l < r) and y > 0:
            spans.append((2 if l == 0 else l, y, r))
        if y > 0:
            spans.append((-r, y, -l))
        if l > 0 or l < r:
            spans.append((2 if l == 0 else l, -y, r))
        spans.append((-r, -y, -l))
        yield from reversed(spans)
