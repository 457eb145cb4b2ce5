"""Drawing detections (port of ``yolov10_3d_tpu/utils/plotting.py``:
``COLORS``, ``color_for`` and the ``Annotator`` surface that
``Results.plot`` uses).

The JAX Annotator draws with ``PIL.ImageDraw``; this one draws in numpy by
PIL's rasterisation rules, so that given the same detections the image is
PIL's pixel for pixel:

- ``rectangle``: an outline of ``width`` rows and columns (Pillow's
  ``ImagingDrawRectangle``: ``width`` horizontal spans at the top and the
  bottom, then ``width`` vertical runs between them, drawn from
  ``y0 + width`` towards ``y1 - width + 1`` without that end row), or a
  filled span of rows; everything clipped to the image;
- ``line`` of width 1: Bresenham's walk without its end point, then the end
  point (Pillow's ``draw_lines``);
- text in Pillow's bitmap default font (``utils/font.py``), the mask's set
  pixels painted in the text colour.

PIL draws text with FreeType when it has it (Aileron, ``load_default()``);
the port always draws with the bitmap font, which is what PIL draws with
when it has none. The solution apps' drawing (regions, tracks, pose angles)
and lines wider than one pixel wait for ROADMAP item 19.
"""

from __future__ import annotations

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
        """A line from p1 to p2 (both ends drawn). Only one-pixel lines are
        ported; wider ones are the solution apps' (ROADMAP item 19)."""
        if (width or self.lw) != 1:
            raise NotImplementedError("lines wider than one pixel (the solution apps' drawing) "
                                      "are ROADMAP queue 1, item 19")
        x0, y0, x1, y1 = int(p1[0]), int(p1[1]), int(p2[0]), int(p2[1])
        self._line(x0, y0, x1, y1, self._c(color))
        self._point(x1, y1, self._c(color))

    def result(self) -> np.ndarray:
        return self.im
