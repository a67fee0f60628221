"""cv2's 8-connected drawing routines on the host, as masks (numpy only).

The train-mode augmentations draw a polygon (``RandomShadow``), vertical
lines (``RandomRain``) and a filled circle (``RandomSunFlare``). What they
cover depends on the shape and the drawn parameters only, so the pixels are
found here, with OpenCV's own algorithms (``imgproc/src/drawing.cpp``), and
the device blends by the mask:

* :func:`fill_poly`: ``cv2.fillPoly`` with ``LINE_8`` and no shift: each
  edge drawn by Bresenham (``Line``), then a scanline fill between
  successive edge crossings in 16-bit fixed point (``FillEdgeCollection``),
  so a polygon that crosses itself fills by parity;
* :func:`line`: ``cv2.line`` of thickness 1, ``LINE_8``;
* :func:`fill_circle`: ``cv2.circle`` with thickness -1, ``LINE_8``
  (``Circle``: the midpoint circle's horizontal spans).
"""

from __future__ import annotations

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _clip_line(w: int, h: int, p1: list, p2: list) -> bool:
    """``clipLine``: clip the segment to ``[0, w) x [0, h)`` in place;
    False when nothing is left."""
    right, bottom = w - 1, h - 1
    x1, y1 = p1
    x2, y2 = p2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1)) if y2 != y1 else 0
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1)) if y2 != y1 else 0
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1)) if x2 != x1 else 0
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1)) if x2 != x1 else 0
                x2 = a
                c2 = 0
    p1[:], p2[:] = [x1, y1], [x2, y2]
    return (c1 | c2) == 0


def line(mask: np.ndarray, p0: tuple, p1: tuple, value) -> None:
    """``cv2.line(mask, p0, p1, value, 1)`` in place: the 8-connected line
    from ``p0`` to ``p1`` (``(x, y)`` points), clipped to the mask
    (``LineIterator`` with ``leftToRight``)."""
    h, w = mask.shape[:2]
    a, b = [int(p0[0]), int(p0[1])], [int(p1[0]), int(p1[1])]
    if not _clip_line(w, h, a, b):
        return
    (x1, y1), (x2, y2) = a, b
    if x2 < x1:  # left to right
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    steep = dy > dx
    if steep:
        dx, dy = dy, dx
    err = dx - (dy + dy)
    plus, minus = dx + dx, -(dy + dy)
    x, y = x1, y1
    for _ in range(dx + 1):
        mask[y, x] = value
        minor = err < 0
        err += minus + (plus if minor else 0)
        # the major step every time, the minor one when err went negative
        if steep:
            y += sy
            x += 1 if minor else 0
        else:
            x += 1
            y += sy if minor else 0


def fill_poly(mask: np.ndarray, pts: np.ndarray, value) -> None:
    """``cv2.fillPoly(mask, [pts], value)`` in place (``LINE_8``, no shift):
    the edges drawn as lines, then on each row the spans between successive
    edge crossings, ordered by x. An edge from ``(xa, ya)`` down to ``(xb,
    yb)`` crosses row ``y`` (``ya <= y < yb``) at the 16-bit fixed-point
    ``xa + 1/2 - 2^-16 + (y - ya) (xb - xa) / (yb - ya)``, rounded down:
    on OpenCV 5.0 this gives cv2's pixels on every polygon tried."""
    h, w = mask.shape[:2]
    pts = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    edges = []
    x0, y0 = pts[-1]
    for x1, y1 in pts:
        line(mask, (x0, y0), (x1, y1), value)
        if y0 != y1:
            (ya, xa), (yb, xb) = sorted([(y0, x0), (y1, x1)])
            edges.append((ya, yb, xa, xb))
        x0, y0 = x1, y1
    half = (XY_ONE >> 1) - 1
    for y in range(max(0, min(e[0] for e in edges)) if edges else 0,
                   min(h, max(e[1] for e in edges)) if edges else 0):
        xs = sorted((xa << XY_SHIFT) + half + (y - ya) * ((xb - xa) << XY_SHIFT) // (yb - ya)
                    for ya, yb, xa, xb in edges if ya <= y < yb)
        for k in range(0, len(xs) - 1, 2):
            x1, x2 = xs[k] >> XY_SHIFT, xs[k + 1] >> XY_SHIFT
            if x1 < w and x2 >= 0:
                mask[y, max(x1, 0):min(x2, w - 1) + 1] = value


def fill_circle(mask: np.ndarray, center: tuple, radius: int, value) -> None:
    """``cv2.circle(mask, center, radius, value, -1)`` in place."""
    h, w = mask.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    err, dx, dy, plus, minus = 0, int(radius), 0, 1, (int(radius) << 1) - 1

    def span(y, xa, xb):
        if 0 <= y < h and xa < w and xb >= 0:
            mask[y, max(xa, 0):min(xb, w - 1) + 1] = value

    while dx >= dy:
        span(cy - dy, cx - dx, cx + dx)
        span(cy + dy, cx - dx, cx + dx)
        span(cy - dx, cx - dy, cx + dy)
        span(cy + dx, cx - dy, cx + dy)
        dy += 1
        err += plus
        plus += 2
        m = -1 if err > 0 else 0  # (err <= 0) - 1
        err -= minus & m
        dx += m
        minus -= m & 2
