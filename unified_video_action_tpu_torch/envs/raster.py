"""A numpy rasterizer for the PushT env's frames: the four drawing calls the
JAX env makes through OpenCV (``envs/pusht.py:359-392``), reproduced on
uint8 (H, W, 3) arrays with OpenCV's integer arithmetic, so that a frame
equals the reference's pixel for pixel.

- :func:`fill_poly`: ``cv2.fillPoly`` of one polygon with integer vertices
  (8-connected): each edge drawn as a Bresenham line, then the scanline fill
  of OpenCV's edge collection (16.16 fixed-point x, rows ``y0 <= y < y1`` of
  every non-horizontal edge, spans ``[ceil(x_a), floor(x_b)]`` between
  consecutive sorted x).
- :func:`thick_line`: ``cv2.line(thickness=t)`` for t > 1: the convex
  quadrilateral around the segment in 16.16 fixed point, filled by OpenCV's
  convex scan converter, and a filled circle of radius t / 2 at each end.
- :func:`fill_circle`: ``cv2.circle(thickness=-1)``: the midpoint circle's
  horizontal spans.
- :func:`resize_linear_u8`: ``cv2.resize(interpolation=INTER_LINEAR)`` of a
  uint8 image: half-pixel centres, 11-bit coefficients, horizontal taps
  exact in int32, the vertical taps as OpenCV's vector path computes them
  (``(mulhi(S0 >> 4, b0) + mulhi(S1 >> 4, b1) + 2) >> 2``), which equals
  ``(b0 S0 + b1 S1 + 2^21) >> 22`` to within one level.

Colors are given in the array's own channel order.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
RESIZE_COEF_BITS = 11
RESIZE_COEF_SCALE = 1 << RESIZE_COEF_BITS


def _c_div(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Integer division truncating toward zero, as C's ``/`` on int64."""
    q = np.abs(a) // np.abs(b)
    return np.where((a < 0) != (b < 0), -q, q)


def _hline(img: np.ndarray, y: int, x1: int, x2: int, color) -> None:
    h, w = img.shape[:2]
    if 0 <= y < h:
        x1, x2 = max(x1, 0), min(x2, w - 1)
        if x1 <= x2:
            img[y, x1:x2 + 1] = color


def clip_line(w: int, h: int, p1: Sequence[int], p2: Sequence[int]):
    """OpenCV's ``clipLine`` to the rectangle [0, w-1] x [0, h-1]: the ends
    moved onto its border, or None if the segment misses it."""
    (x1, y1), (x2, y2) = (int(p1[0]), int(p1[1])), (int(p2[0]), int(p2[1]))
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1, c1 = a, (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2, c2 = a, (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return None if (c1 | c2) else ((x1, y1), (x2, y2))


def line8_points(p0: Sequence[int], p1: Sequence[int], w: int, h: int) -> Tuple[np.ndarray, np.ndarray]:
    """(xs, ys) of OpenCV's 8-connected line from p0 to p1 on a w x h image
    (``LineIterator`` with ``leftToRight``, after ``clipLine``): the major
    axis steps every pixel, the minor one when the error term ``dx - 2 dy
    (i + 1) + 2 dx m_i`` is negative, which gives the minor offset ``m_i =
    ceil((2 dy i - dx) / (2 dx))``."""
    clipped = clip_line(w, h, p0, p1)
    if clipped is None:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    (x0, y0), (x1, y1) = clipped
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    ax, ay = x1 - x0, abs(y1 - y0)
    sy = -1 if y1 < y0 else 1
    major, minor = (ax, ay) if ax >= ay else (ay, ax)
    i = np.arange(major + 1, dtype=np.int64)
    m = -((major - 2 * minor * i) // (2 * major)) if major else np.zeros(1, np.int64)
    if ax >= ay:
        return x0 + i, y0 + sy * m
    return x0 + m, y0 + sy * i


def _put_points(img: np.ndarray, xs: np.ndarray, ys: np.ndarray, color) -> None:
    h, w = img.shape[:2]
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[keep], xs[keep]] = color


def fill_poly(img: np.ndarray, pts, color) -> None:
    """``cv2.fillPoly(img, [pts], color)`` for one polygon with integer
    vertices (convex or not), in place."""
    pts = np.asarray(pts, dtype=np.int64).reshape(-1, 2)
    h, w = img.shape[:2]
    n = len(pts)
    prev = np.roll(pts, 1, axis=0)  # edge i runs from vertex i-1 to vertex i
    for a, b in zip(prev, pts):
        _put_points(img, *line8_points(a, b, w, h), color)
    keep = prev[:, 1] != pts[:, 1]
    if n < 2 or keep.sum() < 2:
        return
    a, b = prev[keep], pts[keep]
    down = a[:, 1] < b[:, 1]
    y0 = np.where(down, a[:, 1], b[:, 1])
    y1 = np.where(down, b[:, 1], a[:, 1])
    x0 = np.where(down, a[:, 0], b[:, 0]) << XY_SHIFT
    dx = _c_div((b[:, 0] - a[:, 0]) << XY_SHIFT, b[:, 1] - a[:, 1])
    rows = np.arange(y0.min(), min(int(y1.max()), h), dtype=np.int64)
    rows = rows[rows >= 0]
    if rows.size == 0:
        return
    active = (rows[:, None] >= y0[None]) & (rows[:, None] < y1[None])
    big = np.int64(1) << 62
    xs = np.where(active, x0[None] + (rows[:, None] - y0[None]) * dx[None], big)
    xs.sort(axis=1)
    count = active.sum(axis=1)
    c0, c1 = max(int(pts[:, 0].min()), 0), min(int(pts[:, 0].max()), w - 1)
    if c0 > c1:
        return
    cols = np.arange(c0, c1 + 1, dtype=np.int64)
    mask = np.zeros((rows.size, cols.size), dtype=bool)
    for j in range(0, xs.shape[1] - 1, 2):
        on = count > j + 1
        lo = (xs[:, j] + XY_ONE - 1) >> XY_SHIFT
        hi = xs[:, j + 1] >> XY_SHIFT
        mask |= on[:, None] & (cols[None] >= lo[:, None]) & (cols[None] <= hi[:, None])
    img[rows[0]:rows[-1] + 1, c0:c1 + 1][mask] = color


def _line2_points(p1: Sequence[int], p2: Sequence[int]):
    """(xs, ys) of OpenCV's ``Line2``: a line between 16.16 fixed-point ends,
    which the convex fill draws as each polygon's outline."""
    (x1, y1), (x2, y2) = (int(p1[0]), int(p1[1])), (int(p2[0]), int(p2[1]))
    dx, dy = x2 - x1, y2 - y1
    if abs(dx) > abs(dy):
        if dx < 0:
            x1, y1, x2, y2, dy = x2, y2, x1, y1, -dy
        y_step = int(_c_div(np.int64(dy << XY_SHIFT), np.int64(abs(dx) | 1)))
        ecount = (x2 - x1) >> XY_SHIFT
        x = (x1 + (XY_ONE >> 1)) >> XY_SHIFT
        y = y1 + (XY_ONE >> 1)
        k = np.arange(ecount + 1, dtype=np.int64)
        xs, ys = x + k, (y + k * y_step) >> XY_SHIFT
    else:
        if dy < 0:
            x1, y1, x2, y2, dx = x2, y2, x1, y1, -dx
        x_step = int(_c_div(np.int64(dx << XY_SHIFT), np.int64(abs(dy) | 1)))
        ecount = (y2 - y1) >> XY_SHIFT
        x = x1 + (XY_ONE >> 1)
        y = (y1 + (XY_ONE >> 1)) >> XY_SHIFT
        k = np.arange(ecount + 1, dtype=np.int64)
        xs, ys = (x + k * x_step) >> XY_SHIFT, y + k
    end = np.array([(x2 + (XY_ONE >> 1)) >> XY_SHIFT]), np.array([(y2 + (XY_ONE >> 1)) >> XY_SHIFT])
    return np.concatenate([end[0], xs]), np.concatenate([end[1], ys])


def _fill_convex_fixed(img: np.ndarray, v: np.ndarray, color) -> None:
    """OpenCV's ``FillConvexPoly`` on 16.16 fixed-point vertices (shift 16,
    8-connected): the outline by ``Line2``, then two walking edges whose
    spans are ``[(xl + 0.5) >> 16, (xr + 0.5) >> 16]``."""
    h, w = img.shape[:2]
    npts = len(v)
    half = XY_ONE >> 1
    for i in range(npts):
        _put_points(img, *_line2_points(v[i - 1], v[i]), color)
    ys = [(int(p[1]) + half) >> XY_SHIFT for p in v]
    xs = [(int(p[0]) + half) >> XY_SHIFT for p in v]
    imin = int(np.argmin([int(p[1]) for p in v]))
    ymin, ymax = min(ys), max(ys)
    if npts < 3 or max(xs) < 0 or ymax < 0 or min(xs) >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edge = [{"idx": imin, "di": 1, "x": -XY_ONE, "dx": 0, "ye": ymin},
            {"idx": imin, "di": npts - 1, "x": -XY_ONE, "dx": 0, "ye": ymin}]
    edges = npts
    y = ymin
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0 = e["idx"]
                idx = (idx0 + e["di"]) % npts
                while edges > 0:
                    edges -= 1
                    ty = (int(v[idx][1]) + half) >> XY_SHIFT
                    if ty > y:
                        xs_, xe_ = int(v[idx0][0]), int(v[idx][0])
                        e["ye"] = ty
                        e["dx"] = int(_c_div(np.int64((xe_ - xs_) * 2 + (ty - y)),
                                             np.int64(2 * (ty - y))))
                        e["x"] = xs_
                        e["idx"] = idx
                        break
                    idx0 = idx
                    idx = (idx + e["di"]) % npts
                else:
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]["x"] > edge[1]["x"] else (0, 1)
            x1 = (edge[left]["x"] + half) >> XY_SHIFT
            x2 = (edge[right]["x"] + half) >> XY_SHIFT
            if x2 >= 0 and x1 < w:
                _hline(img, y, x1, x2, color)
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def fill_circle(img: np.ndarray, center: Sequence[int], radius: int, color) -> None:
    """``cv2.circle(img, center, radius, color, -1)`` (8-connected, no
    sub-pixel shift), in place."""
    cx, cy = int(center[0]), int(center[1])
    err, dx, dy, plus, minus = 0, int(radius), 0, 1, (int(radius) << 1) - 1
    while dx >= dy:
        _hline(img, cy - dy, cx - dx, cx + dx, color)
        _hline(img, cy + dy, cx - dx, cx + dx, color)
        _hline(img, cy - dx, cx - dy, cx + dy, color)
        _hline(img, cy + dx, cx - dy, cx + dy, color)
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def thick_line(img: np.ndarray, p0: Sequence[int], p1: Sequence[int], color, thickness: int) -> None:
    """``cv2.line(img, p0, p1, color, thickness)`` with integer ends and
    thickness > 1 (8-connected, round caps), in place."""
    if thickness <= 1:
        raise ValueError("thick_line draws thickness > 1; a 1-pixel line is line8_points")
    p0 = (int(p0[0]) << XY_SHIFT, int(p0[1]) << XY_SHIFT)
    p1 = (int(p1[0]) << XY_SHIFT, int(p1[1]) << XY_SHIFT)
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    t = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (t + odd * XY_ONE * 0.5) / np.sqrt(r)
        dpx, dpy = int(np.rint(dy * r)), int(np.rint(dx * r))
        quad = np.array([(p0[0] + dpx, p0[1] + dpy), (p0[0] - dpx, p0[1] - dpy),
                         (p1[0] - dpx, p1[1] - dpy), (p1[0] + dpx, p1[1] + dpy)], dtype=np.int64)
        _fill_convex_fixed(img, quad, color)
    for p in (p0, p1):
        center = ((p[0] + (XY_ONE >> 1)) >> XY_SHIFT, (p[1] + (XY_ONE >> 1)) >> XY_SHIFT)
        fill_circle(img, center, (t + (XY_ONE >> 1)) >> XY_SHIFT, color)


def _linear_taps(src: int, dst: int):
    """Source index pairs and 11-bit weights of INTER_LINEAR along one axis."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    low = s < 0
    f[low], s[low] = 0, 0
    high = s >= src - 1
    f[high], s[high] = 0, src - 1
    w1 = np.rint(f * RESIZE_COEF_SCALE).astype(np.int64)
    w0 = np.rint((np.float32(1) - f) * RESIZE_COEF_SCALE).astype(np.int64)
    return s, np.minimum(s + 1, src - 1), w0, w1


def resize_linear_u8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size)`` (``size`` = (width, height), INTER_LINEAR)
    of a uint8 (H, W) or (H, W, C) image. For uint8 input no 16-bit step of
    the vertical taps saturates (``S >> 4 <= 255 * 2048 / 16``), so int32
    holds them exactly."""
    if img.dtype != np.uint8:
        raise TypeError(f"resize_linear_u8 takes uint8, got {img.dtype}")
    out_w, out_h = int(size[0]), int(size[1])
    h, w = img.shape[:2]
    c = img.shape[2] if img.ndim == 3 else 1
    sy0, sy1, b0, b1 = (t.astype(np.int32) for t in _linear_taps(h, out_h))
    sx0, sx1, a0, a1 = (t.astype(np.int32) for t in _linear_taps(w, out_w))
    src = img.reshape(h, w, c).astype(np.int32)
    a0, a1 = a0[None, :, None], a1[None, :, None]

    def taps(rows):
        part = src[rows]
        return (part[:, sx0] * a0 + part[:, sx1] * a1).reshape(out_h, -1)

    v0 = ((taps(sy0) >> 4) * b0[:, None]) >> 16
    v1 = ((taps(sy1) >> 4) * b1[:, None]) >> 16
    out = np.clip((v0 + v1 + 2) >> 2, 0, 255).astype(np.uint8).reshape(out_h, out_w, c)
    return out if img.ndim == 3 else out[..., 0]
