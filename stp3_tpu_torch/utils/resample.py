"""The two OpenCV calls of the JAX package's nuScenes dataset, in numpy:

* ``resize_linear_float(depth, (w, h))``: ``cv2.resize(depth, (w, h),
  interpolation=cv2.INTER_LINEAR)`` of a float32 map (the depth label);
* ``fill_poly(canvas, pts, value)``: ``cv2.fillPoly(canvas, [pts], value)``
  of one polygon with integer vertices (the BEV labels), edges included.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


# ------------------------------------------------------------ INTER_LINEAR


def _taps(in_size: int, out_size: int, clamp_fraction: bool):
    """Source index and fraction of each output pixel of cv::resize's
    linear interpolation: half-pixel centres, the scale the inverse of
    out / in, the position in double, its fraction rounded to float32.
    Along x OpenCV zeroes the fraction where the index is below 0 or at or
    above in_size - 1; along y it clamps the two rows instead."""
    scale = 1.0 / (out_size / in_size)
    pos = (np.arange(out_size) + 0.5) * scale - 0.5
    s = np.floor(pos).astype(np.int64)
    f = (pos - s).astype(np.float32)
    if clamp_fraction:
        low, high = s < 0, s >= in_size - 1
        f = np.where(low | high, np.float32(0), f)
        s = np.where(low, 0, np.where(high, in_size - 1, s))
    return s, f


def resize_linear_float(src: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(src, size, interpolation=cv2.INTER_LINEAR)`` of a 2-D
    float32 array; ``size`` is (width, height). The horizontal pass runs
    first, in float32. OpenCV's vector code may fuse a multiply-add where
    this adds two products, a difference of a few units in the last place."""
    src = np.asarray(src, np.float32)
    if src.ndim != 2:
        raise ValueError(f'resize_linear_float takes a 2-D map, got {src.shape}')
    (ow, oh), (ih, iw) = size, src.shape
    sx, fx = _taps(iw, ow, True)
    x1 = np.minimum(sx + 1, iw - 1)
    one = np.float32(1)
    rows = src[:, sx] * (one - fx) + src[:, x1] * fx               # (ih, ow)
    sy, fy = _taps(ih, oh, False)
    y0, y1 = np.clip(sy, 0, ih - 1), np.clip(sy + 1, 0, ih - 1)
    out = rows[y0] * (one - fy)[:, None] + rows[y1] * fy[:, None]
    return out.astype(np.float32)


# ---------------------------------------------------------------- fillPoly


def _cdiv(a: int, b: int) -> int:
    """C's integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(w: int, h: int, p1: list, p2: list) -> bool:
    """cv::clipLine on [x, y] lists, in place (OpenCV keeps its partial
    updates when the line misses the image, and so does this)."""
    right, bottom = w - 1, h - 1
    x1, y1 = p1
    x2, y2 = p2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    p1[:] = [x1, y1]
    p2[:] = [x2, y2]
    return (c1 | c2) == 0


def _line8(canvas: np.ndarray, p1, p2, value) -> None:
    """cv::line with LINE_8 (LineIterator, left to right)."""
    h, w = canvas.shape[:2]
    p1, p2 = list(p1), list(p2)
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h and 0 <= p2[1] < h):
        if not _clip_line(w, h, p1, p2):
            return
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    sx = sy = 1
    if dx < 0:
        dx, dy, p1 = -dx, -dy, p2
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
        sx, sy = sy, sx
    err = dx - 2 * dy
    # each step takes the minus move, and the plus move too where err < 0
    minus, plus = ((0, sx), (sy, 0)) if vert else ((sx, 0), (0, sy))
    x, y = p1
    for _ in range(dx + 1):
        canvas[y, x] = value
        if err < 0:
            err += 2 * dx - 2 * dy
            x += minus[0] + plus[0]
            y += minus[1] + plus[1]
        else:
            err -= 2 * dy
            x += minus[0]
            y += minus[1]


class _Edge:
    __slots__ = ('y0', 'y1', 'x', 'dx', 'next')

    def __init__(self, y0=0, y1=0, x=0, dx=0):
        self.y0, self.y1, self.x, self.dx, self.next = y0, y1, x, dx, None


def _collect_edges(canvas: np.ndarray, pts: np.ndarray, value) -> list:
    """CollectPolyEdges (shift 0, no offset, LINE_8): draws every edge and
    returns the non-horizontal ones, x in 16.16 fixed point at pixel
    centres (+1/2), the slope truncated toward zero. An edge that leaves
    the image runs through its clipped end points (their x only, where
    clipping leaves both at one row)."""
    h, w = canvas.shape[:2]
    half = XY_ONE >> 1
    edges = []
    v = [(int(x), int(y)) for x, y in pts]
    x0, y0 = v[-1]
    for x1, y1 in v:
        _line8(canvas, (x0, y0), (x1, y1), value)
        c0, c1 = [x0, y0], [x1, y1]
        if not (0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h and 0 <= y1 < h):
            t0, t1 = [x0, y0], [x1, y1]
            _clip_line(w, h, t0, t1)
            c0[0], c1[0] = t0[0], t1[0]
            if t0[1] != t1[1]:
                c0[1], c1[1] = t0[1], t1[1]
        if y0 != y1:
            dx = _cdiv((c1[0] - c0[0]) << XY_SHIFT, c1[1] - c0[1])
            if y0 < y1:
                edges.append(_Edge(y0, y1, (c0[0] << XY_SHIFT) + half + (y0 - c0[1]) * dx, dx))
            else:
                edges.append(_Edge(y1, y0, (c1[0] << XY_SHIFT) + half + (y1 - c1[1]) * dx, dx))
        x0, y0 = x1, y1
    return edges


def _fill_edges(canvas: np.ndarray, edges: list, value) -> None:
    """FillEdgeCollection (LINE_8): an active edge list walked scanline by
    scanline, spans filled between pairs of edges."""
    h, w = canvas.shape[:2]
    total = len(edges)
    if total < 2:
        return
    y_min = min(e.y0 for e in edges)
    y_max = max(e.y1 for e in edges)
    ends = [e.x + (e.y1 - e.y0) * e.dx for e in edges]
    x_min = min(min(e.x for e in edges), min(ends))
    x_max = max(max(e.x for e in edges), max(ends))
    if y_max < 0 or y_min >= h or x_max < 0 or x_min >= (w << XY_SHIFT):
        return
    edges = sorted(edges, key=lambda e: (e.y0, e.x, e.dx))
    tmp = _Edge(y0=2 ** 31 - 1)
    edges.append(tmp)
    i = 0
    e = edges[0]
    for y in range(e.y0, min(y_max, h)):
        draw = 0
        clipline = y < 0
        prelast, last = tmp, tmp.next
        while last is not None or e.y0 == y:
            if last is not None and last.y1 == y:
                prelast.next = last.next               # the edge ends here
                last = last.next
                continue
            keep_prelast = prelast
            if last is not None and (e.y0 > y or last.x < e.x):
                prelast, last = last, last.next
            elif i < total:
                prelast.next = e                       # an edge starts here
                e.next = last
                prelast = e
                i += 1
                e = edges[i]
            else:
                break
            if draw:
                if not clipline:
                    # the pixels whose centres lie between the two edges
                    lo, hi = sorted((keep_prelast.x, prelast.x))
                    x1 = (lo + (XY_ONE >> 1) - 1) >> XY_SHIFT
                    x2 = (hi - (XY_ONE >> 1)) >> XY_SHIFT
                    if x1 < w and x2 >= 0:
                        canvas[y, max(x1, 0):min(x2, w - 1) + 1] = value
                keep_prelast.x += keep_prelast.dx
                prelast.x += prelast.dx
            draw ^= 1
        # bubble sort of the active list by x
        keep_prelast = None
        while True:
            prelast, last, last_exchange = tmp, tmp.next, None
            while last is not keep_prelast and last.next is not None:
                te = last.next
                if last.x > te.x:
                    prelast.next = te
                    last.next = te.next
                    te.next = last
                    prelast = te
                    last_exchange = prelast
                else:
                    prelast, last = last, te
            if last_exchange is None:
                break
            keep_prelast = last_exchange
            if keep_prelast is tmp.next or keep_prelast is tmp:
                break


def fill_poly(canvas: np.ndarray, pts: np.ndarray, value) -> np.ndarray:
    """``cv2.fillPoly(canvas, [pts], value)``: fill the polygon of integer
    (x, y) vertices ``pts`` (N, 2) into the 2-D ``canvas`` in place, its
    8-connected edges included; returns the canvas."""
    pts = np.asarray(pts)
    if pts.ndim != 2 or pts.shape[1] != 2 or not np.issubdtype(pts.dtype, np.integer):
        raise ValueError(f'fill_poly takes integer (N, 2) points, got {pts.dtype} {pts.shape}')
    if len(pts):
        _fill_edges(canvas, _collect_edges(canvas, pts, value), value)
    return canvas
