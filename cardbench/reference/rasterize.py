"""Host-side polygon rasterization (replaces skimage.draw.polygon); the
port's own copy of stp3_tpu/utils/rasterize.py.

Used for the ego-footprint cell offsets in the planner cost terms
(reference stp3/cost.py:68-81) and the collision metric
(reference stp3/metrics.py:298-307). Pure numpy, even-odd rule on integer
pixel coordinates, matching skimage.draw.polygon's behaviour of returning
all integer points inside the polygon.
"""
from __future__ import annotations

import numpy as np


def polygon(r, c, shape=None):
    """Return (rr, cc) integer coords inside the polygon (r, c vertices)."""
    r = np.asarray(r, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)
    rmin = int(np.floor(r.min()))
    rmax = int(np.ceil(r.max()))
    cmin = int(np.floor(c.min()))
    cmax = int(np.ceil(c.max()))
    rr_all, cc_all = np.meshgrid(np.arange(rmin, rmax + 1), np.arange(cmin, cmax + 1),
                                 indexing='ij')
    pts_r = rr_all.ravel().astype(np.float64)
    pts_c = cc_all.ravel().astype(np.float64)

    inside = np.zeros(pts_r.shape, dtype=bool)
    n = len(r)
    j = n - 1
    for i in range(n):
        ri, ci = r[i], c[i]
        rj, cj = r[j], c[j]
        cond = ((ri > pts_r) != (rj > pts_r)) & (
            pts_c < (cj - ci) * (pts_r - ri) / (rj - ri + 1e-12) + ci)
        inside ^= cond
        j = i

    rr = rr_all.ravel()[inside]
    cc = cc_all.ravel()[inside]
    if shape is not None:
        keep = (rr >= 0) & (rr < shape[0]) & (cc >= 0) & (cc < shape[1])
        rr, cc = rr[keep], cc[keep]
    return rr.astype(np.int64), cc.astype(np.int64)
