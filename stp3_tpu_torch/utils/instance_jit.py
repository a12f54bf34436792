"""Instance decoding on the tensors' device: the torch counterpart of
stp3_tpu/utils/instance_jit.py, and of the host numpy path in
utils/instance.py (reference stp3/utils/instance.py:80-170).

The host path moves the full center / offset / segmentation tensors to
the host and loops over (B, T); this decoder runs the center NMS and the
pixel grouping for every frame at once on the device, so only the final
(B, T, H, W) id maps leave it. It matches the host path id for id:

  * maxpool NMS: ``F.max_pool2d``, whose padding is -inf, as
    ``lax.reduce_window``'s init value;
  * ``argwhere`` (a dynamic shape) becomes ``topk`` over the negated flat
    index of the NMS survivors with a static ``max_instances`` cap: the
    first ``max_instances`` survivors in row-major order, sorted, as the
    host path's ``argwhere()[:max_n]``. No two scores tie, so the order
    does not depend on how ``topk`` breaks ties;
  * the nearest center by ``argmin`` over the same float32 distances the
    host path forms (``sqrt(dx*dx + dy*dy)``, each op rounded on its
    own), which takes the first of equal minima on both backends;
  * consecutive renumbering through a bincount / cumsum lookup table of
    the ids present, ``np.unique``'s numbering (see ``_decode_frames``).

Temporal id consistency (Hungarian matching) stays on the host
(utils/instance.py).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# elements of one chunk's (frames, K, H, W) distance tensor: 64 Mi fp32 values
# (256 MiB), so that a large validation batch is decoded in pieces
DISTANCE_CHUNK_ELEMENTS = 1 << 26


def _nms_keep(center: torch.Tensor, conf_threshold: float, nms_kernel_size: int) -> torch.Tensor:
    """center (N, H, W) -> bool (N, H, W): local maxima above the threshold
    (reference instance.py:80-91 maxpool trick)."""
    cp = torch.where(center > conf_threshold, center, -1.0)
    pad = (nms_kernel_size - 1) // 2
    pooled = F.max_pool2d(cp[:, None], nms_kernel_size, stride=1, padding=pad)[:, 0]
    return (cp == pooled) & (cp > 0)


def _decode_frames(center: torch.Tensor, offset: torch.Tensor, foreground: torch.Tensor,
                   conf_threshold: float, nms_kernel_size: int,
                   max_instances: int) -> torch.Tensor:
    """(N, H, W), (N, H, W, 2), (N, H, W) bool -> (N, H, W) int64 ids in
    [0, K], consecutively numbered per frame, 0 = background."""
    n, h, w = center.shape
    dev = center.device
    keep = _nms_keep(center, conf_threshold, nms_kernel_size).reshape(n, h * w)
    k = min(max_instances, h * w)
    # fp32 holds integers below 2^24 exactly; h * w <= 40,000 here
    neg_idx = torch.where(keep, -torch.arange(h * w, device=dev, dtype=torch.float32),
                          float('-inf'))
    scores, idx = torch.topk(neg_idx, k, dim=1)                   # (N, K), ascending index
    valid = scores > float('-inf')
    cy = (idx // w).float()
    cx = (idx % w).float()

    gx = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    gy = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    loc_x = gx + offset[..., 0]                                   # (N, H, W)
    loc_y = gy + offset[..., 1]
    d_r = cy[:, :, None, None] - loc_x[:, None]                   # (N, K, H, W)
    d_c = cx[:, :, None, None] - loc_y[:, None]
    d = d_r.mul_(d_r).add_(d_c.mul_(d_c)).sqrt_()
    d.masked_fill_(~valid[:, :, None, None], float('inf'))
    ids = d.argmin(1) + 1                                         # (N, H, W)
    seg = torch.where(foreground & valid.any(1)[:, None, None], ids, 0).reshape(n, h * w)

    # consecutive renumbering: LUT[i] = #present ids <= i, minus 1, over the ids
    # present, 0 only if some pixel is background: np.unique's renumbering, so
    # in a frame without background the first instance becomes 0, as on the
    # host path and in the reference (JAX's device decode counts 0 present
    # always, and differs from its own host path in such a frame)
    occ = torch.zeros(n, k + 1, dtype=torch.int64, device=dev)
    occ.scatter_(1, seg, 1)
    lut = occ.cumsum(1) - 1
    return lut.gather(1, seg).reshape(n, h, w)


def decode_instances(segmentation_logits: torch.Tensor, center: torch.Tensor,
                     offset: torch.Tensor, conf_threshold: float = 0.1,
                     nms_kernel_size: int = 3, max_instances: int = 100,
                     vehicles_id: int = 1) -> torch.Tensor:
    """Batch instance decoding on the tensors' device.

    segmentation_logits (B, T, H, W, C); center (B, T, H, W, 1); offset
    (B, T, H, W, 2) -> (B, T, H, W) int64 instance ids (0 = background),
    consecutive per frame (no temporal linking: see the module docstring).
    Logits in fp32, as the host path's argmax reads them."""
    b, t, h, w = segmentation_logits.shape[:4]
    foreground = (segmentation_logits.argmax(-1) == vehicles_id).reshape(b * t, h, w)
    center = center.reshape(b * t, h, w, -1)[..., 0]
    offset = offset.reshape(b * t, h, w, 2)
    k = min(max_instances, h * w)
    chunk = max(1, DISTANCE_CHUNK_ELEMENTS // (k * h * w))
    out = [_decode_frames(center[i:i + chunk], offset[i:i + chunk], foreground[i:i + chunk],
                          conf_threshold, nms_kernel_size, max_instances)
           for i in range(0, b * t, chunk)]
    return torch.cat(out).reshape(b, t, h, w)
