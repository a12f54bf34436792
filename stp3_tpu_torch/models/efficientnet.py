"""Truncated EfficientNet backbone (port of stp3_tpu/models/efficientnet.py):
stem + MBConv blocks up to the stride-8 endpoint, returning the
"reduction" endpoints recorded whenever the spatial size halves.

flax ``padding='SAME'`` pads TF-style: at stride 2 the extra pixel goes
at the bottom/right (the stem, and the strided depthwise convs), which
``Conv2d(padding='SAME')`` reproduces with an explicit ``F.pad``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from stp3_tpu_torch.layers.base import Conv2d, Norm, dropout, to_first, to_last

# (num_repeat, kernel, stride, expand_ratio, in_ch, out_ch, se_ratio)
_BASE_BLOCKS: List[Tuple[int, int, int, int, int, int, float]] = [
    (1, 3, 1, 1, 32, 16, 0.25),
    (2, 3, 2, 6, 16, 24, 0.25),
    (2, 5, 2, 6, 24, 40, 0.25),
    (3, 3, 2, 6, 40, 80, 0.25),
    (3, 5, 1, 6, 80, 112, 0.25),
    (4, 5, 2, 6, 112, 192, 0.25),
    (1, 3, 1, 6, 192, 320, 0.25),
]

_SCALING = {  # width, depth, drop_connect
    'efficientnet-b0': (1.0, 1.0, 0.2),
    'efficientnet-b4': (1.4, 1.8, 0.2),
}

# blocks kept for the downsample-8 truncation
_TRUNCATE_IDX = {'efficientnet-b0': 10, 'efficientnet-b4': 21}


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    filters *= width
    new_f = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_f < 0.9 * filters:
        new_f += divisor
    return int(new_f)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def block_plan(name: str, truncate: bool = True):
    """Expanded per-block list [(kernel, stride, expand, in_ch, out_ch, se)]."""
    width, depth, _ = _SCALING[name]
    plan = []
    for (r, k, s, e, i, o, se) in _BASE_BLOCKS:
        i2, o2 = round_filters(i, width), round_filters(o, width)
        for j in range(round_repeats(r, depth)):
            plan.append((k, s if j == 0 else 1, e, i2 if j == 0 else o2, o2, se))
    if truncate:
        plan = plan[:_TRUNCATE_IDX[name] + 1]
    return plan


class SqueezeExcite(nn.Module):
    def __init__(self, ch: int, reduced_ch: int):
        super().__init__()
        self.Conv_0 = Conv2d(ch, reduced_ch, 1)
        self.Conv_1 = Conv2d(reduced_ch, ch, 1)

    def forward(self, x):                                        # NCHW
        s = x.mean((-2, -1), keepdim=True)
        s = self.Conv_1(F.silu(self.Conv_0(s)))
        return x * torch.sigmoid(s)


class MBConv(nn.Module):
    """Inverted-residual block. Given a generator (training), a residual
    block drops its whole residual branch per sample with probability
    ``drop_rate`` (drop-connect, as efficientnet_pytorch's)."""

    def __init__(self, in_ch: int, kernel: int, stride: int, expand: int,
                 out_ch: int, se_ratio: float, norm: str = 'gn', drop_rate: float = 0.0):
        super().__init__()
        self.stride, self.residual = stride, stride == 1 and in_ch == out_ch
        self.drop_rate = drop_rate
        mid = in_ch * expand
        convs, norms = [], []
        if expand != 1:
            convs.append(Conv2d(in_ch, mid, 1, bias=False))
            norms.append(Norm(mid, norm, eps=1e-3))
        convs.append(Conv2d(mid, mid, kernel, stride, 'SAME', groups=mid, bias=False))
        norms.append(Norm(mid, norm, eps=1e-3))
        self.expand = expand != 1
        self.se = se_ratio > 0
        if self.se:
            self.SqueezeExcite_0 = SqueezeExcite(mid, max(1, int(in_ch * se_ratio)))
        convs.append(Conv2d(mid, out_ch, 1, bias=False))
        norms.append(Norm(out_ch, norm, eps=1e-3))
        for i, (c, n) in enumerate(zip(convs, norms)):
            setattr(self, f'Conv_{i}', c)
            setattr(self, f'Norm_{i}', n)

    def forward(self, x, rng: Optional[torch.Generator] = None):  # NCHW
        i = 0
        h = x
        if self.expand:
            h = F.silu(self.Norm_0(self.Conv_0(h)))
            i = 1
        h = F.silu(getattr(self, f'Norm_{i}')(getattr(self, f'Conv_{i}')(h)))
        if self.se:
            h = self.SqueezeExcite_0(h)
        h = getattr(self, f'Norm_{i + 1}')(getattr(self, f'Conv_{i + 1}')(h))
        if not self.residual:
            return h
        return dropout(h, self.drop_rate, rng, (h.shape[0], 1, 1, 1)) + x


class EfficientNetFeatures(nn.Module):
    """Truncated EfficientNet; ``forward`` maps (B, H, W, 3) to a dict of
    channels-last reduction endpoints."""

    def __init__(self, arch: str = 'efficientnet-b4', norm: str = 'gn'):
        super().__init__()
        width, _, drop_connect = _SCALING[arch]
        stem_ch = round_filters(32, width)
        self.Conv_0 = Conv2d(3, stem_ch, 3, 2, 'SAME', bias=False)
        self.Norm_0 = Norm(stem_ch, norm, eps=1e-3)
        plan = block_plan(arch)
        self.n_blocks = len(plan)
        # drop-connect divides by the TRUNCATED block count, as the
        # reference does (encoder.py:48-55)
        for idx, (k, s, e, i, o, se) in enumerate(plan):
            setattr(self, f'MBConv_{idx}',
                    MBConv(i, k, s, e, o, se, norm, drop_connect * idx / self.n_blocks))

    def nchw(self, x, rng: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        x = F.silu(self.Norm_0(self.Conv_0(x)))
        endpoints: Dict[str, torch.Tensor] = {}
        prev = x
        for idx in range(self.n_blocks):
            x = getattr(self, f'MBConv_{idx}')(x, rng)
            if prev.shape[-2] > x.shape[-2]:
                endpoints[f'reduction_{len(endpoints) + 1}'] = prev
            prev = x
        endpoints[f'reduction_{len(endpoints) + 1}'] = x
        return endpoints

    def forward(self, x) -> Dict[str, torch.Tensor]:
        return {k: to_last(v) for k, v in self.nchw(to_first(x)).items()}
