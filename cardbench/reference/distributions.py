"""Present-distribution module (port of stp3_tpu/models/distributions.py).

GAUSSIAN and MIXGAUSSIAN: four downsampling Bottlenecks, a global average
pool and a 1x1 conv to (B, 1, 2L) or (B, 1, 6L + 3) parameters.
BERNOULLI: one Bottleneck to L channels and a log-sigmoid, per BEV cell.
"""
from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from cardbench.reference.base import Conv2d, to_first
from cardbench.reference.convolutions import Bottleneck

METHODS = ('GAUSSIAN', 'MIXGAUSSIAN', 'BERNOULLI')


class DistributionEncoder(nn.Module):
    def __init__(self, cin: int, out_channels: int, norm: str = 'gn'):
        super().__init__()
        for i in range(4):
            setattr(self, f'Bottleneck_{i}', Bottleneck(cin if i == 0 else out_channels,
                                                        out_channels, downsample=True,
                                                        norm=norm))

    def nchw(self, x):
        for i in range(4):
            x = getattr(self, f'Bottleneck_{i}').nchw(x)
        return x


class DistributionModule(nn.Module):
    """s_t (B, 1, H, W, C) -> GAUSSIAN (B, 1, 2L), MIXGAUSSIAN (B, 1, 6L + 3)
    or BERNOULLI (B, H, W, L) log-probabilities."""

    def __init__(self, in_channels: int, latent_dim: int, method: str = 'GAUSSIAN',
                 norm: str = 'gn'):
        super().__init__()
        if method not in METHODS:
            raise NotImplementedError(f'distribution {method!r} (one of {METHODS})')
        self.method = method
        if method == 'BERNOULLI':
            self.Bottleneck_0 = Bottleneck(in_channels, latent_dim, norm=norm)
            return
        compress = in_channels // 2
        out = 2 * latent_dim if method == 'GAUSSIAN' else 6 * latent_dim + 3
        self.DistributionEncoder_0 = DistributionEncoder(in_channels, compress, norm)
        self.Conv_0 = Conv2d(compress, out, 1)

    def nchw(self, s_t):
        """s_t (B, C, 1, H, W) -> (B, 1, 2L) / (B, 1, 6L + 3), or BERNOULLI's
        channels-first (B, L, H, W) log-probabilities."""
        b, _, s = s_t.shape[:3]
        assert s == 1
        if self.method == 'BERNOULLI':
            return F.logsigmoid(self.Bottleneck_0.nchw(s_t[:, :, 0]))
        h = self.DistributionEncoder_0.nchw(s_t[:, :, 0])
        h = self.Conv_0(h.mean((-2, -1), keepdim=True))
        return h.reshape(b, 1, -1)

    def forward(self, s_t):
        out = self.nchw(to_first(s_t))
        return out.movedim(1, -1) if self.method == 'BERNOULLI' else out
