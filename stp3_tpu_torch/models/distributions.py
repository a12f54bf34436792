"""Present-distribution module, GAUSSIAN method (port of
stp3_tpu/models/distributions.py): four downsampling Bottlenecks, a
global average pool and a 1x1 conv to (mu, log_sigma). MIXGAUSSIAN and
BERNOULLI are not ported yet."""
from __future__ import annotations

import torch.nn as nn

from stp3_tpu_torch.layers.base import Conv2d, to_first
from stp3_tpu_torch.layers.convolutions import Bottleneck


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
    """s_t (B, 1, H, W, C) -> (B, 1, 2L) GAUSSIAN parameters."""

    def __init__(self, in_channels: int, latent_dim: int, method: str = 'GAUSSIAN',
                 norm: str = 'gn'):
        super().__init__()
        if method != 'GAUSSIAN':
            raise NotImplementedError(f'distribution {method} is not ported yet')
        compress = in_channels // 2
        self.DistributionEncoder_0 = DistributionEncoder(in_channels, compress, norm)
        self.Conv_0 = Conv2d(compress, 2 * latent_dim, 1)

    def nchw(self, s_t):
        """s_t (B, C, 1, H, W) -> (B, 1, 2L)."""
        b, _, s = s_t.shape[:3]
        assert s == 1
        h = self.DistributionEncoder_0.nchw(s_t[:, :, 0])
        h = self.Conv_0(h.mean((-2, -1), keepdim=True))
        return h.reshape(b, 1, -1)

    def forward(self, s_t):
        return self.nchw(to_first(s_t))
