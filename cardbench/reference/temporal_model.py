"""Temporal model over BEV sequences (port of
stp3_tpu/models/temporal_model.py): ``receptive_field - 1``
TemporalBlocks with spatio-temporal pyramid pooling over the full BEV
extent, then a per-frame DeepLabHead; or the identity
(MODEL.TEMPORAL_MODEL.NAME 'identity'). (B, S, H, W, C) in and out."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from cardbench.reference.base import to_first, to_last
from cardbench.reference.convolutions import DeepLabHead
from cardbench.reference.temporal import Bottleneck3D, TemporalBlock


class TemporalModel(nn.Module):
    def __init__(self, in_channels: int, receptive_field: int,
                 input_shape: Tuple[int, int], start_out_channels: int = 64,
                 extra_in_channels: int = 0, inbetween_layers: int = 0,
                 use_pyramid_pooling: bool = True, norm: str = 'gn'):
        super().__init__()
        h, w = input_shape
        self.layers = []
        c, block_out = in_channels, start_out_channels
        n_tb = n_b3 = 0
        for _ in range(receptive_field - 1):
            pool_sizes = [(2, h, w)] if use_pyramid_pooling else None
            blk = TemporalBlock(c, block_out, use_pyramid_pooling, pool_sizes, norm)
            setattr(self, f'TemporalBlock_{n_tb}', blk)
            self.layers.append(f'TemporalBlock_{n_tb}')
            n_tb += 1
            c = block_out
            for _ in range(inbetween_layers):
                setattr(self, f'Bottleneck3D_{n_b3}',
                        Bottleneck3D(c, block_out, kernel_size=(1, 3, 3), norm=norm))
                self.layers.append(f'Bottleneck3D_{n_b3}')
                n_b3 += 1
            block_out += extra_in_channels
        self.DeepLabHead_0 = DeepLabHead(c, c, 128, norm)

    @staticmethod
    def out_channels(start_out_channels: int, receptive_field: int,
                     extra_in_channels: int) -> int:
        c = start_out_channels
        for _ in range(max(receptive_field - 1 - 1, 0)):
            c += extra_in_channels
        return c if receptive_field > 1 else start_out_channels

    def nchw(self, x, rng: Optional[torch.Generator] = None):
        """x (B, C, S, H, W) -> (B, C', S, H, W); ``rng`` draws the
        DeepLabHead's training-time dropout mask (None at eval)."""
        for name in self.layers:
            x = getattr(self, name).nchw(x)
        b, c, s, h, w = x.shape
        flat = self.DeepLabHead_0.nchw(x.transpose(1, 2).flatten(0, 1), rng)
        return flat.reshape(b, s, -1, h, w).transpose(1, 2)

    def forward(self, x):
        return to_last(self.nchw(to_first(x)))


class TemporalModelIdentity(nn.Module):
    """The pass-through temporal model; it has no parameters."""

    def nchw(self, x, rng: Optional[torch.Generator] = None):
        return x

    def forward(self, x):
        return x
