"""Future prediction (port of stp3_tpu/models/future_prediction.py):
DualGRU rollout of ``n_future`` states from the latent sample, ConvNeXt
res-blocks, then ``n_gru_blocks`` SpatialGRUs over [past ++ future] with
ConvNeXt blocks between them and a DeepLabHead after the last."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from stp3_tpu_torch.layers.base import to_first, to_last
from stp3_tpu_torch.layers.convolutions import ConvNeXtBlock, DeepLabHead
from stp3_tpu_torch.layers.temporal import DualGRU, SpatialGRU


def _per_frame(module, x, *args):
    """Apply a 2-D ``nchw`` module to every frame of (B, C, T, H, W)."""
    b, _, t, h, w = x.shape
    y = module.nchw(x.transpose(1, 2).flatten(0, 1), *args)
    return y.reshape(b, t, -1, h, w).transpose(1, 2)


class FuturePrediction(nn.Module):
    def __init__(self, in_channels: int, latent_dim: int, n_future: int,
                 mixture: bool = True, n_gru_blocks: int = 2, n_res_layers: int = 1,
                 norm: str = 'gn', remat_cells: bool = False):
        """``remat_cells``: MODEL.REMAT 'cells', one checkpoint a GRU cell
        step (``layers/temporal.py``)."""
        super().__init__()
        self.n_gru_blocks, self.n_res_layers = n_gru_blocks, n_res_layers
        self.DualGRU_0 = DualGRU(latent_dim, in_channels, n_future, mixture,
                                 remat_cells=remat_cells)
        n_cnx = 0
        for _ in range(n_res_layers):
            setattr(self, f'ConvNeXtBlock_{n_cnx}', ConvNeXtBlock(in_channels))
            n_cnx += 1
        for i in range(n_gru_blocks):
            setattr(self, f'SpatialGRU_{i}', SpatialGRU(in_channels, in_channels,
                                                        remat_cells=remat_cells))
            if i < n_gru_blocks - 1:
                for _ in range(n_res_layers):
                    setattr(self, f'ConvNeXtBlock_{n_cnx}', ConvNeXtBlock(in_channels))
                    n_cnx += 1
        self.DeepLabHead_0 = DeepLabHead(in_channels, in_channels, 128, norm)

    def nchw(self, sample, state, rng: Optional[torch.Generator] = None):
        """sample (B, L, 1, H, W); state (B, C, P, H, W) ->
        (B, C, P + n_future, H, W); ``rng`` draws the DeepLabHead's
        training-time dropout mask (None at eval)."""
        x = self.DualGRU_0.nchw(sample, state)
        cnx = 0
        for _ in range(self.n_res_layers):
            x = _per_frame(getattr(self, f'ConvNeXtBlock_{cnx}'), x)
            cnx += 1
        x = torch.cat([state, x], 2)
        hidden_state = x[:, :, 0]
        for i in range(self.n_gru_blocks):
            x = getattr(self, f'SpatialGRU_{i}').nchw(x, hidden_state)
            if i < self.n_gru_blocks - 1:
                for _ in range(self.n_res_layers):
                    x = _per_frame(getattr(self, f'ConvNeXtBlock_{cnx}'), x)
                    cnx += 1
            else:
                x = _per_frame(self.DeepLabHead_0, x, rng)
        return x

    def forward(self, sample, state):
        return to_last(self.nchw(to_first(sample), to_first(state)))
