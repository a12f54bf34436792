"""Per-camera image encoder (port of stp3_tpu/models/encoder.py):
EfficientNet trunk + two DeepLab necks giving a C-channel context map
and a D-bin depth-logit map at stride 8."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from stp3_tpu_torch.layers.base import to_first, to_last
from stp3_tpu_torch.layers.convolutions import DeepLabHead, UpsamplingConcat
from stp3_tpu_torch.models.efficientnet import EfficientNetFeatures, block_plan


class Encoder(nn.Module):
    """(B*, H, W, 3) -> (features (B*, H/8, W/8, C), depth (B*, H/8, W/8, D))."""

    def __init__(self, C: int, D: int, name_backbone: str = 'efficientnet-b4',
                 downsample: int = 8, norm: str = 'gn'):
        super().__init__()
        assert downsample == 8, 'only the reference downsample=8 is supported'
        plan = block_plan(name_backbone)
        # reduction_4 (stride 16) is the last block's width; reduction_3
        # (stride 8) the width entering the last stride-2 block
        c1 = plan[-1][4]
        c2 = next(b[3] for b in reversed(plan) if b[1] == 2)
        self.EfficientNetFeatures_0 = EfficientNetFeatures(name_backbone, norm)
        self.DeepLabHead_0 = DeepLabHead(c1, c1, 64, norm)
        self.UpsamplingConcat_0 = UpsamplingConcat(c1, c2, C, norm)
        self.DeepLabHead_1 = DeepLabHead(c1, c1, 64, norm)
        self.UpsamplingConcat_1 = UpsamplingConcat(c1, c2, D, norm)

    def nchw(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        endpoints = self.EfficientNetFeatures_0.nchw(x)
        input_1 = endpoints['reduction_4']     # stride 16
        input_2 = endpoints['reduction_3']     # stride 8
        feat = self.UpsamplingConcat_0.nchw(self.DeepLabHead_0.nchw(input_1), input_2)
        depth = self.UpsamplingConcat_1.nchw(self.DeepLabHead_1.nchw(input_1), input_2)
        return feat, depth

    def forward(self, x):
        feat, depth = self.nchw(to_first(x))
        return to_last(feat), to_last(depth)
