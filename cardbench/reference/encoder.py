"""Per-camera image encoder (port of stp3_tpu/models/encoder.py):
EfficientNet trunk + two DeepLab necks giving a C-channel context map
and a D-bin depth-logit map at stride 8; without the depth distribution
only the context neck is built and the depth is None."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from cardbench.reference.base import to_first, to_last
from cardbench.reference.convolutions import DeepLabHead, UpsamplingConcat
from cardbench.reference.efficientnet import EfficientNetFeatures, block_plan


class Encoder(nn.Module):
    """(B*, H, W, 3) -> (features (B*, H/8, W/8, C), depth (B*, H/8, W/8, D)
    or None)."""

    def __init__(self, C: int, D: int, name_backbone: str = 'efficientnet-b4',
                 downsample: int = 8, norm: str = 'gn', use_depth_distribution: bool = True):
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
        self.use_depth_distribution = use_depth_distribution
        if use_depth_distribution:
            self.DeepLabHead_1 = DeepLabHead(c1, c1, 64, norm)
            self.UpsamplingConcat_1 = UpsamplingConcat(c1, c2, D, norm)

    def nchw(self, x, rng: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``rng``: the generator of the training-time drop-connect and
        dropout masks; None at eval."""
        endpoints = self.EfficientNetFeatures_0.nchw(x, rng)
        input_1 = endpoints['reduction_4']     # stride 16
        input_2 = endpoints['reduction_3']     # stride 8
        feat = self.UpsamplingConcat_0.nchw(self.DeepLabHead_0.nchw(input_1, rng), input_2)
        if not self.use_depth_distribution:
            return feat, None
        depth = self.UpsamplingConcat_1.nchw(self.DeepLabHead_1.nchw(input_1, rng), input_2)
        return feat, depth

    def forward(self, x, rng: Optional[torch.Generator] = None):
        feat, depth = self.nchw(to_first(x), rng)
        return to_last(feat), None if depth is None else to_last(depth)
