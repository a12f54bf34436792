"""BEV decoder (port of stp3_tpu/models/decoder.py): ResNet18-style trunk
(explicit torch-style pads), three UpsamplingAdd stages, then per-task
heads. The 3x3 convs of every all-frame head run as ONE fused conv; the
HD-map head runs on the present frame only."""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from stp3_tpu_torch.layers.base import Conv2d, Norm, common_dtype, to_first, to_last
from stp3_tpu_torch.layers.convolutions import UpsamplingAdd


class BasicBlock(nn.Module):
    def __init__(self, cin: int, channels: int, stride: int = 1, norm: str = 'gn'):
        super().__init__()
        self.Conv_0 = Conv2d(cin, channels, 3, stride, ((1, 1), (1, 1)), bias=False)
        self.Norm_0 = Norm(channels, norm)
        self.Conv_1 = Conv2d(channels, channels, 3, 1, ((1, 1), (1, 1)), bias=False)
        self.Norm_1 = Norm(channels, norm)
        self.project = stride != 1 or cin != channels
        if self.project:
            self.Conv_2 = Conv2d(cin, channels, 1, stride, ((0, 0), (0, 0)), bias=False)
            self.Norm_2 = Norm(channels, norm)

    def forward(self, x):                                        # NCHW
        h = F.relu(self.Norm_0(self.Conv_0(x)))
        h = self.Norm_1(self.Conv_1(h))
        if self.project:
            x = self.Norm_2(self.Conv_2(x))
        return F.relu(h + x)


class Head(nn.Module):
    """3x3 conv (bare kernel ``Conv_0``) -> norm -> relu -> 1x1 conv."""

    def __init__(self, cin: int, out_channels: int, norm: str = 'gn'):
        super().__init__()
        self.Conv_0 = Conv2d(cin, cin, 3, bias=False)
        self.Norm_0 = Norm(cin, norm)
        self.Conv_1 = Conv2d(cin, out_channels, 1)

    def finish(self, hidden):
        return self.Conv_1(F.relu(self.Norm_0(hidden)))

    def forward(self, x):                                        # NCHW
        return self.finish(self.Conv_0(x))


class Decoder(nn.Module):
    def __init__(self, cin: int, n_classes: int, n_present: int, n_hdmap: int,
                 predict_pedestrian: bool = True, perceive_hdmap: bool = True,
                 predict_instance: bool = True, predict_future_flow: bool = True,
                 planning: bool = True, norm: str = 'gn'):
        super().__init__()
        if predict_future_flow and not predict_instance:
            raise ValueError('flow cannot be enabled without instance prediction')
        self.n_present, self.perceive_hdmap = n_present, perceive_hdmap
        self.Conv_0 = Conv2d(cin, 64, 7, 2, ((3, 3), (3, 3)), bias=False)
        self.Norm_0 = Norm(64, norm)
        for i, (ci, co, s) in enumerate([(64, 64, 1), (64, 64, 1), (64, 128, 2),
                                         (128, 128, 1), (128, 256, 2), (256, 256, 1)]):
            setattr(self, f'BasicBlock_{i}', BasicBlock(ci, co, s, norm))
        self.UpsamplingAdd_0 = UpsamplingAdd(256, 128, norm)
        self.UpsamplingAdd_1 = UpsamplingAdd(128, 64, norm)
        self.UpsamplingAdd_2 = UpsamplingAdd(64, cin, norm)
        heads = [('segmentation', 'segmentation_head', n_classes)]
        if predict_pedestrian:
            heads.append(('pedestrian', 'pedestrian_head', n_classes))
        if predict_instance:
            heads += [('instance_center', 'instance_center_head', 1),
                      ('instance_offset', 'instance_offset_head', 2)]
        if predict_future_flow:
            heads.append(('instance_flow', 'instance_future_head', 2))
        if planning:
            heads.append(('costvolume', 'costvolume_head', 1))
        self.heads = [(key, name) for key, name, _ in heads]
        for _, name, n_out in heads:
            setattr(self, name, Head(cin, n_out, norm))
        if perceive_hdmap:
            self.hdmap_head = Head(cin, 2 * n_hdmap, norm)

    def forward(self, x) -> Dict[str, Optional[torch.Tensor]]:
        """x (B, S, H, W, C) -> dict of channels-last per-task outputs."""
        b, s, h, w, c = x.shape
        flat = to_first(x.reshape(b * s, h, w, c))
        skip1 = flat
        t = F.relu(self.Norm_0(self.Conv_0(flat)))
        t = self.BasicBlock_1(self.BasicBlock_0(t))
        skip2 = t
        t = self.BasicBlock_3(self.BasicBlock_2(t))
        skip3 = t
        t = self.BasicBlock_5(self.BasicBlock_4(t))
        t = self.UpsamplingAdd_0.nchw(t, skip3)
        t = self.UpsamplingAdd_1.nchw(t, skip2)
        t = self.UpsamplingAdd_2.nchw(t, skip1)

        def unflat(y):
            return to_last(y).reshape(b, s, h, w, -1)

        mods = [getattr(self, name) for _, name in self.heads]
        kernel = torch.cat([m.Conv_0.kernel for m in mods], 0)
        fused = mods[0].Conv_0.conv(t, kernel.to(common_dtype(t, kernel)))
        out: Dict[str, Optional[torch.Tensor]] = {
            'pedestrian': None, 'hdmap': None, 'instance_center': None,
            'instance_offset': None, 'instance_flow': None, 'costvolume': None}
        for i, ((key, _), mod) in enumerate(zip(self.heads, mods)):
            y = unflat(mod.finish(fused[:, i * c:(i + 1) * c]))
            if key == 'instance_center':
                y = torch.sigmoid(y)
            elif key == 'costvolume':
                y = y[..., 0]
            out[key] = y
        if self.perceive_hdmap:
            present = t.reshape(b, s, *t.shape[1:])[:, self.n_present - 1]
            out['hdmap'] = to_last(self.hdmap_head(present))
        return out
