"""Planner (port of stp3_tpu/models/planning_model.py):
command-conditioned candidate selection, argmin over the seven BEV
costs, then GRU refinement of the chosen trajectory from the front-cam
feature; in training, the max-margin loss of the candidates against the
GT trajectory plus the smooth-L1 of the refinement. The GRU cell is
written in flax's own layout (ir/iz/in input denses with bias, hr/hz/hn
recurrent denses, only hn with bias), so a flax tree loads leaf for leaf.

Command codes: 0=LEFT, 1=FORWARD, 2=RIGHT, 3=other (keep all candidates).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from stp3_tpu_torch.layers.base import Dense, to_first
from stp3_tpu_torch.layers.convolutions import Bottleneck
from stp3_tpu_torch.models.cost import CostConfig, CostFunction

CMD_LEFT, CMD_FORWARD, CMD_RIGHT, CMD_OTHER = 0, 1, 2, 3


def command_index_table(sample_num: int) -> np.ndarray:
    """(4, N) gather indices: LEFT/FORWARD/RIGHT tile their third of the
    (terminal-x-sorted) candidates 3x; row 3 keeps all."""
    assert sample_num % 3 == 0
    num = sample_num // 3
    rows = [np.tile(np.arange(i * num, (i + 1) * num), 3) for i in range(3)]
    rows.append(np.arange(sample_num))
    return np.stack(rows).astype(np.int64)


class GRUCell(nn.Module):
    """flax ``nn.GRUCell``: r = sig(ir(x) + hr(h)), z = sig(iz(x) + hz(h)),
    n = tanh(in(x) + r * hn(h)), h' = (1 - z) * n + z * h."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        for g in ('r', 'z', 'n'):
            setattr(self, f'i{g}', Dense(cin, features, bias=True))
            setattr(self, f'h{g}', Dense(features, features, bias=(g == 'n')))

    def reset_parameters(self, generator):
        # flax: lecun-normal input kernels, orthogonal recurrent kernels
        for g in ('r', 'z', 'n'):
            with torch.no_grad():
                nn.init.orthogonal_(getattr(self, f'h{g}').kernel, generator=generator)

    def forward(self, h, x):
        r = torch.sigmoid(self.ir(x) + self.hr(h))
        z = torch.sigmoid(self.iz(x) + self.hz(h))
        n = torch.tanh(getattr(self, 'in')(x) + r * self.hn(h))
        return (1.0 - z) * n + z * h


class Planning(nn.Module):
    def __init__(self, cost_cfg: CostConfig, sample_num: int, feature_channel: int = 64,
                 gru_state_size: int = 256, gru_input_size: int = 6, norm: str = 'gn'):
        super().__init__()
        fc = feature_channel
        self.gru_state_size = gru_state_size
        self.reduce_channel_0 = Bottleneck(fc, fc, downsample=True, norm=norm)
        self.reduce_channel_1 = Bottleneck(fc, fc // 2, downsample=True, norm=norm)
        self.reduce_channel_2 = Bottleneck(fc // 2, fc // 2, downsample=True, norm=norm)
        self.reduce_channel_3 = Bottleneck(fc // 2, fc // 8, norm=norm)
        self.gru = GRUCell(gru_input_size, gru_state_size)
        self.decoder_fc1 = Dense(gru_state_size, gru_state_size)
        self.decoder_fc2 = Dense(gru_state_size, 2)
        self.register_buffer('cmd_table', torch.from_numpy(command_index_table(sample_num)),
                             persistent=False)
        self.cost_fn = CostFunction(cost_cfg)

    def select_trajs_by_command(self, trajs, commands):
        idx = self.cmd_table[commands]                              # (B, N)
        return torch.gather(trajs, 1, idx[:, :, None, None].expand(-1, -1, *trajs.shape[2:]))

    @staticmethod
    def split_hdmap(hd_map) -> Tuple[torch.Tensor, torch.Tensor]:
        c = hd_map.shape[-1]
        if c == 2:
            return hd_map[..., 0:1], hd_map[..., 1:2]
        if c == 4:
            return hd_map[..., 0:2], hd_map[..., 2:4]
        raise NotImplementedError(f'hd_map channels {c}')

    def select(self, trajs, cost_volume, semantic_pred, lane_divider, drivable_area,
               target_points):
        fc, fo = self.cost_fn(cost_volume, trajs[..., :2], semantic_pred, lane_divider,
                              drivable_area, target_points)
        kk = torch.argmin(fc + fo.sum(-1), -1)
        return trajs[torch.arange(trajs.shape[0], device=trajs.device), kk]

    def loss(self, trajs, gt_trajs, cost_volume, semantic_pred, lane_divider,
             drivable_area, target_points):
        """Max-margin loss of the candidates against the GT trajectory
        (reference planning_model.py:66-87)."""
        sm_fc, sm_fo = self.cost_fn(cost_volume, trajs[..., :2], semantic_pred,
                                    lane_divider, drivable_area, target_points)
        gt = gt_trajs[:, None] if gt_trajs.ndim == 3 else gt_trajs
        gt_fc, gt_fo = self.cost_fn(cost_volume, gt[..., :2], semantic_pred, lane_divider,
                                    drivable_area, target_points)
        l2 = ((trajs[..., :2] - gt[..., :2]) ** 2).sum(-1)          # (B, N, T)
        margin = F.relu(gt_fo - sm_fo).sum(-1) + (gt_fc - sm_fc) + l2.mean(-1)
        return F.relu(margin).max(-1).values.mean()

    def forward(self, cam_front, trajs, gt_trajs, cost_volume, semantic_pred, hd_map,
                commands, target_points, train: bool = False):
        """``Planning.__call__``: returns (loss, refined (B, T, 3)); the loss
        is 0 unless ``train``.

        cam_front (B, Hf, Wf, C); trajs (B, N, T, 3); gt_trajs (B, T, 3);
        cost_volume and semantic_pred (B, T, H, W); hd_map (B, H, W, 2 or 4)
        channels-last; commands (B,) int; target_points (B, 2)."""
        cur = self.select_trajs_by_command(trajs, commands.long())
        lane_divider, drivable_area = self.split_hdmap(hd_map)
        loss = None
        if train:
            loss = self.loss(cur, gt_trajs, cost_volume, semantic_pred, lane_divider,
                             drivable_area, target_points)
        h = to_first(cam_front)
        for i in range(4):
            h = getattr(self, f'reduce_channel_{i}').nchw(h)
        h0 = h.reshape(h.shape[0], -1)          # (C, H, W) ravel order
        if h0.shape[-1] != self.gru_state_size:
            raise ValueError(f'front-cam feature flattens to {h0.shape[-1]}, expected '
                             f'GRU_STATE_SIZE={self.gru_state_size}')
        final = self.select(cur, cost_volume, semantic_pred, lane_divider, drivable_area,
                            target_points)
        b, s, _ = final.shape
        x = h0.new_zeros(b, 2)
        tp = target_points.to(h0.dtype)
        outs = []
        for i in range(s):
            h0 = self.gru(h0, torch.cat([x, final[:, i, :2], tp], -1))
            x = self.decoder_fc2(F.relu(self.decoder_fc1(h0)))
            outs.append(x)
        out = torch.stack(outs, 1)
        out3 = torch.cat([out, torch.zeros_like(out[..., :1])], -1)
        if not train:
            return torch.zeros((), device=out.device), out3
        # smooth-L1 to GT with the x axis weighted 10x (reference :148)
        diff = out - gt_trajs[..., :2]
        absd = diff.abs()
        huber = torch.where(absd < 1.0, 0.5 * diff ** 2, absd - 0.5)
        weight = torch.tensor([10.0, 1.0], device=huber.device)     # fp32, as in JAX
        return loss * 0.5 + (huber * weight).mean(), out3
