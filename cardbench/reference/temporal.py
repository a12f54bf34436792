"""Temporal layers (port of stp3_tpu/layers/temporal.py): convolutional
GRUs and causal 3-D conv blocks.

Public layout is the JAX one: frames (B, H, W, C), sequences
(B, T, H, W, C). Internally (``nchw``) frames are (B, C, H, W) and
sequences (B, C, T, H, W), so a 3-D conv sees its native layout.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from cardbench.reference.base import (Conv2d, Dense, Norm, lecun_normal_, remat,
                                        same_padding)
from cardbench.reference.convolutions import (Bottleblock, ChannelsLast,
                                                resize_bilinear)


class ConvGRUCell(ChannelsLast):
    """Conv GRU cell. The update and reset gates are ONE 3x3 conv
    (``gates``, update half first); the candidate conv reads
    [x, (1 - reset) * state]."""

    def __init__(self, cin: int, hidden: int, gru_bias_init: float = 0.0):
        super().__init__()
        self.hidden, self.gru_bias_init = hidden, gru_bias_init
        self.gates = Conv2d(cin + hidden, 2 * hidden, 3)
        self.candidate = Conv2d(cin + hidden, hidden, 3)

    def nchw(self, x, state):
        h = self.hidden
        gates = self.gates(torch.cat([x, state], 1)) + self.gru_bias_init
        update = torch.sigmoid(gates[:, :h])
        reset = torch.sigmoid(gates[:, h:])
        tilde = self.candidate(torch.cat([x, (1.0 - reset) * state], 1))
        return (1.0 - update) * state + update * tilde


class RawConv(Conv2d):
    """SAME 3x3 conv that can be applied to an input-channel slice of its
    kernel (``_RawConv``): conv(concat([x, s]), K) = conv(x, K[:, :cx]) +
    conv(s, K[:, cx:])."""

    def slice_apply(self, x, lo: int, hi: Optional[int], with_bias: bool):
        return self.conv(x, self.kernel[:, lo:hi], self.bias if with_bias else None)


class LatentGRUCell(ChannelsLast):
    """ConvGRUCell for a rollout whose input x is the same tensor every
    step (``_LatentGRUCell``): ``x_maps`` computes the x-half of both
    convs once, each step convolves only the state half. Same param tree
    as ConvGRUCell."""

    def __init__(self, hidden: int, x_channels: int, gru_bias_init: float = 0.0):
        super().__init__()
        self.hidden, self.x_channels = hidden, x_channels
        self.gru_bias_init = gru_bias_init
        self.gates = RawConv(x_channels + hidden, 2 * hidden, 3)
        self.candidate = RawConv(x_channels + hidden, hidden, 3)

    def x_maps(self, x):
        cx = self.x_channels
        return (self.gates.slice_apply(x, 0, cx, True),
                self.candidate.slice_apply(x, 0, cx, True))

    def step(self, x_maps, state):
        gx, cx_map = x_maps
        cx, h = self.x_channels, self.hidden
        gates = gx + self.gates.slice_apply(state, cx, None, False) + self.gru_bias_init
        update = torch.sigmoid(gates[:, :h])
        reset = torch.sigmoid(gates[:, h:])
        tilde = cx_map + self.candidate.slice_apply((1.0 - reset) * state, cx, None, False)
        return (1.0 - update) * state + update * tilde

    def nchw(self, x, state):
        """One step from a raw x (the public form, for tests)."""
        return self.step(self.x_maps(x), state)


def _cell(module, method: str, remat_cells: bool):
    """One GRU cell step, checkpointed under MODEL.REMAT 'cells': the
    backward recomputes the step's gate convs from its saved (x_t,
    h_{t-1}) instead of storing every gate tensor. The per-step states
    stay saved, so the serial rollout is not run again (as the whole
    future stage's recomputation under 'future' runs it)."""
    if remat_cells:
        return functools.partial(remat, module, method)
    return getattr(module, method)


class SpatialGRU(ChannelsLast):
    """ConvGRU over (B, C, T, H, W), then a per-step 1x1 conv decoder."""

    def __init__(self, input_size: int, hidden: int, gru_bias_init: float = 0.0,
                 remat_cells: bool = False):
        super().__init__()
        self.hidden, self.remat_cells = hidden, remat_cells
        self.cell = ConvGRUCell(input_size, hidden, gru_bias_init)
        self.decoder = Conv2d(hidden, input_size, 1, bias=False)

    def nchw(self, x, state=None):
        b, _, t, hh, ww = x.shape
        if state is None:
            state = x.new_zeros(b, self.hidden, hh, ww)
        cell = _cell(self.cell, 'nchw', self.remat_cells)
        states = []
        for i in range(t):
            state = cell(x[:, :, i], state)
            states.append(state)
        s = torch.stack(states, 1).flatten(0, 1)                  # (B*T, C, H, W)
        y = self.decoder(s)
        return y.reshape(b, t, *y.shape[1:]).transpose(1, 2)


class DualGRU(ChannelsLast):
    """Dual-pathway future rollout with a learned 2-way trust gate.
    x: latent sample (B, L, 1, H, W); state: past states (B, C, P, H, W)."""

    def __init__(self, input_size: int, hidden: int, n_future: int,
                 mixture: bool = True, gru_bias_init: float = 0.0, remat_cells: bool = False):
        super().__init__()
        self.input_size, self.n_future, self.mixture = input_size, n_future, mixture
        self.remat_cells = remat_cells
        self.cell1 = LatentGRUCell(hidden, input_size, gru_bias_init)
        self.cell2 = ConvGRUCell(hidden, hidden, gru_bias_init)
        self.decoder2 = Conv2d(hidden, hidden, 3)
        # flax builds nn.Sequential([Bottleblock, Conv]) inside DualGRU's
        # scope, so its layers are named DualGRU/{Bottleblock_0, Conv_0}
        self.Bottleblock_0 = Bottleblock(2 * hidden, hidden)
        self.Conv_0 = Conv2d(hidden, 2, 1, bias=False)

    def nchw(self, x, state):
        assert x.shape[1] == self.input_size
        n_present = state.shape[2]
        # under 'cells' cell 1's step is checkpointed, its hoisted x_maps not
        cell1 = _cell(self.cell1, 'step', self.remat_cells)
        cell2 = _cell(self.cell2, 'nchw', self.remat_cells)
        h = state[:, :, 0]
        for t in range(n_present - 1):
            h = cell2(state[:, :, t], h)
        s1 = s2 = state[:, :, -1]
        x0_maps = self.cell1.x_maps(x[:, :, 0])
        outs = []
        for _ in range(self.n_future):
            s1 = cell1(x0_maps, s1)
            h = cell2(s2, h)
            s2 = self.decoder2(h)
            mix = torch.cat([s1, s2], 1)
            gate = torch.softmax(self.Conv_0(self.Bottleblock_0.nchw(mix)), 1)
            cur = s2 * gate[:, 0:1] + s1 * gate[:, 1:2]
            if self.mixture:
                s1 = s2 = cur
            outs.append(cur)
        return torch.stack(outs, 2)


class CausalConv3d(ChannelsLast):
    """3-D conv with left-only time padding, then norm + relu; the norm's
    stats span (T, H, W). Kernel stored OIDHW."""

    def __init__(self, cin: int, cout: int, kernel_size: Tuple[int, int, int] = (2, 3, 3),
                 dilation: Tuple[int, int, int] = (1, 1, 1), norm: str = 'gn'):
        super().__init__()
        self.kernel_size, self.dilation = tuple(kernel_size), tuple(dilation)
        self.kernel = nn.Parameter(torch.zeros(cout, cin, *kernel_size))
        self.Norm_0 = Norm(cout, norm)

    def reset_parameters(self, generator):
        o, i, kt, kh, kw = self.kernel.shape
        lecun_normal_(self.kernel, i * kt * kh * kw, generator)

    @staticmethod
    def flax_leaf(name, arr):
        return arr.transpose(4, 3, 0, 1, 2)                      # DHWIO -> OIDHW

    @staticmethod
    def to_flax_leaf(name, arr):
        return arr.transpose(2, 3, 4, 1, 0)                      # OIDHW -> DHWIO

    def nchw(self, x):
        kt, kh, kw = self.kernel_size
        dt, dh, dw = self.dilation
        hpad, wpad = ((kh - 1) * dh) // 2, ((kw - 1) * dw) // 2
        x = F.pad(x, (0, 0, 0, 0, (kt - 1) * dt, 0))
        # the JAX layer casts its kernel to the input's dtype (no promotion)
        out = F.conv3d(x, self.kernel.to(x.dtype), None, 1, (0, hpad, wpad),
                       self.dilation)
        return F.relu(self.Norm_0(out))


class Conv1x1x1NormActivated(ChannelsLast):
    """1x1x1 conv (a Dense over channels) + norm + relu."""

    def __init__(self, cin: int, cout: int, norm: str = 'gn'):
        super().__init__()
        self.Dense_0 = Dense(cin, cout, bias=False)
        self.Norm_0 = Norm(cout, norm)

    def nchw(self, x):
        return F.relu(self.Norm_0(self.Dense_0.nchw(x)))


class Bottleneck3D(ChannelsLast):
    """3-D bottleneck: 1x1x1 reduce, causal conv, 1x1x1 expand, + skip."""

    def __init__(self, cin: int, cout: Optional[int] = None,
                 kernel_size=(2, 3, 3), dilation=(1, 1, 1), norm: str = 'gn'):
        super().__init__()
        cout = cout or cin
        self.Conv1x1x1NormActivated_0 = Conv1x1x1NormActivated(cin, cin // 2, norm)
        self.CausalConv3d_0 = CausalConv3d(cin // 2, cin // 2, kernel_size, dilation, norm)
        self.Conv1x1x1NormActivated_1 = Conv1x1x1NormActivated(cin // 2, cout, norm)
        self.project = cout != cin
        if self.project:
            self.Dense_0 = Dense(cin, cout, bias=False)
            self.Norm_0 = Norm(cout, norm)

    def nchw(self, x):
        h = self.Conv1x1x1NormActivated_0.nchw(x)
        h = self.CausalConv3d_0.nchw(h)
        h = self.Conv1x1x1NormActivated_1.nchw(h)
        skip = self.Norm_0(self.Dense_0.nchw(x)) if self.project else x
        return h + skip


def _avg_pool(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """flax ``avg_pool`` with stride = window: VALID when the window tiles
    the map, else SAME with the zero pad counted in the average. Either way
    the (padded) map is a whole number of windows, so the pool is a
    reshape and a mean (``F.avg_pool2d`` sums a whole-map window serially,
    one thread per output)."""
    h, w = x.shape[-2:]
    if h % kh or w % kw:
        (pt, pb), (pl, pr) = same_padding(h, kh, kh), same_padding(w, kw, kw)
        x = F.pad(x, (pl, pr, pt, pb))
    b, c, hp, wp = x.shape
    return x.reshape(b, c, hp // kh, kh, wp // kw, kw).mean((3, 5))


class PyramidSpatioTemporalPooling(ChannelsLast):
    """Causal spatio-temporal average pyramid: per pool size, spatial
    average pool, average with the previous frame (frame 0 alone),
    1x1x1 reduce, bilinear upsample back."""

    def __init__(self, cin: int, reduction_channels: int,
                 pool_sizes: Sequence[Tuple[int, int, int]], norm: str = 'gn'):
        super().__init__()
        self.pool_sizes = [tuple(p) for p in pool_sizes]
        for i, (kt, _, _) in enumerate(self.pool_sizes):
            assert kt == 2, 'time kernel must be 2 (matches reference)'
            setattr(self, f'Conv1x1x1NormActivated_{i}',
                    Conv1x1x1NormActivated(cin, reduction_channels, norm))

    def nchw(self, x):
        b, c, t, h, w = x.shape
        out = []
        for i, (_, kh, kw) in enumerate(self.pool_sizes):
            frames = x.transpose(1, 2).flatten(0, 1)             # (B*T, C, H, W)
            xp = _avg_pool(frames, kh, kw)
            xp = xp.reshape(b, t, c, *xp.shape[-2:]).transpose(1, 2)  # (B, C, T, hp, wp)
            prev = torch.cat([xp[:, :, :1], xp[:, :, :-1]], 2)
            xt = torch.cat([xp[:, :, :1], ((xp + prev) / 2.0)[:, :, 1:]], 2)
            xt = getattr(self, f'Conv1x1x1NormActivated_{i}').nchw(xt)
            rc = xt.shape[1]
            up = resize_bilinear(xt.transpose(1, 2).flatten(0, 1), (h, w))
            out.append(up.reshape(b, t, rc, h, w).transpose(1, 2))
        return torch.cat(out, 1)


class TemporalBlock(ChannelsLast):
    """Causal temporal block: paths 2x3x3, 1x3x3 (each after a 1x1x1
    reduce) and 1x1x1, optional pyramid pooling, 1x1x1 aggregation, +
    (projected) residual."""

    def __init__(self, cin: int, cout: Optional[int] = None,
                 use_pyramid_pooling: bool = False,
                 pool_sizes: Optional[Sequence[Tuple[int, int, int]]] = None,
                 norm: str = 'gn'):
        super().__init__()
        cout = cout or cin
        half = cin // 2
        self.use_pyramid_pooling = use_pyramid_pooling
        self.Conv1x1x1NormActivated_0 = Conv1x1x1NormActivated(cin, half, norm)
        self.CausalConv3d_0 = CausalConv3d(half, half, (2, 3, 3), norm=norm)
        self.Conv1x1x1NormActivated_1 = Conv1x1x1NormActivated(cin, half, norm)
        self.CausalConv3d_1 = CausalConv3d(half, half, (1, 3, 3), norm=norm)
        self.Conv1x1x1NormActivated_2 = Conv1x1x1NormActivated(cin, half, norm)
        agg_in = 3 * half
        if use_pyramid_pooling:
            assert pool_sizes is not None
            self.PyramidSpatioTemporalPooling_0 = PyramidSpatioTemporalPooling(
                cin, cin // 3, pool_sizes, norm)
            agg_in += cin // 3
        self.Conv1x1x1NormActivated_3 = Conv1x1x1NormActivated(agg_in, cout, norm)
        self.project = cout != cin
        if self.project:
            self.Dense_0 = Dense(cin, cout, bias=False)
            self.Norm_0 = Norm(cout, norm)

    def nchw(self, x):
        paths = [self.CausalConv3d_0.nchw(self.Conv1x1x1NormActivated_0.nchw(x)),
                 self.CausalConv3d_1.nchw(self.Conv1x1x1NormActivated_1.nchw(x)),
                 self.Conv1x1x1NormActivated_2.nchw(x)]
        if self.use_pyramid_pooling:
            paths.append(self.PyramidSpatioTemporalPooling_0.nchw(x))
        h = self.Conv1x1x1NormActivated_3.nchw(torch.cat(paths, 1))
        skip = self.Norm_0(self.Dense_0.nchw(x)) if self.project else x
        return skip + h
