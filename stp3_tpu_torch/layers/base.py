"""Parameter-owning leaf modules and the port's layout conventions.

Every leaf names its parameters after the flax leaf it mirrors
(``kernel``, ``bias``, ``scale``) and stores them in PyTorch's own layout
(OIHW convs, (out, in) dense kernels). ``flax_leaf`` converts one flax
array into that layout, which is all ``utils/from_flax.py`` needs.

Composite modules name their children after the flax auto-names
(``Conv_0``, ``Norm_1``, ...), so a module's dotted torch path equals its
flax param path with ``/`` replaced by ``.``.

Layout: public ``forward`` calls take and return channels-last tensors,
as the JAX package does; internally modules work channels-first
(``nchw``) so ``F.conv2d`` sees its native layout. A channels-last tensor
permuted to NCHW is a ``channels_last``-strided view, so the permutes at
module boundaries copy nothing.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

Padding = Union[str, Tuple[Tuple[int, int], Tuple[int, int]]]


def to_first(x: torch.Tensor) -> torch.Tensor:
    """(B, ..., C) channels-last -> (B, C, ...) channels-first view."""
    return x.movedim(-1, 1)


def to_last(x: torch.Tensor) -> torch.Tensor:
    """(B, C, ...) channels-first -> (B, ..., C) channels-last view."""
    return x.movedim(1, -1)


def common_dtype(*tensors: torch.Tensor) -> torch.dtype:
    """flax's ``dtype=None`` rule: compute in the promoted type of input
    and params (bf16 input with fp32 params computes in fp32)."""
    dt = tensors[0].dtype
    for t in tensors[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return dt


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax ``lecun_normal``: truncated normal on [-2, 2] std, with the std
    corrected so the variance is 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


def same_padding(size: int, k: int, stride: int, dilation: int = 1) -> Tuple[int, int]:
    """flax/TF ``padding='SAME'``: out = ceil(size / stride), the total pad
    split with the extra pixel at the END (asymmetric at stride 2)."""
    out = -(-size // stride)
    eff = (k - 1) * dilation + 1
    total = max((out - 1) * stride + eff - size, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Module):
    """flax ``nn.Conv`` over NCHW. ``padding`` is ``'SAME'`` (flax
    semantics, asymmetric where flax is) or explicit ((top, bottom),
    (left, right))."""

    def __init__(self, cin: int, cout: int, kernel_size: Union[int, Tuple[int, int]],
                 stride: int = 1, padding: Padding = 'SAME', groups: int = 1,
                 dilation: int = 1, bias: bool = True):
        super().__init__()
        kh, kw = (kernel_size, kernel_size) if isinstance(kernel_size, int) else kernel_size
        self.stride, self.padding = stride, padding
        self.groups, self.dilation = groups, dilation
        self.kernel = nn.Parameter(torch.zeros(cout, cin // groups, kh, kw))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        o, i, kh, kw = self.kernel.shape
        lecun_normal_(self.kernel, i * kh * kw, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    @staticmethod
    def flax_leaf(name: str, arr: np.ndarray) -> np.ndarray:
        # HWIO -> OIHW; a depthwise (kh, kw, 1, C) lands on (C, 1, kh, kw)
        return arr.transpose(3, 2, 0, 1) if name == 'kernel' else arr

    def pads(self, x: torch.Tensor, kh: int, kw: int):
        if self.padding == 'SAME':
            return (same_padding(x.shape[-2], kh, self.stride, self.dilation),
                    same_padding(x.shape[-1], kw, self.stride, self.dilation))
        return self.padding

    def conv(self, x: torch.Tensor, kernel: torch.Tensor,
             bias: Optional[torch.Tensor] = None,
             pads: Optional[Sequence[Tuple[int, int]]] = None) -> torch.Tensor:
        """F.conv2d with this layer's stride/dilation/groups, flax dtype
        promotion and (possibly asymmetric) padding."""
        kh, kw = kernel.shape[-2:]
        (pt, pb), (pl, pr) = pads if pads is not None else self.pads(x, kh, kw)
        dt = common_dtype(x, kernel)
        x, kernel = x.to(dt), kernel.to(dt)
        if bias is not None:
            bias = bias.to(dt)
        if pt == pb and pl == pr:
            pad = (pt, pl)
        else:
            x = F.pad(x, (pl, pr, pt, pb))
            pad = (0, 0)
        return F.conv2d(x, kernel, bias, self.stride, pad, self.dilation, self.groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x, self.kernel, self.bias)


class Dense(nn.Module):
    """flax ``nn.Dense``; kernel stored (out, in) for ``F.linear``."""

    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.kernel, self.kernel.shape[1], generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    @staticmethod
    def flax_leaf(name: str, arr: np.ndarray) -> np.ndarray:
        return arr.T if name == 'kernel' else arr   # (I, O) -> (O, I)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Over the LAST axis (flax semantics)."""
        dt = common_dtype(x, self.kernel)
        b = self.bias.to(dt) if self.bias is not None else None
        return F.linear(x.to(dt), self.kernel.to(dt), b)

    def nchw(self, x: torch.Tensor) -> torch.Tensor:
        """Over axis 1 of a channels-first (B, C, ...) tensor: a 1x1 conv."""
        dt = common_dtype(x, self.kernel)
        k = self.kernel.to(dt).reshape(*self.kernel.shape, *([1] * (x.ndim - 2)))
        b = self.bias.to(dt) if self.bias is not None else None
        conv = F.conv2d if x.ndim == 4 else F.conv3d
        return conv(x.to(dt), k, b)


def num_groups(channels: int, preferred: int = 8) -> int:
    g = min(preferred, channels)
    while channels % g != 0:
        g -= 1
    return max(g, 1)


class GroupNorm(nn.Module):
    """``_GroupNormFast`` (stp3_tpu/layers/convolutions.py): eps 1e-6,
    fp32 stats from per-channel sum / sum-of-squares, var = E[x^2] - E[x]^2,
    applied as one per-channel multiply-add in the promoted dtype.
    Channels-first input (B, C, ...); stats over every non-(B, C) axis."""

    def __init__(self, channels: int, groups: int, eps: float = 1e-6):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        g = self.groups
        red = tuple(range(2, x.ndim))
        x32 = x.float()
        s1 = x32.sum(red)
        s2 = (x32 * x32).sum(red)
        n = (x.numel() // (b * c)) * (c // g)
        mean = s1.reshape(b, g, c // g).sum(-1) / n
        var = s2.reshape(b, g, c // g).sum(-1) / n - mean * mean
        inv = torch.rsqrt(var + self.eps)
        a = inv.repeat_interleave(c // g, -1) * self.scale.float()
        b2 = self.bias.float() - mean.repeat_interleave(c // g, -1) * a
        shape = (b, c) + (1,) * (x.ndim - 2)
        dt = common_dtype(x, self.scale)
        return x.to(dt) * a.reshape(shape).to(dt) + b2.reshape(shape).to(dt)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: eps 1e-6 (torch's default is 1e-5), fp32
    stats with var = max(E[x^2] - E[x]^2, 0), result in the promoted
    dtype of input and params. Normalises over axis ``dim``."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    reset_parameters = GroupNorm.reset_parameters

    def forward(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim, keepdim=True)
        var = ((x32 * x32).mean(dim, keepdim=True) - mean * mean).clamp_min(0.0)
        shape = [1] * x.ndim
        shape[dim] = x.shape[dim]
        mul = torch.rsqrt(var + self.eps) * self.scale.float().reshape(shape)
        y = (x32 - mean) * mul + self.bias.float().reshape(shape)
        return y.to(common_dtype(x, self.scale))


class Norm(nn.Module):
    """``stp3_tpu.layers.convolutions.Norm`` for kinds 'gn' (child
    ``GroupNorm_0``), 'ln' (child ``LayerNorm_0``) and 'none'. Channels-
    first input. ``eps`` belongs to the BatchNorm kinds only (1e-3 at the
    EfficientNet sites); those kinds are not ported yet."""

    def __init__(self, channels: int, kind: str = 'gn', groups: int = 8,
                 eps: float = 1e-5):
        super().__init__()
        if kind in ('bn', 'bn_frozen'):
            raise NotImplementedError(f"norm kind '{kind}' is not ported yet")
        if kind not in ('gn', 'ln', 'none'):
            raise ValueError(f'unknown norm kind {kind!r}')
        self.kind, self.eps = kind, eps
        if kind == 'gn':
            self.GroupNorm_0 = GroupNorm(channels, num_groups(channels, groups))
        elif kind == 'ln':
            self.LayerNorm_0 = LayerNorm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == 'gn':
            return self.GroupNorm_0(x)
        if self.kind == 'ln':
            return self.LayerNorm_0(x, dim=1)
        return x


def init_parameters(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init of every leaf. Matches flax's initialisers in
    distribution (lecun-normal kernels, zero biases, unit norm scales),
    not in the drawn numbers. Children are initialised before their
    parent, so a parent may override its children's defaults (the GRU
    cell's orthogonal recurrent kernels)."""
    for m in reversed(list(module.modules())):
        reset = getattr(m, 'reset_parameters', None)
        if reset is not None:
            reset(generator)
    return module
