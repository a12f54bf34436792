"""2-D building blocks (port of stp3_tpu/layers/convolutions.py).

Each module's ``forward`` takes and returns channels-last tensors; its
``nchw`` method is the channels-first body that composites call.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from stp3_tpu_torch.layers.base import (Conv2d, ConvTranspose2d, Dense, LayerNorm, Norm,
                                        common_dtype, dropout, to_first, to_last)
from stp3_tpu_torch.ops.kernels.convnext_mlp import convnext_mlp


class ChannelsLast(nn.Module):
    """Public channels-last ``forward`` around a channels-first ``nchw``."""

    def forward(self, x: torch.Tensor, *rest: torch.Tensor) -> torch.Tensor:
        return to_last(self.nchw(to_first(x), *(to_first(r) for r in rest)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU in fp32, tanh-approximate in bf16 (as the JAX
    package's ``gelu``)."""
    return F.gelu(x, approximate='tanh' if x.dtype == torch.bfloat16 else 'none')


def resize_bilinear(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(..., 'bilinear')`` for an UPSAMPLE of an NCHW map:
    half-pixel centres, i.e. ``align_corners=False``. A downscale would be
    antialiased in JAX and is refused."""
    h, w = hw
    if h < x.shape[-2] or w < x.shape[-1]:
        raise ValueError(f'resize {tuple(x.shape[-2:])} -> {hw} is a downscale; '
                         'only upsampling matches jax.image.resize')
    if (h, w) == tuple(x.shape[-2:]):
        return x
    return F.interpolate(x, size=(h, w), mode='bilinear', align_corners=False)


def upsample_bilinear(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    return resize_bilinear(x, (x.shape[-2] * scale, x.shape[-1] * scale))


class ConvBlock(ChannelsLast):
    """conv (or, with ``transpose``, flax's 'SAME' transposed conv) ->
    norm -> activation."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3, stride: int = 1,
                 norm: str = 'gn', activation: str = 'relu', use_bias: bool = False,
                 transpose: bool = False):
        super().__init__()
        if transpose:
            self.ConvTranspose_0 = ConvTranspose2d(cin, cout, kernel_size, stride,
                                                   bias=use_bias)
        else:
            self.Conv_0 = Conv2d(cin, cout, kernel_size, stride, bias=use_bias)
        self.Norm_0 = Norm(cout, norm)
        self.act = {'relu': F.relu, 'lrelu': lambda v: F.leaky_relu(v, 0.1),
                    'elu': F.elu, 'tanh': torch.tanh, 'none': lambda v: v}[activation]

    def nchw(self, x):
        conv = self.ConvTranspose_0 if hasattr(self, 'ConvTranspose_0') else self.Conv_0
        return self.act(self.Norm_0(conv(x)))


class Bottleneck(ChannelsLast):
    """1x1 down-project -> kxk (stride 1, stride 2, or with ``upsample`` a
    stride-2 transposed conv) -> 1x1 up-project, each norm + relu, with a
    projected residual. The downsampling skip zero-pads an odd H/W at the
    bottom/right and THEN 2x2-max-pools (not ``MaxPool2d(ceil_mode=True)``,
    which would ignore the pad); the upsampling skip is a 2x bilinear
    upsample."""

    def __init__(self, cin: int, cout: Optional[int] = None, kernel_size: int = 3,
                 downsample: bool = False, norm: str = 'gn', upsample: bool = False):
        super().__init__()
        cout = cout or cin
        bneck = cin // 2
        p = kernel_size // 2
        self.downsample, self.upsample = downsample, upsample
        self.Conv_0 = Conv2d(cin, bneck, 1, bias=False)
        self.Norm_0 = Norm(bneck, norm)
        if upsample:
            # torch's ConvTranspose2d(padding=k//2, output_padding=k//2) window
            self.ConvTranspose_0 = ConvTranspose2d(bneck, bneck, kernel_size, 2,
                                                   ((p, p + 1), (p, p + 1)), bias=False,
                                                   transpose_kernel=True)
        else:
            self.Conv_1 = Conv2d(bneck, bneck, kernel_size, 2 if downsample else 1,
                                 padding=((p, p), (p, p)), bias=False)
        self.Norm_1 = Norm(bneck, norm)
        # flax numbers the Conv children in the order it creates them
        self.names = ('Conv_1', 'Conv_2') if upsample else ('Conv_2', 'Conv_3')
        setattr(self, self.names[0], Conv2d(bneck, cout, 1, bias=False))
        self.Norm_2 = Norm(cout, norm)
        self.project = cout != cin or downsample or upsample
        if self.project:
            setattr(self, self.names[1], Conv2d(cin, cout, 1, bias=False))
            self.Norm_3 = Norm(cout, norm)

    def nchw(self, x):
        h = F.relu(self.Norm_0(self.Conv_0(x)))
        mid = self.ConvTranspose_0 if self.upsample else self.Conv_1
        h = F.relu(self.Norm_1(mid(h)))
        h = F.relu(self.Norm_2(getattr(self, self.names[0])(h)))
        if not self.project:
            return h + x
        skip = x
        if self.upsample:
            skip = upsample_bilinear(skip, 2)
        elif self.downsample:
            ph, pw = skip.shape[-2] % 2, skip.shape[-1] % 2
            if ph or pw:
                skip = F.pad(skip, (0, pw, 0, ph))
            skip = F.max_pool2d(skip, 2, 2)
        return h + self.Norm_3(getattr(self, self.names[1])(skip))


class UpsamplingConcat(ChannelsLast):
    """2x bilinear upsample, concat [skip, x], 2 x (3x3 conv-norm-relu)."""

    def __init__(self, cin_up: int, cin_skip: int, cout: int, norm: str = 'gn',
                 scale_factor: int = 2):
        super().__init__()
        self.scale_factor = scale_factor
        self.Conv_0 = Conv2d(cin_skip + cin_up, cout, 3, bias=False)
        self.Norm_0 = Norm(cout, norm)
        self.Conv_1 = Conv2d(cout, cout, 3, bias=False)
        self.Norm_1 = Norm(cout, norm)

    def nchw(self, x_up, x_skip):
        x = upsample_bilinear(x_up, self.scale_factor)
        x = resize_bilinear(x, x_skip.shape[-2:])
        x = torch.cat([x_skip, x], 1)
        x = F.relu(self.Norm_0(self.Conv_0(x)))
        return F.relu(self.Norm_1(self.Conv_1(x)))


class UpsamplingAdd(ChannelsLast):
    """2x bilinear upsample -> 1x1 conv -> norm, + skip."""

    def __init__(self, cin: int, cout: int, norm: str = 'gn', scale_factor: int = 2):
        super().__init__()
        self.scale_factor = scale_factor
        self.Conv_0 = Conv2d(cin, cout, 1, bias=False)
        self.Norm_0 = Norm(cout, norm)

    def nchw(self, x, x_skip):
        x = upsample_bilinear(x, self.scale_factor)
        x = resize_bilinear(x, x_skip.shape[-2:])
        return self.Norm_0(self.Conv_0(x)) + x_skip


class ChunkedPointwise(Conv2d):
    """1x1 bias-free conv of a channel concat, computed per part with that
    part's input-channel slice of ONE kernel, so the concat (and the
    broadcast of a (B, C, 1, 1) part) never materialises."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 1, bias=False)

    def nchw(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        out, off = None, 0
        for p in parts:
            c = p.shape[1]
            y = self.conv(p, self.kernel[:, off:off + c])
            out = y if out is None else out + y
            off += c
        return out


class AtrousConv(Conv2d):
    """Bias-free dilated 3x3 (padding = rate). Taps that always fall
    outside a map smaller than the rate are sliced away, which computes
    the same result as the plain dilated conv with fewer taps."""

    def __init__(self, cin: int, cout: int, rate: int):
        super().__init__(cin, cout, 3, dilation=rate, bias=False)
        self.rate = rate

    def forward(self, x):
        h, w = x.shape[-2:]
        rows = slice(None) if self.rate < h else slice(1, 2)
        cols = slice(None) if self.rate < w else slice(1, 2)
        k = self.kernel[:, :, rows, cols]
        ph = self.rate if k.shape[2] == 3 else 0
        pw = self.rate if k.shape[3] == 3 else 0
        return self.conv(x, k, pads=((ph, ph), (pw, pw)))


class ASPP(ChannelsLast):
    """Atrous spatial pyramid pooling, then dropout 0.5 when ``nchw`` is
    given a generator (training)."""

    def __init__(self, cin: int, cout: int = 256, rates: Sequence[int] = (12, 24, 36),
                 norm: str = 'gn'):
        super().__init__()
        self.n_rates = len(rates)
        self.Conv_0 = Conv2d(cin, cout, 1, bias=False)
        for i, rate in enumerate(rates):
            setattr(self, f'Conv_{i + 1}', AtrousConv(cin, cout, rate))
        setattr(self, f'Conv_{len(rates) + 1}', Conv2d(cin, cout, 1, bias=False))
        self.Conv_5 = ChunkedPointwise(cout * (len(rates) + 2), cout)
        for i in range(len(rates) + 3):
            setattr(self, f'Norm_{i}', Norm(cout, norm))

    def nchw(self, x, rng: Optional[torch.Generator] = None):
        branches = [self.Conv_0] + [getattr(self, f'Conv_{i + 1}')
                                    for i in range(self.n_rates)]
        res = [F.relu(getattr(self, f'Norm_{i}')(conv(x)))
               for i, conv in enumerate(branches)]
        k = self.n_rates + 1
        g = x.mean((-2, -1), keepdim=True)
        res.append(F.relu(getattr(self, f'Norm_{k}')(getattr(self, f'Conv_{k}')(g))))
        h = F.relu(getattr(self, f'Norm_{k + 1}')(self.Conv_5.nchw(res)))
        return dropout(h, 0.5, rng)


class DeepLabHead(ChannelsLast):
    """ASPP -> 3x3 conv-norm-relu -> 1x1 conv (with bias)."""

    def __init__(self, cin: int, num_classes: int, hidden: int = 256, norm: str = 'gn'):
        super().__init__()
        self.ASPP_0 = ASPP(cin, hidden, norm=norm)
        self.Conv_0 = Conv2d(hidden, hidden, 3, bias=False)
        self.Norm_0 = Norm(hidden, norm)
        self.Conv_1 = Conv2d(hidden, num_classes, 1)

    def nchw(self, x, rng: Optional[torch.Generator] = None):
        x = self.ASPP_0.nchw(x, rng)
        return self.Conv_1(F.relu(self.Norm_0(self.Conv_0(x))))


class ConvNeXtBlock(ChannelsLast):
    """dwconv 7x7 -> LN -> pw 4x -> GELU -> pw -> gamma -> + skip.

    With a bf16 input the LN..skip tail runs as K2, the fused CUDA
    kernel (``ops/kernels/convnext_mlp``), whose math is exactly this
    block's bf16 function (tanh GELU, bf16 products, fp32 accumulation).
    With an fp32 input it takes the unfused path with exact-erf GELU, as
    the fp32 JAX block does: K2 rounds its matmul operands to bf16, so
    routing fp32 through it would silently lower the precision."""

    def __init__(self, dim: int, layer_scale_init_value: float = 1e-6):
        super().__init__()
        self.layer_scale_init_value = layer_scale_init_value
        self.Conv_0 = Conv2d(dim, dim, 7, groups=dim)
        self.LayerNorm_0 = LayerNorm(dim)
        self.Dense_0 = Dense(dim, 4 * dim)
        self.Dense_1 = Dense(4 * dim, dim)
        self.gamma = (nn.Parameter(torch.full((dim,), layer_scale_init_value))
                      if layer_scale_init_value > 0 else None)

    def reset_parameters(self, generator):
        if self.gamma is not None:
            with torch.no_grad():
                self.gamma.fill_(self.layer_scale_init_value)

    def nchw(self, x):
        b, c, hh, ww = x.shape
        h = to_last(self.Conv_0(x))                           # (B, H, W, C)
        x_last = to_last(x)
        if h.dtype == torch.bfloat16:
            gamma = self.gamma if self.gamma is not None else torch.ones_like(self.LayerNorm_0.scale)
            out = convnext_mlp(
                h.reshape(-1, c).contiguous(), x_last.reshape(-1, c).contiguous(),
                self.LayerNorm_0.scale, self.LayerNorm_0.bias,
                self.Dense_0.kernel.t(), self.Dense_0.bias,
                self.Dense_1.kernel.t(), self.Dense_1.bias, gamma)
            return to_first(out.reshape(b, hh, ww, c))
        h = self.Dense_1(gelu(self.Dense_0(self.LayerNorm_0(h))))
        if self.gamma is not None:
            h = self.gamma.to(common_dtype(h, self.gamma)) * h
        return to_first(x_last + h)


class Bottleblock(ChannelsLast):
    """7x7 -> LN -> GELU, 1x1 -> LN -> GELU, 3x3 -> LN -> GELU, with a
    GELU-projected residual when the width changes."""

    def __init__(self, cin: int, cout: Optional[int] = None):
        super().__init__()
        cout = cout or cin
        bneck = cin // 2
        self.Conv_0 = Conv2d(cin, bneck, 7, bias=False)
        self.LayerNorm_0 = LayerNorm(bneck)
        self.Conv_1 = Conv2d(bneck, bneck, 1, bias=False)
        self.LayerNorm_1 = LayerNorm(bneck)
        self.Conv_2 = Conv2d(bneck, cout, 3, bias=False)
        self.LayerNorm_2 = LayerNorm(cout)
        self.project = cout != cin
        if self.project:
            self.Conv_3 = Conv2d(cin, cout, 1, bias=False)

    def nchw(self, x):
        h = gelu(self.LayerNorm_0(self.Conv_0(x), dim=1))
        h = gelu(self.LayerNorm_1(self.Conv_1(h), dim=1))
        h = gelu(self.LayerNorm_2(self.Conv_2(h), dim=1))
        return h + (gelu(self.Conv_3(x)) if self.project else x)
