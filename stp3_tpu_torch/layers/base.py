"""Parameter-owning leaf modules and the port's layout conventions.

Every leaf names its parameters after the flax leaf it mirrors
(``kernel``, ``bias``, ``scale``) and stores them in PyTorch's own layout
(OIHW convs, (out, in) dense kernels). ``flax_leaf`` converts one flax
array into that layout and ``to_flax_leaf`` back, exactly, which is all
``utils/from_flax.py`` needs.

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

import contextlib
import functools
import math
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from stp3_tpu_torch.parallel.mesh import differentiable_all_reduce

Padding = Union[str, Tuple[Tuple[int, int], Tuple[int, int]]]


def to_first(x: torch.Tensor) -> torch.Tensor:
    """(B, ..., C) channels-last -> (B, C, ...) channels-first view."""
    return x.movedim(-1, 1)


def to_last(x: torch.Tensor) -> torch.Tensor:
    """(B, C, ...) channels-first -> (B, ..., C) channels-last view."""
    return x.movedim(1, -1)


def stats_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype of a norm's statistics: fp32, or the input's if wider."""
    return torch.promote_types(x.dtype, torch.float32)


def common_dtype(*tensors: torch.Tensor) -> torch.dtype:
    """flax's ``dtype=None`` rule: compute in the promoted type of input
    and params (bf16 input with fp32 params computes in fp32)."""
    dt = tensors[0].dtype
    for t in tensors[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return dt


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            mask_shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """flax ``nn.Dropout`` in training: keep each element (or each slice of
    ``mask_shape``, which broadcasts against x) with probability 1 - rate
    and scale the kept ones by 1 / (1 - rate). The masks come from
    ``generator``; without one (eval) it is the identity."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    shape = x.shape if mask_shape is None else mask_shape
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


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

    @staticmethod
    def to_flax_leaf(name: str, arr: np.ndarray) -> np.ndarray:
        return arr.transpose(2, 3, 1, 0) if name == 'kernel' else arr   # OIHW -> HWIO

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


class ConvTranspose2d(nn.Module):
    """flax ``nn.ConvTranspose`` over NCHW: the input dilated by ``stride``
    (zeros between its pixels), padded by ``padding`` (flax's 'SAME' rule,
    or explicit ((top, bottom), (left, right))), then correlated with the
    kernel. The kernel is stored in torch's ConvTranspose2d layout (in,
    out, kh, kw); ``transpose_kernel`` says whether the flax kernel is
    torch's (flipped, (kh, kw, out, in)) or a plain HWIO conv kernel."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int = 1,
                 padding: Padding = 'SAME', bias: bool = True, transpose_kernel: bool = False):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.transpose_kernel = transpose_kernel
        self.kernel = nn.Parameter(torch.zeros(cin, cout, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        i, o, kh, kw = self.kernel.shape
        # flax's fan-in of the kernel it creates: (kh, kw, out, in) when
        # transposed, else (kh, kw, in, out)
        lecun_normal_(self.kernel, (o if self.transpose_kernel else i) * kh * kw, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def flax_leaf(self, name: str, arr: np.ndarray) -> np.ndarray:
        if name != 'kernel':
            return arr
        # torch layout W[i, o, a, b]: the correlation kernel is W flipped
        # with its channel axes swapped
        return arr.transpose(3, 2, 0, 1) if self.transpose_kernel else (
            arr[::-1, ::-1].transpose(2, 3, 0, 1))

    def to_flax_leaf(self, name: str, arr: np.ndarray) -> np.ndarray:
        if name != 'kernel':
            return arr
        return arr.transpose(2, 3, 1, 0) if self.transpose_kernel else (
            arr.transpose(2, 3, 0, 1)[::-1, ::-1])

    def pads(self, k: int) -> Tuple[int, int]:
        """lax.conv_transpose's 'SAME' padding of one spatial axis."""
        s = self.stride
        pad_len = k + s - 2
        before = k - 1 if s > k - 1 else -(-pad_len // 2)
        return before, pad_len - before

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kh, kw = self.kernel.shape[-2:]
        (pt, pb), (pl, pr) = ((self.pads(kh), self.pads(kw)) if self.padding == 'SAME'
                              else self.padding)
        dt = common_dtype(x, self.kernel)
        s = self.stride
        b, c, h, w = x.shape
        if s > 1:
            dilated = x.new_zeros(b, c, (h - 1) * s + 1, (w - 1) * s + 1, dtype=dt)
            dilated[..., ::s, ::s] = x
            x = dilated
        x = F.pad(x.to(dt), (pl, pr, pt, pb))
        kernel = self.kernel.to(dt).flip(-2, -1).transpose(0, 1)
        bias = self.bias.to(dt) if self.bias is not None else None
        return F.conv2d(x, kernel, bias)


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

    @staticmethod
    def to_flax_leaf(name: str, arr: np.ndarray) -> np.ndarray:
        return arr.T if name == 'kernel' else arr   # (O, I) -> (I, O)

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
    fp32 stats (float64 for a float64 input) from per-channel sum /
    sum-of-squares, var = E[x^2] - E[x]^2, applied as one per-channel
    multiply-add in the promoted dtype.
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
        st = stats_dtype(x)
        x32 = x.to(st)
        s1 = x32.sum(red)
        s2 = (x32 * x32).sum(red)
        n = (x.numel() // (b * c)) * (c // g)
        mean = s1.reshape(b, g, c // g).sum(-1) / n
        var = s2.reshape(b, g, c // g).sum(-1) / n - mean * mean
        inv = torch.rsqrt(var + self.eps)
        a = inv.repeat_interleave(c // g, -1) * self.scale.to(st)
        b2 = self.bias.to(st) - mean.repeat_interleave(c // g, -1) * a
        shape = (b, c) + (1,) * (x.ndim - 2)
        dt = common_dtype(x, self.scale)
        return x.to(dt) * a.reshape(shape).to(dt) + b2.reshape(shape).to(dt)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: eps 1e-6 (torch's default is 1e-5), fp32
    stats (float64 for a float64 input) with var = max(E[x^2] - E[x]^2,
    0), result in the promoted dtype of input and params. Normalises over
    axis ``dim``."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    reset_parameters = GroupNorm.reset_parameters

    def forward(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        st = stats_dtype(x)
        x32 = x.to(st)
        mean = x32.mean(dim, keepdim=True)
        var = ((x32 * x32).mean(dim, keepdim=True) - mean * mean).clamp_min(0.0)
        shape = [1] * x.ndim
        shape[dim] = x.shape[dim]
        mul = torch.rsqrt(var + self.eps) * self.scale.to(st).reshape(shape)
        y = (x32 - mean) * mul + self.bias.to(st).reshape(shape)
        return y.to(common_dtype(x, self.scale))


NORM_KINDS = ('gn', 'ln', 'none', 'bn', 'bn_frozen')


class Norm(nn.Module):
    """``stp3_tpu.layers.convolutions.Norm``. Channels-first input.

    'gn' (child ``GroupNorm_0``), 'ln' (child ``LayerNorm_0``), 'none';
    and the BatchNorm kinds, whose leaves sit on the Norm itself as in
    flax: parameters ``scale`` and ``bias``, buffers ``mean`` and ``var``.

    'bn': in training (the module's ``training`` flag) the batch's
    statistics, in fp32 (float64 for a float64 input) over every non-channel
    axis, var = max(E[x^2] - mean^2, 0); the running statistics move by
    ``momentum`` in torch's convention (new = (1 - m) old + m batch, with
    the unbiased variance) unless ``update_running`` is off (the encoder's
    recomputation under REMAT, ``running_stats_frozen``). In eval, the
    running statistics. 'bn_frozen': always the running statistics, which
    are buffers, so the optimizer, the weight decay and the gradient clip
    never see them (the JAX trainer masks them out with ``optax.masked``).
    ``momentum`` is set from MODEL.BN_MOMENTUM by the model that owns the
    site. ``group`` (a process group, set by a data-parallel
    ``Trainer``): the batch statistics are of the global batch, Σx, Σx²
    and the count summed over the ranks with one differentiable
    all-reduce (SyncBatchNorm's semantics; stp3_tpu's 'bn' under its
    batch-sharded jit computes the same global statistics), so the
    unbiased correction takes the global count and the running statistics
    stay equal on every rank. Under REMAT 'encoder' the recomputation
    joins the all-reduce again on every rank (each rank recomputes), and
    moves no running statistic. ``eps`` (1e-5; 1e-3 at the EfficientNet sites) belongs to the
    BatchNorm kinds only.

    Either way ``inv = rsqrt(var + eps) * scale`` is formed in the
    statistics' type and cast, with the mean and the bias, to the input's
    dtype: ``(x - mean) * inv + bias`` in that dtype, as the JAX layer
    computes it."""

    def __init__(self, channels: int, kind: str = 'gn', groups: int = 8,
                 eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        if kind not in NORM_KINDS:
            raise ValueError(f'unknown norm kind {kind!r}')
        self.kind, self.eps, self.momentum = kind, eps, momentum
        self.update_running = True
        self.group = None
        if kind == 'gn':
            self.GroupNorm_0 = GroupNorm(channels, num_groups(channels, groups))
        elif kind == 'ln':
            self.LayerNorm_0 = LayerNorm(channels)
        elif kind in ('bn', 'bn_frozen'):
            self.scale = nn.Parameter(torch.ones(channels))
            self.bias = nn.Parameter(torch.zeros(channels))
            self.register_buffer('mean', torch.zeros(channels))
            self.register_buffer('var', torch.ones(channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.kind in ('bn', 'bn_frozen'):
            with torch.no_grad():
                self.scale.fill_(1.0)
                self.bias.zero_()
                self.mean.zero_()
                self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == 'gn':
            return self.GroupNorm_0(x)
        if self.kind == 'ln':
            return self.LayerNorm_0(x, dim=1)
        if self.kind == 'none':
            return x
        if self.kind == 'bn' and self.training:
            mean, var = self._batch_stats(x)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.eps) * self.scale
        shape = (1, x.shape[1]) + (1,) * (x.ndim - 2)
        return ((x - mean.to(x.dtype).reshape(shape)) * inv.to(x.dtype).reshape(shape)
                + self.bias.to(x.dtype).reshape(shape))

    def _batch_stats(self, x: torch.Tensor):
        red = (0,) + tuple(range(2, x.ndim))
        x32 = x.to(stats_dtype(x))
        n = x.numel() // x.shape[1]
        if self.group is None:
            mean = x32.mean(red)
            mean_sq = (x32 * x32).mean(red)
            unbiased = n / max(n - 1, 1)
        else:
            c = x.shape[1]
            sums = differentiable_all_reduce(torch.cat(
                [x32.sum(red), (x32 * x32).sum(red), x32.new_full((1,), n)]), self.group)
            n = sums[2 * c:].detach()
            mean, mean_sq = sums[:c] / n, sums[c:2 * c] / n
            unbiased = n / (n - 1).clamp_min(1)
        var = (mean_sq - mean * mean).clamp_min(0.0)
        if self.update_running:
            m = self.momentum
            with torch.no_grad():
                self.mean.mul_(1.0 - m).add_(m * mean.to(self.mean.dtype))
                self.var.mul_(1.0 - m).add_(m * (var * unbiased).to(self.var.dtype))
        return mean, var



def batch_norms(module: nn.Module):
    """Every 'bn' Norm site in ``module`` (the ones with running updates)."""
    return [m for m in module.modules() if isinstance(m, Norm) and m.kind == 'bn']


@contextlib.contextmanager
def running_stats_frozen(module: nn.Module):
    """Within: the 'bn' sites of ``module`` normalise with their batch's
    statistics but leave their running statistics alone (a recomputation
    of a forward that has already updated them once)."""
    sites = batch_norms(module)
    before = [m.update_running for m in sites]
    for m in sites:
        m.update_running = False
    try:
        yield
    finally:
        for m, flag in zip(sites, before):
            m.update_running = flag


class _Bound(nn.Module):
    """``module.<method>`` as the ``forward`` of a module, for
    ``functional_call``."""

    def __init__(self, module: nn.Module, method: str):
        super().__init__()
        self.m, self.method = module, method

    def forward(self, *args):
        return getattr(self.m, self.method)(*args)


def remat(module: nn.Module, method: str, *args, policy: Optional[Callable] = None):
    """``getattr(module, method)(*args)`` with its activations recomputed in
    the backward (``torch.utils.checkpoint``, non-reentrant); a plain call
    when autograd is off. ``policy``: a selective checkpoint
    (``create_selective_checkpoint_contexts``) that keeps what it marks
    saved and recomputes the rest.

    The recomputation must see what the forward saw:
      * the module's parameters as they are at the call (under a caller's
        ``functional_call``, its e.g. bf16 copies), passed into the
        checkpoint, since the backward runs after that call has restored
        the module's own;
      * the random numbers: every ``torch.Generator`` among ``args`` is
        set back to its state at the call for the recomputation, and
        restored after it;
      * its 'bn' sites normalise with the batch's statistics again (the
        same values: the same input) without a second running update.

    A kernel launched through ctypes (K2) is no aten op, so no policy
    sees it: it runs again in the recomputation."""
    if not torch.is_grad_enabled():
        return getattr(module, method)(*args)
    bound = _Bound(module, method)
    params = {f'm.{k}': v for k, v in module.named_parameters()}
    gens = [a for a in args if isinstance(a, torch.Generator)]
    start = [g.get_state() for g in gens]
    ran = []

    def run(params, *xs):
        if not ran:
            ran.append(True)
            return functional_call(bound, params, xs)
        now = [g.get_state() for g in gens]
        for g, s in zip(gens, start):
            g.set_state(s)
        try:
            with running_stats_frozen(module):
                return functional_call(bound, params, xs)
        finally:
            for g, s in zip(gens, now):
                g.set_state(s)

    kw = {} if policy is None else {
        'context_fn': functools.partial(create_selective_checkpoint_contexts, policy)}
    return checkpoint(run, params, *args, use_reentrant=False, preserve_rng_state=False, **kw)


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
