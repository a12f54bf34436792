"""K4, the fused lift + splat: a CUDA C++ kernel for Hopper.

K4 replaces ``stp3_tpu/ops/pallas/bev_pool_kernel.py::lift_splat_pallas``:
out[rank[p]] += depth_prob[p] * ctx[ray[p]], the depth-softmax x context
outer product of the LSS lift fused into the BEV scatter, so the lifted
(P, C) rows never exist. Frame-batched here: ctx (F, R, C), depth_prob
and int32 ranks (F, P) in [0, ncells], int32 ray ids (P,) in [0, R)
shared by every frame -> (F, ncells, C), fp32 sums cast to ctx's dtype;
rank == ncells marks a point outside the grid, which is dropped. Each
frame's function is the JAX one, and all frames are one launch.

The kernel is ``csrc/lift_splat.cu`` (its comments say what bounds it and
why it is built the way it is); this module builds it with nvcc at first
use, binds it with ctypes and checks the arguments. Like K1 it sorts each
tile of ``TILE`` consecutive points of a frame by rank, sums each run of
equal ranks in registers (each row dp x ctx[ray] formed there) and adds
it with one vector atomic per 4 channels, so it makes
``bev_splat.atomic_rows_per_landed_point(ranks, ncells, TILE)`` atomic
rows per landed point. ``LiftSplat`` is a
``torch.autograd.Function`` whose forward is K4 and whose backward is the
JAX package's ``_ls_bwd`` (plain XLA there, plain PyTorch here): the
cotangent rows g[rank] (K3, ``gather_rows``, on CUDA), d ctx summed over
ray ids with ``index_add_``, d depth_prob as a row-wise dot product.

Dispatch is on the tensor's device: a CPU tensor takes the plain version
(gather the ctx rows, scale by depth_prob, ``index_add_`` onto ncells + 1
fp32 rows), a CUDA tensor launches the kernel or raises.
``lift_splat_accumulate.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from stp3_tpu_torch.ops.kernels.bev_splat import gather_rows
from stp3_tpu_torch.ops.kernels.nvcc_build import load_library

_LIB = {}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# K4's points per block, kTile in csrc/lift_splat.cu
TILE = 1024


def build() -> dict:
    """Build (or reuse) and bind the kernel library; returns the build info
    from ``nvcc_build.load_library``."""
    lib, info = load_library('lift_splat', ['lift_splat.cu'])
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn = lib.lift_splat_accumulate
    fn.argtypes = [ptr, i32, ptr, i32, ptr, ptr, ptr, i32, i64, i32, i32, i32, ptr]
    fn.restype = ctypes.c_int
    _LIB['lift_splat_accumulate'] = fn
    return info


def _check(ctx: torch.Tensor, depth_prob: torch.Tensor, ranks: torch.Tensor,
           ray_ids: torch.Tensor, ncells: int) -> None:
    if (ctx.ndim != 3 or depth_prob.ndim != 2 or ranks.shape != depth_prob.shape
            or ranks.shape[0] != ctx.shape[0] or ray_ids.shape != ranks.shape[1:]):
        raise ValueError(f'ctx (F, R, C), depth_prob and ranks (F, P), ray_ids (P,) '
                         f'expected, got {tuple(ctx.shape)}, {tuple(depth_prob.shape)}, '
                         f'{tuple(ranks.shape)}, {tuple(ray_ids.shape)}')
    # float64 only on the CPU (the plain version): the kernel takes fp32 and bf16
    dtypes = tuple(_DTYPE_CODE) + ((torch.float64,) if ctx.device.type == 'cpu' else ())
    for name, t in (('ctx', ctx), ('depth_prob', depth_prob)):
        if t.dtype not in dtypes:
            raise TypeError(f'{name} on {t.device} must be one of {dtypes}, got {t.dtype}')
    for name, t in (('ranks', ranks), ('ray_ids', ray_ids)):
        if t.dtype != torch.int32:
            raise TypeError(f'{name} must be int32, got {t.dtype}')
    if len({t.device for t in (ctx, depth_prob, ranks, ray_ids)}) != 1:
        raise ValueError('ctx, depth_prob, ranks and ray_ids must be on one device')
    if ncells <= 0:
        raise ValueError(f'ncells must be positive, got {ncells}')


def lift_splat_accumulate_plain(ctx: torch.Tensor, depth_prob: torch.Tensor,
                                ranks: torch.Tensor, ray_ids: torch.Tensor,
                                ncells: int) -> torch.Tensor:
    """Plain PyTorch version: (F, ncells, C) fp32 sums (float64 for float64
    inputs), via ``index_add_`` of dp * ctx[ray] onto ncells + 1 rows whose
    last (overflow) row is then dropped."""
    f, _, c = ctx.shape
    dt = torch.promote_types(torch.promote_types(ctx.dtype, depth_prob.dtype), torch.float32)
    rows = ctx.to(dt)[:, ray_ids.long()] * depth_prob.to(dt)[..., None]     # (F, P, C)
    acc = torch.zeros(f, ncells + 1, c, dtype=dt, device=ctx.device)
    idx = ranks.long() + torch.arange(f, device=ctx.device)[:, None] * (ncells + 1)
    acc.view(-1, c).index_add_(0, idx.reshape(-1), rows.reshape(-1, c))
    return acc[:, :ncells]


def lift_splat_accumulate(ctx: torch.Tensor, depth_prob: torch.Tensor, ranks: torch.Tensor,
                          ray_ids: torch.Tensor, ncells: int) -> torch.Tensor:
    """(F, ncells, C) fp32 per-frame sums; the kernel on CUDA tensors."""
    _check(ctx, depth_prob, ranks, ray_ids, ncells)
    if ctx.device.type == 'cpu':
        return lift_splat_accumulate_plain(ctx, depth_prob, ranks, ray_ids, ncells)
    if ctx.device.type != 'cuda':
        raise RuntimeError(f'no kernel for device {ctx.device}')
    if not all(t.is_contiguous() for t in (ctx, depth_prob, ranks, ray_ids)):
        raise ValueError('kernel operands must be contiguous')
    if 'lift_splat_accumulate' not in _LIB:
        build()
    f, r, c = ctx.shape
    p = ranks.shape[1]
    acc = torch.zeros(f, ncells, c, dtype=torch.float32, device=ctx.device)
    with torch.cuda.device(ctx.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _LIB['lift_splat_accumulate'](
            ctx.data_ptr(), _DTYPE_CODE[ctx.dtype], depth_prob.data_ptr(),
            _DTYPE_CODE[depth_prob.dtype], ranks.data_ptr(), ray_ids.data_ptr(),
            acc.data_ptr(), f, p, r, c, ncells, stream)
    if err != 0:
        raise RuntimeError(f'lift_splat kernel launch failed: cudaError {err}')
    lift_splat_accumulate.launches += 1
    return acc


lift_splat_accumulate.launches = 0


def lift_splat_plain(ctx: torch.Tensor, depth_prob: torch.Tensor, ranks: torch.Tensor,
                     ray_ids: torch.Tensor, ncells: int) -> torch.Tensor:
    return lift_splat_accumulate_plain(ctx, depth_prob, ranks, ray_ids, ncells).to(ctx.dtype)


class LiftSplat(torch.autograd.Function):
    """K4 forward; the backward of ``_ls_bwd`` (casts as there: the
    cotangent in fp32, d ctx in ctx's dtype, d depth_prob in its own).
    The ranks and ray ids get no gradient."""

    @staticmethod
    def forward(ctx_, ctx, depth_prob, ranks, ray_ids, ncells):
        ctx_.save_for_backward(ctx, depth_prob, ranks, ray_ids)
        return lift_splat_accumulate(ctx, depth_prob, ranks, ray_ids, ncells).to(ctx.dtype)

    @staticmethod
    def backward(ctx_, g):
        ctx, depth_prob, ranks, ray_ids = ctx_.saved_tensors
        dt = torch.promote_types(g.dtype, torch.float32)
        g_rows = gather_rows(g.to(dt).contiguous(), ranks)          # (F, P, C), 0 if dropped
        ray = ray_ids.long()
        d_ctx = torch.zeros(ctx.shape, dtype=dt, device=ctx.device)
        d_ctx.index_add_(1, ray, depth_prob.to(dt)[..., None] * g_rows)
        d_dp = (g_rows * ctx.to(dt)[:, ray]).sum(-1)
        return d_ctx.to(ctx.dtype), d_dp.to(depth_prob.dtype), None, None, None


def lift_splat_frames(ctx: torch.Tensor, depth_prob: torch.Tensor, ranks: torch.Tensor,
                      ray_ids: torch.Tensor, ncells: int) -> torch.Tensor:
    """The K4 function for F frames in one launch: ctx (F, R, C),
    depth_prob (F, P), ranks (F, P), ray_ids (P,) -> (F, ncells, C) in
    ctx's dtype, differentiable in ctx and depth_prob."""
    return LiftSplat.apply(ctx, depth_prob, ranks, ray_ids, ncells)


def lift_splat(ctx: torch.Tensor, depth_prob: torch.Tensor, ranks: torch.Tensor,
               ray_ids: torch.Tensor, ncells: int) -> torch.Tensor:
    """``lift_splat_pallas``'s signature, one frame: ctx (R, C), depth_prob,
    ranks and ray_ids (P,) -> (ncells, C) in ctx's dtype."""
    if ctx.ndim != 2 or depth_prob.ndim != 1:
        raise ValueError(f'ctx (R, C) and depth_prob (P,) expected, got {tuple(ctx.shape)} '
                         f'and {tuple(depth_prob.shape)}')
    return lift_splat_frames(ctx[None], depth_prob[None], ranks[None], ray_ids, ncells)[0]
