"""K1: the frame-batched BEV splat, a CUDA C++ kernel for Hopper.

Replaces ``stp3_tpu/ops/pallas/bev_pool_kernel.py::bev_pool_pallas_v2_batched``:
feats (F, P, C) and int32 ranks (F, P) in [0, ncells] -> (F, ncells, C),
each frame's points scatter-added onto their BEV cell in fp32 and cast
back to the feats' dtype; rank == ncells marks a point outside the grid,
which is dropped. The kernel is ``csrc/bev_pool.cu`` (its header says
what bounds it and why it is built the way it is); this module builds it
with nvcc at first use, binds it with ctypes and checks its arguments.

Dispatch is on the tensor's device: a CPU tensor takes the plain
version (``index_add_`` onto an (F, ncells + 1, C) fp32 buffer), a CUDA
tensor launches the kernel or raises. ``bev_splat_accumulate.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from stp3_tpu_torch.ops.kernels.nvcc_build import load_library

_LIB = None


def build() -> dict:
    """Build (or reuse) and bind the kernel library; returns the build info
    from ``nvcc_build.load_library``."""
    global _LIB
    lib, info = load_library('bev_pool', ['bev_pool.cu'])
    fn = lib.bev_splat_accumulate
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _LIB = fn
    return info


def _check(feats: torch.Tensor, ranks: torch.Tensor, ncells: int) -> None:
    if feats.ndim != 3 or ranks.shape != feats.shape[:2]:
        raise ValueError(f'feats (F, P, C) / ranks (F, P) expected, got '
                         f'{tuple(feats.shape)} / {tuple(ranks.shape)}')
    if feats.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'feats must be fp32 or bf16, got {feats.dtype}')
    if ranks.dtype != torch.int32:
        raise TypeError(f'ranks must be int32, got {ranks.dtype}')
    if feats.device != ranks.device:
        raise ValueError(f'feats on {feats.device}, ranks on {ranks.device}')
    if ncells <= 0:
        raise ValueError(f'ncells must be positive, got {ncells}')


def bev_splat_accumulate_plain(feats: torch.Tensor, ranks: torch.Tensor,
                               ncells: int) -> torch.Tensor:
    """Plain PyTorch version: (F, ncells, C) fp32 sums, via ``index_add_``
    onto ncells + 1 rows whose last (overflow) row is then dropped."""
    f, p, c = feats.shape
    acc = torch.zeros(f, ncells + 1, c, dtype=torch.float32, device=feats.device)
    idx = (ranks.long() + torch.arange(f, device=feats.device)[:, None] * (ncells + 1))
    acc.view(-1, c).index_add_(0, idx.reshape(-1), feats.reshape(-1, c).float())
    return acc[:, :ncells]


def bev_splat_accumulate(feats: torch.Tensor, ranks: torch.Tensor,
                         ncells: int) -> torch.Tensor:
    """(F, ncells, C) fp32 per-frame sums; the kernel on CUDA tensors."""
    _check(feats, ranks, ncells)
    if feats.device.type == 'cpu':
        return bev_splat_accumulate_plain(feats, ranks, ncells)
    if feats.device.type != 'cuda':
        raise RuntimeError(f'bev_splat: no kernel for device {feats.device}')
    if not (feats.is_contiguous() and ranks.is_contiguous()):
        raise ValueError('feats and ranks must be contiguous')
    if _LIB is None:
        build()
    f, p, c = feats.shape
    acc = torch.zeros(f, ncells, c, dtype=torch.float32, device=feats.device)
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _LIB(feats.data_ptr(), 0 if feats.dtype == torch.float32 else 1,
                   ranks.data_ptr(), acc.data_ptr(), f, p, c, ncells, stream)
    if err != 0:
        raise RuntimeError(f'bev_splat kernel launch failed: cudaError {err}')
    bev_splat_accumulate.launches += 1
    return acc


bev_splat_accumulate.launches = 0


def bev_splat(feats: torch.Tensor, ranks: torch.Tensor, ncells: int) -> torch.Tensor:
    """The K1 function: (F, ncells, C) in feats' dtype."""
    return bev_splat_accumulate(feats, ranks, ncells).to(feats.dtype)


def bev_splat_plain(feats: torch.Tensor, ranks: torch.Tensor, ncells: int) -> torch.Tensor:
    return bev_splat_accumulate_plain(feats, ranks, ncells).to(feats.dtype)
