"""K1, the frame-batched BEV splat, and K3, its backward: CUDA C++ kernels
for Hopper.

K1 replaces ``stp3_tpu/ops/pallas/bev_pool_kernel.py::bev_pool_pallas_v2_batched``:
feats (F, P, C) and int32 ranks (F, P) in [0, ncells] -> (F, ncells, C),
each frame's points scatter-added onto their BEV cell in fp32 and cast
back to the feats' dtype; rank == ncells marks a point outside the grid,
which is dropped.

K3 replaces ``gather_rows_pallas`` of the same file, the row gather that
the splat's VJP runs: dfeats[f, p] = g[f, ranks[f, p]], zero for a
dropped point.

Both kernels are ``csrc/bev_pool.cu`` (its comments say what bounds each
and why it is built the way it is); this module builds that file with
nvcc at first use, binds it with ctypes and checks the arguments. K1
sorts each tile of ``TILE`` consecutive points by rank and adds each run
of equal ranks with one vector atomic per lane;
``atomic_rows_per_landed_point`` counts those runs from the ranks.
``bev_splat`` is a ``torch.autograd.Function`` whose forward is K1 and
whose backward is K3.

The JAX package's two per-frame kernels compute K1's function at F=1 and
are entries on K1's kernel here: ``bev_pool_v1`` replaces
``bev_pool_pallas`` (v1) and ``bev_pool_v2`` replaces
``bev_pool_pallas_v2`` (v2). Their backward is K3 at F=1, which is the
function of both JAX VJPs (``_bwd`` and ``_bwd_v2``).

Dispatch is on the tensor's device: a CPU tensor takes the plain version
(``index_add_`` onto an (F, ncells + 1, C) fp32 buffer; ``torch.gather``
from a zero-padded table), a CUDA tensor launches the kernel or raises.
``bev_splat_accumulate.launches``, ``bev_pool_v1.launches``,
``bev_pool_v2.launches`` and ``gather_rows.launches`` count kernel
launches, each by the entry that made it.
"""
from __future__ import annotations

import ctypes

import torch

from stp3_tpu_torch.ops.kernels.nvcc_build import load_library

_LIB = {}
# K1's points per block, kTile in csrc/bev_pool.cu
TILE = 1024


def build() -> dict:
    """Build (or reuse) and bind the kernel library; returns the build info
    from ``nvcc_build.load_library``."""
    lib, info = load_library('bev_pool', ['bev_pool.cu'])
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for name, argtypes in (
            ('bev_splat_accumulate', [ptr, i32, ptr, ptr, i32, i64, i32, i32, ptr]),
            ('gather_rows', [ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr])):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LIB[name] = fn
    return info


def _kernel(name: str):
    if name not in _LIB:
        build()
    return _LIB[name]


def _check(feats: torch.Tensor, ranks: torch.Tensor) -> None:
    if feats.ndim != 3 or ranks.ndim != 2 or ranks.shape[0] != feats.shape[0]:
        raise ValueError(f'(F, *, C) rows / (F, P) ranks expected, got '
                         f'{tuple(feats.shape)} / {tuple(ranks.shape)}')
    # float64 only on the CPU (the plain versions): the kernels take fp32 and bf16
    dtypes = (torch.float32, torch.bfloat16) + (
        (torch.float64,) if feats.device.type == 'cpu' else ())
    if feats.dtype not in dtypes:
        raise TypeError(f'rows on {feats.device} must be one of {dtypes}, got {feats.dtype}')
    if ranks.dtype != torch.int32:
        raise TypeError(f'ranks must be int32, got {ranks.dtype}')
    if feats.device != ranks.device:
        raise ValueError(f'rows on {feats.device}, ranks on {ranks.device}')


def _cuda_launch_ready(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != 'cuda':
        raise RuntimeError(f'no kernel for device {dev}')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('kernel operands must be contiguous')


# ----------------------------------------------------------------- K1
def overflow_out_of_range(ranks: torch.Tensor, ncells: int) -> torch.Tensor:
    """int64 ranks with every rank outside [0, ncells) set to ncells, the
    overflow row that the plain versions drop."""
    return torch.where((ranks >= 0) & (ranks < ncells), ranks, ncells).long()


def bev_splat_accumulate_plain(feats: torch.Tensor, ranks: torch.Tensor,
                               ncells: int) -> torch.Tensor:
    """Plain PyTorch version: (F, ncells, C) fp32 sums (float64 for float64
    rows), via ``index_add_`` onto ncells + 1 rows a frame whose last
    (overflow) row is then dropped. A rank outside [0, ncells) goes to the
    overflow row of its own frame: dropped, as the kernel drops it."""
    f, p, c = feats.shape
    dt = torch.promote_types(feats.dtype, torch.float32)
    acc = torch.zeros(f, ncells + 1, c, dtype=dt, device=feats.device)
    idx = (overflow_out_of_range(ranks, ncells)
           + torch.arange(f, device=feats.device)[:, None] * (ncells + 1))
    acc.view(-1, c).index_add_(0, idx.reshape(-1), feats.reshape(-1, c).to(dt))
    return acc[:, :ncells]


def bev_splat_accumulate(feats: torch.Tensor, ranks: torch.Tensor,
                         ncells: int) -> torch.Tensor:
    """(F, ncells, C) fp32 per-frame sums; the kernel on CUDA tensors."""
    return _accumulate(feats, ranks, ncells, bev_splat_accumulate)


def atomic_rows_per_landed_point(ranks: torch.Tensor, ncells: int, tile: int = TILE) -> float:
    """K1's atomic rows per landed point: the distinct (tile, rank) pairs
    of the points that land (rank in [0, ncells)), over those points, for
    tiles of ``tile`` consecutive points of each frame of (F, P) ``ranks``.
    Each such pair is one run of the kernel, which adds its row with one
    vector atomic a lane. 0.0 when no point lands."""
    f, p = ranks.shape
    lands = (ranks >= 0) & (ranks < ncells)
    n = int(lands.sum())
    if n == 0:
        return 0.0
    n_tiles = -(-p // tile)
    tile_of = (torch.arange(f, device=ranks.device)[:, None] * n_tiles
               + torch.arange(p, device=ranks.device)[None] // tile)
    pairs = tile_of * ncells + ranks.long()
    return torch.unique(pairs[lands]).numel() / n


def _accumulate(feats: torch.Tensor, ranks: torch.Tensor, ncells: int,
                entry) -> torch.Tensor:
    """K1 for the entry point ``entry``, whose launch count it raises."""
    _check(feats, ranks)
    if ranks.shape != feats.shape[:2]:
        raise ValueError(f'ranks {tuple(ranks.shape)} != feats[:2] {tuple(feats.shape[:2])}')
    if ncells <= 0:
        raise ValueError(f'ncells must be positive, got {ncells}')
    if feats.device.type == 'cpu':
        return bev_splat_accumulate_plain(feats, ranks, ncells)
    _cuda_launch_ready(feats, ranks)
    f, p, c = feats.shape
    acc = torch.zeros(f, ncells, c, dtype=torch.float32, device=feats.device)
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel('bev_splat_accumulate')(
            feats.data_ptr(), 0 if feats.dtype == torch.float32 else 1,
            ranks.data_ptr(), acc.data_ptr(), f, p, c, ncells, stream)
    if err != 0:
        raise RuntimeError(f'bev_splat kernel launch failed: cudaError {err}')
    entry.launches += 1
    return acc


bev_splat_accumulate.launches = 0


def bev_splat_plain(feats: torch.Tensor, ranks: torch.Tensor, ncells: int) -> torch.Tensor:
    return bev_splat_accumulate_plain(feats, ranks, ncells).to(feats.dtype)


# ----------------------------------------------------------------- K3
def gather_rows_plain(table: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``torch.gather`` from the table with a zero
    row appended, every rank outside [0, ncells) sent to that row."""
    f, ncells, c = table.shape
    padded = torch.cat([table, table.new_zeros(f, 1, c)], 1)
    idx = torch.where((ranks >= 0) & (ranks < ncells), ranks, ncells).long()
    return torch.gather(padded, 1, idx[..., None].expand(-1, -1, c))


def gather_rows(table: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """table (F, ncells, C) fp32 or bf16; ranks (F, P) int32 -> (F, P, C)
    in the table's dtype: out[f, p] = table[f, ranks[f, p]], zeros for a
    rank outside [0, ncells). The kernel on CUDA tensors."""
    _check(table, ranks)
    if table.device.type == 'cpu':
        return gather_rows_plain(table, ranks)
    _cuda_launch_ready(table, ranks)
    f, ncells, c = table.shape
    p = ranks.shape[1]
    out = torch.empty(f, p, c, dtype=table.dtype, device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel('gather_rows')(table.data_ptr(), ranks.data_ptr(), out.data_ptr(),
                                     f, p, c, table.element_size(), ncells, stream)
    if err != 0:
        raise RuntimeError(f'gather_rows kernel launch failed: cudaError {err}')
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


# ------------------------------------------------------------ autograd
class BevSplat(torch.autograd.Function):
    """K1 forward, K3 backward (the JAX package's ``_bwd_v2b``); the ranks
    get no gradient. ``entry`` is the entry point whose launch count the
    forward raises."""

    @staticmethod
    def forward(ctx, feats, ranks, ncells, entry):
        ctx.save_for_backward(ranks)
        return _accumulate(feats, ranks, ncells, entry).to(feats.dtype)

    @staticmethod
    def backward(ctx, g):
        ranks, = ctx.saved_tensors
        return gather_rows(g.contiguous(), ranks), None, None, None


def bev_splat(feats: torch.Tensor, ranks: torch.Tensor, ncells: int) -> torch.Tensor:
    """The K1 function: (F, ncells, C) in feats' dtype, differentiable in
    feats through K3."""
    return BevSplat.apply(feats, ranks, ncells, bev_splat_accumulate)


def _one_frame(feats: torch.Tensor, ranks: torch.Tensor, ncells: int, entry) -> torch.Tensor:
    if feats.ndim != 2 or ranks.ndim != 1:
        raise ValueError(f'(P, C) rows / (P,) ranks expected, got {tuple(feats.shape)} / '
                         f'{tuple(ranks.shape)}')
    return BevSplat.apply(feats[None], ranks[None], ncells, entry)[0]


def bev_pool_v1(feats: torch.Tensor, ranks: torch.Tensor, ncells: int) -> torch.Tensor:
    """``bev_pool_pallas``'s function: feats (P, C) fp32 or bf16, ranks (P,)
    int32 in [0, ncells] -> (ncells, C) in feats' dtype (fp32 sums),
    differentiable in feats; K1 at F=1 on CUDA tensors."""
    return _one_frame(feats, ranks, ncells, bev_pool_v1)


def bev_pool_v2(feats: torch.Tensor, ranks: torch.Tensor, ncells: int) -> torch.Tensor:
    """``bev_pool_pallas_v2``'s function (the same as v1's); K1 at F=1 on
    CUDA tensors, counted apart."""
    return _one_frame(feats, ranks, ncells, bev_pool_v2)


bev_pool_v1.launches = 0
bev_pool_v2.launches = 0
