"""Operations and bytes of the port's kernels at a step's own shapes and
ranks: each input byte the kernel needs read once, each output byte
written once (the arithmetic of ``chip_smoke.py``'s ``bound()`` phases,
for the kernel alone rather than its wrapper).

- K1 ``splat_tile_kernel`` (``csrc/bev_pool.cu``): every rank, the rows of
  the points that land in the grid, and the fp32 sums of the cells some
  point lands on (the accumulator is zeroed by another kernel); one add
  per channel of each landed point, in fp32.
- K2 ``convnext_mlp_kernel`` (``csrc/convnext_mlp.cu``): h and x read, y
  written, the weights read; two (N, C) x (C, 4C)-sized products at two
  operations a multiply-add, on the bf16 tensor cores.
- K3 ``gather_rows_kernel`` (``csrc/bev_pool.cu``): every rank, the table
  rows some rank names, the (F, P, C) rows written; no arithmetic.
"""
from __future__ import annotations

from typing import Tuple

import torch


def landed(ranks: torch.Tensor, ncells: int) -> torch.Tensor:
    return (ranks >= 0) & (ranks < ncells)


def distinct_cells(ranks: torch.Tensor, ncells: int) -> int:
    """Cells some rank names, summed over the frames (rows of ``ranks``)."""
    return sum(int(torch.unique(r[landed(r, ncells)]).numel()) for r in ranks)


def k1_splat(ranks: torch.Tensor, ncells: int, channels: int, elem: int) -> Tuple[float, float]:
    """(bytes, fp32 operations) of one K1 launch over (F, P) ``ranks``."""
    n_landed = int(landed(ranks, ncells).sum())
    n_bytes = (n_landed * channels * elem + ranks.numel() * 4
               + distinct_cells(ranks, ncells) * channels * 4)
    return float(n_bytes), float(n_landed * channels)


def k2_mlp(rows: int, channels: int, elem: int) -> Tuple[float, float]:
    """(bytes, bf16 operations) of one K2 launch over ``rows`` rows."""
    c = channels
    weights = 2 * c * 4 * c * elem + (4 * c + 4 * c) * 4
    return float(3 * rows * c * elem + weights), float(2 * 2 * rows * c * 4 * c)


def k3_gather(ranks: torch.Tensor, ncells: int, channels: int, elem: int) -> Tuple[float, float]:
    """(bytes, operations) of one K3 launch over (F, P) ``ranks``."""
    n_bytes = ((distinct_cells(ranks, ncells) + ranks.numel()) * channels * elem
               + ranks.numel() * 4)
    return float(n_bytes), 0.0
