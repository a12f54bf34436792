#!/usr/bin/env python3
"""K1 (the BEV splat), K2 (the fused ConvNeXt MLP) and K4 (the fused lift +
splat) of one checkout of the port, timed three ways on one NVIDIA GPU.

    python3 scripts/torch_kernel_ab.py [--tree DIR] [--label NAME]

``stp3_tpu_torch`` is imported from DIR (default: this repository), so a
kernel of an earlier commit can be timed beside this one's: unpack that
commit's package into a directory that .gitignore lists, e.g.

    mkdir -p build/ab/old
    git archive <commit> stp3_tpu_torch | tar -x -C build/ab/old

and run the script on each tree in turns (old, new, new, old), one
after another on the same card. The configurations, the rig and its
ranks are this repository's (tests/torch_fixtures.py): K1 (``bev_splat``:
zeroing the fp32 sums, the kernel, the cast to bf16) at the flagship's
serving splat (F=3, the rig's pre-warped ranks) and at the CARLA agent's
single-frame splat (F=1), bf16 rows; K2 (``convnext_mlp``) at the
flagship's two serving row counts (N=240,000 and 360,000), bf16; K4
(``lift_splat_frames``: zeroing the fp32 sums, the kernel, the cast to
bf16) at the flagship's fused splat (F=3, bf16 context and depth
probabilities, the rig's pre-warped ranks). Each is checked against its
plain version and timed:

  call   one wrapper call between two CUDA events, the host's time to
         issue it included (``time_ms``, median of 20);
  graph  ``device_ms``: 10 calls in one CUDA graph, the median
         of 7 replays over 10; the inputs of one call stay in the card's L2
         for the next as far as they fit (50 MB on an H100);
  cold   the same with a 128 MB buffer zeroed before each call (which
         evicts the L2), less the time of the zeroing alone.

Each line gives the share of the bound (``bound``: the larger of the
bytes over the memory rate and the operations over the peak rate, over
the time) under each timing, the card's name and power limit, and what
the compiler reported for the kernels (ptxas for a CUDA kernel, Triton's
metadata for a Triton one); K4's line also its atomic rows per landed
point (1 for a kernel with no tile, which adds each landed point's row
with atomics of its own).
The last line is one JSON object with every number. Exits non-zero
without a card or when a kernel disagrees with its plain version.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the configurations, the rig and its ranks: this repository's, whatever
# tree the port comes from (they import the port when called)
sys.path.insert(0, os.path.join(ROOT, 'tests'))
import torch_fixtures as fixtures  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {'bf16': 989e12, 'fp32': 67e12}


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Median of per-call CUDA-event times after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, calls: int = 10, reps: int = 7) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in one
    CUDA graph, replayed ``reps`` times, the median replay (CUDA events)
    over ``calls``. Unlike ``time_ms`` it leaves out the host's time to
    issue the call (Python, the wrapper, the launches)."""
    import torch
    for _ in range(3):
        fn()                                  # warm-up: builds, caches, the allocator
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_ms(graph.replay, warmup=1, iters=reps) / calls


def cold_ms(fn, flush) -> float:
    """``device_ms`` of ``fn`` with ``flush`` (a buffer larger than the
    card's 50 MB L2) zeroed before each call, less the zeroing's own time:
    the time of a call that finds its inputs out of the L2."""
    return device_ms(lambda: (flush.zero_(), fn())) - device_ms(flush.zero_)


def bound(n_bytes: float, n_ops: float, kind: str):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the peak rate of their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS_PER_S[kind]
    return max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops else 'operations'


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def k4_bound(ctx, dp, ranks, rays, ncells):
    """(bound_ms, bound_by) of K4: every rank read once; the ray id and dp
    of each point that lands; the ctx table once; the (F, ncells, C)
    result written once in ctx's dtype; a multiply and an add per channel
    of each point that lands."""
    f, _, c = ctx.shape
    valid = (ranks < ncells).sum().item()
    n_bytes = (nbytes(ranks) + valid * (rays.element_size() + dp.element_size()) + nbytes(ctx)
               + f * ncells * c * ctx.element_size())
    return bound(n_bytes, 2 * valid * c, 'fp32')


def timings(fn, flush) -> dict:
    return {'call': time_ms(fn), 'graph': device_ms(fn), 'cold': cold_ms(fn, flush)}


def shares(bound_ms: float, ms: dict) -> str:
    return ', '.join(f'{k} {v:.4f} ms (share {bound_ms / v:.3f})' for k, v in ms.items())


def k1_numbers(cfg, device, ranks, ncells, flush, what: str) -> dict:
    import torch
    from stp3_tpu_torch.ops.kernels import bev_splat as K1
    f, p = ranks.shape
    c = cfg.MODEL.ENCODER.OUT_CHANNELS
    gen = torch.Generator(device='cpu').manual_seed(fixtures.SEED)
    feats = torch.randn(f, p, c, generator=gen).to(device=device, dtype=torch.bfloat16)
    got = K1.bev_splat_accumulate(feats, ranks, ncells)
    want = K1.bev_splat_accumulate_plain(feats, ranks, ncells)
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-3):
        sys.exit(f'K1 disagrees with its plain version at {what}: max_abs_err {err:.3e}')
    valid = (ranks < ncells).sum().item()
    # every rank and the rows of the points that land in the grid read once
    # (a dropped point's row is never needed), the (F, ncells, C) result
    # written once; one add per channel of each point that lands
    n_bytes = valid * c * feats.element_size() + nbytes(ranks) + (
        f * ncells * c * feats.element_size())
    bound_ms, _ = bound(n_bytes, valid * c, 'fp32')
    ms = timings(lambda: K1.bev_splat(feats, ranks, ncells), flush)
    print(f'[K1 {what}] F={f} P={p} C={c} ncells={ncells} bf16: max_abs_err {err:.3e} (rtol 1e-4, '
          f'atol 1e-3) OK; bound {bound_ms:.4f} ms; {shares(bound_ms, ms)}', flush=True)
    return dict(ms, bound_ms=bound_ms, max_abs_err=err)


def k2_numbers(device, n: int, flush, label: str) -> dict:
    import torch
    from stp3_tpu_torch.ops.kernels import convnext_mlp as K2
    c = 64
    gen = torch.Generator(device='cpu').manual_seed(fixtures.SEED)

    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(device)

    weights = (rnd(c, scale=0.1, shift=1.0), rnd(c, scale=0.1),
               rnd(c, 4 * c, scale=c ** -0.5), rnd(4 * c, scale=0.1),
               rnd(4 * c, c, scale=(4 * c) ** -0.5), rnd(c, scale=0.1),
               rnd(c, scale=0.5))
    h = rnd(n, c).to(torch.bfloat16)
    x = rnd(n, c).to(torch.bfloat16)
    got = K2.convnext_mlp(h, x, *weights)
    want = K2.convnext_mlp_plain(h, x, *weights)
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), rtol=1e-2, atol=1e-2):
        sys.exit(f'K2 disagrees with its plain version at N={n}: max_abs_err {err:.3e}')
    # h, x and the weights read once, y written once; two (N, C) x (C, 4C)
    # products of 2 operations per multiply-add, on the bf16 tensor cores
    bound_ms, _ = bound(nbytes(h, x, h) + nbytes(*weights), 2 * 2 * n * c * 4 * c, 'bf16')
    ms = timings(lambda: K2.convnext_mlp(h, x, *weights), flush)
    print(f'[K2 {label}] N={n} C={c} bf16: max_abs_err {err:.3e} (rtol=atol=1e-2) OK; bound '
          f'{bound_ms:.4f} ms; {shares(bound_ms, ms)}', flush=True)
    return dict(ms, bound_ms=bound_ms, max_abs_err=err)


def k4_numbers(cfg, device, flush, what: str) -> dict:
    import torch
    from stp3_tpu_torch.ops.kernels import bev_splat as K1
    from stp3_tpu_torch.ops.kernels import lift_splat as K4
    feat, logits, ranks, rays, ncells = fixtures.k4_inputs(cfg, device)
    f, c = ranks.shape[0], feat.shape[-1]
    ctx, dp = feat.reshape(f, -1, c), fixtures.depth_probs(logits)
    got = K4.lift_splat_accumulate(ctx, dp, ranks, rays, ncells)
    want = K4.lift_splat_accumulate_plain(ctx, dp, ranks, rays, ncells)
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-3):
        sys.exit(f'K4 disagrees with its plain version at {what}: max_abs_err {err:.3e}')
    bound_ms, _ = k4_bound(ctx, dp, ranks, rays, ncells)
    tile = getattr(K4, 'TILE', None)
    rows = K1.atomic_rows_per_landed_point(ranks, ncells, tile) if tile else 1.0
    ms = timings(lambda: K4.lift_splat_frames(ctx, dp, ranks, rays, ncells), flush)
    print(f'[K4 {what}] F={f} R={ctx.shape[1]} P={ranks.shape[1]} C={c} ncells={ncells} bf16: '
          f'max_abs_err {err:.3e} (rtol 1e-4, atol 1e-3) OK; atomic rows per landed point '
          f'{rows:.4f} (tile {tile}); bound {bound_ms:.4f} ms; {shares(bound_ms, ms)}', flush=True)
    return dict(ms, bound_ms=bound_ms, max_abs_err=err, atomic_rows_per_landed_point=rows)


def compiler_report(device) -> dict:
    """ptxas's registers, shared memory and spills for a CUDA kernel;
    Triton's for K2 where the tree's K2 is a Triton kernel."""
    import torch
    from stp3_tpu_torch.ops.kernels import bev_splat as K1
    from stp3_tpu_torch.ops.kernels import convnext_mlp as K2
    from stp3_tpu_torch.ops.kernels import lift_splat as K4
    out = {'K1': fixtures.ptxas_summary(K1.build()['log']),
           'K4': fixtures.ptxas_summary(K4.build()['log'])}
    if hasattr(K2, 'build'):
        out['K2'] = fixtures.ptxas_summary(K2.build()['log'])
    else:
        # the tree's K2 is Triton: one launch as its wrapper makes it, for
        # the compiled kernel's metadata
        kernel, cdiv = K2._kernel()
        f32, n, c = torch.float32, 256, 64
        h = torch.zeros(n, c, device=device, dtype=torch.bfloat16)
        vec, mat = torch.zeros(c, device=device), torch.zeros(c, 4 * c, device=device)
        compiled = kernel[(cdiv(n, K2._BLOCK_M),)](
            h, h, torch.empty_like(h), vec, vec, mat.to(torch.bfloat16),
            torch.zeros(4 * c, device=device, dtype=f32), mat.t().contiguous().to(torch.bfloat16),
            vec, vec, n, C=c, C4=4 * c, BLOCK_M=K2._BLOCK_M, EPS=K2._EPS,
            K0=K2._SQRT_2_OVER_PI, num_warps=K2._NUM_WARPS)
        meta = compiled.metadata
        out['K2'] = [f'Triton _mlp_kernel: {compiled.n_regs} registers, {compiled.n_spills} '
                     f'spills, {meta.shared} B shared memory, {meta.num_warps} warps, '
                     f'{meta.num_stages} stages']
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--tree', default=ROOT, help='the checkout whose stp3_tpu_torch is timed')
    parser.add_argument('--label', default='this tree')
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        sys.exit('no CUDA device')
    import stp3_tpu_torch
    if not os.path.abspath(stp3_tpu_torch.__file__).startswith(tree + os.sep):
        sys.exit(f'stp3_tpu_torch came from {stp3_tpu_torch.__file__}, not {tree}')
    from stp3_tpu_torch.ops.bev_pool import prewarped_ranks
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f'[{args.label}] {tree} on {card}', flush=True)
    device = torch.device('cuda', 0)
    report = compiler_report(device)
    for name, lines in report.items():
        print(f'[{args.label}] {name}: ' + ' | '.join(lines), flush=True)
    flush = torch.empty(32 * 2 ** 20, device=device)          # 128 MB of fp32
    cfg = fixtures.flagship_cfg()
    ranks, ncells = fixtures.splat_ranks(cfg, device)
    numbers = {'tree': args.label, 'card': card, 'compiler': report,
               'k1_serving': k1_numbers(cfg, device, ranks, ncells, flush,
                                        f'{args.label} serving F=3')}
    agent = fixtures.carla_planning_cfg()
    geometry, ego, (res, start, dim) = fixtures.rig_geometry(agent, device, carla=True)
    ranks = prewarped_ranks(geometry[:, -1:], ego[:, -1:], res, start, dim)
    numbers['k1_agent'] = k1_numbers(agent, device, ranks, int(np.prod(dim)), flush,
                                     f'{args.label} agent F=1')
    for n in (240000, 360000):
        numbers[f'k2_{n}'] = k2_numbers(device, n, flush, f'{args.label} serving')
    numbers['k4_fused'] = k4_numbers(cfg, device, flush, f'{args.label} fused F=3')
    print(json.dumps(numbers), flush=True)


if __name__ == '__main__':
    main()
