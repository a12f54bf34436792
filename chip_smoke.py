#!/usr/bin/env python3
"""Drive the PyTorch port (stp3_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py              # every phase below
    python3 chip_smoke.py --profile    # ... and where each path's time goes

Phases, each printing one line (or a few) before the last:
  1. device: card name and power limit, torch / CUDA versions, TF32 flags;
  2. build: nvcc-build the BEV splat kernels (K1 and K3), the fused
     lift + splat (K4) and the fused ConvNeXt MLP (K2) from csrc/, one
     nvcc per source, all three at once; each kernel's registers, shared
     memory and spills as ptxas reports them;
  3. K1 vs its plain version at the serving (F=3) and training (F=6)
     splat shapes, ranks from the flagship rig's real geometry, and at the
     agent's single-frame splat (F=1, the CARLA rig); times of both and of
     index_add_, the share of the bound, K1's atomic rows per landed
     point; at the serving shape also the zeroing and the cast alone;
  4. K2 (fused ConvNeXt MLP, CUDA C++) vs its plain version at the serving
     and training row counts; times of both and the share of the bound;
  5. K3 (the splat's backward row gather) vs its plain version at the
     training shape (6, 483,840, 64), bf16 and fp32, bit for bit; times of
     both and of torch.gather;
  6. backward: K1's autograd Function (K3 backward) vs the plain splat's
     autograd at the training shape, bit for bit;
  [K1 v1] / [K1 v2]: K1's per-frame entries at one flagship frame against
     the plain version, index_add_ and their bound; then the serving splat
     with method 'pallas' / 'pallas2' (3 launches, one per frame) against
     method 'auto' (one launch for all frames);
  [K4]: the fused lift + splat at the flagship fused shape (F=3) against
     its plain version, beside the path it replaces (the lift, then K1):
     device time, one event-timed call and the time with the L2 evicted,
     the share of the bound, K4's atomic rows per landed point and its
     ptxas report; its backward against autograd through the plain version;
  7. CPU-vs-CUDA parity of the tiny model in fp32 (same seeded weights),
     every head, the planner costs on a shared occupancy, and the refined
     trajectory;
  8. CPU-vs-CUDA parity of one tiny fp32 train step (same seeded weights,
     one batch, dropout off, fixed noise, TF32 off): loss terms and every
     gradient;
  9. serving: the full-width flagship (EfficientNet-b4, 6 cameras at
     224x480, 200x200 BEV, 6 future frames, 1,800 candidates) from a
     seeded init under the bf16 policy: forward + occupancy + plan as
     bench.py times it, its launch counts and its p50 latency;
 10. training: the Planning stage at full width and batch 2 (bf16 policy,
     fp32 masters, REMAT 'encoder', seeded init, synthetic batches): one
     counted step, then 2 warm-up and 10 timed steps; loss terms finite,
     parameters changed, step p50, samples/s and peak memory;
 11. [fused]: the flagship with fused_lift_splat: fp32 BEV features of the
     fused and materialised paths of the same weights, then forward + plan
     under the bf16 policy (K4 once, K2 twice, K1 never) and its p50; then
     [fused turns]: the fused and the materialised step of the same
     weights in turns, 4 each, alternating (p50 of 20 steps a turn);
 12. [agent]: the CARLA Planning stage at full width (4 cameras at
     256x256, 200x200 BEV at 0.2 m, 2,400 candidates, seeded fp32 weights):
     AgentCore in its three tick modes over recorded ticks (seeded uint8
     300x400 frames, GPS 2 m further each tick): controls in range, static
     vs dynamic single-frame splat, incremental vs full heads at zero
     ego-motion; each mode's plan_step p50 over 20 ticks, launches per
     tick and peak memory.
With --profile, torch.profiler windows of 3 calls (device events, summed
device time against the wall time, the kernels that take the most) of the
serving and fused forward + plan, of a train step and of each agent tick
mode; after phase 10 also the train step split by CUDA events into loss
(labels + forward + losses), backward and clip + Adam, and the host's
time to issue a step; in [fused turns] per turn the host's issue time,
the SM clock and power, the device's events, time and idle gaps, then the
kernels and the host ops of each variant.
Then one JSON line with every kernel's numbers (the numbers of the path
each kernel was measured on at the top level, each path's launches and
times under "paths"), and last {"ok": true, "device": {...}}. Any failure
exits non-zero before that.
Without a CUDA device, or without the repository beside it, it fails.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 0

# The flagship: the nuScenes Planning stack at full width (EfficientNet-b4,
# 6 cameras at 224x480, 200x200 BEV, 6 future frames, 1,800 candidates)
FLAGSHIP = {
    'N_FUTURE_FRAMES': 6, 'FUTURE_DISCOUNT': 0.95, 'PROBABILISTIC': {'ENABLED': True},
    'PLANNING': {'ENABLED': True, 'SAMPLE_NUM': 1800},
    'INSTANCE_SEG': {'ENABLED': False}, 'INSTANCE_FLOW': {'ENABLED': False},
}
# stp3_tpu/configs/nuscenes/Planning.yml, as code (PyYAML is not needed)
PLANNING_STAGE = {
    'TAG': 'Planning', 'BATCHSIZE': 2, 'PRECISION': 16, 'EPOCHS': 20, 'N_WORKERS': 8,
    'TIME_RECEPTIVE_FIELD': 3, 'N_FUTURE_FRAMES': 6, 'FUTURE_DISCOUNT': 0.95,
    'DATASET': {'VERSION': 'trainval'}, 'LIFT': {'GT_DEPTH': False},
    'MODEL': {'REMAT': 'encoder', 'BN_MOMENTUM': 0.05,
              'ENCODER': {'NAME': 'efficientnet-b4', 'USE_DEPTH_DISTRIBUTION': True},
              'TEMPORAL_MODEL': {'NAME': 'temporal_block', 'INPUT_EGOPOSE': True}},
    'SEMANTIC_SEG': {'PEDESTRIAN': {'ENABLED': True}, 'HDMAP': {'ENABLED': True}},
    'INSTANCE_SEG': {'ENABLED': False}, 'INSTANCE_FLOW': {'ENABLED': False},
    'PROBABILISTIC': {'ENABLED': True, 'METHOD': 'GAUSSIAN'},
    'PLANNING': {'ENABLED': True, 'SAMPLE_NUM': 1800}, 'OPTIMIZER': {'LR': 2e-4},
    'COST_FUNCTION': {'SAFETY': 1.0, 'HEADWAY': 1.0, 'LRDIVIDER': 10.0, 'COMFORT': 0.1,
                      'PROGRESS': 0.5, 'VOLUME': 100.0},
    'PRETRAINED': {'LOAD_WEIGHTS': True},
}
# the tiny model of the parity phases: b0, 2 cameras at 32x64, 16x16 BEV
TINY = {
    'TIME_RECEPTIVE_FIELD': 2, 'N_FUTURE_FRAMES': 2,
    'IMAGE': {'FINAL_DIM': (32, 64), 'NAMES': ['CAM_L', 'CAM_R']},
    'LIFT': {'X_BOUND': [-8.0, 8.0, 1.0], 'Y_BOUND': [-8.0, 8.0, 1.0],
             'D_BOUND': [2.0, 10.0, 1.0]},
    'MODEL': {'ENCODER': {'NAME': 'efficientnet-b0', 'OUT_CHANNELS': 16},
              'TEMPORAL_MODEL': {'START_OUT_CHANNELS': 16},
              'DISTRIBUTION': {'LATENT_DIM': 4}},
    'PLANNING': {'SAMPLE_NUM': 12, 'GRU_STATE_SIZE': 2},
}


# stp3_tpu/configs/carla/Planning.yml, as code: the agent's configuration
CARLA_PLANNING = {
    'TAG': 'CARLA_planning', 'BATCHSIZE': 2, 'PRECISION': 16, 'EPOCHS': 20, 'N_WORKERS': 8,
    'DATASET': {'NAME': 'carla'}, 'TIME_RECEPTIVE_FIELD': 3, 'N_FUTURE_FRAMES': 4,
    'IMAGE': {'FINAL_DIM': (256, 256), 'NAMES': ['front', 'left', 'right', 'rear'],
              'ORIGINAL_HEIGHT': 300, 'ORIGINAL_WIDTH': 400},
    'LIFT': {'X_BOUND': [-20.0, 20.0, 0.2], 'Y_BOUND': [-20.0, 20.0, 0.2], 'GT_DEPTH': False},
    'EGO': {'WIDTH': 2.12, 'HEIGHT': 4.90},
    'MODEL': {'REMAT': 'encoder', 'BN_MOMENTUM': 0.05,
              'ENCODER': {'NAME': 'efficientnet-b4', 'USE_DEPTH_DISTRIBUTION': True},
              'TEMPORAL_MODEL': {'NAME': 'temporal_block', 'INPUT_EGOPOSE': True}},
    'SEMANTIC_SEG': {'PEDESTRIAN': {'ENABLED': True}, 'HDMAP': {'ENABLED': True}},
    'INSTANCE_SEG': {'ENABLED': False}, 'INSTANCE_FLOW': {'ENABLED': False},
    'PROBABILISTIC': {'ENABLED': True, 'METHOD': 'GAUSSIAN'},
    'PLANNING': {'ENABLED': True, 'GRU_STATE_SIZE': 128, 'SAMPLE_NUM': 2400},
    'FUTURE_DISCOUNT': 0.95, 'OPTIMIZER': {'LR': 2e-4},
    'COST_FUNCTION': {'SAFETY': 1.0, 'HEADWAY': 1.0, 'LRDIVIDER': 10.0, 'COMFORT': 1.0,
                      'PROGRESS': 1.0, 'VOLUME': 100.0},
    'PRETRAINED': {'LOAD_WEIGHTS': True},
}


def make_cfg(*overrides):
    """The port's default config with the nested overrides merged in order."""
    from stp3_tpu_torch.config import CfgNode, get_cfg
    cfg = get_cfg()
    for override in overrides:
        cfg.merge_from_other_cfg(CfgNode(override))
    return cfg


def flagship_cfg(tiny: bool = False):
    return make_cfg(FLAGSHIP, TINY) if tiny else make_cfg(FLAGSHIP)


def planning_cfg(tiny: bool = False):
    """The Planning stage's training config; ``tiny`` in fp32."""
    return make_cfg(PLANNING_STAGE, TINY, {'PRECISION': 32}) if tiny else make_cfg(
        PLANNING_STAGE)


def carla_planning_cfg():
    return make_cfg(CARLA_PLANNING)


# the kernels: name, route, source, the TPU kernel each replaces, and the
# path whose numbers stand at the top level of the kernels line
KERNELS = (
    ('bev_splat', 'cuda', 'stp3_tpu_torch/csrc/bev_pool.cu',
     'stp3_tpu/ops/pallas/bev_pool_kernel.py:262', 'train'),
    ('bev_pool_v1', 'cuda', 'stp3_tpu_torch/csrc/bev_pool.cu',
     'stp3_tpu/ops/pallas/bev_pool_kernel.py:62', 'per_frame'),
    ('bev_pool_v2', 'cuda', 'stp3_tpu_torch/csrc/bev_pool.cu',
     'stp3_tpu/ops/pallas/bev_pool_kernel.py:169', 'per_frame'),
    ('convnext_mlp', 'cuda', 'stp3_tpu_torch/csrc/convnext_mlp.cu',
     'stp3_tpu/ops/pallas/convnext_mlp_kernel.py:124', 'train'),
    ('gather_rows', 'cuda', 'stp3_tpu_torch/csrc/bev_pool.cu',
     'stp3_tpu/ops/pallas/bev_pool_kernel.py:319', 'train'),
    ('lift_splat', 'cuda', 'stp3_tpu_torch/csrc/lift_splat.cu',
     'stp3_tpu/ops/pallas/bev_pool_kernel.py:418', 'fused'),
)
PATHS = ('serving', 'train', 'per_frame', 'fused', 'agent')


def counters():
    """Each kernel's launch counter: the wrapper that launches it."""
    from stp3_tpu_torch.ops.kernels import bev_splat as K1
    from stp3_tpu_torch.ops.kernels import convnext_mlp as K2
    from stp3_tpu_torch.ops.kernels import lift_splat as K4
    return {'bev_splat': K1.bev_splat_accumulate, 'bev_pool_v1': K1.bev_pool_v1,
            'bev_pool_v2': K1.bev_pool_v2, 'convnext_mlp': K2.convnext_mlp,
            'gather_rows': K1.gather_rows, 'lift_splat': K4.lift_splat_accumulate}


def reset_launches() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_launches() -> dict:
    import torch
    torch.cuda.synchronize()
    return {name: fn.launches for name, fn in counters().items()}


def expect_launches(what: str, launches: dict, **want) -> None:
    """Fail unless the kernels in ``want`` launched that often and no other
    kernel launched."""
    full = {name: want.get(name, 0) for name in launches}
    if launches != full:
        fail(f'{what}: launches {launches}, expected {full}')


# the kernels' mangled template arguments; a substitution (S_, S0_, ...)
# repeats an earlier argument, in these kernels the one before it
_MANGLED = {'13__nv_bfloat16': 'bf16', 'f': 'float', 't': 'uint16_t', 'j': 'uint32_t',
            '5uint4': 'uint4'}


def ptxas_summary(log: str) -> list:
    """One 'kernel: registers, shared memory, spills' entry per entry
    function of an nvcc '-Xptxas -v' log."""
    import re
    out, name, spills = [], '?', ''
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            # the kernel's name and its mangled template arguments
            base = re.search(r'([a-z][a-z_]*_kernel)I(\w*?)EE', m.group(1))
            name = m.group(1)
            if base:
                args = []
                for tok in re.findall(r'13__nv_bfloat16|5uint4|S\d*_|[a-z]', base.group(2)):
                    args.append(args[-1] if tok.startswith('S') else _MANGLED.get(tok, tok))
                name = f'{base.group(1)}<{", ".join(args)}>'
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads', line)
        if m:
            spills = f'spills {m.group(1)}/{m.group(2)} B'
        m = re.search(r'Used (\d+) registers', line)
        if m:
            smem = re.search(r'(\d+) bytes smem', line)
            out.append(f'{name}: {m.group(1)} registers, {smem.group(1) if smem else 0} B static '
                       f'smem, {spills}')
    return out


def build_kernels(repo: str) -> None:
    """nvcc-build K1+K3 (bev_pool.cu), K4 (lift_splat.cu) and K2
    (convnext_mlp.cu) at once, one nvcc per source."""
    from concurrent.futures import ThreadPoolExecutor
    import torch
    from stp3_tpu_torch.ops.kernels import bev_splat as K1
    from stp3_tpu_torch.ops.kernels import convnext_mlp as K2
    from stp3_tpu_torch.ops.kernels import lift_splat as K4
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        infos = list(pool.map(lambda build: build(), (K1.build, K4.build, K2.build)))
    for name, info in zip(('K1+K3', 'K4', 'K2'), infos):
        say(f"[build] {name} {'built' if info['built'] else 'reused'} in {info['seconds']:.2f} s "
            f"-> {os.path.relpath(info['path'], repo)}; ptxas: "
            + ' | '.join(ptxas_summary(info['log'])))
    say(f'[build] K2 dynamic shared memory a CTA: {K2.shared_memory_bytes(torch.bfloat16)} B '
        f'(bf16 rows), {K2.shared_memory_bytes(torch.float32)} B (fp32 rows)')
    say(f'[build] all three builds done in {time.perf_counter() - t0:.2f} s of wall time')


def fail(msg: str) -> None:
    print(f'chip_smoke FAILED: {msg}', flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def example_inputs(cfg, seed: int = SEED, b: int = 1):
    """numpy twin of __graft_entry__._example_inputs + _planning_extras
    (the rig and the ego-motion repeat over a batch of ``b``)."""
    rng = np.random.RandomState(seed)
    rf, n = cfg.TIME_RECEPTIVE_FIELD, len(cfg.IMAGE.NAMES)
    h, w = cfg.IMAGE.FINAL_DIM
    image = rng.rand(b, rf, n, h, w, 3).astype(np.float32)
    k = np.tile(np.array([[0.3 * w, 0, w / 2], [0, 0.3 * w, h / 2], [0, 0, 1]],
                         np.float32), (b, rf, n, 1, 1))
    e = np.tile(np.eye(4, dtype=np.float32), (b, rf, n, 1, 1))
    for i in range(n):
        yaw = 2 * np.pi * i / n
        rot = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)
        yawm = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                         [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]], np.float32)
        e[:, :, i, :3, :3] = yawm @ rot
        e[:, :, i, :3, 3] = [1.5 * np.cos(yaw), 1.5 * np.sin(yaw), 1.6]
    ego = np.tile(np.array([2.0, 0, 0, 0, 0, 0.01], np.float32), (b, rf, 1))
    rng = np.random.RandomState(seed)
    nf = cfg.N_FUTURE_FRAMES
    extras = {
        'trajs': rng.randn(1, cfg.PLANNING.SAMPLE_NUM, nf, 3).astype(np.float32),
        'gt_trajs': rng.randn(1, nf, 3).astype(np.float32),
        'commands': np.zeros((1,), np.int64),
        'target_points': np.zeros((1, 2), np.float32),
    }
    return (image, k, e, ego), extras


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


# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {'bf16': 989e12, 'fp32': 67e12}


def bound(n_bytes: float, n_ops: float, kind: str):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the peak rate of their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS_PER_S[kind]
    return max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops else 'operations'


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def rig_geometry(cfg, device, b: int = 1, carla: bool = False):
    """(geometry (B, rf, N, D, Hf, Wf, 3), ego (B, rf, 6), (res, start,
    dim)) of the example rig and ego-motion, or of the fixed CARLA rig at
    zero ego-motion."""
    import torch
    from stp3_tpu_torch.datas.carla import carla_cam_rig
    from stp3_tpu_torch.ops.geometry import (calculate_birds_eye_view_parameters,
                                             create_frustum, get_geometry)
    mc = model_cfg(cfg)
    (_, k, e, ego), _ = example_inputs(cfg, b=b)
    if carla:
        extr, intr = carla_cam_rig(mc.final_dim)
        k, e = (np.tile(a, (b, mc.receptive_field, 1, 1, 1)) for a in (intr, extr))
        ego = np.zeros_like(ego)
    grid = calculate_birds_eye_view_parameters(mc.x_bound, mc.y_bound, mc.z_bound)
    fr = torch.as_tensor(create_frustum(mc.final_dim, mc.encoder_downsample, mc.d_bound),
                         device=device)
    k, e, ego = to_torch((k, e, ego), device)
    return get_geometry(fr, k, e), ego, grid


def splat_ranks(cfg, device, b: int = 1):
    """(F = b * rf, P) int32 ranks of the flagship rig's real frustum
    geometry, pre-warped by the example ego-motion, as the model splats."""
    from stp3_tpu_torch.ops.bev_pool import prewarped_ranks
    geometry, ego, (res, start, dim) = rig_geometry(cfg, device, b)
    return prewarped_ranks(geometry, ego, res, start, dim), int(np.prod(dim))


def phase_k1(cfg, device, path: str, b: int = 1, ranks=None):
    """K1 vs its plain version at the splat of a batch of ``b`` (F = b * rf
    frames), or at the given (F, P) ``ranks``; returns its numbers for the
    ``path`` it serves."""
    import torch
    from stp3_tpu_torch.ops.kernels import bev_splat as K1
    ncells = int(np.prod(model_cfg(cfg).bev_dimension))
    if ranks is None:
        ranks, ncells = splat_ranks(cfg, device, b=b)
    f, p = ranks.shape
    c = cfg.MODEL.ENCODER.OUT_CHANNELS
    gen = torch.Generator(device='cpu').manual_seed(SEED)
    feats = torch.randn(f, p, c, generator=gen).to(device=device, dtype=torch.bfloat16)
    acc_k = K1.bev_splat_accumulate(feats, ranks, ncells)
    acc_p = K1.bev_splat_accumulate_plain(feats, ranks, ncells)
    torch.cuda.synchronize()
    err = (acc_k - acc_p).abs().max().item()
    # fp32 on both sides; only the (atomic) summation order differs
    ok = torch.allclose(acc_k, acc_p, rtol=1e-4, atol=1e-3)
    valid = (ranks < ncells).sum().item()
    # the timed window: zeroing the (F, ncells, C) fp32 accumulator, the
    # kernel and the cast of the sums to bf16
    ms = device_ms(lambda: K1.bev_splat(feats, ranks, ncells))
    call_ms = time_ms(lambda: K1.bev_splat(feats, ranks, ncells))
    plain_ms = device_ms(lambda: K1.bev_splat_plain(feats, ranks, ncells))
    # one PyTorch call of the same scatter-add: index_add_ onto a flat buffer
    flat_idx = (ranks.long() + torch.arange(f, device=device)[:, None] * (ncells + 1)).reshape(-1)
    buf = torch.zeros(f * (ncells + 1), c, dtype=feats.dtype, device=device)
    flat_feats = feats.reshape(-1, c)
    library_ms = device_ms(lambda: buf.index_add_(0, flat_idx, flat_feats))
    # every rank and the rows of the points that land in the grid read once
    # (a dropped point's row is never needed), the (F, ncells, C) result
    # written once; one add per channel of each point that lands
    n_bytes = valid * c * feats.element_size() + nbytes(ranks) + (
        f * ncells * c * feats.element_size())
    bound_ms, bound_by = bound(n_bytes, valid * c, 'fp32')
    rows = K1.atomic_rows_per_landed_point(ranks, ncells)
    say(f'[K1 {path}] bev_splat F={f} P={p} C={c} ncells={ncells} bf16, invalid share '
        f'{1 - valid / (f * p):.4f}: max_abs_err {err:.3e} (rtol 1e-4, atol 1e-3) '
        f'{"OK" if ok else "MISMATCH"}; kernel {ms:.4f} ms (zeroing the fp32 sums, the kernel, '
        f'the cast to bf16; {call_ms:.4f} ms a call with the host\'s issue time), plain '
        f'{plain_ms:.3f} ms, index_add_ {library_ms:.3f} ms, bound '
        f'{bound_ms:.4f} ms ({bound_by}, {n_bytes / 1e6:.1f} MB), bound_share '
        f'{bound_ms / ms:.3f}; atomic rows per landed point {rows:.4f} (tile {K1.TILE})')
    if not ok:
        fail(f'K1 disagrees with its plain version at F={f}')
    if path == 'serving':
        zero_ms = device_ms(lambda: torch.zeros(f, ncells, c, device=device))
        sums = K1.bev_splat_accumulate(feats, ranks, ncells)
        cast_ms = device_ms(lambda: sums.to(feats.dtype))
        say(f'[K1 {path}] of the kernel\'s {ms:.4f} ms: zeroing the fp32 sums alone '
            f'{zero_ms:.4f} ms, the cast to bf16 alone {cast_ms:.4f} ms')
    return dict(shape=f'F={f} P={p} C={c} ncells={ncells} bf16', max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                bound_share=bound_ms / ms, atomic_rows_per_landed_point=rows)


def phase_k2(cfg, device, path: str, b: int = 1):
    """K2 vs its plain version at the two ConvNeXt row counts of a batch of
    ``b``; returns its numbers (summed over both calls) for ``path``."""
    import torch
    from stp3_tpu_torch.ops.kernels import convnext_mlp as K2
    c = cfg.MODEL.TEMPORAL_MODEL.START_OUT_CHANNELS
    nx = int((cfg.LIFT.X_BOUND[1] - cfg.LIFT.X_BOUND[0]) / cfg.LIFT.X_BOUND[2])
    ny = int((cfg.LIFT.Y_BOUND[1] - cfg.LIFT.Y_BOUND[0]) / cfg.LIFT.Y_BOUND[2])
    rf, nf = cfg.TIME_RECEPTIVE_FIELD, cfg.N_FUTURE_FRAMES
    gen = torch.Generator(device='cpu').manual_seed(SEED)

    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(device)

    weights = (rnd(c, scale=0.1, shift=1.0), rnd(c, scale=0.1),
               rnd(c, 4 * c, scale=c ** -0.5), rnd(4 * c, scale=0.1),
               rnd(4 * c, c, scale=(4 * c) ** -0.5), rnd(c, scale=0.1),
               rnd(c, scale=0.5))
    per_shape, errs, ms, plain_ms, bound_ms, bound_by = [], [], 0.0, 0.0, 0.0, set()
    for frames in (nf, rf + nf):          # after the DualGRU; after SpatialGRU 1
        n = b * frames * nx * ny
        h = rnd(n, c).to(torch.bfloat16)
        x = rnd(n, c).to(torch.bfloat16)
        got = K2.convnext_mlp(h, x, *weights)
        want = K2.convnext_mlp_plain(h, x, *weights)
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), rtol=1e-2, atol=1e-2)
        t_k = device_ms(lambda: K2.convnext_mlp(h, x, *weights))
        t_call = time_ms(lambda: K2.convnext_mlp(h, x, *weights))
        t_p = device_ms(lambda: K2.convnext_mlp_plain(h, x, *weights))
        # h, x and the weights read once, y written once; two (N, C) x (C, 4C)
        # products of 2 operations per multiply-add, on the bf16 tensor cores
        t_b, by = bound(nbytes(h, x, h) + nbytes(*weights),
                        2 * 2 * n * c * 4 * c, 'bf16')
        say(f'[K2 {path}] convnext_mlp N={n} C={c} bf16: max_abs_err {err:.3e} (rtol=atol=1e-2) '
            f'{"OK" if ok else "MISMATCH"}; kernel {t_k:.4f} ms ({t_call:.4f} ms a call with the '
            f'host\'s issue time), plain {t_p:.3f} ms, bound '
            f'{t_b:.4f} ms ({by}), bound_share {t_b / t_k:.3f}; no single PyTorch call computes '
            f'this function')
        if not ok:
            fail(f'K2 disagrees with its plain version at N={n}')
        per_shape.append(dict(n=n, max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=t_b,
                              bound_share=t_b / t_k))
        errs.append(err)
        ms += t_k
        plain_ms += t_p
        bound_ms += t_b
        bound_by.add(by)
    return dict(shape=f'N={" and ".join(str(s["n"]) for s in per_shape)} C={c} bf16',
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by='/'.join(sorted(bound_by)), library_ms=None, bound_share=bound_ms / ms,
                per_shape=per_shape)


def phase_k3(cfg, device):
    """K3 at the training shape: the splat's cotangent (F, ncells, C) and
    the ranks of the flagship rig at batch B = cfg.BATCHSIZE; returns its
    numbers for the train path."""
    import torch
    from stp3_tpu_torch.ops.kernels import bev_splat as K
    ranks, ncells = splat_ranks(cfg, device, b=int(cfg.BATCHSIZE))
    f, p = ranks.shape
    c = cfg.MODEL.ENCODER.OUT_CHANNELS
    gen = torch.Generator(device='cpu').manual_seed(SEED)
    table32 = torch.randn(f, ncells, c, generator=gen).to(device)
    parts = []
    for table in (table32, table32.to(torch.bfloat16)):
        got = K.gather_rows(table, ranks)
        want = K.gather_rows_plain(table, ranks)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f'K3 differs from its plain version ({table.dtype}): max_abs_err '
                 f'{(got.float() - want.float()).abs().max().item():.3e}')
        parts.append(str(table.dtype).replace('torch.', ''))
    table = table32.to(torch.bfloat16)                      # the bf16 policy's cotangent
    ms = device_ms(lambda: K.gather_rows(table, ranks))
    plain_ms = device_ms(lambda: K.gather_rows_plain(table, ranks))
    # one PyTorch call of the same gather: torch.gather from the padded table
    padded = torch.cat([table, table.new_zeros(f, 1, c)], 1)
    idx = ranks.long().clamp(0, ncells)[..., None].expand(-1, -1, c)
    library_ms = device_ms(lambda: torch.gather(padded, 1, idx))
    # every rank and the table rows that some rank names read once (a row
    # no point lands on is never needed), the (F, P, C) rows written once
    referenced = sum(torch.unique(r[(r >= 0) & (r < ncells)]).numel() for r in ranks)
    n_bytes = (referenced * c + f * p * c) * table.element_size() + nbytes(ranks)
    bound_ms, bound_by = bound(n_bytes, 0, 'bf16')
    say(f'[K3 train] gather_rows F={f} P={p} C={c} ncells={ncells} ({referenced / (f * ncells):.4f} '
        f'of the rows referenced): equal to its plain version bit for bit in '
        f'{" and ".join(parts)}; bf16 kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, '
        f'torch.gather {library_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}, '
        f'{n_bytes / 1e6:.1f} MB)')
    return dict(shape=f'F={f} P={p} C={c} ncells={ncells} bf16', max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def phase_backward(cfg, device):
    """K1's autograd Function (K3 backward) against autograd through the
    plain splat at the training shape, bf16, bit for bit. (K2's Function
    differentiates its plain version, so a comparison with the plain
    version's autograd cannot differ; tests/test_torch_cuda.py checks its
    wiring at a small shape.)"""
    import torch
    from stp3_tpu_torch.ops.kernels import bev_splat as K1
    gen = torch.Generator(device='cpu').manual_seed(SEED + 1)
    ranks, ncells = splat_ranks(cfg, device, b=int(cfg.BATCHSIZE))
    f, p = ranks.shape
    c = cfg.MODEL.ENCODER.OUT_CHANNELS
    feats = torch.randn(f, p, c, generator=gen).to(device, torch.bfloat16)
    g = torch.randn(f, ncells, c, generator=gen).to(device, torch.bfloat16)
    grads = []
    for splat in (K1.bev_splat, K1.bev_splat_plain):
        x = feats.clone().requires_grad_(True)
        splat(x, ranks, ncells).backward(g)
        grads.append(x.grad)
    torch.cuda.synchronize()
    # both gather the same bf16 cotangent rows: no arithmetic
    if not torch.equal(*grads):
        fail('K1 backward (K3) differs from the plain splat\'s autograd')
    say(f'[backward] K1 d feats ({f}, {p}, {c}) bf16 equal bit for bit to the plain '
        f'splat\'s autograd')


def model_cfg(cfg):
    from stp3_tpu_torch.models.stp3 import STP3Config
    return STP3Config.from_cfg(cfg)


def phase_per_frame(cfg, device):
    """[K1 v1] / [K1 v2]: K1's per-frame entries at one flagship frame (the
    present frame's ranks) against the plain version, then the serving
    splat with method 'pallas' / 'pallas2' against 'auto'. Returns (numbers
    by entry, launches of the per-frame path)."""
    import torch
    from stp3_tpu_torch.ops.bev_pool import prewarped_ranks, project_to_birds_eye_view
    from stp3_tpu_torch.ops.kernels import bev_splat as K1
    geometry, ego, (res, start, dim) = rig_geometry(cfg, device)
    ranks = prewarped_ranks(geometry, ego, res, start, dim)[-1].contiguous()
    ncells = int(np.prod(dim))
    p = ranks.shape[0]
    c = cfg.MODEL.ENCODER.OUT_CHANNELS
    gen = torch.Generator(device='cpu').manual_seed(SEED)
    feats32 = torch.randn(p, c, generator=gen).to(device)
    feats = feats32.to(torch.bfloat16)
    valid = (ranks < ncells).sum().item()
    rows = K1.atomic_rows_per_landed_point(ranks[None], ncells)
    numbers = {}
    for name, version in (('bev_pool_v1', 'v1'), ('bev_pool_v2', 'v2')):
        entry = getattr(K1, name)
        got32 = entry(feats32, ranks, ncells)
        want32 = K1.bev_splat_accumulate_plain(feats32[None], ranks[None], ncells)[0]
        got16 = entry(feats, ranks, ncells)
        want16 = K1.bev_splat_plain(feats[None], ranks[None], ncells)[0]
        torch.cuda.synchronize()
        err = (got32 - want32).abs().max().item()
        # fp32 rows: the fp32 sums at K1's tolerance; bf16 rows: both round
        # the same sums (reordered), so at most one bf16 rounding (2^-8) apart
        ok = (torch.allclose(got32, want32, rtol=1e-4, atol=1e-3)
              and torch.allclose(got16.float(), want16.float(), rtol=2 ** -7, atol=1e-3))
        ms = device_ms(lambda: entry(feats, ranks, ncells))
        plain_ms = device_ms(lambda: K1.bev_splat_plain(feats[None], ranks[None], ncells))
        buf = torch.zeros(ncells + 1, c, dtype=feats.dtype, device=device)
        idx = ranks.long()
        library_ms = device_ms(lambda: buf.index_add_(0, idx, feats))
        n_bytes = valid * c * feats.element_size() + nbytes(ranks) + ncells * c * 2
        bound_ms, bound_by = bound(n_bytes, valid * c, 'fp32')
        say(f'[K1 {version}] {name} P={p} C={c} ncells={ncells} bf16 (one flagship frame, '
            f'invalid share {1 - valid / p:.4f}): max_abs_err {err:.3e} on fp32 rows (rtol '
            f'1e-4, atol 1e-3), bf16 rows within one rounding, {"OK" if ok else "MISMATCH"}; '
            f'kernel {ms:.3f} ms (zeroing, kernel, cast), plain {plain_ms:.3f} ms, index_add_ '
            f'{library_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}, {n_bytes / 1e6:.1f} MB), '
            f'bound_share {bound_ms / ms:.3f}; atomic rows per landed point {rows:.4f} (tile '
            f'{K1.TILE})')
        if not ok:
            fail(f'K1 {version} disagrees with its plain version')
        numbers[name] = dict(shape=f'P={p} C={c} ncells={ncells} bf16', max_abs_err=err, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=library_ms, bound_share=bound_ms / ms,
                             atomic_rows_per_landed_point=rows)

    # the per-frame path: the serving splat with one launch per frame, fp32
    # lifted rows so that the methods compare at K1's tolerance
    mc = model_cfg(cfg)
    n = len(cfg.IMAGE.NAMES)
    hf, wf = (v // mc.encoder_downsample for v in mc.final_dim)
    lifted = torch.randn(1, mc.receptive_field, n, mc.depth_channels, hf, wf, c,
                         generator=torch.Generator(device=device).manual_seed(SEED),
                         device=device)
    args = (lifted, geometry, ego, res, start, dim, mc.discount)
    reset_launches()
    want = project_to_birds_eye_view(*args, method='auto')
    expect_launches("method 'auto'", read_launches(), bev_splat=1)
    path_launches = dict.fromkeys(counters(), 0)
    for method, name in (('pallas', 'bev_pool_v1'), ('pallas2', 'bev_pool_v2')):
        reset_launches()
        got = project_to_birds_eye_view(*args, method=method)
        launches = read_launches()
        expect_launches(f'method {method!r}', launches, **{name: mc.receptive_field})
        path_launches[name] += launches[name]
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, rtol=1e-4, atol=1e-3):
            fail(f'project_to_birds_eye_view method {method!r} differs from \'auto\': '
                 f'max_abs_err {err:.3e}')
        say(f'[K1 per_frame] project_to_birds_eye_view {tuple(lifted.shape)} fp32, method '
            f'{method!r}: {launches[name]} launches of {name} (one per frame), equal to '
            f"method 'auto' (one K1 launch) within rtol 1e-4, atol 1e-3: max_abs_err {err:.3e}")
    return numbers, path_launches


def cold_ms(fn, flush) -> float:
    """``device_ms`` of ``fn`` with ``flush`` (a buffer larger than the
    card's 50 MB L2) zeroed before each call, less the zeroing's own time:
    the time of a call that finds its inputs out of the L2."""
    return device_ms(lambda: (flush.zero_(), fn())) - device_ms(flush.zero_)


def k4_inputs(cfg, device):
    """The fused splat's inputs at the flagship rig: (F, N, Hf, Wf, C) bf16
    context and (F, N, Hf, Wf, D) bf16 depth logits, seeded, of F = rf
    frames; the (F, P) pre-warped ranks of the rig's real geometry; the
    (P,) ray ids; ncells."""
    import torch
    from stp3_tpu_torch.ops.bev_pool import lift_ray_ids
    ranks, ncells = splat_ranks(cfg, device)
    mc = model_cfg(cfg)
    f = ranks.shape[0]
    n, d, c = len(cfg.IMAGE.NAMES), mc.depth_channels, cfg.MODEL.ENCODER.OUT_CHANNELS
    hf, wf = (v // mc.encoder_downsample for v in mc.final_dim)
    gen = torch.Generator(device=device).manual_seed(SEED)
    feat = torch.randn(f, n, hf, wf, c, generator=gen, device=device).to(torch.bfloat16)
    logits = torch.randn(f, n, hf, wf, d, generator=gen, device=device).to(torch.bfloat16)
    return feat, logits, ranks, lift_ray_ids(n, d, hf, wf, device), ncells


def depth_probs(logits):
    """(F, N, Hf, Wf, D) depth logits -> (F, P) probabilities in K4's point
    order (camera, depth bin, pixel row, pixel column)."""
    import torch
    return torch.softmax(logits, -1).movedim(-1, 2).reshape(logits.shape[0], -1).contiguous()


def k4_bound(ctx, dp, ranks, rays, ncells):
    """(bound_ms, bound_by, bytes) of K4: every rank read once; the ray id
    and dp of each point that lands; the ctx table once; the (F, ncells,
    C) result written once in ctx's dtype; a multiply and an add per
    channel of each point that lands."""
    f, _, c = ctx.shape
    valid = (ranks < ncells).sum().item()
    n_bytes = (nbytes(ranks) + valid * (rays.element_size() + dp.element_size()) + nbytes(ctx)
               + f * ncells * c * ctx.element_size())
    return bound(n_bytes, 2 * valid * c, 'fp32') + (n_bytes,)


def phase_k4(cfg, device):
    """[K4]: the fused lift + splat at the flagship fused shape (F = rf
    frames, bf16 ctx and depth probabilities, the rig's real ranks) against
    its plain version and the path it replaces; its backward (fp32) against
    autograd through the plain version."""
    import torch
    from stp3_tpu_torch.models.stp3 import lift_depth_context
    from stp3_tpu_torch.ops.kernels import bev_splat as K1
    from stp3_tpu_torch.ops.kernels import lift_splat as K4
    feat, logits, ranks, rays, ncells = k4_inputs(cfg, device)
    f, p = ranks.shape
    c = feat.shape[-1]
    ctx, dp = feat.reshape(f, -1, c), depth_probs(logits)
    acc_k = K4.lift_splat_accumulate(ctx, dp, ranks, rays, ncells)
    acc_p = K4.lift_splat_accumulate_plain(ctx, dp, ranks, rays, ncells)
    torch.cuda.synchronize()
    err = (acc_k - acc_p).abs().max().item()
    ok = torch.allclose(acc_k, acc_p, rtol=1e-4, atol=1e-3)
    # the timed window: zeroing the (F, ncells, C) fp32 sums, the kernel and
    # the cast of the sums to bf16
    ms = device_ms(lambda: K4.lift_splat_frames(ctx, dp, ranks, rays, ncells))
    call_ms = time_ms(lambda: K4.lift_splat_frames(ctx, dp, ranks, rays, ncells))
    flush = torch.empty(32 * 2 ** 20, device=device)          # 128 MB of fp32
    cold = cold_ms(lambda: K4.lift_splat_frames(ctx, dp, ranks, rays, ncells), flush)
    del flush
    plain_ms = device_ms(lambda: K4.lift_splat_plain(ctx, dp, ranks, rays, ncells))
    # from the same encoder outputs: softmax + K4, against the lift + K1
    fused_ms = device_ms(lambda: K4.lift_splat_frames(ctx, depth_probs(logits), ranks, rays,
                                                      ncells))
    materialised_ms = device_ms(lambda: K1.bev_splat(
        lift_depth_context(feat, logits).reshape(f, -1, c), ranks, ncells))
    valid = (ranks < ncells).sum().item()
    bound_ms, bound_by, n_bytes = k4_bound(ctx, dp, ranks, rays, ncells)
    rows = K1.atomic_rows_per_landed_point(ranks, ncells, K4.TILE)
    ptxas = ' | '.join(ptxas_summary(K4.build()['log']))
    say(f'[K4] lift_splat F={f} R={ctx.shape[1]} P={p} C={c} ncells={ncells} bf16, invalid share '
        f'{1 - valid / (f * p):.4f}: max_abs_err {err:.3e} (rtol 1e-4, atol 1e-3) '
        f'{"OK" if ok else "MISMATCH"}; kernel {ms:.4f} ms (zeroing the fp32 sums, the kernel, '
        f'the cast to bf16; {call_ms:.4f} ms a call with the host\'s issue time, {cold:.4f} ms '
        f'with the L2 evicted), plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}, '
        f'{n_bytes / 1e6:.1f} MB), bound_share {bound_ms / ms:.3f}; atomic rows per landed '
        f'point {rows:.4f} (tile {K4.TILE}); from the encoder outputs: softmax + K4 '
        f'{fused_ms:.4f} ms, lift + K1 (materialised) {materialised_ms:.4f} ms; no single '
        f'PyTorch call computes this function; ptxas: {ptxas}')
    if not ok:
        fail('K4 disagrees with its plain version')

    g = torch.randn(f, ncells, c, generator=torch.Generator(device=device).manual_seed(SEED + 1),
                    device=device)
    grads = []
    for fn in (K4.lift_splat_frames, K4.lift_splat_plain):
        a = ctx.float().requires_grad_(True)
        b = dp.float().requires_grad_(True)
        reset_launches()
        fn(a, b, ranks, rays, ncells).backward(g)
        grads.append((a.grad, b.grad, read_launches()))
    (ga, gb, lk), (wa, wb, lp) = grads
    expect_launches('K4 forward + backward', lk, lift_splat=1, gather_rows=1)
    expect_launches('plain lift + splat forward + backward', lp)
    errs = [(x - y).abs().max().item() for x, y in ((ga, wa), (gb, wb))]
    # fp32 on both sides; index_add_ over ray ids and the atomics reorder sums
    if not (torch.allclose(ga, wa, rtol=1e-4, atol=1e-4)
            and torch.allclose(gb, wb, rtol=1e-4, atol=1e-4)):
        fail(f'K4 backward differs from the plain autograd: d ctx {errs[0]:.3e}, d dp '
             f'{errs[1]:.3e} (rtol 1e-4, atol 1e-4)')
    say(f'[K4] backward (fp32, K3 row gather + index_add_ over ray ids) vs autograd through the '
        f'plain version within rtol 1e-4, atol 1e-4: d ctx max_abs_err {errs[0]:.3e}, d dp '
        f'{errs[1]:.3e}')
    return dict(shape=f'F={f} R={ctx.shape[1]} P={p} C={c} ncells={ncells} bf16',
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, bound_share=bound_ms / ms, call_ms=call_ms,
                cold_ms=cold, atomic_rows_per_landed_point=rows,
                materialised_ms=materialised_ms, fused_path_ms=fused_ms)


def to_torch(arrays, device, dtype=None):
    import torch
    return [torch.as_tensor(a, device=device) if dtype is None or not np.issubdtype(
        a.dtype, np.floating) else torch.as_tensor(a, device=device).to(dtype) for a in arrays]


def build_model(cfg, fused: bool = False):
    import torch
    from stp3_tpu_torch.layers.base import init_parameters
    from stp3_tpu_torch.models.stp3 import STP3
    model = STP3(dataclasses.replace(model_cfg(cfg), fused_lift_splat=fused))
    init_parameters(model, torch.Generator().manual_seed(SEED))
    return model.eval()


def plan_step(model, image, k, e, ego, trajs, gt, commands, target):
    """bench.py's timed step: forward, occupancy, plan."""
    import torch
    rf = model.cfg.receptive_field
    out = model(image, k, e, ego)
    seg = out['segmentation'].argmax(-1)
    ped = out['pedestrian'].argmax(-1)
    occupancy = torch.logical_or(seg, ped).float()
    _, traj = model.plan(out['cam_front'], trajs, gt, out['costvolume'][:, rf:],
                         occupancy[:, rf:], out['hdmap'], commands, target)
    return out, traj


def close(name, got, want, atol=2e-3, rtol=1e-3):
    import torch
    got, want = got.float().cpu(), want.float().cpu()
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, atol=atol, rtol=rtol):
        fail(f'device parity: {name} max_abs_err {err:.3e} (atol {atol}, rtol {rtol})')
    return err


def planner_costs(model, plan_args):
    """The planner's (cost_fc, cost_fo) for plan()'s arguments."""
    _, trajs, _, cost_volume, occupancy, hd_map, commands, target = plan_args
    cur = model.planner.select_trajs_by_command(trajs, commands)
    lane_divider, drivable = model.planner.split_hdmap(hd_map)
    return model.planner.cost_fn(cost_volume, cur[..., :2], occupancy, lane_divider,
                                 drivable, target)


def phase_parity(tiny_cfg, device):
    """The tiny model in fp32, CPU (plain versions) vs CUDA (kernels)."""
    import torch
    from stp3_tpu_torch.utils.precision import pin_fp32_math
    pin_fp32_math()
    cpu_model = build_model(tiny_cfg)
    gpu_model = copy.deepcopy(cpu_model).to(device)
    (image, k, e, ego), ex = example_inputs(tiny_cfg)
    rf = tiny_cfg.TIME_RECEPTIVE_FIELD
    errs = {}
    with torch.inference_mode():
        out_c = cpu_model(*to_torch((image, k, e, ego), 'cpu'))
        out_g = gpu_model(*to_torch((image, k, e, ego), device))
        for key, v in out_c.items():
            if v is None:
                if out_g[key] is not None:
                    fail(f'device parity: {key} is None on CPU only')
                continue
            errs[key] = close(key, out_g[key], v)
        seg_c, ped_c = out_c['segmentation'].argmax(-1), out_c['pedestrian'].argmax(-1)
        occ = torch.logical_or(seg_c, ped_c).float()[:, rf:]
        traj_in = to_torch((ex['trajs'], ex['gt_trajs'], ex['commands'],
                            ex['target_points']), 'cpu')
        for code in (1, 2):                   # FORWARD, RIGHT
            cmd = torch.tensor([code])
            args_c = (out_c['cam_front'], traj_in[0], traj_in[1],
                      out_c['costvolume'][:, rf:], occ, out_c['hdmap'], cmd, traj_in[3])
            args_g = tuple(a.to(device) for a in args_c)
            # the same inputs on both sides: costs first, then the selection
            fc_c, fo_c = planner_costs(cpu_model, args_c)
            fc, fo = planner_costs(gpu_model, args_g)
            errs[f'cost_fc[{code}]'] = close(f'cost_fc cmd {code}', fc, fc_c)
            errs[f'cost_fo[{code}]'] = close(f'cost_fo cmd {code}', fo, fo_c)
            _, traj_c = cpu_model.plan(*args_c)
            _, traj_g = gpu_model.plan(*args_g)
            errs[f'traj[{code}]'] = close(f'refined traj cmd {code}', traj_g, traj_c)
    worst = max(errs, key=errs.get)
    say(f'[parity] tiny model fp32, CPU vs CUDA (TF32 off: matmul '
        f'{torch.backends.cuda.matmul.allow_tf32}, cudnn {torch.backends.cudnn.allow_tf32}): '
        f'{len(errs)} outputs within atol 2e-3 rtol 1e-3; worst {worst} {errs[worst]:.3e}')


def phase_flagship(cfg, device, card, fused: bool = False):
    """The serving forward + plan at full width under the bf16 policy;
    ``fused``: with the fused lift + splat (K4 in place of the lift and
    K1). Returns the launches of one step."""
    import torch
    from stp3_tpu_torch.utils.precision import policy_dtype
    tag = '[fused]' if fused else '[flagship]'
    t0 = time.perf_counter()
    dt = policy_dtype(cfg)
    model = build_model(cfg, fused).to(device=device, dtype=dt)
    n_params = sum(p.numel() for p in model.parameters())
    (image, k, e, ego), ex = example_inputs(cfg)
    image, = to_torch((image,), device, dt)
    k, e, ego = to_torch((k, e, ego), device)                    # geometry stays fp32
    trajs, gt, target = to_torch((ex['trajs'], ex['gt_trajs'], ex['target_points']),
                                 device, dt)
    commands, = to_torch((ex['commands'],), device)
    say(f'{tag} {n_params} params, {dt}, built in {time.perf_counter() - t0:.1f} s')
    with torch.inference_mode():
        reset_launches()
        out, traj = plan_step(model, image, k, e, ego, trajs, gt, commands, target)
        launches = read_launches()
        if fused:
            expect_launches('fused forward + plan', launches, lift_splat=1, convnext_mlp=2)
        else:
            expect_launches('forward + plan', launches, bev_splat=1, convnext_mlp=2)
        for key, v in out.items():
            if v is not None and not torch.isfinite(v.float()).all():
                fail(f'flagship output {key} is not finite')
        if tuple(traj.shape) != (1, cfg.N_FUTURE_FRAMES, 3) or not torch.isfinite(
                traj.float()).all():
            fail(f'refined trajectory {tuple(traj.shape)} not finite of shape (1, 6, 3)')
        shapes = {key: tuple(v.shape) for key, v in out.items() if v is not None}
        say(f'{tag} outputs finite: {shapes}; traj {tuple(traj.shape)} '
            f'{traj[0, :, :2].float().cpu().numpy().round(3).tolist()}')
        say(f'{tag} launches per forward: {launches}')
        torch.cuda.reset_peak_memory_stats()

        def step():
            return plan_step(model, image, k, e, ego, trajs, gt, commands, target)

        p50 = time_ms(step, warmup=3, iters=20)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        say(f'{tag} forward+plan p50 {p50:.2f} ms (median of 20, CUDA events), '
            f'peak memory {peak:.2f} GiB, on {card}')
        if '--profile' in sys.argv[1:]:
            profile_window(lambda i: step(), f'{tag} forward+plan', card)
        if fused:
            fused_vs_materialised(model, step, card)
    return launches


TURNS = (False, True, True, False, False, True, True, False)   # fused_lift_splat, in turns


def fused_vs_materialised(model, step, card) -> None:
    """[fused turns]: the serving step with the fused and the materialised
    splat of the same weights, in ``TURNS`` (4 turns each, alternating),
    p50 of 20 steps a turn. With --profile also, per turn: the host's time
    to issue a step (from a drained device: the call's own time, then the
    wait for the device), the card's SM clock and power while the p50 ran,
    and a torch.profiler window of 3 steps (device events and time a step,
    the device's busy share and largest idle gaps); then per variant the
    kernels that take the most and the host ops whose time a step differs
    most between the two."""
    import torch
    profiling = '--profile' in sys.argv[1:]
    names = {False: 'materialised', True: 'fused'}
    p50s = {False: [], True: []}
    windows = {False: [], True: []}
    for turn in TURNS:
        model.cfg = dataclasses.replace(model.cfg, fused_lift_splat=turn)
        if not profiling:
            p50s[turn].append(time_ms(step, warmup=3, iters=20))
            continue
        sampler = smi_sampler()
        try:
            p50s[turn].append(time_ms(step, warmup=3, iters=20))
        finally:
            clock, power = smi_stop(sampler)
        issue, tail = [], []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            issue.append((t1 - t0) * 1e3)
            tail.append((time.perf_counter() - t1) * 1e3)
        window = profile_steps(lambda i: step())
        windows[turn].append(window)
        say(f'[fused turns] {names[turn]}: p50 {p50s[turn][-1]:.2f} ms; host issue p50 '
            f'{np.median(issue):.2f} ms, then the device {np.median(tail):.2f} ms; SM clock '
            f'{clock} MHz, power {power} W (medians while the p50 ran); profiled: '
            f'{window["events"]:.0f} device events, {window["busy_ms"]:.2f} ms device time and '
            f'{window["wall_ms"]:.2f} ms wall a step (busy '
            f'{window["busy_ms"] / window["wall_ms"]:.3f}), '
            f'largest idle gaps {", ".join(f"{g:.2f}" for g in window["gaps"])} ms')
    say(f'[fused turns] in turns ({", ".join(names[t] for t in TURNS)}; p50 of 20 steps each): '
        f'materialised {" / ".join(f"{t:.2f}" for t in p50s[False])} ms (median '
        f'{np.median(p50s[False]):.2f}), fused {" / ".join(f"{t:.2f}" for t in p50s[True])} ms '
        f'(median {np.median(p50s[True]):.2f}), on {card}')
    if not profiling:
        return
    per_step = {}
    for turn in (False, True):
        kernels, host = {}, {}
        for w in windows[turn]:
            for table, part in ((kernels, w['kernels']), (host, w['host'])):
                for name, (ms, k) in part.items():
                    t, n = table.get(name, (0.0, 0.0))
                    table[name] = (t + ms / len(windows[turn]), n + k / len(windows[turn]))
        per_step[turn] = host
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
        say(f'[fused turns] {names[turn]}, device kernels a step (mean of the turns): '
            + '; '.join(f'{ms:.3f} ms x{k:.0f} {name[:70]}' for name, (ms, k) in top))
    ops = set(per_step[False]) | set(per_step[True])

    def diff(name):
        return per_step[True].get(name, (0.0, 0))[0] - per_step[False].get(name, (0.0, 0))[0]

    say('[fused turns] host ops whose self time a step differs most (fused - materialised; '
        'ms a step, calls a step): ' + '; '.join(
            f'{name[:50]} {diff(name):+.3f} ms ({per_step[False].get(name, (0, 0))[1]:.0f} -> '
            f'{per_step[True].get(name, (0, 0))[1]:.0f} calls)'
            for name in sorted(ops, key=lambda n: -abs(diff(n)))[:12]))


def smi_sampler():
    """nvidia-smi sampling the SM clock and power draw every 100 ms."""
    return subprocess.Popen(['nvidia-smi', '--query-gpu=clocks.sm,power.draw',
                             '--format=csv,noheader,nounits', '-lms', '100'],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)


def smi_stop(proc):
    """Stop an ``smi_sampler``; (median SM clock, median power) of its samples."""
    proc.terminate()
    out, _ = proc.communicate(timeout=30)
    rows = [line.split(',') for line in out.splitlines() if line.count(',') == 1]
    try:
        vals = np.array([[float(a), float(b)] for a, b in rows])
    except ValueError:
        return 'unread', 'unread'
    if not len(vals):
        return 'unread', 'unread'
    clock, power = np.median(vals, 0)
    return f'{clock:.0f}', f'{power:.1f}'


def phase_fused(cfg, device, card):
    """[fused]: the fp32 BEV features of the fused (K4) and materialised
    (lift, then K1) paths of one seeded full-width model, then the fused
    forward + plan under the bf16 policy. Returns the launches of one step."""
    import torch
    model = build_model(cfg).to(device)
    (image, k, e, ego), _ = example_inputs(cfg)
    image, k, e, ego = to_torch((image, k, e, ego), device)
    with torch.inference_mode():
        want, _, _ = model.calculate_birds_eye_view_features(image, k, e, ego)
        model.cfg = dataclasses.replace(model.cfg, fused_lift_splat=True)
        reset_launches()
        got, _, _ = model.calculate_birds_eye_view_features(image, k, e, ego)
        expect_launches('fp32 fused BEV features', read_launches(), lift_splat=1)
        err = (got - want).abs().max().item()
        ok = torch.allclose(got, want, rtol=1e-4, atol=1e-3)
    say(f'[fused] fp32 BEV features {tuple(got.shape)} of the fused path (K4) vs the '
        f'materialised one (lift, then K1), same weights: max_abs_err {err:.3e} of max '
        f'{want.abs().max().item():.3e} (rtol 1e-4, atol 1e-3) {"OK" if ok else "MISMATCH"}')
    if not ok:
        fail('fused and materialised BEV features differ')
    del model, got, want
    torch.cuda.empty_cache()
    return phase_flagship(cfg, device, card, fused=True)


CAMS = ('rgb', 'rgb_left', 'rgb_right', 'rgb_rear')
AGENT_MODES = (('full', dict(incremental=False)),
               ('incremental', dict(incremental=True, static_geometry=False)),
               ('static', dict(incremental=True, static_geometry=True)))
HEADS = ('segmentation', 'pedestrian', 'hdmap', 'costvolume')


def recorded_ticks(n: int):
    """n seeded CARLA sensor ticks: uint8 300x400 frames of the four
    cameras, the GPS 2 m further each tick, heading 0."""
    rng = np.random.RandomState(SEED)
    for t in range(n):
        yield ({key: rng.randint(0, 256, (300, 400, 3), np.uint8) for key in CAMS},
               np.array([2.0 * t, 0.0]), 0.0)


def selected(model, plan_args):
    """Index of the candidate the planner selects before refinement."""
    import torch
    fc, fo = planner_costs(model, plan_args)
    return torch.argmin(fc + fo.sum(-1), -1).tolist()


def serve_plan_args(model, out, trajs, commands, target):
    import torch
    rf = model.cfg.receptive_field
    occ = torch.logical_or(out['segmentation'].argmax(-1), out['pedestrian'].argmax(-1)).float()
    return (out['cam_front'], trajs, torch.zeros(1, model.cfg.n_future, 3, device=trajs.device),
            out['costvolume'][:, rf:], occ[:, rf:], out['hdmap'], commands, target)


def phase_agent(device, card):
    """[agent]: the CARLA Planning stage at full width, seeded fp32 weights:
    the serving methods against the full forward, then AgentCore's three
    tick modes. Returns (K1's numbers at the agent's splat, the launches of
    one steady tick of each mode)."""
    import torch
    from stp3_tpu_torch.datas.carla import carla_cam_rig, scale_and_crop_image
    from stp3_tpu_torch.deploy.agent_core import AgentCore
    from stp3_tpu_torch.models.stp3 import context_depth_rays, lift_depth_context
    from stp3_tpu_torch.ops.bev_pool import prewarped_ranks, project_to_birds_eye_view
    from stp3_tpu_torch.ops.static_splat import build_column_splat_plan, column_splat
    from stp3_tpu_torch.utils import sampler
    from stp3_tpu_torch.utils.network import prepare_image
    cfg = carla_planning_cfg()
    t0 = time.perf_counter()
    model = build_model(cfg).to(device)
    mc, rf = model.cfg, cfg.TIME_RECEPTIVE_FIELD
    say(f'[agent] CARLA Planning stage: {sum(p.numel() for p in model.parameters())} fp32 '
        f'params, {len(cfg.IMAGE.NAMES)} cameras at {tuple(mc.final_dim)}, BEV {mc.bev_size} at '
        f'{mc.x_bound[2]} m, D={mc.depth_channels}, rf {rf}, {mc.n_future} future frames, '
        f'{mc.sample_num} candidates, GRU {mc.gru_state_size}; built in '
        f'{time.perf_counter() - t0:.1f} s')

    # K1 at the agent's dynamic single-frame splat: the CARLA rig, F=1
    geometry, ego, (res, start, dim) = rig_geometry(cfg, device, carla=True)
    k1 = phase_k1(cfg, device, 'agent',
                  ranks=prewarped_ranks(geometry[:, -1:], ego[:, -1:], res, start, dim))

    # the serving methods against the full forward at zero ego-motion
    extr, intr = carla_cam_rig(mc.final_dim)
    t0 = time.perf_counter()
    arrays = build_column_splat_plan(model.frustum, intr, extr, model.bev_resolution,
                                     model.bev_start_position,
                                     model.bev_dimension).device_arrays(device)
    plan_s = time.perf_counter() - t0
    crop = mc.final_dim[0]
    frames = np.stack([np.stack([scale_and_crop_image(fr[key], 1.0, crop) for key in CAMS])
                       for fr, _, _ in recorded_ticks(rf)])[None]        # (1, rf, 4, H, W, 3)
    images = prepare_image(torch.as_tensor(frames, device=device), torch.float32)
    k, e = (torch.as_tensor(np.tile(a, (1, rf, 1, 1, 1)), device=device) for a in (intr, extr))
    ego0 = torch.zeros(1, rf, 6, device=device)
    trajs = torch.as_tensor(sampler.sample_trajectories(
        3.0, 0.0, mc.n_future, mc.sample_num, rng=np.random.RandomState(SEED))[None, :, 1:],
        dtype=torch.float32, device=device)
    commands = torch.tensor([1], device=device)
    target = torch.tensor([[0.0, 5.0]], device=device)
    with torch.inference_mode():
        bev_d, _ = model.splat_single_frame(images[:, -1], k[:, -1], e[:, -1])
        bev_s, _ = model.splat_single_frame_static(images[:, -1], arrays)
        err = (bev_s - bev_d).abs().max().item()
        if not torch.allclose(bev_s, bev_d, rtol=1e-4, atol=1e-3):
            fail(f'static and dynamic single-frame splats differ: max_abs_err {err:.3e}')
        say(f'[agent] single-frame splat {tuple(bev_d.shape)} fp32, static (column plan, built '
            f'in {plan_s:.2f} s, mask {tuple(arrays["mask"].shape)}) vs dynamic (K1): max_abs_err '
            f'{err:.3e} of max {bev_d.abs().max().item():.3e} (rtol 1e-4, atol 1e-3) OK')
        out_f = model(images, k, e, ego0)
        args_f = serve_plan_args(model, out_f, trajs, commands, target)
        _, traj_f = model.plan(*args_f)
        pick_f = selected(model, args_f)
        cache = {name: torch.stack([split(t) for t in range(rf - 1)], 1) for name, split in (
            ('incremental', lambda t: model.splat_single_frame(images[:, t], k[:, t], e[:, t])[0]),
            ('static', lambda t: model.splat_single_frame_static(images[:, t], arrays)[0]))}
        served = {'incremental': model.serve_step(images[:, -1], k[:, -1], e[:, -1], ego0,
                                                  cache['incremental'], trajs, commands, target),
                  'static': model.serve_step_static(images[:, -1], ego0, cache['static'], trajs,
                                                    commands, target, arrays)}
        for name, (traj, out, _) in served.items():
            errs = {key: (out[key] - out_f[key]).abs().max().item() for key in HEADS}
            # tests/test_serving.py:69-73's tolerance (rtol = atol = 1e-4), atol
            # doubled: the full forward splats its frames in one K1 launch, the
            # tick each frame alone, so the fp32 atomics sum in other orders
            # (which change from run to run), and the identity warp of the
            # cached frames is exact only to the rounding of its sampling
            # coordinates; through the 200x200 fp32 BEV stack that moves the
            # heads by up to ~1e-4 (9.6e-5 and 1.02e-4 in two runs)
            share = max(((out[key] - out_f[key]).abs() / (2e-4 + 1e-4 * out_f[key].abs()))
                        .max().item() for key in HEADS)
            ok = share <= 1.0
            pick = selected(model, serve_plan_args(model, out, trajs, commands, target))
            d_traj = (traj - traj_f).abs().max().item()
            say(f'[agent] {name} tick vs full forward at zero ego-motion: heads max_abs_err '
                f'{ {key: float(f"{v:.3e}") for key, v in errs.items()} } (rtol 1e-4, atol 2e-4; '
                f'{share:.2f} of the tolerance used) {"OK" if ok else "MISMATCH"}; selected '
                f'candidate {pick} vs {pick_f}; refined trajectory max_abs_err {d_traj:.3e}')
            if not ok:
                fail(f'{name} tick heads differ from the full forward at zero ego-motion')
            if pick == pick_f and not torch.allclose(traj, traj_f, rtol=1e-4, atol=1e-4):
                fail(f'{name} tick trajectory differs from the full forward\'s with the same '
                     f'selected candidate')
        # the single-frame splat alone, from the encoder's outputs: the lift
        # and K1 (dynamic) against the column plan (static)
        feat, depth = model.encode(images[:, -1].reshape(-1, *images.shape[3:]))
        feat = feat.reshape(1, -1, *feat.shape[1:])
        depth5 = depth.reshape(1, -1, *depth.shape[1:])
        zero = torch.zeros(1, 1, 6, device=device)
        ctx, dp = context_depth_rays(mc, feat, depth)
        dyn_ms = time_ms(lambda: project_to_birds_eye_view(
            lift_depth_context(feat, depth5)[:, None], geometry[:, -1:], zero, res, start, dim))
        sta_ms = time_ms(lambda: column_splat(ctx, dp, arrays, (
            feat.shape[1], feat.shape[2], feat.shape[3], mc.depth_channels, mc.bev_dimension)))
        say(f'[agent] single-frame splat from the encoder outputs, fp32: lift + K1 {dyn_ms:.3f} '
            f'ms, column plan (mask product, context product, sorted index_add_) {sta_ms:.3f} ms '
            f'(CUDA events, median of 20)')
    del out_f, served, cache

    # the three tick modes through AgentCore: 2 checked ticks, then 20 timed
    per_tick, n_timed = {}, 20
    for mode, kw in AGENT_MODES:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        core = AgentCore(cfg, model, device=device, **kw)
        setup_s = time.perf_counter() - t0
        controls, push_ms, plan_ms, sample_ms = [], [], [], []
        for t, (frame, gps, theta) in enumerate(recorded_ticks(rf + 3 + n_timed)):
            t0 = time.perf_counter()
            core.push_frame(frame, gps, theta)
            push_ms.append((time.perf_counter() - t0) * 1e3)
            if not core.warmed_up:
                continue
            np.random.seed(SEED + t)              # the sampler draws from the module RNG
            if len(controls) == 2:
                reset_launches()
            t0 = time.perf_counter()
            controls.append(core.plan_step(3.0, 4, np.array([0.0, 5.0])))
            plan_ms.append((time.perf_counter() - t0) * 1e3)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        for _ in range(n_timed):                  # the sampler alone: host work of a tick
            t0 = time.perf_counter()
            sampler.sample_trajectories(3.0, 0.0, mc.n_future, mc.sample_num)
            sample_ms.append((time.perf_counter() - t0) * 1e3)
        if len(plan_ms) != 2 + n_timed:
            fail(f'agent {mode}: {len(plan_ms)} planned ticks, expected {2 + n_timed}')
        for steer, throttle, brake, _ in controls:
            if not (np.isfinite([steer, throttle]).all() and -1.0 <= steer <= 1.0
                    and 0.0 <= throttle <= 0.75 and isinstance(brake, bool)):
                fail(f'agent {mode}: control out of range: {(steer, throttle, brake)}')
        per = {name: n / n_timed for name, n in launches.items()}
        expect_launches(f'agent {mode} tick', per, **({} if mode == 'static' else {'bev_splat': 1}))
        per_tick[mode] = {name: int(n) for name, n in per.items()}
        first = [tuple(round(float(v), 4) for v in c[:3]) for c in controls[:2]]
        say(f'[agent] {mode}: set-up (incl. warm-up{", column plan" if mode == "static" else ""}) '
            f'{setup_s:.2f} s; first two planned ticks (steer, throttle, brake) {first}; '
            f'plan_step p50 {float(np.median(plan_ms[2:])):.2f} ms (median of {n_timed} ticks, '
            f'wall clock, host included; spread {min(plan_ms[2:]):.2f}-{max(plan_ms[2:]):.2f}), '
            f'push_frame (crop) p50 {float(np.median(push_ms)):.3f} ms, of which host work: '
            f'trajectory sampling p50 {float(np.median(sample_ms)):.2f} ms; launches per tick '
            f'{ {n: v for n, v in per_tick[mode].items() if v} }; peak memory {peak:.2f} GiB; '
            f'on {card}')
        if '--profile' in sys.argv[1:]:
            profile_ticks(core, mode, card)
    return k1, per_tick


def profile_steps(run, n: int = 3, n_gaps: int = 3) -> dict:
    """torch.profiler over ``n`` calls of ``run(i)``, a call at a time:
    wall time, device events and summed device time, the device's
    ``n_gaps`` largest idle gaps (ms), and by name the device kernels' and
    the host ops' self time (ms) and counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            run(i)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    kernels = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    gaps, end = [], None
    for e in kernels:
        if end is not None and e.time_range.start > end:
            gaps.append((e.time_range.start - end) / 1e3)
        end = e.time_range.end if end is None else max(end, e.time_range.end)
    by_name = {}
    for e in kernels:
        t, k = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3 / n, k + 1 / n)
    host = {a.key: (a.self_cpu_time_total / 1e3 / n, a.count / n) for a in prof.key_averages()
            if a.device_type == torch.autograd.DeviceType.CPU}
    return dict(wall_ms=wall, events=len(kernels) / n,
                busy_ms=sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n,
                gaps=sorted(gaps, reverse=True)[:n_gaps], kernels=by_name, host=host)


def profile_window(run, what: str, card, n: int = 3, top: int = 6) -> None:
    """Where the time of ``n`` calls of ``run(i)`` goes (--profile):
    torch.profiler's device events and summed device time per call beside
    the wall time per call, and the kernels that take the most."""
    w = profile_steps(run, n)
    say(f'[profile] {what}: {n} under torch.profiler, {w["wall_ms"]:.2f} ms of wall time, '
        f'{w["events"]:.0f} device events and {w["busy_ms"]:.2f} ms of summed device time each '
        f'(device busy {w["busy_ms"] / w["wall_ms"]:.2f} of the wall time); on {card}')
    for name, (ms, k) in sorted(w['kernels'].items(), key=lambda kv: -kv[1][0])[:top]:
        say(f'[profile]   {ms:8.2f} ms each {k:6.0f} calls each  {name[:110]}')


def profile_ticks(core, mode: str, card, ticks: int = 3):
    """Where an agent tick's time goes (--profile): ``ticks`` planned ticks."""
    frames = list(recorded_ticks(ticks))

    def tick(i):
        core.push_frame(*frames[i])
        core.plan_step(3.0, 4, np.array([0.0, 5.0]))

    profile_window(tick, f'agent {mode} tick', card, ticks)


def synthetic_batches(cfg, n_batches: int, device):
    """``n_batches`` batches of cfg.BATCHSIZE synthetic samples, on the device."""
    from stp3_tpu_torch.datas.synthetic import SyntheticDataset, collate
    from stp3_tpu_torch.training.trainer import batch_to_device
    b = int(cfg.BATCHSIZE)
    ds = SyntheticDataset(cfg, n_samples=b * n_batches, seed=SEED)
    return [batch_to_device(collate([ds[j] for j in range(i * b, (i + 1) * b)]), device)
            for i in range(n_batches)]


def step_grads(trainer, batch, noise, outputs=None):
    """(loss dict, {name: gradient}) of one step without the optimizer;
    ``outputs``, a list, receives every module's output of the forward."""
    import torch
    keep = (lambda m, i, o: outputs.append(o.detach().double().cpu())
            if isinstance(o, torch.Tensor) else None)
    hooks = [m.register_forward_hook(keep) for m in trainer.model.modules()] if (
        outputs is not None) else []
    trainer.optimizer.zero_grad(set_to_none=True)
    total, loss = trainer.loss_fn(batch, noise=noise, dropout=False)
    n_forward = len(outputs or ())
    total.backward()
    for hook in hooks:
        hook.remove()
    if outputs is not None:
        del outputs[n_forward:]           # REMAT's recomputation in the backward
    return ({k: v.item() for k, v in loss.items()},
            {n: p.grad.double().cpu() for n, p in trainer.model.named_parameters()})


def phase_train_parity(tiny_cfg, device):
    """One tiny fp32 train step on CUDA (kernels) and on the CPU (plain
    versions), each against the same step in float64 on the CPU (PRECISION
    64): the same seeded weights, one batch, dropout off, one fixed noise
    draw, TF32 off. The CUDA step's loss terms at rtol 1e-4; its gradients
    at a relative L2 error below 1e-2 each and below 1e-3 in the median
    over the parameters. Why not 1e-3 each: in fp32 an element whose
    pre-activation lies within rounding of zero can take the other side of
    a ReLU, and on this tiny model one such element moves every gradient
    upstream of it by up to a few 1e-3, on either device. The line prints
    both fp32 steps' distances from the float64 one and their sign flips
    (module-output elements whose sign differs from the float64 forward)."""
    import torch
    from stp3_tpu_torch.training.trainer import Trainer
    from stp3_tpu_torch.utils.precision import pin_fp32_math
    pin_fp32_math()
    cpu = Trainer(tiny_cfg, device='cpu', seed=SEED)
    ref_cfg = tiny_cfg.clone()
    ref_cfg.PRECISION = 64
    batch, = synthetic_batches(tiny_cfg, 1, 'cpu')
    noise = torch.from_numpy(np.random.RandomState(SEED).randn(
        int(tiny_cfg.BATCHSIZE), 1, tiny_cfg.MODEL.DISTRIBUTION.LATENT_DIM).astype(np.float32))
    steps = {}
    for name, trainer in (
            ('float64', Trainer(ref_cfg, device='cpu', model=copy.deepcopy(cpu.model))),
            ('CUDA', Trainer(tiny_cfg, device=device, model=copy.deepcopy(cpu.model))),
            ('CPU', cpu)):
        outputs = []
        dev = trainer.device
        steps[name] = step_grads(trainer, {k: v.to(dev) for k, v in batch.items()},
                                 noise.to(dev), outputs) + (outputs,)
    loss_r, grads_r, outputs_r = steps.pop('float64')
    parts = []
    for name, (loss, grads, outputs) in steps.items():
        errs = {n: ((grads[n] - g).norm() / g.norm().clamp_min(1e-300)).item()
                for n, g in grads_r.items()}
        worst = max(errs, key=errs.get)
        median = float(np.median(list(errs.values())))
        flips = sum(int(((o > 0) != (r > 0)).sum()) for o, r in zip(outputs, outputs_r))
        parts.append(f'{name} fp32: median {median:.2e}, {sum(e >= 1e-3 for e in errs.values())} '
                     f'above 1e-3, worst {errs[worst]:.2e} ({worst}), {flips} sign flips')
        if name != 'CUDA':
            continue
        for key, want in loss_r.items():
            if not np.isclose(loss[key], want, rtol=1e-4, atol=1e-7):
                fail(f'train parity: loss {key} {loss[key]} on CUDA vs {want} in float64')
        if errs[worst] >= 1e-2 or median >= 1e-3:
            fail(f'train parity: CUDA gradients vs the float64 step: worst {worst} '
                 f'{errs[worst]:.3e} (limit 1e-2), median {median:.3e} (limit 1e-3)')
    say(f'[train parity] tiny step, {len(grads_r)} gradients against the float64 step on the '
        f'CPU (TF32 off); CUDA loss terms within rtol 1e-4, gradients within relative L2 1e-2 '
        f'and 1e-3 in the median. ' + '; '.join(parts))


def phase_train(cfg, device, card):
    """The Planning stage's training at full width and batch cfg.BATCHSIZE."""
    import torch
    from stp3_tpu_torch.training.trainer import Trainer
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=device, seed=SEED)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    batches = synthetic_batches(cfg, 2, device)
    b = int(cfg.BATCHSIZE)
    say(f'[train] {n_params} fp32 master params, compute {trainer.compute_dtype}, REMAT '
        f'{cfg.MODEL.REMAT!r}, batch {b}; built with 2 synthetic batches in '
        f'{time.perf_counter() - t0:.1f} s')
    before = [p.detach().clone() for p in trainer.model.parameters()]

    reset_launches()
    losses = [trainer.train_step(batches[0])]
    launches = read_launches()
    expect_launches('one train step', launches, bev_splat=1, gather_rows=1, convnext_mlp=2)
    say(f'[train] launches in one train step: {launches}')

    for i in range(2):                                           # warm-up
        losses.append(trainer.train_step(batches[i % 2]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(10):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(trainer.train_step(batches[i % 2]))
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for step, loss in enumerate(losses):
        bad = [k for k, v in loss.items() if not torch.isfinite(v).all()]
        if bad:
            fail(f'train step {step}: loss terms {bad} are not finite')
    changed = sum(not torch.equal(a, p) for a, p in zip(before, trainer.model.parameters()))
    if changed < len(before) // 2:
        fail(f'only {changed} of {len(before)} parameter tensors changed in 13 steps')
    p50 = float(np.median(times))
    first, last = losses[0], losses[-1]
    say(f'[train] 13 steps finite; {changed} of {len(before)} parameter tensors changed; '
        f'total loss {first["total"].item():.4f} -> {last["total"].item():.4f}; terms of the '
        f'last step {({k: round(v.item(), 4) for k, v in last.items()})}')
    say(f'[train] step p50 {p50:.2f} ms (median of 10, CUDA events; spread '
        f'{min(times):.2f}-{max(times):.2f} ms), {b / p50 * 1e3:.3f} samples/s, peak memory '
        f'{peak:.2f} GiB, on {card}')
    return trainer, batches, launches


def profile_train(trainer, batches, card, steps: int = 3):
    """Where a train step's time goes (--profile)."""
    import torch

    def timed(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        return out, (start, end)

    parts = {'loss (labels, forward, losses)': [], 'backward': [], 'clip + Adam': [],
             'host issue of one step': []}
    for i in range(6):
        batch = batches[i % 2]
        trainer.optimizer.zero_grad(set_to_none=True)
        (total, _), ev_loss = timed(lambda: trainer.loss_fn(batch))
        _, ev_bwd = timed(total.backward)
        _, ev_opt = timed(lambda: (torch.nn.utils.clip_grad_norm_(
            trainer.model.parameters(), float(trainer.cfg.GRAD_NORM_CLIP)),
            trainer.optimizer.step()))
        torch.cuda.synchronize()
        for key, (a, b) in zip(parts, (ev_loss, ev_bwd, ev_opt)):
            parts[key].append(a.elapsed_time(b))
        t0 = time.perf_counter()
        trainer.train_step(batch)
        parts['host issue of one step'].append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    say('[profile] train step, median of 6 (ms): ' + ', '.join(
        f'{k} {float(np.median(v)):.2f}' for k, v in parts.items()) + f'; on {card}')

    profile_window(lambda i: trainer.train_step(batches[i % 2]), 'train step', card, steps,
                   top=15)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this script needs an NVIDIA GPU')
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)

    device = torch.device('cuda', 0)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else 'nvidia-smi failed'
    say(card)
    say(f'[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, CUDA '
        f'{torch.version.cuda}; TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, '
        f'cudnn {torch.backends.cudnn.allow_tf32}')

    build_kernels(repo)

    cfg, train_cfg = flagship_cfg(), planning_cfg()
    b = int(train_cfg.BATCHSIZE)
    # each kernel's numbers at the shapes of each path that launches it
    report = {
        'bev_splat': {'serving': phase_k1(cfg, device, 'serving'),
                      'train': phase_k1(train_cfg, device, 'train', b)},
        'convnext_mlp': {'serving': phase_k2(cfg, device, 'serving'),
                         'train': phase_k2(train_cfg, device, 'train', b)},
        'gather_rows': {'train': phase_k3(train_cfg, device)},
        'lift_splat': {'fused': phase_k4(cfg, device)},
    }
    phase_backward(train_cfg, device)
    per_frame, launches = phase_per_frame(cfg, device)
    launches = {'per_frame': launches}
    for name, numbers in per_frame.items():
        report[name] = {'per_frame': numbers}
    phase_parity(flagship_cfg(tiny=True), device)
    phase_train_parity(planning_cfg(tiny=True), device)
    launches['serving'] = phase_flagship(cfg, device, card)
    trainer, batches, launches['train'] = phase_train(train_cfg, device, card)
    if '--profile' in sys.argv[1:]:
        profile_train(trainer, batches, card)
    del trainer, batches
    torch.cuda.empty_cache()
    launches['fused'] = phase_fused(cfg, device, card)
    report['bev_splat']['agent'], per_tick = phase_agent(device, card)
    # the agent path: one steady tick of each of its three modes
    launches['agent'] = {name: sum(tick[name] for tick in per_tick.values())
                         for name in counters()}
    say('[launches] ' + '; '.join(f'{path} {launches[path]}' for path in PATHS)
        + f'; agent per tick {per_tick}')
    for name, *_, main_path in KERNELS:
        if not launches[main_path][name]:
            fail(f'{name} was never launched on its path {main_path!r}')

    kernels = []
    for name, route, source, replaces, main_path in KERNELS:
        paths = {path: dict(launches=launches[path][name], **report[name].get(path, {}))
                 for path in PATHS}
        paths['agent']['per_tick'] = {mode: tick[name] for mode, tick in per_tick.items()}
        top = {k: paths[main_path][k] for k in ('launches', 'max_abs_err', 'ms', 'plain_ms',
                                                'bound_ms', 'bound_by', 'library_ms')}
        kernels.append(dict(name=name, route=route, source=source, replaces=replaces, **top,
                            main_path=main_path, paths=paths))
    say(json.dumps({'kernels': kernels}))
    say(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                           'kind': torch.cuda.get_device_name(0),
                                           'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
