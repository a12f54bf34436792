#!/usr/bin/env python3
"""Drive the PyTorch port (stp3_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py              # every phase below
    python3 chip_smoke.py --profile    # ... then where a train step's time goes

Phases, each printing one line (or a few) before the last:
  1. device: card name and power limit, torch / CUDA versions, TF32 flags;
  2. build: nvcc-build the BEV splat kernels (K1 and K3) from csrc/;
  3. K1 vs its plain version at the serving (F=3) and training (F=6)
     splat shapes, ranks from the flagship rig's real geometry; times of
     both and of index_add_;
  4. K2 (fused ConvNeXt MLP, Triton) vs its plain version at the serving
     and training row counts; times of both;
  5. K3 (the splat's backward row gather) vs its plain version at the
     training shape (6, 483,840, 64), bf16 and fp32, bit for bit; times of
     both and of torch.gather;
  6. backward: K1's autograd Function (K3 backward) vs the plain splat's
     autograd at the training shape, bit for bit;
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
     parameters changed, step p50, samples/s and peak memory.
With --profile, after phase 10: the train step split by CUDA events into
loss (labels + forward + losses), backward and clip + Adam, the host's
time to issue a step, and a torch.profiler window of 3 steps (kernel
launches, summed kernel time, the kernels that take the most).
Then one JSON line with every kernel's numbers (the train path's at the
top level, each path's launches and times under "paths"), and last
{"ok": true, "device": {...}}. Any failure exits non-zero before that.
Without a CUDA device, or without the repository beside it, it fails.
"""
from __future__ import annotations

import copy
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


# the kernels: name, route, source, the TPU kernel each replaces
KERNELS = (
    ('bev_splat', 'cuda', 'stp3_tpu_torch/csrc/bev_pool.cu',
     'stp3_tpu/ops/pallas/bev_pool_kernel.py:262'),
    ('convnext_mlp', 'triton', 'stp3_tpu_torch/ops/kernels/convnext_mlp.py',
     'stp3_tpu/ops/pallas/convnext_mlp_kernel.py:124'),
    ('gather_rows', 'cuda', 'stp3_tpu_torch/csrc/bev_pool.cu',
     'stp3_tpu/ops/pallas/bev_pool_kernel.py:319'),
)


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


def splat_ranks(cfg, device, b: int = 1):
    """(F = b * rf, P) int32 ranks of the flagship rig's real frustum
    geometry, pre-warped by the example ego-motion, as the model splats."""
    import torch
    from stp3_tpu_torch.models.stp3 import STP3Config
    from stp3_tpu_torch.ops.bev_pool import prewarped_ranks
    from stp3_tpu_torch.ops.geometry import (calculate_birds_eye_view_parameters,
                                             create_frustum, get_geometry)
    mc = STP3Config.from_cfg(cfg)
    (_, k, e, ego), _ = example_inputs(cfg, b=b)
    res, start, dim = calculate_birds_eye_view_parameters(mc.x_bound, mc.y_bound,
                                                          mc.z_bound)
    fr = torch.as_tensor(create_frustum(mc.final_dim, mc.encoder_downsample, mc.d_bound),
                         device=device)
    k, e, ego = to_torch((k, e, ego), device)
    ranks = prewarped_ranks(get_geometry(fr, k, e), ego, res, start, dim)
    return ranks, int(np.prod(dim))


def phase_k1(cfg, device, path: str, b: int = 1):
    """K1 vs its plain version at the splat of a batch of ``b`` (F = b * rf
    frames); returns its numbers for the ``path`` it serves."""
    import torch
    from stp3_tpu_torch.ops.kernels import bev_splat as K1
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
    ms = time_ms(lambda: K1.bev_splat(feats, ranks, ncells))
    plain_ms = time_ms(lambda: K1.bev_splat_plain(feats, ranks, ncells))
    # one PyTorch call of the same scatter-add: index_add_ onto a flat buffer
    flat_idx = (ranks.long() + torch.arange(f, device=device)[:, None] * (ncells + 1)).reshape(-1)
    buf = torch.zeros(f * (ncells + 1), c, dtype=feats.dtype, device=device)
    flat_feats = feats.reshape(-1, c)
    library_ms = time_ms(lambda: buf.index_add_(0, flat_idx, flat_feats))
    # every rank and the rows of the points that land in the grid read once
    # (a dropped point's row is never needed), the (F, ncells, C) result
    # written once; one add per channel of each point that lands
    n_bytes = valid * c * feats.element_size() + nbytes(ranks) + (
        f * ncells * c * feats.element_size())
    bound_ms, bound_by = bound(n_bytes, valid * c, 'fp32')
    say(f'[K1 {path}] bev_splat F={f} P={p} C={c} ncells={ncells} bf16, invalid share '
        f'{1 - valid / (f * p):.4f}: max_abs_err {err:.3e} (rtol 1e-4, atol 1e-3) '
        f'{"OK" if ok else "MISMATCH"}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, '
        f'index_add_ {library_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}, '
        f'{n_bytes / 1e6:.1f} MB)')
    if not ok:
        fail(f'K1 disagrees with its plain version at F={f}')
    return dict(shape=f'F={f} P={p} C={c} ncells={ncells} bf16', max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


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
        t0 = time.perf_counter()
        got = K2.convnext_mlp(h, x, *weights)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        want = K2.convnext_mlp_plain(h, x, *weights)
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), rtol=1e-2, atol=1e-2)
        t_k = time_ms(lambda: K2.convnext_mlp(h, x, *weights))
        t_p = time_ms(lambda: K2.convnext_mlp_plain(h, x, *weights))
        # h, x and the weights read once, y written once; two (N, C) x (C, 4C)
        # products of 2 operations per multiply-add, on the bf16 tensor cores
        t_b, by = bound(nbytes(h, x, h) + nbytes(*weights),
                        2 * 2 * n * c * 4 * c, 'bf16')
        say(f'[K2 {path}] convnext_mlp N={n} C={c} bf16: max_abs_err {err:.3e} (rtol=atol=1e-2) '
            f'{"OK" if ok else "MISMATCH"}; first call (incl. Triton compile) '
            f'{first_s:.2f} s; kernel {t_k:.3f} ms, plain {t_p:.3f} ms, bound {t_b:.4f} ms '
            f'({by}); no single PyTorch call computes this function')
        if not ok:
            fail(f'K2 disagrees with its plain version at N={n}')
        per_shape.append(dict(n=n, max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=t_b))
        errs.append(err)
        ms += t_k
        plain_ms += t_p
        bound_ms += t_b
        bound_by.add(by)
    return dict(shape=f'N={" and ".join(str(s["n"]) for s in per_shape)} C={c} bf16',
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by='/'.join(sorted(bound_by)), library_ms=None, per_shape=per_shape)


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
    ms = time_ms(lambda: K.gather_rows(table, ranks))
    plain_ms = time_ms(lambda: K.gather_rows_plain(table, ranks))
    # one PyTorch call of the same gather: torch.gather from the padded table
    padded = torch.cat([table, table.new_zeros(f, 1, c)], 1)
    idx = ranks.long().clamp(0, ncells)[..., None].expand(-1, -1, c)
    library_ms = time_ms(lambda: torch.gather(padded, 1, idx))
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


def to_torch(arrays, device, dtype=None):
    import torch
    return [torch.as_tensor(a, device=device) if dtype is None or not np.issubdtype(
        a.dtype, np.floating) else torch.as_tensor(a, device=device).to(dtype) for a in arrays]


def build_model(cfg):
    import torch
    from stp3_tpu_torch.layers.base import init_parameters
    from stp3_tpu_torch.models.stp3 import STP3, STP3Config
    model = STP3(STP3Config.from_cfg(cfg))
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


def phase_flagship(cfg, device, card):
    import torch
    from stp3_tpu_torch.ops.kernels.bev_splat import bev_splat_accumulate
    from stp3_tpu_torch.ops.kernels.convnext_mlp import convnext_mlp
    from stp3_tpu_torch.utils.precision import policy_dtype
    t0 = time.perf_counter()
    dt = policy_dtype(cfg)
    model = build_model(cfg).to(device=device, dtype=dt)
    n_params = sum(p.numel() for p in model.parameters())
    (image, k, e, ego), ex = example_inputs(cfg)
    image, = to_torch((image,), device, dt)
    k, e, ego = to_torch((k, e, ego), device)                    # geometry stays fp32
    trajs, gt, target = to_torch((ex['trajs'], ex['gt_trajs'], ex['target_points']),
                                 device, dt)
    commands, = to_torch((ex['commands'],), device)
    say(f'[flagship] {n_params} params, {dt}, built in {time.perf_counter() - t0:.1f} s')
    with torch.inference_mode():
        bev_splat_accumulate.launches = 0
        convnext_mlp.launches = 0
        out, traj = plan_step(model, image, k, e, ego, trajs, gt, commands, target)
        torch.cuda.synchronize()
        launches = {'bev_splat': bev_splat_accumulate.launches,
                    'convnext_mlp': convnext_mlp.launches}
        if launches != {'bev_splat': 1, 'convnext_mlp': 2}:
            fail(f'per-forward launches {launches}, expected 1 K1 and 2 K2')
        for key, v in out.items():
            if v is not None and not torch.isfinite(v.float()).all():
                fail(f'flagship output {key} is not finite')
        if tuple(traj.shape) != (1, cfg.N_FUTURE_FRAMES, 3) or not torch.isfinite(
                traj.float()).all():
            fail(f'refined trajectory {tuple(traj.shape)} not finite of shape (1, 6, 3)')
        shapes = {key: tuple(v.shape) for key, v in out.items() if v is not None}
        say(f'[flagship] outputs finite: {shapes}; traj {tuple(traj.shape)} '
            f'{traj[0, :, :2].float().cpu().numpy().round(3).tolist()}')
        say(f'[flagship] launches per forward: {launches}')
        p50 = time_ms(lambda: plan_step(model, image, k, e, ego, trajs, gt, commands,
                                        target), warmup=3, iters=20)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say(f'[flagship] forward+plan p50 {p50:.2f} ms (median of 20, CUDA events), '
        f'peak memory {peak:.2f} GiB, on {card}')
    return launches


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
    from stp3_tpu_torch.ops.kernels.bev_splat import bev_splat_accumulate, gather_rows
    from stp3_tpu_torch.ops.kernels.convnext_mlp import convnext_mlp
    from stp3_tpu_torch.training.trainer import Trainer
    counters = (bev_splat_accumulate, gather_rows, convnext_mlp)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=device, seed=SEED)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    batches = synthetic_batches(cfg, 2, device)
    b = int(cfg.BATCHSIZE)
    say(f'[train] {n_params} fp32 master params, compute {trainer.compute_dtype}, REMAT '
        f'{cfg.MODEL.REMAT!r}, batch {b}; built with 2 synthetic batches in '
        f'{time.perf_counter() - t0:.1f} s')
    before = [p.detach().clone() for p in trainer.model.parameters()]

    for fn in counters:
        fn.launches = 0
    losses = [trainer.train_step(batches[0])]
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    if launches != {'bev_splat_accumulate': 1, 'gather_rows': 1, 'convnext_mlp': 2}:
        fail(f'per-step launches {launches}, expected 1 K1, 1 K3 and 2 K2')
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
    return trainer, batches, {'bev_splat': launches['bev_splat_accumulate'],
                              'gather_rows': launches['gather_rows'],
                              'convnext_mlp': launches['convnext_mlp']}


def profile_train(trainer, batches, card, steps: int = 3):
    """Where a train step's time goes (--profile)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            trainer.train_step(batches[i % 2])
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / steps
    say(f'[profile] {steps} steps under torch.profiler: {len(kernels) / steps:.0f} device '
        f'events and {busy:.2f} ms of summed device time per step')
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3 / steps, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (ms, n) in top:
        say(f'[profile]   {ms:8.2f} ms/step {n / steps:6.0f} calls/step  {name[:110]}')


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this script needs an NVIDIA GPU')
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    from stp3_tpu_torch.ops.kernels import bev_splat as K1

    device = torch.device('cuda', 0)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else 'nvidia-smi failed'
    say(card)
    say(f'[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, CUDA '
        f'{torch.version.cuda}; TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, '
        f'cudnn {torch.backends.cudnn.allow_tf32}')

    info = K1.build()
    regs = [ln.strip() for ln in info['log'].splitlines() if 'registers' in ln]
    say(f"[build] K1+K3 {'built' if info['built'] else 'reused'} in {info['seconds']:.2f} s "
        f"-> {os.path.relpath(info['path'], repo)}; ptxas: {' | '.join(regs)}")

    cfg, train_cfg = flagship_cfg(), planning_cfg()
    b = int(train_cfg.BATCHSIZE)
    # each kernel's numbers at the shapes of each path that launches it
    report = {
        'bev_splat': {'serving': phase_k1(cfg, device, 'serving'),
                      'train': phase_k1(train_cfg, device, 'train', b)},
        'convnext_mlp': {'serving': phase_k2(cfg, device, 'serving'),
                         'train': phase_k2(train_cfg, device, 'train', b)},
        'gather_rows': {'train': phase_k3(train_cfg, device)},
    }
    phase_backward(train_cfg, device)
    phase_parity(flagship_cfg(tiny=True), device)
    phase_train_parity(planning_cfg(tiny=True), device)
    launches = {'serving': phase_flagship(cfg, device, card)}
    trainer, batches, launches['train'] = phase_train(train_cfg, device, card)
    if '--profile' in sys.argv[1:]:
        profile_train(trainer, batches, card)
    say(f'[launches] serving forward+plan {launches["serving"]}; one train step '
        f'{launches["train"]}')

    # the top-level numbers are the train path's (this slice's path, which
    # runs all three kernels); 'paths' holds every path's launches and times
    kernels = []
    for name, route, source, replaces in KERNELS:
        paths = {path: dict(launches=launches[path][name], **numbers)
                 for path, numbers in report[name].items()}
        top = {k: paths['train'][k] for k in ('launches', 'max_abs_err', 'ms', 'plain_ms',
                                              'bound_ms', 'bound_by', 'library_ms')}
        kernels.append(dict(name=name, route=route, source=source, replaces=replaces, **top,
                            paths=paths))
    say(json.dumps({'kernels': kernels}))
    say(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                           'kind': torch.cuda.get_device_name(0),
                                           'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
