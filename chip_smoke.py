#!/usr/bin/env python3
"""Drive the PyTorch port (stp3_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line (or a few) before the last:
  1. device: card name and power limit, torch / CUDA versions, TF32 flags;
  2. build: nvcc-build the BEV splat kernel (K1) from csrc/;
  3. K1 vs its plain version at the flagship splat shape, ranks from the
     flagship rig's real geometry; times of both;
  4. K2 (fused ConvNeXt MLP, Triton) vs its plain version at the two
     flagship row counts; times of both;
  5. CPU-vs-CUDA parity of the tiny model in fp32 (same seeded weights),
     every head, the planner costs on a shared occupancy, and the refined
     trajectory;
  6. the full-width flagship (EfficientNet-b4, 6 cameras at 224x480,
     200x200 BEV, 6 future frames, 1,800 candidates) from a seeded init
     under the bf16 policy: forward + occupancy + plan as bench.py times
     it, its launch counts and its p50 latency.
Then one JSON line with every kernel's numbers, and last
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


def fail(msg: str) -> None:
    print(f'chip_smoke FAILED: {msg}', flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def example_inputs(cfg, seed: int = SEED):
    """numpy twin of __graft_entry__._example_inputs + _planning_extras."""
    rng = np.random.RandomState(seed)
    rf, n = cfg.TIME_RECEPTIVE_FIELD, len(cfg.IMAGE.NAMES)
    h, w = cfg.IMAGE.FINAL_DIM
    image = rng.rand(1, rf, n, h, w, 3).astype(np.float32)
    k = np.tile(np.array([[0.3 * w, 0, w / 2], [0, 0.3 * w, h / 2], [0, 0, 1]],
                         np.float32), (1, rf, n, 1, 1))
    e = np.tile(np.eye(4, dtype=np.float32), (1, rf, n, 1, 1))
    for i in range(n):
        yaw = 2 * np.pi * i / n
        rot = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)
        yawm = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                         [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]], np.float32)
        e[:, :, i, :3, :3] = yawm @ rot
        e[:, :, i, :3, 3] = [1.5 * np.cos(yaw), 1.5 * np.sin(yaw), 1.6]
    ego = np.tile(np.array([2.0, 0, 0, 0, 0, 0.01], np.float32), (1, rf, 1))
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


def splat_ranks(cfg, device):
    """(F, P) int32 ranks of the flagship rig's real frustum geometry,
    pre-warped by the example ego-motion, exactly as the model splats."""
    import torch
    from stp3_tpu_torch.models.stp3 import STP3Config
    from stp3_tpu_torch.ops.bev_pool import prewarped_ranks
    from stp3_tpu_torch.ops.geometry import (calculate_birds_eye_view_parameters,
                                             create_frustum, get_geometry)
    mc = STP3Config.from_cfg(cfg)
    (_, k, e, ego), _ = example_inputs(cfg)
    res, start, dim = calculate_birds_eye_view_parameters(mc.x_bound, mc.y_bound,
                                                          mc.z_bound)
    fr = torch.as_tensor(create_frustum(mc.final_dim, mc.encoder_downsample, mc.d_bound),
                         device=device)
    k, e, ego = to_torch((k, e, ego), device)
    ranks = prewarped_ranks(get_geometry(fr, k, e), ego, res, start, dim)
    return ranks, int(np.prod(dim))


def phase_k1(cfg, device, report):
    import torch
    from stp3_tpu_torch.ops.kernels import bev_splat as K1
    ranks, ncells = splat_ranks(cfg, device)
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
    invalid = (ranks == ncells).float().mean().item()
    ms = time_ms(lambda: K1.bev_splat(feats, ranks, ncells))
    plain_ms = time_ms(lambda: K1.bev_splat_plain(feats, ranks, ncells))
    say(f'[K1] bev_splat F={f} P={p} C={c} ncells={ncells} bf16, invalid share '
        f'{invalid:.4f}: max_abs_err {err:.3e} (rtol 1e-4, atol 1e-3) '
        f'{"OK" if ok else "MISMATCH"}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms')
    if not ok:
        fail('K1 disagrees with its plain version')
    report['bev_splat'] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def phase_k2(cfg, device, report):
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
    per_shape, errs, ms, plain_ms = [], [], 0.0, 0.0
    for frames in (nf, rf + nf):          # after the DualGRU; after SpatialGRU 1
        n = frames * nx * ny
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
        say(f'[K2] convnext_mlp N={n} C={c} bf16: max_abs_err {err:.3e} (rtol=atol=1e-2) '
            f'{"OK" if ok else "MISMATCH"}; first call (incl. Triton compile) '
            f'{first_s:.2f} s; kernel {t_k:.3f} ms, plain {t_p:.3f} ms')
        if not ok:
            fail(f'K2 disagrees with its plain version at N={n}')
        per_shape.append(dict(n=n, max_abs_err=err, ms=t_k, plain_ms=t_p))
        errs.append(err)
        ms += t_k
        plain_ms += t_p
    report['convnext_mlp'] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                                  per_shape=per_shape)


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


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this script needs an NVIDIA GPU')
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    from __graft_entry__ import _flagship_cfg
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
    say(f"[build] K1 {'built' if info['built'] else 'reused'} in {info['seconds']:.2f} s "
        f"-> {os.path.relpath(info['path'], repo)}; ptxas: {' | '.join(regs)}")

    cfg = _flagship_cfg()
    report = {}
    phase_k1(cfg, device, report)
    phase_k2(cfg, device, report)
    phase_parity(_flagship_cfg(tiny=True), device)
    launches = phase_flagship(cfg, device, card)

    kernels = [
        dict(name='bev_splat', route='cuda', source='stp3_tpu_torch/csrc/bev_pool.cu',
             replaces='stp3_tpu/ops/pallas/bev_pool_kernel.py:262',
             launches=launches['bev_splat'], **report['bev_splat']),
        dict(name='convnext_mlp', route='triton',
             source='stp3_tpu_torch/ops/kernels/convnext_mlp.py',
             replaces='stp3_tpu/ops/pallas/convnext_mlp_kernel.py:124',
             launches=launches['convnext_mlp'], **report['convnext_mlp']),
    ]
    say(json.dumps({'kernels': kernels}))
    say(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                           'kind': torch.cuda.get_device_name(0),
                                           'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
