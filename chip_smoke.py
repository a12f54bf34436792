#!/usr/bin/env python3
"""Check the PyTorch port (stp3_tpu_torch) once on one NVIDIA GPU: its
kernels against their plain versions at the real shapes, the launches of
every path, the compiled calls against eager ones, and each path end to
end. It times nothing: the port's benchmark (cardbench/, BENCHMARK.json)
does.

    python3 chip_smoke.py

Phases, each printing one line (or a few) before the last:
  1. device: card name and power limit, torch / CUDA versions, TF32 flags;
  2. build: nvcc-build the BEV splat kernels (K1 and K3), the fused
     lift + splat (K4) and the fused ConvNeXt MLP (K2) from csrc/, one
     nvcc per source, all three at once; each kernel's registers, shared
     memory and spills as ptxas reports them;
  [image_io]: the host C codec of the datasets (csrc/image_codec.c, built
     with cc): the committed 1600x900 camera JPEG
     (tests/data/camera_1600x900.jpg) decoded to the SHA-256 of Pillow's
     decode stored beside it, its nuScenes resize + crop to Pillow's;
     PNGs of every mode with all five row filters read back exactly; the
     resampler against its plain version;
  3. K1 vs its plain version at the serving (F=3) and training (F=6)
     splat shapes, ranks from the flagship rig's real geometry, at each
     stage's and path's splat, and at the agent's single-frame splat (F=1,
     the CARLA rig);
  4. K2 (fused ConvNeXt MLP, CUDA C++) vs its plain version at the serving
     and training row counts and those of the other paths;
  5. K3 (the splat's backward row gather) vs its plain version at the
     training shapes, bf16 and fp32, bit for bit;
  6. backward: K1's autograd Function (K3 backward) vs the plain splat's
     autograd at the training shape, bit for bit;
  [K1 v1] / [K1 v2]: K1's per-frame entries at one flagship frame against
     K1's plain version, fp32 and bf16 rows, one launch each;
  [K4]: the fused lift + splat at the flagship fused shape (F=3) against
     its plain version; its backward against autograd through the plain
     version, with its launches;
  7. CPU-vs-CUDA parity of the tiny model in fp32 (same seeded weights),
     every head, the planner costs on a shared occupancy, and the refined
     trajectory;
  8. CPU-vs-CUDA parity of one tiny fp32 train step (same seeded weights,
     one batch, dropout off, fixed noise, TF32 off): loss terms and every
     gradient;
  9. serving: the full-width flagship (EfficientNet-b4, 6 cameras at
     224x480, 200x200 BEV, 6 future frames, 1,800 candidates) from a
     seeded init under the bf16 policy: forward + occupancy + plan, its
     launches, every output finite;
 10. training: the Planning stage at full width and batch 2 (bf16 policy,
     fp32 masters, REMAT 'encoder', seeded init, synthetic batches)
     through the compiled train step (Trainer.train_step: two CUDA graphs,
     the gradients' and the update's, captured after WARMUP_CALLS eager
     steps): K1, K3 and K2 twice in the gradients' graph, none in the
     update's, no counter moved by a replay; loss terms finite, parameters
     changed;
     [train graphs]: the compiled step against the eager compute_gradients
     + apply_gradients of a twin trainer of the same seed (and two more
     twins: eager against eager), dropout on, 8 steps after the capture:
     the launches in both graphs, none on a replay, the generators equal
     after every step, loss terms and parameter updates within
     GRAPH_LIMIT x eager vs eager; val_forward compiled against eager at
     batch 2 and at a ragged batch of 1 (a second graph); an fp32
     trainer's capture;
     [remat]: the same stage under each MODEL.REMAT tag of REMAT_TAGS
     ('encoder', each other stage with it, and encoder+temporal+decoder+
     cells), from one seeded init and batch: each step's loss terms and
     gradients against the 'encoder' step's, within REMAT_MULTIPLE of the
     distance between two 'encoder' reruns (the bf16 backward's order);
     launches (K1 and K3 once, K2 twice, 4 times under 'future' and
     'gates', whose recomputation runs the future stage's K2 again); each
     tag's compiled step capturing its graphs (or raising, naming the
     tag) and a replayed step finite;
 11. [fused]: the flagship with fused_lift_splat: fp32 BEV features of the
     fused and materialised paths of the same weights, then forward + plan
     under the bf16 policy (K4 once, K2 twice, K1 never);
 12. [agent]: the CARLA Planning stage at full width (4 cameras at
     256x256, 200x200 BEV at 0.2 m, 2,400 candidates, seeded fp32 weights):
     static vs dynamic single-frame splat, incremental vs full heads at
     zero ego-motion; AgentCore in its three tick modes over recorded
     ticks (seeded uint8 300x400 frames, GPS 2 m further each tick):
     controls in range, no wrapper launch in the ticks (they replay the
     CUDA graphs the core captured in its warm-up), the launches in the
     tick's graph;
     [graphs]: the compiled fixed-shape serving calls (utils/graphs.py)
     against the eager model, on the [fused] phase's model (the flagship
     step materialised and fused, bench.py's forward + occupancy + plan,
     and STP3.serve_step, bf16) and the [agent] cores (the three tick
     modes, fp32): an eager step under set_sync_debug_mode('error'), the
     launches in each graph equal to the eager step's, none on a replay,
     the refined trajectory, segmentation logits and new BEV cache graphed
     vs eager within GRAPH_LIMIT x eager vs eager; then a batch-2 frame
     capturing a second graph and a moved parameter raising;
 13. the stage train steps, each at full width from a seeded init on
     synthetic batches under its YAML's bf16 policy and REMAT 'encoder'
     (configured as code in tests/torch_fixtures.py: PERCEPTION_STAGE,
     CARLA_PERCEPTION, PREDICTION_BER), compiled and checked like phase
     10 (K1 and K3 at each stage's splat shape and K2 at Prediction_Ber's
     rows are held against their plain versions with the kernel phases
     above): [perception] nuScenes Perception at batch 3 (K1 and K3 once,
     K2 never); [perception carla] CARLA Perception at batch 6;
     [prediction_ber] Prediction_Ber at batch 2 (K1, K3 once, K2 twice);
 14. [perception bn]: Perception under MODEL.NORM 'bn' (BN_MOMENTUM 0.05):
     one step of one seeded init and batch, dropout off, under REMAT
     'encoder' and 'none' must leave the same running statistics (a
     second update in the recomputation would not); then its compiled
     step, and an eval forward on the running statistics;
 15. [bn_frozen]: the flagship forward + plan under MODEL.NORM
     'bn_frozen', bf16: launches, outputs finite;
 16. [train_cli]: stp3_tpu_torch.train.run on the full-width Planning
     stage (batch 2, bf16, REMAT 'encoder') over synthetic 'mini' data,
     with PROFILE.ENABLED (2 steps) and VIS_INTERVAL 2: one epoch (5 train
     steps, validation on 4 samples, a checkpoint), then a resume for a
     second epoch whose step, Adam step and best IoU continue from the
     saved ones; which of tensorboard, moviepy and matplotlib the machine
     has; the train steps, val forwards and panel forwards replay CUDA
     graphs: the graphs' launches (K1, K3 and K2 twice in the gradients',
     none in the update's, K1 and K2 twice in the validation call's) and
     the counted launches of the eager and capturing calls an epoch; a
     checkpoint saved from the card reads back bit for bit; the profiler
     trace holds exactly steps 2 and 3 and K1's, K3's and K2's kernels;
     visualise_output of a full-width val forward is (T, 1400, 400, 3)
     uint8; DEBUG.NAN_CHECK on a NaN camera image, in a replayed step,
     raises FloatingPointError with the parameters, Adam and the step
     unchanged bit for bit;
 17. [evaluate_planning]: stp3_tpu_torch.evaluate.evaluate on that
     checkpoint at batch 1 (4 samples, each a replay of the validation
     call's graph: K1 once, K2 twice in it): every result key finite and
     in its range;
 18. [evaluate_prediction]: the same on a checkpoint of the
     Prediction.yml stage at full width (GAUSSIAN, instance and flow
     heads, 4 future frames), the panoptic metrics through the device
     decode; K2 at its rows is held against its plain version with the
     kernel phases above;
 19. [decode]: that stage's validation output at full width: the device
     decode (utils/instance_jit.py) equal to the host loop id for id;
 20. [labels as prediction]: the labels fed back as the prediction, at
     full width: IoU = PQ = SQ = RQ = 1 for every present class, L2 = 0,
     no collision;
 21. [reference_import]: a reference-format Lightning .ckpt of the
     nuScenes Planning stage at full width (seeded; BN statistics and every
     constant vector redrawn; the config as plain hyper_parameters)
     through stp3_tpu_torch.scripts.import_torch_checkpoint (an ok()
     report, only the bookkeeping ignored), evaluated on the card as
     [evaluate_planning] is (K1 once and K2 twice a sample), exported back
     with export_torch_checkpoint and held to the input bit for bit (the
     planner GRU's r / z biases to their fold);
 22. [carla_agent]: the same for the CARLA Planning stage at full width
     (CAM_FRONT_PARITY set and printed), then the harness
     stp3_tpu_torch.carla_agent.STP3Agent on the card over the recorded
     ticks as 300x400 BGRA sensor data with gps, speed and imu: warm-up
     ticks zero, planned ticks equal (1e-5, under deterministic
     algorithms; the spread without them, from the order of fp32 atomic
     adds, printed) to an AgentCore on the same model fed the RGB frames,
     launches per tick as [agent]'s default (static) mode; then the
     harness with the model cast to bf16: how many of 20 planned ticks
     select another candidate than fp32;
 23. [nuscenes_data]: the nuScenes Planning stage with LIFT.GT_DEPTH at
     full width (6 cameras at 1600x900 -> 224x480, 3 past and 6 future
     frames, the 200x200 BEV) on the PIL-free stand-in tree of
     tests/torch_fake_datasets.py through prepare_dataloaders with
     N_WORKERS (8) process workers: 2 epochs of train steps on its batches
     (K1 and K3 once a step, K2 twice; every loss term finite, 'depths'
     among them);
 24. [carla_data]: the same for CARLA's Planning stage on stand-in routes
     (4 cameras at 400x300 -> 256, the topdown labels at scale 1.1, the
     hdmap PNGs), with K1, K3 and K2 also held against their plain
     versions at its shapes;
 25. [dp nccl]: the Planning stage (batch 2, bf16) through the
     data-parallel Trainer over NCCL at world 1 beside the plain Trainer:
     the all-reduce over one rank and the division by 1 leave the
     gradients and the loss terms bit for bit, and clip + Adam on them the
     parameters; one distributed step's launches (K1, K3, K2 twice) (K3
     at batch 1 and K1 at one rank's cameras are held against their plain
     versions with the kernel phases);
 26. [dp 2 ranks] / [dp bn]: two ranks of this script (``--rank dp``)
     share the card over gloo (NCCL refuses two ranks on one device):
     the full-width Planning stage in fp32 (TF32 off, dropout off, a fixed
     draw) at batch 1 a rank against one process at batch 2 and against
     that step with its samples swapped (the loss terms, every gradient
     after the all-reduce, the parameters' updates; under MODEL.NORM 'bn'
     the running statistics), both ranks bit for bit equal; then 3 bf16
     steps a rank, each launching K1, K3 and K2 twice;
     [dp batch split]: in one process (fp32, TF32 off, deterministic
     algorithms where torch has them), the mean of two batch-1 steps of the
     Planning stage against the batch-2 step, beside the batch-2 step with
     its samples swapped, held to DP_LIMITS as [dp 2 ranks] is;
 27. [cam parallel]: three ranks (``--rank cam``) on the card over gloo
     split the flagship's 6 cameras over groups of 2 and 3, in bf16 and
     in fp32: forward + plan, serve_step and serve_step_static against the
     one-process port (occupancy, the selected candidate, the refined
     trajectory), each rank's launches (K1 once a forward, never the plain
     splat).
Every multi-rank group runs under a deadline (RANKS_TIMEOUT_S): a rank that
fails or outlives it ends the group and fails the script.
Then one JSON line with every kernel's launches on each path and its
largest distance from its plain version at each shape it was held to
(under "paths"), and last {"ok": true, "device": {...}}. Any failure exits
non-zero before that.
Without a CUDA device, or without the repository beside it, it fails.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np

# the configurations as code and the seeded inputs, shared with the tests,
# and the PIL-free stand-in datasets (importable by the loaders' workers too)
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), 'tests'))
import torch_fake_datasets as fake  # noqa: E402
from torch_fixtures import (  # noqa: E402
    AGENT_ROUTE, CAMS, CARLA_DATA, CARLA_PLANNING, CLI_DATA, FLAGSHIP, NUSCENES_DATA,
    PLANNING_STAGE, PREDICTION_STAGE, SEED, bgra_tick, build_model, carla_planning_cfg,
    check_export, depth_probs, example_inputs, flagship_cfg, k4_inputs, make_cfg, model_cfg,
    plan_step, planning_cfg, planning_result_keys, ptxas_summary, recorded_ticks,
    rig_geometry, running_stats, splat_ranks, stage_cfg, step_grads, synthetic_batches,
    to_torch, write_reference_checkpoint)


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
PATHS = ('serving', 'train', 'per_frame', 'fused', 'agent', 'perception', 'perception_carla',
         'perception_bn', 'prediction_ber', 'bn_frozen', 'train_cli', 'evaluate_planning',
         'evaluate_prediction', 'reference_import', 'carla_agent', 'nuscenes_data', 'carla_data',
         'dp_nccl', 'dp_ranks', 'cam_parallel', 'remat', 'graphs', 'train_graphs')


def counters():
    """Each kernel's launch counter: the wrapper that launches it."""
    from stp3_tpu_torch.ops.kernels import launch_counters
    return launch_counters()


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


def scaled(per_call: dict, n: int) -> dict:
    return {name: n * k for name, k in per_call.items()}


def expect_graphed(what: str, call, **want) -> None:
    """Fail unless the compiled call (utils/graphs) has captured a CUDA
    graph and its last call's graph holds the launches in ``want`` and no
    other."""
    if not call.captures:
        fail(f'{what}: no CUDA graph was captured')
    expect_launches(f'{what} (launches in its CUDA graph)', dict(call.launches_per_call), **want)


def expect_train_graphs(what: str, trainer, **want) -> None:
    """A Trainer's compiled train step: ``want`` in the gradients' graph,
    nothing in the update's (clip + Adam)."""
    if not trainer.compiled:
        fail(f'{what}: the trainer runs its steps eagerly')
    expect_graphed(f"{what}: the gradients' call", trainer.graphs['gradients'], **want)
    expect_graphed(f"{what}: the update's call", trainer.graphs['update'])


def expect_no_launch_on_replay(what: str, fn) -> None:
    """Fail if a call of ``fn`` (replaying graphs) moves a launch counter."""
    reset_launches()
    fn()
    moved = {k: v for k, v in read_launches().items() if v}
    if moved:
        fail(f'{what}: a replay moved the launch counters {moved}')


def warm_up_to_graphs(trainer, batch) -> int:
    """Train steps on ``batch`` until the compiled step has captured its
    graphs (the first WARMUP_CALLS steps run eagerly); returns the steps."""
    from stp3_tpu_torch.utils.graphs import WARMUP_CALLS
    n = 0
    while not trainer.graphs['update'].captures:
        if n > WARMUP_CALLS:
            fail('the compiled train step captured no graph')
        trainer.train_step(batch)
        n += 1
    return n


def free_card() -> None:
    """Give back what deleted objects held on the card: a Trainer and its
    compiled calls refer to each other, so collect them first."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def build_kernels(repo: str) -> None:
    """nvcc-build K1+K3 (bev_pool.cu), K4 (lift_splat.cu) and K2
    (convnext_mlp.cu) at once, one nvcc per source."""
    from concurrent.futures import ThreadPoolExecutor
    import torch
    from stp3_tpu_torch.ops.kernels import bev_splat as K1
    from stp3_tpu_torch.ops.kernels import convnext_mlp as K2
    from stp3_tpu_torch.ops.kernels import lift_splat as K4
    with ThreadPoolExecutor(3) as pool:
        infos = list(pool.map(lambda build: build(), (K1.build, K4.build, K2.build)))
    for name, info in zip(('K1+K3', 'K4', 'K2'), infos):
        say(f"[build] {name} {'built' if info['built'] else 'reused'} "
            f"-> {os.path.relpath(info['path'], repo)}; ptxas: "
            + ' | '.join(ptxas_summary(info['log'])))
    say(f'[build] K2 dynamic shared memory a CTA: {K2.shared_memory_bytes(torch.bfloat16)} B '
        f'(bf16 rows), {K2.shared_memory_bytes(torch.float32)} B (fp32 rows)')


def fail(msg: str) -> None:
    print(f'chip_smoke FAILED: {msg}', flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


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
    say(f'[K1 {path}] bev_splat F={f} P={p} C={c} ncells={ncells} bf16, invalid share '
        f'{1 - valid / (f * p):.4f}: max_abs_err {err:.3e} (rtol 1e-4, atol 1e-3) '
        f'{"OK" if ok else "MISMATCH"}')
    if not ok:
        fail(f'K1 disagrees with its plain version at F={f}')
    return dict(shape=f'F={f} P={p} C={c} ncells={ncells} bf16', max_abs_err=err)


def phase_k2(cfg, device, path: str, b: int = 1):
    """K2 vs its plain version at the two ConvNeXt row counts of a batch of
    ``b``; returns its numbers for ``path``."""
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
    rows, errs = [], []
    for frames in (nf, rf + nf):          # after the DualGRU; after SpatialGRU 1
        n = b * frames * nx * ny
        h = rnd(n, c).to(torch.bfloat16)
        x = rnd(n, c).to(torch.bfloat16)
        got = K2.convnext_mlp(h, x, *weights)
        want = K2.convnext_mlp_plain(h, x, *weights)
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), rtol=1e-2, atol=1e-2)
        say(f'[K2 {path}] convnext_mlp N={n} C={c} bf16: max_abs_err {err:.3e} (rtol=atol=1e-2) '
            f'{"OK" if ok else "MISMATCH"}')
        if not ok:
            fail(f'K2 disagrees with its plain version at N={n}')
        rows.append(n)
        errs.append(err)
    return dict(shape=f'N={" and ".join(map(str, rows))} C={c} bf16', max_abs_err=max(errs))


def phase_k3(cfg, device, path: str = 'train'):
    """K3 at a training shape: the splat's cotangent (F, ncells, C) and the
    ranks of the config's rig at batch B = cfg.BATCHSIZE, bf16 and fp32,
    bit for bit; returns its numbers for ``path``."""
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
    say(f'[K3 {path}] gather_rows F={f} P={p} C={c} ncells={ncells}: equal to its plain version '
        f'bit for bit in {" and ".join(parts)}')
    return dict(shape=f'F={f} P={p} C={c} ncells={ncells} bf16', max_abs_err=0.0)


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


def phase_per_frame(cfg, device):
    """[K1 v1] / [K1 v2]: K1's per-frame entries at one flagship frame (the
    present frame's ranks) against K1's plain version, fp32 and bf16 rows,
    one launch each. Returns (numbers by entry, their launches)."""
    import torch
    from stp3_tpu_torch.ops.bev_pool import prewarped_ranks
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
    numbers, path_launches = {}, dict.fromkeys(counters(), 0)
    for name, version in (('bev_pool_v1', 'v1'), ('bev_pool_v2', 'v2')):
        entry = getattr(K1, name)
        reset_launches()
        got32 = entry(feats32, ranks, ncells)
        got16 = entry(feats, ranks, ncells)
        launches = read_launches()
        expect_launches(f'K1 {version}, fp32 and bf16 rows', launches, **{name: 2})
        path_launches[name] += launches[name]
        want32 = K1.bev_splat_accumulate_plain(feats32[None], ranks[None], ncells)[0]
        want16 = K1.bev_splat_plain(feats[None], ranks[None], ncells)[0]
        torch.cuda.synchronize()
        err = (got32 - want32).abs().max().item()
        # fp32 rows: the fp32 sums at K1's tolerance; bf16 rows: both round
        # the same sums (reordered), so at most one bf16 rounding (2^-8) apart
        ok = (torch.allclose(got32, want32, rtol=1e-4, atol=1e-3)
              and torch.allclose(got16.float(), want16.float(), rtol=2 ** -7, atol=1e-3))
        say(f'[K1 {version}] {name} P={p} C={c} ncells={ncells} (one flagship frame, '
            f'invalid share {1 - valid / p:.4f}): max_abs_err {err:.3e} on fp32 rows (rtol '
            f'1e-4, atol 1e-3), bf16 rows within one rounding, {"OK" if ok else "MISMATCH"}; '
            f'one launch each')
        if not ok:
            fail(f'K1 {version} disagrees with its plain version')
        numbers[name] = dict(shape=f'P={p} C={c} ncells={ncells} bf16', max_abs_err=err)
    return numbers, path_launches


def phase_k4(cfg, device):
    """[K4]: the fused lift + splat at the flagship fused shape (F = rf
    frames, bf16 ctx and depth probabilities, the rig's real ranks) against
    its plain version; its backward (fp32) against autograd through the
    plain version."""
    import torch
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
    valid = (ranks < ncells).sum().item()
    say(f'[K4] lift_splat F={f} R={ctx.shape[1]} P={p} C={c} ncells={ncells} bf16, invalid share '
        f'{1 - valid / (f * p):.4f}: max_abs_err {err:.3e} (rtol 1e-4, atol 1e-3) '
        f'{"OK" if ok else "MISMATCH"}')
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
                max_abs_err=err)


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


def phase_flagship(cfg, device, fused: bool = False, tag: str = ''):
    """The serving forward + plan at full width under the bf16 policy;
    ``fused``: with the fused lift + splat (K4 in place of the lift and
    K1). Returns the launches of one step, the model and the step's
    arguments."""
    import torch
    from stp3_tpu_torch.utils.precision import policy_dtype
    tag = f'[{tag}]' if tag else '[fused]' if fused else '[flagship]'
    dt = policy_dtype(cfg)
    model = build_model(cfg, fused).to(device=device, dtype=dt)
    n_params = sum(p.numel() for p in model.parameters())
    (image, k, e, ego), ex = example_inputs(cfg)
    image, = to_torch((image,), device, dt)
    k, e, ego = to_torch((k, e, ego), device)                    # geometry stays fp32
    trajs, gt, target = to_torch((ex['trajs'], ex['gt_trajs'], ex['target_points']),
                                 device, dt)
    commands, = to_torch((ex['commands'],), device)
    say(f'{tag} {n_params} params, {dt}')
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
    return launches, model, (image, k, e, ego, trajs, gt, commands, target)


def phase_fused(cfg, device):
    """[fused]: the fp32 BEV features of the fused (K4) and materialised
    (lift, then K1) paths of one seeded full-width model, then the fused
    forward + plan under the bf16 policy. Returns ``phase_flagship``'s."""
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
    free_card()
    return phase_flagship(cfg, device, fused=True)


AGENT_MODES = (('full', dict(incremental=False)),
               ('incremental', dict(incremental=True, static_geometry=False)),
               ('static', dict(incremental=True, static_geometry=True)))
HEADS = ('segmentation', 'pedestrian', 'hdmap', 'costvolume')


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
    tick modes. Returns (K1's numbers at the agent's splat, the launches in
    each mode's tick graph, the model, the three cores by mode)."""
    import torch
    from stp3_tpu_torch.datas.carla_data import carla_cam_rig, scale_and_crop_image
    from stp3_tpu_torch.deploy.agent_core import AgentCore
    from stp3_tpu_torch.ops.bev_pool import prewarped_ranks
    from stp3_tpu_torch.ops.static_splat import build_column_splat_plan
    from stp3_tpu_torch.utils import sampler
    from stp3_tpu_torch.utils.network import prepare_image
    cfg = carla_planning_cfg()
    model = build_model(cfg).to(device)
    mc, rf = model.cfg, cfg.TIME_RECEPTIVE_FIELD
    say(f'[agent] CARLA Planning stage: {sum(p.numel() for p in model.parameters())} fp32 '
        f'params, {len(cfg.IMAGE.NAMES)} cameras at {tuple(mc.final_dim)}, BEV {mc.bev_size} at '
        f'{mc.x_bound[2]} m, D={mc.depth_channels}, rf {rf}, {mc.n_future} future frames, '
        f'{mc.sample_num} candidates, GRU {mc.gru_state_size}')

    # K1 at the agent's dynamic single-frame splat: the CARLA rig, F=1
    geometry, ego, (res, start, dim) = rig_geometry(cfg, device, carla=True)
    k1 = phase_k1(cfg, device, 'agent',
                  ranks=prewarped_ranks(geometry[:, -1:], ego[:, -1:], res, start, dim))

    # the serving methods against the full forward at zero ego-motion
    extr, intr = carla_cam_rig(mc.final_dim)
    arrays = build_column_splat_plan(model.frustum, intr, extr, model.bev_resolution,
                                     model.bev_start_position,
                                     model.bev_dimension).device_arrays(device)
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
        say(f'[agent] single-frame splat {tuple(bev_d.shape)} fp32, static (column plan, '
            f'mask {tuple(arrays["mask"].shape)}) vs dynamic (K1): max_abs_err '
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
    del out_f, served, cache

    # the three tick modes through AgentCore: 2 checked ticks, then 20 whose
    # launches are counted; each tick replays the compiled calls captured in
    # the core's warm-up
    per_tick, n_counted, cores = {}, 20, {}
    for mode, kw in AGENT_MODES:
        core = cores[mode] = AgentCore(cfg, model, device=device, **kw)
        controls = []
        for t, (frame, gps, theta) in enumerate(recorded_ticks(rf + 3 + n_counted)):
            core.push_frame(frame, gps, theta)
            if not core.warmed_up:
                continue
            np.random.seed(SEED + t)              # the sampler draws from the module RNG
            if len(controls) == 2:
                reset_launches()
            controls.append(core.plan_step(3.0, 4, np.array([0.0, 5.0])))
        launches = read_launches()
        if len(controls) != 2 + n_counted:
            fail(f'agent {mode}: {len(controls)} planned ticks, expected {2 + n_counted}')
        for steer, throttle, brake, _ in controls:
            if not (np.isfinite([steer, throttle]).all() and -1.0 <= steer <= 1.0
                    and 0.0 <= throttle <= 0.75 and isinstance(brake, bool)):
                fail(f'agent {mode}: control out of range: {(steer, throttle, brake)}')
        # no wrapper ran in the counted ticks: they replayed the graphs, whose
        # kernels the capture counted
        expect_launches(f'agent {mode} ticks (replays)', launches)
        per_tick[mode] = tick_graph(core).launches_per_call
        expect_launches(f'agent {mode} tick graph', per_tick[mode],
                        **({} if mode == 'static' else {'bev_splat': 1}))
        first = [tuple(round(float(v), 4) for v in c[:3]) for c in controls[:2]]
        say(f'[agent] {mode}: first two planned ticks (steer, throttle, brake) {first}; '
            f'{len(controls)} planned ticks in range, none launching a wrapper; launches per '
            f'tick (in its graph) { {n: v for n, v in per_tick[mode].items() if v}}; on {card}')
    return k1, per_tick, model, cores


def tick_graph(core):
    """The compiled call an AgentCore replays each tick."""
    return core._serve if core.incremental else core._infer


# [graphs]: each compiled call against the eager one, graphed-vs-eager
# within this multiple of eager-vs-eager
GRAPH_LIMIT = 2.0


def max_dist(got: dict, want: dict) -> dict:
    return {key: (got[key].float() - want[key].float()).abs().max().item() for key in want}


def compare_compiled(name: str, eager, call, args, pick, card, **want) -> dict:
    """[graphs] for one path: ``call`` (a ``utils.graphs`` compiled call)
    against ``eager`` (the model's own methods) on ``args``: a step under
    ``torch.cuda.set_sync_debug_mode('error')`` (after one that makes the
    per-device constants), the launches of an eager step and in the graph
    (``want``), none on a replay, the outputs ``pick`` selects graphed vs
    eager within GRAPH_LIMIT x eager vs eager. Returns the launches in the
    graph."""
    import torch
    eager(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        eager(*args)
    except RuntimeError as err:
        fail(f'[graphs] {name}: the eager step synchronises with the host: {err}')
    finally:
        torch.cuda.set_sync_debug_mode('default')
    reset_launches()
    first = pick(eager(*args))
    expect_launches(f'[graphs] {name} eager step', read_launches(), **want)
    second = pick(eager(*args))
    graphed = pick(call(*args))               # captures here unless captured before
    expect_launches(f'[graphs] {name} graph', call.launches_per_call, **want)
    reset_launches()
    graphed = pick(call(*args))
    expect_launches(f'[graphs] {name} replay', read_launches())
    d_eager, d_graph = max_dist(second, first), max_dist(graphed, first)
    if any(d_graph[key] > GRAPH_LIMIT * d_eager[key] for key in first):
        fail(f'[graphs] {name}: graphed vs eager {d_graph} exceeds {GRAPH_LIMIT} x eager vs '
             f'eager {d_eager}')
    launches = {k: v for k, v in call.launches_per_call.items() if v}
    say(f'[graphs] {name}: {call.captures} graph(s); launches in the graph {launches} = eager, '
        f'none on a replay; graphed vs eager '
        f'{ {k: float(f"{v:.3e}") for k, v in d_graph.items()}} within {GRAPH_LIMIT} x eager vs '
        f'eager { {k: float(f"{v:.3e}") for k, v in d_eager.items()}}; on {card}')
    return launches


def recompiles_and_refuses(call, eager, img, model, card) -> None:
    """[graphs]: an input of another shape captures a second graph (equal
    to eager), the first shape replays its own; a parameter whose storage
    moved makes the call raise, and it runs again once the storage is back."""
    import torch
    captures = call.captures
    img2 = torch.cat([img, img.flip(1)])
    got, want = call(img2), eager(img2)
    err = (got - want).abs().max().item()
    if call.captures != captures + 1 or not torch.allclose(got, want, rtol=1e-4, atol=1e-3):
        fail(f'[graphs] a batch-2 frame: {call.captures - captures} new graphs, max_abs_err '
             f'{err:.3e} against eager')
    call(img)
    if call.captures != captures + 1:
        fail('[graphs] the batch-1 frame captured again')
    param = next(model.parameters())
    held = param.data
    param.data = held.clone()
    try:
        call(img)
    except RuntimeError as e:
        refused = str(e)
    else:
        refused = None
    finally:
        param.data = held
    if refused is None or 'moved' not in refused:
        fail(f'[graphs] a parameter with new storage was not refused: {refused}')
    call(img)
    say(f'[graphs] static splat: a batch-2 frame captured graph {call.captures} (max_abs_err '
        f'{err:.3e} against eager, rtol 1e-4, atol 1e-3), the batch-1 frame replays its own; a '
        f'parameter with new storage raises "{refused[:90]}..."; on {card}')


def phase_graphs(flagship, agent_model, cores, card) -> dict:
    """[graphs]: the compiled fixed-shape serving calls against the eager
    model: the flagship step (bench.py's forward + occupancy + plan, bf16)
    materialised and fused and STP3.serve_step, on the [fused] phase's
    model; AgentCore's tick in its three modes (CARLA Planning, fp32) on
    the [agent] phase's cores. Returns each path's launches in its graph."""
    import torch
    from stp3_tpu_torch.datas.carla_data import scale_and_crop_image
    from stp3_tpu_torch.utils import graphs, sampler
    from stp3_tpu_torch.utils.network import prepare_image
    model, (image, k, e, ego, trajs, gt, commands, target) = flagship
    cfgs = {fused: dataclasses.replace(model.cfg, fused_lift_splat=fused)
            for fused in (False, True)}

    def flagship_step(fused):
        def step(*args):
            model.cfg = cfgs[fused]
            return plan_step(model, *args)
        return step

    def compared(traj, out, cache=None):
        """The outputs held graphed vs eager: (traj, out[, new cache])."""
        return {'traj': traj, 'segmentation': out['segmentation'],
                **({} if cache is None else {'cache': cache})}

    def step_outputs(result):                 # plan_step returns (out, traj)
        return compared(result[1], result[0])

    rf = model.cfg.receptive_field
    results, pool = {}, graphs.Pool()
    with torch.inference_mode():
        step_args = (image, k, e, ego, trajs, gt, commands, target)
        for fused, name in ((False, 'flagship'), (True, 'flagship fused')):
            eager = flagship_step(fused)
            results[name] = compare_compiled(
                name, eager, graphs.compiled(eager, model, pool=pool), step_args, step_outputs,
                card, **({'lift_splat': 1} if fused else {'bev_splat': 1}), convnext_mlp=2)
        model.cfg = cfgs[False]
        cache = torch.stack([model.splat_single_frame(image[:, t], k[:, t], e[:, t])[0]
                             for t in range(rf - 1)], 1)
        serve_args = (image[:, -1], k[:, -1], e[:, -1], ego, cache, trajs, commands, target)
        results['flagship serve_step'] = compare_compiled(
            'flagship serve_step', model.serve_step, graphs.compiled(model.serve_step, model,
                                                                     pool=pool),
            serve_args, lambda r: compared(*r), card, bev_splat=1, convnext_mlp=2)

        # the agent's ticks on the [agent] phase's cores and model, fp32
        mc = agent_model.cfg
        rf, crop = mc.receptive_field, mc.final_dim[0]
        dev = image.device
        frames = torch.as_tensor(np.stack(
            [np.stack([scale_and_crop_image(fr[key], 1.0, crop) for key in CAMS])
             for fr, _, _ in recorded_ticks(rf)])[None], device=dev)   # (1, rf, 4, H, W, 3)
        # a tick's arguments in AgentCore's dtypes: 2 m forward and a slight
        # turn a frame, sampled candidates, FORWARD, a target 5 m ahead
        tick = (torch.as_tensor(np.tile(np.array([2.0, 0, 0, 0, 0, 0.01], np.float32),
                                        (1, rf, 1)), device=dev),
                torch.as_tensor(sampler.sample_trajectories(
                    3.0, 0.0, mc.n_future, mc.sample_num, rng=np.random.RandomState(SEED))[
                        None, :, 1:], dtype=torch.float32, device=dev),
                torch.tensor([1], dtype=torch.int32, device=dev),
                torch.tensor([[0.0, 5.0]], device=dev))

        def prep(img):
            return prepare_image(img, torch.float32)

        plan = cores['static']._plan
        k_rig, e_rig = cores['incremental']._intr, cores['incremental']._extr

        def splat_static(img):
            return agent_model.splat_single_frame_static(prep(img), plan)[0]

        def splat_dynamic(img):
            return agent_model.splat_single_frame(prep(img), k_rig[:, 0], e_rig[:, 0])[0]

        def serve_static(img, ego_, cache_, trajs_, cmd, tp):
            return agent_model.serve_step_static(prep(img), ego_, cache_, trajs_, cmd, tp, plan)

        def serve_dynamic(img, ego_, cache_, trajs_, cmd, tp):
            return agent_model.serve_step(prep(img), k_rig[:, 0], e_rig[:, 0], ego_, cache_,
                                          trajs_, cmd, tp)

        def infer_full(images, ego_, trajs_, cmd, tp):
            out = agent_model(prep(images), k_rig, e_rig, ego_)
            occ = torch.logical_or(out['segmentation'].argmax(-1),
                                   out['pedestrian'].argmax(-1)).float()
            gt0 = torch.zeros(1, mc.n_future, 3, device=images.device)
            _, traj = agent_model.plan(out['cam_front'], trajs_, gt0, out['costvolume'][:, rf:],
                                       occ[:, rf:], out['hdmap'], cmd, tp)
            return traj, out

        results['agent full'] = compare_compiled(
            'agent full tick', infer_full, cores['full']._infer, (frames, *tick),
            lambda r: compared(*r), card, bev_splat=1)
        for mode, splat, serve, want in (('incremental', splat_dynamic, serve_dynamic,
                                          {'bev_splat': 1}),
                                         ('static', splat_static, serve_static, {})):
            cache = torch.stack([splat(frames[:, t]) for t in range(rf - 1)], 1)
            results[f'agent {mode}'] = compare_compiled(
                f'agent {mode} tick', serve, cores[mode]._serve,
                (frames[:, -1], tick[0], cache, *tick[1:]), lambda r: compared(*r), card, **want)
        recompiles_and_refuses(cores['static']._splat, splat_static, frames[:, -1], agent_model,
                               card)
    return results


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


def phase_train(cfg, device, card, tag: str = 'train', **want):
    """A stage's training at full width and batch cfg.BATCHSIZE from a
    seeded init on synthetic batches, through the compiled train step:
    its WARMUP_CALLS eager steps, the step that captures the gradients'
    and the update's CUDA graphs, then a step replaying them. The
    gradients' graph holds the launches in ``want`` (by default K1, K3 and
    K2 twice), the update's none, the replay moves no counter, and the
    counters of the whole run are the eager and capturing steps'; loss
    terms finite, most parameter tensors changed. Returns (trainer,
    batches, the run's launches)."""
    import torch
    from stp3_tpu_torch.training.trainer import Trainer
    want = want or dict(bev_splat=1, gather_rows=1, convnext_mlp=2)
    trainer = Trainer(cfg, device=device, seed=SEED)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    batches = synthetic_batches(cfg, 2, device)
    say(f'[{tag}] {cfg.TAG}: {n_params} fp32 master params, compute {trainer.compute_dtype}, '
        f'MODEL.NORM {cfg.MODEL.NORM!r}, REMAT {cfg.MODEL.REMAT!r}, batch {int(cfg.BATCHSIZE)}')
    before = [p.detach().clone() for p in trainer.model.parameters()]

    reset_launches()
    losses = []
    while not trainer.graphs['update'].captures and len(losses) < 8:
        losses.append(trainer.train_step(batches[len(losses) % 2]))
    launches = read_launches()
    expect_train_graphs(f'[{tag}] train step', trainer, **want)
    expect_launches(f'[{tag}] {len(losses)} steps, the last capturing', launches,
                    **scaled(want, len(losses)))
    grads = trainer.graphs['gradients']
    expect_no_launch_on_replay(f'[{tag}] a replayed train step',
                               lambda: losses.append(trainer.train_step(batches[1])))
    say(f'[{tag}] the compiled step: {len(losses) - 2} eager steps, then the CUDA graphs; '
        f'launches in the gradients\' graph {grads.launches_per_call}, none in the update\'s, '
        f'none counted on a replay; the run\'s counters {launches}')
    for step, loss in enumerate(losses):
        bad = [k for k, v in loss.items() if not torch.isfinite(v).all()]
        if bad:
            fail(f'{tag} step {step}: loss terms {bad} are not finite')
    changed = sum(not torch.equal(a, p) for a, p in zip(before, trainer.model.parameters()))
    if changed < len(before) // 2:
        fail(f'{tag}: only {changed} of {len(before)} parameter tensors changed in '
             f'{len(losses)} steps')
    first, last = losses[0], losses[-1]
    say(f'[{tag}] {len(losses)} steps finite; {changed} of {len(before)} parameter tensors '
        f'changed; total loss {first["total"].item():.4f} -> {last["total"].item():.4f}; terms '
        f'of the last step {({k: round(v.item(), 4) for k, v in last.items()})}; on {card}')
    return trainer, batches, launches


# [train graphs]: steps after the capture on each trainer, and the floor
# of the limit of graphed-vs-eager (GRAPH_LIMIT x eager-vs-eager)
TRAIN_GRAPH_STEPS = 8
TRAIN_GRAPH_FLOOR = 1e-6


def update_errors(got: list, want: list, start: list) -> list:
    """Each parameter tensor's relative L2 distance of its update from
    ``start`` from ``want``'s."""
    out = []
    for g, w, s in zip(got, want, start):
        du = (w - s).float()
        out.append(((g - w).float().norm() / du.norm().clamp_min(1e-30)).item())
    return out


def train_distance(got: dict, want: dict) -> dict:
    """How far one run of steps is from another: the loss terms' largest
    difference over the steps relative to that step's total loss (the
    uncertainty terms sit near zero), the parameters' updates (median and
    worst relative L2 over the tensors)."""
    loss = max(abs(g[k] - w[k]) / max(abs(w['total']), 1e-12)
               for g, w in zip(got['loss'], want['loss']) for k in w)
    errs = update_errors(got['params'], want['params'], want['start'])
    return {'loss': loss, 'median': float(np.median(errs)), 'worst': max(errs)}


def phase_train_graphs(cfg, device, card) -> dict:
    """[train graphs]: the Planning stage at full width and batch 2 (bf16
    policy over fp32 masters, REMAT 'encoder', dropout on, the latent from
    the trainer's generator) through the compiled train step, against the
    eager ``compute_gradients`` + ``apply_gradients`` of a twin trainer of
    the same seed and of two more twins (eager against eager: the
    yardstick, the larger of their distances from the first twin), all
    taking the same batches. The compiled trainer's eager warm-up steps
    and the step that captures its two graphs; K1 and K3 once and K2 twice
    in the gradients' graph, nothing in the update's, no counter moved by
    a replay; then TRAIN_GRAPH_STEPS steps on each trainer: the twins'
    generators where the compiled trainer's is (the replays draw what
    eager steps draw), and the loss terms of every step and the
    parameters' updates graphed vs eager within GRAPH_LIMIT x eager vs
    eager (or TRAIN_GRAPH_FLOOR). Then ``val_forward`` compiled against its
    eager body at batch 2 and at a ragged batch of 1 (a second graph),
    within GRAPH_LIMIT x eager vs eager. Last, an fp32 trainer's capture.
    Returns the compiled trainer's launches (the counters of its run)."""
    import torch
    from stp3_tpu_torch.training.trainer import Trainer
    batches = synthetic_batches(cfg, 2, device)
    graphed = Trainer(cfg, device=device, seed=SEED)
    names = ('eager', 'rerun', 'rerun2')
    twins = [Trainer(cfg, device=device, seed=SEED) for _ in names]
    start = [p.detach().clone() for p in graphed.model.parameters()]
    runs = {name: {'loss': [], 'start': start} for name in ('graphed',) + names}

    def eager_step(trainer, batch):
        out = trainer.compute_gradients(batch)
        trainer.apply_gradients()
        return out

    def record(name, loss):
        runs[name]['loss'].append({k: v.item() for k, v in loss.items()})

    reset_launches()
    n = 0
    while not graphed.graphs['update'].captures:
        if n > 6:
            fail('[train graphs] the compiled step captured no graph')
        record('graphed', graphed.train_step(batches[n % 2]))
        n += 1
    launches = read_launches()
    grads = graphed.graphs['gradients']
    expect_train_graphs('[train graphs]', graphed, bev_splat=1, gather_rows=1, convnext_mlp=2)
    for name, twin in zip(names, twins):
        for i in range(n):
            record(name, eager_step(twin, batches[i % 2]))
    say(f'[train graphs] {cfg.TAG}, batch {cfg.BATCHSIZE}, {graphed.compute_dtype}: '
        f'{grads.eager_calls} eager warm-up steps, then the gradients\' and the update\'s '
        f'CUDA graphs; launches in the gradients\' graph {grads.launches_per_call}, in the '
        f'update\'s none; the run\'s counters {launches}')
    expect_no_launch_on_replay('[train graphs] a replayed step',
                               lambda: record('graphed', graphed.train_step(batches[0])))
    for i in range(1, TRAIN_GRAPH_STEPS):
        record('graphed', graphed.train_step(batches[i % 2]))
    for name, twin in zip(names, twins):
        for i in range(TRAIN_GRAPH_STEPS):
            record(name, eager_step(twin, batches[i % 2]))
    for name, trainer in zip(('graphed',) + names, [graphed] + twins):
        runs[name]['params'] = [p.detach().clone() for p in trainer.model.parameters()]
    same_gen = all(torch.equal(graphed.generator.get_state(), t.generator.get_state())
                   for t in twins)
    if not same_gen or graphed.step != twins[0].step:
        fail(f'[train graphs] after {graphed.step} steps the generators differ: the replays '
             'drew otherwise than the eager steps')
    got = train_distance(runs['graphed'], runs['eager'])
    yards = [train_distance(runs[name], runs['eager']) for name in names[1:]]
    yard = {m: max(y[m] for y in yards) for m in got}
    limit = {m: max(GRAPH_LIMIT * v, TRAIN_GRAPH_FLOOR) for m, v in yard.items()}
    bad = [k for run in runs.values() for loss in run['loss'] for k, v in loss.items()
           if not np.isfinite(v)]
    say(f'[train graphs] {graphed.step} steps a trainer, the generators equal after every step; '
        f'graphed vs eager: loss terms rel {got["loss"]:.2e}, parameter updates '
        f'median {got["median"]:.2e}, worst {got["worst"]:.2e}; eager vs eager (the yardstick): '
        f'{yard["loss"]:.2e}, {yard["median"]:.2e}, {yard["worst"]:.2e}; limit {GRAPH_LIMIT:g}x '
        f'it or {TRAIN_GRAPH_FLOOR:g}; on {card}')
    over = [m for m in got if got[m] > limit[m]]
    if bad or over:
        fail(f'[train graphs] loss terms not finite {bad[:3]} or beyond the limit {over}: '
             f'{got} against {limit}')
    del twins
    free_card()
    val_graphs(graphed, batches[0], card)
    del graphed
    free_card()
    fp32_train_graph(cfg, device, batches, card)
    return launches


def val_graphs(trainer, batch, card) -> None:
    """``val_forward`` compiled (the graph ``validate`` replays) against its
    eager body, at the batch and at a ragged batch of its first row (a
    second graph): the heads and the plan within GRAPH_LIMIT x eager vs
    eager (or TRAIN_GRAPH_FLOOR); K1 once and K2 twice in each graph."""
    call = trainer.graphs['val']
    keys = ('segmentation', 'pedestrian', 'hdmap', 'final_traj')
    ragged = {k: v[:1] for k, v in batch.items()}
    rows = []
    for name, b in (('batch', batch), ('ragged', ragged)):
        captures = call.captures
        graphed, _ = trainer.val_forward(b)
        eager = [trainer._val_forward(b)[0] for _ in range(2)]
        if call.captures != captures + 1:
            fail(f'[train graphs] val_forward at a {name} batch captured no new graph')
        expect_graphed(f'[train graphs] val_forward ({name})', call, bev_splat=1,
                       convnext_mlp=2)
        want = {k: eager[0][k] for k in keys}
        got = max(max_dist({k: graphed[k] for k in keys}, want).values())
        yard = max(max_dist({k: eager[1][k] for k in keys}, want).values())
        if got > max(GRAPH_LIMIT * yard, TRAIN_GRAPH_FLOOR):
            fail(f'[train graphs] val_forward ({name}) graphed vs eager {got:.3e}, eager vs '
                 f'eager {yard:.3e}')
        rows.append(f'{name} (batch {b["image"].shape[0]}): graphed vs eager max abs '
                    f'{got:.3e} (eager vs eager {yard:.3e})')
    say(f'[train graphs] val_forward, {call.captures} graphs: ' + '; '.join(rows)
        + f'; on {card}')


def fp32_train_graph(cfg, device, batches, card) -> None:
    """The same stage under PRECISION 32 (TF32 off, as [train parity] left
    it), whose convolutions keep cuDNN's fp32 workspaces: the compiled step
    captures its graphs."""
    from stp3_tpu_torch.training.trainer import Trainer
    fp32 = cfg.clone()
    fp32.PRECISION = 32
    trainer = Trainer(fp32, device=device, seed=SEED)
    n = warm_up_to_graphs(trainer, batches[0])
    say(f'[train graphs] fp32: {n} steps to the capture; on {card}')
    del trainer
    free_card()


def phase_perception_bn(cfg, device, card):
    """[perception bn]: the Perception stage under MODEL.NORM 'bn' (the
    reference's own stage-1 recipe, BN_MOMENTUM 0.05) at full width and
    batch 3, bf16 policy. From one seeded init and one batch, dropout off:
    the step under REMAT 'encoder' (whose backward recomputes the encoder)
    and under REMAT 'none' must leave the same running statistics: a
    second update in the recomputation would take a second momentum step,
    about as large as the step's own change, so the two may differ by at
    most 1e-2 of that change. Then the compiled train step (``phase_train``)
    and an eval forward on the running statistics with finite heads.
    Returns the launches of one step."""
    import torch
    from stp3_tpu_torch.training.trainer import Trainer
    batches = synthetic_batches(cfg, 1, device)
    stats = {}
    for remat in ('encoder', 'none'):
        run_cfg = cfg.clone()
        run_cfg.MODEL.REMAT = remat
        trainer = Trainer(run_cfg, device=device, seed=SEED)
        start = running_stats(trainer.model)
        reset_launches()
        loss = trainer.train_step(batches[0], dropout=False)
        launches = read_launches()
        expect_launches(f'[perception bn] REMAT {remat!r} step', launches, bev_splat=1,
                        gather_rows=1)
        if not all(torch.isfinite(v).all() for v in loss.values()):
            fail(f'[perception bn] REMAT {remat!r}: a loss term is not finite')
        stats[remat] = running_stats(trainer.model)
        del trainer
        free_card()
    change = max((stats['none'][k] - start[k]).abs().max().item() for k in start)
    diff = max((stats['encoder'][k] - stats['none'][k]).abs().max().item() for k in start)
    moved = sum(not torch.equal(stats['none'][k], start[k]) for k in start)
    say(f'[perception bn] {len(start) // 2} bn sites, {moved} of {len(start)} running '
        f'statistics moved in one step (dropout off); REMAT encoder vs none: max difference '
        f'{diff:.3e} against the step\'s own max change {change:.3e} (limit 1e-2 of it)')
    if not diff <= 1e-2 * change or moved < len(start) // 2:
        fail('[perception bn] the running statistics under REMAT encoder differ from REMAT '
             'none: the recomputation updated them again')
    trainer, batches, launches = phase_train(cfg, device, card, 'perception bn',
                                             bev_splat=1, gather_rows=1)
    out, _ = trainer.val_forward(batches[0])
    for key in ('segmentation', 'pedestrian', 'hdmap'):
        if not torch.isfinite(out[key].float()).all():
            fail(f'[perception bn] eval forward on running statistics: {key} not finite')
    say(f'[perception bn] eval forward on the running statistics: heads finite, '
        f'{ {k: tuple(v.shape) for k, v in out.items() if v is not None} }')
    return launches


# the MODEL.REMAT tags of [remat]: 'encoder' (every shipped YAML's) first,
# then each other stage with it, and one composition
REMAT_TAGS = ('encoder', 'encoder+temporal', 'encoder+future', 'encoder+decoder',
              'encoder+cells', 'encoder+gates', 'encoder+temporal+decoder+cells')
# a tag's distance from the 'encoder' step may reach this multiple of the
# distance between 'encoder' steps themselves, or 1e-6, the larger: two runs
# of one bf16 step give bit-equal loss terms but gradients ~2% apart in the
# median on the card (the backward's atomic adds land in another order)
REMAT_MULTIPLE = 4.0
REMAT_FLOOR = 1e-6


def remat_trainer(cfg, remat: str, weights: dict, device):
    """A Trainer of ``cfg`` under MODEL.REMAT ``remat`` with ``weights``
    and the seeded generator."""
    from stp3_tpu_torch.models.stp3 import STP3, STP3Config
    from stp3_tpu_torch.training.trainer import Trainer
    run_cfg = cfg.clone()
    run_cfg.MODEL.REMAT = remat
    model = STP3(STP3Config.from_cfg(run_cfg))
    model.load_state_dict(weights)
    return Trainer(run_cfg, device=device, seed=SEED, model=model)


def remat_numbers(trainer, batch):
    """(loss terms, gradients) of one step without the update: dropout on,
    the latent drawn from the trainer's generator."""
    loss = trainer.compute_gradients(batch)
    return ({k: v.item() for k, v in loss.items()},
            {n: p.grad.detach().clone() for n, p in trainer.model.named_parameters()})


def remat_distance(got, want) -> dict:
    """The loss terms' largest relative difference; the gradients' median
    and worst relative L2 error (``grad_errors``)."""
    errs = grad_errors(got[1], want[1])
    return {'loss': max(abs(got[0][k] - v) / max(abs(v), 1e-12) for k, v in want[0].items()),
            'median': float(np.median(list(errs.values()))), 'worst': max(errs.values())}


def phase_remat(cfg, device, card) -> dict:
    """[remat]: the full-width Planning stage (batch 2, bf16 policy over fp32
    masters, seeded init, a synthetic batch) under each of ``REMAT_TAGS``.
    Each tag's step (dropout on, the latent from the seeded generator) from
    the same weights and batch: its loss terms and gradients against the
    'encoder' step's, within ``REMAT_MULTIPLE`` of the distance between
    'encoder' steps (the larger of two reruns); its launches (K1 and K3
    once, K2 twice, and twice more where 'future' or 'gates' recomputes
    the future stage: K2 is a ctypes launch, which no checkpoint policy
    sees, so it runs again in the recomputation). Then the compiled train
    step's warm-up steps and its capture (a tag whose recomputation cannot
    be captured raises, naming the tag), the same launches in its
    gradients' graph, and a replayed step's loss terms finite. Returns the
    launches of the counted (eager) steps, summed over the tags."""
    import torch
    from stp3_tpu_torch.training.trainer import Trainer
    weights = {k: v.detach().clone()
               for k, v in Trainer(cfg, device=device, seed=SEED).model.state_dict().items()}
    free_card()
    batch, = synthetic_batches(cfg, 1, device)
    ref = remat_numbers(remat_trainer(cfg, 'encoder', weights, device), batch)
    reruns = [remat_distance(remat_numbers(remat_trainer(cfg, 'encoder', weights, device),
                                           batch), ref) for _ in range(2)]
    free_card()
    yard = {m: max(r[m] for r in reruns) for m in reruns[0]}
    limit = {m: max(REMAT_MULTIPLE * v, REMAT_FLOOR) for m, v in yard.items()}
    say(f'[remat] {cfg.TAG}, batch {cfg.BATCHSIZE}, PRECISION {cfg.PRECISION} over fp32 '
        f'masters: {len(ref[1])} gradients; two \'encoder\' reruns against the first: loss '
        f'terms rel {yard["loss"]:.2e}, gradients median {yard["median"]:.2e}, worst '
        f'{yard["worst"]:.2e} (the yardstick); each tag may reach {REMAT_MULTIPLE:g}x it, or '
        f'{REMAT_FLOOR:g}')
    total = {name: 0 for name in counters()}
    for tag in REMAT_TAGS:
        trainer = remat_trainer(cfg, tag, weights, device)
        reset_launches()
        numbers = remat_numbers(trainer, batch)
        launches = read_launches()
        k2 = 4 if {'future', 'gates'} & set(tag.split('+')) else 2
        expect_launches(f'[remat] {tag!r} step', launches, bev_splat=1, gather_rows=1,
                        convnext_mlp=k2)
        for name, n in launches.items():
            total[name] += n
        if not all(np.isfinite(v) for v in numbers[0].values()):
            fail(f'[remat] {tag!r}: a loss term is not finite')
        dist = remat_distance(numbers, ref)
        del numbers
        over = [m for m in dist if dist[m] > limit[m]]
        if over:
            fail(f'[remat] {tag!r}: {over} beyond the limit: {dist} against {limit}')
        warm_up_to_graphs(trainer, batch)          # the compiled step captures, or raises
        expect_train_graphs(f'[remat] {tag!r}', trainer, bev_splat=1, gather_rows=1,
                            convnext_mlp=k2)
        loss = trainer.train_step(batch)
        if not all(torch.isfinite(v).all() for v in loss.values()):
            fail(f'[remat] {tag!r}: a loss term of a replayed step is not finite')
        say(f'[remat] {tag}: launches {launches}; against \'encoder\': loss rel '
            f'{dist["loss"]:.2e}, gradients median {dist["median"]:.2e}, worst '
            f'{dist["worst"]:.2e}; its compiled step captured and replayed; on {card}')
        del trainer
        free_card()
    return total


def finite_dict(d) -> bool:
    """Every value of a (nested) dict of arrays, tensors or numbers finite."""
    import torch
    for v in d.values():
        if isinstance(v, dict):
            if not finite_dict(v):
                return False
        elif isinstance(v, torch.Tensor):
            if not torch.isfinite(v.float()).all():
                return False
        elif not np.isfinite(np.asarray(v, np.float64)).all():
            return False
    return True


CLI_VIS_INTERVAL = 2


def phase_train_cli(device, card, repo: str):
    """[train_cli]: ``stp3_tpu_torch.train.run`` on the full-width Planning
    stage (batch 2, bf16 policy, REMAT 'encoder') over synthetic 'mini'
    data, with PROFILE.ENABLED (PROFILE.STEPS 2) and VIS_INTERVAL 2: one
    epoch of 5 train steps, validation on 4 samples (2 val forwards) and a
    checkpoint; then a resume from that checkpoint for a second epoch,
    whose step, Adam step and best IoU must continue from the saved ones.
    The train steps and the val forwards replay CUDA graphs: counted
    launches an epoch are the train steps' up to the capturing one and the
    validation call's warm-up and capture (K1 once a call, K3 once a train
    step, K2 twice), its graphs hold K1, K3 and K2 twice (gradients),
    nothing (update), K1 and K2 twice (val; the panels' forwards of the
    train batches replay it too). The profiler trace must hold exactly steps 2
    and 3 and name K1's, K3's and K2's kernels. Then ``cli_panels_and_nan_check``.
    Returns (the last checkpoint, the launches of the first epoch)."""
    import glob
    import importlib.util
    import shutil
    import torch
    from stp3_tpu_torch.train import run
    from stp3_tpu_torch.training import checkpoint as ckpt_lib
    cfg = make_cfg(PLANNING_STAGE, CLI_DATA, {'PROFILE': {'ENABLED': True, 'STEPS': 2},
                                              'VIS_INTERVAL': CLI_VIS_INTERVAL})
    save_dir = os.path.join(repo, 'build', 'chip_smoke', 'train_cli')
    shutil.rmtree(save_dir, ignore_errors=True)
    have = {m: importlib.util.find_spec(m) is not None
            for m in ('tensorboard', 'moviepy', 'matplotlib')}
    say('[train_cli] on this machine: ' + ', '.join(
        f'{m} {"present" if v else "absent"}' for m, v in have.items())
        + ' (without tensorboard the CLI writes no scalars or panels and runs no panel '
        'forward; add_video needs moviepy; the evaluation figures need matplotlib)')
    from stp3_tpu_torch.utils.graphs import WARMUP_CALLS
    b = int(cfg.BATCHSIZE)
    steps, vals = 10 // b, -(-int(cfg.DATASET.VAL_SAMPLES) // b)
    # counted: the train steps up to the capturing one, and the validation
    # call's warm-up calls and capture (its one graph serves the panels'
    # forwards of the train batches and the val batches: one shape, every
    # val row valid); the replays count nothing
    first_graphed = WARMUP_CALLS + 1
    counted = min(steps, first_graphed)
    want = dict(bev_splat=counted + first_graphed, gather_rows=counted,
                convnext_mlp=2 * (counted + first_graphed))

    def log(msg):
        say(f'[train_cli] {msg}')

    def check_graphs(what, rec):
        g = rec['graphs']
        if not rec['compiled'] or [g[k]['captures'] for k in ('gradients', 'update', 'val')] != [
                1, 1, 1]:
            fail(f'[train_cli] {what}: compiled {rec["compiled"]}, graphs {g}')
        for name, want_in in (('gradients', dict(bev_splat=1, gather_rows=1, convnext_mlp=2)),
                              ('update', {}), ('val', dict(bev_splat=1, convnext_mlp=2))):
            expect_launches(f'[train_cli] {what}: the {name} graph', g[name]['launches'],
                            **want_in)

    reset_launches()
    first = run(cfg, device, save_dir, log=log)
    launches = read_launches()
    expect_launches(f'[train_cli] epoch 1 ({steps} train steps, {vals} val forwards)',
                    launches, **want)
    check_graphs('epoch 1', first)
    say(f'[train_cli] launches in epoch 1: {launches} (the eager and capturing calls); in '
        f'the graphs {({k: v["launches"] for k, v in first["graphs"].items()})}')
    check_cli_trace(glob.glob(os.path.join(save_dir, 'profile', '*.pt.trace.json')), card)
    resume = cfg.clone()
    resume.EPOCHS = 2
    resume.CHECKPOINT.RESUME = first['last']
    reset_launches()
    second = run(resume, device, save_dir, log=log)
    expect_launches('[train_cli] the resumed epoch 2', read_launches(), **want)
    check_graphs('the resumed epoch 2', second)
    state = ckpt_lib.load_checkpoint(second['last'])
    adam = {int(s['step']) for s in state['optimizer']['state'].values()}
    meta = ckpt_lib.load_meta(second['last'])
    if (first['step'] != steps or second['start_step'] != steps or second['step'] != 2 * steps
            or state['step'] != 2 * steps or adam != {2 * steps}):
        fail(f'[train_cli] resume: steps {first["step"]} -> {second["start_step"]} -> '
             f'{second["step"]}, checkpoint step {state["step"]}, Adam steps {adam}')
    if (second['start_best_iou'] != first['best_iou'] or second['best_iou'] < first['best_iou']
            or meta['metrics']['best_iou'] != second['best_iou']):
        fail(f'[train_cli] resume: best IoU {first["best_iou"]} -> {second["start_best_iou"]} '
             f'-> {second["best_iou"]} (meta {meta["metrics"]})')
    for rec in (first, second):
        if not finite_dict(rec['loss']) or not finite_dict(rec['metrics']):
            fail('[train_cli] a loss term or a validation metric is not finite')
    say(f'[train_cli] resumed at step {second["start_step"]} with best IoU '
        f'{second["start_best_iou"]:.4f}; ended at step {second["step"]} (Adam step {adam}), '
        f'best IoU {second["best_iou"]:.4f}; format_version {meta["format_version"]}')

    loaded = ckpt_lib.load_checkpoint(second['last'], map_location=device)
    probe = ckpt_lib.save_checkpoint(os.path.join(save_dir, 'save_probe'), loaded['step'],
                                     loaded['model'], loaded['optimizer'], None,
                                     loaded['generator'])
    same = all(torch.equal(a, loaded['model'][k].cpu()) for k, a in
               ckpt_lib.load_checkpoint(probe)['model'].items())
    if not same:
        fail('[train_cli] a checkpoint saved from the card does not read back bit for bit')
    say(f'[train_cli] checkpoint {os.path.getsize(os.path.join(second["last"], "state.pt"))} '
        f'B, loaded to the card and saved from it bit for bit; on {card}')
    cli_panels_and_nan_check(cfg, device, card)
    return second['last'], launches


# K1's, K3's and K2's CUDA kernels, by the names the trace gives them
TRACE_KERNELS = {'bev_splat': 'splat_tile_kernel', 'gather_rows': 'gather_rows_kernel',
                 'convnext_mlp': 'convnext_mlp_kernel'}


def check_cli_trace(paths: list, card: str) -> None:
    """PROFILE.ENABLED's trace: one file, whose train_step_<n> ranges are
    exactly steps 2 and 3 (the JAX CLI's window at PROFILE.STEPS 2), with
    K1's, K3's and K2's kernels among its device events."""
    import re
    if len(paths) != 1:
        fail(f'[train_cli] PROFILE.ENABLED: {len(paths)} trace files, expected one')
    with open(paths[0]) as f:
        events = json.load(f)['traceEvents']
    steps = sorted({int(m.group(1)) for e in events
                    for m in [re.fullmatch(r'train_step_(\d+)', str(e.get('name', '')))] if m})
    kernels = [e['name'] for e in events if e.get('cat') == 'kernel']
    counts = {name: sum(k in n for n in kernels) for name, k in TRACE_KERNELS.items()}
    if steps != [2, 3] or not all(counts.values()):
        fail(f'[train_cli] the profiler trace holds steps {steps} (expected [2, 3]) and our '
             f'kernels {counts}')
    say(f'[train_cli] PROFILE.ENABLED: {os.path.basename(paths[0])}, '
        f'{os.path.getsize(paths[0])} B, {len(events)} events, train steps {steps}, '
        f'{len(kernels)} device kernels, of them {counts} ours; on {card}')


def cli_panels_and_nan_check(cfg, device, card: str) -> None:
    """The train panels of the card's outputs, outside the CLI's guard:
    ``visualise_output`` of a full-width val forward is (T, 7*200, 2*200,
    3) uint8 of more than a few colours. Then DEBUG.NAN_CHECK: after the
    clean steps that capture the compiled step, a batch with one camera
    image of NaNs (a replay of the gradients' graph) raises
    FloatingPointError between the two graphs and leaves the parameters,
    Adam's state and the step count bit for bit as they were."""
    import torch
    from stp3_tpu_torch.training.trainer import Trainer
    from stp3_tpu_torch.utils.network import prepare_image
    from stp3_tpu_torch.utils.visualisation import visualise_output
    run_cfg = cfg.clone()
    run_cfg.DEBUG.NAN_CHECK = True
    trainer = Trainer(run_cfg, device=device, seed=SEED)
    batch, = synthetic_batches(run_cfg, 1, device)
    output, labels = trainer.val_forward(batch)
    panel = visualise_output(labels, output, run_cfg)
    t, (h, w) = labels['segmentation'].shape[1], labels['segmentation'].shape[2:]
    colours = len(np.unique(panel.reshape(-1, 3), axis=0))
    if panel.shape != (t, 7 * h, 2 * w, 3) or panel.dtype != np.uint8 or colours < 4:
        fail(f'[train_cli] panels {panel.shape} {panel.dtype}, {colours} colours')
    warm_up_to_graphs(trainer, batch)              # the NaN step replays the graph
    params = [p.detach().clone() for p in trainer.model.parameters()]
    adam = {i: {k: v.clone() for k, v in st.items()}
            for i, st in trainer.optimizer.state_dict()['state'].items()}
    step = trainer.step
    bad = dict(batch)
    bad['image'] = prepare_image(batch['image'], torch.float32).clone()
    bad['image'][0, 0, 0] = float('nan')
    try:
        trainer.train_step(bad)
    except FloatingPointError as exc:
        message = str(exc)
    else:
        fail('[train_cli] DEBUG.NAN_CHECK: a NaN image did not raise FloatingPointError')
    after = trainer.optimizer.state_dict()['state']
    same = (trainer.step == step
            and all(torch.equal(a, p) for a, p in zip(params, trainer.model.parameters()))
            and all(torch.equal(after[i][k], v) for i, st in adam.items() for k, v in st.items()))
    if not same:
        fail('[train_cli] DEBUG.NAN_CHECK raised, but the parameters, Adam or the step moved')
    say(f'[train_cli] panels of the card\'s val forward: {panel.shape} uint8, {colours} '
        f'colours; DEBUG.NAN_CHECK on a NaN camera image: '
        f'FloatingPointError ({message}); parameters, Adam state and step {step} unchanged bit '
        f'for bit; on {card}')
    del trainer
    free_card()


def prediction_checkpoint(device, repo: str) -> str:
    """A checkpoint of the Prediction stage's seeded init (step 0) with the
    CLI data config, for [evaluate_prediction]."""
    import shutil
    from stp3_tpu_torch.training import checkpoint as ckpt_lib
    from stp3_tpu_torch.training.trainer import Trainer
    cfg = make_cfg(PREDICTION_STAGE, CLI_DATA)
    ckpt_dir = os.path.join(repo, 'build', 'chip_smoke', 'prediction', 'checkpoints')
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    os.makedirs(ckpt_dir)
    trainer = Trainer(cfg, device=device, seed=SEED)
    say(f'[evaluate_prediction] {cfg.TAG}: {sum(p.numel() for p in trainer.model.parameters())} '
        f'parameters, seeded init saved as step 0')
    return ckpt_lib.save_checkpoint(ckpt_dir, 0, trainer.model.state_dict(),
                                    cfg_dict=cfg.convert_to_dict())


def result_in_range(key: str, value: float) -> bool:
    if key.startswith('plan_L2'):
        return value >= 0
    return 0.0 <= value <= 1.0          # IoU, PQ / SQ / RQ, collision rates


def phase_evaluate(path: str, ckpt: str, device, card, keys) -> dict:
    """[evaluate_*]: ``stp3_tpu_torch.evaluate.evaluate`` on a checkpoint at
    batch 1 over the 4 validation samples, each a replay of the compiled
    validation call (one graph: K1 once and K2 twice in it; the counters
    move in its warm-up calls and its capture only); the result ``keys``
    exactly, each finite and in its range. Returns the launches."""
    from stp3_tpu_torch.evaluate import evaluate
    from stp3_tpu_torch.utils.graphs import WARMUP_CALLS
    stats = {}
    reset_launches()
    results = evaluate(ckpt, device, log=lambda msg: say(f'[{path}] {msg}'), stats=stats)
    launches = read_launches()
    n = stats['samples']
    if stats['captures'] != 1:
        fail(f'[{path}] the validation call captured {stats["captures"]} graphs, expected 1')
    expect_launches(f'[{path}] the validation graph', stats['launches'], bev_splat=1,
                    convnext_mlp=2)
    expect_launches(f'[{path}] {n} samples, the counted calls', launches,
                    bev_splat=WARMUP_CALLS + 1, convnext_mlp=2 * (WARMUP_CALLS + 1))
    if sorted(results) != sorted(keys):
        fail(f'[{path}] result keys {sorted(results)}, expected {sorted(keys)}')
    bad = {k: v for k, v in results.items() if not (np.isfinite(v) and result_in_range(k, v))}
    if bad:
        fail(f'[{path}] results not finite or out of range: {bad}')
    say(f'[{path}] launches {launches}; {n} samples at batch 1, every result finite and in '
        f'range; on {card}')
    return launches


def phase_decode(ckpt: str, device, card):
    """[decode]: the Prediction stage's validation output at full width and
    batch 1 (the checkpoint's weights): the device decode
    (utils/instance_jit.py) against the host loop, id for id. Returns
    (trainer, its synthetic batch)."""
    from stp3_tpu_torch.evaluate import eval_cfg
    from stp3_tpu_torch.training import checkpoint as ckpt_lib
    from stp3_tpu_torch.training.trainer import Trainer
    from stp3_tpu_torch.utils.instance import predict_instance_segmentation_and_trajectories
    cfg = eval_cfg(ckpt)
    trainer = Trainer(cfg, device=device)
    trainer.model.load_state_dict(ckpt_lib.load_checkpoint(ckpt, map_location=device)['model'])
    batch, = synthetic_batches(cfg, 1, device)
    output, _ = trainer.val_forward(batch)

    def decode(jit_decode):
        return predict_instance_segmentation_and_trajectories(
            output, make_consistent=False, jit_decode=jit_decode)

    on_device, on_host = decode(True), decode(False)
    if on_device.shape != on_host.shape or not np.array_equal(on_device, on_host):
        fail(f'[decode] device decode differs from the host loop at '
             f'{np.count_nonzero(on_device != on_host)} of {on_host.size} pixels')
    per_frame = [int(f.max()) for f in on_device.reshape(-1, *on_device.shape[-2:])]
    say(f'[decode] Prediction stage, {tuple(output["instance_center"].shape)} centers: the device '
        f'decode equals the host loop id for id (instances per frame {per_frame}); on {card}')
    return trainer, batch


def phase_labels_as_prediction(pred_trainer, pred_batch, device, card):
    """[labels as prediction]: the metrics at full width on the labels fed
    back as the prediction, which needs no trained weights: the Planning
    stage's label classes into IoUMetric (vehicle, pedestrian, each HD-map
    element), its GT trajectory into PlanningMetric per second of
    horizon, and the Prediction stage's label instance ids into
    PanopticMetric. Every present class's IoU, PQ, SQ and RQ must be 1,
    with no false positive or negative; L2 0 and no collision."""
    import torch
    from stp3_tpu_torch.metrics import IoUMetric, PanopticMetric, PlanningMetric
    from stp3_tpu_torch.training.trainer import Trainer
    cfg = make_cfg(PLANNING_STAGE, CLI_DATA)
    trainer = Trainer(cfg, device=device, seed=SEED)
    batch, = synthetic_batches(cfg, 1, device)
    labels = trainer.prepare_future_labels(batch)
    rf = cfg.TIME_RECEPTIVE_FIELD
    ious = {}
    for name, lab in (('vehicle', labels['segmentation'][:, rf - 1:]),
                      ('pedestrian', labels['pedestrian'][:, rf - 1:]),
                      *((e, labels['hdmap'][..., i])
                        for i, e in enumerate(cfg.SEMANTIC_SEG.HDMAP.ELEMENTS))):
        metric = IoUMetric(2)
        metric.update(lab, lab)
        score, st = metric.compute(), metric.state
        present = st['support'] > 0
        if st['fp'].any() or st['fn'].any() or not (score[present] == 1.0).all():
            fail(f'[labels as prediction] IoU {name}: {score}, state {st}')
        ious[name] = score.tolist()
    occupancy = torch.logical_or(labels['segmentation'][:, rf:], labels['pedestrian'][:, rf:])
    gt = labels['gt_trajectory']
    plan = {}
    for i in range(cfg.N_FUTURE_FRAMES // 2):
        t = 2 * (i + 1)
        metric = PlanningMetric(cfg, t)
        metric.update(gt[:, 1:t + 1], gt[:, 1:t + 1], occupancy[:, :t])
        res = metric.compute()
        if res['L2'].any() or res['obj_col'].any() or res['obj_box_col'].any():
            fail(f'[labels as prediction] planning {t} frames: {res}')
        plan[f'{i + 1}s'] = {k: float(v.mean()) for k, v in res.items()}
    inst = pred_trainer.prepare_future_labels(pred_batch)['instance'][:, pred_trainer.rf - 1:]
    pan = PanopticMetric(2)
    pan.update(inst, inst)
    res = pan.compute()
    if (pan.state['false_positive'].any() or pan.state['false_negative'].any()
            or not all(res[k][1] == 1.0 for k in ('pq', 'sq', 'rq'))):
        fail(f'[labels as prediction] panoptic {res}, state {pan.state}')
    say(f'[labels as prediction] IoU {ious}; planning {plan}; panoptic '
        f'{ {k: v.tolist() for k, v in res.items()} } over '
        f'{int(pan.state["true_positive"][1])} vehicle instances; no false positive or negative')


def phase_reference_import(device, card, repo: str, cfg=None) -> dict:
    """[reference_import]: a reference-format Lightning .ckpt of the
    nuScenes Planning stage at full width (seeded, the config as plain
    hyper_parameters), imported with ``import_torch_checkpoint`` (an ok()
    report, only the bookkeeping ignored), evaluated with
    ``stp3_tpu_torch.evaluate.evaluate`` on the card at batch 1 as
    [evaluate_planning] is (K1 once and K2 twice a sample), then exported
    with ``export_torch_checkpoint`` and held to the input bit for bit (the
    planner GRU's r / z biases to their fold). Returns the evaluation's
    launches."""
    import shutil
    import torch
    from stp3_tpu_torch.scripts.export_torch_checkpoint import export_checkpoint
    from stp3_tpu_torch.scripts.import_torch_checkpoint import import_checkpoint
    cfg = cfg if cfg is not None else make_cfg(PLANNING_STAGE, CLI_DATA)
    root = os.path.join(repo, 'build', 'chip_smoke', 'reference_import')
    shutil.rmtree(root, ignore_errors=True)
    ckpt = os.path.join(root, 'reference.ckpt')
    sd, bookkeeping = write_reference_checkpoint(cfg, ckpt)
    n_bytes = sum(v.nbytes for v in sd.values())

    def log(msg):
        say(f'[reference_import] {msg}')

    path, report = import_checkpoint(ckpt, os.path.join(root, 'imported'), log=log)
    if not report.ok() or report.ignored != bookkeeping:
        fail(f'[reference_import] report: missing {report.missing[:4]}, unexpected '
             f'{report.unexpected[:4]}, ignored beyond the bookkeeping '
             f'{sorted(set(report.ignored) ^ set(bookkeeping))[:4]}')
    launches = phase_evaluate('reference_import', path, device, card, planning_result_keys(cfg))
    export_checkpoint(path, os.path.join(root, 'exported.ckpt'), log=log)
    exported = torch.load(os.path.join(root, 'exported.ckpt'), map_location='cpu',
                          weights_only=True)['state_dict']
    try:
        n = check_export(sd, bookkeeping, exported, cfg)
    except AssertionError as exc:
        fail(f'[reference_import] {exc}')
    say(f'[reference_import] {cfg.TAG}: {len(sd)} model tensors, {n_bytes} B '
        f'({sum(v.size for v in sd.values())} values) + {len(bookkeeping)} bookkeeping entries; '
        f'report ok, '
        f'{report.converted} leaves, only the bookkeeping ignored; the export gives back all '
        f'{n} tensors bit for bit (the planner GRU\'s r / z biases as their fold); on {card}')
    return launches


def record_selection(model, sink: dict) -> None:
    """Wrap ``model.planner.select`` to write the index of the candidate it
    selects (B,) into the device buffer ``sink['pick']`` (a measurement;
    nothing else changes), which ``drive_harness`` and ``drive_core``
    append to ``sink['picks']`` after each planned tick. A compiled call
    captures the copy into that buffer: install this before the AgentCore
    that compiles it."""
    import torch
    select = model.planner.select
    sink['pick'] = torch.zeros(1, dtype=torch.int64, device=next(model.parameters()).device)

    def recording(trajs, *args):
        final = select(trajs, *args)
        sink['pick'].copy_((trajs == final[:, None]).flatten(2).all(-1).int().argmax(-1))
        return final
    model.planner.select = recording


def drive_harness(agent, n_ticks: int, sink=None):
    """``run_step`` over ``n_ticks`` recorded ticks (the sampler's module RNG
    seeded before each): the controls, the number of planned ticks, and
    the launches of the planned ticks after the first two; with a
    ``record_selection`` sink, each planned tick's pick."""
    controls, planned = [], 0
    for t, (frame, _, theta) in enumerate(recorded_ticks(n_ticks)):
        data = bgra_tick(t, frame, theta)
        if planned == 2:
            reset_launches()
        np.random.seed(SEED + t)
        controls.append(agent.run_step(data, t))
        if agent.core.warmed_up:
            planned += 1
            if sink is not None:
                sink['picks'].append(sink['pick'].clone())
    return controls, planned, read_launches()


def drive_core(core, n_ticks: int, sink=None):
    """The same ticks into an ``AgentCore`` directly: RGB frames, the
    position, command and local target computed here as the leaderboard
    glue does (reference carla_agent.py), zero control while warming up."""
    from stp3_tpu_torch.deploy.control import RoutePlanner
    route = RoutePlanner(1.0, 50.0)
    route.set_route(AGENT_ROUTE, True)
    controls = []
    for t, (frame, _, theta) in enumerate(recorded_ticks(n_ticks)):
        gps = np.array([2.0 * t / RoutePlanner.SCALE[0], 0.0])
        pos = (gps - route.mean) * route.scale
        wp, cmd = route.run_step(pos)
        c, s_ = np.cos(theta + np.pi / 2), np.sin(theta + np.pi / 2)
        local = np.array([[c, -s_], [s_, c]]).T @ (wp - pos) * [1.0, -1.0]
        core.push_frame(frame, pos, theta)
        np.random.seed(SEED + t)
        if not core.warmed_up:
            controls.append((0.0, 0.0, 0.0))
            continue
        steer, throttle, brake, _ = core.plan_step(3.0, cmd, local)
        if sink is not None:
            sink['picks'].append(sink['pick'].clone())
        brake = float(brake)
        controls.append((steer, throttle, 0.0 if brake < 0.05 or throttle > brake else brake))
    return controls


def phase_carla_agent(device, card, repo: str, agent_per_tick: dict, cfg=None) -> dict:
    """[carla_agent]: a reference-format .ckpt of the CARLA Planning stage
    at full width, imported (PLANNING.CAM_FRONT_PARITY set: the rig's front
    camera is at index 0), driven through the harness ``STP3Agent`` on the
    card over the recorded ticks as BGRA sensor data: warm-up ticks zero,
    planned ticks equal (1e-5, deterministic algorithms) to an
    ``AgentCore`` on the same loaded model fed the RGB frames, launches
    per tick as [agent]'s default (static) mode. Then the harness with
    the model cast to bf16: how many planned ticks select another
    candidate than fp32 (a measurement). Returns the launches of the 20
    counted fp32 ticks."""
    import shutil
    import torch
    from stp3_tpu_torch.carla_agent import STP3Agent
    from stp3_tpu_torch.deploy.agent_core import AgentCore
    from stp3_tpu_torch.scripts.import_torch_checkpoint import CAM_FRONT_NOTE, import_checkpoint
    from stp3_tpu_torch.training import checkpoint as ckpt_lib
    cfg = cfg if cfg is not None else carla_planning_cfg()
    root = os.path.join(repo, 'build', 'chip_smoke', 'carla_agent')
    shutil.rmtree(root, ignore_errors=True)
    ckpt = os.path.join(root, 'reference.ckpt')
    write_reference_checkpoint(cfg, ckpt)
    notes = []

    def log(msg):
        notes.append(msg)
        say(f'[carla_agent] {msg}')

    path, report = import_checkpoint(ckpt, os.path.join(root, 'imported'), log=log)
    if not report.ok() or CAM_FRONT_NOTE not in notes or not ckpt_lib.load_config_dict(
            path)['PLANNING']['CAM_FRONT_PARITY']:
        fail(f'[carla_agent] import: report ok {report.ok()}, CAM_FRONT_PARITY not set and '
             f'printed for the rig {list(cfg.IMAGE.NAMES)}')

    rf, n_counted = cfg.TIME_RECEPTIVE_FIELD, 20
    n_ticks = rf + 3 + n_counted
    agent = STP3Agent()
    agent.setup(path)
    if agent.core.device.type != device.type or agent.core.model.cfg.cam_front_index != 1:
        fail(f'[carla_agent] the harness runs on {agent.core.device}, planner camera '
             f'{agent.core.model.cfg.cam_front_index}')
    agent.set_global_plan(AGENT_ROUTE)
    sink = {'picks': []}
    record_selection(agent.core.model, sink)
    # the harness's core again, compiled with the recording in its graphs
    agent.core = AgentCore(agent.cfg, agent.core.model, device=device)
    controls, planned, launches = drive_harness(agent, n_ticks, sink)
    picks = {'fp32': list(sink['picks'])}
    expect_launches('[carla_agent] harness ticks (replays)', launches)
    per = tick_graph(agent.core).launches_per_call
    expect_launches('[carla_agent] harness tick graph', per,
                    **{k: v for k, v in agent_per_tick['static'].items() if v})
    n_warm = len(controls) - planned
    zero = {'steer': 0.0, 'throttle': 0.0, 'brake': 0.0}
    if planned != 2 + n_counted or n_warm != rf + 1 or any(c != zero for c in controls[:n_warm]):
        fail(f'[carla_agent] {len(controls)} ticks, {planned} planned, warm-up controls '
             f'{controls[:n_warm]}')
    core = AgentCore(agent.cfg, agent.core.model, device=device)
    sink['picks'] = []
    direct = drive_core(core, n_ticks, sink)
    got = np.array([[c['steer'], c['throttle'], c['brake']] for c in controls], np.float64)
    spread = float(np.abs(got - np.array(direct, np.float64)).max())
    flips_nd = sum(a != b for a, b in zip(torch.cat(picks['fp32']).tolist(),
                                          torch.cat(sink['picks']).tolist()))
    # each core holds its graphs' pool (up to ~18 GiB in fp32: PERF.md)
    del core, agent
    free_card()
    # the comparison itself with deterministic algorithms: two runs of the same
    # ticks on the card differ by the order of their fp32 atomic adds (the
    # column splat's index_add_), which the line above shows
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        agent_d = STP3Agent()
        agent_d.setup(path)
        agent_d.set_global_plan(AGENT_ROUTE)
        controls_d, _, _ = drive_harness(agent_d, n_ticks)
        direct_d = drive_core(AgentCore(agent_d.cfg, agent_d.core.model, device=device), n_ticks)
    finally:
        torch.use_deterministic_algorithms(False)
    del agent_d
    free_card()
    got_d = np.array([[c['steer'], c['throttle'], c['brake']] for c in controls_d], np.float64)
    err = float(np.abs(got_d - np.array(direct_d, np.float64)).max())
    if err > 1e-5 or controls_d[:n_warm] != controls[:n_warm]:
        fail(f'[carla_agent] harness controls differ from a direct AgentCore by {err:.3e} '
             f'(deterministic algorithms)')
    say(f'[carla_agent] harness: {n_warm} warm-up ticks of zero control, {planned} planned '
        f'ticks equal to a direct AgentCore on the same model within {err:.3e} (tolerance '
        f'1e-5, deterministic algorithms; without them the two runs differ by {spread:.3e}, '
        f'{flips_nd} of {planned} ticks selecting another candidate: the atomics\' '
        f'order); launches per tick (in its graph) {({k: v for k, v in per.items() if v})} as '
        f'[agent] static; on {card}')

    # the same harness with the imported model cast to bf16 (AgentCore runs in
    # its weights' dtype): a measurement, no option of the harness
    agent16 = STP3Agent()
    agent16.setup(path)
    model16 = agent16.core.model.to(torch.bfloat16)
    sink = {'picks': []}
    record_selection(model16, sink)
    agent16.core = AgentCore(agent16.cfg, model16, device=device)
    agent16.set_global_plan(AGENT_ROUTE)
    controls16, planned16, _ = drive_harness(agent16, n_ticks, sink)
    picks['bf16'] = sink['picks']
    if planned16 != 2 + n_counted or not all(
            np.isfinite([c['steer'], c['throttle']]).all() for c in controls16):
        fail(f'[carla_agent] bf16 harness: {planned16} planned ticks, controls {controls16}')
    sel = {k: torch.cat(v).tolist()[2:] for k, v in picks.items()}
    flips = sum(a != b for a, b in zip(sel['fp32'], sel['bf16']))
    d_steer = float(np.abs(np.array([c['steer'] for c in controls16[-n_counted:]])
                           - got[-n_counted:, 0]).max())
    say(f'[carla_agent] bf16 harness: {flips} of {n_counted} planned ticks select another '
        f'candidate than fp32 (indices fp32 {sel["fp32"]}, bf16 {sel["bf16"]}); steer differs '
        f'by up to {d_steer:.3e}; launches per tick (in its graph) '
        f'{ {k: v for k, v in tick_graph(agent16.core).launches_per_call.items() if v}}; '
        f'on {card}')
    return launches


def phase_image_io(repo: str, card: str) -> None:
    """[image_io]: the host C codec (csrc/image_codec.c, built with cc):
    the committed 1600x900 camera fixture decoded to the SHA-256 of
    Pillow's decode stored beside it, and its nuScenes resize (bilinear,
    0.3) + crop to the SHA-256 of Pillow's; PNGs of every mode written with
    every row filter read back exactly; the resampler against its numpy
    plain version."""
    import hashlib
    from stp3_tpu_torch.datas.nuscenes_data import resize_and_crop_image
    from stp3_tpu_torch.utils import image_io
    info = image_io.load()
    say(f"[image_io] image_codec.c {'built' if info['built'] else 'reused'} "
        f"-> {os.path.relpath(info['path'], repo)}")
    meta = fake.camera_meta()
    img = image_io.read_jpeg(fake.CAMERA_JPEG)
    digest = hashlib.sha256(img.tobytes()).hexdigest()
    if list(img.shape) != meta['decode']['shape'] or digest != meta['decode']['sha256']:
        fail(f'[image_io] the fixture decodes to {img.shape} {digest}, Pillow to '
             f"{meta['decode']}")
    key = 'resize_bilinear_480x270_crop_0_46_480_270'
    crop = resize_and_crop_image(img, (480, 270), (0, 46, 480, 270))
    if hashlib.sha256(crop.tobytes()).hexdigest() != meta[key]['sha256']:
        fail('[image_io] the resize + crop of the fixture differs from Pillow\'s')
    rng = np.random.RandomState(SEED)
    shapes = {'L': (300, 400), 'P': (300, 400), 'LA': (300, 400, 2), 'RGB': (300, 400, 3),
              'RGBA': (300, 400, 4)}
    for mode, shape in shapes.items():
        arr = rng.randint(0, 256, shape, np.uint8)
        got, got_mode = image_io.decode_png(fake.png_bytes(arr, mode))
        if got_mode != mode or not np.array_equal(got, arr):
            fail(f'[image_io] a {mode} PNG does not read back exactly')
    for size, filt in (((480, 270), 'bilinear'), ((232, 232), 'nearest'), ((363, 272), 'bicubic')):
        src = img if filt != 'nearest' else img[:256, :256, 0]
        if not np.array_equal(image_io.resample(src, size, filt),
                              image_io.resample_plain(src, size, filt)):
            fail(f'[image_io] {filt} resample to {size} differs from its plain version')
    say(f'[image_io] the 1600x900 fixture decodes to Pillow\'s SHA-256 and its resize + crop to '
        f'Pillow\'s; PNGs L / P / LA / RGB / RGBA with all five row filters read back exactly; '
        f'bilinear, nearest and bicubic equal their plain versions; beside {card}')


def phase_dataset(tag: str, cfg, device, card: str, epochs: int = 2) -> dict:
    """[nuscenes_data] / [carla_data]: a stage's training on its dataset
    class through ``prepare_dataloaders`` with cfg.N_WORKERS process
    workers: ``epochs`` epochs of train steps on the loader's batches (the
    compiled step: its graphs' launches, the counters over the steps up to
    the capturing one; every loss term finite). Returns the launches."""
    import torch
    from stp3_tpu_torch.datas.dataloaders import prepare_dataloaders
    from stp3_tpu_torch.training.trainer import Trainer, batch_to_device
    from stp3_tpu_torch.utils.graphs import WARMUP_CALLS
    trainloader, valloader, traindata, _ = prepare_dataloaders(cfg, return_dataset=True)
    try:
        n = len(traindata)
        if len(trainloader) < 3:
            fail(f'[{tag}] {n} training samples: too few for the train steps')
        sample = traindata[0]
        say(f'[{tag}] {type(traindata).__name__}: {n} training samples; a sample: ' + ', '.join(
            f'{k} {tuple(v.shape)} {v.dtype}' for k, v in sample.items()
            if k in ('image', 'depths', 'segmentation', 'hdmap', 'sample_trajectory')))
        trainer = Trainer(cfg, device=device, seed=SEED)
        losses = []
        reset_launches()
        for _ in range(epochs):
            for batch in trainloader:
                losses.append(trainer.train_step(batch_to_device(batch, device)))
        launches = read_launches()
        steps = len(losses)
        counted = min(steps, WARMUP_CALLS + 1)
        expect_train_graphs(f'[{tag}] train step', trainer, bev_splat=1, gather_rows=1,
                            convnext_mlp=2)
        expect_launches(f'[{tag}] {steps} train steps, {counted} counted (eager, capturing)',
                        launches, bev_splat=counted, gather_rows=counted,
                        convnext_mlp=2 * counted)
        for i, loss in enumerate(losses):
            bad = [k for k, v in loss.items() if not torch.isfinite(v).all()]
            if bad:
                fail(f'[{tag}] step {i}: loss terms {bad} are not finite')
        if cfg.LIFT.GT_DEPTH and 'depths' not in losses[-1]:
            fail(f'[{tag}] GT_DEPTH is on but the step has no depth loss')
        say(f'[{tag}] {steps} train steps on the loader\'s batches ({int(cfg.N_WORKERS)} '
            f'process workers), every loss term finite ({", ".join(sorted(losses[-1]))}); '
            f'launches {launches}; on {card}')
        del trainer
        free_card()
        return launches
    finally:
        trainloader.close()
        valloader.close()


def phase_real_data(repo: str, device, card: str) -> dict:
    """The stand-in trees under build/chip_smoke/, then [nuscenes_data]
    (the Planning stage with LIFT.GT_DEPTH: 6 cameras at 1600x900 -> 224x480,
    3 past and 6 future frames, the 200x200 BEV; 'mini': 10 windows) and
    [carla_data] (CARLA's Planning stage: 4 cameras at 400x300 -> 256, the
    topdown labels at scale 1.1, the hdmap PNGs; 10 training windows).
    Returns their launches."""
    import shutil
    root = os.path.join(repo, 'build', 'chip_smoke', 'data')
    shutil.rmtree(root, ignore_errors=True)
    nusc_root, carla_root = os.path.join(root, 'nuscenes'), os.path.join(root, 'carla')
    fake.install(n_samples=18)                     # 18 samples: 10 windows of 3 + 6
    fake.write_carla_route(carla_root, n_frames=17, town='Town01_tiny')
    fake.write_carla_route(carla_root, n_frames=9, town='Town05_short')
    launches = {}
    cfg = make_cfg(PLANNING_STAGE, NUSCENES_DATA,
                   {'DATASET': {'DATAROOT': nusc_root, 'MAP_FOLDER': nusc_root}})
    launches['nuscenes_data'] = phase_dataset('nuscenes_data', cfg, device, card)
    cfg = make_cfg(CARLA_PLANNING, CARLA_DATA, {'DATASET': {'DATAROOT': carla_root}})
    launches['carla_data'] = phase_dataset('carla_data', cfg, device, card)
    return launches


# ------------------------------------------------- data and camera parallel
# the multi-rank phases share the one card over gloo (NCCL refuses two
# ranks on one device); [dp nccl] runs NCCL at world 1 in this process
RANKS_TIMEOUT_S = 420
DP_WORLD = 2
CAM_WORLD = 3


def grad_errors(grads: dict, want: dict) -> dict:
    """Each gradient's L2 error against ``want``'s, relative to its norm or
    to 1e-4 of the largest gradient's norm, the larger: a gradient that is
    zero but for rounding (a 'bn' bias whose output feeds another 'bn')
    is held to that floor, not to its own rounding."""
    floor = 1e-4 * max(g.double().norm().item() for g in want.values())
    return {n: ((grads[n].double() - g.double()).norm().item()
                / max(g.double().norm().item(), floor)) for n, g in want.items()}


def stats_error(stats: dict, want: dict) -> float:
    """The largest difference of the 'bn' running statistics, over the
    largest running variance: a running mean near zero (a 'bn' after a
    bias-free linear map of a normalised input) has no relative error."""
    if not want:
        return 0.0
    scale = max(v.abs().max().item() for k, v in want.items() if k.endswith('var'))
    return max((stats[k] - v).abs().max().item() for k, v in want.items()) / scale


def phase_dp_nccl(cfg, device, card) -> dict:
    """[dp nccl]: the Planning stage at full width and batch 2 (bf16
    policy) through the data-parallel Trainer over NCCL at world 1 beside
    the plain Trainer, from one seeded init. The reduce is an identity:
    the plain step's gradients all-reduced over the one rank and divided
    by 1, and the loss terms averaged, equal themselves bit for bit, and
    both trainers' clip + Adam on them leave parameters equal bit for bit.
    The distributed step compiles over NCCL (the gradient all-reduce runs
    between its two graphs): K1, K3 and K2 twice in its gradients' graph.
    Returns the launches of its steps up to the capture."""
    import torch
    import torch.distributed as dist
    from stp3_tpu_torch.parallel import mesh
    from stp3_tpu_torch.parallel.launch import free_port
    from stp3_tpu_torch.training.trainer import Trainer
    env = {'RANK': '0', 'WORLD_SIZE': '1', 'LOCAL_RANK': '0', 'MASTER_ADDR': '127.0.0.1',
           'MASTER_PORT': str(free_port())}          # torchrun's environment, one rank
    os.environ.update(env)
    try:
        if mesh.maybe_initialize_multihost(device) != device or (
                device.type == 'cuda' and dist.get_backend() != 'nccl'):
            fail('[dp nccl] the process group did not start on NCCL on the card')
        group = mesh.data_group()
        plain = Trainer(cfg, device=device, seed=SEED)
        dp = Trainer(cfg, device=device, seed=SEED, group=group)
        for (n, p), q in zip(plain.model.named_parameters(), dp.model.parameters()):
            if not torch.equal(p, q):
                fail(f'[dp nccl] broadcast over one rank changed {n}')
        batches = synthetic_batches(cfg, 2, device)
        loss = plain.compute_gradients(batches[0])
        for p, q in zip(plain.model.parameters(), dp.model.parameters()):
            q.grad = p.grad.clone()
        mesh.allreduce_gradients(dp.model.parameters(), group)
        averaged = mesh.allreduce_mean(loss, group)
        for (n, p), q in zip(plain.model.named_parameters(), dp.model.parameters()):
            if not torch.equal(p.grad, q.grad):
                fail(f'[dp nccl] all-reduce / 1 changed the gradient of {n}')
        if any(not torch.equal(averaged[k], v) for k, v in loss.items()):
            fail('[dp nccl] the loss terms averaged over one rank changed')
        plain.apply_gradients()
        dp.apply_gradients()
        same = all(torch.equal(p, q) for p, q in zip(plain.model.parameters(),
                                                      dp.model.parameters()))
        if not same:
            fail('[dp nccl] clip + Adam on equal gradients left different parameters')
        reset_launches()
        n = warm_up_to_graphs(dp, batches[1])
        launches = read_launches()
        expect_train_graphs('[dp nccl] the distributed step', dp, bev_splat=1, gather_rows=1,
                            convnext_mlp=2)
        expect_launches(f'[dp nccl] {n} distributed steps, the last capturing', launches,
                        bev_splat=n, gather_rows=n, convnext_mlp=2 * n)
        say(f'[dp nccl] world 1 over NCCL: the gradients of {sum(1 for _ in dp.model.parameters())} '
            f'tensors all-reduced and divided by 1, the loss terms averaged, and clip + Adam '
            f'on them: bit for bit the plain Trainer\'s; the distributed step compiled, '
            f'launches in its gradients\' graph {dp.graphs["gradients"].launches_per_call}, '
            f'counted in its {n} steps to the capture {launches}; on {card}')
        del plain, dp, batches
        free_card()
        return launches
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)


def spawn_ranks(scenario: str, world: int, repo: str) -> list:
    """``world`` ranks of this script (``--rank scenario``) sharing card 0
    over gloo, under a deadline; returns each rank's JSON result. A rank
    that fails fails the phase."""
    from stp3_tpu_torch.parallel.launch import run_ranks
    out = os.path.join(repo, 'build', 'chip_smoke', f'ranks_{scenario}')
    os.makedirs(out, exist_ok=True)
    free_card()
    try:
        outputs = run_ranks([sys.executable, os.path.abspath(__file__), '--rank', scenario,
                             out], world, RANKS_TIMEOUT_S, cwd=repo, share_device=True)
    except (RuntimeError, TimeoutError) as exc:
        fail(f'[{scenario}] {exc}')
    results = []
    for r in range(world):
        with open(os.path.join(out, f'rank{r}.json')) as f:
            results.append(json.load(f))
    for line in outputs[0].splitlines():
        if line.startswith('['):
            say(line)
    say(f'[{scenario}] {world} ranks on one card over gloo finished')
    return results


def dp_global(cfg, device):
    """A global batch of 2 synthetic samples (host numpy) and a fixed draw."""
    from stp3_tpu_torch.datas.synthetic import SyntheticDataset, collate
    ds = SyntheticDataset(cfg, n_samples=2, seed=SEED)
    batch = collate([ds[i] for i in range(2)])
    batch['noise'] = np.random.RandomState(SEED).randn(
        2, 1, cfg.MODEL.DISTRIBUTION.LATENT_DIM).astype(np.float32)
    return batch


def dp_step_numbers(trainer, batch, noise) -> dict:
    """One step (dropout off, the draw ``noise``): the loss terms, the
    gradients (after any all-reduce), the parameters' update and the 'bn'
    running statistics."""
    start = [p.detach().clone() for p in trainer.model.parameters()]
    loss = trainer.compute_gradients(batch, noise, dropout=False)
    grads = {n: p.grad.clone() for n, p in trainer.model.named_parameters()}
    trainer.apply_gradients()
    return {'loss': {k: v.item() for k, v in loss.items()}, 'grads': grads,
            'update': [p.detach() - s for p, s in zip(trainer.model.parameters(), start)],
            'stats': running_stats(trainer.model)}


def dp_distance(got: dict, want: dict) -> dict:
    """How far one step's numbers are from another's."""
    errs = grad_errors(got['grads'], want['grads'])
    worst = max(errs, key=errs.get)
    return {'loss': max(abs(got['loss'][k] - v) / max(abs(v), 1e-12)
                        for k, v in want['loss'].items()),
            'median': float(np.median(list(errs.values()))), 'worst': errs[worst],
            'worst_name': worst,
            'update': float(np.median([((u - w).norm() / w.norm().clamp_min(1e-30)).item()
                                       for u, w in zip(got['update'], want['update'])])),
            'stats': stats_error(got['stats'], want['stats'])}


def dp_compare(tag, cfg, device, group, rank) -> dict:
    """One step (dropout off, a fixed draw) of a seeded init on this rank's
    row of a global batch of 2. Rank 0 also takes the one-process step on
    the global batch, and on it with its two samples swapped (the same
    step summed in another order: the floor of fp32 reassociation), and
    measures the 2-rank step's distance from the first, beside the
    swapped step's; every rank holds its parameters and statistics to
    rank 0's, bit for bit."""
    import torch
    from stp3_tpu_torch.parallel import mesh
    from stp3_tpu_torch.training.trainer import Trainer, batch_to_device
    glob_np = dp_global(cfg, device)
    ref = []
    if rank == 0:
        for order in ([0, 1], [1, 0]):
            batch = batch_to_device({k: v[order] for k, v in glob_np.items()}, device)
            noise = batch.pop('noise')
            ref.append(dp_step_numbers(Trainer(cfg, device=device, seed=SEED), batch, noise))
            free_card()
    trainer = Trainer(cfg, device=device, seed=SEED, group=group)
    rows = mesh.shard_batch(glob_np, device, group)
    noise = rows.pop('noise')
    mine_numbers = dp_step_numbers(trainer, rows, noise)
    # every rank against rank 0, bit for bit
    mine = torch.cat([p.detach().reshape(-1) for p in trainer.model.parameters()]
                     + [v.reshape(-1) for v in mine_numbers['stats'].values()])
    theirs = mine.clone()
    torch.distributed.broadcast(theirs, src=0, group=group)
    if not torch.equal(mine, theirs):
        fail(f'[{tag}] rank {rank} parameters or statistics differ from rank 0\'s')
    out = {'equal_to_rank0': True}
    if rank == 0:
        out.update(split=dp_distance(mine_numbers, ref[0]), swapped=dp_distance(ref[1], ref[0]),
                   n_grads=len(ref[0]['grads']), n_stats=len(ref[0]['stats']))
    del trainer
    free_card()
    return out


def rank_dp(out_dir: str) -> dict:
    """One rank of [dp 2 ranks] and [dp bn] (``--rank dp``)."""
    import torch
    from stp3_tpu_torch.parallel import mesh
    from stp3_tpu_torch.training.trainer import Trainer
    device = mesh.maybe_initialize_multihost(backend='gloo')
    group = mesh.data_group()
    rank = mesh.process_index(group)
    fp32 = make_cfg(PLANNING_STAGE, {'PRECISION': 32})
    result = {'dp': dp_compare('dp 2 ranks', fp32, device, group, rank)}
    # 3 bf16 steps through the kernels, each rank on its own batch of 1
    trainer = Trainer(planning_cfg(), device=device, seed=SEED, group=group)
    if trainer.compiled:
        fail(f'[dp 2 ranks] rank {rank}: a gloo group\'s trainer must step eagerly')
    batch = mesh.shard_batch(dp_global(fp32, device), device, group)
    batch.pop('noise')
    reset_launches()
    for _ in range(3):
        loss = trainer.train_step(batch)
    result['launches'] = read_launches()
    expect_launches(f'[dp 2 ranks] rank {rank}: 3 bf16 steps', result['launches'],
                    bev_splat=3, gather_rows=3, convnext_mlp=6)
    if not all(torch.isfinite(v).all() for v in loss.values()):
        fail(f'[dp 2 ranks] rank {rank}: a bf16 loss term is not finite')
    del trainer
    free_card()
    result['bn'] = dp_compare('dp bn', make_cfg(PLANNING_STAGE, {'PRECISION': 32,
                                                                 'MODEL': {'NORM': 'bn'}}),
                              device, group, rank)
    return result


def phase_dp_batch_split(device, card) -> None:
    """[dp batch split]: whether the 2-rank fp32 distance of [dp 2 ranks]
    comes from the all-reduce or from the batch size. In one process, no
    group, fp32 with TF32 off and deterministic algorithms where torch has
    them (K1's fp32 atomics and the bilinear upsample's backward have none:
    warn only): the Planning stage at full width from one seeded init,
    dropout off, a fixed draw; the mean of the two batch-1 gradients (as
    the all-reduce averages them) against the batch-2 gradient, beside the
    batch-2 step with its samples swapped. Held to ``DP_LIMITS`` as the
    2-rank step is."""
    import torch
    from stp3_tpu_torch.training.trainer import Trainer, batch_to_device
    cfg = make_cfg(PLANNING_STAGE, {'PRECISION': 32})
    glob_np = dp_global(cfg, device)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        steps = {}
        for name, rows in (('global', [0, 1]), ('swapped', [1, 0]), ('row0', [0]),
                           ('row1', [1])):
            batch = batch_to_device({k: v[rows] for k, v in glob_np.items()}, device)
            noise = batch.pop('noise')
            steps[name] = dp_step_numbers(Trainer(cfg, device=device, seed=SEED), batch, noise)
            free_card()
    finally:
        torch.use_deterministic_algorithms(False)
    split = {'loss': {k: (steps['row0']['loss'][k] + steps['row1']['loss'][k]) / 2
                      for k in steps['global']['loss']},
             'grads': {n: (steps['row0']['grads'][n] + steps['row1']['grads'][n]) / 2
                       for n in steps['global']['grads']},
             'update': steps['global']['update'], 'stats': {}}
    got, floor = dp_distance(split, steps['global']), dp_distance(steps['swapped'],
                                                                  steps['global'])
    limits = {m: max(lim, 10 * floor[m]) for m, lim in DP_LIMITS.items() if m != 'update'}
    say(f'[dp batch split] one process, fp32, TF32 off, deterministic algorithms where torch '
        f'has them: the mean of two batch-1 steps vs the batch-2 step (the batch-2 step with '
        f'its samples swapped in brackets): loss terms rel {got["loss"]:.2e} '
        f'[{floor["loss"]:.2e}]; {len(split["grads"])} gradients, median {got["median"]:.2e} '
        f'[{floor["median"]:.2e}], worst {got["worst"]:.2e} ({got["worst_name"]}) '
        f'[{floor["worst"]:.2e}]; on {card}')
    over = [m for m in limits if got[m] > limits[m]]
    if over:
        fail(f'[dp batch split] the batch-1 steps do not average to the batch-2 step: {over}')


# each measure of the 2-rank step's distance from the one-process step
# may reach the larger of its limit and 10 times the swapped step's distance
DP_LIMITS = {'loss': 1e-4, 'median': 1e-3, 'worst': 1e-2, 'update': 1e-2, 'stats': 1e-3}


def report_dp(results: list, card: str) -> dict:
    """Gate and print [dp 2 ranks] and [dp bn] from the ranks' results.
    fp32, TF32 off: the loss terms' relative error; each gradient's L2
    error over its norm, or over 1e-4 of the largest gradient's norm where
    its own is smaller (``grad_errors``), in the median and the worst; the
    median relative error of the parameters' updates; the running
    statistics' largest difference over the largest running variance
    (``stats_error``). Each may reach the larger of ``DP_LIMITS`` (the
    limits of [train parity], where an fp32 ReLU sign flip moves every
    gradient upstream of it) and 10 times the distance of the
    one-process step with its two samples swapped: 'bn' in fp32 forms
    E[x^2] - E[x]^2, which reassociation moves by far more than its
    rounding where the variance is small against the mean."""
    for tag, key in (('dp 2 ranks', 'dp'), ('dp bn', 'bn')):
        split, floor = results[0][key]['split'], results[0][key]['swapped']
        limits = {m: max(lim, 10 * floor[m]) for m, lim in DP_LIMITS.items()}
        say(f'[{tag}] 2 ranks at batch 1 over gloo vs one process at batch 2 (fp32, TF32 '
            f'off, dropout off, a fixed draw; the one-process step with its samples swapped '
            f'in brackets): loss terms rel {split["loss"]:.2e} [{floor["loss"]:.2e}]; '
            f'{results[0][key]["n_grads"]} gradients after the all-reduce, median '
            f'{split["median"]:.2e} [{floor["median"]:.2e}], worst {split["worst"]:.2e} '
            f'({split["worst_name"]}) [{floor["worst"]:.2e}]; parameter updates median rel '
            f'{split["update"]:.2e} [{floor["update"]:.2e}]; {results[0][key]["n_stats"]} '
            f'running statistics {split["stats"]:.2e} [{floor["stats"]:.2e}]; limits '
            f'{ {m: float(f"{v:.2e}") for m, v in limits.items()} }; both ranks\' parameters '
            f'and statistics equal bit for bit')
        over = [m for m in DP_LIMITS if split[m] > limits[m]]
        if over:
            fail(f'[{tag}] the 2-rank step is not the one-process global-batch step: {over}')
    for rank, r in enumerate(results):
        say(f'[dp 2 ranks] rank {rank}: 3 bf16 steps at batch 1, eager (a gloo group\'s '
            f'collectives cannot be captured in a CUDA graph), launches {r["launches"]}, '
            f'on {card}')
    return {name: sum(r['launches'][name] for r in results) for name in results[0]['launches']}


def occupancy(out):
    import torch
    return torch.logical_or(out['segmentation'].argmax(-1), out['pedestrian'].argmax(-1))


def cam_compare(ref, got, model, trajs, commands, target, truth=None) -> dict:
    """Occupancy agreement, the selected candidate and the refined
    trajectory of a camera-parallel call against the one-process one;
    with ``truth`` (the one-process fp32 occupancy) also both calls'
    agreement with it."""
    import torch
    (traj_r, out_r), (traj_g, out_g) = ref, got
    agree = (occupancy(out_r) == occupancy(out_g)).float().mean().item()
    extra = {} if truth is None else {
        'split_vs_fp32': (occupancy(out_g) == truth).float().mean().item(),
        'one_vs_fp32': (occupancy(out_r) == truth).float().mean().item()}
    sel_r = selected(model, serve_plan_args(model, out_r, trajs, commands, target))
    sel_g = selected(model, serve_plan_args(model, out_g, trajs, commands, target))
    finite = all(torch.isfinite(v.float()).all() for v in out_g.values()
                 if isinstance(v, torch.Tensor)) and bool(torch.isfinite(traj_g.float()).all())
    return {'occupancy': agree, 'same_candidate': sel_r == sel_g,
            'traj_err': (traj_g.float() - traj_r.float()).abs().max().item(),
            'finite': finite, **extra}


def cam_inputs(cfg, device, dt):
    """The flagship's forward inputs (image in ``dt``, geometry fp32), the
    planner's, a seeded past-frame BEV cache and the fixed rig (host)."""
    import torch
    (image, k, e, ego), ex = example_inputs(cfg)
    image, = to_torch((image,), device, dt)
    k, e, ego = to_torch((k, e, ego), device)
    trajs, gt, target = to_torch((ex['trajs'], ex['gt_trajs'], ex['target_points']), device, dt)
    commands, = to_torch((ex['commands'],), device)
    mc = model_cfg(cfg)
    cache = torch.from_numpy(np.random.RandomState(SEED + 1).randn(
        1, mc.receptive_field - 1, *mc.bev_size, mc.encoder_out_channels)
        .astype(np.float32)).to(device, dt)
    rig = (k[0, -1].cpu().numpy(), e[0, -1].cpu().numpy())
    return (image, k, e, ego), (trajs, gt, commands, target), cache, rig


def rank_cam(out_dir: str) -> dict:
    """One rank of [cam parallel] (``--rank cam``): the flagship at full
    width, in fp32 (TF32 off) and in bf16 (the serving policy), split
    over 2 and over 3 ranks; rank 0 also runs the one-process port on the
    same inputs, and keeps the fp32 occupancy to hold the bf16 calls to.
    Each rank counts its launches of each call."""
    import torch
    from stp3_tpu_torch.ops.static_splat import build_column_splat_plan
    from stp3_tpu_torch.parallel import mesh, serving
    device = mesh.maybe_initialize_multihost(backend='gloo')
    rank = mesh.process_index(mesh.data_group())
    cfg = flagship_cfg()
    groups = {n: serving.cam_mesh(n) for n in (2, CAM_WORLD)}
    result, truth = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        model = build_model(cfg).to(device=device, dtype=dt)
        (image, k, e, ego), (trajs, gt, commands, target), cache, rig = cam_inputs(
            cfg, device, dt)
        present = (image[:, -1], k[:, -1], e[:, -1])
        numbers = {}
        with torch.inference_mode():
            if rank == 0:
                arrays = build_column_splat_plan(model.frustum, *rig, model.bev_resolution,
                                                 model.bev_start_position,
                                                 model.bev_dimension).device_arrays(device)
                ref = {'plan': plan_step(model, image, k, e, ego, trajs, gt, commands,
                                         target)[::-1],
                       'serve': model.serve_step(*present, ego, cache, trajs, commands,
                                                 target)[:2],
                       'static': model.serve_step_static(image[:, -1], ego, cache, trajs,
                                                         commands, target, arrays)[:2]}
                if dt == torch.float32:
                    truth = {name: occupancy(out) for name, (_, out) in ref.items()}
        k2 = 2 if dt == torch.bfloat16 else 0              # fp32 takes the unfused MLP
        for n_shards, group in groups.items():
            if rank >= n_shards:
                continue
            fwd = serving.make_cam_parallel_forward(model, group)
            step = serving.make_cam_parallel_plan_step(model, group)
            serve = serving.make_cam_parallel_serve_step(model, group)
            static = serving.make_cam_parallel_serve_step_static(model, group, *rig)
            calls = {  # plan: the plan step (for the trajectory), the forward (the heads)
                'plan': (lambda: (step(image, k, e, ego, trajs, gt, commands, target),
                                  fwd(image, k, e, ego)), dict(bev_splat=2, convnext_mlp=2 * k2)),
                'serve': (lambda: serve(*present, ego, cache, trajs, commands, target)[:2],
                          dict(bev_splat=1, convnext_mlp=k2)),
                'static': (lambda: static(image[:, -1], ego, cache, trajs, commands,
                                          target)[:2], dict(convnext_mlp=k2))}
            split = {}
            with torch.inference_mode():
                for name, (call, want) in calls.items():
                    reset_launches()
                    got = call()
                    launches = read_launches()
                    expect_launches(f'[cam parallel] rank {rank} of {n_shards}, {dt}: {name}',
                                    launches, **want)
                    split[name] = {'launches': launches}
                    if rank == 0:
                        split[name].update(cam_compare(
                            ref[name], got, model, trajs, commands, target,
                            truth[name] if dt == torch.bfloat16 else None))
            numbers[str(n_shards)] = split
        result[str(dt).replace('torch.', '')] = numbers
        del model
        free_card()
    mesh.coordination_barrier()
    return result


def cam_shard_ranks(cfg, device, n_shards: int):
    """(F = rf, P) ranks of one rank's cameras (the first N / n_shards of
    the flagship rig), pre-warped as the model splats them."""
    from stp3_tpu_torch.ops.bev_pool import prewarped_ranks
    geometry, ego, (res, start, dim) = rig_geometry(cfg, device)
    nl = geometry.shape[2] // n_shards
    return prewarped_ranks(geometry[:, :, :nl].contiguous(), ego, res, start, dim)


# [cam parallel]'s limits in fp32: the share of occupancy cells that must
# agree with one process and the refined trajectory's largest difference
CAM_OCCUPANCY = 0.9999
CAM_TRAJ_M = 1e-3


def report_cam(results: list, card: str) -> dict:
    """Gate and print [cam parallel]. In fp32 the split sums the same
    partial grids in another order: occupancy agrees with one process on
    99.99% of the cells, the same candidate is selected and the refined
    trajectory is within 1e-3 m. Under bf16 each rank's partial grid is
    rounded to bf16 before the sum, a rounding the one-process step does
    not take, and a random-weight model's logits are near ties in many
    cells: the split's occupancy may disagree with the fp32 one-process
    occupancy on at most twice as many cells as the bf16 one-process step
    does, plus 0.1% of the cells; every output finite; the agreement with
    the bf16 one-process step, the candidate and the trajectory printed."""
    launches = {}
    for dt, numbers in results[0].items():
        for n_shards in ('2', str(CAM_WORLD)):
            for name in ('plan', 'serve', 'static'):
                r = numbers[n_shards][name]
                if dt == 'float32':
                    gate = (f'(limit {CAM_OCCUPANCY}); refined trajectory max |diff| '
                            f'{r["traj_err"]:.3e} m (limit {CAM_TRAJ_M})')
                    bad = (r['occupancy'] < CAM_OCCUPANCY or not r['same_candidate']
                           or r['traj_err'] > CAM_TRAJ_M)
                else:
                    limit = 1 - 2 * (1 - r['one_vs_fp32']) - 1e-3
                    gate = (f'against one bf16 process; with the fp32 one-process occupancy '
                            f'{r["split_vs_fp32"]:.6f} (limit {limit:.6f}; one bf16 process '
                            f'{r["one_vs_fp32"]:.6f}); refined trajectory max |diff| '
                            f'{r["traj_err"]:.3e} m')
                    bad = r['split_vs_fp32'] < limit
                say(f'[cam parallel] {dt}, {n_shards} ranks, {name}: occupancy agreement '
                    f'{r["occupancy"]:.6f} {gate}; same candidate {r["same_candidate"]}; '
                    f'finite {r["finite"]}')
                if bad or not r['finite']:
                    fail(f'[cam parallel] {dt}, {n_shards} ranks, {name}: not the one-process '
                         f'result')
    for n_shards in ('2', str(CAM_WORLD)):
        ranks = [res['bfloat16'][n_shards] for res in results if n_shards in res['bfloat16']]
        say(f'[cam parallel] bf16, {n_shards} ranks: K1 launches per rank (plan step + '
            f'forward, serve_step, serve_step_static) '
            f'{[[r[m]["launches"]["bev_splat"] for m in ("plan", "serve", "static")] for r in ranks]}'
            f', on {card}')
    for res in results:
        for numbers in res.values():
            for split in numbers.values():
                for name in ('plan', 'serve', 'static'):
                    for kname, v in split[name]['launches'].items():
                        launches[kname] = launches.get(kname, 0) + v
    return launches


def rank_main(scenario: str, out_dir: str) -> None:
    """A rank of a multi-rank phase (``--rank dp|cam OUT_DIR``), started by
    ``spawn_ranks`` with torchrun's environment."""
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this script needs an NVIDIA GPU')
    result = {'dp': rank_dp, 'cam': rank_cam}[scenario](out_dir)
    with open(os.path.join(out_dir, f'rank{os.environ["RANK"]}.json'), 'w') as f:
        json.dump(result, f)


def main() -> None:
    import torch
    if sys.argv[1:2] == ['--rank']:
        rank_main(sys.argv[2], sys.argv[3])
        return
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
    phase_image_io(repo, card)

    cfg, train_cfg = flagship_cfg(), planning_cfg()
    b = int(train_cfg.BATCHSIZE)
    stages = {'perception': stage_cfg('perception'),
              'perception_carla': stage_cfg('carla_perception'),
              'prediction_ber': stage_cfg('prediction_ber')}
    # each kernel's numbers at the shapes of each path that launches it
    report = {
        'bev_splat': {'serving': phase_k1(cfg, device, 'serving'),
                      'train': phase_k1(train_cfg, device, 'train', b)},
        'convnext_mlp': {'serving': phase_k2(cfg, device, 'serving'),
                         'train': phase_k2(train_cfg, device, 'train', b)},
        'gather_rows': {'train': phase_k3(train_cfg, device)},
        'lift_splat': {'fused': phase_k4(cfg, device)},
    }
    # the stage train steps' splats (K1) and their backward (K3); K2 at
    # Prediction_Ber's rows (Perception has no future prediction)
    for path, stage in stages.items():
        sb = int(stage.BATCHSIZE)
        report['bev_splat'][path] = phase_k1(stage, device, path, sb)
        report['gather_rows'][path] = phase_k3(stage, device, path)
    report['convnext_mlp']['prediction_ber'] = phase_k2(
        stages['prediction_ber'], device, 'prediction_ber', int(stages['prediction_ber'].BATCHSIZE))
    # the CLI paths: training and its val forwards at the training shapes, the
    # evaluations at batch 1 (K1 at the serving splat of the same rig; K2 at
    # the Prediction stage's own rows)
    # the nuScenes dataset path trains the Planning stage at the training
    # shapes; CARLA's Planning stage at batch 2 splats 4 cameras of 256x256
    carla_cfg = carla_planning_cfg()
    for name in ('bev_splat', 'convnext_mlp', 'gather_rows'):
        report[name]['train_graphs'] = report[name]['train']
        report[name]['train_cli'] = report[name]['train']
        report[name]['nuscenes_data'] = report[name]['train']
        report[name]['remat'] = report[name]['train']
    report['bev_splat']['carla_data'] = phase_k1(carla_cfg, device, 'carla_data', b)
    report['gather_rows']['carla_data'] = phase_k3(carla_cfg, device, 'carla_data')
    report['convnext_mlp']['carla_data'] = phase_k2(carla_cfg, device, 'carla_data', b)
    for name in ('bev_splat', 'convnext_mlp'):
        report[name]['evaluate_planning'] = report[name]['serving']
        report[name]['reference_import'] = report[name]['serving']
    report['bev_splat']['evaluate_prediction'] = report['bev_splat']['serving']
    report['convnext_mlp']['evaluate_prediction'] = phase_k2(
        stage_cfg('prediction'), device, 'evaluate_prediction', 1)
    phase_backward(train_cfg, device)
    per_frame, launches = phase_per_frame(cfg, device)
    launches = {'per_frame': launches}
    for name, numbers in per_frame.items():
        report[name] = {'per_frame': numbers}
    phase_parity(flagship_cfg(tiny=True), device)
    phase_train_parity(planning_cfg(tiny=True), device)
    launches['serving'], _, _ = phase_flagship(cfg, device)
    *_, launches['train'] = phase_train(train_cfg, device, card)
    free_card()
    launches['train_graphs'] = phase_train_graphs(train_cfg, device, card)
    free_card()
    launches['remat'] = phase_remat(train_cfg, device, card)
    free_card()
    launches['fused'], *flagship = phase_fused(cfg, device)
    report['bev_splat']['agent'], per_tick, agent_model, cores = phase_agent(device, card)
    # the compiled serving calls on those models: the kernels in their graphs
    graph_launches = phase_graphs(flagship, agent_model, cores, card)
    launches['graphs'] = {name: sum(n.get(name, 0) for n in graph_launches.values())
                          for name in counters()}
    del flagship, agent_model, cores
    free_card()
    # the agent path: one steady tick of each of its three modes
    launches['agent'] = {name: sum(tick[name] for tick in per_tick.values())
                         for name in counters()}
    for path, tag in (('perception', 'perception'), ('perception_carla', 'perception carla'),
                      ('prediction_ber', 'prediction_ber')):
        want = dict(bev_splat=1, gather_rows=1, convnext_mlp=2 if path == 'prediction_ber' else 0)
        *_, launches[path] = phase_train(stages[path], device, card, tag, **want)
        free_card()
    launches['perception_bn'] = phase_perception_bn(
        stage_cfg('perception', False, {'MODEL': {'NORM': 'bn'}}), device, card)
    free_card()
    launches['bn_frozen'], _, _ = phase_flagship(
        make_cfg(FLAGSHIP, {'MODEL': {'NORM': 'bn_frozen'}}), device, tag='bn_frozen')
    ckpt, launches['train_cli'] = phase_train_cli(device, card, repo)
    launches['evaluate_planning'] = phase_evaluate('evaluate_planning', ckpt, device, card,
                                                   planning_result_keys(train_cfg))
    pred_ckpt = prediction_checkpoint(device, repo)
    launches['evaluate_prediction'] = phase_evaluate(
        'evaluate_prediction', pred_ckpt, device, card,
        ['vehicle_iou', 'vehicle_pq', 'vehicle_sq', 'vehicle_rq'])
    phase_labels_as_prediction(*phase_decode(pred_ckpt, device, card), device, card)
    launches['reference_import'] = phase_reference_import(device, card, repo)
    launches['carla_agent'] = phase_carla_agent(device, card, repo, per_tick)
    launches.update(phase_real_data(repo, device, card))
    # data parallel and camera parallel: K1, K3 and K2 at the training shapes
    # of batch 2 ([dp nccl]) and of batch 1 (each rank of [dp 2 ranks]); K1 at
    # one rank's cameras of the 2-way split and K2 at the serving rows
    for name in ('bev_splat', 'convnext_mlp', 'gather_rows'):
        report[name]['dp_nccl'] = report[name]['train']
    report['bev_splat']['dp_ranks'] = report['bev_splat']['serving']
    report['convnext_mlp']['dp_ranks'] = report['convnext_mlp']['serving']
    report['gather_rows']['dp_ranks'] = phase_k3(make_cfg(PLANNING_STAGE, {'BATCHSIZE': 1}),
                                                 device, 'dp_ranks')
    report['bev_splat']['cam_parallel'] = phase_k1(cfg, device, 'cam_parallel',
                                                   ranks=cam_shard_ranks(cfg, device, 2))
    report['convnext_mlp']['cam_parallel'] = report['convnext_mlp']['serving']
    launches['dp_nccl'] = phase_dp_nccl(train_cfg, device, card)
    launches['dp_ranks'] = report_dp(spawn_ranks('dp', DP_WORLD, repo), card)
    phase_dp_batch_split(device, card)
    launches['cam_parallel'] = report_cam(spawn_ranks('cam', CAM_WORLD, repo), card)
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
        top = {k: paths[main_path][k] for k in ('launches', 'shape', 'max_abs_err')}
        kernels.append(dict(name=name, route=route, source=source, replaces=replaces, **top,
                            main_path=main_path, paths=paths))
    say(json.dumps({'kernels': kernels}))
    say(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                           'kind': torch.cuda.get_device_name(0),
                                           'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
