"""The port's configurations as code and the seeded inputs built from them,
for the CPU tests, their helper modules, the on-card check (chip_smoke.py)
and the scripts under scripts/. Nothing here times anything or needs a
card, and nothing imports jax, stp3_tpu, PIL, cv2 or PyYAML: the card's
machine has none of them (the configurations are code, not YAML). The
port is imported inside the functions that use it.
"""
from __future__ import annotations

import dataclasses
import os

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
# the tiny model of the parity checks: b0, 2 cameras at 32x64, 16x16 BEV
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


# stp3_tpu/configs/nuscenes/Perception.yml, as code: stage 1 (no future
# prediction, no present distribution, no planner)
PERCEPTION_STAGE = {
    'TAG': 'Perception', 'BATCHSIZE': 3, 'PRECISION': 16, 'EPOCHS': 20, 'N_WORKERS': 8,
    'DATASET': {'VERSION': 'trainval'}, 'TIME_RECEPTIVE_FIELD': 3, 'N_FUTURE_FRAMES': 0,
    'LIFT': {'GT_DEPTH': False},
    'MODEL': {'REMAT': 'encoder', 'BN_MOMENTUM': 0.05,
              'ENCODER': {'NAME': 'efficientnet-b4', 'USE_DEPTH_DISTRIBUTION': True},
              'TEMPORAL_MODEL': {'NAME': 'temporal_block', 'INPUT_EGOPOSE': True}},
    'SEMANTIC_SEG': {'PEDESTRIAN': {'ENABLED': True}, 'HDMAP': {'ENABLED': True}},
    'INSTANCE_SEG': {'ENABLED': False}, 'INSTANCE_FLOW': {'ENABLED': False},
    'PROBABILISTIC': {'ENABLED': False}, 'PLANNING': {'ENABLED': False},
    'OPTIMIZER': {'LR': 1e-3},
}
# stp3_tpu/configs/carla/Perception.yml, as code: 4 cameras at 256x256,
# a +-20 m BEV grid at 0.2 m
CARLA_PERCEPTION = {
    **PERCEPTION_STAGE, 'TAG': 'CARLA_perception', 'BATCHSIZE': 6, 'DATASET': {'NAME': 'carla'},
    'IMAGE': {'FINAL_DIM': (256, 256), 'NAMES': ['front', 'left', 'right', 'rear'],
              'ORIGINAL_HEIGHT': 300, 'ORIGINAL_WIDTH': 400},
    'LIFT': {'X_BOUND': [-20.0, 20.0, 0.2], 'Y_BOUND': [-20.0, 20.0, 0.2], 'GT_DEPTH': False},
}
# stp3_tpu/configs/nuscenes/Prediction_Ber.yml, as code: stage 2 with a
# Bernoulli spatial latent
PREDICTION_BER = {
    'TAG': 'Prediction_Ber', 'BATCHSIZE': 2, 'PRECISION': 16, 'EPOCHS': 20, 'N_WORKERS': 8,
    'DATASET': {'VERSION': 'trainval'}, 'TIME_RECEPTIVE_FIELD': 3, 'N_FUTURE_FRAMES': 4,
    'LIFT': {'GT_DEPTH': False},
    'MODEL': {'REMAT': 'encoder', 'BN_MOMENTUM': 0.05,
              'ENCODER': {'NAME': 'efficientnet-b4', 'USE_DEPTH_DISTRIBUTION': True},
              'TEMPORAL_MODEL': {'NAME': 'temporal_block', 'INPUT_EGOPOSE': True}},
    'SEMANTIC_SEG': {'PEDESTRIAN': {'ENABLED': False}, 'HDMAP': {'ENABLED': False}},
    'INSTANCE_FLOW': {'ENABLED': True},
    'PROBABILISTIC': {'ENABLED': True, 'METHOD': 'BERNOULLI'},
    'PLANNING': {'ENABLED': False}, 'FUTURE_DISCOUNT': 0.95, 'OPTIMIZER': {'LR': 2e-4},
    'PRETRAINED': {'LOAD_WEIGHTS': True},
}
# stp3_tpu/configs/nuscenes/Prediction.yml, as code: stage 2 (GAUSSIAN latent,
# instance and flow heads, no planner)
PREDICTION_STAGE = {**PREDICTION_BER, 'TAG': 'Prediction',
                    'PROBABILISTIC': {'ENABLED': True, 'METHOD': 'GAUSSIAN'}}
# the synthetic data of the train / evaluate CLI paths: 10 training samples
# (5 steps at batch 2) and 4 validation samples, one epoch a run
CLI_DATA = {'DATASET': {'NAME': 'synthetic', 'VERSION': 'mini', 'VAL_SAMPLES': 4},
            'EPOCHS': 1, 'LOGGING_INTERVAL': 1}
# the tiny widths over a stage's own depth (its receptive field, future
# frames and switches), fp32
TINY_WIDTHS = {k: v for k, v in TINY.items()
               if k not in ('TIME_RECEPTIVE_FIELD', 'N_FUTURE_FRAMES')}
STAGES = {'perception': PERCEPTION_STAGE, 'carla_perception': CARLA_PERCEPTION,
          'prediction_ber': PREDICTION_BER, 'prediction': PREDICTION_STAGE}
# the real-data paths: nuScenes' Planning stage with the depth label, and
# CARLA's, each over its PIL-free stand-in tree (tests/torch_fake_datasets.py)
NUSCENES_DATA = {'DATASET': {'NAME': 'nuscenes', 'VERSION': 'mini'},
                 'LIFT': {'GT_DEPTH': True}, 'WORKER_KIND': 'process'}
CARLA_DATA = {'DATASET': {'NAME': 'carla'}, 'WORKER_KIND': 'process'}


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


def stage_cfg(stage: str, tiny: bool = False, *overrides):
    """The training config of a stage of ``STAGES``, then ``overrides``;
    ``tiny``: at TINY's widths in fp32 (CARLA's four cameras kept, at
    32x32)."""
    if not tiny:
        return make_cfg(STAGES[stage], *overrides)
    cams = ({'IMAGE': {'FINAL_DIM': (32, 32), 'NAMES': CARLA_PERCEPTION['IMAGE']['NAMES']}}
            if stage == 'carla_perception' else {})
    return make_cfg(STAGES[stage], TINY_WIDTHS, cams, {'PRECISION': 32}, *overrides)


def model_cfg(cfg):
    from stp3_tpu_torch.models.stp3 import STP3Config
    return STP3Config.from_cfg(cfg)


def planning_result_keys(cfg) -> list:
    keys = ['vehicle_iou', 'pedestrian_iou'] + [
        f'{e}_iou' for e in cfg.SEMANTIC_SEG.HDMAP.ELEMENTS]
    return keys + [f'plan_{m}_{s + 1}s' for m in ('L2', 'obj_col', 'obj_box_col')
                   for s in range(cfg.N_FUTURE_FRAMES // 2)]


# ------------------------------------------------------------ inputs
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


def to_torch(arrays, device, dtype=None):
    import torch
    return [torch.as_tensor(a, device=device) if dtype is None or not np.issubdtype(
        a.dtype, np.floating) else torch.as_tensor(a, device=device).to(dtype) for a in arrays]


def synthetic_batches(cfg, n_batches: int, device):
    """``n_batches`` batches of cfg.BATCHSIZE synthetic samples, on the device."""
    from stp3_tpu_torch.datas.synthetic import SyntheticDataset, collate
    from stp3_tpu_torch.training.trainer import batch_to_device
    b = int(cfg.BATCHSIZE)
    ds = SyntheticDataset(cfg, n_samples=b * n_batches, seed=SEED)
    return [batch_to_device(collate([ds[j] for j in range(i * b, (i + 1) * b)]), device)
            for i in range(n_batches)]


# ------------------------------------------------------- the splat's rig
def rig_geometry(cfg, device, b: int = 1, carla: bool = False):
    """(geometry (B, rf, N, D, Hf, Wf, 3), ego (B, rf, 6), (res, start,
    dim)) of the example rig and ego-motion, or of the fixed CARLA rig at
    zero ego-motion."""
    import torch
    from stp3_tpu_torch.datas.carla_data import carla_cam_rig
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


# ------------------------------------------------------------ the model
def build_model(cfg, fused: bool = False):
    import torch
    from stp3_tpu_torch.layers.base import init_parameters
    from stp3_tpu_torch.models.stp3 import STP3
    model = STP3(dataclasses.replace(model_cfg(cfg), fused_lift_splat=fused))
    init_parameters(model, torch.Generator().manual_seed(SEED))
    return model.eval()


def plan_step(model, image, k, e, ego, trajs, gt, commands, target):
    """bench.py's step: forward, occupancy, plan."""
    import torch
    rf = model.cfg.receptive_field
    out = model(image, k, e, ego)
    seg = out['segmentation'].argmax(-1)
    ped = out['pedestrian'].argmax(-1)
    occupancy = torch.logical_or(seg, ped).float()
    _, traj = model.plan(out['cam_front'], trajs, gt, out['costvolume'][:, rf:],
                         occupancy[:, rf:], out['hdmap'], commands, target)
    return out, traj


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


def running_stats(model) -> dict:
    """{name: copy} of every 'bn' site's running statistics."""
    from stp3_tpu_torch.layers.base import batch_norms
    return {f'{i}.{stat}': getattr(m, stat).detach().clone()
            for i, m in enumerate(batch_norms(model)) for stat in ('mean', 'var')}


# ------------------------------------------- reference-format checkpoints
def reference_state_dict(mcfg, seed: int = SEED) -> dict:
    """A reference-format state_dict of ``mcfg`` (a models.stp3.STP3Config)
    from ``seed``: the port's ``synthesize_state_dict``, then every BN
    running variance drawn from [0.5, 1.5] and every other vector or scalar
    the init leaves constant (biases, BN scales, running means, layer
    scales, the GRU biases, the uncertainty weights) moved off its constant,
    so that a swapped mean and variance, a transposed kernel or a bias in
    the wrong place changes the outputs."""
    from stp3_tpu_torch.utils import torch_import as ti
    sd = ti.synthesize_state_dict(mcfg, seed)
    rng = np.random.RandomState(seed)
    for key, value in sd.items():
        if key.endswith('.running_var'):
            sd[key] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
        elif value.ndim <= 1 and np.all(value == value.flat[0]):
            sd[key] = (value + 0.1 * rng.randn(*value.shape)).astype(np.float32)
    return sd


def grid_constants(mcfg) -> dict:
    """The grid buffers a reference checkpoint carries (``model.frustum``,
    ``model.bev_*``), from the port's geometry."""
    from stp3_tpu_torch.ops.geometry import calculate_birds_eye_view_parameters, create_frustum
    res, start, dim = calculate_birds_eye_view_parameters(mcfg.x_bound, mcfg.y_bound,
                                                          mcfg.z_bound)
    return {'model.bev_resolution': res, 'model.bev_start_position': start,
            'model.bev_dimension': dim,
            'model.frustum': create_frustum(mcfg.final_dim, mcfg.encoder_downsample,
                                            mcfg.d_bound).astype(np.float32)}


def write_reference_checkpoint(cfg, path: str, seed: int = SEED):
    """Write a Lightning-style .ckpt of ``cfg`` to ``path``: {'state_dict':
    {'model.*': tensor}, 'hyper_parameters': the config as a plain dict,
    ...}, with the bookkeeping entries a reference file carries
    (``num_batches_tracked`` beside every BN, ``model.frustum``,
    ``model.bev_*``). Returns (the model's state_dict as numpy, the
    bookkeeping keys)."""
    import torch
    from stp3_tpu_torch.models.stp3 import STP3Config
    mcfg = STP3Config.from_cfg(cfg)
    sd = reference_state_dict(mcfg, seed)
    extra = grid_constants(mcfg)
    extra.update({k[:-len('running_mean')] + 'num_batches_tracked': np.asarray(7, np.int64)
                  for k in sd if k.endswith('.running_mean')})
    state_dict = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in {**sd, **extra}.items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({'state_dict': state_dict, 'hyper_parameters': cfg.convert_to_dict(),
                'epoch': 19, 'global_step': 1000}, path)
    return sd, sorted(extra)


def gru_fold(sd: dict, key: str):
    """The planner GRU's (bias_ih, bias_hh) as export writes them after an
    import: the r / z parts of bias_hh folded into bias_ih, zeros left."""
    bih, bhh = sd[f'{key}.bias_ih'], sd[f'{key}.bias_hh']
    h = bhh.shape[0] // 3
    return (np.concatenate([bih[:2 * h] + bhh[:2 * h], bih[2 * h:]]),
            np.concatenate([np.zeros(2 * h, np.float32), bhh[2 * h:]]))


def check_export(sd: dict, bookkeeping, exported: dict, cfg) -> int:
    """Raise AssertionError unless ``exported`` (the state_dict of an
    exported .ckpt) holds every tensor of ``sd`` bit for bit, the planner
    GRU's biases as their fold, and the bookkeeping entries rebuilt.
    Returns the tensors checked."""
    import torch
    from stp3_tpu_torch.models.stp3 import STP3Config
    if sorted(exported) != sorted(set(sd) | set(bookkeeping)):
        raise AssertionError(
            f'export: keys differ: {sorted(set(exported) ^ set(sd) ^ set(bookkeeping))[:6]}')
    want = dict(sd)
    gru = 'model.planning.GRU'
    if f'{gru}.bias_ih' in sd:
        want[f'{gru}.bias_ih'], want[f'{gru}.bias_hh'] = gru_fold(sd, gru)
    want.update(grid_constants(STP3Config.from_cfg(cfg)))
    want.update({k: np.zeros((), np.int64) for k in bookkeeping if 'num_batches_tracked' in k})
    bad = [k for k, v in want.items()
           if not torch.equal(exported[k], torch.from_numpy(np.ascontiguousarray(v)))]
    if bad:
        raise AssertionError(f'export: {len(bad)} tensors do not come back bit for bit, '
                             f'e.g. {bad[:4]}')
    return len(want)


# ------------------------------------------------------- the CARLA agent
CAMS = ('rgb', 'rgb_left', 'rgb_right', 'rgb_rear')
# the harness's route: north along the ticks' gps, then a turn
AGENT_ROUTE = [({'lat': 0.0, 'lon': 0.0}, 4), ({'lat': 2e-4, 'lon': 0.0}, 4),
               ({'lat': 6e-4, 'lon': 1e-4}, 1)]


def recorded_ticks(n: int):
    """n seeded CARLA sensor ticks: uint8 300x400 frames of the four
    cameras, the GPS 2 m further each tick, heading 0."""
    rng = np.random.RandomState(SEED)
    for t in range(n):
        yield ({key: rng.randint(0, 256, (300, 400, 3), np.uint8) for key in CAMS},
               np.array([2.0 * t, 0.0]), 0.0)


def bgra_tick(t: int, frame: dict, theta: float) -> dict:
    """One leaderboard sensor tick of a recorded frame: 300x400 BGRA
    cameras, gps (lat, lon, alt) 2 m further north each tick, speed 3 m/s,
    the compass last in the imu."""
    from stp3_tpu_torch.deploy.control import RoutePlanner
    data = {key: (t, np.concatenate([img[..., ::-1], np.full(img.shape[:2] + (1,), 255,
                                                             np.uint8)], -1))
            for key, img in frame.items()}
    data['gps'] = (t, np.array([2.0 * t / RoutePlanner.SCALE[0], 0.0, 0.0]))
    data['speed'] = (t, {'speed': 3.0})
    data['imu'] = (t, np.array([0.0] * 6 + [theta]))
    return data


# ------------------------------------------------------------- the build
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
