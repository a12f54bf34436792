"""Config system of stp3_tpu_torch: the port's own copy of stp3_tpu/config.py,
with the same key tree and the same defaults, so one YAML file configures
either package.

A lightweight, dependency-free replacement for the reference's fvcore/yacs
``CfgNode`` tree (reference: stp3/config.py:32-162). The default tree below
mirrors the reference key-for-key so that the reference's YAML configs load
unchanged. Supports:

  * attribute access (``cfg.LIFT.X_BOUND``)
  * YAML config-file merge (``--config-file``)
  * dotted CLI overrides (``KEY.SUBKEY value`` pairs, reference config.py:184-188)
  * dict round-trip (``convert_to_dict`` / ``get_cfg(cfg_dict=...)``) used for
    checkpoint rehydration (reference config.py:173-189)

``import yaml`` happens only inside ``merge_from_file``: nothing else in
the port needs PyYAML, and a machine without it can still build configs
in code.
"""
from __future__ import annotations

import argparse
import ast
import copy
from typing import Any, Dict, List, Optional


class CfgNode(dict):
    """dict with attribute access; nested dicts are auto-wrapped."""

    def __init__(self, init: Optional[Dict[str, Any]] = None):
        super().__init__()
        if init:
            for k, v in init.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = CfgNode(value) if isinstance(value, dict) and not isinstance(value, CfgNode) else value

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def convert_to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in self.items():
            out[k] = v.convert_to_dict() if isinstance(v, CfgNode) else v
        return out

    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        for k, v in other.items():
            if isinstance(v, (dict, CfgNode)) and isinstance(self.get(k), CfgNode):
                self[k].merge_from_other_cfg(CfgNode(dict(v)))
            else:
                if isinstance(v, str) and v[:1] in '([':
                    # yacs-style tuple/list literals in YAML, e.g.
                    # "FINAL_DIM: (256, 256)" (reference configs/carla/*.yml)
                    try:
                        v = ast.literal_eval(v)
                    except (ValueError, SyntaxError):
                        pass
                self[k] = copy.deepcopy(v)

    def merge_from_file(self, path: str) -> None:
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f) or {}
        self.merge_from_other_cfg(CfgNode(data))

    def merge_from_list(self, opts: List[str]) -> None:
        assert len(opts) % 2 == 0, f'Override list must be key/value pairs, got {opts}'
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split('.')
            for p in parts[:-1]:
                node = node[p]
            leaf = parts[-1]
            old = node.get(leaf)
            node[leaf] = _coerce(value, old)


def _coerce(value: str, old: Any) -> Any:
    """Parse a CLI string into the type of the existing default."""
    if isinstance(old, str) or old is None:
        try:
            return ast.literal_eval(value)
        except (ValueError, SyntaxError):
            return value
    if isinstance(old, bool):
        return value.lower() in ('1', 'true', 'yes')
    try:
        parsed = ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value
    if isinstance(old, float) and isinstance(parsed, int):
        return float(parsed)
    return parsed


def _defaults() -> CfgNode:
    """Default tree mirroring reference stp3/config.py:32-162, plus
    the keys the reference lacks (listed in TPU_ONLY_KEYS)."""
    _C = CfgNode()
    _C.LOG_DIR = 'tensorboard_logs'
    _C.TAG = 'default'

    _C.GPUS = [0]  # kept for config-file compatibility
    _C.PRECISION = 16  # 16 => bf16 compute policy; 32 => fp32
    _C.BATCHSIZE = 3
    _C.EPOCHS = 20

    _C.N_WORKERS = 5
    # loader worker kind: 'thread' (zero IPC; GIL-releasing sample work) or
    # 'process' (spawn pool, the reference's DataLoader-workers
    # equivalent). Read by the JAX package's loader.
    _C.WORKER_KIND = 'thread'
    _C.VIS_INTERVAL = 5000
    _C.LOGGING_INTERVAL = 500

    _C.PRETRAINED = CfgNode()
    _C.PRETRAINED.LOAD_WEIGHTS = False
    _C.PRETRAINED.PATH = ''

    _C.DATASET = CfgNode()
    _C.DATASET.DATAROOT = '/data/Nuscenes'
    _C.DATASET.VERSION = 'trainval'
    _C.DATASET.NAME = 'nuscenes'
    _C.DATASET.MAP_FOLDER = '/data/Nuscenes'
    _C.DATASET.IGNORE_INDEX = 255
    _C.DATASET.FILTER_INVISIBLE_VEHICLES = True
    _C.DATASET.SAVE_DIR = 'datas'
    # no reference counterpart: synthetic val-set size override, 0 = the
    # default max(4, n_train // 4)
    _C.DATASET.VAL_SAMPLES = 0

    _C.TIME_RECEPTIVE_FIELD = 3
    _C.N_FUTURE_FRAMES = 4

    _C.IMAGE = CfgNode()
    _C.IMAGE.FINAL_DIM = (224, 480)
    _C.IMAGE.RESIZE_SCALE = 0.3
    _C.IMAGE.TOP_CROP = 46
    _C.IMAGE.ORIGINAL_HEIGHT = 900
    _C.IMAGE.ORIGINAL_WIDTH = 1600
    _C.IMAGE.NAMES = ['CAM_FRONT_LEFT', 'CAM_FRONT', 'CAM_FRONT_RIGHT',
                      'CAM_BACK_LEFT', 'CAM_BACK', 'CAM_BACK_RIGHT']

    _C.LIFT = CfgNode()
    _C.LIFT.X_BOUND = [-50.0, 50.0, 0.5]   # forward
    _C.LIFT.Y_BOUND = [-50.0, 50.0, 0.5]   # sides
    _C.LIFT.Z_BOUND = [-10.0, 10.0, 20.0]  # height
    _C.LIFT.D_BOUND = [2.0, 50.0, 1.0]
    _C.LIFT.GT_DEPTH = False
    _C.LIFT.DISCOUNT = 0.5

    _C.EGO = CfgNode()
    _C.EGO.WIDTH = 1.85
    _C.EGO.HEIGHT = 4.084

    _C.MODEL = CfgNode()
    _C.MODEL.ENCODER = CfgNode()
    _C.MODEL.ENCODER.DOWNSAMPLE = 8
    _C.MODEL.ENCODER.NAME = 'efficientnet-b4'
    _C.MODEL.ENCODER.OUT_CHANNELS = 64
    _C.MODEL.ENCODER.USE_DEPTH_DISTRIBUTION = True

    _C.MODEL.TEMPORAL_MODEL = CfgNode()
    _C.MODEL.TEMPORAL_MODEL.NAME = 'temporal_block'
    _C.MODEL.TEMPORAL_MODEL.START_OUT_CHANNELS = 64
    _C.MODEL.TEMPORAL_MODEL.EXTRA_IN_CHANNELS = 0
    _C.MODEL.TEMPORAL_MODEL.INBETWEEN_LAYERS = 0
    _C.MODEL.TEMPORAL_MODEL.PYRAMID_POOLING = True
    _C.MODEL.TEMPORAL_MODEL.INPUT_EGOPOSE = True

    _C.MODEL.DISTRIBUTION = CfgNode()
    _C.MODEL.DISTRIBUTION.LATENT_DIM = 32
    _C.MODEL.DISTRIBUTION.MIN_LOG_SIGMA = -5.0
    _C.MODEL.DISTRIBUTION.MAX_LOG_SIGMA = 5.0

    _C.MODEL.FUTURE_PRED = CfgNode()
    _C.MODEL.FUTURE_PRED.N_GRU_BLOCKS = 2
    _C.MODEL.FUTURE_PRED.N_RES_LAYERS = 1
    _C.MODEL.FUTURE_PRED.MIXTURE = True

    _C.MODEL.DECODER = CfgNode()
    _C.MODEL.BN_MOMENTUM = 0.1
    # normalisation: the reference uses (sync) BatchNorm everywhere
    # (train.py:45 sync_batchnorm=True); both packages default to
    # GroupNorm, which needs no cross-replica traffic and no running state
    _C.MODEL.NORM = 'gn'
    _C.MODEL.GN_GROUPS = 8

    _C.SEMANTIC_SEG = CfgNode()
    _C.SEMANTIC_SEG.VEHICLE = CfgNode()
    _C.SEMANTIC_SEG.VEHICLE.WEIGHTS = [1.0, 2.0]
    _C.SEMANTIC_SEG.VEHICLE.USE_TOP_K = True
    _C.SEMANTIC_SEG.VEHICLE.TOP_K_RATIO = 0.25

    _C.SEMANTIC_SEG.PEDESTRIAN = CfgNode()
    _C.SEMANTIC_SEG.PEDESTRIAN.ENABLED = True
    _C.SEMANTIC_SEG.PEDESTRIAN.WEIGHTS = [1.0, 10.0]
    _C.SEMANTIC_SEG.PEDESTRIAN.USE_TOP_K = True
    _C.SEMANTIC_SEG.PEDESTRIAN.TOP_K_RATIO = 0.25

    _C.SEMANTIC_SEG.HDMAP = CfgNode()
    _C.SEMANTIC_SEG.HDMAP.ENABLED = True
    _C.SEMANTIC_SEG.HDMAP.ELEMENTS = ['lane_divider', 'drivable_area']
    _C.SEMANTIC_SEG.HDMAP.WEIGHTS = [[1.0, 5.0], [1.0, 1.0]]
    _C.SEMANTIC_SEG.HDMAP.TRAIN_WEIGHT = [1, 1]
    _C.SEMANTIC_SEG.HDMAP.USE_TOP_K = [True, False]
    _C.SEMANTIC_SEG.HDMAP.TOP_K_RATIO = [0.25, 0.25]

    _C.INSTANCE_SEG = CfgNode()
    _C.INSTANCE_SEG.ENABLED = True

    _C.INSTANCE_FLOW = CfgNode()
    _C.INSTANCE_FLOW.ENABLED = True

    _C.PROBABILISTIC = CfgNode()
    _C.PROBABILISTIC.ENABLED = True
    _C.PROBABILISTIC.METHOD = 'GAUSSIAN'  # [BERNOULLI, GAUSSIAN, MIXGAUSSIAN]

    _C.PLANNING = CfgNode()
    _C.PLANNING.ENABLED = True
    _C.PLANNING.GRU_STATE_SIZE = 256
    _C.PLANNING.SAMPLE_NUM = 600
    _C.PLANNING.COMMAND = ['LEFT', 'FORWARD', 'RIGHT']
    # Reproduce the reference's hardcoded cam_front_index=1 (reference
    # stp3.py:203) instead of resolving the front camera by name. For
    # nuScenes the two agree (CAM_FRONT is at index 1); for CARLA's rig
    # order (front,left,right,rear) index 1 is the LEFT camera — a
    # reference bug, but a checkpoint TRAINED with it expects the planner
    # to consume that camera's feature, so imported reference CARLA
    # checkpoints must run with this True (the torch importer auto-sets
    # it; see PARITY.md "cam_front selection").
    _C.PLANNING.CAM_FRONT_PARITY = False

    _C.FUTURE_DISCOUNT = 0.95

    _C.OPTIMIZER = CfgNode()
    _C.OPTIMIZER.LR = 3e-4
    _C.OPTIMIZER.WEIGHT_DECAY = 1e-7
    _C.GRAD_NORM_CLIP = 5

    _C.COST_FUNCTION = CfgNode()
    _C.COST_FUNCTION.SAFETY = 0.1
    _C.COST_FUNCTION.LAMBDA = 1.0
    _C.COST_FUNCTION.HEADWAY = 1.0
    _C.COST_FUNCTION.LRDIVIDER = 10.0
    _C.COST_FUNCTION.COMFORT = 0.1
    _C.COST_FUNCTION.PROGRESS = 0.5
    _C.COST_FUNCTION.VOLUME = 100.0

    # ------------------------------------------- keys the reference lacks
    _C.PARALLEL = CfgNode()
    _C.PARALLEL.DP = -1            # data-parallel size; -1 => all devices
    _C.PARALLEL.MESH_AXES = ['data']
    _C.PARALLEL.MULTIHOST = False  # multi-host start-up

    _C.CHECKPOINT = CfgNode()
    _C.CHECKPOINT.DIR = 'checkpoints'
    _C.CHECKPOINT.SAVE_EVERY_EPOCH = True
    _C.CHECKPOINT.KEEP = -1        # save_top_k=-1 equivalent (keep all)
    _C.CHECKPOINT.RESUME = ''

    _C.DEBUG = CfgNode()
    _C.DEBUG.NAN_CHECK = False     # stop at the first NaN
    _C.PROFILE = CfgNode()
    _C.PROFILE.ENABLED = False     # profiler trace of the first steps
    _C.PROFILE.DIR = ''            # default: <run_dir>/profile
    _C.PROFILE.STEPS = 5

    # activation rematerialisation: trade FLOPs for HBM at train time.
    # 'none', or '+'-joined stage tags from {encoder, temporal, future,
    # decoder, cells}; 'cells' checkpoints each GRU cell (step-local
    # recompute) instead of the whole future stage.
    _C.MODEL.REMAT = 'none'

    return _C


# Config keys with NO reference counterpart (added by stp3_tpu; the name is
# the JAX package's). The reference rehydrates checkpoints via fvcore/yacs
# merge_from_other_cfg (reference config.py:173-189), which raises on any
# unknown key, so a cfg dict handed back to the reference must strip these
# first.
TPU_ONLY_KEYS = (
    'CHECKPOINT.DIR', 'CHECKPOINT.KEEP', 'CHECKPOINT.RESUME',
    'CHECKPOINT.SAVE_EVERY_EPOCH',
    'DATASET.VAL_SAMPLES',
    'DEBUG.NAN_CHECK',
    'MODEL.GN_GROUPS', 'MODEL.NORM', 'MODEL.REMAT',
    'PARALLEL.DP', 'PARALLEL.MESH_AXES', 'PARALLEL.MULTIHOST',
    'PLANNING.CAM_FRONT_PARITY',
    'PROFILE.DIR', 'PROFILE.ENABLED', 'PROFILE.STEPS',
    'WORKER_KIND',
)


def strip_tpu_only_keys(cfg_dict: Dict[str, Any]) -> Dict[str, Any]:
    """A deep copy of ``cfg_dict`` with every TPU_ONLY_KEYS path removed
    and emptied parent groups pruned — a reference-schema-compatible
    hyper_parameters dict."""
    out = copy.deepcopy(dict(cfg_dict))
    for dotted in TPU_ONLY_KEYS:
        parts = dotted.split('.')
        node = out
        for p in parts[:-1]:
            node = node.get(p)
            if not isinstance(node, dict):
                break
        else:
            node.pop(parts[-1], None)
    def prune(d):
        for k in [k for k, v in d.items() if isinstance(v, dict)]:
            prune(d[k])
            if not d[k]:
                del d[k]
    prune(out)
    return out


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description='stp3_tpu_torch training')
    parser.add_argument('--config-file', default='', metavar='FILE', help='path to config file')
    parser.add_argument('opts', help='dotted-key overrides', default=None, nargs=argparse.REMAINDER)
    return parser


def get_cfg(args=None, cfg_dict: Optional[Dict[str, Any]] = None) -> CfgNode:
    """Defaults -> cfg_dict -> --config-file YAML -> CLI dotted overrides.

    Same precedence as the reference (config.py:173-189), including the
    float coercion of COST_FUNCTION values when rehydrating from a dict.
    """
    cfg = _defaults()
    if cfg_dict is not None:
        tmp = CfgNode(cfg_dict)
        if 'COST_FUNCTION' in tmp:
            for k in list(tmp.COST_FUNCTION.keys()):
                tmp.COST_FUNCTION[k] = float(tmp.COST_FUNCTION[k])
        cfg.merge_from_other_cfg(tmp)
    if args is not None:
        if getattr(args, 'config_file', ''):
            cfg.merge_from_file(args.config_file)
        if getattr(args, 'opts', None):
            cfg.merge_from_list(args.opts)
    return cfg
