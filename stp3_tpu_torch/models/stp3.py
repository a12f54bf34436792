"""STP3: perceive -> predict -> plan (port of stp3_tpu/models/stp3.py,
the materialised-lift path, for serving and training).

``forward(image, intrinsics, extrinsics, future_egomotion)`` returns the
JAX model's output dict (channels-last); ``plan(...)`` runs the planner.
Geometry stays fp32 under any parameter dtype.

Training (``train=True``) draws every random number from the caller's
``torch.Generator``: the EfficientNet drop-connect masks, the four
DeepLabHeads' dropout masks and the GAUSSIAN latent noise.
``MODEL.REMAT='encoder'`` recomputes the encoder's activations in the
backward (``torch.utils.checkpoint``), replaying the same masks.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from stp3_tpu_torch.layers.base import to_first, to_last
from stp3_tpu_torch.models.cost import CostConfig
from stp3_tpu_torch.models.decoder import Decoder
from stp3_tpu_torch.models.distributions import DistributionModule
from stp3_tpu_torch.models.encoder import Encoder
from stp3_tpu_torch.models.future_prediction import FuturePrediction
from stp3_tpu_torch.models.planning_model import Planning
from stp3_tpu_torch.models.temporal_model import TemporalModel
from stp3_tpu_torch.ops.bev_pool import project_to_birds_eye_view
from stp3_tpu_torch.ops.geometry import (calculate_birds_eye_view_parameters,
                                         create_frustum, get_geometry)
from stp3_tpu_torch.utils.precision import pin_fp32_math


def _cam_front_index(names) -> int:
    lowered = [str(n).lower() for n in names]
    for i, n in enumerate(lowered):
        if n in ('cam_front', 'front'):
            return i
    return 1 if len(names) > 1 else 0


@dataclasses.dataclass(frozen=True)
class STP3Config:
    """The subset of the config tree the model reads (the JAX package's
    STP3Config, plus ``norm``: this package keeps the norm kind in the
    config instead of a process-wide default)."""
    x_bound: Tuple[float, float, float] = (-50.0, 50.0, 0.5)
    y_bound: Tuple[float, float, float] = (-50.0, 50.0, 0.5)
    z_bound: Tuple[float, float, float] = (-10.0, 10.0, 20.0)
    d_bound: Tuple[float, float, float] = (2.0, 50.0, 1.0)
    final_dim: Tuple[int, int] = (224, 480)
    discount: float = 0.5
    use_depth_distribution: bool = True
    encoder_name: str = 'efficientnet-b4'
    encoder_downsample: int = 8
    encoder_out_channels: int = 64
    receptive_field: int = 3
    n_future: int = 4
    temporal_name: str = 'temporal_block'
    start_out_channels: int = 64
    extra_in_channels: int = 0
    inbetween_layers: int = 0
    pyramid_pooling: bool = True
    input_egopose: bool = True
    probabilistic: bool = True
    prob_method: str = 'GAUSSIAN'
    latent_dim: int = 32
    min_log_sigma: float = -5.0
    max_log_sigma: float = 5.0
    n_gru_blocks: int = 2
    n_res_layers: int = 1
    mixture: bool = True
    n_classes: int = 2
    n_hdmap: int = 2
    predict_pedestrian: bool = True
    perceive_hdmap: bool = True
    predict_instance: bool = True
    predict_future_flow: bool = True
    planning_enabled: bool = True
    sample_num: int = 600
    gru_state_size: int = 256
    cost: CostConfig = dataclasses.field(
        default_factory=lambda: CostConfig(
            x_bound=(-50.0, 50.0, 0.5), y_bound=(-50.0, 50.0, 0.5),
            z_bound=(-10.0, 10.0, 20.0), ego_width=1.85, ego_height=4.084,
            n_future=4, safety=0.1, lambda_=1.0, headway=1.0, lrdivider=10.0,
            comfort=0.1, progress=0.5, volume=100.0))
    gt_depth: bool = False
    cam_front_index: int = 1
    norm: str = 'gn'
    remat: str = 'none'

    @classmethod
    def from_cfg(cls, cfg) -> "STP3Config":
        return cls(
            x_bound=tuple(cfg.LIFT.X_BOUND), y_bound=tuple(cfg.LIFT.Y_BOUND),
            z_bound=tuple(cfg.LIFT.Z_BOUND), d_bound=tuple(cfg.LIFT.D_BOUND),
            final_dim=tuple(cfg.IMAGE.FINAL_DIM), discount=cfg.LIFT.DISCOUNT,
            use_depth_distribution=cfg.MODEL.ENCODER.USE_DEPTH_DISTRIBUTION,
            encoder_name=cfg.MODEL.ENCODER.NAME,
            encoder_downsample=cfg.MODEL.ENCODER.DOWNSAMPLE,
            encoder_out_channels=cfg.MODEL.ENCODER.OUT_CHANNELS,
            receptive_field=cfg.TIME_RECEPTIVE_FIELD,
            n_future=cfg.N_FUTURE_FRAMES,
            temporal_name=cfg.MODEL.TEMPORAL_MODEL.NAME,
            start_out_channels=cfg.MODEL.TEMPORAL_MODEL.START_OUT_CHANNELS,
            extra_in_channels=cfg.MODEL.TEMPORAL_MODEL.EXTRA_IN_CHANNELS,
            inbetween_layers=cfg.MODEL.TEMPORAL_MODEL.INBETWEEN_LAYERS,
            pyramid_pooling=cfg.MODEL.TEMPORAL_MODEL.PYRAMID_POOLING,
            input_egopose=cfg.MODEL.TEMPORAL_MODEL.INPUT_EGOPOSE,
            probabilistic=cfg.PROBABILISTIC.ENABLED,
            prob_method=cfg.PROBABILISTIC.METHOD,
            latent_dim=cfg.MODEL.DISTRIBUTION.LATENT_DIM,
            min_log_sigma=cfg.MODEL.DISTRIBUTION.MIN_LOG_SIGMA,
            max_log_sigma=cfg.MODEL.DISTRIBUTION.MAX_LOG_SIGMA,
            n_gru_blocks=cfg.MODEL.FUTURE_PRED.N_GRU_BLOCKS,
            n_res_layers=cfg.MODEL.FUTURE_PRED.N_RES_LAYERS,
            mixture=cfg.MODEL.FUTURE_PRED.MIXTURE,
            n_classes=len(cfg.SEMANTIC_SEG.VEHICLE.WEIGHTS),
            n_hdmap=len(cfg.SEMANTIC_SEG.HDMAP.ELEMENTS),
            predict_pedestrian=cfg.SEMANTIC_SEG.PEDESTRIAN.ENABLED,
            perceive_hdmap=cfg.SEMANTIC_SEG.HDMAP.ENABLED,
            predict_instance=cfg.INSTANCE_SEG.ENABLED,
            predict_future_flow=cfg.INSTANCE_FLOW.ENABLED,
            planning_enabled=cfg.PLANNING.ENABLED,
            sample_num=cfg.PLANNING.SAMPLE_NUM,
            gru_state_size=cfg.PLANNING.GRU_STATE_SIZE,
            cost=CostConfig.from_cfg(cfg),
            gt_depth=cfg.LIFT.GT_DEPTH,
            cam_front_index=(1 if cfg.PLANNING.get('CAM_FRONT_PARITY', False)
                             else _cam_front_index(cfg.IMAGE.NAMES)),
            norm=cfg.MODEL.get('NORM', 'gn'),
            remat=cfg.MODEL.get('REMAT', 'none'),
        )

    @property
    def depth_channels(self) -> int:
        return int((self.d_bound[1] - self.d_bound[0]) / self.d_bound[2])

    @property
    def bev_size(self) -> Tuple[int, int]:
        _, _, dim = calculate_birds_eye_view_parameters(
            list(self.x_bound), list(self.y_bound), list(self.z_bound))
        return int(dim[0]), int(dim[1])

    @property
    def temporal_in_channels(self) -> int:
        return self.encoder_out_channels + (6 if self.input_egopose else 0)

    @property
    def future_pred_in_channels(self) -> int:
        return TemporalModel.out_channels(self.start_out_channels, self.receptive_field,
                                          self.extra_in_channels)


def lift_depth_context(feat: torch.Tensor, depth_logits: torch.Tensor) -> torch.Tensor:
    """LSS lift: depth softmax (x) context. feat (..., Hf, Wf, C), depth
    logits (..., Hf, Wf, D) -> (..., D, Hf, Wf, C)."""
    depth_prob = torch.softmax(depth_logits, -1)
    return depth_prob.movedim(-1, -3)[..., None] * feat[..., None, :, :, :]


def _check_supported(c: STP3Config) -> None:
    """This package ports the flagship serving slice; refuse the rest."""
    unsupported = {
        'MODEL.TEMPORAL_MODEL.NAME': (c.temporal_name, 'temporal_block'),
        'PROBABILISTIC.ENABLED': (c.probabilistic, True),
        'PROBABILISTIC.METHOD': (c.prob_method, 'GAUSSIAN'),
        'MODEL.ENCODER.USE_DEPTH_DISTRIBUTION': (c.use_depth_distribution, True),
        'LIFT.GT_DEPTH': (c.gt_depth, False),
    }
    for key, (have, want) in unsupported.items():
        if have != want:
            raise NotImplementedError(f'{key}={have!r} is not ported yet (only {want!r})')
    if c.n_future <= 0 or c.receptive_field < 2:
        raise NotImplementedError('only N_FUTURE_FRAMES > 0 and '
                                  'TIME_RECEPTIVE_FIELD >= 2 are ported')
    if c.remat not in ('none', 'encoder'):
        raise NotImplementedError(f"MODEL.REMAT={c.remat!r} is not ported yet (only 'none' "
                                  "and 'encoder'; the other stages are on ROADMAP.md queue 1)")


class STP3(nn.Module):
    """The end-to-end model. Constructing it pins fp32 math on CUDA
    (``torch.backends.cuda.matmul.allow_tf32 = False`` and
    ``torch.backends.cudnn.allow_tf32 = False``): fp32 here means fp32, as
    the JAX package's ``precision='highest'`` does. The bf16 policy is
    unaffected."""

    def __init__(self, cfg: STP3Config):
        super().__init__()
        _check_supported(cfg)
        pin_fp32_math()
        c = self.cfg = cfg
        self.bev_resolution, self.bev_start_position, self.bev_dimension = (
            calculate_birds_eye_view_parameters(list(c.x_bound), list(c.y_bound),
                                                list(c.z_bound)))
        self.frustum = create_frustum(c.final_dim, c.encoder_downsample, c.d_bound)
        self._frustum_on: Dict[torch.device, torch.Tensor] = {}
        norm = c.norm
        self.encoder = Encoder(c.encoder_out_channels, c.depth_channels, c.encoder_name,
                               c.encoder_downsample, norm)
        self.temporal_model = TemporalModel(
            c.temporal_in_channels, c.receptive_field, c.bev_size, c.start_out_channels,
            c.extra_in_channels, c.inbetween_layers, c.pyramid_pooling, norm)
        cf = c.future_pred_in_channels
        self.present_distribution = DistributionModule(cf, c.latent_dim, c.prob_method, norm)
        self.future_prediction = FuturePrediction(cf, c.latent_dim, c.n_future, c.mixture,
                                                  c.n_gru_blocks, c.n_res_layers, norm)
        self.decoder = Decoder(cf, c.n_classes, c.receptive_field, c.n_hdmap,
                               c.predict_pedestrian, c.perceive_hdmap, c.predict_instance,
                               c.predict_future_flow, c.planning_enabled, norm)
        if c.planning_enabled:
            self.planner = Planning(c.cost, c.sample_num, c.encoder_out_channels,
                                    c.gru_state_size, norm=norm)
        # homoscedastic uncertainty log-variances (zero-initialised)
        names = ['segmentation']
        names += ['pedestrian'] if c.predict_pedestrian else []
        names += ['hdmap'] if c.perceive_hdmap else []
        names += ['centerness', 'offset'] if c.predict_instance else []
        names += ['flow'] if c.predict_future_flow else []
        names += ['planning'] if c.planning_enabled else []
        for n in names:
            setattr(self, f'{n}_weight', nn.Parameter(torch.zeros(())))

    def _frustum(self, device) -> torch.Tensor:
        if device not in self._frustum_on:
            self._frustum_on[device] = torch.as_tensor(self.frustum, device=device)
        return self._frustum_on[device]

    def encode(self, image: torch.Tensor, rng: Optional[torch.Generator] = None):
        """(B*, H, W, 3) -> channels-last (features, depth logits); under
        ``remat == 'encoder'`` (and autograd) the activations are
        recomputed in the backward. The checkpointed call takes the
        encoder's parameters as they are now, so a recomputation sees the
        same (e.g. bf16) copies, and it replays the forward's masks from
        the generator state it started with, leaving the generator where
        it was."""
        if self.cfg.remat != 'encoder' or not torch.is_grad_enabled():
            return self.encoder(image, rng)
        start = None if rng is None else rng.get_state()
        ran = []

        def run(params, x):
            if rng is not None and ran:                   # the backward's recomputation
                now = rng.get_state()
                rng.set_state(start)
                try:
                    return functional_call(self.encoder, params, (x, rng))
                finally:
                    rng.set_state(now)
            ran.append(True)
            return functional_call(self.encoder, params, (x, rng))

        return checkpoint(run, dict(self.encoder.named_parameters()), image,
                          use_reentrant=False, preserve_rng_state=False)

    def calculate_birds_eye_view_features(self, image, intrinsics, extrinsics,
                                          future_egomotion, rng=None):
        """(B, S, N, H, W, 3) -> BEV (B, S, nx, ny, C), depth logits
        (B, S, N, Hf, Wf, D) and the present frame's front-cam feature."""
        b, s, n = image.shape[:3]
        geometry = get_geometry(self._frustum(image.device), intrinsics.float(),
                                extrinsics.float())
        feat, depth = self.encode(image.reshape(b * s * n, *image.shape[3:]), rng)
        feat = feat.reshape(b, s, n, *feat.shape[1:])
        depth = depth.reshape(b, s, n, *depth.shape[1:])
        cam_front = feat[:, -1, self.cfg.cam_front_index]
        lifted = lift_depth_context(feat, depth)                   # (B,S,N,D,Hf,Wf,C)
        x = project_to_birds_eye_view(lifted, geometry, future_egomotion.float(),
                                      self.bev_resolution, self.bev_start_position,
                                      self.bev_dimension, self.cfg.discount)
        return x, depth, cam_front

    def distribution_forward(self, present_state, noise=None):
        """present_state (B, C, 1, H, W) -> sample (B, L, 1, H, W) and the
        distribution stats. ``noise`` (B, 1, L) is the GAUSSIAN draw; None
        means zero (eval)."""
        c = self.cfg
        b, _, s, h, w = present_state.shape
        L = c.latent_dim
        out = self.present_distribution.nchw(present_state)        # (B, 1, 2L)
        mu = out[:, :, :L]
        log_sigma = out[:, :, L:2 * L].clamp(c.min_log_sigma, c.max_log_sigma)
        noise = torch.zeros_like(mu) if noise is None else noise.to(mu)
        sample = mu + torch.exp(log_sigma) * noise
        sample = sample.reshape(b, s, L).transpose(1, 2)[..., None, None].expand(b, L, s, h, w)
        return sample, {'present_mu': mu, 'present_log_sigma': log_sigma}

    def forward(self, image, intrinsics, extrinsics, future_egomotion, train: bool = False,
                generator: Optional[torch.Generator] = None, noise=None,
                dropout: bool = True):
        """image (B, S, N, H, W, 3); intrinsics (B, S, N, 3, 3); extrinsics
        (B, S, N, 4, 4); future_egomotion (B, S, 6). Returns the output
        dict, channels-last.

        ``train``: drop-connect and dropout masks (unless ``dropout`` is
        False) and the GAUSSIAN noise (unless ``noise`` (B, 1, L) is given)
        are drawn from ``generator``, which must then be on the model's
        device."""
        rf = self.cfg.receptive_field
        if train and generator is None and (dropout or noise is None):
            raise ValueError('train=True draws random numbers: pass a torch.Generator')
        masks = generator if train and dropout else None
        if train and noise is None:
            noise = torch.randn(image.shape[0], 1, self.cfg.latent_dim, generator=generator,
                                device=image.device)
        ego = future_egomotion[:, :rf]
        x, depth, cam_front = self.calculate_birds_eye_view_features(
            image[:, :rf], intrinsics[:, :rf], extrinsics[:, :rf], ego, masks)
        return self.forward_from_bev(x, depth, cam_front, ego, noise, masks)

    def forward_from_bev(self, x, depth, cam_front, ego, noise=None, rng=None):
        """The post-splat forward: egopose concat -> temporal ->
        distribution / future -> decode. x (B, rf, nx, ny, C); ``noise``
        and ``rng`` as in ``forward`` (None at eval)."""
        c = self.cfg
        rf = c.receptive_field
        output = {'depth_prediction': depth, 'cam_front': cam_front}
        if c.input_egopose:
            b, s, h, w = x.shape[:4]
            # no egomotion at time 0: feed zeros, then shift
            ego_shift = torch.cat([torch.zeros_like(ego[:, :1]), ego[:, :rf - 1]], 1)
            ego_spatial = ego_shift[:, :, None, None, :].expand(b, s, h, w, 6)
            x = torch.cat([x, ego_spatial.to(x.dtype)], -1)
        states = self.temporal_model.nchw(to_first(x), rng)         # (B, C, S, H, W)
        sample, stats = self.distribution_forward(states[:, :, -1:], noise)
        output.update(stats)
        states = self.future_prediction.nchw(sample, states, rng)
        output.update(self.decoder(to_last(states)))
        return output

    def plan(self, cam_front, trajs, gt_trajs, cost_volume, semantic_pred, hd_map,
             commands, target_points, train: bool = False):
        """The planner: (loss, 0 unless ``train``; refined trajectory (B, T, 3))."""
        return self.planner(cam_front, trajs, gt_trajs, cost_volume, semantic_pred,
                            hd_map, commands, target_points, train)
