"""STP3: perceive -> predict -> plan (port of stp3_tpu/models/stp3.py,
for serving and training).

``forward(image, intrinsics, extrinsics, future_egomotion)`` returns the
JAX model's output dict (channels-last); ``plan(...)`` runs the planner.
Geometry stays fp32 under any parameter dtype. The lift is materialised
and splatted by K1, or, with ``STP3Config.fused_lift_splat``, fused into
the splat by K4.

The closed-loop serving methods (``splat_single_frame``, ``serve_step``,
``splat_single_frame_static``, ``serve_step_static``) encode and splat only
the newest frame and take the past frames' BEV grids from a cache, aligned
to the present by SE(2) grid warps; the static variants splat with a plan
precomputed from a fixed rig (``ops/static_splat.py``).

Every stage YAML builds: the Perception stage (no future prediction,
no present distribution), the Prediction and Planning stages with a
GAUSSIAN, MIXGAUSSIAN or BERNOULLI present distribution or none
(PROBABILISTIC.ENABLED False: a zero latent), the identity temporal
model, the uniform lift (USE_DEPTH_DISTRIBUTION False) and every
MODEL.NORM ('gn', 'ln', 'bn', 'bn_frozen', 'none').

Training (``train=True``) draws every random number from the caller's
``torch.Generator``: the EfficientNet drop-connect masks, the four
DeepLabHeads' dropout masks and the latent noise. 'bn' normalises with
the batch's statistics while the module is in training mode
(``model.train()``) and updates its running statistics once a forward.
``MODEL.REMAT`` ('none', or '+'-joined stage tags) recomputes a stage's
activations in the backward (``layers/base.remat``), replaying the same
masks and leaving the running statistics alone: 'encoder', 'temporal',
'future' and 'decoder' each checkpoint their stage, 'cells' each GRU
cell step of future prediction, and 'gates' the future stage
selectively: its convolution and matmul outputs are kept and the rest
is recomputed (``_save_conv_dot``).

Each stage is a ``utils/profiling.stage``, traced on the card inside a
CUDA graph's replay too: ``stp3.encoder``, ``stp3.splat`` (geometry,
lift and splat; in serving also the cache's warp and discounted
accumulate), ``stp3.temporal`` (with the egopose concat), ``stp3.future``
(present distribution and future prediction), ``stp3.decoder`` and
``stp3.planner``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import CheckpointPolicy

from stp3_tpu_torch.layers.base import Norm, remat, to_first, to_last
from stp3_tpu_torch.models.cost import CostConfig
from stp3_tpu_torch.models.decoder import Decoder
from stp3_tpu_torch.models.distributions import DistributionModule
from stp3_tpu_torch.models.encoder import Encoder
from stp3_tpu_torch.models.future_prediction import FuturePrediction
from stp3_tpu_torch.models.planning_model import Planning
from stp3_tpu_torch.models.temporal_model import TemporalModel, TemporalModelIdentity
from stp3_tpu_torch.ops.bev_pool import (discounted_accumulate, project_lift_splat_fused,
                                         project_to_birds_eye_view)
from stp3_tpu_torch.ops.geometry import (calculate_birds_eye_view_parameters,
                                         create_frustum, get_geometry)
from stp3_tpu_torch.ops.static_splat import column_splat
from stp3_tpu_torch.ops.warp import cumulative_warp_features
from stp3_tpu_torch.utils import profiling
from stp3_tpu_torch.utils.precision import pin_fp32_math


_CONV_DOT = (torch.ops.aten.convolution.default, torch.ops.aten.mm.default,
             torch.ops.aten.addmm.default, torch.ops.aten.bmm.default)


def _save_conv_dot(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The selective-checkpoint policy of MODEL.REMAT 'gates': the outputs
    of convolutions and matmuls are saved (recomputing them would read
    their inputs again), everything elementwise (the gate sigmoids, tanh,
    the trust gate's softmax mixing) is recomputed from them."""
    return (CheckpointPolicy.MUST_SAVE if op in _CONV_DOT
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_tags(remat: str) -> set:
    """The stage tags of a MODEL.REMAT value."""
    return set() if remat == 'none' else set(remat.split('+'))


def _cam_front_index(names) -> int:
    lowered = [str(n).lower() for n in names]
    for i, n in enumerate(lowered):
        if n in ('cam_front', 'front'):
            return i
    return 1 if len(names) > 1 else 0


@dataclasses.dataclass(frozen=True)
class STP3Config:
    """The subset of the config tree the model reads (the JAX package's
    STP3Config, plus ``norm`` and ``bn_momentum``: this package keeps the
    norm kind and the BatchNorm momentum in the config instead of
    process-wide defaults)."""
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
    # the fused lift + splat (K4); set in code, as in the JAX package
    fused_lift_splat: bool = False
    norm: str = 'gn'
    bn_momentum: float = 0.1
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
            bn_momentum=float(cfg.MODEL.get('BN_MOMENTUM', 0.1)),
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
    def bev_dimension(self) -> Tuple[int, int, int]:
        _, _, dim = calculate_birds_eye_view_parameters(
            list(self.x_bound), list(self.y_bound), list(self.z_bound))
        return int(dim[0]), int(dim[1]), int(dim[2])

    @property
    def spatial_extent(self) -> Tuple[float, float]:
        return (self.x_bound[1], self.y_bound[1])

    @property
    def temporal_in_channels(self) -> int:
        return self.encoder_out_channels + (6 if self.input_egopose else 0)

    @property
    def future_pred_in_channels(self) -> int:
        if self.temporal_name == 'identity':
            return self.temporal_in_channels
        return TemporalModel.out_channels(self.start_out_channels, self.receptive_field,
                                          self.extra_in_channels)


def lift_depth_context(feat: torch.Tensor, depth_logits: torch.Tensor) -> torch.Tensor:
    """LSS lift: depth softmax (x) context. feat (..., Hf, Wf, C), depth
    logits (..., Hf, Wf, D) -> (..., D, Hf, Wf, C)."""
    depth_prob = torch.softmax(depth_logits, -1)
    return depth_prob.movedim(-1, -3)[..., None] * feat[..., None, :, :, :]


def lift_uniform(feat: torch.Tensor, depth_channels: int) -> torch.Tensor:
    """USE_DEPTH_DISTRIBUTION False: the context repeated over the D bins.
    feat (..., Hf, Wf, C) -> (..., D, Hf, Wf, C) (an expanded view)."""
    return feat[..., None, :, :, :].expand(
        *feat.shape[:-3], depth_channels, *feat.shape[-3:])


def context_depth_rays(cfg: STP3Config, feat: torch.Tensor, depth: torch.Tensor):
    """Ray-major (B, rays, C) context and (B, rays, D) depth distribution
    for the static splat plans (ray = cam*Hf*Wf + h*Wf + w). feat (B, N,
    Hf, Wf, C); depth its (B, N, Hf, Wf, D) (or flat (B*N, ...)) logits, unused
    without the depth distribution (all ones, as ``lift_uniform``)."""
    b = feat.shape[0]
    ctx = feat.reshape(b, -1, feat.shape[-1])
    if not cfg.use_depth_distribution:
        return ctx, ctx.new_ones(*ctx.shape[:-1], cfg.depth_channels)
    dp = torch.softmax(depth, -1).reshape(b, -1, cfg.depth_channels)
    return ctx, dp


def _check_supported(c: STP3Config) -> None:
    """Refuse what this package does not port, and what the JAX package
    refuses, with the JAX package's exception where it has one."""
    tags = remat_tags(c.remat)
    unknown = tags - {'encoder', 'temporal', 'future', 'decoder', 'cells', 'gates'}
    if unknown:
        raise NotImplementedError(f'MODEL.REMAT stages {sorted(unknown)}')
    # a tag that would do nothing on this architecture is refused: a remat
    # policy that quietly does nothing is a memory budget miscalculated
    if 'temporal' in tags and c.temporal_name == 'identity':
        raise ValueError("MODEL.REMAT 'temporal' has no effect with "
                         "MODEL.TEMPORAL_MODEL.NAME 'identity'")
    if tags & {'future', 'cells', 'gates'} and c.n_future == 0:
        raise ValueError(f"MODEL.REMAT {sorted(tags & {'future', 'cells', 'gates'})} has no "
                         "effect with N_FUTURE_FRAMES 0 (no future-prediction stage is built)")
    if 'gates' in tags and tags & {'future', 'cells'}:
        raise ValueError("MODEL.REMAT 'gates' (policy remat) composes with "
                         "'encoder'/'temporal'/'decoder' but not with 'future'/'cells' (they "
                         "wrap the same stage)")
    if c.temporal_name not in ('temporal_block', 'identity'):
        raise NotImplementedError(f'Temporal module {c.temporal_name}')
    if c.temporal_name == 'temporal_block' and c.receptive_field < 2:
        # the JAX model's head then keeps the input's width, not the
        # START_OUT_CHANNELS its later stages are built for
        raise NotImplementedError("MODEL.TEMPORAL_MODEL.NAME 'temporal_block' needs "
                                  "TIME_RECEPTIVE_FIELD >= 2 ('identity' takes any)")


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
        self.remat_stages = remat_tags(c.remat)
        self.bev_resolution, self.bev_start_position, self.bev_dimension = (
            calculate_birds_eye_view_parameters(list(c.x_bound), list(c.y_bound),
                                                list(c.z_bound)))
        self.frustum = create_frustum(c.final_dim, c.encoder_downsample, c.d_bound)
        self._frustum_on: Dict[torch.device, torch.Tensor] = {}
        norm = c.norm
        self.encoder = Encoder(c.encoder_out_channels, c.depth_channels, c.encoder_name,
                               c.encoder_downsample, norm, c.use_depth_distribution)
        if c.temporal_name == 'identity':
            self.temporal_model = TemporalModelIdentity()
        else:
            self.temporal_model = TemporalModel(
                c.temporal_in_channels, c.receptive_field, c.bev_size, c.start_out_channels,
                c.extra_in_channels, c.inbetween_layers, c.pyramid_pooling, norm)
        cf = c.future_pred_in_channels
        if c.n_future > 0:
            if c.probabilistic:
                self.present_distribution = DistributionModule(cf, c.latent_dim,
                                                               c.prob_method, norm)
            self.future_prediction = FuturePrediction(cf, c.latent_dim, c.n_future,
                                                      c.mixture, c.n_gru_blocks,
                                                      c.n_res_layers, norm,
                                                      remat_cells='cells' in self.remat_stages)
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
        names += ['depths'] if c.gt_depth else []
        names += ['centerness', 'offset'] if c.predict_instance else []
        names += ['flow'] if c.predict_future_flow else []
        names += ['planning'] if c.planning_enabled else []
        for n in names:
            setattr(self, f'{n}_weight', nn.Parameter(torch.zeros(())))
        # MODEL.BN_MOMENTUM at every BatchNorm site (the reference sets it
        # on all of its BNs when it builds the model)
        for m in self.modules():
            if isinstance(m, Norm):
                m.momentum = c.bn_momentum

    def noise_shape(self, b: int) -> Tuple[int, ...]:
        """The shape of the training-time latent draw of a batch of ``b``:
        GAUSSIAN (B, 1, L); MIXGAUSSIAN (3, B, 1, L), its three draws in
        order; BERNOULLI (B, nx, ny, L), one a BEV cell."""
        L = self.cfg.latent_dim
        if self.cfg.prob_method == 'MIXGAUSSIAN':
            return (3, b, 1, L)
        if self.cfg.prob_method == 'BERNOULLI':
            return (b, *self.cfg.bev_size, L)
        return (b, 1, L)

    def _frustum(self, device) -> torch.Tensor:
        if device not in self._frustum_on:
            self._frustum_on[device] = torch.as_tensor(self.frustum, device=device)
        return self._frustum_on[device]

    def encode(self, image: torch.Tensor, rng: Optional[torch.Generator] = None):
        """(B*, H, W, 3) -> channels-last (features, depth logits), under
        REMAT 'encoder' recomputed in the backward."""
        if 'encoder' in self.remat_stages:
            return remat(self.encoder, 'forward', image, rng)
        return self.encoder(image, rng)

    def camera_geometry(self, intrinsics, extrinsics) -> torch.Tensor:
        """intrinsics (..., N, 3, 3), extrinsics (..., N, 4, 4) -> the fp32
        ego-frame points of every frustum cell (..., N, D, Hf, Wf, 3)."""
        return get_geometry(self._frustum(intrinsics.device), intrinsics.float(),
                            extrinsics.float())

    def encode_cameras(self, image, rng=None):
        """image (..., N, H, W, 3) -> channels-last features (..., N, Hf, Wf,
        C) and depth logits (..., N, Hf, Wf, D), None under the uniform
        lift; ``encode`` on the flattened images."""
        lead = image.shape[:-3]
        with profiling.stage('stp3.encoder', image):
            feat, depth = self.encode(image.reshape(-1, *image.shape[-3:]), rng)
        feat = feat.reshape(*lead, *feat.shape[1:])
        if depth is not None:
            depth = depth.reshape(*lead, *depth.shape[1:])
        return feat, depth

    def splat_frames(self, feat, depth, geometry, future_egomotion, fused: bool):
        """feat (B, S, N, Hf, Wf, C), depth (B, S, N, Hf, Wf, D) or None,
        geometry (B, S, N, D, Hf, Wf, 3) -> BEV (B, S, nx, ny, C), the
        frames pre-warped and accumulated: the lift then K1, or with
        ``fused`` K4 on depth_prob x context without the lifted tensor."""
        c = self.cfg
        ego = future_egomotion.float()
        if fused:
            return project_lift_splat_fused(feat, c.depth_channels if depth is None else depth,
                                            geometry, ego, self.bev_resolution,
                                            self.bev_start_position, self.bev_dimension,
                                            c.discount)
        lifted = (lift_uniform(feat, c.depth_channels) if depth is None
                  else lift_depth_context(feat, depth))            # (B,S,N,D,Hf,Wf,C)
        return project_to_birds_eye_view(lifted, geometry, ego, self.bev_resolution,
                                         self.bev_start_position, self.bev_dimension,
                                         c.discount)

    def calculate_birds_eye_view_features(self, image, intrinsics, extrinsics,
                                          future_egomotion, rng=None):
        """(B, S, N, H, W, 3) -> BEV (B, S, nx, ny, C), depth logits
        (B, S, N, Hf, Wf, D) and the present frame's front-cam feature.
        ``fused_lift_splat``: K4 splats depth_prob x context without the
        lifted tensor (the JAX package takes that branch on a single-device
        TPU only; here whenever the flag is set)."""
        c = self.cfg
        feat, depth = self.encode_cameras(image, rng)
        cam_front = feat[:, -1, c.cam_front_index] if c.planning_enabled else None
        with profiling.stage('stp3.splat', feat):
            geometry = self.camera_geometry(intrinsics, extrinsics)
            x = self.splat_frames(feat, depth, geometry, future_egomotion, c.fused_lift_splat)
        return x, depth, cam_front

    def distribution_forward(self, present_state, noise=None):
        """present_state (B, C, 1, H, W) -> sample (B, L, 1, H, W) and the
        distribution stats (channels-last, as the JAX package's). ``noise``
        has ``noise_shape``; None means zero (eval)."""
        c = self.cfg
        b, _, s, h, w = present_state.shape
        L = c.latent_dim
        out = self.present_distribution.nchw(present_state)
        if c.prob_method == 'BERNOULLI':                           # (B, L, H, W)
            noise = torch.zeros_like(out) if noise is None else to_first(noise.to(out))
            sample = (torch.exp(out) + noise)[:, :, None]
            return sample, {'present_log_prob': to_last(out)}

        def gaussian(params, draw):
            mu = params[:, :, :L]
            log_sigma = params[:, :, L:2 * L].clamp(c.min_log_sigma, c.max_log_sigma)
            draw = torch.zeros_like(mu) if draw is None else draw.to(mu)
            return mu + torch.exp(log_sigma) * draw, mu, log_sigma

        if c.prob_method == 'GAUSSIAN':                            # (B, 1, 2L)
            sample, mu, log_sigma = gaussian(out, noise)
            stats = {'present_mu': mu, 'present_log_sigma': log_sigma}
        else:                                                      # (B, 1, 6L + 3)
            coef = torch.softmax(out[:, :, 6 * L:], -1)
            parts = [gaussian(out[:, :, 2 * i * L:2 * (i + 1) * L],
                              None if noise is None else noise[i]) for i in range(3)]
            sample = sum(smp * coef[:, :, i:i + 1] for i, (smp, _, _) in enumerate(parts))
            stats = {'present_mu': [mu for _, mu, _ in parts],
                     'present_log_sigma': [ls for _, _, ls in parts]}
        sample = sample.reshape(b, s, L).transpose(1, 2)[..., None, None].expand(b, L, s, h, w)
        return sample, stats

    def forward(self, image, intrinsics, extrinsics, future_egomotion, train: bool = False,
                generator: Optional[torch.Generator] = None, noise=None,
                dropout: bool = True):
        """image (B, S, N, H, W, 3); intrinsics (B, S, N, 3, 3); extrinsics
        (B, S, N, 4, 4); future_egomotion (B, S, 6). Returns the output
        dict, channels-last.

        ``train``: drop-connect and dropout masks (unless ``dropout`` is
        False) and the latent noise (unless ``noise``, of ``noise_shape``,
        is given) are drawn from ``generator``, which must then be on the
        model's device. Whether the 'bn' sites use the batch's statistics
        is the module's training mode, not ``train``."""
        rf = self.cfg.receptive_field
        # a latent is drawn only where a present distribution is built
        draws = train and noise is None and self.cfg.n_future > 0 and self.cfg.probabilistic
        if train and generator is None and (dropout or draws):
            raise ValueError('train=True draws random numbers: pass a torch.Generator')
        masks = generator if train and dropout else None
        if draws:
            noise = torch.randn(self.noise_shape(image.shape[0]), generator=generator,
                                device=image.device)
        ego = future_egomotion[:, :rf]
        x, depth, cam_front = self.calculate_birds_eye_view_features(
            image[:, :rf], intrinsics[:, :rf], extrinsics[:, :rf], ego, masks)
        return self.forward_from_bev(x, depth, cam_front, ego, noise, masks)

    def forward_from_bev(self, x, depth, cam_front, ego, noise=None, rng=None):
        """The post-splat forward: egopose concat -> temporal ->
        distribution / future -> decode. x (B, rf, nx, ny, C); ``noise``
        and ``rng`` as in ``forward`` (None at eval)."""
        output = {'depth_prediction': depth, 'cam_front': cam_front}
        heads, stats = self._predict(x, ego, noise, rng)
        output.update(stats)
        output.update(heads)
        return output

    def _predict(self, x, ego, noise=None, rng=None):
        """(decoder outputs, distribution stats) of the BEV features x."""
        c = self.cfg
        rf = c.receptive_field
        with profiling.stage('stp3.temporal', x):
            if c.input_egopose:
                b, s, h, w = x.shape[:4]
                # no egomotion at time 0: feed zeros, then shift
                ego_shift = torch.cat([torch.zeros_like(ego[:, :1]), ego[:, :rf - 1]], 1)
                ego_spatial = ego_shift[:, :, None, None, :].expand(b, s, h, w, 6)
                x = torch.cat([x, ego_spatial.to(x.dtype)], -1)
            if 'temporal' in self.remat_stages:
                states = remat(self.temporal_model, 'nchw', to_first(x), rng)
            else:
                states = self.temporal_model.nchw(to_first(x), rng)     # (B, C, S, H, W)
        stats = {}
        if c.n_future > 0:
            with profiling.stage('stp3.future', states):
                if c.probabilistic:
                    sample, stats = self.distribution_forward(states[:, :, -1:], noise)
                else:
                    b, _, _, h, w = states.shape
                    sample = states.new_zeros(b, c.latent_dim, 1, h, w)
                if self.remat_stages & {'future', 'gates'}:
                    policy = _save_conv_dot if 'gates' in self.remat_stages else None
                    states = remat(self.future_prediction, 'nchw', sample, states, rng,
                                   policy=policy)
                else:
                    states = self.future_prediction.nchw(sample, states, rng)
        with profiling.stage('stp3.decoder', states):
            if 'decoder' in self.remat_stages:
                return remat(self.decoder, 'forward', to_last(states)), stats
            return self.decoder(to_last(states)), stats

    # ------------------------------------------------------------- serving
    def splat_single_frame(self, image, intrinsics, extrinsics):
        """Encode, lift and splat ONE frame in its own ego frame (no
        pre-warp, no temporal accumulate; K1 at F=B). image (B, N, H, W,
        3); intrinsics (B, N, 3, 3); extrinsics (B, N, 4, 4). Returns (bev
        (B, nx, ny, C), cam_front (B, Hf, Wf, C))."""
        c = self.cfg
        feat, depth = self.encode_cameras(image)
        cam_front = feat[:, c.cam_front_index] if c.planning_enabled else None
        with profiling.stage('stp3.splat', feat):
            return self.splat_present(feat, depth, intrinsics, extrinsics), cam_front

    def splat_present(self, feat, depth, intrinsics, extrinsics):
        """The present frame's features (B, N, Hf, Wf, C) and depth logits
        (or None) splatted in its own ego frame: (B, nx, ny, C), lift then
        K1."""
        geometry = self.camera_geometry(intrinsics[:, None], extrinsics[:, None])
        zero_ego = torch.zeros(feat.shape[0], 1, 6, device=feat.device)
        return self.splat_frames(feat[:, None], None if depth is None else depth[:, None],
                                 geometry, zero_ego, fused=False)[:, 0]

    def serve_step(self, image, intrinsics, extrinsics, future_egomotion, cached_bev,
                   trajs, commands, target_points):
        """Incremental closed-loop inference: only the NEW frame is encoded
        and splatted; the past frames' BEV grids come from the cache (each
        in its own ego frame) and are aligned to the present with SE(2)
        grid warps, not point-level re-warping (the JAX package's serving
        approximation; training and evaluation use the exact forward).

        image (B, N, H, W, 3) present frame only; future_egomotion (B, rf,
        6); cached_bev (B, rf-1, nx, ny, C) per-frame ego-centric splats of
        the past frames, oldest first. Returns (refined trajectory (B,
        n_future, 3), output dict, new cache)."""
        bev_new, cam_front = self.splat_single_frame(image, intrinsics, extrinsics)
        return self._serve_tail(bev_new, cam_front, cached_bev, future_egomotion, trajs,
                                commands, target_points)

    def splat_single_frame_static(self, image, plan):
        """Encode and splat ONE frame with a plan precomputed from a fixed
        rig (``ops/static_splat.py``): no scatter kernel. plan is
        ``ColumnSplatPlan.device_arrays(device)`` (per-column products and a
        sorted segment sum). Returns (bev, cam_front)."""
        c = self.cfg
        n = image.shape[1]
        feat, depth = self.encode_cameras(image)                     # (B,N,Hf,Wf,C)
        cam_front = feat[:, c.cam_front_index] if c.planning_enabled else None
        with profiling.stage('stp3.splat', feat):
            ctx, dp = context_depth_rays(c, feat, depth)
            _, hf, wf = self.frustum.shape[:3]
            bev = column_splat(ctx, dp, plan, (n, hf, wf, c.depth_channels, c.bev_dimension))
        return bev, cam_front

    def serve_step_static(self, image, future_egomotion, cached_bev, trajs, commands,
                          target_points, plan):
        """``serve_step`` with the static-geometry splat (the rig's
        intrinsics and extrinsics are frozen into ``plan``)."""
        bev_new, cam_front = self.splat_single_frame_static(image, plan)
        return self._serve_tail(bev_new, cam_front, cached_bev, future_egomotion, trajs,
                                commands, target_points)

    def _serve_tail(self, bev_new, cam_front, cached_bev, future_egomotion, trajs,
                    commands, target_points):
        """After the present frame's splat: cache alignment, the discounted
        accumulate, temporal model, future prediction, decode, plan. Without
        a planner (PLANNING.ENABLED False, as in the Perception stage) the
        refined trajectory is None."""
        c = self.cfg
        rf = c.receptive_field
        ego = future_egomotion[:, :rf]
        with profiling.stage('stp3.splat', bev_new):
            frames = torch.cat([cached_bev.to(bev_new.dtype), bev_new[:, None]], 1)
            aligned = cumulative_warp_features(frames, ego.float(), mode='bilinear',
                                               spatial_extent=c.spatial_extent)
            x = discounted_accumulate(aligned, c.discount)          # (B, rf, nx, ny, C)
        output, _ = self._predict(x, ego)
        output['cam_front'] = cam_front
        if not c.planning_enabled:
            return None, output, frames[:, 1:]
        seg = output['segmentation'].argmax(-1)
        ped = output['pedestrian'].argmax(-1) if c.predict_pedestrian else torch.zeros_like(seg)
        occupancy = torch.logical_or(seg, ped).to(x.dtype)
        gt_dummy = torch.zeros(bev_new.shape[0], c.n_future, 3, dtype=x.dtype,
                               device=x.device)
        _, traj = self.plan(cam_front, trajs, gt_dummy, output['costvolume'][:, rf:],
                            occupancy[:, rf:], output['hdmap'], commands, target_points)
        return traj, output, frames[:, 1:]

    def plan(self, cam_front, trajs, gt_trajs, cost_volume, semantic_pred, hd_map,
             commands, target_points, train: bool = False):
        """The planner: (loss, 0 unless ``train``; refined trajectory (B, T, 3))."""
        with profiling.stage('stp3.planner', cam_front):
            return self.planner(cam_front, trajs, gt_trajs, cost_volume, semantic_pred,
                                hd_map, commands, target_points, train)
