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
``MODEL.REMAT='encoder'`` recomputes the encoder's activations in the
backward (``torch.utils.checkpoint``), replaying the same masks and
leaving the running statistics alone.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from stp3_tpu_torch.layers.base import Norm, running_stats_frozen, to_first, to_last
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
from stp3_tpu_torch.ops.static_splat import column_splat, static_splat
from stp3_tpu_torch.ops.warp import cumulative_warp_features
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
    Hf, Wf, C); depth the encoder's flat (B*N, Hf, Wf, D) logits, unused
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
    tags = set() if c.remat == 'none' else set(c.remat.split('+'))
    unknown = tags - {'encoder', 'temporal', 'future', 'decoder', 'cells', 'gates'}
    if unknown:
        raise NotImplementedError(f'MODEL.REMAT stages {sorted(unknown)}')
    if 'temporal' in tags and c.temporal_name == 'identity':
        raise ValueError("MODEL.REMAT 'temporal' has no effect with "
                         "MODEL.TEMPORAL_MODEL.NAME 'identity'")
    if tags & {'future', 'cells', 'gates'} and c.n_future == 0:
        raise ValueError(f"MODEL.REMAT {sorted(tags & {'future', 'cells', 'gates'})} has no "
                         "effect with N_FUTURE_FRAMES 0 (no future-prediction stage is built)")
    if tags - {'encoder'}:
        raise NotImplementedError(f"MODEL.REMAT={c.remat!r} is not ported yet (only 'none' "
                                  "and 'encoder'; the other stages are on ROADMAP.md queue 1)")
    if c.gt_depth:
        raise NotImplementedError('LIFT.GT_DEPTH=True is not ported yet')
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
                                                      c.n_res_layers, norm)
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
        """(B*, H, W, 3) -> channels-last (features, depth logits); under
        ``remat == 'encoder'`` (and autograd) the activations are
        recomputed in the backward. The checkpointed call takes the
        encoder's parameters as they are now, so a recomputation sees the
        same (e.g. bf16) copies, and it replays the forward's masks from
        the generator state it started with, leaving the generator where
        it was; its 'bn' sites normalise with the batch statistics again
        (the same values: the same input) without a second running
        update."""
        if self.cfg.remat != 'encoder' or not torch.is_grad_enabled():
            return self.encoder(image, rng)
        start = None if rng is None else rng.get_state()
        ran = []

        def run(params, x):
            if ran:                                  # the backward's recomputation
                with running_stats_frozen(self.encoder):
                    if rng is None:
                        return functional_call(self.encoder, params, (x, rng))
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
        (B, S, N, Hf, Wf, D) and the present frame's front-cam feature.
        ``fused_lift_splat``: K4 splats depth_prob x context without the
        lifted tensor (the JAX package takes that branch on a single-device
        TPU only; here whenever the flag is set)."""
        b, s, n = image.shape[:3]
        geometry = get_geometry(self._frustum(image.device), intrinsics.float(),
                                extrinsics.float())
        c = self.cfg
        feat, depth = self.encode(image.reshape(b * s * n, *image.shape[3:]), rng)
        feat = feat.reshape(b, s, n, *feat.shape[1:])
        if depth is not None:
            depth = depth.reshape(b, s, n, *depth.shape[1:])
        cam_front = feat[:, -1, c.cam_front_index] if c.planning_enabled else None
        if c.fused_lift_splat:
            x = project_lift_splat_fused(feat, c.depth_channels if depth is None else depth,
                                         geometry, future_egomotion.float(),
                                         self.bev_resolution, self.bev_start_position,
                                         self.bev_dimension, c.discount)
            return x, depth, cam_front
        lifted = (lift_uniform(feat, c.depth_channels) if depth is None
                  else lift_depth_context(feat, depth))            # (B,S,N,D,Hf,Wf,C)
        x = project_to_birds_eye_view(lifted, geometry, future_egomotion.float(),
                                      self.bev_resolution, self.bev_start_position,
                                      self.bev_dimension, self.cfg.discount)
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
        if c.input_egopose:
            b, s, h, w = x.shape[:4]
            # no egomotion at time 0: feed zeros, then shift
            ego_shift = torch.cat([torch.zeros_like(ego[:, :1]), ego[:, :rf - 1]], 1)
            ego_spatial = ego_shift[:, :, None, None, :].expand(b, s, h, w, 6)
            x = torch.cat([x, ego_spatial.to(x.dtype)], -1)
        states = self.temporal_model.nchw(to_first(x), rng)         # (B, C, S, H, W)
        stats = {}
        if c.n_future > 0:
            if c.probabilistic:
                sample, stats = self.distribution_forward(states[:, :, -1:], noise)
            else:
                b, _, _, h, w = states.shape
                sample = states.new_zeros(b, c.latent_dim, 1, h, w)
            states = self.future_prediction.nchw(sample, states, rng)
        return self.decoder(to_last(states)), stats

    # ------------------------------------------------------------- serving
    def splat_single_frame(self, image, intrinsics, extrinsics):
        """Encode, lift and splat ONE frame in its own ego frame (no
        pre-warp, no temporal accumulate; K1 at F=B). image (B, N, H, W,
        3); intrinsics (B, N, 3, 3); extrinsics (B, N, 4, 4). Returns (bev
        (B, nx, ny, C), cam_front (B, Hf, Wf, C))."""
        b, n = image.shape[:2]
        geometry = get_geometry(self._frustum(image.device), intrinsics[:, None].float(),
                                extrinsics[:, None].float())
        c = self.cfg
        feat, depth = self.encode(image.reshape(b * n, *image.shape[2:]))
        feat = feat.reshape(b, n, *feat.shape[1:])
        cam_front = feat[:, c.cam_front_index] if c.planning_enabled else None
        lifted = (lift_uniform(feat, c.depth_channels) if depth is None else
                  lift_depth_context(feat, depth.reshape(b, n, *depth.shape[1:])))
        zero_ego = torch.zeros(b, 1, 6, device=image.device)
        bev = project_to_birds_eye_view(lifted[:, None], geometry, zero_ego,
                                        self.bev_resolution, self.bev_start_position,
                                        self.bev_dimension, self.cfg.discount)[:, 0]
        return bev, cam_front

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
        ``ColumnSplatPlan.device_arrays(device)`` (a dict: per-column
        products and a sorted segment sum) or
        ``StaticSplatPlan.device_buckets(device)`` (a list: per-cell gather
        buckets). Returns (bev, cam_front)."""
        c = self.cfg
        b, n = image.shape[:2]
        feat, depth = self.encode(image.reshape(b * n, *image.shape[2:]))
        feat = feat.reshape(b, n, *feat.shape[1:])                   # (B,N,Hf,Wf,C)
        cam_front = feat[:, c.cam_front_index] if c.planning_enabled else None
        ctx, dp = context_depth_rays(c, feat, depth)
        if isinstance(plan, dict):
            _, hf, wf = self.frustum.shape[:3]
            bev = column_splat(ctx, dp, plan, (n, hf, wf, c.depth_channels, c.bev_dimension))
        else:
            bev = static_splat(ctx, dp, plan, c.bev_dimension)
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
        frames = torch.cat([cached_bev.to(bev_new.dtype), bev_new[:, None]], 1)
        ego = future_egomotion[:, :rf]
        aligned = cumulative_warp_features(frames, ego.float(), mode='bilinear',
                                           spatial_extent=c.spatial_extent)
        x = discounted_accumulate(aligned, c.discount)              # (B, rf, nx, ny, C)
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
        return self.planner(cam_front, trajs, gt_trajs, cost_volume, semantic_pred,
                            hd_map, commands, target_points, train)
