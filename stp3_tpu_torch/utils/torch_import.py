"""Reference ST-P3 (torch / Lightning) checkpoints in and out of this
package (the counterpart of stp3_tpu/utils/torch_import.py, in numpy and
torch only).

The reference trains with BatchNorm, so an imported model is built with
``MODEL.NORM='bn_frozen'``: every Norm site carries the running statistics
as buffers outside the optimizer. The converter maps every reference
``state_dict`` tensor onto a leaf of a flax-path tree of numpy arrays
(``'encoder/DeepLabHead_0/...'``); the modules of this package are named
after those paths, so reference -> port is ``import_state_dict`` followed
by ``utils.from_flax.load_flax_params``, and port -> reference is
``export_state_dict(to_flax(module)['params'], cfg)``. The layouts:

  * Conv2d           OIHW  -> HWIO  (depthwise included: O=C, I=1)
  * Conv3d           OIDHW -> DHWIO (CausalConv3d kernels)
  * Conv3d 1x1x1     OI111 -> Dense (I, O) (reference
                     conv_1x1x1_norm_activated, temporal.py:315-325)
  * ConvTranspose2d  (I,O,kh,kw) -> (kh,kw,O,I) with transpose_kernel=True
  * Linear           (O,I) -> (I,O)
  * BatchNorm{2,3}d  weight/bias/running_mean/running_var ->
                     Norm{scale,bias,mean,var}
  * GRU conv gates   the reference's separate conv_update / conv_reset
                     (temporal.py:21-23) fuse into the 2x-output 'gates'
                     conv (update first, reset second)
  * nn.GRUCell       (r,z,n)-stacked weight_ih/weight_hh/bias_ih/bias_hh ->
                     GRUCell ir/iz/in/hr/hz/hn; torch's two r/z biases fold
                     into the input bias, and export writes zeros for the
                     r/z part of bias_hh, so that entry does not round-trip
                     bit for bit (its fold does)

Reference key names: encoder stp3/models/encoder.py:18-35 (with
efficientnet_pytorch's _conv_stem/_bn0/_blocks.N names), temporal model
temporal_model.py:22-48, distribution distributions.py:15-67, future
prediction future_prediction.py:13-26, decoder decoder.py:24-89 (with
torchvision resnet18 names), planner planning_model.py:13-31, uncertainty
weights trainer.py:42-97.
"""
from __future__ import annotations

import dataclasses
import pickle
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from stp3_tpu_torch.layers.base import init_parameters
from stp3_tpu_torch.models.efficientnet import _TRUNCATE_IDX, block_plan
from stp3_tpu_torch.models.stp3 import STP3, _cam_front_index
from stp3_tpu_torch.utils.from_flax import flatten_tree, to_flax, unflatten_tree

Array = np.ndarray
StateDict = Dict[str, Array]
Params = Dict[str, object]

# --------------------------------------------------------------------------
# leaf transforms (torch -> flax); each has an exact inverse
# --------------------------------------------------------------------------


def _t_conv(w: Array) -> Array:          # OIHW -> HWIO
    return np.transpose(w, (2, 3, 1, 0))


def _t_conv_inv(w: Array) -> Array:
    return np.transpose(w, (3, 2, 0, 1))


def _t_conv3d(w: Array) -> Array:        # OIDHW -> DHWIO
    return np.transpose(w, (2, 3, 4, 1, 0))


def _t_conv3d_inv(w: Array) -> Array:
    return np.transpose(w, (4, 3, 0, 1, 2))


def _t_convT(w: Array) -> Array:         # (I,O,kh,kw) -> (kh,kw,O,I), transpose_kernel=True
    return np.transpose(w, (2, 3, 1, 0))


def _t_convT_inv(w: Array) -> Array:
    return np.transpose(w, (3, 2, 0, 1))


def _t_linear(w: Array) -> Array:        # (O,I) -> (I,O)
    return np.transpose(w, (1, 0))


def _t_dense_from_1x1x1(w: Array) -> Array:   # (O,I,1,1,1) -> (I,O)
    return np.transpose(w.reshape(w.shape[0], w.shape[1]), (1, 0))


def _t_dense_to_1x1x1(w: Array) -> Array:
    return np.transpose(w, (1, 0))[:, :, None, None, None]


def _identity(x: Array) -> Array:
    return x


def _scalar(x) -> Array:
    return np.asarray(x).reshape(())


# --------------------------------------------------------------------------
# declarative mapping entries
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Entry:
    """One mapping unit: ``torch_keys`` <-> ``flax_paths``.

    imp(torch_values) -> flax_values; exp(flax_values) -> torch_values.
    Values are positional lists matching the key / path lists.
    """
    torch_keys: List[str]
    flax_paths: List[str]
    imp: Callable[[List[Array]], List[Array]]
    exp: Callable[[List[Array]], List[Array]]


def _simple(tkey: str, fpath: str, fwd, inv) -> Entry:
    return Entry([tkey], [fpath], lambda v: [fwd(v[0])], lambda v: [inv(v[0])])


class Mapper:
    """Accumulates Entries while walking the (config-dependent) module tree."""

    def __init__(self) -> None:
        self.entries: List[Entry] = []

    # -- primitives ---------------------------------------------------------
    def conv(self, t: str, f: str, bias: bool = False) -> None:
        self.entries.append(_simple(f'{t}.weight', f'{f}/kernel', _t_conv, _t_conv_inv))
        if bias:
            self.entries.append(_simple(f'{t}.bias', f'{f}/bias', _identity, _identity))

    def convT(self, t: str, f: str, bias: bool = False) -> None:
        self.entries.append(_simple(f'{t}.weight', f'{f}/kernel', _t_convT, _t_convT_inv))
        if bias:
            self.entries.append(_simple(f'{t}.bias', f'{f}/bias', _identity, _identity))

    def conv3d(self, t: str, f: str) -> None:
        self.entries.append(_simple(f'{t}.weight', f'{f}/kernel', _t_conv3d, _t_conv3d_inv))

    def dense(self, t: str, f: str, bias: bool = True) -> None:
        self.entries.append(_simple(f'{t}.weight', f'{f}/kernel', _t_linear, _t_linear))
        if bias:
            self.entries.append(_simple(f'{t}.bias', f'{f}/bias', _identity, _identity))

    def dense_1x1x1(self, t: str, f: str) -> None:
        # conv_1x1x1_norm_activated's Conv3d (bias=False) -> Dense
        self.entries.append(_simple(f'{t}.weight', f'{f}/kernel',
                                    _t_dense_from_1x1x1, _t_dense_to_1x1x1))

    def bn(self, t: str, f: str) -> None:
        """BatchNorm{1,2,3}d -> bn_frozen Norm."""
        self.entries.append(Entry(
            [f'{t}.weight', f'{t}.bias', f'{t}.running_mean', f'{t}.running_var'],
            [f'{f}/scale', f'{f}/bias', f'{f}/mean', f'{f}/var'], list, list))

    def ln(self, t: str, f: str) -> None:
        """torch LayerNorm / reference channels_first LayerNorm -> LayerNorm."""
        self.entries.append(Entry([f'{t}.weight', f'{t}.bias'],
                                  [f'{f}/scale', f'{f}/bias'], list, list))

    def scalar(self, t: str, f: str) -> None:
        self.entries.append(_simple(t, f, _scalar, _scalar))

    def gru_gates(self, t_update: str, t_reset: str, f_gates: str) -> None:
        """Fuse conv_update + conv_reset into the 2x-output 'gates' conv
        (update first; layers/temporal.py ConvGRUCell)."""
        def imp(v):
            wu, bu, wr, br = v
            k = np.concatenate([_t_conv(wu), _t_conv(wr)], axis=-1)
            return [k, np.concatenate([bu, br], axis=0)]

        def exp(v):
            k, b = v
            h = k.shape[-1] // 2
            return [_t_conv_inv(k[..., :h]), b[:h], _t_conv_inv(k[..., h:]), b[h:]]

        self.entries.append(Entry(
            [f'{t_update}.weight', f'{t_update}.bias', f'{t_reset}.weight', f'{t_reset}.bias'],
            [f'{f_gates}/kernel', f'{f_gates}/bias'], imp, exp))

    def torch_gru_cell(self, t: str, f: str) -> None:
        """nn.GRUCell -> the flax-layout GRUCell. torch stacks (r,z,n) along
        dim 0 of weight_ih / weight_hh; the cell keeps six Dense layers (hr
        and hz without bias, so torch's b_ir + b_hr folds into the ir bias)."""
        def imp(v):
            wih, whh, bih, bhh = v
            h = whh.shape[1]
            w_ir, w_iz, w_in = wih[:h], wih[h:2 * h], wih[2 * h:]
            w_hr, w_hz, w_hn = whh[:h], whh[h:2 * h], whh[2 * h:]
            b_ir, b_iz, b_in = bih[:h], bih[h:2 * h], bih[2 * h:]
            b_hr, b_hz, b_hn = bhh[:h], bhh[h:2 * h], bhh[2 * h:]
            return [_t_linear(w_ir), b_ir + b_hr,
                    _t_linear(w_iz), b_iz + b_hz,
                    _t_linear(w_in), b_in,
                    _t_linear(w_hr), _t_linear(w_hz),
                    _t_linear(w_hn), b_hn]

        def exp(v):
            ir_k, ir_b, iz_k, iz_b, in_k, in_b, hr_k, hz_k, hn_k, hn_b = v
            wih = np.concatenate([_t_linear(ir_k), _t_linear(iz_k), _t_linear(in_k)], 0)
            whh = np.concatenate([_t_linear(hr_k), _t_linear(hz_k), _t_linear(hn_k)], 0)
            bih = np.concatenate([ir_b, iz_b, in_b], 0)
            bhh = np.concatenate([np.zeros_like(ir_b), np.zeros_like(iz_b), hn_b], 0)
            return [wih, whh, bih, bhh]

        self.entries.append(Entry(
            [f'{t}.weight_ih', f'{t}.weight_hh', f'{t}.bias_ih', f'{t}.bias_hh'],
            [f'{f}/ir/kernel', f'{f}/ir/bias', f'{f}/iz/kernel', f'{f}/iz/bias',
             f'{f}/in/kernel', f'{f}/in/bias', f'{f}/hr/kernel', f'{f}/hz/kernel',
             f'{f}/hn/kernel', f'{f}/hn/bias'], imp, exp))

    # -- composite reference modules ----------------------------------------
    def aspp(self, t: str, f: str) -> None:
        """reference ASPP (convolutions.py:242-270): convs.0 (1x1), convs.1-3
        (rates 12/24/36), convs.4 (pooling), project."""
        self.conv(f'{t}.convs.0.0', f'{f}/Conv_0')
        self.bn(f'{t}.convs.0.1', f'{f}/Norm_0')
        for i in (1, 2, 3):
            self.conv(f'{t}.convs.{i}.0', f'{f}/Conv_{i}')
            self.bn(f'{t}.convs.{i}.1', f'{f}/Norm_{i}')
        self.conv(f'{t}.convs.4.1', f'{f}/Conv_4')
        self.bn(f'{t}.convs.4.2', f'{f}/Norm_4')
        self.conv(f'{t}.project.0', f'{f}/Conv_5')
        self.bn(f'{t}.project.1', f'{f}/Norm_5')

    def deeplab_head(self, t: str, f: str) -> None:
        """reference DeepLabHead (convolutions.py:272-280): Sequential
        [ASPP, conv3x3, BN, ReLU, conv1x1]."""
        self.aspp(f'{t}.0', f'{f}/ASPP_0')
        self.conv(f'{t}.1', f'{f}/Conv_0')
        self.bn(f'{t}.2', f'{f}/Norm_0')
        self.conv(f'{t}.4', f'{f}/Conv_1', bias=True)

    def upsampling_concat(self, t: str, f: str) -> None:
        """reference UpsamplingConcat (convolutions.py:183-201):
        conv.[0 conv, 1 bn, 3 conv, 4 bn]."""
        self.conv(f'{t}.conv.0', f'{f}/Conv_0')
        self.bn(f'{t}.conv.1', f'{f}/Norm_0')
        self.conv(f'{t}.conv.3', f'{f}/Conv_1')
        self.bn(f'{t}.conv.4', f'{f}/Norm_1')

    def upsampling_add(self, t: str, f: str) -> None:
        """reference UpsamplingAdd (convolutions.py:204-215):
        upsample_layer.[1 conv, 2 bn]."""
        self.conv(f'{t}.upsample_layer.1', f'{f}/Conv_0')
        self.bn(f'{t}.upsample_layer.2', f'{f}/Norm_0')

    def bottleneck2d(self, t: str, f: str, in_ch: int, out_ch: Optional[int],
                     downsample: bool = False, upsample: bool = False) -> None:
        """reference Bottleneck (convolutions.py:65-169). The flax names are
        per type: the middle conv is ConvTranspose_0 in the upsample
        variant, which shifts the later Conv_i indices by one."""
        out_ch = out_ch or in_ch
        self.conv(f'{t}.layers.conv_down_project', f'{f}/Conv_0')
        self.bn(f'{t}.layers.abn_down_project.0', f'{f}/Norm_0')
        if upsample:
            self.convT(f'{t}.layers.conv', f'{f}/ConvTranspose_0')
            nxt = 1
        else:
            self.conv(f'{t}.layers.conv', f'{f}/Conv_1')
            nxt = 2
        self.bn(f'{t}.layers.abn.0', f'{f}/Norm_1')
        self.conv(f'{t}.layers.conv_up_project', f'{f}/Conv_{nxt}')
        self.bn(f'{t}.layers.abn_up_project.0', f'{f}/Norm_2')
        if out_ch != in_ch or downsample or upsample:
            self.conv(f'{t}.projection.conv_skip_proj', f'{f}/Conv_{nxt + 1}')
            self.bn(f'{t}.projection.bn_skip_proj', f'{f}/Norm_3')

    def bottleblock(self, t: str, f: str, in_ch: int, out_ch: Optional[int]) -> None:
        """reference Bottleblock (convolutions.py:348-380): layers
        [0 conv7, 1 LN, 3 conv1, 4 LN, 6 conv3, 7 LN] + projection.0 conv."""
        out_ch = out_ch or in_ch
        self.conv(f'{t}.layers.0', f'{f}/Conv_0')
        self.ln(f'{t}.layers.1', f'{f}/LayerNorm_0')
        self.conv(f'{t}.layers.3', f'{f}/Conv_1')
        self.ln(f'{t}.layers.4', f'{f}/LayerNorm_1')
        self.conv(f'{t}.layers.6', f'{f}/Conv_2')
        self.ln(f'{t}.layers.7', f'{f}/LayerNorm_2')
        if out_ch != in_ch:
            self.conv(f'{t}.projection.0', f'{f}/Conv_3')

    def convnext_block(self, t: str, f: str) -> None:
        """reference ConvNeXt Block (convolutions.py:310-346)."""
        self.conv(f'{t}.dwconv', f'{f}/Conv_0', bias=True)
        self.ln(f'{t}.norm', f'{f}/LayerNorm_0')
        self.dense(f'{t}.pwconv1', f'{f}/Dense_0')
        self.dense(f'{t}.pwconv2', f'{f}/Dense_1')
        self.entries.append(_simple(f'{t}.gamma', f'{f}/gamma', _identity, _identity))

    def conv1x1x1_na(self, t: str, f: str) -> None:
        """reference conv_1x1x1_norm_activated (temporal.py:315-325)."""
        self.dense_1x1x1(f'{t}.conv', f'{f}/Dense_0')
        self.bn(f'{t}.norm', f'{f}/Norm_0')

    def causal_conv3d(self, t: str, f: str) -> None:
        """reference CausalConv3d (temporal.py:252-273), bias=False."""
        self.conv3d(f'{t}.conv', f)
        self.bn(f'{t}.norm', f'{f}/Norm_0')

    def temporal_block(self, t: str, f: str, in_ch: int, out_ch: int,
                       pyramid: bool, n_pool: int) -> None:
        """reference TemporalBlock (temporal.py:426-489)."""
        self.conv1x1x1_na(f'{t}.convolution_paths.0.0', f'{f}/Conv1x1x1NormActivated_0')
        self.causal_conv3d(f'{t}.convolution_paths.0.1', f'{f}/CausalConv3d_0')
        self.conv1x1x1_na(f'{t}.convolution_paths.1.0', f'{f}/Conv1x1x1NormActivated_1')
        self.causal_conv3d(f'{t}.convolution_paths.1.1', f'{f}/CausalConv3d_1')
        self.conv1x1x1_na(f'{t}.convolution_paths.2', f'{f}/Conv1x1x1NormActivated_2')
        if pyramid:
            for j in range(n_pool):
                self.conv1x1x1_na(
                    f'{t}.pyramid_pooling.features.{j}.conv_bn_relu',
                    f'{f}/PyramidSpatioTemporalPooling_0/Conv1x1x1NormActivated_{j}')
        self.conv1x1x1_na(f'{t}.aggregation.0', f'{f}/Conv1x1x1NormActivated_3')
        if out_ch != in_ch:
            self.dense_1x1x1(f'{t}.projection.0', f'{f}/Dense_0')
            self.bn(f'{t}.projection.1', f'{f}/Norm_0')

    def bottleneck3d(self, t: str, f: str, in_ch: int, out_ch: int) -> None:
        """reference Bottleneck3D (temporal.py:328-372)."""
        self.conv1x1x1_na(f'{t}.layers.conv_down_project', f'{f}/Conv1x1x1NormActivated_0')
        self.causal_conv3d(f'{t}.layers.conv', f'{f}/CausalConv3d_0')
        self.conv1x1x1_na(f'{t}.layers.conv_up_project', f'{f}/Conv1x1x1NormActivated_1')
        if out_ch != in_ch:
            self.dense_1x1x1(f'{t}.projection.0', f'{f}/Dense_0')
            self.bn(f'{t}.projection.1', f'{f}/Norm_0')

    def spatial_gru(self, t: str, f: str) -> None:
        """reference SpatialGRU (temporal.py:11-57)."""
        self.gru_gates(f'{t}.conv_update', f'{t}.conv_reset', f'{f}/cell/gates')
        self.conv(f'{t}.conv_state_tilde', f'{f}/cell/candidate', bias=True)
        self.conv(f'{t}.conv_decoder', f'{f}/decoder')

    def dual_gru(self, t: str, f: str, hidden: int) -> None:
        """reference Dual_GRU (temporal.py:59-160)."""
        self.gru_gates(f'{t}.conv_update_1', f'{t}.conv_reset_1', f'{f}/cell1/gates')
        self.conv(f'{t}.conv_state_tilde_1', f'{f}/cell1/candidate', bias=True)
        self.gru_gates(f'{t}.conv_update_2', f'{t}.conv_reset_2', f'{f}/cell2/gates')
        self.conv(f'{t}.conv_state_tilde_2', f'{f}/cell2/candidate', bias=True)
        self.conv(f'{t}.conv_decoder_2', f'{f}/decoder2', bias=True)
        self.bottleblock(f'{t}.trusting_gate.0', f'{f}/Bottleblock_0',
                         in_ch=2 * hidden, out_ch=hidden)
        self.conv(f'{t}.trusting_gate.1', f'{f}/Conv_0')

    def mbconv(self, t: str, f: str, expand: int) -> None:
        """efficientnet_pytorch MBConvBlock state keys (_expand_conv absent
        when expand_ratio == 1, as in the first stage)."""
        ci = 0
        if expand != 1:
            self.conv(f'{t}._expand_conv', f'{f}/Conv_0')
            self.bn(f'{t}._bn0', f'{f}/Norm_0')
            ci = 1
        self.conv(f'{t}._depthwise_conv', f'{f}/Conv_{ci}')
        self.bn(f'{t}._bn1', f'{f}/Norm_{ci}')
        self.conv(f'{t}._se_reduce', f'{f}/SqueezeExcite_0/Conv_0', bias=True)
        self.conv(f'{t}._se_expand', f'{f}/SqueezeExcite_0/Conv_1', bias=True)
        self.conv(f'{t}._project_conv', f'{f}/Conv_{ci + 1}')
        self.bn(f'{t}._bn2', f'{f}/Norm_{ci + 1}')

    def efficientnet(self, t: str, f: str, arch: str) -> None:
        self.conv(f'{t}._conv_stem', f'{f}/Conv_0')
        self.bn(f'{t}._bn0', f'{f}/Norm_0')
        for i, (k, s, e, ci, co, se) in enumerate(block_plan(arch)):
            self.mbconv(f'{t}._blocks.{i}', f'{f}/MBConv_{i}', expand=e)

    def basic_block(self, t: str, f: str, downsample: bool) -> None:
        """torchvision resnet18 BasicBlock."""
        self.conv(f'{t}.conv1', f'{f}/Conv_0')
        self.bn(f'{t}.bn1', f'{f}/Norm_0')
        self.conv(f'{t}.conv2', f'{f}/Conv_1')
        self.bn(f'{t}.bn2', f'{f}/Norm_1')
        if downsample:
            self.conv(f'{t}.downsample.0', f'{f}/Conv_2')
            self.bn(f'{t}.downsample.1', f'{f}/Norm_2')

    def head(self, t: str, f: str) -> None:
        """reference decoder head Sequential [conv3x3, BN, ReLU, conv1x1]
        (decoder.py:37-89)."""
        self.conv(f'{t}.0', f'{f}/Conv_0')
        self.bn(f'{t}.1', f'{f}/Norm_0')
        self.conv(f'{t}.3', f'{f}/Conv_1', bias=True)


def build_mapping(cfg) -> List[Entry]:
    """The whole STP3 mapping for a ``models.stp3.STP3Config``."""
    b = Mapper()
    c = cfg

    # ---- encoder (reference stp3/models/encoder.py:18-35)
    b.efficientnet('model.encoder.backbone', 'encoder/EfficientNetFeatures_0', c.encoder_name)
    b.deeplab_head('model.encoder.feature_layer_1', 'encoder/DeepLabHead_0')
    b.upsampling_concat('model.encoder.feature_layer_2', 'encoder/UpsamplingConcat_0')
    if c.use_depth_distribution:
        b.deeplab_head('model.encoder.depth_layer_1', 'encoder/DeepLabHead_1')
        b.upsampling_concat('model.encoder.depth_layer_2', 'encoder/UpsamplingConcat_1')

    # ---- temporal model (reference stp3/models/temporal_model.py:22-48)
    if c.temporal_name == 'temporal_block':
        seq, b3d = 0, 0
        in_ch, out_ch = c.temporal_in_channels, c.start_out_channels
        for layer in range(c.receptive_field - 1):
            b.temporal_block(f'model.temporal_model.model.{seq}',
                             f'temporal_model/TemporalBlock_{layer}',
                             in_ch=in_ch, out_ch=out_ch, pyramid=c.pyramid_pooling, n_pool=1)
            seq += 1
            for _ in range(c.inbetween_layers):
                b.bottleneck3d(f'model.temporal_model.model.{seq}',
                               f'temporal_model/Bottleneck3D_{b3d}', in_ch=out_ch, out_ch=out_ch)
                seq += 1
                b3d += 1
            in_ch = out_ch
            out_ch += c.extra_in_channels
        b.deeplab_head('model.temporal_model.final_conv', 'temporal_model/DeepLabHead_0')

    fut_ch = c.future_pred_in_channels

    # ---- distribution (reference stp3/models/distributions.py:15-33)
    if c.n_future > 0 and c.probabilistic:
        t, f = 'model.present_distribution', 'present_distribution'
        if c.prob_method in ('GAUSSIAN', 'MIXGAUSSIAN'):
            comp = fut_ch // 2
            chans = [(fut_ch, comp), (comp, comp), (comp, comp), (comp, comp)]
            for i, (ci, co) in enumerate(chans):
                b.bottleneck2d(f'{t}.encoder.model.{i}',
                               f'{f}/DistributionEncoder_0/Bottleneck_{i}',
                               in_ch=ci, out_ch=co, downsample=True)
            b.conv(f'{t}.decoder.1', f'{f}/Conv_0', bias=True)
        elif c.prob_method == 'BERNOULLI':
            b.bottleneck2d(f'{t}.encoder.0', f'{f}/Bottleneck_0', in_ch=fut_ch,
                           out_ch=c.latent_dim)

    # ---- future prediction (reference stp3/models/future_prediction.py:13-26)
    if c.n_future > 0:
        t, f = 'model.future_prediction', 'future_prediction'
        b.dual_gru(f'{t}.dual_grus', f'{f}/DualGRU_0', hidden=fut_ch)
        cnx = 0
        for j in range(c.n_res_layers):
            b.convnext_block(f'{t}.res_blocks1.{j}', f'{f}/ConvNeXtBlock_{cnx}')
            cnx += 1
        for i in range(c.n_gru_blocks):
            b.spatial_gru(f'{t}.spatial_grus.{i}', f'{f}/SpatialGRU_{i}')
            if i < c.n_gru_blocks - 1:
                for j in range(c.n_res_layers):
                    b.convnext_block(f'{t}.res_blocks.{i}.{j}', f'{f}/ConvNeXtBlock_{cnx}')
                    cnx += 1
            else:
                b.deeplab_head(f'{t}.res_blocks.{i}', f'{f}/DeepLabHead_0')

    # ---- decoder (reference stp3/models/decoder.py:24-89)
    t, f = 'model.decoder', 'decoder'
    b.conv(f'{t}.first_conv', f'{f}/Conv_0')
    b.bn(f'{t}.bn1', f'{f}/Norm_0')
    for i, (layer, down) in enumerate((('layer1.0', False), ('layer1.1', False),
                                       ('layer2.0', True), ('layer2.1', False),
                                       ('layer3.0', True), ('layer3.1', False))):
        b.basic_block(f'{t}.{layer}', f'{f}/BasicBlock_{i}', downsample=down)
    for i, name in enumerate(('up3_skip', 'up2_skip', 'up1_skip')):
        b.upsampling_add(f'{t}.{name}', f'{f}/UpsamplingAdd_{i}')
    heads = [('segmentation_head', True), ('pedestrian_head', c.predict_pedestrian),
             ('hdmap_head', c.perceive_hdmap), ('instance_offset_head', c.predict_instance),
             ('instance_center_head', c.predict_instance),
             ('instance_future_head', c.predict_future_flow),
             ('costvolume_head', c.planning_enabled)]
    for name, enabled in heads:
        if enabled:
            b.head(f'{t}.{name}', f'{f}/{name}')

    # ---- planner (reference stp3/models/planning_model.py:13-31)
    if c.planning_enabled:
        t, f = 'model.planning', 'planner'
        fc = c.encoder_out_channels
        chans = [(fc, fc, True), (fc, fc // 2, True),
                 (fc // 2, fc // 2, True), (fc // 2, fc // 8, False)]
        for i, (ci, co, down) in enumerate(chans):
            b.bottleneck2d(f'{t}.reduce_channel.{i}', f'{f}/reduce_channel_{i}',
                           in_ch=ci, out_ch=co, downsample=down)
        b.torch_gru_cell(f'{t}.GRU', f'{f}/gru')
        b.dense(f'{t}.decoder.0', f'{f}/decoder_fc1')
        b.dense(f'{t}.decoder.2', f'{f}/decoder_fc2')

    # ---- uncertainty log-variances (reference stp3/trainer.py:42-97)
    weights = [('segmentation', True), ('pedestrian', c.predict_pedestrian),
               ('hdmap', c.perceive_hdmap), ('depths', c.gt_depth),
               ('centerness', c.predict_instance), ('offset', c.predict_instance),
               ('flow', c.predict_future_flow), ('planning', c.planning_enabled)]
    for name, enabled in weights:
        if enabled:
            b.scalar(f'model.{name}_weight', f'{name}_weight')

    return b.entries


# --------------------------------------------------------------------------
# tree helpers
# --------------------------------------------------------------------------


def _get(tree: Params, path: str) -> Array:
    for key in path.split('/'):
        tree = tree[key]
    return np.asarray(tree)


# keys that exist in reference checkpoints but carry no learnable content:
# constant grid buffers (stp3.py:23-25,111-130), cost-function constants
# (cost.py:57-58,204), BN bookkeeping, and Lightning-side loss / metric state
_IGNORED_SUBSTRINGS = (
    'num_batches_tracked',
    'model.bev_resolution', 'model.bev_start_position', 'model.bev_dimension',
    'model.frustum',
    'model.planning.cost_function.',
)


def _is_ignored(key: str) -> bool:
    if not key.startswith('model.'):
        return True
    return any(s in key for s in _IGNORED_SUBSTRINGS)


@dataclasses.dataclass
class ImportReport:
    converted: int
    ignored: List[str]
    missing: List[str]          # expected torch keys absent from the state_dict
    unexpected: List[str]       # model.* keys the mapping does not know

    def ok(self) -> bool:
        return not self.missing and not self.unexpected


def _convert_entries(sd: StateDict, entries: Sequence[Entry]):
    """Apply mapping entries to a numpy state_dict. Returns
    (params, consumed keys, missing keys, number of leaves converted)."""
    flat: Dict[str, Array] = {}
    consumed = set()
    missing: List[str] = []
    for e in entries:
        if any(k not in sd for k in e.torch_keys):
            missing.extend(k for k in e.torch_keys if k not in sd)
            continue
        for path, v in zip(e.flax_paths, e.imp([sd[k] for k in e.torch_keys])):
            flat[path] = np.asarray(v, np.float32)
        consumed.update(e.torch_keys)
    return unflatten_tree(flat), consumed, missing, len(flat)


def _mismatch(what: str, report: ImportReport) -> ValueError:
    return ValueError(f'{what} mismatch: missing={report.missing[:10]} '
                      f'({len(report.missing)} total), unexpected={report.unexpected[:10]} '
                      f'({len(report.unexpected)} total)')


def import_state_dict(sd: Dict[str, object], cfg, *,
                      strict: bool = True) -> Tuple[Params, ImportReport]:
    """Reference state_dict -> flax-path param tree of a 'bn_frozen' model.

    ``sd`` values may be torch tensors or numpy arrays; a Lightning
    checkpoint is unwrapped to its ``state_dict`` first
    (``load_reference_checkpoint``)."""
    sd = {k: _to_np(v) for k, v in sd.items()}
    params, consumed, missing, n = _convert_entries(sd, build_mapping(cfg))
    ignored = [k for k in sd if k not in consumed and _is_ignored(k)]
    unexpected = [k for k in sd if k not in consumed and not _is_ignored(k)]
    report = ImportReport(n, sorted(ignored), sorted(missing), sorted(unexpected))
    if strict and not report.ok():
        raise _mismatch('torch import', report)
    return params, report


def import_backbone_state_dict(sd: Dict[str, object], arch: str, *,
                               strict: bool = True) -> Tuple[Params, ImportReport]:
    """A bare efficientnet-pytorch ImageNet state_dict -> the encoder trunk
    subtree ``{'EfficientNetFeatures_0': ...}`` ('bn_frozen' Norms carrying
    the ImageNet running statistics), truncated at the stride-8 endpoint as
    the reference deletes blocks (stp3/models/encoder.py:18,39-55). The
    classifier keys (``_conv_head``, ``_bn1``, ``_fc``) and the blocks past
    the truncation index are expected and ignored. Merge the subtree into
    a whole model's tree with ``merge_backbone``."""
    sd = {k: _to_np(v) for k, v in sd.items()}
    prefixed = {f'backbone.{k}': v for k, v in sd.items()}
    b = Mapper()
    b.efficientnet('backbone', 'EfficientNetFeatures_0', arch)
    params, consumed, missing, n = _convert_entries(prefixed, b.entries)
    missing = [k[len('backbone.'):] for k in missing]
    trunc = _TRUNCATE_IDX[arch]

    def _backbone_ignored(key: str) -> bool:
        if 'num_batches_tracked' in key or key.startswith(('_conv_head.', '_bn1.', '_fc.')):
            return True
        return key.startswith('_blocks.') and int(key.split('.')[1]) > trunc

    rest = [k for k in sd if f'backbone.{k}' not in consumed]
    ignored = [k for k in rest if _backbone_ignored(k)]
    unexpected = [k for k in rest if not _backbone_ignored(k)]
    report = ImportReport(n, sorted(ignored), sorted(missing), sorted(unexpected))
    if strict and not report.ok():
        raise _mismatch('backbone import', report)
    return params, report


def merge_backbone(params: Params, backbone: Params) -> Params:
    """``params`` (a whole STP3 flax-path tree) with its encoder trunk
    replaced by ``backbone`` (``import_backbone_state_dict``'s subtree).
    Raises ValueError unless the two trunks have the same leaves and
    shapes, so an efficientnet-b0 / b4 or norm-kind mismatch fails here
    and not at load time."""
    sub = backbone['EfficientNetFeatures_0']
    cur = {k: np.shape(v) for k, v in
           flatten_tree(params['encoder']['EfficientNetFeatures_0']).items()}
    new = {k: np.shape(v) for k, v in flatten_tree(sub).items()}
    if cur != new:
        only_cur = sorted(set(cur) - set(new))[:5]
        only_new = sorted(set(new) - set(cur))[:5]
        shape = sorted(k for k in cur if k in new and cur[k] != new[k])[:5]
        raise ValueError('backbone subtree does not match the model: '
                         f'missing={only_cur} extra={only_new} shape={shape}')
    out = dict(params)
    out['encoder'] = {**out['encoder'], 'EfficientNetFeatures_0': sub}
    return out


def export_state_dict(params: Params, cfg) -> StateDict:
    """Flax-path param tree -> reference-format state_dict (numpy)."""
    sd: StateDict = {}
    for e in build_mapping(cfg):
        for k, v in zip(e.torch_keys, e.exp([_get(params, p) for p in e.flax_paths])):
            sd[k] = np.asarray(v, np.float32)
    return sd


def _to_np(v) -> Array:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def synthesize_state_dict(cfg, seed: int = 0) -> StateDict:
    """A reference-format state_dict with the right keys and shapes for
    ``cfg`` (a ``models.stp3.STP3Config``): the seeded init of this
    package's STP3 under 'bn_frozen', exported. For tests and the chip
    smoke, where no reference checkpoint exists."""
    model = init_parameters(STP3(dataclasses.replace(cfg, norm='bn_frozen')),
                            torch.Generator().manual_seed(seed))
    return export_state_dict(to_flax(model)['params'], cfg)


def apply_cam_front_parity(cfg) -> bool:
    """Set PLANNING.CAM_FRONT_PARITY for an imported REFERENCE checkpoint
    whose rig puts the front camera somewhere other than index 1 (CARLA:
    front, left, right, rear). The reference hardcodes cam_front_index=1
    (reference stp3.py:203), on the CARLA rig the LEFT camera, so its
    planner was trained on that camera's feature; feeding the true front
    camera instead would be a train / serve shift. Mutates ``cfg``;
    returns True if the flag was newly set. See PARITY.md."""
    if not cfg.PLANNING.ENABLED or cfg.PLANNING.get('CAM_FRONT_PARITY', False):
        return False
    if _cam_front_index(cfg.IMAGE.NAMES) != 1:
        cfg.PLANNING.CAM_FRONT_PARITY = True
        return True
    return False


def load_reference_blob(path: str):
    """``torch.load`` of a Lightning .ckpt or a raw state_dict, with
    ``weights_only=True``: tensors, containers and plain values only. A
    file that pickles a class (a Lightning ``AttributeDict`` as
    ``hyper_parameters``) is refused with a ValueError that says how to
    get past it."""
    try:
        return torch.load(path, map_location='cpu', weights_only=True)
    except pickle.UnpicklingError as err:
        raise ValueError(
            f'{path} pickles objects that torch.load(weights_only=True) refuses (a Lightning '
            f'checkpoint keeps its hyper_parameters as an AttributeDict). Save its '
            f'state_dict alone where Lightning is installed (torch.save(torch.load(path, '
            f'weights_only=False)["state_dict"], out)) and import that file with '
            f'--config-file and KEY VALUE overrides in place of the hyper_parameters') from err


def reference_state_dict(blob) -> StateDict:
    """The numpy state_dict of a loaded .ckpt (its ``state_dict``) or of a
    raw state_dict."""
    sd = blob.get('state_dict', blob) if isinstance(blob, dict) else blob
    return {k: _to_np(v) for k, v in sd.items()}


def load_reference_checkpoint(path: str) -> StateDict:
    """A Lightning .ckpt (or raw torch state_dict) as numpy arrays."""
    return reference_state_dict(load_reference_blob(path))


def filter_decoder(params: Params) -> Params:
    """Curriculum warm-start filter: drop the decoder (the reference loads
    the previous stage without its 'decoder' keys, train.py:21-29)."""
    return {k: v for k, v in params.items() if k != 'decoder'}
