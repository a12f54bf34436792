"""Weight interchange of the port (stp3_tpu_torch/utils/torch_import.py,
utils/from_flax.to_flax and the three stp3_tpu_torch.scripts CLIs)
against stp3_tpu's converter and against real torch.nn layers, on the CPU.

The reference-format state dicts are made from a seed
(chip_smoke.reference_state_dict: the port's synthesize_state_dict with
the BN statistics and every constant vector redrawn), so a swapped mean
and variance, a transposed kernel or a misplaced bias changes the
outputs. Tolerances: the layers against torch.nn at atol 1e-5 (rtol 1e-4
for the conv3d + BN stack, tests/test_torch_import.py's), the whole
model's heads at atol 2e-3 / rtol 1e-3 (tests/test_torch_model.py's
precedent: reassociation through a ~60-conv stack); every tree, state
dict and layout transform bit for bit.
"""
import argparse
import json
import os

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from stp3_tpu.config import get_cfg as jax_get_cfg
from stp3_tpu.models.stp3 import STP3 as JSTP3
from stp3_tpu.models.stp3 import STP3Config as JCfg
from stp3_tpu.utils import torch_import as jti
from stp3_tpu_torch.config import CfgNode, get_cfg
from stp3_tpu_torch.layers.base import Conv2d, ConvTranspose2d, Dense, Norm, init_parameters
from stp3_tpu_torch.layers.temporal import CausalConv3d, Conv1x1x1NormActivated, ConvGRUCell
from stp3_tpu_torch.models.efficientnet import _TRUNCATE_IDX
from stp3_tpu_torch.models.planning_model import GRUCell
from stp3_tpu_torch.models.stp3 import STP3, STP3Config
from stp3_tpu_torch.scripts import export_torch_checkpoint, import_backbone
from stp3_tpu_torch.scripts import import_torch_checkpoint
from stp3_tpu_torch.training import checkpoint as ckpt_lib
from stp3_tpu_torch.training.checkpoint import filter_warm_start_params
from stp3_tpu_torch.utils import torch_import as ti
from stp3_tpu_torch.utils.from_flax import (flatten_tree, load_flax_params,
                                            load_flax_variables, to_flax)
from torch_jax_steps import (assert_outputs_close, inputs_of, jax_forwards,
                             jax_norm_defaults, run_once, seeded_variables, to_numpy)

torch.set_num_threads(2)
assert jax_norm_defaults            # the autouse fixture, imported to take effect here

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGE_YAMLS = ('nuscenes/Perception.yml', 'nuscenes/Prediction.yml',
               'nuscenes/Prediction_Ber.yml', 'nuscenes/Planning.yml', 'carla/Perception.yml',
               'carla/Prediction.yml', 'carla/Planning.yml')
BN_FROZEN = {'MODEL': {'NORM': 'bn_frozen'}}
TINY_FP32 = {**chip_smoke.TINY_WIDTHS, 'PRECISION': 32}


def flat_equal(got, want):
    """Two nested trees of arrays: the same leaves, each bit for bit."""
    got, want = flatten_tree(got), flatten_tree(want)
    assert sorted(got) == sorted(want), sorted(set(got) ^ set(want))[:5]
    for key, w in want.items():
        assert got[key].dtype == w.dtype and got[key].shape == w.shape, key
        np.testing.assert_array_equal(got[key], w, err_msg=key)


def stage_cfg(stage):
    """A stage's tiny fp32 config under 'bn_frozen' at a receptive field of 2."""
    if stage == 'planning':
        return chip_smoke.make_cfg(chip_smoke.PLANNING_STAGE, TINY_FP32, BN_FROZEN)
    return chip_smoke.stage_cfg(stage, True, {'TIME_RECEPTIVE_FIELD': 2}, BN_FROZEN)


def jax_cfg(cfg):
    """The JAX package's STP3Config of the port's config (this also sets its
    process-wide norm kind)."""
    return JCfg.from_cfg(jax_get_cfg(cfg_dict=cfg.convert_to_dict()))


# ------------------------------------------------------------------ mapping
@pytest.mark.parametrize('yaml_path', STAGE_YAMLS)
def test_build_mapping_matches_jax(yaml_path):
    """The (torch keys, flax paths) list of every stage YAML, at the tiny
    widths under 'bn_frozen', equals stp3_tpu's, entry for entry."""
    args = argparse.Namespace(config_file=os.path.join(REPO, 'stp3_tpu', 'configs', yaml_path),
                              opts=[])
    cfg = get_cfg(args)
    for override in (TINY_FP32, BN_FROZEN):
        cfg.merge_from_other_cfg(CfgNode(override))
    got = [(e.torch_keys, e.flax_paths) for e in ti.build_mapping(STP3Config.from_cfg(cfg))]
    want = [(e.torch_keys, e.flax_paths) for e in jti.build_mapping(jax_cfg(cfg))]
    assert got == want
    assert len(got) > 200


LEAF_PAIRS = {
    'conv': (ti._t_conv, ti._t_conv_inv, (6, 4, 3, 5)),
    'conv3d': (ti._t_conv3d, ti._t_conv3d_inv, (6, 4, 2, 3, 5)),
    'convT': (ti._t_convT, ti._t_convT_inv, (6, 4, 3, 3)),
    'linear': (ti._t_linear, ti._t_linear, (5, 7)),
    'dense_1x1x1': (ti._t_dense_from_1x1x1, ti._t_dense_to_1x1x1, (5, 7, 1, 1, 1)),
    # the port modules' flax layout <-> torch layout (from_flax / to_flax)
    'Conv2d': (Conv2d(4, 6, 3).to_flax_leaf, Conv2d(4, 6, 3).flax_leaf, (6, 4, 3, 5)),
    'Conv2d depthwise': (Conv2d(6, 6, 3, groups=6).to_flax_leaf,
                         Conv2d(6, 6, 3, groups=6).flax_leaf, (6, 1, 3, 3)),
    'ConvTranspose2d': (ConvTranspose2d(4, 6, 3, transpose_kernel=True).to_flax_leaf,
                        ConvTranspose2d(4, 6, 3, transpose_kernel=True).flax_leaf,
                        (4, 6, 3, 3)),
    'ConvTranspose2d flipped': (ConvTranspose2d(4, 6, 3).to_flax_leaf,
                                ConvTranspose2d(4, 6, 3).flax_leaf, (4, 6, 3, 3)),
    'Dense': (Dense(7, 5).to_flax_leaf, Dense(7, 5).flax_leaf, (5, 7)),
    'CausalConv3d': (CausalConv3d(4, 6).to_flax_leaf, CausalConv3d(4, 6).flax_leaf,
                     (6, 4, 2, 3, 3)),
}


@pytest.mark.parametrize('name', sorted(LEAF_PAIRS))
def test_leaf_transforms_are_exact_inverses(name):
    fwd, inv, shape = LEAF_PAIRS[name]
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    np.testing.assert_array_equal(inv('kernel', fwd('kernel', x)) if name[0].isupper()
                                  else inv(fwd(x)), x)
    y = fwd('kernel', x) if name[0].isupper() else fwd(x)
    np.testing.assert_array_equal(fwd('kernel', inv('kernel', y)) if name[0].isupper()
                                  else fwd(inv(y)), y)
    if name[0].isupper() and name != 'CausalConv3d':   # (its only leaf is the kernel)
        # biases and the like pass as they are
        b = x.reshape(-1)[:6]
        assert fwd('bias', b) is b and inv('bias', b) is b


# ---------------------------------------------------- layers against torch.nn
def _randomise_bn(bn, gen):
    with torch.no_grad():
        bn.running_mean.copy_(torch.randn(bn.num_features, generator=gen))
        bn.running_var.copy_(torch.rand(bn.num_features, generator=gen) + 0.5)
        bn.weight.copy_(torch.randn(bn.num_features, generator=gen))
        bn.bias.copy_(torch.randn(bn.num_features, generator=gen))
    return bn.eval()


def _convert(build, sd):
    """The reference ``sd`` through the mapping entries ``build`` adds
    (torch prefix 't', flax prefix 'm'): the flax subtree 'm'."""
    b = ti.Mapper()
    build(b)
    params, consumed, missing, _ = ti._convert_entries(
        {k: v.detach().numpy() for k, v in sd.items()}, b.entries)
    assert not missing
    return params['m'], b.entries


def _layer_case(name, gen):
    """(reference torch.nn module(s) as one callable, its state_dict under
    prefix 't', the mapping, the port module, inputs) of a layer kind."""
    tnn = torch.nn
    if name == 'conv2d stride 2':
        ref = tnn.Conv2d(5, 6, 3, stride=2, padding=1)
        port = Conv2d(5, 6, 3, stride=2, padding=((1, 1), (1, 1)))
        return ref, ref, lambda b: b.conv('t', 'm', bias=True), port, (torch.randn(2, 5, 7, 9),)
    if name == 'depthwise conv':
        ref = tnn.Conv2d(6, 6, 5, padding=2, groups=6, bias=False)
        port = Conv2d(6, 6, 5, padding=((2, 2), (2, 2)), groups=6, bias=False)
        return ref, ref, lambda b: b.conv('t', 'm'), port, (torch.randn(2, 6, 8, 7),)
    if name == 'transposed conv':
        ref = tnn.ConvTranspose2d(6, 3, 3, stride=2, padding=1, output_padding=1, bias=False)
        port = ConvTranspose2d(6, 3, 3, stride=2, padding=((1, 2), (1, 2)), bias=False,
                               transpose_kernel=True)
        return ref, ref, lambda b: b.convT('t', 'm'), port, (torch.randn(2, 6, 9, 11),)
    if name == 'batchnorm':
        ref = _randomise_bn(tnn.BatchNorm2d(10, eps=1e-3), gen)
        return ref, ref, lambda b: b.bn('t', 'm'), Norm(10, 'bn_frozen', eps=1e-3), (
            torch.randn(2, 10, 4, 5),)
    if name == 'causal conv3d + BN':
        conv = tnn.Conv3d(3, 5, (2, 3, 3), bias=False)
        bn = _randomise_bn(tnn.BatchNorm3d(5), gen)
        seq = tnn.ModuleDict({'conv': conv, 'norm': bn})

        def ref(x):     # left-padded in time (reference temporal.py:252-273)
            return torch.relu(bn(conv(torch.nn.functional.pad(x, (1, 1, 1, 1, 1, 0)))))
        return ref, seq, lambda b: b.causal_conv3d('t', 'm'), CausalConv3d(
            3, 5, norm='bn_frozen').nchw, (torch.randn(2, 3, 4, 6, 7),)
    if name == 'conv 1x1x1 + BN':
        conv = tnn.Conv3d(4, 6, 1, bias=False)
        bn = _randomise_bn(tnn.BatchNorm3d(6), gen)
        seq = tnn.ModuleDict({'conv': conv, 'norm': bn})
        return (lambda x: torch.relu(bn(conv(x)))), seq, lambda b: b.conv1x1x1_na('t', 'm'), \
            Conv1x1x1NormActivated(4, 6, 'bn_frozen').nchw, (torch.randn(2, 4, 3, 5, 6),)
    if name == 'linear':
        ref = tnn.Linear(7, 5)
        return ref, ref, lambda b: b.dense('t', 'm'), Dense(7, 5), (torch.randn(3, 7),)
    if name == 'GRUCell':
        ref = tnn.GRUCell(6, 16)
        with torch.no_grad():       # torch's init draws biases; make the r / z fold matter
            ref.bias_hh.add_(torch.randn(48, generator=gen))
        # torch's GRUCell(x, h); the flax-layout cell takes (h, x)
        port = GRUCell(6, 16)
        return ref, ref, lambda b: b.torch_gru_cell('t', 'm'), (
            lambda x, h: port(h, x)), (torch.randn(3, 6), torch.randn(3, 16)), port
    if name == 'ConvGRU gates':
        cin, ch = 4, 8
        mods = tnn.ModuleDict({k: tnn.Conv2d(cin + ch, ch, 3, padding=1)
                               for k in ('u', 'r', 'c')})

        def ref(x, s):   # reference gru_cell, stp3/layers/temporal.py:44-57
            xs = torch.cat([x, s], 1)
            upd, rst = torch.sigmoid(mods['u'](xs)), torch.sigmoid(mods['r'](xs))
            tilde = mods['c'](torch.cat([x, (1.0 - rst) * s], 1))
            return (1.0 - upd) * s + upd * tilde

        def build(b):
            b.gru_gates('t.u', 't.r', 'm/gates')
            b.conv('t.c', 'm/candidate', bias=True)
        return ref, mods, build, ConvGRUCell(cin, ch).nchw, (torch.randn(2, cin, 6, 7),
                                                             torch.randn(2, ch, 6, 7))
    raise KeyError(name)


LAYERS = ('conv2d stride 2', 'depthwise conv', 'transposed conv', 'batchnorm',
          'causal conv3d + BN', 'conv 1x1x1 + BN', 'linear', 'GRUCell', 'ConvGRU gates')


@pytest.mark.parametrize('name', LAYERS)
def test_imported_layer_matches_torch_nn(name):
    """A real torch.nn layer's weights through the mapping into the port's
    layer: the same outputs; and exported back from the port's layer, the
    same tensors (the GRUCell's r / z biases as their fold)."""
    gen = torch.Generator().manual_seed(LAYERS.index(name))
    torch.manual_seed(LAYERS.index(name))
    ref, owner, build, port, inputs, *module = _layer_case(name, gen)
    sd = {f't.{k}': v for k, v in owner.state_dict().items()}
    tree, entries = _convert(build, sd)
    port_module = module[0] if module else getattr(port, '__self__', port)
    load_flax_params(port_module, tree)
    with torch.no_grad():
        want, got = ref(*inputs), port(*inputs)
    tol = dict(rtol=1e-4, atol=1e-4) if 'conv3d' in name else dict(rtol=0, atol=1e-5)
    torch.testing.assert_close(got, want, **tol)

    exported = {}
    back = {'m': to_flax(port_module)['params']}
    for e in entries:
        exported.update(zip(e.torch_keys, e.exp([ti._get(back, p) for p in e.flax_paths])))
    want_sd = {k: v.numpy() for k, v in sd.items() if k in exported}
    if name == 'GRUCell':
        want_sd['t.bias_ih'], want_sd['t.bias_hh'] = chip_smoke.gru_fold(want_sd, 't')
    assert sorted(exported) == sorted(want_sd)
    for k, v in want_sd.items():
        np.testing.assert_array_equal(exported[k], v, err_msg=k)


# ------------------------------------------------------------- whole model
def _jax_outputs(cfg, jmc, params, inputs, ex):
    """The JAX model's eval forward and, with a planner, its plan on its own
    outputs: one program. Returns (outputs, plan arguments, trajectory)."""
    jm = JSTP3(jmc)
    out, _ = jax_forwards(jm, {'params': params}, inputs)
    if not jmc.planning_enabled:
        return out, None, None
    rf = cfg.TIME_RECEPTIVE_FIELD
    occ = np.logical_or(out['segmentation'].argmax(-1),
                        out['pedestrian'].argmax(-1)).astype(np.float32)[:, rf:]
    args = [out['cam_front'], ex['trajs'], ex['gt_trajs'], out['costvolume'][:, rf:], occ,
            out['hdmap'], np.array([1], np.int32), ex['target_points']]
    _, traj = run_once(lambda p, *a: jm.apply({'params': p}, *a, train=False,
                                              method=JSTP3.plan), params, *args)
    return out, args, np.asarray(traj)


@pytest.mark.parametrize('stage', ['planning', 'prediction', 'perception'])
def test_imported_reference_state_dict_matches_jax(stage):
    """The same seeded reference state dict imported by stp3_tpu (then
    flax apply) and by the port (then STP3): the same tree bit for bit,
    every head at atol 2e-3 / rtol 1e-3, and the planner's refined
    trajectory on the same arguments."""
    cfg = stage_cfg(stage)
    mcfg = STP3Config.from_cfg(cfg)
    sd = chip_smoke.reference_state_dict(mcfg, seed=1)
    params, report = ti.import_state_dict(sd, mcfg)
    assert report.ok() and report.converted == len(flatten_tree(params))
    jmc = jax_cfg(cfg)
    jparams, jreport = jti.import_state_dict(sd, jmc)
    assert vars(report) == vars(jreport)
    flat_equal(params, jparams)

    inputs = inputs_of(cfg, b=1)
    _, ex = chip_smoke.example_inputs(cfg)
    out_j, plan_args, traj_j = _jax_outputs(cfg, jmc, jparams, inputs, ex)
    model = load_flax_params(STP3(mcfg), params).eval()
    with torch.no_grad():
        out_t = model(*[torch.from_numpy(a) for a in inputs])
        assert_outputs_close(to_numpy(out_t), out_j)
        if traj_j is not None:
            _, traj_t = model.plan(*[torch.tensor(np.asarray(a)) for a in plan_args])
            np.testing.assert_allclose(traj_t.numpy(), traj_j, atol=2e-3, rtol=1e-3)


def test_export_matches_jax_and_gives_back_the_input():
    """On the same flax tree the port's export equals stp3_tpu's bit for bit
    (keys, dtypes, values); a port module's export, export_state_dict of
    to_flax(module), gives back the imported state dict (the planner
    GRU's r / z biases as their fold)."""
    cfg = stage_cfg('planning')
    mcfg = STP3Config.from_cfg(cfg)
    sd = chip_smoke.reference_state_dict(mcfg, seed=2)
    params, _ = ti.import_state_dict(sd, mcfg)
    got, want = ti.export_state_dict(params, mcfg), jti.export_state_dict(params, jax_cfg(cfg))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    model = load_flax_params(STP3(mcfg), params)
    back = ti.export_state_dict(to_flax(model)['params'], mcfg)
    expected = dict(sd)
    gru = 'model.planning.GRU'
    expected[f'{gru}.bias_ih'], expected[f'{gru}.bias_hh'] = chip_smoke.gru_fold(sd, gru)
    assert not np.array_equal(expected[f'{gru}.bias_hh'], sd[f'{gru}.bias_hh'])
    assert sorted(back) == sorted(expected)
    for k, v in expected.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize('norm', ['bn_frozen', 'bn', 'gn'])
def test_to_flax_inverts_the_load(norm):
    """to_flax(load_flax_variables(m, v)) == v bit for bit: 'params' and,
    under 'bn', 'batch_stats'."""
    cfg = chip_smoke.make_cfg(chip_smoke.PLANNING_STAGE, TINY_FP32, {'MODEL': {'NORM': norm}})
    inputs, ex = chip_smoke.example_inputs(cfg)
    jm = JSTP3(jax_cfg(cfg))
    extras = {k: ex[k] for k in ('trajs', 'gt_trajs', 'commands', 'target_points')}
    variables = seeded_variables(jm, [np.asarray(a) for a in inputs], seed=3, extras=extras)
    assert ('batch_stats' in variables) == (norm == 'bn')
    model = load_flax_variables(STP3(STP3Config.from_cfg(cfg)), variables)
    back = to_flax(model)
    assert sorted(back) == sorted(variables)
    for collection in variables:
        flat_equal(back[collection], variables[collection])


# ----------------------------------------------------------------- backbone
@pytest.fixture(scope='module')
def oracle_class():
    import reference_oracle as ro
    ro.install()
    from efficientnet_pytorch import EfficientNet
    return EfficientNet


def _oracle_state_dict(oracle_class, arch, seed=0):
    import reference_oracle as ro
    net = oracle_class(arch)
    ro.randomize_(net, seed=seed)
    return {k: v.numpy() for k, v in net.state_dict().items()}


@pytest.mark.parametrize('arch', ['efficientnet-b0', 'efficientnet-b4'])
def test_backbone_import_matches_jax(oracle_class, arch):
    """An efficientnet-pytorch state dict (with the classifier and the
    blocks past the truncation) into the encoder trunk: the port's
    subtree and report equal stp3_tpu's; strict mode rejects a key the
    mapping does not know; merge_backbone refuses a trunk of another
    shape."""
    sd = _oracle_state_dict(oracle_class, arch)
    got, report = ti.import_backbone_state_dict(sd, arch)
    want, jreport = jti.import_backbone_state_dict(sd, arch)
    assert report.ok() and vars(report) == vars(jreport)
    assert any(k.startswith('_conv_head') for k in report.ignored)
    assert any(k.startswith(f'_blocks.{_TRUNCATE_IDX[arch] + 1}.') for k in report.ignored)
    flat_equal(got, want)
    with pytest.raises(ValueError, match='unexpected'):
        ti.import_backbone_state_dict({**sd, 'garbage.weight': np.zeros(3, np.float32)}, arch)
    _, loose = ti.import_backbone_state_dict({**sd, 'garbage.weight': np.zeros(3)}, arch,
                                             strict=False)
    assert loose.unexpected == ['garbage.weight']
    whole = {'encoder': {'EfficientNetFeatures_0': got['EfficientNetFeatures_0'], 'x': 1},
             'decoder': {}}
    merged = ti.merge_backbone(whole, got)
    assert merged['encoder']['x'] == 1
    other = 'efficientnet-b0' if arch == 'efficientnet-b4' else 'efficientnet-b4'
    with pytest.raises(ValueError, match='does not match'):
        ti.merge_backbone(whole, ti.import_backbone_state_dict(
            _oracle_state_dict(oracle_class, other), other)[0])


# --------------------------------------------------------------------- CLIs
def cli_cfg(*overrides):
    """The tiny Planning stage with the CLI paths' synthetic data, fp32."""
    return chip_smoke.make_cfg(chip_smoke.PLANNING_STAGE, chip_smoke.CLI_DATA, TINY_FP32,
                               *overrides)


@pytest.fixture(scope='module')
def imported(tmp_path_factory):
    """A reference .ckpt of the tiny Planning stage and its import by the CLI."""
    root = tmp_path_factory.mktemp('imported')
    cfg = cli_cfg()
    sd, bookkeeping = chip_smoke.write_reference_checkpoint(cfg, str(root / 'ref.ckpt'))
    lines = []
    path, report = import_torch_checkpoint.import_checkpoint(
        str(root / 'ref.ckpt'), str(root / 'ckpt'), log=lines.append)
    mcfg = STP3Config.from_cfg(get_cfg(cfg_dict=ckpt_lib.load_config_dict(path)))
    return dict(root=root, cfg=cfg, mcfg=mcfg, sd=sd, bookkeeping=bookkeeping, path=path,
                report=report, lines=lines)


def test_import_cli_then_evaluate(imported, capsys):
    """import_torch_checkpoint on a Lightning-style .ckpt whose
    hyper_parameters is a plain dict: an ok() report ignoring only the
    bookkeeping, a 'bn_frozen' checkpoint at step 0 holding the imported
    tree, no CAM_FRONT_PARITY on the nuScenes rig; then evaluate() on the
    CPU runs on it. The CLI's main gives the same checkpoint."""
    from stp3_tpu_torch.evaluate import evaluate
    report = imported['report']
    assert report.ok() and report.ignored == imported['bookkeeping']
    saved = ckpt_lib.load_config_dict(imported['path'])
    assert saved['MODEL']['NORM'] == 'bn_frozen' and not saved['PLANNING']['CAM_FRONT_PARITY']
    assert not any(line.startswith('NOTE') for line in imported['lines'])
    state = ckpt_lib.load_checkpoint(imported['path'])
    assert state['step'] == 0
    mcfg = imported['mcfg']
    assert mcfg.norm == 'bn_frozen'
    model = STP3(mcfg)
    model.load_state_dict(state['model'])
    flat_equal(to_flax(model)['params'], ti.import_state_dict(imported['sd'], mcfg)[0])

    again = import_torch_checkpoint.main(['--checkpoint', str(imported['root'] / 'ref.ckpt'),
                                          '--output', str(imported['root'] / 'cli')])
    assert 'converted' in capsys.readouterr().out
    for k, v in ckpt_lib.load_checkpoint(again)['model'].items():
        assert torch.equal(v, state['model'][k]), k

    results = evaluate(imported['path'], device='cpu', log=lambda msg: None)
    assert sorted(results) == sorted(chip_smoke.planning_result_keys(imported['cfg']))
    assert all(np.isfinite(v) for v in results.values())


def test_export_cli_round_trip(imported):
    """export_torch_checkpoint: the input's tensors bit for bit (the GRU's
    r / z biases as their fold), the grid constants and zeroed
    num_batches_tracked, hyper_parameters in the reference schema; the
    exported file re-imports to the same tree."""
    out = str(imported['root'] / 'exported.ckpt')
    export_torch_checkpoint.main(['--checkpoint', imported['path'], '--output', out])
    blob = torch.load(out, map_location='cpu', weights_only=True)
    chip_smoke.check_export(imported['sd'], imported['bookkeeping'], blob['state_dict'],
                            imported['cfg'])
    hp = blob['hyper_parameters']
    assert 'NORM' not in hp['MODEL'] and 'VAL_SAMPLES' not in hp['DATASET']
    mcfg = imported['mcfg']
    first, _ = ti.import_state_dict(imported['sd'], mcfg)
    again, report = ti.import_state_dict(ti.load_reference_checkpoint(out), mcfg)
    assert report.ok()
    flat_equal(again, first)
    no_decoder = ti.filter_decoder(again)     # the curriculum's warm-start filter
    assert 'decoder' not in no_decoder and sorted(no_decoder) == sorted(set(again) - {'decoder'})


def test_export_cli_folds_bn_and_refuses_gn(imported, tmp_path):
    """A 'bn' checkpoint exports as its 'bn_frozen' twin does; a 'gn' one
    cannot be expressed in the reference format and raises."""
    state = ckpt_lib.load_checkpoint(imported['path'])['model']
    outs = {}
    for norm in ('bn', 'bn_frozen'):
        cfg = cli_cfg({'MODEL': {'NORM': norm}})
        path = ckpt_lib.save_checkpoint(str(tmp_path / norm), 0, state,
                                        cfg_dict=cfg.convert_to_dict())
        outs[norm] = export_torch_checkpoint.export_checkpoint(
            path, str(tmp_path / f'{norm}.ckpt'), log=lambda msg: None)
    assert sorted(outs['bn']) == sorted(outs['bn_frozen'])
    for k, v in outs['bn_frozen'].items():
        assert torch.equal(outs['bn'][k], v), k
    gn = cli_cfg({'MODEL': {'NORM': 'gn'}})
    model = init_parameters(STP3(STP3Config.from_cfg(gn)), torch.Generator().manual_seed(0))
    path = ckpt_lib.save_checkpoint(str(tmp_path / 'gn'), 0, model.state_dict(),
                                    cfg_dict=gn.convert_to_dict())
    with pytest.raises(SystemExit, match="MODEL.NORM='gn'"):
        export_torch_checkpoint.main(['--checkpoint', path, '--output', str(tmp_path / 'x')])


def test_import_cli_sets_cam_front_parity_for_the_carla_rig(tmp_path):
    """The CARLA rig (front camera at index 0): CAM_FRONT_PARITY set,
    printed and saved, so the planner reads camera 1 as the reference's."""
    cfg = chip_smoke.make_cfg(chip_smoke.CARLA_PLANNING, TINY_FP32,
                              {'IMAGE': {'FINAL_DIM': (32, 32),
                                         'NAMES': ['front', 'left', 'right', 'rear']}})
    chip_smoke.write_reference_checkpoint(cfg, str(tmp_path / 'carla.ckpt'))
    lines = []
    path, report = import_torch_checkpoint.import_checkpoint(
        str(tmp_path / 'carla.ckpt'), str(tmp_path / 'out'), log=lines.append)
    assert report.ok()
    assert import_torch_checkpoint.CAM_FRONT_NOTE in lines
    saved = get_cfg(cfg_dict=ckpt_lib.load_config_dict(path))
    assert saved.PLANNING.CAM_FRONT_PARITY
    assert STP3Config.from_cfg(saved).cam_front_index == 1
    assert STP3Config.from_cfg(cfg).cam_front_index == 0


class AttributeDict(dict):
    """Stands in for Lightning's AttributeDict: a class in the pickle."""


def test_import_cli_refuses_a_pickled_class(imported, tmp_path):
    """torch.load(weights_only=True) refuses a hyper_parameters pickled as a
    class; the error says how to get past it. A raw state dict imports
    with the config from --config-file (here a JSON-compatible YAML)."""
    blob = torch.load(str(imported['root'] / 'ref.ckpt'), weights_only=True)
    torch.save({'state_dict': blob['state_dict'],
                'hyper_parameters': AttributeDict(blob['hyper_parameters'])},
               str(tmp_path / 'lightning.ckpt'))
    with pytest.raises(ValueError, match='weights_only'):
        import_torch_checkpoint.import_checkpoint(str(tmp_path / 'lightning.ckpt'),
                                                  str(tmp_path / 'out'), log=lambda m: None)
    torch.save(blob['state_dict'], str(tmp_path / 'raw.pt'))
    (tmp_path / 'cfg.yml').write_text(json.dumps(
        json.loads(json.dumps(imported['cfg'].convert_to_dict()))))
    path, report = import_torch_checkpoint.import_checkpoint(
        str(tmp_path / 'raw.pt'), str(tmp_path / 'raw'), str(tmp_path / 'cfg.yml'),
        log=lambda m: None)
    assert report.ok()
    want = ckpt_lib.load_checkpoint(imported['path'])['model']
    for k, v in ckpt_lib.load_checkpoint(path)['model'].items():
        assert torch.equal(v, want[k]), k


def test_import_cli_keeps_the_init_where_the_file_lacks_a_tensor(imported, tmp_path):
    """A key missing from the file is reported, and its leaf keeps the
    seeded init; everything else is imported."""
    blob = torch.load(str(imported['root'] / 'ref.ckpt'), weights_only=True)
    del blob['state_dict']['model.decoder.segmentation_head.3.bias']
    torch.save(blob, str(tmp_path / 'partial.ckpt'))
    lines = []
    path, report = import_torch_checkpoint.import_checkpoint(
        str(tmp_path / 'partial.ckpt'), str(tmp_path / 'out'), log=lines.append)
    assert report.missing == ['model.decoder.segmentation_head.3.bias']
    assert any(line.startswith('WARNING: param tree mismatch: 1 leaves missing')
               for line in lines)
    state = ckpt_lib.load_checkpoint(path)['model']
    full = ckpt_lib.load_checkpoint(imported['path'])['model']
    init = init_parameters(STP3(imported['mcfg']), torch.Generator().manual_seed(0)).state_dict()
    for k, v in state.items():
        assert torch.equal(v, init[k] if k == 'decoder.segmentation_head.Conv_1.bias'
                           else full[k]), k


def test_import_backbone_cli_warm_start(oracle_class, tmp_path):
    """import_backbone on an efficientnet-pytorch .pth: the encoder trunk
    carries the file's tensors (the port keeps torch's OIHW layout, so
    they are equal as they are) and ImageNet statistics; a 'gn' run's warm
    start from it (PRETRAINED.PATH) takes the trunk's kernels and skips the
    statistics its norms do not hold."""
    sd = _oracle_state_dict(oracle_class, 'efficientnet-b0', seed=4)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(tmp_path / 'b0.pth'))
    cfg = cli_cfg()
    (tmp_path / 'cfg.yml').write_text(json.dumps(json.loads(json.dumps(cfg.convert_to_dict()))))
    path = import_backbone.main(['--weights', str(tmp_path / 'b0.pth'), '--output',
                                 str(tmp_path / 'init'), '--config-file',
                                 str(tmp_path / 'cfg.yml'), 'TAG', 'imagenet'])
    state = ckpt_lib.load_checkpoint(path)['model']
    assert ckpt_lib.load_config_dict(path)['TAG'] == 'imagenet'
    trunk = 'encoder.EfficientNetFeatures_0'
    np.testing.assert_array_equal(state[f'{trunk}.Conv_0.kernel'].numpy(),
                                  sd['_conv_stem.weight'])
    np.testing.assert_array_equal(state[f'{trunk}.Norm_0.var'].numpy(), sd['_bn0.running_var'])
    np.testing.assert_array_equal(state[f'{trunk}.MBConv_3.Conv_1.kernel'].numpy(),
                                  sd['_blocks.3._depthwise_conv.weight'])
    gn = init_parameters(STP3(STP3Config.from_cfg(cli_cfg({'MODEL': {'NORM': 'gn'}}))),
                         torch.Generator().manual_seed(1)).state_dict()
    merged, n = filter_warm_start_params(state, gn)
    assert torch.equal(merged[f'{trunk}.Conv_0.kernel'], state[f'{trunk}.Conv_0.kernel'])
    assert not any(k.endswith(('.mean', '.var')) for k in merged)
    assert 0 < n < len(gn)
