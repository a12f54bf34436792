"""The compiled training and validation calls of the port's Trainer
(stp3_tpu_torch/training/trainer.py over utils/graphs.compiled_step and
compiled) on the CPU, where a compiled call runs its function eagerly:

  * ``train_step`` (the gradients' call, the host's work, the update's
    call) is the eager ``compute_gradients`` + ``apply_gradients``, bit
    for bit over 3 steps: loss terms, parameters, Adam's state, the 'bn'
    running statistics and the generator's state;
  * DEBUG.NAN_CHECK raises between the two calls: the update's call is
    not made, and the parameters, Adam and the step stay as they were;
  * the storage the graphs read by address (the parameters, every
    ``.grad``, Adam's state) is held: a ``.grad`` set anew, an optimizer
    ``load_state_dict`` or a moved parameter makes the call raise;
  * ``val_step``'s metric increments, computed on the device in the
    validation call and read back once, equal the metrics' own updates
    (exact counts, L2 at rtol 1e-6), padding rows weighted out; a ragged
    last batch is a second signature (a second graph on the card) and
    its metrics add up to one batch's;
  * ``train.run`` restores a warm start and a resume before the first
    compiled call (the card captures after them), and a resume goes on in
    its run directory;
  * ``remat``'s generator rewind on the CPU path under every MODEL.REMAT
    tag, through the compiled step: the step equals REMAT 'none''s and
    leaves the generator where it did.

The same calls capture and replay CUDA graphs on the card
(tests/test_torch_cuda.py, chip_smoke.py's [train graphs] phase). No JAX:
the parity of these steps with the JAX package's is held by
tests/test_torch_train.py, test_torch_stages.py, test_torch_norms.py and
test_torch_gt_depth.py, which go through the same ``train_step``.
"""
import copy
import os

import numpy as np
import pytest
import torch

import torch_fixtures
from torch_fixtures import planning_cfg, running_stats, synthetic_batches
from stp3_tpu_torch import train as ttrain
from stp3_tpu_torch.datas.synthetic import SyntheticDataset, collate
from stp3_tpu_torch.layers.base import init_parameters
from stp3_tpu_torch.metrics import IoUMetric, PlanningMetric
from stp3_tpu_torch.models.stp3 import STP3, STP3Config
from stp3_tpu_torch.training import checkpoint as ckpt_lib
from stp3_tpu_torch.training.trainer import Trainer, batch_to_device, make_optimizer
from stp3_tpu_torch.utils import graphs, rng
from stp3_tpu_torch.utils.device import rows_to_device, to_host
from stp3_tpu_torch.utils.instance import predict_instance_segmentation_and_trajectories
from stp3_tpu_torch.utils.network import prepare_image

torch.set_num_threads(2)

TAGS = ('none', 'encoder', 'temporal', 'future', 'decoder', 'cells', 'gates',
        'encoder+temporal+decoder+cells', 'future+cells')


def _cfg(norm: str = 'bn', remat: str = 'encoder'):
    cfg = planning_cfg(tiny=True)
    cfg.MODEL.NORM = norm
    cfg.MODEL.REMAT = remat
    return cfg


@pytest.fixture(scope='module')
def setup():
    """The tiny Planning stage under 'bn' (fp32, REMAT 'encoder'), seeded
    weights, two synthetic batches."""
    cfg = _cfg()
    init = init_parameters(STP3(STP3Config.from_cfg(cfg)), torch.Generator().manual_seed(0))
    return cfg, copy.deepcopy(init.state_dict()), synthetic_batches(cfg, 2, 'cpu')


def _trainer(cfg, weights, **kw):
    model = STP3(STP3Config.from_cfg(cfg))
    model.load_state_dict(weights)
    return Trainer(cfg, device='cpu', seed=3, model=model, **kw)


def _adam(trainer):
    return [{k: v.clone() for k, v in st.items()}
            for st in trainer.optimizer.state_dict()['state'].values()]


def test_compiled_step_is_the_eager_step_bit_for_bit(setup):
    cfg, weights, batches = setup
    compiled, eager = _trainer(cfg, weights), _trainer(cfg, weights)
    assert compiled.compiled and isinstance(compiled.graphs['gradients'], graphs.CompiledStep)
    assert not compiled.optimizer.defaults['capturable']       # none on the CPU
    for i in range(3):
        got = compiled.train_step(batches[i % 2])
        want = eager.compute_gradients(batches[i % 2])
        eager.apply_gradients()
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(got[k], v), (i, k)
        for (n, p), q in zip(compiled.model.named_parameters(), eager.model.parameters()):
            assert torch.equal(p, q), (i, n)
        for a, b in zip(_adam(compiled), _adam(eager)):
            for k, v in b.items():
                assert torch.equal(a[k], v), (i, k)
        stats_c, stats_e = running_stats(compiled.model), running_stats(eager.model)
        assert stats_c and all(torch.equal(stats_c[k], v) for k, v in stats_e.items())
        assert torch.equal(compiled.generator.get_state(), eager.generator.get_state())
    assert compiled.step == eager.step == 3
    # the gradients' call zeroes .grad in place: the same tensors every step
    ptrs = [p.grad.data_ptr() for p in compiled.model.parameters()]
    compiled.train_step(batches[0])
    assert ptrs == [p.grad.data_ptr() for p in compiled.model.parameters()]


def test_nan_check_raises_between_the_two_calls(setup, monkeypatch):
    cfg, weights, batches = setup
    nan_cfg = cfg.clone()
    nan_cfg.DEBUG.NAN_CHECK = True
    trainer = _trainer(nan_cfg, weights)
    updates = []
    update = trainer.graphs['update']
    monkeypatch.setitem(trainer.graphs, 'update', lambda: updates.append(1) or update())
    trainer.train_step(batches[0])
    assert updates == [1]
    params = [p.detach().clone() for p in trainer.model.parameters()]
    adam, step = _adam(trainer), trainer.step
    bad = dict(batches[1])
    bad['image'] = prepare_image(bad['image'], torch.float32).clone()
    bad['image'][0, 0, 0] = float('nan')
    with pytest.raises(FloatingPointError, match='no update was applied'):
        trainer.train_step(bad)
    assert updates == [1] and trainer.step == step
    assert all(torch.equal(a, p) for a, p in zip(params, trainer.model.parameters()))
    for a, b in zip(_adam(trainer), adam):
        assert all(torch.equal(a[k], v) for k, v in b.items())


def test_the_storage_the_graphs_read_is_held(setup):
    """What a compiled training call holds: the parameters and buffers, each
    ``.grad`` and Adam's state. Replacing any of them (what a graph would
    not see) raises on the next call; updating them in place does not."""
    cfg, weights, batches = setup
    trainer = _trainer(cfg, weights)
    trainer.train_step(batches[0])
    call = trainer.graphs['gradients']
    names = [name for name, _, _ in call._held_tensors()]
    n_params = sum(1 for _ in trainer.model.parameters())
    assert sum(n.startswith('the gradient of') for n in names) == n_params
    assert sum("'exp_avg_sq'" in n for n in names) == n_params
    call._hold()
    trainer.train_step(batches[1])                       # in place: still held
    call._check_storage()
    for breaking, match in (
            (lambda: trainer.optimizer.load_state_dict(  # as from a checkpoint
                copy.deepcopy(trainer.optimizer.state_dict())), 'replaced'),
            (lambda: trainer.optimizer.zero_grad(set_to_none=True), 'set anew'),
            (lambda: setattr(trainer.model.planning_weight, 'data',
                             trainer.model.planning_weight.data.clone()), 'moved')):
        call._held = None
        call._hold()
        breaking()
        with pytest.raises(RuntimeError, match=match):
            call._check_storage()


def test_make_optimizer_is_capturable_only_on_the_card():
    layer = torch.nn.Linear(2, 2)
    assert not make_optimizer(planning_cfg(tiny=True), layer.parameters()).defaults['capturable']


def _reference_metrics(trainer, output, labels, rows):
    """The metrics updated the way ``val_step`` did before its increments
    moved into the compiled call: each metric's own ``update`` on the kept
    rows."""
    cfg, rf = trainer.cfg, trainer.rf
    n = len(cfg.SEMANTIC_SEG.VEHICLE.WEIGHTS)
    out = {k: v[rows] for k, v in output.items() if isinstance(v, torch.Tensor)}
    lab = {k: v[rows] for k, v in labels.items()}
    vehicle, ped = IoUMetric(n), IoUMetric(n)
    vehicle.update(out['segmentation'].argmax(-1)[:, rf - 1:], lab['segmentation'][:, rf - 1:])
    ped.update(out['pedestrian'].argmax(-1)[:, rf - 1:], lab['pedestrian'][:, rf - 1:])
    hdmap = [IoUMetric(2, absent_score=1.0) for _ in cfg.SEMANTIC_SEG.HDMAP.ELEMENTS]
    for i, m in enumerate(hdmap):
        m.update(out['hdmap'][..., 2 * i:2 * (i + 1)].argmax(-1), lab['hdmap'][..., i])
    plan = PlanningMetric(cfg, cfg.N_FUTURE_FRAMES)
    plan.update(out['final_traj'], lab['gt_trajectory'][:, 1:],
                torch.logical_or(lab['segmentation'][:, rf:], lab['pedestrian'][:, rf:]))
    return [vehicle, ped, plan] + hdmap


def _states(metrics):
    return [{k: np.copy(v) for k, v in m.state.items()} for m in metrics]


def _assert_states_equal(got, want):
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in w:
            if key == 'l2':
                np.testing.assert_allclose(g[key], w[key], rtol=1e-6, atol=0)
            else:
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def _val_rows(cfg, n: int, seed: int = 11):
    ds = SyntheticDataset(cfg, n_samples=n, seed=seed)
    return [ds[i] for i in range(n)]


def test_val_increments_equal_the_metric_updates(setup):
    """One readback of the compiled validation call's increments gives
    the metric states that each metric's own update gives; the rows the
    ``valid`` mask marks are weighted out (a padded batch of 3 with the
    third row marked equals the batch of 2)."""
    cfg, weights, _ = setup
    trainer = _trainer(cfg, weights)
    rows = _val_rows(cfg, 2)
    pair = batch_to_device(collate(rows), 'cpu')
    output, labels = trainer.val_forward(pair)
    want = _states(_reference_metrics(trainer, output, labels, slice(None)))
    got = []
    for batch in (pair, dict(pair, valid=np.array([True, True])),
                  dict(batch_to_device(collate(rows + rows[:1]), 'cpu'),
                       valid=np.array([True, True, False]))):
        trainer.reset_metrics()
        trainer.val_step(batch)
        got.append(_states([trainer.metric_vehicle_val, trainer.metric_pedestrian_val,
                            trainer.metric_planning_val] + trainer.metric_hdmap_val))
    for states in got:
        _assert_states_equal(states, want)
    assert want[0]['support'].sum() == 2 * (cfg.N_FUTURE_FRAMES + 1) * 16 * 16
    assert got[2][2]['total'] == 2
    # a batch of padding only adds nothing
    trainer.reset_metrics()
    trainer.val_step(dict(pair, valid=np.array([False, False])))
    assert all(not np.any(v) for st in _states(trainer._all_metrics()) for v in st.values())


def test_a_ragged_last_batch_is_a_second_signature_and_adds_up(setup):
    """The validation call's graph is kept under the batch's shapes: a
    ragged last batch (and a batch with a ``valid`` mask) is another
    signature, so the card captures a second graph for it, as does a batch
    with padding rows (a batch whose rows are all valid is weighted as one
    without a mask); the metrics of a batch of 2 and a ragged batch of 1
    add up to those of one batch of 3."""
    cfg, weights, _ = setup
    trainer = _trainer(cfg, weights)
    rows = _val_rows(cfg, 3)
    full, ragged = (batch_to_device(collate(r), 'cpu') for r in (rows[:2], rows[2:]))
    key = graphs.signature(full, None)
    assert graphs.signature(batch_to_device(collate(rows[1:]), 'cpu'), None) == key
    assert graphs.signature(ragged, None) != key
    assert graphs.signature(full, rows_to_device(np.array([True, False]), 'cpu')) != key
    trainer.reset_metrics()
    for batch in (full, ragged):
        trainer.val_step(batch)
    split = _states(trainer._all_metrics())
    trainer.reset_metrics()
    trainer.val_step(batch_to_device(collate(rows), 'cpu'))
    _assert_states_equal(split, _states(trainer._all_metrics()))


def test_host_helpers_and_decoded_ids():
    """``to_host`` brings a dict of tensors as numpy; the instance linking
    takes ids already decoded and gives what decoding them again gives."""
    x = {'a': torch.arange(6).reshape(2, 3), 'b': torch.tensor([True, False])}
    host = to_host(x)
    assert all(isinstance(v, np.ndarray) and np.array_equal(v, x[k].numpy())
               for k, v in host.items())
    r = np.random.RandomState(0)
    output = {'segmentation': torch.as_tensor(r.randn(1, 3, 12, 12, 2), dtype=torch.float32),
              'instance_center': torch.as_tensor(r.rand(1, 3, 12, 12, 1), dtype=torch.float32),
              'instance_offset': torch.as_tensor(r.randn(1, 3, 12, 12, 2), dtype=torch.float32),
              'instance_flow': torch.as_tensor(r.randn(1, 3, 12, 12, 2), dtype=torch.float32)}
    from stp3_tpu_torch.utils.instance_jit import decode_instances
    ids = decode_instances(output['segmentation'], output['instance_center'],
                           output['instance_offset'])
    want = predict_instance_segmentation_and_trajectories(output)
    got = predict_instance_segmentation_and_trajectories(
        {'instance_flow': output['instance_flow'].numpy()}, decoded=ids.numpy())
    assert np.array_equal(got, want) and want.max() > 0


def test_train_run_restores_before_the_first_compiled_call(tmp_path, monkeypatch):
    """The order of ``train.run``: the warm start's and the resume's loads
    come before the first call of the compiled gradients' step (on the card
    the graphs are captured at a later call still, after the warm-up
    steps), and the resumed run goes on in the checkpoint's run directory."""
    events = []
    restore, load = ckpt_lib.restore_train_state, ckpt_lib.load_checkpoint
    step_call = graphs.CompiledStep.__call__

    def spy_call(self, *args, **kwargs):
        events.append(('call', self.name))
        return step_call(self, *args, **kwargs)

    monkeypatch.setattr(ckpt_lib, 'restore_train_state',
                        lambda *a, **k: events.append(('restore',)) or restore(*a, **k))
    monkeypatch.setattr(ckpt_lib, 'load_checkpoint',
                        lambda *a, **k: events.append(('load',)) or load(*a, **k))
    monkeypatch.setattr(graphs.CompiledStep, '__call__', spy_call)
    cfg = torch_fixtures.make_cfg(torch_fixtures.PLANNING_STAGE, torch_fixtures.TINY,
                                  {'PRECISION': 32},
                                  {'DATASET': {'NAME': 'synthetic', 'VERSION': 'mini',
                                               'VAL_SAMPLES': 2}, 'N_WORKERS': 0, 'EPOCHS': 1,
                                   'LOG_DIR': str(tmp_path),
                                   'PRETRAINED': {'LOAD_WEIGHTS': False}})
    first = ttrain.run(cfg, 'cpu', log=lambda msg: None)
    assert events[0][0] == 'call'
    events.clear()
    resume = cfg.clone()
    resume.EPOCHS = 2
    resume.CHECKPOINT.RESUME = first['last']
    resume.PRETRAINED.LOAD_WEIGHTS = True
    resume.PRETRAINED.PATH = first['last']
    logs = []
    second = ttrain.run(resume, 'cpu', log=logs.append)
    kinds = [e[0] for e in events]
    first_call = kinds.index('call')
    assert 'restore' in kinds[:first_call] and 'load' in kinds[:first_call]
    assert kinds.index('load') < kinds.index('restore') < first_call
    assert events[first_call][1].startswith('Trainer gradients')
    assert second['save_dir'] == first['save_dir'] and second['step'] == 2 * first['step']
    assert os.path.dirname(second['last']) == os.path.dirname(first['last'])
    assert any('compiled calls, run eagerly on the CPU' in line for line in logs)


@pytest.fixture(scope='module')
def rewind_reference():
    """The tiny Planning stage under 'gn' with dropout on: one compiled
    step under REMAT 'none' from seeded weights (loss terms, generator)."""
    cfg = _cfg('gn', 'none')
    init = init_parameters(STP3(STP3Config.from_cfg(cfg)), torch.Generator().manual_seed(1))
    weights = copy.deepcopy(init.state_dict())
    batch, = synthetic_batches(cfg, 1, 'cpu')
    return weights, batch


@pytest.mark.parametrize('remat', TAGS)
def test_remat_rewinds_the_generator_on_the_cpu(rewind_reference, remat):
    """Through the compiled step with dropout on: the recomputation draws the
    forward's masks again (loss terms and parameters as under 'none', bit
    for bit) and leaves the generator where the forward did."""
    weights, batch = rewind_reference
    steps = {}
    for tag in ('none', remat):
        trainer = _trainer(_cfg('gn', tag), weights)
        start = trainer.generator.get_state()
        loss = trainer.train_step(batch)
        steps[tag] = (loss, [p.detach() for p in trainer.model.parameters()],
                      trainer.generator.get_state())
        assert not torch.equal(steps[tag][2], start)
    (loss_n, params_n, gen_n), (loss, params, gen) = steps['none'], steps[remat]
    assert all(torch.equal(loss[k], v) for k, v in loss_n.items())
    assert all(torch.equal(a, b) for a, b in zip(params, params_n))
    assert torch.equal(gen, gen_n)


def test_rewound_cpu_generator_draws_again_and_returns():
    g = torch.Generator().manual_seed(5)
    snap = rng.snapshot(g)
    first = torch.rand(4, generator=g)
    after = g.get_state()
    with rng.rewound([g], [snap]):
        assert torch.equal(torch.rand(4, generator=g), first)
    assert torch.equal(g.get_state(), after)
