"""The port's tracing (``utils/profiling``: ``span``, ``stage``,
``window_spans``) on the CPU, and the benchmark's readers of it
(``cardbench/metrics/*_ms.*.py``): nothing is recorded without a
profiler; under one, the tiny model's forward + plan, the agent's tick
through ``serve_step_static`` and ``Trainer.train_step`` give their
stages and host ranges, nested and counted as their calls make them; a
window holds only what was made while the profiler ran; the ring's
bookkeeping (positions of eager stamps and replays, its checks) on a
ring whose device writes are played on the host; each reader on a
synthetic window."""
import contextlib
import os

import numpy as np
import pytest
import torch

import torch_fixtures
from cardbench import harness
from cardbench.tracing import Summary
from stp3_tpu_torch.utils import profiling

torch.set_num_threads(2)

STAGES = ('stp3.encoder', 'stp3.splat', 'stp3.temporal', 'stp3.future', 'stp3.decoder',
          'stp3.planner')


def _window(fn, calls: int = 2):
    """(the port's spans, the profiler's host ranges as (start, end, name)
    in µs) of ``calls`` calls of ``fn`` under a profiler."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(calls):
            fn()
    ranges = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
              if e.name.startswith(('stp3.', 'train.', 'agent.', 'graph.'))]
    return profiling.window_spans(), sorted(ranges)


def _counts(names):
    out = {}
    for n in names:
        out[n] = out.get(n, 0) + 1
    return out


def _inside(inner, outer) -> bool:
    return outer.start_ns <= inner.start_ns and inner.end_ns <= outer.end_ns


@pytest.fixture(scope='module')
def flagship():
    cfg = torch_fixtures.make_cfg(torch_fixtures.FLAGSHIP, torch_fixtures.TINY, {'PRECISION': 32})
    model = torch_fixtures.build_model(cfg)
    (image, k, e, ego), extras = torch_fixtures.example_inputs(cfg)
    args = torch_fixtures.to_torch([image, k, e, ego, extras['trajs'], extras['gt_trajs'],
                                    extras['commands'], extras['target_points']], 'cpu')
    return model, args


def test_no_profiler_records_nothing_and_opens_no_range(flagship):
    model, args = flagship
    assert not torch.autograd.profiler._is_profiler_enabled
    off = profiling.span('a')
    assert isinstance(off, contextlib.nullcontext)
    assert profiling.stage('b', 'cpu') is off and profiling.stage('c', args[0]) is off
    marks, recorded = profiling._RECORDER.marks, list(profiling._RECORDER.marks)
    with torch.no_grad():
        torch_fixtures.plan_step(model, *args)
    assert profiling._RECORDER.marks is marks and marks == recorded


def test_forward_and_plan_give_each_stage_once_a_call(flagship):
    model, args = flagship
    with torch.no_grad():
        spans, ranges = _window(lambda: torch_fixtures.plan_step(model, *args))
    assert [s.name for s in spans] == list(STAGES) * 2
    assert all(s.device == 'cpu' and s.end_ns > s.start_ns for s in spans)
    # one after another, none inside another
    assert all(a.end_ns <= b.start_ns for a, b in zip(spans, spans[1:]))
    assert [n for _, _, n in ranges] == list(STAGES) * 2


def test_agent_tick_gives_its_host_phases_and_the_static_serve_steps_stages():
    """The tiny 4-camera agent (static geometry: ``serve_step_static``) on
    the CPU, where its compiled calls run eagerly: per tick the five host
    phases in order, the stages between the H2D and the PID, the splat
    twice (the new frame's, then the cache's warp and accumulate)."""
    from stp3_tpu_torch.deploy.agent_core import AgentCore
    from stp3_tpu_torch.layers.base import init_parameters
    from stp3_tpu_torch.models.stp3 import STP3, STP3Config
    cfg = torch_fixtures.make_cfg(torch_fixtures.TINY, {
        'BATCHSIZE': 1, 'PRECISION': 32,
        'IMAGE': {'FINAL_DIM': (64, 64), 'NAMES': ['A', 'B', 'C', 'D']}})
    model = init_parameters(STP3(STP3Config.from_cfg(cfg)), torch.Generator().manual_seed(0))
    core = AgentCore(cfg, model, device='cpu')
    rng = np.random.RandomState(0)
    np.random.seed(0)
    state = {'t': 0}

    def tick():
        t = state['t']
        state['t'] += 1
        frames = {k: rng.randint(0, 256, (80, 100, 3), np.uint8)
                  for k in ('rgb', 'rgb_left', 'rgb_right', 'rgb_rear')}
        core.push_frame(frames, np.array([0.3 * t, 0.0]), 0.01 * t)
        if core.warmed_up:
            core.plan_step(3.0, 4, np.array([0.0, 8.0], np.float32))

    for _ in range(cfg.TIME_RECEPTIVE_FIELD + 3):      # fill the buffers, then plan twice
        tick()
    assert core.warmed_up
    spans, ranges = _window(tick)
    want = ['stp3.encoder', 'stp3.splat', 'stp3.splat'] + list(STAGES[2:])
    assert [s.name for s in spans] == want * 2
    phases = ['agent.push_frame', 'agent.egomotion', 'agent.sample', 'agent.h2d']
    names = [n for _, _, n in ranges]
    assert names == (phases + want + ['agent.pid']) * 2
    host = {n: [(s, e) for s, e, m in ranges if m == n] for n in set(names)}
    for i in range(2):         # the stages run after the H2D and before the PID
        assert host['agent.h2d'][i][1] <= host['stp3.encoder'][i][0]
        assert host['stp3.planner'][i][1] <= host['agent.pid'][i][0]


def test_train_step_gives_forward_backward_update_with_the_models_stages_inside():
    from stp3_tpu_torch.training.trainer import Trainer
    cfg = torch_fixtures.planning_cfg(tiny=True)
    trainer = Trainer(cfg, device='cpu')
    batch, = torch_fixtures.synthetic_batches(cfg, 1, 'cpu')
    trainer.train_step(batch)
    spans, ranges = _window(lambda: trainer.train_step(batch))
    assert _counts(s.name for s in spans) == {
        **{n: 2 for n in STAGES}, 'train.forward': 2, 'train.backward': 2, 'train.update': 2}
    outer = [s for s in spans if s.name.startswith('train.')]
    assert [s.name for s in outer] == ['train.forward', 'train.backward', 'train.update'] * 2
    assert all(a.end_ns <= b.start_ns for a, b in zip(outer, outer[1:]))
    for s in spans:
        if s.name.startswith('stp3.'):
            assert sum(_inside(s, f) for f in outer if f.name == 'train.forward') == 1, s
    assert _counts(n for _, _, n in ranges) == _counts(s.name for s in spans)


def test_the_window_takes_only_the_spans_made_while_the_profiler_ran():
    with profiling.stage('t.before', 'cpu'):
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            with profiling.stage('t.inside', 'cpu'):
                with profiling.stage('t.nested', torch.zeros(1)):
                    pass
    with profiling.stage('t.after', 'cpu'):
        pass
    spans = profiling.window_spans()
    assert [s.name for s in spans] == ['t.inside', 't.nested'] * 3
    assert all(_inside(n, i) for i, n in zip(spans[::2], spans[1::2]))
    assert profiling.window_spans() == spans                 # read once, kept
    assert profiling.mean_ms(spans, 3) == pytest.approx(
        {n: sum(s.ms for s in spans if s.name == n) / 3 for n in ('t.inside', 't.nested')})
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.stage('t.second', 'cpu'):
            pass
    assert [s.name for s in profiling.window_spans()] == ['t.second']


def test_pairs_nest_inside_out_and_drop_a_lone_half():
    a, b = profiling._name_index('t.a'), profiling._name_index('t.b')
    marks = [('cpu', 1, 2 * a + 1), ('cpu', 2, 2 * a), ('cpu', 3, 2 * a), ('cpu', 4, 2 * b),
             ('cpu', 5, 2 * a + 1), ('cuda:0', 5, 2 * a), ('cpu', 6, 2 * b + 1),
             ('cpu', 7, 2 * a + 1), ('cpu', 8, 2 * b), ('cuda:0', 9, 2 * a + 1)]
    assert profiling._pair(marks) == [
        profiling.Span('t.a', 2, 7, 'cpu'), profiling.Span('t.a', 3, 5, 'cpu'),
        profiling.Span('t.b', 4, 6, 'cpu'), profiling.Span('t.a', 5, 9, 'cuda:0')]


class _PlayedRing:
    """A ring whose device writes are played on the host, in order, as
    the stamp kernel makes them: the clock and the id into the next slot."""

    def __init__(self, recorder, slots: int):
        self.words = torch.zeros(2 + 2 * slots, dtype=torch.int64)
        self.slots, self.clock = slots, 1000
        recorder.rings[0] = profiling._Ring(self.words)

    def run(self, stamps, step: int = 10):
        for stamp_id in stamps:
            slot = int(self.words[0]) % self.slots
            self.clock += step
            self.words[2 + 2 * slot], self.words[3 + 2 * slot] = self.clock, stamp_id
            self.words[0] += 1


@pytest.fixture
def recorder(monkeypatch):
    rec = profiling._Recorder()
    monkeypatch.setattr(profiling, '_RECORDER', rec)
    return rec


def _graph_stamps(*names):
    return tuple(i for n in names for i in (2 * profiling._name_index(n),
                                             2 * profiling._name_index(n) + 1))


def test_replays_take_their_ring_positions_and_only_traced_ones_are_kept(recorder):
    ring = _PlayedRing(recorder, profiling.RING_SLOTS)
    stamps = _graph_stamps('t.one', 't.two')
    for _ in range(5):                            # untraced replays: counted, not kept
        profiling.replayed(0, stamps)
        ring.run(stamps)
    assert recorder.marks == [] and recorder.rings[0].issued == 20
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            profiling.replayed(0, stamps)
            ring.run(stamps)
    spans = profiling.window_spans()
    assert [s.name for s in spans] == ['t.one', 't.two'] * 3
    assert all(s.device == 'cuda:0' and s.end_ns - s.start_ns == 10 for s in spans)
    assert [s.start_ns for s in spans] == [1210 + 20 * k for k in range(6)]
    profiling.replayed(0, stamps)                 # untraced again: the window is closed
    ring.run(stamps)
    assert profiling.window_spans() == spans


def test_the_ring_refuses_what_it_cannot_account_for(recorder, monkeypatch):
    monkeypatch.setattr(profiling, 'RING_SLOTS', 8)
    ring = _PlayedRing(recorder, 8)
    stamps = _graph_stamps('t.one', 't.two')
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.replayed(0, stamps)
        ring.run(stamps)
        ring.run(stamps[:1])                      # a stamp no replay accounts for
    with pytest.raises(RuntimeError, match='written 5 times but 4'):
        profiling.window_spans()
    ring.words[0] -= 1
    ring.words[3 + 2 * 1] = 2 * profiling._name_index('t.two')      # a slot overwritten
    recorder.spans = None
    with pytest.raises(RuntimeError, match='holds id'):
        profiling.window_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):                        # 12 stamps through 8 slots
            profiling.replayed(0, stamps)
            ring.run(stamps)
    with pytest.raises(RuntimeError, match='came round'):
        profiling.window_spans()


# ------------------------------------------------------------- the readers
STAGE_READERS = {f'{s}_ms.{cell}': f'stp3.{s}' for cell in ('serve', 'agent')
                 for s in ('encoder', 'splat', 'temporal', 'future', 'decoder', 'planner')}
STAGE_READERS.update({f'{s}_ms.train': f'train.{s}' for s in ('forward', 'backward', 'update')})


def _summary(n_steps: int, host=()):
    steps = [(float(i), i + 0.9) for i in range(n_steps)]
    return Summary({'k': [0.5, 10]}, [(0.0, 0.5)], list(host), steps, (0.0, n_steps), n_steps)


@pytest.mark.parametrize('metric', sorted(STAGE_READERS))
def test_stage_reader_on_a_synthetic_window(metric, monkeypatch):
    """The mean over the traced steps of the stage's device time, in ms;
    None where the window holds none of it or the port has no window."""
    name = STAGE_READERS[metric]
    spans = [profiling.Span(name, 1_000_000, 4_000_000, 'cuda:0'),
             profiling.Span(name, 9_000_000, 10_500_000, 'cuda:0'),
             profiling.Span('other', 0, 50_000_000, 'cuda:0')]
    reader = harness.metric_reader(metric)
    monkeypatch.setattr(profiling, 'window_spans', lambda: spans)
    assert reader.read(_summary(3), {}) == pytest.approx(1.5)
    monkeypatch.setattr(profiling, 'window_spans', lambda: spans[2:])
    assert reader.read(_summary(3), {}) is None
    monkeypatch.delattr(profiling, 'window_spans')
    assert reader.read(_summary(3), {}) is None


def test_sampler_reader_on_a_synthetic_window():
    reader = harness.metric_reader('sampler_ms.agent')
    host = [(0.0, 0.9, 'cardbench.step'), (0.1, 0.135, 'agent.sample'),
            (1.1, 1.137, 'agent.sample'), (1.2, 1.3, 'agent.pid')]
    assert reader.read(_summary(2, host), {}) == pytest.approx(36.0)
    assert reader.read(_summary(2, host[:1]), {}) is None


def test_every_new_reader_is_a_file_of_the_benchmark():
    names = {m['name'] for m in harness.load_json(
        os.path.join(harness.ROOT, 'BENCHMARK.json'))['per_layer']}
    assert set(STAGE_READERS) | {'sampler_ms.agent'} <= names


def test_the_stamp_is_no_counted_kernel_and_matches_no_roofline_needle():
    """The launch counters compare exact dicts, and the roofline readers
    find their kernels by these needles in the trace's kernel names."""
    import re
    from pathlib import Path
    from stp3_tpu_torch.ops.kernels import launch_counters, stage_stamp
    src = (Path(stage_stamp.__file__).parents[2] / 'csrc' / 'stage_stamp.cu').read_text()
    kernels = re.findall(r'__global__\s+void\s+(\w+)', src)
    assert kernels == ['stage_stamp_kernel']
    for needle in ('splat_tile', 'convnext_mlp', 'gather_rows'):
        assert needle not in kernels[0]
    assert not any('stamp' in name for name in launch_counters())
