"""The benchmark's files: BENCHMARK.json against the contract it is checked
by, each configuration against its stage YAML and the port's own reading
of it, discovery of cells, traffic and metrics by name, and the ban on
JAX in everything that runs on the card."""
import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from cardbench import harness

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCH = json.load(open(os.path.join(ROOT, 'BENCHMARK.json')))
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
# a run's (run_seconds + 60) and each cell's 2 x 90 s of compile, at 24
# cells of 2 + 14 x 24 runs, and 1200 s spare, within 12 hours
CHECK_SECONDS = 43200


def test_benchmark_keys_and_names():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs', 'workloads',
                          'end_to_end', 'per_layer'}
    assert 1 <= BENCH['run_seconds'] <= 51
    assert (2 + 14 * 24) * (BENCH['run_seconds'] + 60) + 24 * 180 + 1200 <= CHECK_SECONDS
    for c in BENCH['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert c['file'].startswith(BENCH['paths'][0] + '/')
    for w in BENCH['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'} and len(w['why']) <= 200
        assert w['chips'] in (1, 4)
    for m in BENCH['end_to_end']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'bound', 'source'}
        assert 0.01 <= m['bound'] <= 0.25 and m['source'] in ('host_clock', 'device_trace')
    for m in BENCH['per_layer']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'source', 'layer', 'moves'}
        assert m['moves'] in {e['name'] for e in BENCH['end_to_end']}
    every = BENCH['configs'] + BENCH['workloads'] + BENCH['end_to_end'] + BENCH['per_layer']
    for item in every:
        assert NAME.match(item['name']), item['name']
        assert 'unit' not in item or UNIT.match(item['unit'])
        assert item.get('better', 'lower') in ('lower', 'higher')
    names = [m['name'] for m in BENCH['end_to_end'] + BENCH['per_layer']]
    assert len(names) == len(set(names))
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize('cell', [w['name'] for w in BENCH['workloads']])
def test_every_cell_reports_what_the_contract_asks(cell):
    spec = harness.load_cell(cell)
    e2e = {m['name'] for m in spec['end_to_end']}
    assert 'setup_s' in e2e and len(e2e) >= 2 and spec['per_layer']
    for m in spec['per_layer']:
        assert m['moves'] in e2e
        assert os.path.exists(os.path.join(HERE, 'metrics', m['name'] + '.py'))
    assert os.path.exists(os.path.join(HERE, 'entries', spec['workload']['entry'] + '.py'))


def yaml_stage(path: str) -> dict:
    import yaml
    with open(os.path.join(ROOT, path)) as f:
        return yaml.safe_load(f)


def flat(tree: dict, prefix: str = '') -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f'{prefix}{k}.'))
        else:
            out[f'{prefix}{k}'] = list(v) if isinstance(v, tuple) else v
    return out


@pytest.mark.parametrize('config', [c['name'] for c in BENCH['configs']])
def test_config_is_its_yaml(config):
    """Every key of the stage YAML as the file runs it, but those listed in
    ``reduced``; the reference's model fields and training settings as the
    port reads the stage."""
    from cardbench.entries.serve import port_config
    from cardbench.tiny import model_fields
    entry = {c['name']: c for c in BENCH['configs']}[config]
    data = json.load(open(os.path.join(ROOT, entry['file'])))
    assert data['source'] == entry['source'] and data['reduced'] == entry['reduced']
    want = flat(yaml_stage(data['yaml']))
    got = flat(data['stage'])
    for key, value in want.items():
        if key.split('.')[0] in entry['reduced']:
            assert got[key] != value, key
            continue
        if isinstance(value, str) and value.startswith('('):     # a tuple, as YAML text
            value = [int(v) for v in value.strip('()').split(',')]
        elif isinstance(value, str) and re.fullmatch(r'[0-9.]+e-?[0-9]+', value):
            value = float(value)                             # YAML 1.1 reads 2e-4 as text
        assert got[key] == value, key
    assert data['model'] == model_fields(data['stage'])
    cfg = port_config(data)
    assert {16: 'bf16', 32: 'fp32'}[int(cfg.PRECISION)] == data['precision']
    if 'train' in data:
        t = data['train']
        assert t['segmentation'] == dict(cfg.SEMANTIC_SEG.VEHICLE)
        assert (t['LR'], t['WEIGHT_DECAY'], t['GRAD_NORM_CLIP'], t['FUTURE_DISCOUNT']) == (
            cfg.OPTIMIZER.LR, cfg.OPTIMIZER.WEIGHT_DECAY, cfg.GRAD_NORM_CLIP,
            cfg.FUTURE_DISCOUNT)


def test_a_cell_and_a_metric_are_found_by_name(tmp_path):
    """A new cell, traffic mix and per-layer metric, added as files and
    entries alone in a copy, are found by the harness."""
    root = str(tmp_path)
    shutil.copytree(HERE, os.path.join(root, 'cardbench'),
                    ignore=shutil.ignore_patterns('__pycache__'))
    bench = json.loads(json.dumps(BENCH))
    bench['workloads'].append({'name': 'dummy_cell', 'config': 'nuscenes_planning',
                               'traffic': 'dummy_traffic', 'chips': 1, 'why': 'a test'})
    bench['per_layer'].append({'name': 'dummy.metric', 'unit': '%', 'better': 'higher',
                               'source': 'device_trace', 'layer': 'kernels (csrc/)',
                               'moves': 'plan_ms_p50', 'workloads': ['dummy_cell']})
    bench['end_to_end'][0]['workloads'].append('dummy_cell')
    json.dump(bench, open(os.path.join(root, 'BENCHMARK.json'), 'w'))
    here = os.path.join(root, 'cardbench')
    shutil.copy(os.path.join(here, 'traffic', 'nusc_closed_loop.json'),
                os.path.join(here, 'traffic', 'dummy_traffic.json'))
    shutil.copy(os.path.join(here, 'workloads', 'nusc_plan_serve_b1.json'),
                os.path.join(here, 'workloads', 'dummy_cell.json'))
    with open(os.path.join(here, 'metrics', 'dummy.metric.py'), 'w') as f:
        f.write('def read(summary, inputs):\n    return 42.0\n')
    spec = harness.load_cell('dummy_cell', root)
    assert [m['name'] for m in spec['per_layer']] == ['dummy.metric']
    assert spec['traffic']['kind'] == 'camera_sets'
    assert harness.metric_reader('dummy.metric', root).read(None, None) == 42.0
    assert harness.entry_module(spec['workload']['entry'], root).Entry


def imports(path: str) -> set:
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split('.')[0])
    return names


def sources(sub: str = ''):
    for d, _, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    """Whole top-level names: ``stp3_tpu_torch`` passes, ``stp3_tpu`` does
    not; the reference imports nothing of the port either."""
    for path in sources():
        assert not imports(path) & set(harness.BANNED), path
    for path in sources('reference'):
        assert 'stp3_tpu_torch' not in imports(path), path


def test_a_run_loads_no_jax():
    """What a run imports, the port's entries included, loads no module of
    a banned top-level name."""
    code = ('import sys; sys.path[0] = %r\n'
            'from cardbench import harness\n'
            'for kind in ("serve", "agent", "train"):\n'
            '    harness.entry_module(kind)\n'
            'import stp3_tpu_torch.deploy.agent_core, stp3_tpu_torch.training.trainer\n'
            'print(harness.banned_modules())' % ROOT)
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                         env={**os.environ, 'USE_FLAX': '0'}, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == '[]'
