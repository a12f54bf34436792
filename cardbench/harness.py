"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the result line.

The cell's files are found by name (``load_cell``); its entry kind names
``entries/<kind>.py``, which provides ``Entry(cell, seed, device)`` with

- ``step(i)``: the i-th timed step, from handing its inputs to the port
  until its answer is on the host (a ``throughput`` entry does not wait
  for the device: the harness keeps at most two steps in flight);
- ``samples``: the samples one step completes;
- ``before(i)`` (optional): what the comparison needs from before step i,
  taken outside the step's time;
- ``keep(i, result)``: what the comparison needs of a step drawn for it
  (called for the steps of a seeded reservoir sample of the window);
- ``evidence(kept)`` (optional): what the comparison is handed in place
  of the kept steps (a training entry's first steps);
- ``release()``: drop the port and its state;

and ``numbers(cell, seed, device, kept)``: every number the comparison
works out, by name; ``judge(cell, seed, device, kept)``: those the
workload file gives a limit, each a ``(name, value, limit)``.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import random
import re
import statistics
import sys
import time
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# whole top-level module names no process that reports a result may hold
BANNED = ('jax', 'jaxlib', 'flax', 'optax', 'stp3_tpu')
GIB = 2 ** 30


def process_age_s() -> float:
    """Seconds since this process started (``/proc``: its start in clock
    ticks after boot against the uptime)."""
    with open('/proc/self/stat') as f:
        start_ticks = int(f.read().rsplit(')', 1)[1].split()[19])
    with open('/proc/uptime') as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf('SC_CLK_TCK')


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """The Python file at ``path`` as a module (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def for_cell(metric: dict, cell: str) -> bool:
    return 'workloads' not in metric or cell in metric['workloads']


def load_cell(name: str, root: str = ROOT) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic and workload files and the metrics it reports."""
    bench = load_json(os.path.join(root, 'BENCHMARK.json'))
    cells = {w['name']: w for w in bench['workloads']}
    if name not in cells:
        raise KeyError(f'no cell {name!r} in BENCHMARK.json')
    cell = cells[name]
    configs = {c['name']: c for c in bench['configs']}
    config = configs[cell['config']]
    here = os.path.join(root, 'cardbench')
    return dict(
        name=name, chips=int(cell['chips']), root=root,
        config=load_json(os.path.join(root, config['file'])),
        traffic=load_json(os.path.join(here, 'traffic', cell['traffic'] + '.json')),
        workload=load_json(os.path.join(here, 'workloads', name + '.json')),
        end_to_end=[m for m in bench['end_to_end'] if for_cell(m, name)],
        per_layer=[m for m in bench['per_layer'] if for_cell(m, name)])


def entry_module(kind: str, root: str = ROOT):
    return load_module(os.path.join(root, 'cardbench', 'entries', kind + '.py'),
                       f'cardbench_entry_{kind}')


def metric_reader(name: str, root: str = ROOT):
    return load_module(os.path.join(root, 'cardbench', 'metrics', name + '.py'),
                       'cardbench_metric_' + name.replace('.', '_'))


def banned_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is banned."""
    return sorted({m for m in sys.modules if m.split('.')[0] in BANNED})


class Reservoir:
    """A uniform sample of ``k`` of the window's steps, drawn from the seed
    (reservoir sampling: the window's length is not known in advance)."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.kept = k, random.Random(seed * 7919 + 17), {}

    def offer(self, i: int, result, keep) -> None:
        if i < self.k:
            self.kept[i] = keep(i, result)
            return
        j = self.rng.randrange(i + 1)
        if j < self.k:
            victim = sorted(self.kept)[j]
            del self.kept[victim]
            self.kept[i] = keep(i, result)


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile by linear interpolation between order statistics."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def sync(device) -> None:
    import torch
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def run_window(entry, seconds: float, sample: Reservoir, device,
               profiled_steps: Optional[int] = None):
    """Timed steps for ``seconds`` (or exactly ``profiled_steps``): per-step
    host-clock latencies, the steps and the window's seconds. A
    ``throughput`` entry's steps are not waited for one by one: an event
    after each, and step i waits for step i - 2's event."""
    import torch
    throughput = entry.throughput and device.type == 'cuda'
    before = getattr(entry, 'before', None)
    events, latencies, i = [], [], 0
    sync(device)
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        if profiled_steps is None and t0 - t_start >= seconds:
            break
        if profiled_steps is not None and i >= profiled_steps:
            break
        if throughput and len(events) >= 2:
            events.pop(0).synchronize()
        if before is not None:
            before(i)
            t0 = time.perf_counter()
        with torch.profiler.record_function('cardbench.step'):
            result = entry.step(i)
        if throughput:
            ev = torch.cuda.Event()
            ev.record()
            events.append(ev)
        latencies.append(time.perf_counter() - t0)
        sample.offer(i, result, entry.keep)
        i += 1
    sync(device)
    return latencies, i, time.perf_counter() - t_start


# a step latency metric: ``<what>_ms_p<q>``, the q-th percentile of every
# step of the window (q 50: the median)
LATENCY = re.compile(r'^[A-Za-z0-9]\w*_ms_p(\d+)$')


def end_to_end(cell: dict, latencies, steps: int, window_s: float, samples_per_step: int,
               peak_bytes: int, setup_s: float) -> Dict[str, float]:
    """The cell's end-to-end metrics, by name: set-up, peak memory, the
    rate of samples and the percentiles of the steps' latencies."""
    values = {'setup_s': setup_s, 'peak_mem_gib': peak_bytes / GIB,
              'train_samples_per_s': steps * samples_per_step / window_s}
    ms = [t * 1e3 for t in latencies]
    for m in cell['end_to_end']:
        q = LATENCY.match(m['name'])
        if q and ms:
            values[m['name']] = (statistics.median(ms) if q.group(1) == '50'
                                 else percentile(ms, int(q.group(1))))
    return {m['name']: values[m['name']] for m in cell['end_to_end']}


def device_info(chips: int, peak_bytes: int, device) -> dict:
    import torch
    if device.type != 'cuda':
        return {'platform': 'cpu', 'kind': 'cpu', 'count': chips, 'memory_peak_bytes': 0}
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(device), 'count': chips,
            'memory_peak_bytes': int(peak_bytes)}


def free_card(device) -> None:
    import torch
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()


def say_checks(checks) -> None:
    for name, value, limit in checks:
        print(f'check {name} {value!r} limit {limit!r}', file=sys.stderr, flush=True)


def checks_correct(checks) -> bool:
    return bool(checks) and all(math.isfinite(v) and v <= lim for _, v, lim in checks)


def run(workload: str, seed: int, seconds: float, trace: bool, root: str = ROOT,
        device=None) -> int:
    """One run of the cell ``workload``; prints the result line; the exit
    code. ``device``: run there without looking for a card (the CPU tests
    of the harness); the measurement itself needs the card."""
    cell = load_cell(workload, root)
    import torch
    if device is None and (not torch.cuda.is_available()
                           or torch.cuda.device_count() < cell['chips']):
        print(f'cardbench: the cell needs {cell["chips"]} CUDA device(s), '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0} found',
              file=sys.stderr)
        return 2
    kind = cell['workload']['entry']
    module = entry_module(kind, root)
    device = torch.device('cuda', 0) if device is None else torch.device(device)
    entry = module.Entry(cell, seed, device)
    sync(device)
    setup_s = process_age_s()
    sample = Reservoir(int(cell['workload']['sample']), seed)
    summary = None
    if trace:
        from cardbench import tracing
        with tracing.profiled() as prof:
            latencies, steps, window_s = run_window(
                entry, seconds, sample, device,
                profiled_steps=int(cell['workload']['trace_steps']))
        summary = tracing.summarise(prof, steps)
    else:
        latencies, steps, window_s = run_window(entry, seconds, sample, device)
    peak = torch.cuda.max_memory_reserved(device) if device.type == 'cuda' else 0
    loaded = banned_modules()
    samples_per_step = entry.samples
    layer_inputs = entry.layer_inputs() if trace else None
    kept = entry.evidence(sample.kept) if hasattr(entry, 'evidence') else sample.kept
    entry.release()
    del entry
    free_card(device)
    if loaded:
        print(f'cardbench: banned modules loaded: {", ".join(loaded)}', file=sys.stderr)
        return 3
    checks = module.judge(cell, seed, device, kept)
    correct = checks_correct(checks)
    # the steps judged and found wrong: the sample (at least one) or none
    result = {'correct': correct, 'attempted': steps,
              'failed': 0 if correct else max(1, len(sample.kept))}
    if trace:
        metrics = {}
        for m in cell['per_layer']:
            value = metric_reader(m['name'], root).read(summary, layer_inputs)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
        result['metrics'] = metrics
        result['device'] = {**device_info(cell['chips'], peak, device), 'busy_s': summary.busy_s,
                            'window_s': summary.window_s}
        result['breakdown'] = summary.breakdown()
    else:
        values = end_to_end(cell, latencies, steps, window_s, samples_per_step, peak, setup_s)
        result['metrics'] = {m['name']: {'value': values[m['name']], 'unit': m['unit']}
                             for m in cell['end_to_end']}
        result['device'] = device_info(cell['chips'], peak, device)
    result['checks'] = {name: {'value': v, 'limit': lim} for name, v, lim in checks}
    if banned_modules():
        print(f'cardbench: banned modules loaded: {", ".join(banned_modules())}',
              file=sys.stderr)
        return 3
    say_checks(checks)
    print(json.dumps(result), flush=True)
    return 0
