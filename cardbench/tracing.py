"""The traced window: ``torch.profiler`` over the CPU and the card, reduced
to what the per-layer metrics read.

The window runs from the start of the first timed step to the end of the last device
kernel. The device is busy where some kernel runs (the union of the
kernels' intervals); a gap is an interval in the window where none runs,
named by the innermost host operation running at its middle. Each timed
step is a ``cardbench.step`` range on the host.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

STEP = 'cardbench.step'


@contextlib.contextmanager
def profiled():
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof
        torch.cuda.synchronize()


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals, as disjoint sorted intervals."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def covered(union: List[Tuple[float, float]], s: float, e: float) -> float:
    """The length of [s, e) that the disjoint ``union`` covers."""
    return sum(max(0.0, min(e, b) - max(s, a)) for a, b in union)


class Summary:
    """Times in seconds. ``kernels``: {name: [device seconds, launches]}
    over the window; ``steps``: the (start, end) host interval of each
    timed step; ``busy``: the merged kernel intervals."""

    def __init__(self, kernels: Dict[str, list], busy: List[Tuple[float, float]],
                 host: List[Tuple[float, float, str]], steps: List[Tuple[float, float]],
                 window: Tuple[float, float], n_steps: int):
        self.kernels, self.busy, self.host, self.step_spans = kernels, busy, host, steps
        self.window = window
        self.n_steps = n_steps
        self.window_s = window[1] - window[0]
        self.busy_s = sum(e - s for s, e in busy)

    def kernel_s(self, needle: str) -> Tuple[float, int]:
        """Device seconds and launches of the kernels whose name holds ``needle``."""
        t, n = 0.0, 0
        for name, (s, k) in self.kernels.items():
            if needle in name:
                t, n = t + s, n + k
        return t, n

    def step_busy_s(self) -> List[Tuple[float, float]]:
        """(wall, device-busy) seconds of each timed step."""
        return [(e - s, covered(self.busy, s, e)) for s, e in self.step_spans]

    def gaps(self) -> List[Tuple[float, float]]:
        edges, prev = [], self.window[0]
        for s, e in self.busy:
            if s > prev:
                edges.append((prev, s))
            prev = max(prev, e)
        if self.window[1] > prev:
            edges.append((prev, self.window[1]))
        return edges

    def host_at(self, t: float) -> str:
        """The innermost host operation running at ``t``."""
        best = None
        for s, e, name in self.host:
            if s <= t < e and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        return best[2] if best else 'idle host'

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(((n, v[0]) for n, v in self.kernels.items()), key=lambda kv: -kv[1])
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return {'device_ops': [[n[:200], s] for n, s in ops[:top]],
                'idle_gaps': [[self.host_at((s + e) / 2)[:200], e - s] for s, e in gaps]}


def summarise(prof, n_steps: int) -> Summary:
    """The profiler's events reduced to a ``Summary`` of ``n_steps`` steps."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    kernels: Dict[str, list] = {}
    intervals, host, steps = [], [], []
    last = None
    for e in prof.events():
        s, t = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == cuda and (e.name == STEP or getattr(e, 'is_user_annotation', False)):
            continue                       # the step's range, drawn on the device's track
        if e.device_type == cuda:
            acc = kernels.setdefault(e.name, [0.0, 0])
            acc[0] += t - s
            acc[1] += 1
            intervals.append((s, t))
            last = t if last is None else max(last, t)
        else:
            host.append((s, t, e.name))
            if e.name == STEP:
                steps.append((s, t))
    if not intervals:
        raise RuntimeError('the traced window holds no device kernel')
    steps.sort()
    return Summary(kernels, merge(intervals), host, steps,
                   (steps[0][0], max(last, steps[-1][1])), n_steps)
