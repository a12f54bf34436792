"""Tracing (port of stp3_tpu/utils/profiling.py).

  * ``trace(logdir)``: ``torch.profiler`` over the CPU and, where there is
    one, the card, writing a TensorBoard-loadable trace
    (``<host>_<pid>.<time>.pt.trace.json``) into ``logdir`` when the
    context ends;
  * ``span(name)``: a host range (``torch.profiler.record_function``)
    while a profiler runs, so it lies in the profiler's trace beside the
    kernels, on its clock;
  * ``stage(name, where)``: a span, and on the card a begin and an end
    stamp on the current stream (``csrc/stage_stamp.cu``: the device's
    ``%globaltimer`` and the stamp's id into the next slot of a ring of
    ``RING_SLOTS`` slots, one ring a device). A stamp is a kernel, so a
    CUDA graph captured by ``utils/graphs`` records it and every replay
    writes it again: the stage's device time survives the replay, which
    carries no host range. On the CPU a stage records the host's
    ``perf_counter_ns`` instead;
  * ``window_spans()``: the stages of the last profiler window, as
    ``Span``s, each stage's begin paired with its end;
  * ``nan_guard()``: autograd's anomaly mode with its NaN check, the
    counterpart of ``jax_debug_nans``: the backward raises at the first
    op that returns a NaN, and names it.

With no profiler running, ``span`` and ``stage`` read one flag and
return a shared no-op context: no record, no allocation, no sync. While
``utils/graphs`` captures a graph, a stage on the card always stamps,
so that any later replay can be traced; the replays themselves are
counted (``replayed``), and their ring positions are kept only while a
profiler runs. The ring is read once, when the window's spans are asked
for, after a sync: no step gains a host sync, traced or not. A window is
the run of traced calls made while a profiler runs; it ends where a
replay, or ``window_spans``, finds the profiler stopped.

The JAX module's ``start_server`` (a live capture endpoint) has no
counterpart: ``torch.profiler`` captures in process only.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch
from torch.autograd import profiler as _autograd_profiler

from stp3_tpu_torch.ops.kernels import stage_stamp

# slots of a device's ring: (2 + 2 x RING_SLOTS) words of 8 bytes, exactly 1 MiB, the
# largest block the caching allocator serves from its small pool (2 MiB segments)
RING_SLOTS = 65535

_OFF = contextlib.nullcontext()


class Span(NamedTuple):
    """One stage of a window. ``device``: 'cuda:<i>' (times from that
    device's ``%globaltimer``) or 'cpu' (the host's ``perf_counter_ns``)."""
    name: str
    start_ns: int
    end_ns: int
    device: str

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


def _profiler_running() -> bool:
    return _autograd_profiler._is_profiler_enabled


# a stage's name -> its index; its begin stamp's id is 2 x index, its end's 2 x index + 1
_NAMES: List[str] = []
_INDEX: Dict[str, int] = {}


def _name_index(name: str) -> int:
    i = _INDEX.get(name)
    if i is None:
        i = _INDEX[name] = len(_NAMES)
        _NAMES.append(name)
    return i


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


class _Ring:
    """One device's ring (``words``) and the stamps put on its streams so
    far (the eager ones and each replay's), which is the position of the
    next."""

    def __init__(self, words: torch.Tensor):
        self.words, self.issued = words, 0


class _Recorder:
    """The process's rings and the marks of the current window: (device
    index, or None on the host; the ring position of the first stamp, or
    the host's ns; the stamp ids, in order)."""

    def __init__(self):
        self.rings: Dict[int, _Ring] = {}
        self.captured: Optional[list] = None   # the stamp ids of a capture in progress
        self.open = False
        self.marks: list = []
        self.spans: Optional[List[Span]] = None

    def ring(self, device: torch.device) -> _Ring:
        index = _device_index(device)
        if index not in self.rings:
            stage_stamp.build()
            self.rings[index] = _Ring(torch.zeros(
                stage_stamp.HEADER_WORDS + 2 * RING_SLOTS, dtype=torch.int64,
                device=torch.device('cuda', index)))
        return self.rings[index]

    def _record(self, where, position: int, stamps: Sequence[int]) -> None:
        if not self.open:
            self.open, self.marks = True, []
        self.marks.append((where, position, stamps))
        self.spans = None

    def mark(self, device: torch.device, stamp_id: int) -> None:
        if device.type != 'cuda':
            if _profiler_running():
                self._record(None, time.perf_counter_ns(), (stamp_id,))
            return
        if self.captured is not None:
            ring = self.rings.get(_device_index(device))
            if ring is None:
                raise RuntimeError('a stage inside a capture needs its ring made before it '
                                   '(utils/graphs makes it)')
            stage_stamp.stamp(ring.words, RING_SLOTS, stamp_id)
            self.captured.append(stamp_id)
            return
        # a capture not made by utils/graphs: its replays would not be counted
        if not _profiler_running() or torch.cuda.is_current_stream_capturing():
            return
        ring = self.ring(device)
        self._record(_device_index(device), ring.issued, (stamp_id,))
        stage_stamp.stamp(ring.words, RING_SLOTS, stamp_id)
        ring.issued += 1

    def replayed(self, device_index: int, stamps: Sequence[int]) -> None:
        if not stamps:
            return
        ring = self.rings[device_index]
        if _profiler_running():
            self._record(device_index, ring.issued, stamps)
        else:
            self.open = False
        ring.issued += len(stamps)

    def read(self) -> List[Span]:
        words = {}
        for index in {where for where, _, _ in self.marks if where is not None}:
            ring = self.rings[index]
            if ring.words.is_cuda:
                torch.cuda.synchronize(ring.words.device)
            words[index] = ring.words.cpu().numpy()
            written = int(words[index][0])
            if written != ring.issued:
                raise RuntimeError(f'the stamp ring of cuda:{index} was written {written} times '
                                   f'but {ring.issued} stamps were counted')
        marks = []                                  # (clock, ns, stamp id) in stream order
        for where, position, stamps in self.marks:
            if where is None:
                marks.append(('cpu', position, stamps[0]))
                continue
            ring = words[where]
            if self.rings[where].issued - position > RING_SLOTS:
                raise RuntimeError(f'more than {RING_SLOTS} stamps since the window began: the '
                                   'ring came round before it was read')
            for k, stamp_id in enumerate(stamps):
                slot = stage_stamp.HEADER_WORDS + 2 * ((position + k) % RING_SLOTS)
                if int(ring[slot + 1]) != stamp_id:
                    raise RuntimeError(f'stamp {position + k} of cuda:{where} holds id '
                                       f'{int(ring[slot + 1])}, not {stamp_id}')
                marks.append((f'cuda:{where}', int(ring[slot]), stamp_id))
        return _pair(marks)


def _pair(marks) -> List[Span]:
    """Each begin paired with the next end of its name on its clock (a
    stage inside itself pairs inside out); a begin or end without its
    other half is left out."""
    open_: Dict[tuple, List[int]] = {}
    spans = []
    for clock, ns, stamp_id in marks:
        index, end = divmod(stamp_id, 2)
        begins = open_.setdefault((clock, index), [])
        if not end:
            begins.append(ns)
        elif begins:
            spans.append(Span(_NAMES[index], begins.pop(), ns, clock))
    spans.sort(key=lambda s: (s.device, s.start_ns, -s.end_ns))
    return spans


_RECORDER = _Recorder()


def span(name: str):
    """A host range named ``name`` while a profiler runs; else nothing."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


class _Stage:
    __slots__ = ('name', 'device', 'begin', 'range')

    def __init__(self, name: str, device: torch.device):
        self.name, self.device = name, device
        self.begin = 2 * _name_index(name)
        self.range = None

    def __enter__(self):
        if _profiler_running():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        _RECORDER.mark(self.device, self.begin)
        return self

    def __exit__(self, *exc):
        _RECORDER.mark(self.device, self.begin + 1)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def stage(name: str, where):
    """A span named ``name`` and, on the device of ``where`` (a tensor or
    a device), the stage's begin and end (the module docstring)."""
    if not (_autograd_profiler._is_profiler_enabled or _RECORDER.captured is not None):
        return _OFF
    return _Stage(name, where.device if isinstance(where, torch.Tensor) else torch.device(where))


@contextlib.contextmanager
def capturing(device: torch.device):
    """Within: a capture of ``utils/graphs`` on ``device`` (the ring is
    made first, outside the capture); yields the list that receives the
    ids of the stamps the capture records, in order."""
    _RECORDER.ring(device)
    _RECORDER.captured = []
    try:
        yield _RECORDER.captured
    finally:
        _RECORDER.captured = None


def replayed(device_index: int, stamps: Sequence[int]) -> None:
    """A replay of a graph holding ``stamps`` on ``device_index`` was put on
    its stream: the ring positions it takes."""
    _RECORDER.replayed(device_index, stamps)


def window_spans() -> List[Span]:
    """The stages of the last profiler window, sorted by clock and start.
    The first call after the window reads the rings (a sync); later calls
    return the same spans."""
    if not _profiler_running():
        _RECORDER.open = False
    if _RECORDER.spans is None:
        _RECORDER.spans = _RECORDER.read()
    return list(_RECORDER.spans)


def mean_ms(spans: Sequence[Span], steps: int) -> Dict[str, float]:
    """Each stage's time a step: its spans' ms summed over ``steps``, by name."""
    out: Dict[str, float] = {}
    for s in spans:
        out[s.name] = out.get(s.name, 0.0) + s.ms / steps
    return out


@contextlib.contextmanager
def trace(logdir: str):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)) as prof:
        yield prof


@contextlib.contextmanager
def nan_guard():
    with torch.autograd.detect_anomaly(check_nan=True):
        yield
