"""What the per-stage readers share: the port's stages of the traced
window (``stp3_tpu_torch.utils.profiling.window_spans``: device time
from the stage stamps, which CUDA-graph replays write too) and the host
ranges of the window by name (``summary.host``). A value is the mean
over the traced steps of the time the stage or range took within a
step, in ms, or None where the window holds none of it (a port without
these stages)."""
from __future__ import annotations

from typing import Optional


def window_spans():
    """The port's stages of the last profiler window, or None where the
    port records none."""
    from stp3_tpu_torch.utils import profiling
    read = getattr(profiling, 'window_spans', None)
    return None if read is None else read()


def stage_ms(summary, name: str) -> Optional[float]:
    """The device time of the port's stage ``name`` a traced step."""
    spans = [s for s in window_spans() or () if s.name == name]
    if not spans or not summary.n_steps:
        return None
    return 1e-6 * sum(s.end_ns - s.start_ns for s in spans) / summary.n_steps


def host_ms(summary, name: str) -> Optional[float]:
    """The host time of the range ``name`` a traced step."""
    ranges = [(s, e) for s, e, n in summary.host if n == name]
    if not ranges or not summary.n_steps:
        return None
    return 1e3 * sum(e - s for s, e in ranges) / summary.n_steps
