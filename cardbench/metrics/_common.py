"""What the per-layer metric readers share. A reader's ``read(summary,
inputs)`` takes the traced window's ``tracing.Summary`` and the entry's
``layer_inputs()`` and returns the metric's value, or None where the
window holds nothing to read."""
from __future__ import annotations

from typing import Optional

from cardbench.peaks import PEAK_FLOPS


def mfu(summary, inputs) -> Optional[float]:
    """% of the precision's peak: the model FLOPs of the traced steps over
    the traced window."""
    if not summary.n_steps or summary.window_s <= 0:
        return None
    flops = inputs['flops_per_step'] * summary.n_steps
    return 100.0 * flops / summary.window_s / PEAK_FLOPS[inputs['precision']]


def idle_share(summary, inputs) -> Optional[float]:
    """% of the traced window in which no kernel ran."""
    return 100.0 * (1.0 - summary.busy_s / summary.window_s)


def roofline(summary, inputs, kernel: str, counts: str) -> Optional[float]:
    """% of its roofline: the bound time of the traced launches of
    ``kernel`` (``inputs['bounds'][counts]``, from ``counts/kernels.py``)
    over their device time in the trace."""
    seconds, launches = summary.kernel_s(kernel)
    bound = inputs.get('bounds', {}).get(counts)
    if not launches or bound is None:
        return None
    return 100.0 * bound / seconds
