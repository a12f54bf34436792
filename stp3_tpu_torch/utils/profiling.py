"""Tracing and timing (port of stp3_tpu/utils/profiling.py).

  * ``trace(logdir)``: ``torch.profiler`` over the CPU and, where there is
    one, the card, writing a TensorBoard-loadable trace
    (``<host>_<pid>.<time>.pt.trace.json``) into ``logdir`` when the
    context ends;
  * ``timed(fn, ...)``: the median wall-clock ms of ``fn`` over ``n``
    calls, each waited for on the card;
  * ``nan_guard()``: autograd's anomaly mode with its NaN check, the
    counterpart of ``jax_debug_nans``: the backward raises at the first
    op that returns a NaN, and names it.

The JAX module's ``start_server`` (a live capture endpoint) has no
counterpart: ``torch.profiler`` captures in process only.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Tuple

import torch


@contextlib.contextmanager
def trace(logdir: str):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)) as prof:
        yield prof


def start_server(port: int = 9999):
    raise NotImplementedError('torch.profiler has no live capture endpoint: trace a window '
                              'of steps with trace(logdir) instead')


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn: Callable, *args, n: int = 10, warmup: int = 1, **kwargs) -> Tuple[float, object]:
    """(median wall-clock ms over ``n`` calls, the last call's result); the
    card is synchronised after each call."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
        _sync()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync()
        times.append((time.perf_counter() - t0) * 1000.0)
    times.sort()
    return times[len(times) // 2], out


@contextlib.contextmanager
def nan_guard():
    with torch.autograd.detect_anomaly(check_nan=True):
        yield
