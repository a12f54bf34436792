"""Compiled fixed-shape calls: the port's counterpart of ``jax.jit`` for a
call whose shapes do not change from call to call (a serving step, an
agent tick).

``compiled(fn, *modules)`` returns a callable. On CUDA tensors its first
call with a new signature (the tensor arguments' shapes, dtypes and
devices, and every other argument's value) runs ``fn`` eagerly a few
times on a side stream (kernel builds, cuDNN and cuBLAS set-up, the
kernels' one-time attributes), copies the tensor arguments into static
buffers and captures one call as a ``torch.cuda.CUDAGraph``; a later call
with that signature copies its tensors into those buffers and replays the
graph. A new signature captures a new graph, as jit traces again. Every
call returns fresh tensors (clones of the graph's outputs), as a JAX call
returns fresh arrays: a caller may feed an output back in as the next
input. On CPU tensors the callable calls ``fn`` eagerly, and clones its
outputs the same way. Either way ``fn`` runs under ``torch.no_grad()``:
a compiled call is forward-only.

What a graph cannot see changes: it reads ``modules``' parameters and
buffers at the addresses they had at capture, so weights updated in place
(``load_state_dict``) are read, while a tensor whose storage moved (after
``.to()``) makes the callable raise. Every other tensor that ``fn``
reads without taking it as an argument is a constant of the graph, as are
its Python control flow and the values it read on the host at capture.
A capture that fails raises, naming the call; a compiled call never runs
eagerly on the card instead.

The kernels' launch counters (``ops/kernels.launch_counters``) count
host calls, so a replay does not move them: ``launches_per_call`` holds
the launches each kernel made while the last call's graph was captured.
A capture records the stamps of ``utils/profiling.stage`` inside ``fn``,
and a replay tells ``profiling`` which ring positions they take; while a
profiler runs each replay (copy-in, launch, output clones) is a
``graph.replay`` host range.

``compiled_step(fn, *modules, optimizer=, generators=, device=)`` is the
training counterpart (the JAX trainer's jitted step): ``fn`` runs with
autograd on, may call ``backward`` and an optimizer's ``step``, and
returns detached tensors. On the card the first ``WARMUP_CALLS`` calls of
a signature are real calls, run eagerly on a side stream (torch's
whole-network recipe: a warm-up that repeated one batch would update the
parameters more often than the caller asked); the next call captures the
graph and replays it, and so does every later call. The call's explicit
``generators`` are registered with each graph, so every replay draws new
numbers from them and leaves them where the same eager call would
(``remat``'s rewinds inside the capture use states registered beside
them: ``utils/rng.py``). Besides the modules' parameters and buffers, the
graphs read the optimizer's state tensors and the parameters' ``.grad``
where they lay at capture: ``fn`` must update them in place (``zero_grad``
with ``set_to_none=False``), and a ``.grad`` set anew or an optimizer
state replaced (``load_state_dict``) makes the call raise. A capture that
fails raises, with the caller's stream and every registered generator
usable; the call never runs eagerly on the card instead. On the CPU ``fn``
runs eagerly, with autograd.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from stp3_tpu_torch.ops.kernels import launch_counters
from stp3_tpu_torch.utils import profiling, rng

# eager calls before a capture (torch.cuda.graph's recipe)
WARMUP_CALLS = 3
_LEAF = '*'


def _flatten(tree, leaves: list):
    """The structure of nested tuples, lists and dicts, hashable, with
    every other object appended to ``leaves`` in order."""
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, tuple(_flatten(t, leaves) for t in tree))
    if isinstance(tree, dict):
        return ('dict', tuple(tree), tuple(_flatten(v, leaves) for v in tree.values()))
    leaves.append(tree)
    return _LEAF


def _unflatten(spec, leaves):
    """``_flatten``'s inverse over an iterator of leaves."""
    if spec == _LEAF:
        return next(leaves)
    if spec[0] == 'dict':
        return {k: _unflatten(s, leaves) for k, s in zip(spec[1], spec[2])}
    children = [_unflatten(s, leaves) for s in spec[1]]
    return tuple(children) if spec[0] == 'tuple' else children


def _leaf_key(leaf):
    if isinstance(leaf, torch.Tensor):
        return ('tensor', tuple(leaf.shape), leaf.dtype, leaf.device)
    try:
        hash(leaf)
    except TypeError:
        raise TypeError(f'a compiled call takes tensors and hashable values, got '
                        f'{type(leaf).__name__}') from None
    return ('value', type(leaf), leaf)


def _split(args, kwargs):
    """(structure, leaves, signature) of a call's arguments."""
    leaves: list = []
    spec = _flatten((args, kwargs), leaves)
    return spec, leaves, (spec, tuple(_leaf_key(x) for x in leaves))


def signature(*args, **kwargs):
    """The key a compiled call keeps a graph under: the arguments'
    structure, each tensor's shape, dtype and device, and every other
    argument's type and value (which must be hashable)."""
    return _split(args, kwargs)[2]


def _fresh(spec, leaves):
    """The output tree with every tensor cloned."""
    return _unflatten(spec, (x.clone() if isinstance(x, torch.Tensor) else x for x in leaves))


def _read_launches() -> Dict[str, int]:
    return {name: fn.launches for name, fn in launch_counters().items()}


def _recover_from_failed_capture(caller, device, own_states=()) -> None:
    """Undo what a capture that raised leaves behind: the capture stream
    as the current stream, and the device's default generator still in
    capture (it would refuse every later draw: 'Offset increment outside
    graph capture'); the generator gets a fresh state of the same seed and
    offset. ``own_states``: (generator, its ``graphsafe_get_state()`` from
    before the capture) of every other generator registered with the
    graph, which gets a fresh state of that one (a capture that failed
    within a rewind leaves the generator on a rewind state)."""
    torch.cuda.set_stream(caller)
    generator = torch.cuda.default_generators[device.index]
    generator.graphsafe_set_state(generator.clone_state())
    for generator, own in own_states:
        generator.graphsafe_set_state(own.clone_state())


@contextlib.contextmanager
def _no_collection():
    """Within (a capture): no garbage collection. Dead cycles are collected
    first; a collection during a capture could free another CUDA graph
    (an owner of compiled calls and its calls refer to each other), whose
    destruction is not permitted while a stream captures and would
    invalidate the capture."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def _capture_error(name: str, err: BaseException) -> RuntimeError:
    # the first error inside the capture, if the capture's end raised another
    first = err.__context__ or err
    return RuntimeError(f'CUDA graph capture of {name} failed: {first}')


class Pool:
    """One graph memory pool that the graphs of one owner share (they are
    replayed one at a time, on one stream). The pool is made at the first
    capture: a build of torch without CUDA has none."""

    def __init__(self):
        self._handle = None

    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle


@dataclasses.dataclass
class _Graph:
    graph: Any                        # torch.cuda.CUDAGraph
    inputs: List[Optional[torch.Tensor]]
    outputs: list
    out_spec: Any
    launches: Dict[str, int]
    device: int                       # the index of the card it runs on
    stamps: Tuple[int, ...]           # the ids of the stage stamps it holds, in order


class Compiled:
    """``fn`` compiled for fixed shapes; see the module docstring.

    ``captures``: graphs captured so far; ``launches_per_call``: each
    kernel's launches in the last call's graph; ``capture_seconds``: the
    last capture's warm-up and capture; ``pool_bytes``: what the captures
    added to the memory the caching allocator holds (the graph pool's
    share of the captures made so far)."""

    def __init__(self, fn: Callable, modules=(), pool: Optional[Pool] = None):
        self.fn = fn
        self.name = getattr(fn, '__qualname__', repr(fn))
        self.pool = pool if pool is not None else Pool()
        self._modules = tuple(modules)
        self._graphs: Dict[Any, _Graph] = {}
        self._held = None                 # [(name, getter, data_ptr at capture)]
        self.launches_per_call: Dict[str, int] = {}
        self.capture_seconds = 0.0
        self.pool_bytes = 0

    @property
    def captures(self) -> int:
        return len(self._graphs)

    def __call__(self, *args, **kwargs):
        spec, leaves, key = _split(args, kwargs)
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        if not any(t.is_cuda for t in tensors):
            with torch.no_grad():
                out = self.fn(*args, **kwargs)
            out_leaves: list = []
            return _fresh(_flatten(out, out_leaves), out_leaves)
        if not all(t.is_cuda for t in tensors):
            raise ValueError(f'{self.name}: a compiled call on the card takes CUDA tensors '
                             'only (a host tensor would be read once, at capture)')
        self._check_storage()
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = self._capture(spec, leaves)
        with profiling.span('graph.replay'):
            for buf, x in zip(graph.inputs, leaves):
                if buf is not None:
                    buf.copy_(x)
            graph.graph.replay()
            profiling.replayed(graph.device, graph.stamps)
            self.launches_per_call = dict(graph.launches)
            return _fresh(graph.out_spec, graph.outputs)

    def _held_tensors(self):
        """(name, getter, what moved it) of each tensor that the graphs read
        or write where it lay at capture, besides their inputs."""
        for i, module in enumerate(self._modules):
            for name, t in list(module.named_parameters()) + list(module.named_buffers()):
                yield (f'{type(module).__name__}#{i}.{name}', lambda t=t: t,
                       'was moved (its storage changed, as .to() does)')

    def _hold(self) -> None:
        if self._held is None:
            self._held = [(name, get, why, _ptr(get()))
                          for name, get, why in self._held_tensors()]

    def _check_storage(self) -> None:
        """Raise if a tensor the graphs read by address no longer lies
        where they read it."""
        if self._held is None:
            return
        for name, get, why, ptr in self._held:
            if _ptr(get()) != ptr:
                raise RuntimeError(
                    f'{self.name}: {name} {why} since its CUDA graph was captured; the graph '
                    'would use the old memory. Compile the call again')

    def _capture(self, spec, leaves) -> _Graph:
        self._hold()
        t0 = time.perf_counter()
        device = next(x.device for x in leaves if isinstance(x, torch.Tensor))
        with torch.inference_mode(False):
            # static buffers usable in and out of inference mode
            static = [x.clone() if isinstance(x, torch.Tensor) else x for x in leaves]
        args, kwargs = _unflatten(spec, iter(static))
        caller = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(caller)
        with torch.cuda.stream(side), torch.no_grad():
            for _ in range(WARMUP_CALLS):
                self.fn(*args, **kwargs)
        caller.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = _read_launches()
        try:
            with profiling.capturing(device) as stamps, _no_collection(), torch.no_grad(), \
                    torch.cuda.graph(graph, pool=self.pool.handle()):
                reserved = torch.cuda.memory_reserved(device)
                out = self.fn(*args, **kwargs)
        except RuntimeError as err:
            _recover_from_failed_capture(caller, device)
            raise _capture_error(self.name, err) from err
        return self._captured(graph, static, out, before, reserved, t0, device, stamps)

    def _captured(self, graph, static, out, before, reserved, t0, device, stamps) -> _Graph:
        """The record of a capture that ended well: its launches, outputs,
        inputs, its share of the pool and its time."""
        launches = {k: v - before[k] for k, v in _read_launches().items()}
        outputs: list = []
        out_spec = _flatten(out, outputs)
        self.pool_bytes += torch.cuda.memory_reserved(device) - reserved
        self.capture_seconds = time.perf_counter() - t0
        return _Graph(graph, [x if isinstance(x, torch.Tensor) else None for x in static],
                      outputs, out_spec, launches, device.index, tuple(stamps))


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


class CompiledStep(Compiled):
    """A training call compiled for fixed shapes; see the module docstring.

    ``device``: where the call runs (a call may take no tensor); ``name``:
    the call's name in errors. ``captures``, ``launches_per_call`` (on a
    warm-up call: that eager call's launches), ``capture_seconds`` and
    ``pool_bytes`` as ``Compiled``'s; ``eager_calls``: the warm-up calls
    made so far."""

    def __init__(self, fn: Callable, modules=(), optimizer=None, generators=(),
                 device=None, pool: Optional[Pool] = None, name: Optional[str] = None):
        super().__init__(fn, modules, pool)
        self.name = name or self.name
        self.optimizer = optimizer
        self.device = torch.device(device) if device is not None else torch.device('cpu')
        if self.device.type == 'cuda' and self.device.index is None:
            self.device = torch.device('cuda', torch.cuda.current_device())
        self.generators = [g for g in generators if g.device.type == 'cuda']
        # a signature's eager calls made, and the last one's generator snapshots
        self._warm: Dict[Any, Tuple[int, list]] = {}
        self._rewinds: Dict[Any, rng.Rewinds] = {}
        self._side = None
        self.eager_calls = 0

    def _held_tensors(self):
        yield from super()._held_tensors()
        if self.optimizer is None:
            return
        params = [p for group in self.optimizer.param_groups for p in group['params']]
        for j, p in enumerate(params):
            yield (f'the gradient of parameter {j}', lambda p=p: p.grad,
                   'was set anew (as zero_grad(set_to_none=True) does)')
            for key in self.optimizer.state.get(p, {}):
                yield (f"the optimizer's {key!r} of parameter {j}",
                       lambda p=p, key=key: _tensor_or_none(
                           self.optimizer.state.get(p, {}).get(key)),
                       'was replaced (as the optimizer\'s load_state_dict does)')

    def __call__(self, *args, **kwargs):
        spec, leaves, key = _split(args, kwargs)
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        if self.device.type != 'cuda':
            out = self.fn(*args, **kwargs)
            out_leaves: list = []
            return _fresh(_flatten(out, out_leaves), out_leaves)
        if not all(t.device == self.device for t in tensors):
            raise ValueError(f'{self.name}: a compiled call on {self.device} takes tensors on '
                             'it only (another tensor would be read once, at capture)')
        self._check_storage()
        graph = self._graphs.get(key)
        if graph is None and self._warm.get(key, (0,))[0] < WARMUP_CALLS:
            return self._eager(key, args, kwargs)
        if graph is None:
            graph = self._graphs[key] = self._capture_step(spec, leaves, key)
        with profiling.span('graph.replay'):
            for buf, x in zip(graph.inputs, leaves):
                if buf is not None:
                    buf.copy_(x)
            self._rewinds[key].position()
            graph.graph.replay()
            profiling.replayed(graph.device, graph.stamps)
            self.launches_per_call = dict(graph.launches)
            return _fresh(graph.out_spec, graph.outputs)

    def _eager(self, key, args, kwargs):
        """A warm-up call: the real call, eagerly, on a side stream."""
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        caller = torch.cuda.current_stream(self.device)
        self._side.wait_stream(caller)
        rewinds = rng.Rewinds(self.generators)
        before = _read_launches()
        with torch.cuda.stream(self._side), rewinds.recording():
            out = self.fn(*args, **kwargs)
        caller.wait_stream(self._side)
        self.launches_per_call = {k: v - before[k] for k, v in _read_launches().items()}
        self._warm[key] = (self._warm.get(key, (0,))[0] + 1, rewinds.offsets)
        self.eager_calls += 1
        out_leaves: list = []
        return _fresh(_flatten(out, out_leaves), out_leaves)

    def _capture_step(self, spec, leaves, key) -> _Graph:
        self._hold()
        t0 = time.perf_counter()
        device = self.device
        static = [x.clone() if isinstance(x, torch.Tensor) else x for x in leaves]
        args, kwargs = _unflatten(spec, iter(static))
        caller = torch.cuda.current_stream(device)
        graph = torch.cuda.CUDAGraph()
        rewinds = rng.Rewinds(self.generators, self._warm[key][1])
        own = [(g, g.graphsafe_get_state()) for g in self.generators]
        before = _read_launches()
        try:
            rewinds.register(graph)
            with profiling.capturing(device) as stamps, _no_collection(), rewinds.capturing(), \
                    torch.cuda.graph(graph, pool=self.pool.handle()):
                reserved = torch.cuda.memory_reserved(device)
                out = self.fn(*args, **kwargs)
        except RuntimeError as err:
            _recover_from_failed_capture(caller, device, own)
            raise _capture_error(self.name, err) from err
        self._rewinds[key] = rewinds
        return self._captured(graph, static, out, before, reserved, t0, device, stamps)


def _tensor_or_none(x) -> Optional[torch.Tensor]:
    return x if isinstance(x, torch.Tensor) else None


def compiled_step(fn: Callable, *modules: nn.Module, optimizer=None, generators=(),
                  device=None, pool: Optional[Pool] = None,
                  name: Optional[str] = None) -> CompiledStep:
    """``fn`` as a compiled fixed-shape training call (the module
    docstring): ``modules`` and ``optimizer`` hold the tensors it updates
    in place, ``generators`` the random streams it draws from."""
    return CompiledStep(fn, modules, optimizer, generators, device, pool, name)


def compiled(fn: Callable, *modules: nn.Module, pool: Optional[Pool] = None) -> Compiled:
    """``fn`` as a compiled fixed-shape call (the module docstring);
    ``modules`` are the modules whose parameters and buffers ``fn`` reads,
    ``pool`` a graph pool shared with other calls of the same owner."""
    return Compiled(fn, modules, pool)
