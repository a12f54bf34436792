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
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.nn as nn

from stp3_tpu_torch.ops.kernels import launch_counters

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


def _recover_from_failed_capture(caller, device) -> None:
    """Undo what a capture that raised leaves behind: the capture stream
    as the current stream, and the device's default generator still in
    capture (it would refuse every later draw: 'Offset increment outside
    graph capture'); the generator gets a fresh state of the same seed and
    offset."""
    torch.cuda.set_stream(caller)
    generator = torch.cuda.default_generators[device.index]
    generator.graphsafe_set_state(generator.clone_state())


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
        self._held = None                 # [(name, tensor, data_ptr at capture)]
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
        for buf, x in zip(graph.inputs, leaves):
            if buf is not None:
                buf.copy_(x)
        graph.graph.replay()
        self.launches_per_call = dict(graph.launches)
        return _fresh(graph.out_spec, graph.outputs)

    def _module_tensors(self):
        for i, module in enumerate(self._modules):
            for name, t in list(module.named_parameters()) + list(module.named_buffers()):
                yield f'{type(module).__name__}#{i}.{name}', t

    def _check_storage(self) -> None:
        """Raise if a parameter or buffer of ``modules`` no longer lies where
        the graphs read it."""
        if self._held is None:
            return
        for name, t, ptr in self._held:
            if t.data_ptr() != ptr:
                raise RuntimeError(
                    f'{self.name}: {name} was moved since its CUDA graph was captured (its '
                    'storage changed, as .to() does); the graph would read the old memory. '
                    'Compile the call again')

    def _capture(self, spec, leaves) -> _Graph:
        if self._held is None:
            self._held = [(name, t, t.data_ptr()) for name, t in self._module_tensors()]
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
            with torch.no_grad(), torch.cuda.graph(graph, pool=self.pool.handle()):
                reserved = torch.cuda.memory_reserved(device)
                out = self.fn(*args, **kwargs)
        except RuntimeError as err:
            _recover_from_failed_capture(caller, device)
            # the first error inside the capture, if the capture's end raised another
            first = err.__context__ or err
            raise RuntimeError(f'CUDA graph capture of {self.name} failed: {first}') from err
        launches = {k: v - before[k] for k, v in _read_launches().items()}
        outputs: list = []
        out_spec = _flatten(out, outputs)
        self.pool_bytes += torch.cuda.memory_reserved(device) - reserved
        self.capture_seconds = time.perf_counter() - t0
        return _Graph(graph, [x if isinstance(x, torch.Tensor) else None for x in static],
                      outputs, out_spec, launches)


def compiled(fn: Callable, *modules: nn.Module, pool: Optional[Pool] = None) -> Compiled:
    """``fn`` as a compiled fixed-shape call (the module docstring);
    ``modules`` are the modules whose parameters and buffers ``fn`` reads,
    ``pool`` a graph pool shared with other calls of the same owner."""
    return Compiled(fn, modules, pool)
