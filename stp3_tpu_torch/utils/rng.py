"""Rewinding a ``torch.Generator`` for a recomputation (``layers/base.remat``),
on the CPU, on the card, and inside a CUDA graph capture.

A checkpointed call's backward recomputes its forward, which must draw the
same dropout masks again: ``snapshot(g)`` at the forward keeps where ``g``
stood, and ``rewound(gens, snaps)`` draws from there during the
recomputation, leaving each generator where it was afterwards.

  * CPU generator: ``get_state()`` / ``set_state()``.
  * CUDA generator, eager: a ``clone_state()`` at the forward, swapped in
    with ``graphsafe_set_state`` for the recomputation and swapped out
    again (``graphsafe_get_state`` keeps the generator's own state).
  * CUDA generator inside a capture: a state's host seed and offset say
    nothing about the draw the graph will make (the offset of a draw in a
    graph is read from the device at each replay), and a state can draw
    in a capture only if it was registered with the graph before the
    capture began. So a compiled training call (``utils/graphs``) records,
    in its eager warm-up calls, each snapshot's offset from the call's
    start (``Rewinds.recording``), registers one cloned state per snapshot
    with the graph (``Rewinds.register``), hands them out in order during
    the capture, and sets each to its generator's seed and offset plus the
    recorded distance before every replay (``Rewinds.position``): the
    recomputation then draws exactly what the forward drew in that replay.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import torch

# the warm-up call being recorded, and the capture handing out rewind states
# (process-wide: the recomputation runs on autograd's device thread)
_recording: Optional['Rewinds'] = None
_capture: Optional['Rewinds'] = None


def _is_cuda(g: torch.Generator) -> bool:
    return g.device.type == 'cuda'


def snapshot(g: torch.Generator):
    """Where ``g`` stands, for ``rewound``."""
    if not _is_cuda(g):
        return g.get_state()
    if torch.cuda.is_current_stream_capturing():
        if _capture is None:
            raise RuntimeError(
                'a generator rewound inside a CUDA graph capture needs a rewind state '
                'registered before the capture began: capture the call with '
                'utils.graphs.compiled_step(..., generators=...)')
        return _capture.take(g)
    if _recording is not None:
        _recording.note(g)
    return g.clone_state()


@contextlib.contextmanager
def rewound(gens: Sequence[torch.Generator], snaps: Sequence):
    """Within: each generator at its snapshot; after: where it was."""
    cuda = [_is_cuda(g) for g in gens]
    now = [g.graphsafe_get_state() if c else g.get_state() for g, c in zip(gens, cuda)]
    for g, s, c in zip(gens, snaps, cuda):
        if not c:
            g.set_state(s)
        elif torch.cuda.is_current_stream_capturing():
            g.graphsafe_set_state(s)          # a registered state, used once
        else:
            g.graphsafe_set_state(s.clone_state())
    try:
        yield
    finally:
        for g, s, c in zip(gens, now, cuda):
            if c:
                g.graphsafe_set_state(s)
            else:
                g.set_state(s)


class Rewinds:
    """The rewind states of one captured graph of a compiled training call
    (see the module docstring). ``generators``: the call's explicit CUDA
    generators; ``offsets``: (generator index, offset from the call's
    start) of each snapshot of an eager call, in order."""

    def __init__(self, generators: Sequence[torch.Generator],
                 offsets: Sequence[Tuple[int, int]] = ()):
        self.generators = list(generators)
        self.offsets = list(offsets)
        self.states: List[torch.Generator] = []
        self._start: List[int] = []
        self._taken = 0

    def _index(self, g: torch.Generator) -> int:
        for i, h in enumerate(self.generators):
            if h is g:
                return i
        raise RuntimeError('a generator that the compiled call was not given was rewound '
                           'in it: pass it in generators=')

    @contextlib.contextmanager
    def recording(self):
        """Within (an eager call): note each snapshot's offset from here."""
        global _recording
        self.offsets, self._start = [], [g.get_offset() for g in self.generators]
        _recording = self
        try:
            yield
        finally:
            _recording = None

    def note(self, g: torch.Generator) -> None:
        i = self._index(g)
        self.offsets.append((i, g.get_offset() - self._start[i]))

    def register(self, graph) -> None:
        """Register the generators and one cloned state a snapshot with
        ``graph`` (before its capture)."""
        self.states = [self.generators[i].clone_state() for i, _ in self.offsets]
        for g in self.generators + self.states:
            graph.register_generator_state(g)

    @contextlib.contextmanager
    def capturing(self):
        """Within (the capture): snapshots take the registered states in
        order; a capture that takes other snapshots than the eager call
        noted raises."""
        global _capture
        self._taken, _capture = 0, self
        try:
            yield
        finally:
            _capture = None
        if self._taken != len(self.offsets):
            raise RuntimeError(f'the capture rewound generators {self._taken} times where '
                               f'its eager warm-up call did {len(self.offsets)} times')

    def take(self, g: torch.Generator) -> torch.Generator:
        k = self._taken
        if k >= len(self.offsets) or self.generators[self.offsets[k][0]] is not g:
            raise RuntimeError('the capture rewinds generators otherwise than its eager '
                               'warm-up call did')
        self._taken += 1
        return self.states[k]

    def position(self) -> None:
        """Before a replay: each rewind state at its generator's seed and
        offset plus the distance its snapshot lay from the call's start."""
        for (i, off), state in zip(self.offsets, self.states):
            g = self.generators[i]
            state.set_state(g.get_state())
            state.set_offset(g.get_offset() + off)
