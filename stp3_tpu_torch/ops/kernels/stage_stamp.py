"""The stage stamp, ``csrc/stage_stamp.cu``: one thread writes the device's
``%globaltimer`` and a stamp id into the next slot of a ring on the card.

``utils/profiling.py`` owns the ring and the ids; this module builds the
kernel with nvcc at first use, binds it with ctypes and launches it on
the current stream. It is no compute kernel of the model: it has no
plain version and no launch counter (``launch_counters()`` leaves it
out), and its name holds none of the needles the benchmark's roofline
readers match.
"""
from __future__ import annotations

import ctypes

import torch

from stp3_tpu_torch.ops.kernels.nvcc_build import load_library

# words before the slots: the atomic index, then one unused word
HEADER_WORDS = 2

_LIB = {}


def build() -> dict:
    """Build (or reuse) and bind the kernel library; returns the build info
    from ``nvcc_build.load_library``."""
    lib, info = load_library('stage_stamp', ['stage_stamp.cu'])
    fn = lib.stage_stamp
    fn.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_ulonglong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _LIB['stage_stamp'] = fn
    return info


def stamp(ring: torch.Tensor, capacity: int, stamp_id: int) -> None:
    """One stamp into ``ring`` (int64, ``HEADER_WORDS + 2 * capacity``
    words on a card) on the current stream of the ring's device."""
    if 'stage_stamp' not in _LIB:
        build()
    with torch.cuda.device(ring.device):
        err = _LIB['stage_stamp'](ring.data_ptr(), capacity, stamp_id,
                                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'stage_stamp kernel launch failed: cudaError {err}')
