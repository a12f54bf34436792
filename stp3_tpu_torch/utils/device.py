"""Where the port's entry points run, and moving arrays between the host
and a device."""
from __future__ import annotations

import functools

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names a device; no card and no name
    raises (no silent CPU run)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return torch.device('cuda', 0)


def as_tensor(x, device=None) -> torch.Tensor:
    """A tensor of ``x``: a tensor stays where it is unless ``device``
    names another place; an array goes to ``device`` (default the CPU)."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def as_numpy(x) -> np.ndarray:
    """A host numpy array of a tensor (on any device) or an array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@functools.lru_cache(maxsize=64)
def constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A 1-D tensor of constant ``values``, made once for each dtype and
    device and shared; callers do not write to it. A constant made from
    the host on every call is a host-to-device copy in every step, which
    waits for the stream to drain and which a CUDA graph cannot capture.
    Made outside inference mode, so autograd may save it."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def to_host(tensors) -> dict:
    """{name: host numpy array} of a dict of tensors with one wait for the
    device: every copy from the card is queued (into pinned memory), then
    the stream is synchronised once."""
    copies = {k: t.to('cpu', non_blocking=True) if t.is_cuda else t for k, t in tensors.items()}
    devices = {t.device for t in tensors.values() if t.is_cuda}
    for device in devices:
        torch.cuda.current_stream(device).synchronize()
    return {k: t.detach().numpy() for k, t in copies.items()}


def rows_to_device(mask: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host bool array on ``device``; to the card from pinned memory,
    without waiting for the stream."""
    t = torch.from_numpy(np.array(mask, dtype=bool))
    if torch.device(device).type != 'cuda':
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
