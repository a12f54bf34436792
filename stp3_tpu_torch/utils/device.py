"""Where the port's entry points run, and moving arrays between the host
and a device."""
from __future__ import annotations

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
