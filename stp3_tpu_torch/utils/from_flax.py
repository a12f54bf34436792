"""Load a ``stp3_tpu`` (flax) param tree into a module of this package.

Every torch module is named after its flax path, so the bridge is a
per-leaf layout transform plus a name check: the torch parameter
``a.b.kernel`` takes the flax leaf ``a/b/kernel`` through its owning
module's ``flax_leaf`` (conv HWIO -> OIHW, depthwise (kh, kw, 1, C) ->
(C, 1, kh, kw), conv3d DHWIO -> OIDHW, Dense (I, O) -> (O, I); norms,
biases and scalars as they are). The GRU cells are written in flax's own
layout and need nothing more.

The load is strict: every flax leaf must be consumed, every torch
parameter assigned, and a shape mismatch raises.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def flatten_tree(tree: Mapping, prefix: str = '') -> Dict[str, np.ndarray]:
    """Nested dict of arrays -> {'a/b/leaf': array}."""
    flat: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f'{prefix}/{k}' if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten_tree(v, path))
        else:
            flat[path] = np.asarray(v)
    return flat


def load_flax_params(module: torch.nn.Module, params: Mapping) -> torch.nn.Module:
    """Copy ``params`` (a flax 'params' tree of numpy-convertible arrays)
    into ``module`` in place, converting each leaf to the parameter's
    dtype. Raises KeyError on a missing or extra leaf, ValueError on a
    shape mismatch."""
    flat = flatten_tree(params)
    assigned = set()
    missing = []
    for mod_name, mod in module.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            path = '/'.join(mod_name.split('.') + [pname]) if mod_name else pname
            if path not in flat:
                missing.append(path)
                continue
            transform = getattr(mod, 'flax_leaf', None)
            arr = flat[path] if transform is None else transform(pname, flat[path])
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f'{path}: flax leaf {tuple(flat[path].shape)} maps to '
                                 f'{tuple(arr.shape)}, torch expects {tuple(p.shape)}')
            with torch.no_grad():
                p.copy_(torch.tensor(np.asarray(arr, np.float32), dtype=p.dtype))
            assigned.add(path)
    extra = sorted(set(flat) - assigned)
    if missing or extra:
        raise KeyError(f'flax/torch trees differ: {len(missing)} torch params without a '
                       f'flax leaf {missing[:5]}, {len(extra)} flax leaves unused '
                       f'{extra[:5]}')
    return module
