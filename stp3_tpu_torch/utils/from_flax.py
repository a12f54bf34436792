"""Load a ``stp3_tpu`` (flax) param tree, and its ``batch_stats``, into a
module of this package, and read them back out (``to_flax``).

Every torch module is named after its flax path, so the bridge is a
per-leaf layout transform plus a name check: the torch parameter
``a.b.kernel`` takes the flax leaf ``a/b/kernel`` through its owning
module's ``flax_leaf`` (conv HWIO -> OIHW, depthwise (kh, kw, 1, C) ->
(C, 1, kh, kw), conv3d DHWIO -> OIDHW, Dense (I, O) -> (O, I), transposed
conv -> (in, out, kh, kw); norms, biases and scalars as they are). The
GRU cells are written in flax's own layout and need nothing more.

The BatchNorm kinds' running statistics are buffers (``mean``, ``var``):
'bn_frozen''s come from the 'params' tree (flax keeps them there, as
non-trainable params), 'bn''s from the 'batch_stats' tree.

The load is strict: every flax leaf must be consumed, every torch
parameter and statistics buffer assigned, and a shape mismatch raises.
``to_flax`` is its inverse: each leaf through its module's
``to_flax_leaf``, the exact inverse of ``flax_leaf``, so
``to_flax(load_flax_variables(m, v)) == v`` bit for bit for fp32 ``v``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from stp3_tpu_torch.layers.base import Norm


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


def _leaves(module: torch.nn.Module):
    """(flax path, owning module, leaf name, tensor, collection) of every
    parameter and every BatchNorm statistics buffer of ``module``."""
    for mod_name, mod in module.named_modules():
        prefix = mod_name.split('.') if mod_name else []
        for pname, p in mod.named_parameters(recurse=False):
            yield '/'.join(prefix + [pname]), mod, pname, p, 'params'
        if isinstance(mod, Norm) and mod.kind in ('bn', 'bn_frozen'):
            collection = 'batch_stats' if mod.kind == 'bn' else 'params'
            for bname in ('mean', 'var'):
                yield '/'.join(prefix + [bname]), mod, bname, getattr(mod, bname), collection


def load_flax_params(module: torch.nn.Module, params: Mapping,
                     batch_stats: Optional[Mapping] = None) -> torch.nn.Module:
    """Copy ``params`` (a flax 'params' tree of numpy-convertible arrays)
    and ``batch_stats`` (its 'batch_stats' tree, for a model with 'bn'
    sites) into ``module`` in place, converting each leaf to the tensor's
    dtype. Raises KeyError on a missing or extra leaf of either tree,
    ValueError on a shape mismatch."""
    flat = {'params': flatten_tree(params), 'batch_stats': flatten_tree(batch_stats or {})}
    assigned = {'params': set(), 'batch_stats': set()}
    missing = []
    for path, mod, name, t, collection in _leaves(module):
        tree = flat[collection]
        if path not in tree:
            missing.append(path if collection == 'params' else f'{collection}:{path}')
            continue
        transform = getattr(mod, 'flax_leaf', None)
        arr = tree[path] if transform is None else transform(name, tree[path])
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f'{path}: flax leaf {tuple(tree[path].shape)} maps to '
                             f'{tuple(arr.shape)}, torch expects {tuple(t.shape)}')
        with torch.no_grad():
            t.copy_(torch.tensor(np.array(arr, np.float32, order='C'), dtype=t.dtype))
        assigned[collection].add(path)
    extra = sorted(f'{c}:{p}' if c != 'params' else p
                   for c in flat for p in set(flat[c]) - assigned[c])
    if missing or extra:
        raise KeyError(f'flax/torch trees differ: {len(missing)} torch params without a '
                       f'flax leaf {missing[:5]}, {len(extra)} flax leaves unused '
                       f'{extra[:5]}')
    return module


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> Dict:
    """{'a/b/leaf': array} -> nested dict of arrays (``flatten_tree``'s inverse)."""
    tree: Dict = {}
    for path, value in flat.items():
        *parents, leaf = path.split('/')
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def to_flax(module: torch.nn.Module) -> Dict[str, Dict]:
    """``module``'s flax variables as nested dicts of fp32 numpy arrays:
    ``{'params': ...}``, and ``'batch_stats'`` when it has 'bn' sites
    ('bn_frozen' statistics sit in 'params', as flax keeps them)."""
    flat: Dict[str, Dict[str, np.ndarray]] = {'params': {}}
    for path, mod, name, t, collection in _leaves(module):
        arr = t.detach().to('cpu', torch.float32).numpy()
        transform = getattr(mod, 'to_flax_leaf', None)
        if transform is not None:
            arr = transform(name, arr)
        flat.setdefault(collection, {})[path] = np.array(arr, np.float32, order='C')
    return {collection: unflatten_tree(leaves) for collection, leaves in flat.items()}


def load_flax_variables(module: torch.nn.Module, variables: Mapping) -> torch.nn.Module:
    """``load_flax_params`` of a flax variables dict ({'params': ...} and,
    with 'bn' sites, 'batch_stats'); any other collection raises KeyError."""
    unknown = set(variables) - {'params', 'batch_stats'}
    if unknown:
        raise KeyError(f'flax collections this package does not hold: {sorted(unknown)}')
    return load_flax_params(module, variables['params'], variables.get('batch_stats'))
