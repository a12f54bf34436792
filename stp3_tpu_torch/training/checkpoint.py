"""Checkpoints of the port, in its own format, and the curriculum warm
start (counterpart of stp3_tpu/training/checkpoint.py; reference
train.py:21-42, evaluate.py:31).

A checkpoint is a directory ``<ckpt_dir>/step_<n>/`` holding

  * ``state.pt`` (``torch.save``, read back with ``weights_only=True``):
    ``model``, the model's ``state_dict`` (parameters and the 'bn' /
    'bn_frozen' statistics buffers); ``optimizer``, Adam's
    ``state_dict``; ``step``; ``generator``, the state of the trainer's
    ``torch.Generator`` (dropout, drop-connect and latent draws);
  * ``meta.json``: ``format_version``, ``step``, and the training
    monitor's state under its own ``metrics`` key, so no caller key can
    overwrite the version stamp;
  * ``config.json``: the config as a dict (the card's machine has no
    PyYAML, so the config travels as JSON).

``<ckpt_dir>/last`` holds the path of the newest checkpoint (the
reference ModelCheckpoint's save_last), and the training CLI writes
``<ckpt_dir>/best`` beside it. A directory without a ``meta.json`` stamp
is refused.

The 3-stage curriculum (perception -> prediction -> planning) warm-starts
a stage from the previous stage's weights without its decoder heads
(reference train.py:27: ``'decoder' not in k``, strict=False):
``filter_warm_start_params``.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

# bump on any change that loads cleanly but computes differently
FORMAT_VERSION = 1


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


def save_checkpoint(ckpt_dir: str, step: int, model_state: Mapping[str, torch.Tensor],
                    optimizer_state: Optional[Mapping[str, Any]] = None,
                    cfg_dict: Optional[Dict[str, Any]] = None,
                    generator_state: Optional[torch.Tensor] = None,
                    metrics: Optional[Dict[str, Any]] = None) -> str:
    """Write ``<ckpt_dir>/step_<step>/`` and point ``last`` at it; returns
    its path. ``metrics``: json-able monitor state (e.g. ``{'best_iou':
    ...}``), kept under meta.json's ``metrics`` key."""
    path = os.path.abspath(os.path.join(ckpt_dir, f'step_{step}'))
    os.makedirs(path, exist_ok=True)
    payload = {'model': dict(model_state), 'step': int(step)}
    if optimizer_state is not None:
        payload['optimizer'] = optimizer_state
    if generator_state is not None:
        payload['generator'] = generator_state
    torch.save(payload, os.path.join(path, 'state.pt'))
    meta = {'format_version': FORMAT_VERSION, 'step': int(step),
            'metrics': _jsonable(dict(metrics or {}))}
    with open(os.path.join(path, 'meta.json'), 'w') as f:
        json.dump(meta, f, indent=2)
    if cfg_dict is not None:
        with open(os.path.join(path, 'config.json'), 'w') as f:
            json.dump(_jsonable(cfg_dict), f, indent=2)
    with open(os.path.join(ckpt_dir, 'last'), 'w') as f:
        f.write(path)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    last = os.path.join(ckpt_dir, 'last')
    if os.path.exists(last):
        with open(last) as f:
            return f.read().strip()
    return None


def resolve_checkpoint_path(path: str) -> str:
    """A step directory (holding ``state.pt``) as it is; a pointer file
    (``last``, ``best``) followed; a checkpoint root through its ``last``
    pointer, else its highest ``step_<n>``."""
    path = os.path.abspath(path)
    if os.path.isfile(path):
        with open(path) as f:
            path = f.read().strip()
    if os.path.exists(os.path.join(path, 'state.pt')):
        return path
    last = latest_checkpoint(path) if os.path.isdir(path) else None
    if last and os.path.exists(os.path.join(last, 'state.pt')):
        return last
    steps = sorted((d for d in os.listdir(path) if d.startswith('step_'))
                   if os.path.isdir(path) else [], key=lambda d: int(d.split('_')[1]))
    if steps:
        return os.path.join(path, steps[-1])
    return path


def load_meta(path: str) -> Dict[str, Any]:
    """meta.json of a checkpoint; {} when it has none."""
    meta_path = os.path.join(resolve_checkpoint_path(path), 'meta.json')
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            return json.load(f)
    return {}


def _validate_version(resolved: str) -> None:
    """Refuse a directory without the format stamp, or with a newer one."""
    meta = load_meta(resolved)
    if 'format_version' not in meta:
        raise ValueError(f'checkpoint {resolved} has no meta.json format stamp: it was not '
                         f'written by stp3_tpu_torch.training.checkpoint.save_checkpoint')
    if int(meta['format_version']) > FORMAT_VERSION:
        raise ValueError(f'checkpoint {resolved} has format_version {meta["format_version"]} '
                         f'> supported {FORMAT_VERSION}')


def load_checkpoint(path: str, map_location='cpu') -> Dict[str, Any]:
    """The saved payload ({model, step[, optimizer][, generator]}) of a
    checkpoint, its step directory, pointer or root."""
    resolved = resolve_checkpoint_path(path)
    _validate_version(resolved)
    return torch.load(os.path.join(resolved, 'state.pt'), map_location=map_location,
                      weights_only=True)


def restore_train_state(path: str, trainer) -> int:
    """Resume: load the model (strictly), Adam's state, the generator and
    the step into ``trainer`` (a ``training.trainer.Trainer``); returns
    the step. Entries the checkpoint does not hold keep their live values."""
    state = load_checkpoint(path, map_location=trainer.device)
    trainer.model.load_state_dict(state['model'])
    if 'optimizer' in state:
        trainer.optimizer.load_state_dict(state['optimizer'])
    if 'generator' in state:
        trainer.generator.set_state(state['generator'].cpu())
    trainer.step = int(state['step'])
    return trainer.step


def load_config_dict(path: str) -> Optional[Dict[str, Any]]:
    cfg_path = os.path.join(resolve_checkpoint_path(path), 'config.json')
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            return json.load(f)
    return None


def _stat_sites(state: Mapping[str, torch.Tensor]):
    """The module paths holding both a ``mean`` and a ``var`` entry: the
    BatchNorm sites ('bn', 'bn_frozen') of a port state_dict."""
    return {k[:-len('.mean')] for k in state
            if k.endswith('.mean') and k[:-len('.mean')] + '.var' in state}


def split_frozen_bn(state: Mapping[str, torch.Tensor]
                    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """A 'bn_frozen' model's state_dict -> (its parameters, its running
    statistics): the fine-tune path of an imported reference checkpoint
    with live BatchNorm (import under MODEL.NORM bn_frozen, split, train
    under bn). Only sites with both ``mean`` and ``var`` are split."""
    sites = _stat_sites(state)
    stats = {k: v for k, v in state.items()
             if k.rsplit('.', 1)[0] in sites and k.rsplit('.', 1)[1] in ('mean', 'var')}
    return {k: v for k, v in state.items() if k not in stats}, stats


def merge_bn_to_frozen(params: Mapping[str, torch.Tensor],
                       batch_stats: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The inverse of ``split_frozen_bn``: a 'bn' run's parameters and
    running statistics as one 'bn_frozen' state_dict (the port's 'bn' and
    'bn_frozen' sites share their entry names)."""
    clash = set(params) & set(batch_stats)
    if clash:
        raise KeyError(f'entries in both the parameters and the statistics: {sorted(clash)[:4]}')
    return {**params, **batch_stats}


def filter_warm_start_params(restored: Mapping[str, torch.Tensor],
                             init: Mapping[str, torch.Tensor],
                             exclude_substr: str = 'decoder'
                             ) -> Tuple[Dict[str, torch.Tensor], int]:
    """``init`` with every entry of ``restored`` that exists there with the
    same shape and whose name does not contain ``exclude_substr``
    (reference train.py:21-29: strict=False and the decoder filter);
    returns (merged state_dict, number of entries taken from ``restored``)."""
    merged, n_loaded = {}, 0
    for key, val in init.items():
        src = restored.get(key)
        if (src is not None and exclude_substr not in key.lower()
                and tuple(src.shape) == tuple(val.shape)):
            merged[key] = src
            n_loaded += 1
        else:
            merged[key] = val
    return merged, n_loaded
