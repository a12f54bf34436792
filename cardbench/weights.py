"""Seeded weights, made on the device in a few large calls.

One normal draw of every floating parameter's values at once, from a
``torch.Generator`` on the device, scaled and shifted per leaf by its
kind (the port's initialisers in distribution, with non-zero biases and
layer scales so that every path carries signal):

- a ``kernel`` of two or more axes: variance 1 / fan-in, the fan-in being
  its size over its first axis (lecun-normal);
- a norm ``scale``: 1 + 0.1 z; a ``bias``: 0.02 z; a ConvNeXt ``gamma``:
  0.1 + 0.05 z; a scalar (an uncertainty weight): 0.

The values are rounded to ``dtype``, the type they are served in, and the
port and the reference both load these same values.
"""
from __future__ import annotations

import math
from typing import Dict

import torch


def leaf_scale(name: str, shape) -> tuple:
    """(std, mean) of the leaf ``name`` of ``shape``."""
    leaf = name.rsplit('.', 1)[-1]
    if len(shape) == 0:
        return 0.0, 0.0
    if leaf == 'kernel' and len(shape) >= 2:
        return 1.0 / math.sqrt(math.prod(shape) / shape[0]), 0.0
    if leaf == 'scale':
        return 0.1, 1.0
    if leaf == 'gamma':
        return 0.05, 0.1
    return 0.02, 0.0


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for one ``stream`` of the run's draws
    (weights 0, traffic 1, ...), seeded from ``seed``."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1000003 + stream) % (2 ** 63))


def seeded_state(shapes: Dict[str, tuple], seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """{name: tensor} of every leaf in ``shapes`` (name -> shape), drawn at
    once on ``device`` from ``seed`` in the order of the names, rounded to
    ``dtype``."""
    names = sorted(shapes)
    numels = [math.prod(shapes[n]) for n in names]
    stds, means = zip(*(leaf_scale(n, shapes[n]) for n in names))
    counts = torch.tensor(numels, device=device)
    std = torch.repeat_interleave(torch.tensor(stds, device=device), counts)
    mean = torch.repeat_interleave(torch.tensor(means, device=device), counts)
    z = torch.randn(sum(numels), generator=generator(seed, device), device=device)
    flat = (z * std + mean).to(dtype)
    return {n: t.view(shapes[n]) for n, t in zip(names, flat.split(numels))}


def floating_shapes(module: torch.nn.Module) -> Dict[str, tuple]:
    return {n: tuple(p.shape) for n, p in module.named_parameters() if p.is_floating_point()}


@torch.no_grad()
def load(module: torch.nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Copy ``state`` into ``module``'s parameters of the same names."""
    params = dict(module.named_parameters())
    for name, value in state.items():
        params[name].copy_(value)
