"""The comparison that decides ``correct``, and the control it must fail.

The reference (``stp3.py``) runs in fp32 with TF32 off on the weights
and inputs the benchmark made, and works out again everything the port
derived from them. What the port served is judged by the numbers a
cell's workload file gives a limit:

- ``heads_rel_l2``: each decoder head (segmentation, pedestrian, HD map,
  cost volume) against the reference's, ||served - ref|| / ||ref||, the
  worst head of the worst step;
- ``traj_m``: the planner's select is an argmin over the candidates'
  costs, which flips on rounding, so the served trajectory is judged as
  a served token is, against the reference's refinement of the
  candidate nearest it: the largest distance (m) between a waypoint of
  the port's and of that refinement. (Which candidate the port chose is
  not read: with seeded weights the GRU's gates saturate on the inputs in
  metres, so the refinement hardly depends on the candidate.)
- ``plan_m``: ``traj_m`` with the reference's refinements worked out from
  the front-camera feature the port served, so that it judges the
  planner's stage alone (its select by command, its bottlenecks and GRU
  refinement in the served precision), without the drift of the stages
  before it.

The control is the reference put in the port's place, computed in the
next precision below the configuration's: ``fp8`` for bf16 (every layer
kernel, and every layer's input where the layer is called as a module,
rounded to float8 e4m3 with a per-tensor scale), ``tf32`` for fp32 (the
same model with TF32 on in matmuls and cuDNN convolutions).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Dict, Iterable, List

import torch
import torch.nn as nn
import torch.nn.functional as F

from cardbench.reference.cost import CostConfig
from cardbench.reference.stp3 import STP3, STP3Config

HEADS = ('segmentation', 'pedestrian', 'hdmap', 'costvolume')
FP8_MAX = 448.0                       # the largest float8 e4m3 magnitude


def served_dtype(config: dict) -> torch.dtype:
    """The dtype the configuration serves and trains in."""
    return {'bf16': torch.bfloat16, 'fp32': torch.float32}[config['precision']]


def reference_config(model: dict) -> STP3Config:
    fields = {k: tuple(v) if isinstance(v, list) else v for k, v in model.items()}
    fields['cost'] = CostConfig(**{k: tuple(v) if isinstance(v, list) else v
                                   for k, v in model['cost'].items()})
    return STP3Config(**fields)


def build(model: dict, state: Dict[str, torch.Tensor], device) -> STP3:
    """The fp32 reference of the configuration's ``model`` fields, holding
    ``state`` (upcast to fp32), in eval mode."""
    ref = STP3(reference_config(model)).to(device).eval()
    params = dict(ref.named_parameters())
    with torch.no_grad():
        for name, value in state.items():
            params[name].copy_(value.float())
    return ref


@contextlib.contextmanager
def fp32_math(tf32: bool = False):
    """fp32 matmuls and convolutions (TF32 off), or TF32 with ``tf32``."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, in its dtype."""
    if not x.is_floating_point():
        return x
    scale = FP8_MAX / x.detach().abs().amax().clamp_min(1e-12)
    return ((x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale)


class _Fp8(nn.Module):
    def forward(self, x):
        return fp8(x)


def lower_to_fp8(model: nn.Module) -> nn.Module:
    """Every module that owns a ``kernel`` computes with it and (where called
    as a module) with its first input rounded to fp8."""
    from torch.nn.utils import parametrize
    for m in list(model.modules()):
        if isinstance(getattr(m, 'kernel', None), nn.Parameter):
            parametrize.register_parametrization(m, 'kernel', _Fp8())
            m.register_forward_pre_hook(lambda mod, args: (fp8(args[0]),) + tuple(args[1:]))
    return model


def lower(model: nn.Module, precision: str):
    """(the model, a context in which it computes) in the next precision
    below ``precision``: fp8 kernels and layer inputs below bf16, TF32
    matmuls and convolutions below fp32."""
    if precision == 'bf16':
        return lower_to_fp8(model), fp32_math
    if precision == 'fp32':
        return model, functools.partial(fp32_math, tf32=True)
    raise ValueError(f'no control below {precision}')


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    return float((got.float() - want).norm() / want.norm().clamp_min(1e-30))


def occupancy(out: dict) -> torch.Tensor:
    return torch.logical_or(out['segmentation'].argmax(-1), out['pedestrian'].argmax(-1)).float()


def refine(planner, cam_front: torch.Tensor, finals: torch.Tensor,
           target: torch.Tensor) -> torch.Tensor:
    """The planner's GRU refinement of every candidate in ``finals`` (N, T,
    3) from one front-camera feature (1, Hf, Wf, C): (N, T, 2)."""
    h = cam_front.movedim(-1, 1)
    for i in range(4):
        h = getattr(planner, f'reduce_channel_{i}').nchw(h)
    n, steps = finals.shape[:2]
    h0 = h.reshape(1, -1).expand(n, -1)
    x = h0.new_zeros(n, 2)
    tp = target.float().reshape(1, 2).expand(n, 2)
    outs = []
    for i in range(steps):
        h0 = planner.gru(h0, torch.cat([x, finals[:, i, :2], tp], -1))
        x = planner.decoder_fc2(F.relu(planner.decoder_fc1(h0)))
        outs.append(x)
    return torch.stack(outs, 1)


def plan_choice(ref: STP3, out: dict, trajs: torch.Tensor, commands: torch.Tensor,
                target: torch.Tensor, served: torch.Tensor):
    """({'traj_m': ...}, the reference's refinement (T, 2) nearest the
    ``served`` refined trajectory (T, 2 or 3)): the reference refines every
    candidate the command keeps from its own front-camera feature."""
    cur = ref.planner.select_trajs_by_command(trajs.float(), commands.long())
    refined = refine(ref.planner, out['cam_front'], cur[0], target)
    dist = (refined - served[..., :2].float().to(refined.device)).abs().amax((-2, -1))
    chosen = int(dist.argmin())
    return {'traj_m': float(dist[chosen])}, refined[chosen]


def serve_numbers(ref: STP3, inputs: dict, served: dict) -> Dict[str, float]:
    """The numbers of one served step: ``inputs`` the step's tensors
    (image, intrinsics, extrinsics, ego, trajs, commands, target),
    ``served`` its heads, front-camera feature ('cam_front') and refined
    trajectory ('traj')."""
    with torch.no_grad():
        out = ref(inputs['image'].float(), inputs['intrinsics'], inputs['extrinsics'],
                  inputs['ego'])
        numbers = {'heads_rel_l2': max(rel_l2(served[k], out[k]) for k in HEADS)}
        numbers.update(plan_choice(ref, out, inputs['trajs'], inputs['commands'],
                                   inputs['target'], served['traj'][0])[0])
        served_front = {'cam_front': served['cam_front'].float()}
        numbers['plan_m'] = plan_choice(ref, served_front, inputs['trajs'], inputs['commands'],
                                        inputs['target'], served['traj'][0])[0]['traj_m']
    return numbers


def worst(readings: Iterable[Dict[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, float('-inf')), v)
    return out


def checks(numbers: Dict[str, float], limits: Dict[str, float]) -> List[tuple]:
    return [(k, numbers[k], float(limits[k])) for k in limits]
