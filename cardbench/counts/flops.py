"""Model FLOPs of a step, counted with ``torch.utils.flop_counter`` over
the reference on the ``meta`` device (shapes only, nothing computed).
The reference computes the port's kernels' work as plain operations, so
it is counted too; the splat's scatter and the planner's gathers are not
matrix products and count 0."""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from cardbench.reference import compare

META = torch.device('meta')


def _zeros(*shape, dtype=torch.float32):
    return torch.zeros(*shape, dtype=dtype, device=META)


def serve_inputs(model: dict, batch: int, frames: int, cameras: int):
    h, w = model['final_dim']
    return (_zeros(batch, frames, cameras, h, w, 3), _zeros(batch, frames, cameras, 3, 3),
            _zeros(batch, frames, cameras, 4, 4), _zeros(batch, frames, 6))


def plan_flops(ref, out, batch: int, model: dict) -> None:
    rf = model['receptive_field']
    ref.plan(out['cam_front'], _zeros(batch, model['sample_num'], model['n_future'], 3),
             _zeros(batch, model['n_future'], 3), out['costvolume'][:, rf:],
             compare.occupancy(out)[:, rf:], out['hdmap'],
             _zeros(batch, dtype=torch.long), _zeros(batch, 2))


def serve_step(model: dict, cameras: int, batch: int = 1) -> float:
    """The forward over rf frames, the occupancy and the plan."""
    ref = compare.STP3(compare.reference_config(model)).to(META).eval()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        out = ref(*serve_inputs(model, batch, model['receptive_field'], cameras))
        plan_flops(ref, out, batch, model)
    return float(counter.get_total_flops())


def incremental_step(model: dict, cameras: int, batch: int = 1) -> float:
    """``serve_step``: one frame encoded and splatted, the cached frames'
    grids warped, the temporal model, future prediction, the heads and
    the plan."""
    ref = compare.STP3(compare.reference_config(model)).to(META).eval()
    rf = model['receptive_field']
    image, intr, extr, ego = serve_inputs(model, batch, 1, cameras)
    c = model['encoder_out_channels']
    nx = int(round((model['x_bound'][1] - model['x_bound'][0]) / model['x_bound'][2]))
    ny = int(round((model['y_bound'][1] - model['y_bound'][0]) / model['y_bound'][2]))
    cache = _zeros(batch, rf - 1, nx, ny, c)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        ref.serve_step(image[:, 0], intr[:, 0], extr[:, 0], _zeros(batch, rf, 6), cache,
                       _zeros(batch, model['sample_num'], model['n_future'], 3),
                       _zeros(batch, dtype=torch.long), _zeros(batch, 2))
    return float(counter.get_total_flops())


def train_step(model: dict, cameras: int, batch: int) -> float:
    """Three times the forward over rf frames: the backward computes, for
    each product, the input's and the weight's gradient, each as costly as
    the forward's product (the recomputation of a checkpointed stage not
    counted). ``FlopCounterMode``'s own count of ``convolution_backward``
    is not used: it counts a grouped convolution's backward once a group
    (65x the forward for a 64-channel depthwise convolution, not 2x)."""
    ref = compare.STP3(compare.reference_config(model)).to(META).train()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        ref(*serve_inputs(model, batch, model['receptive_field'], cameras))
    return 3.0 * float(counter.get_total_flops())
