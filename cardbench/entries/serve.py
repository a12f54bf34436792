"""Serving entry: ``bench.py``'s step on the port, ``STP3.forward`` then the
occupancy then ``STP3.plan``, as one compiled call
(``stp3_tpu_torch.utils.graphs.compiled``: a CUDA graph, captured at
set-up and replayed), batch 1, in the configuration's precision. A step
hands one input set of the pool to the call and reads its refined
trajectory back to the host."""
from __future__ import annotations

import torch

from cardbench import generate
from cardbench.counts import flops, kernels
from cardbench.peaks import bound_s
from cardbench.reference import compare
from cardbench.weights import floating_shapes, load, seeded_state


def port_config(config: dict):
    """The port's config tree: its defaults with the stage merged in."""
    from stp3_tpu_torch.config import CfgNode, get_cfg
    cfg = get_cfg()
    cfg.merge_from_other_cfg(CfgNode(config['stage']))
    return cfg


def plan_step(model, image, intrinsics, extrinsics, ego, trajs, gt, commands, target):
    """bench.py's timed step: forward, occupancy, plan."""
    rf = model.cfg.receptive_field
    out = model(image, intrinsics, extrinsics, ego)
    occupancy = torch.logical_or(out['segmentation'].argmax(-1),
                                 out['pedestrian'].argmax(-1)).float()
    _, traj = model.plan(out['cam_front'], trajs, gt, out['costvolume'][:, rf:],
                         occupancy[:, rf:], out['hdmap'], commands, target)
    return {**{k: out[k] for k in compare.HEADS}, 'cam_front': out['cam_front']}, traj


def pool_inputs(pool: dict, j: int) -> dict:
    return {k: v[j] for k, v in pool.items()}


class Entry:
    throughput = False
    samples = 1

    def __init__(self, cell: dict, seed: int, device):
        from stp3_tpu_torch.models.stp3 import STP3, STP3Config
        from stp3_tpu_torch.utils import graphs
        from stp3_tpu_torch.utils.precision import policy_dtype
        self.cell = cell
        cfg = port_config(cell['config'])
        self.dtype = policy_dtype(cfg)
        model = STP3(STP3Config.from_cfg(cfg)).to(device=device, dtype=self.dtype).eval()
        load(model, seeded_state(floating_shapes(model), seed, device, self.dtype))
        self.model = model
        self.pool = generate.camera_sets(cell['traffic'], cell['config']['model'], seed, device,
                                         self.dtype)
        self.n_pool = len(self.pool['image'])
        n_future = int(cell['config']['model']['n_future'])
        self.gt = torch.zeros(1, n_future, 3, dtype=self.dtype, device=device)
        self.call = graphs.compiled(lambda *a: plan_step(model, *a), model)
        self.stepped = []
        for i in range(2):                       # the capture, then one replay
            self.step(i)
        self.stepped = []                        # the input set of each timed step

    def step(self, i: int):
        j = i % self.n_pool
        x = pool_inputs(self.pool, j)
        self.stepped.append(j)
        with torch.inference_mode():
            heads, traj = self.call(x['image'], x['intrinsics'], x['extrinsics'], x['ego'],
                                    x['trajs'], self.gt, x['commands'], x['target'])
            return j, heads, traj.float().cpu()

    def keep(self, i: int, result):
        j, heads, traj = result
        return {'set': j, 'traj': traj, **heads}

    def layer_inputs(self) -> dict:
        """The counts the per-layer metrics read, for the timed steps."""
        config = self.cell['config']
        model = config['model']
        cams = int(self.cell['traffic']['cameras'])
        return {'precision': config['precision'],
                'flops_per_step': flops.serve_step(model, cams),
                'bounds': step_bounds(model, self.pool, self.stepped, self.dtype)}

    def release(self) -> None:
        self.call = self.model = self.pool = None


def splat_ranks(model: dict, x: dict) -> torch.Tensor:
    """(rf, P) ranks of one input set's frames, pre-warped to the present,
    by the reference's geometry."""
    from cardbench.reference import geometry, splat
    res, start, dim = geometry.calculate_birds_eye_view_parameters(
        model['x_bound'], model['y_bound'], model['z_bound'])
    frustum = torch.as_tensor(geometry.create_frustum(tuple(model['final_dim']),
                                                      model['encoder_downsample'],
                                                      tuple(model['d_bound'])),
                              device=x['image'].device)
    points = geometry.get_geometry(frustum, x['intrinsics'].float(), x['extrinsics'].float())
    return splat.prewarped_ranks(points, x['ego'].float(), res, start, dim), int(dim.prod())


def bev_rows(model: dict, frames: int) -> int:
    nx = int(round((model['x_bound'][1] - model['x_bound'][0]) / model['x_bound'][2]))
    ny = int(round((model['y_bound'][1] - model['y_bound'][0]) / model['y_bound'][2]))
    return frames * nx * ny


def step_bounds(model: dict, pool: dict, stepped, dtype) -> dict:
    """Bound seconds of K1 (one launch a step, over the rf frames) and K2
    (two a step: after the DualGRU rollout and after the first SpatialGRU)
    summed over the ``stepped`` input sets."""
    elem = torch.finfo(dtype).bits // 8
    c = model['encoder_out_channels']
    precision = 'bf16' if dtype == torch.bfloat16 else 'fp32'
    k1 = {}
    for j in set(stepped):
        ranks, ncells = splat_ranks(model, pool_inputs(pool, j))
        k1[j] = bound_s(*kernels.k1_splat(ranks, ncells, c, elem), 'fp32')
    nf, rf = model['n_future'], model['receptive_field']
    k2 = sum(bound_s(*kernels.k2_mlp(bev_rows(model, f), model['start_out_channels'], elem),
                     'bf16') for f in (nf, rf + nf))
    bounds = {'k1_splat': sum(k1[j] for j in stepped)}
    if precision == 'bf16':                      # K2 runs on bf16 inputs only
        bounds['k2_mlp'] = k2 * len(stepped)
    return bounds


def served_numbers(cell: dict, seed: int, device, kept: dict, program=None):
    """The compared numbers over the kept steps. ``program``: a model that
    serves in the port's place (the control), run here on each kept
    step's inputs instead of reading what the port served."""
    dtype = compare.served_dtype(cell['config'])
    model = cell['config']['model']
    state = seeded_state(compare_shapes(model), seed, device, dtype)
    pool = generate.camera_sets(cell['traffic'], model, seed, device, dtype)
    readings = []
    with compare.fp32_math():
        ref = compare.build(model, state, device)
        for step in kept.values():
            x = pool_inputs(pool, step['set'])
            served = step if program is None else program(x)
            readings.append(compare.serve_numbers(ref, x, served))
    del ref
    torch.cuda.empty_cache()
    return compare.worst(readings)


def compare_shapes(model: dict) -> dict:
    """name -> shape of every floating leaf of the reference."""
    return floating_shapes(compare.STP3(compare.reference_config(model)))


def numbers(cell: dict, seed: int, device, kept: dict) -> dict:
    return served_numbers(cell, seed, device, kept)


def judge(cell: dict, seed: int, device, kept: dict):
    return compare.checks(numbers(cell, seed, device, kept), cell['workload']['limits'])


def control(cell: dict, seed: int, device, sets) -> dict:
    """The control's numbers: the reference in the next precision below the
    configuration's (``compare.lower``) serves the input sets ``sets`` in
    the port's place."""
    dtype = compare.served_dtype(cell['config'])
    model = cell['config']['model']
    state = seeded_state(compare_shapes(model), seed, device, dtype)
    low, math = compare.lower(compare.build(model, state, device), cell['config']['precision'])

    def program(x):
        with torch.no_grad(), math():
            heads, traj = plan_step(low, x['image'].float(), x['intrinsics'], x['extrinsics'],
                                    x['ego'], x['trajs'].float(),
                                    torch.zeros(1, model['n_future'], 3, device=device),
                                    x['commands'], x['target'].float())
        return {'traj': traj.cpu(), **heads}
    return served_numbers(cell, seed, device, {i: {'set': j} for i, j in enumerate(sets)},
                          program)
