"""CARLA agent entry: ``AgentCore`` ticks in its default mode (incremental,
static geometry: the splat by a column plan built once from the fixed
rig; the tick's device calls are CUDA graphs captured at set-up). A step
is one tick: ``push_frame`` with the simulator's four uint8 frames, GPS
and compass, then ``plan_step`` with speed, command and target point,
which samples the candidates with the module-level ``np.random`` (seeded
from ``--seed``), replays the tick's graph, reads the waypoints back and
runs the PID controllers."""
from __future__ import annotations

import numpy as np
import torch

from cardbench import generate
from cardbench.counts import flops
from cardbench.entries.serve import compare_shapes, port_config
from cardbench.reference import agent as host
from cardbench.reference import compare, sampler
from cardbench.reference import control as pid
from cardbench.weights import floating_shapes, load, seeded_state

# the tick's planning command codes of CARLA's RoadOption values
# (LEFT 1, RIGHT 2, STRAIGHT 3; anything else keeps every candidate)
COMMAND_CODES = {1: 0, 2: 2, 3: 1}
KEEP_ALL = 3


class Entry:
    throughput = False
    samples = 1

    def __init__(self, cell: dict, seed: int, device):
        from stp3_tpu_torch.deploy.agent_core import AgentCore
        from stp3_tpu_torch.models.stp3 import STP3, STP3Config
        from stp3_tpu_torch.utils.precision import policy_dtype
        self.cell = cell
        cfg = port_config(cell['config'])
        dtype = policy_dtype(cfg)
        model = STP3(STP3Config.from_cfg(cfg)).to(device=device, dtype=dtype).eval()
        load(model, seeded_state(floating_shapes(model), seed, device, dtype))
        traffic = cell['traffic']
        self.route = generate.carla_route(traffic, cell['config']['model'], seed, device,
                                          int(traffic['route_ticks']))
        np.random.seed(int(seed) % 2 ** 32)
        self.core = AgentCore(cfg, model, device=device)
        serve = self.core._serve

        def served(*args):                      # what the tick's graph returned, and when
            out = serve(*args)
            self.last = (self.t, out)
            return out
        self.core._serve = served
        self.last = None
        self.t = 0
        rf = int(cell['config']['model']['receptive_field'])
        for _ in range(rf + 3):                  # fill the buffers, then plan twice
            self.tick()

    def tick(self):
        t, r = self.t, self.route
        self.t += 1
        self.core.push_frame(r['frames'][t % len(r['frames'])], r['gps'][t], r['compass'][t])
        if not self.core.warmed_up:
            return None
        return self.core.plan_step(float(r['speed'][t]), int(r['command'][t]), r['target'][t])

    def before(self, i: int) -> None:
        core = self.core
        self.state = {'np_state': np.random.get_state(), 'last_steer': core.last_steer,
                      'turn': list(core.turn_controller._window),
                      'speed_pid': list(core.speed_controller._window)}

    def step(self, i: int):
        steer, throttle, brake, meta = self.tick()
        tick, (traj, out, _) = self.last
        if tick != self.t:
            raise RuntimeError(f'tick {self.t} made no call of AgentCore._serve (the last was in '
                               f'tick {tick}): the heads it returned cannot be read')
        return self.t - 1, control_values(steer, throttle, brake, meta), traj, out

    def keep(self, i: int, result):
        t, ctl, traj, out = result
        return {'tick': t, 'control': ctl, 'traj': traj[0, :, :2].float().cpu(),
                **self.state, **{k: out[k] for k in compare.HEADS}}

    def layer_inputs(self) -> dict:
        config = self.cell['config']
        return {'precision': config['precision'],
                'flops_per_step': flops.incremental_step(config['model'], 4)}

    def release(self) -> None:
        self.core = self.last = None


def tick_inputs(cell: dict, route: dict, kept: dict, device) -> dict:
    """The reference's inputs of one kept tick, worked out from the route:
    the rf buffered frames cropped and normalised, the ego-motion, the
    candidates drawn again from the tick's NumPy state, the command and
    the target point."""
    model = cell['config']['model']
    rf, crop = model['receptive_field'], model['final_dim'][0]
    t = kept['tick']
    ticks = range(t - rf + 1, t + 1)
    cams = cell['traffic']['cameras']
    frames = route['frames']
    images = torch.stack([torch.as_tensor(np.stack(
        [host.centre_crop(frames[s % len(frames)][c], crop) for c in cams]), device=device)
        for s in ticks])
    gps = route['gps'][list(ticks)]
    ego = host.egomotion(gps[:, 0], gps[:, 1], route['compass'][list(ticks)])
    rng = np.random.RandomState()
    rng.set_state(kept['np_state'])
    trajs = sampler.sample_trajectories(float(route['speed'][t]), kept['last_steer'],
                                        model['n_future'], model['sample_num'],
                                        rng=rng).astype(np.float32)
    return {'images': host.normalise(images)[None],                    # (1, rf, N, H, W, 3)
            'ego': torch.as_tensor(ego, device=device)[None],
            'trajs': torch.as_tensor(trajs[None, :, 1:], device=device),
            'commands': torch.tensor([COMMAND_CODES.get(int(route['command'][t]), KEEP_ALL)],
                                     device=device),
            'target': torch.as_tensor(route['target'][t], device=device)[None]}


def reference_tick(ref, rig, x: dict):
    """(refined waypoints (T, 2), outputs) of the reference's incremental
    tick: the past frames splatted each in its own ego frame, then
    ``serve_step`` on the newest."""
    intr, extr = rig
    rf = x['images'].shape[1]
    cache = torch.stack([ref.splat_single_frame(x['images'][:, s], intr, extr)[0]
                         for s in range(rf - 1)], 1)
    traj, out, _ = ref.serve_step(x['images'][:, -1], intr, extr, x['ego'], cache, x['trajs'],
                                  x['commands'], x['target'])
    return traj[0, :, :2], out


def control_values(steer, throttle, brake, meta: dict) -> tuple:
    """A tick's control, and the aim's angle and the desired speed it was
    worked out from (continuous where steer and throttle saturate)."""
    return (steer, throttle, float(brake), meta['angle'], meta['desired_speed'])


def controls(waypoints: np.ndarray, speed: float, kept: dict) -> tuple:
    """The reference's controllers, from the port's controller state
    before the tick, on ``waypoints``: ``control_values``."""
    turn = pid.PIDController(k_p=1.25, k_i=0.75, k_d=0.3, n=40, window=kept['turn'])
    speed_pid = pid.PIDController(k_p=5.0, k_i=0.5, k_d=1.0, n=40, window=kept['speed_pid'])
    return control_values(*pid.control_pid(waypoints, speed, turn, speed_pid))


def tick_numbers(ref, rig, x: dict, speed: float, kept: dict, served: dict) -> dict:
    """The heads, the plan gap, the waypoints and the control of one served
    tick; the control is judged on the reference's refinement of the
    candidate the port chose, through the port's controller state."""
    with torch.no_grad():
        _, out = reference_tick(ref, rig, x)
        numbers = {'heads_rel_l2': max(compare.rel_l2(served[k], out[k])
                                       for k in compare.HEADS)}
        plan, waypoints = compare.plan_choice(ref, out, x['trajs'], x['commands'], x['target'],
                                              served['traj'])
        numbers.update(plan)
        want = controls(waypoints.cpu().numpy(), speed, kept)
        numbers['control'] = max(abs(g - w) for g, w in zip(served['control'], want))
    return numbers


def agent_numbers(cell: dict, seed: int, device, kept: dict, program=None) -> dict:
    """The compared numbers over the kept ticks. ``program(x, kept, rig)``:
    a model that serves in the port's place (the control)."""
    model = cell['config']['model']
    dtype = compare.served_dtype(cell['config'])
    state = seeded_state(compare_shapes(model), seed, device, dtype)
    traffic = cell['traffic']
    route = generate.carla_route(traffic, model, seed, device, int(traffic['route_ticks']))
    extr, intr = host.carla_cam_rig(tuple(model['final_dim']))
    rig = (torch.as_tensor(intr, device=device)[None], torch.as_tensor(extr, device=device)[None])
    readings = []
    with compare.fp32_math():
        ref = compare.build(model, state, device)
        for k in kept.values():
            x = tick_inputs(cell, route, k, device)
            speed = float(route['speed'][k['tick']])
            served = k if program is None else program(x, k, rig, speed)
            readings.append(tick_numbers(ref, rig, x, speed, k, served))
    del ref
    torch.cuda.empty_cache()
    return compare.worst(readings)


def numbers(cell: dict, seed: int, device, kept: dict) -> dict:
    return agent_numbers(cell, seed, device, kept)


def judge(cell: dict, seed: int, device, kept: dict):
    return compare.checks(numbers(cell, seed, device, kept), cell['workload']['limits'])


def control_ticks(cell: dict, seed: int, ticks) -> dict:
    """Kept ticks for the control, which runs without the port: each
    tick's NumPy state drawn from the seed, the controllers at rest."""
    return {i: {'tick': t, 'np_state': np.random.RandomState([seed, i]).get_state(),
                'last_steer': 0.0, 'turn': [], 'speed_pid': []} for i, t in enumerate(ticks)}


def control(cell: dict, seed: int, device, ticks) -> dict:
    """The control's numbers: the reference in the next precision below the
    configuration's (``compare.lower``) ticks in the port's place."""
    model = cell['config']['model']
    dtype = compare.served_dtype(cell['config'])
    state = seeded_state(compare_shapes(model), seed, device, dtype)
    low, math = compare.lower(compare.build(model, state, device), cell['config']['precision'])

    def program(x, kept, rig, speed):
        with torch.no_grad(), math():
            traj, out = reference_tick(low, rig, x)
        waypoints = traj.float()
        return {'traj': waypoints.cpu(), 'control': controls(waypoints.cpu().numpy(), speed, kept),
                **{k: out[k] for k in compare.HEADS}}
    rf = int(model['receptive_field'])           # a tick with rf frames behind it
    return agent_numbers(cell, seed, device,
                         control_ticks(cell, seed, [t + rf for t in ticks]), program)
