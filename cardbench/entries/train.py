"""Training entry: ``Trainer.train_step`` of the port, compiled (after its
``WARMUP_CALLS`` eager steps, two CUDA graphs: the gradients' and the
update's), on the configuration's stage (bf16 over fp32 masters, REMAT as
the stage states), over a pool of seeded batches cycled step after step.
Set-up builds the one trainer, drives it through its first steps (the
eager ones, then the capture and the first replays), and hands it to the
window; the window's steps are not waited for one by one.

The comparison follows two stages of set-up, each three steps through
the window's own call on three different batches, against the
reference's steps in fp32 on the same batches:

- ``start``: the eager steps, from the seeded weights, Adam's fresh state
  and the seeded generator, as the reference starts;
- the replays: the steps that replay the graphs (the window's path),
  from the port's own state before them (its fp32 masters, Adam's step
  count and moments, the generator's state), which the reference takes
  up: the one state of the port that the reference does not work out
  again, and the eager stage checks how the port got there.

Each stage compares the first step's loss terms, its gradient as Adam
took it (from Adam's first moment before and after the step) and each
parameter's change over the three steps."""
from __future__ import annotations

import contextlib
import statistics

import torch

from cardbench import generate
from cardbench.counts import flops, kernels
from cardbench.entries.serve import bev_rows, compare_shapes, port_config, splat_ranks
from cardbench.peaks import bound_s
from cardbench.reference import compare
from cardbench.reference import train as reference
from cardbench.weights import floating_shapes, load, seeded_state

FOLLOWED = 3                   # the steps of each stage the reference follows
BETA1 = reference.BETA1


class Entry:
    throughput = True

    def __init__(self, cell: dict, seed: int, device):
        from stp3_tpu_torch.models.stp3 import STP3, STP3Config
        from stp3_tpu_torch.training.trainer import Trainer
        from stp3_tpu_torch.utils.graphs import WARMUP_CALLS
        self.cell = cell
        cfg = port_config(cell['config'])
        model = STP3(STP3Config.from_cfg(cfg)).to(device)
        load(model, seeded_state(floating_shapes(model), seed, device, torch.float32))
        self.trainer = Trainer(cfg, device=device, seed=seed, model=model)
        self.batches = generate.train_batches(cell['traffic'], cell['config']['model'], seed,
                                              device)
        self.samples = int(cell['traffic']['batch'])
        self.i = 0
        if WARMUP_CALLS != FOLLOWED:
            raise RuntimeError(f'the compiled step makes {WARMUP_CALLS} eager calls before its '
                               f'capture; the comparison follows {FOLLOWED}')
        self.evidence_ = {'start': self.follow(), 'replay': self.follow()}
        graph = self.trainer.graphs['gradients']
        if device.type == 'cuda' and (graph.eager_calls != WARMUP_CALLS or graph.captures != 1):
            raise RuntimeError('the followed steps did not replay the graphs as the window does')
        self.stepped = []

    def state(self) -> dict:
        """The port's state before a step: its parameters (fp32 masters),
        Adam's state of each, the generator's state."""
        opt = self.trainer.optimizer
        params = dict(self.trainer.model.named_parameters())
        return {'params': {n: p.detach().clone() for n, p in params.items()},
                'adam': {n: {k: v.detach().clone() for k, v in opt.state[p].items()}
                         for n, p in params.items() if opt.state.get(p)},
                'generator': self.trainer.generator.get_state(), 'batch': self.i}

    def follow(self) -> dict:
        """``FOLLOWED`` steps from the port's state: that state, the first
        step's terms, its gradient as Adam took it and each parameter's
        change."""
        before = self.state()
        outs = [self.next_step()]
        opt = self.trainer.optimizer
        params = dict(self.trainer.model.named_parameters())

        def moment(n, state):
            return state.get('exp_avg', torch.zeros_like(params[n])).detach()
        # an optimizer that took no step holds no moment: no gradient
        grad = {n: (moment(n, opt.state.get(p, {})) -
                    BETA1 * moment(n, before['adam'].get(n, {}))) / (1 - BETA1)
                for n, p in params.items()}
        outs += [self.next_step() for _ in range(FOLLOWED - 1)]
        return {'from': before, 'terms': outs, 'grad': grad,
                'change': {n: p.detach() - before['params'][n] for n, p in params.items()}}

    def next_step(self):
        batch = self.batches[self.i % len(self.batches)]
        self.i += 1
        return self.trainer.train_step(batch)

    def step(self, i: int):
        self.stepped.append(self.i % len(self.batches))
        return self.next_step()

    def keep(self, i: int, result):
        return None

    def evidence(self, kept: dict) -> dict:
        """Each stage's terms as floats; the replays' starting state."""
        out = {}
        for stage, ev in self.evidence_.items():
            out[stage] = {'terms': [{k: float(v) for k, v in t.items()} for t in ev['terms']],
                          'grad': ev['grad'], 'change': ev['change']}
        out['replay']['from'] = self.evidence_['replay']['from']
        return out

    def layer_inputs(self) -> dict:
        config = self.cell['config']
        model = config['model']
        b = self.samples
        return {'precision': config['precision'],
                'flops_per_step': flops.train_step(model, int(self.cell['traffic']['cameras']), b),
                'bounds': train_bounds(model, self.batches, self.stepped)}

    def release(self) -> None:
        self.trainer = self.batches = self.evidence_ = None


def train_bounds(model: dict, batches, stepped) -> dict:
    """Bound seconds of K1 (the forward's splat of every frame of the
    batch), K2 (two launches in the forward) and K3 (the splat's
    backward), bf16, summed over the ``stepped`` batches."""
    c = model['encoder_out_channels']
    per = {}
    for j in set(stepped):
        x = batches[j]
        ranks, ncells = splat_ranks(model, {'intrinsics': x['intrinsics'],
                                            'extrinsics': x['extrinsics'],
                                            'ego': x['future_egomotion'][:, :model['receptive_field']],
                                            'image': x['image']})
        per[j] = (bound_s(*kernels.k1_splat(ranks, ncells, c, 2), 'fp32'),
                  bound_s(*kernels.k3_gather(ranks, ncells, c, 2), 'bf16'))
    b = batches[0]['image'].shape[0]
    nf, rf = model['n_future'], model['receptive_field']
    k2 = sum(bound_s(*kernels.k2_mlp(b * bev_rows(model, f), model['start_out_channels'], 2),
                     'bf16') for f in (nf, rf + nf))
    return {'k1_splat': sum(per[j][0] for j in stepped),
            'k3_gather': sum(per[j][1] for j in stepped),
            'k2_mlp': k2 * len(stepped)}


def leaf_gaps(got: dict, want: dict, names) -> list:
    """Each leaf's gap of norms, | |got| - |want| |, over the larger of |want|
    and the median leaf's |want|."""
    norms = {n: float(want[n].norm()) for n in names}
    floor = statistics.median(norms.values())
    return [abs(float(got[n].norm()) - norms[n]) / max(norms[n], floor) for n in names]


# the first step's loss terms read (each uncertainty term is 0.5 w at w = 0
# there, on both sides), under their short names; ``loss_rel`` is the worst
# of the perception terms: the planner's max-margin term is a max over the
# candidates, which flips with rounding, and moves less under the control
# than under bf16 (PERF.md)
TERMS = {'segmentation': 'seg_rel', 'pedestrian': 'ped_rel', 'hdmap': 'hdmap_rel',
         'planning': 'plan_rel'}
WORST_OF = ('seg_rel', 'ped_rel', 'hdmap_rel')
STAGES = {'start': 'start_', 'replay': ''}


def stage_numbers(got: dict, want: dict, prefix: str) -> dict:
    """One stage's numbers: each of the first step's loss terms by its
    |gap| over the reference's; ``loss_rel``, the worst of the
    ``WORST_OF`` terms (the later steps' terms move with the first step's
    gradient, below); ``grad_gap`` and
    ``change_gap``, the median leaf's gap of the first step's gradient and
    of the change over the three steps. Leaves whose reference gradient
    is under a thousandth of the median leaf's move under Adam by rounding
    alone: they are left out of the change. (Where the planner's select
    sits at a near-tie, rounding flips it and the planning losses'
    gradient with it, and the global-norm clip then scales every other
    leaf: the replays' ``grad_gap`` reads up to 0.95 on sound runs, and is
    not compared: PERF.md.)"""
    names = list(want['grad'])
    grads = {n: float(want['grad'][n].norm()) for n in names}
    floor = 1e-3 * statistics.median(grads.values())
    moved = [n for n in names if grads[n] >= floor]
    g, w = got['terms'][0], want['terms'][0]
    out = {short: abs(g[k] - w[k]) / abs(w[k]) for k, short in TERMS.items()}
    out['loss_rel'] = max(out[k] for k in WORST_OF)
    out['grad_gap'] = statistics.median(leaf_gaps(got['grad'], want['grad'], names))
    out['change_gap'] = statistics.median(leaf_gaps(got['change'], want['change'], moved))
    return {prefix + k: v for k, v in out.items()}


def train_numbers(evidence: dict, want: dict) -> dict:
    """Both stages' numbers, the replays' unprefixed, the eager steps'
    under ``start_``."""
    out = {}
    for stage, prefix in STAGES.items():
        out.update(stage_numbers(evidence[stage], want[stage], prefix))
    return out


def batches_from(cell: dict, seed: int, device, first: int) -> list:
    batches = generate.train_batches(cell['traffic'], cell['config']['model'], seed, device)
    return [batches[(first + j) % len(batches)] for j in range(FOLLOWED)]


def stage_steps(cell: dict, seed: int, device, start=None, program=None) -> dict:
    """``FOLLOWED`` steps of the reference (or, ``program``, a lowered copy
    of it) on the batches of a stage: from the seeded weights, Adam's
    fresh state and the seeded generator, or from ``start`` (a state of
    ``Entry.state``'s form). Also the state it ends in."""
    model = cell['config']['model']
    generator = torch.Generator(device)
    if start is None:
        state = seeded_state(compare_shapes(model), seed, device, torch.float32)
        generator.manual_seed(int(seed))
        adam, first = None, 0
    else:
        state, adam, first = start['params'], start['adam'], start['batch']
        generator.set_state(start['generator'])
    ref = compare.build(model, state, device).train()
    math = compare.fp32_math
    if program is not None:
        ref, math = program(ref)
    with math():
        out = reference.train_steps(ref, batches_from(cell, seed, device, first), generator,
                                    cell['config']['train'], adam)
    out['end'] = {'params': out.pop('params'), 'adam': out.pop('adam'),
                  'generator': generator.get_state(), 'batch': first + FOLLOWED}
    del ref
    torch.cuda.empty_cache()
    return out


def reference_steps(cell: dict, seed: int, device, evidence: dict) -> dict:
    """The reference's two stages: from the seed, and from the state the
    program's replays started from."""
    return {'start': stage_steps(cell, seed, device),
            'replay': stage_steps(cell, seed, device, evidence['replay']['from'])}


def numbers(cell: dict, seed: int, device, kept: dict) -> dict:
    return train_numbers(kept, reference_steps(cell, seed, device, kept))


def judge(cell: dict, seed: int, device, kept: dict):
    return compare.checks(numbers(cell, seed, device, kept), cell['workload']['limits'])


def control(cell: dict, seed: int, device, picks) -> dict:
    """The control's numbers: the reference in the next precision below the
    configuration's takes the program's six steps; the reference follows
    its first three from the seed and its last three from the state its
    first three left."""
    lowered = lambda m: compare.lower(m, cell['config']['precision'])  # noqa: E731
    start = stage_steps(cell, seed, device, program=lowered)
    replay = stage_steps(cell, seed, device, start['end'], program=lowered)
    low = {'start': start, 'replay': {**replay, 'from': start['end']}}
    return train_numbers(low, reference_steps(cell, seed, device, low))


@contextlib.contextmanager
def planted(fault: str):
    """The port's trainer with ``fault`` planted, so that it runs inside the
    graphs the window replays: ``state unchanged``, the update clips the
    gradients and takes no Adam step; ``half batch``, the loss on the
    first half of each batch's rows, the mean over them."""
    from stp3_tpu_torch.training.trainer import Trainer
    name = {'state unchanged': '_update', 'half batch': 'loss_fn'}[fault]
    original = getattr(Trainer, name)
    if fault == 'state unchanged':
        def fn(self):
            torch.nn.utils.clip_grad_norm_(self.model.parameters(),
                                           float(self.cfg.GRAD_NORM_CLIP))
    else:
        def fn(self, batch, *args, **kwargs):
            rows = {k: v[: v.shape[0] // 2] if torch.is_tensor(v) and v.ndim else v
                    for k, v in batch.items()}
            return original(self, rows, *args, **kwargs)
    setattr(Trainer, name, fn)
    try:
        yield
    finally:
        setattr(Trainer, name, original)


def faults(cell: dict, seed: int, device) -> dict:
    """{fault: numbers} of each fault this cell can have (``planted``),
    planted in the port and judged as a run judges it."""
    out = {}
    for fault in ('state unchanged', 'half batch'):
        with planted(fault):
            entry = Entry(cell, seed, device)
            kept = entry.evidence({})
            entry.release()
            del entry
        torch.cuda.empty_cache()
        out[fault] = numbers(cell, seed, device, kept)
    return out
