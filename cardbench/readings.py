#!/usr/bin/env python3
"""The two readings each compared number's limit is set from, in one
process (set-up is long):

    python3 cardbench/readings.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 --seconds 3

For each of ``--seeds``, the port at the cell's own size and load for a
short window, judged as a run judges it; for each of ``--control-seeds``,
the control (the reference in the next precision below the
configuration's) in the port's place on as many of the traffic's inputs
as a run compares. One JSON line each, then the largest program reading
and the smallest control reading of every number; with ``--fault-seeds``,
each fault the cell's entry plants (``faults``: the training entry's, in
the port's trainer). The benchmark's own runs do not run this.
"""
import argparse
import json
import os
import random
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def seeds(text: str):
    return [int(s) for s in text.split(',') if s]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', type=seeds, default=[])
    parser.add_argument('--control-seeds', type=seeds, default=[])
    parser.add_argument('--fault-seeds', type=seeds, default=[])
    parser.add_argument('--seconds', type=float, default=3.0)
    args = parser.parse_args()
    sys.path[0] = ROOT
    import torch
    from cardbench import harness
    cell = harness.load_cell(args.workload, ROOT)
    module = harness.entry_module(cell['workload']['entry'], ROOT)
    device = torch.device('cuda', 0)
    k = int(cell['workload']['sample'])
    program, control = {}, {}
    for seed in args.seeds:
        entry = module.Entry(cell, seed, device)
        sample = harness.Reservoir(k, seed)
        _, steps, _ = harness.run_window(entry, args.seconds, sample, device)
        kept = entry.evidence(sample.kept) if hasattr(entry, 'evidence') else sample.kept
        entry.release()
        del entry
        harness.free_card(device)
        numbers = module.numbers(cell, seed, device, kept)
        print(json.dumps({'program': seed, 'steps': steps, **numbers}), flush=True)
        for name, v in numbers.items():
            program[name] = max(program.get(name, float('-inf')), v)
    for seed in args.control_seeds:
        picks = random.Random(seed).sample(range(int(cell['traffic']['pool'])), k) \
            if 'pool' in cell['traffic'] else None
        numbers = module.control(cell, seed, device, picks)
        harness.free_card(device)
        print(json.dumps({'control': seed, **numbers}), flush=True)
        for name, v in numbers.items():
            control[name] = min(control.get(name, float('inf')), v)
    for seed in args.fault_seeds:
        for fault, numbers in module.faults(cell, seed, device).items():
            harness.free_card(device)
            print(json.dumps({'fault': fault, 'seed': seed, **numbers}), flush=True)
    print(json.dumps({'program_max': program, 'control_min': control}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
