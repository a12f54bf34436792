#!/usr/bin/env python3
"""Run one cell of the port's benchmark on this machine's GPU(s).

    python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The last line of standard output is the
result as one JSON object; the numbers compared with the reference, each
beside its limit, are the last lines of standard error. Kernel builds and
caches stay inside the checkout (``build/``).
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args()
    build = os.path.join(ROOT, 'build')
    os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(build, 'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = os.path.join(build, 'triton')
    os.environ['USE_FLAX'] = '0'
    sys.path[0] = ROOT              # not cardbench/: its module names stay its own
    from cardbench import harness
    return harness.run(args.workload, args.seed, args.seconds, bool(args.trace), ROOT)


if __name__ == '__main__':
    sys.exit(main())
