"""Readings of the checks over many seeds in one process, for setting their limits:

    python3 portbench/readings.py --workload <cell> --seeds <first> <count> --seconds 1 \
        [--control f32|qe_f32|tf32]

Each seed is a whole run of run.py's (set-up, a window of whole steps, the check against
the reference) without the process's start-up; the libraries' kernel build and dense
blocks come from the first seed's. Prints one JSON line a seed: its checks, readings and
failures. Needs a CUDA card.
"""
import argparse
import gc
import json
import os
import sys
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import portbench.run as R  # noqa: E402


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs=2, required=True, metavar=('FIRST', 'COUNT'))
    p.add_argument('--seconds', type=float, default=1.)
    p.add_argument('--control', default=None, choices=('f32', 'qe_f32', 'tf32'))
    a = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 2
    for seed in range(a.seeds[0], a.seeds[0] + a.seeds[1]):
        args = types.SimpleNamespace(workload=a.workload, seed=seed, seconds=a.seconds,
                                     trace=0, control=a.control, override=None,
                                     traffic_override=None)
        try:
            out = R.run(args, 'cuda:0')
            line = dict(seed=seed, control=a.control, correct=out['correct'],
                        failed=out['failed'], attempted=out['attempted'],
                        checks={k: c['value'] for k, c in out['checks'].items()})
        except Exception as e:          # a control that crashes has failed
            line = dict(seed=seed, control=a.control, error=repr(e)[:500])
        print('READING ' + json.dumps(line), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
