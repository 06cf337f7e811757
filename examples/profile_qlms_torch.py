#!/usr/bin/env python
r"""Profile the port's main path on one CUDA device and say where the time goes:

    python examples/profile_qlms_torch.py [--lmax 2048] [--nsims 8]
        [--trace chiprun_out/main_path_trace.json]

Runs the stages filt, qe, mf (sims 0..nsims-1) and qcl (mc_sims_var) of
params/idealized_example_torch.py with keys ptt and p_p, from a cold start (empty caches,
as chip_smoke.py runs them), under torch.profiler with CPU and CUDA activities. From the
exported Chrome trace it reports:

  * device busy seconds: the union of all device-activity intervals (kernels, memcpy,
    memset) inside the profiled window, so overlapping activities count once;
  * the idle share: 1 - busy / window, the window being the span of the `main_path`
    profiler range around the four stages (they end with a device synchronisation);
  * device seconds and counts per kernel name and per memcpy kind, and per group: the
    four Legendre kernels K1-K4 (told apart by kernel name and the mode template
    argument; the second pass of a split analysis counts with its kernel), cuFFT kernels,
    copies and the rest;
  * host seconds in the recursion-table builds (the `sht.recursion_tables` ranges).

The last line of standard output is one JSON object with these numbers.
"""
import argparse
import json
import os
import re
import subprocess
import sys
import time
from collections import defaultdict

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (_REPO, os.path.join(_REPO, 'examples')):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
# csrc/legendre_pair.cu's kernels: direction, K4's second pass or K2's cluster kernel, and
# the mode, which is the last template argument
_LEGENDRE = re.compile(r'(synth|anal)_pair(_sum|_mma)?_kernel<[^>]*?(\d+)>')


def device_group(e):
    """Group of a device activity: K1-K4 by kernel name and mode, cuFFT, copies, rest. The
    second pass of K4's split ring sum (anal_pair_sum_kernel) falls to K4."""
    if e['cat'] != 'kernel':
        return 'copies' if e['cat'] == 'gpu_memcpy' else 'memset'
    m = _LEGENDRE.search(e['name'])
    if m:
        plain = int(m.group(3)) == 3
        return {('synth', False): 'K1 synth_pair', ('anal', False): 'K2 anal_pair',
                ('synth', True): 'K3 synth', ('anal', True): 'K4 anal'}[(m.group(1), plain)]
    return 'cufft' if 'fft' in e['name'].lower() else 'other kernels'


def is_second_pass(e):
    m = _LEGENDRE.search(e['name']) if e['cat'] == 'kernel' else None
    return bool(m and m.group(2) == '_sum')


def union_seconds(intervals):
    """Total length of the union of (start, end) intervals in microseconds, as seconds."""
    busy, cur = 0., None
    for a, b in sorted(intervals):
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy / 1e6


def summarize(events, window='main_path'):
    """Busy/idle, per-name device times and table-build seconds of a Chrome trace, inside
    the one profiler range named `window`."""
    spans = [e for e in events if e.get('ph') == 'X' and 'dur' in e]
    win = [e for e in spans if e.get('name') == window
           and e.get('cat') == 'user_annotation']
    if len(win) != 1:
        raise RuntimeError('expected one %s range in the trace, found %d' % (window, len(win)))
    w0, w1 = win[0]['ts'], win[0]['ts'] + win[0]['dur']
    dev = [e for e in spans if e.get('cat') in DEVICE_CATS]
    clipped = [(max(e['ts'], w0), min(e['ts'] + e['dur'], w1)) for e in dev]
    busy = union_seconds([(a, b) for a, b in clipped if b > a])
    window = (w1 - w0) / 1e6
    per_name = defaultdict(lambda: [0., 0])
    groups = defaultdict(lambda: [0., 0])
    for e in dev:
        row = per_name[(e['cat'], e['name'])]
        row[0] += e['dur'] / 1e6
        row[1] += 1
        g = groups[device_group(e)]
        g[0] += e['dur'] / 1e6
        g[1] += not is_second_pass(e)      # calls of a kernel, not its device rows
    tables = [e['dur'] / 1e6 for e in spans if e.get('name') == 'sht.recursion_tables'
              and e.get('cat') == 'user_annotation']
    rows = sorted(((s, n, cat, name) for (cat, name), (s, n) in per_name.items()),
                  reverse=True)
    return {'window_s': window, 'device_busy_s': busy, 'idle_share': 1. - busy / window,
            'device_sum_s': sum(r[0] for r in rows),
            'table_builds_s': sum(tables), 'table_builds': len(tables),
            'groups': {k: {'s': t, 'calls': n} for k, (t, n) in
                       sorted(groups.items(), key=lambda kv: -kv[1][0])},
            'rows': [{'cat': cat, 'name': name[:90], 's': s, 'calls': n}
                     for s, n, cat, name in rows]}


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--lmax', type=int, default=2048)
    p.add_argument('--nsims', type=int, default=8)
    p.add_argument('--trace', default=os.path.join('chiprun_out', 'main_path_trace.json'))
    p.add_argument('--rows', type=int, default=15, help='device rows to print')
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('profile_qlms_torch: needs a CUDA device')

    from plancklens_tpu_torch.ops.sht import core, legendre_kernels as lk
    import run_qlms_torch as drv
    smi = subprocess.run(['nvidia-smi', '-i', '0', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True).stdout.strip()
    dev = torch.device('cuda:0')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lk.build()
    lk._load()
    os.environ.update(PLK_LMAX_IVF=str(args.lmax), PLK_LMAX_QLM=str(args.lmax),
                      PLK_NSIMS=str(args.nsims))
    os.environ.pop('PLK_CACHE_DIR', None)
    par = drv.load_parfile(os.path.join(_REPO, 'params', 'idealized_example_torch.py'), dev)
    keys = ('ptt', 'p_p')
    idxs = list(range(args.nsims))
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function('main_path'), core.counting() as c:
            _, s_filt = drv.stage_filt(par, idxs)
            _, s_qe = drv.stage_qe(par, keys, idxs)
            _, s_mf = drv.stage_mf(par, keys)
            _, s_qcl = drv.stage_qcl(par, keys, par.mc_sims_var)
            torch.cuda.synchronize()
        host_wall = time.perf_counter() - t0
    os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
    prof.export_chrome_trace(args.trace)
    with open(args.trace) as f:
        trace = json.load(f)
    out = summarize(trace['traceEvents'] if isinstance(trace, dict) else trace)
    out.update(card=smi, lmax=args.lmax, nsims=args.nsims, host_wall_s=host_wall,
               stages_s={'filt': s_filt, 'qe': s_qe, 'mf': s_mf, 'qcl': s_qcl},
               calls={str(k): n for k, n in c.calls.items()})
    print(smi)
    print('profiled window %.3f s (host clock %.3f s); device busy %.3f s (union), idle '
          'share %.4f; device activity summed %.3f s; %d table builds, %.3f s host'
          % (out['window_s'], host_wall, out['device_busy_s'], out['idle_share'],
             out['device_sum_s'], out['table_builds'], out['table_builds_s']))
    for name, g in out['groups'].items():
        print('  group %-14s %8.4f s %6d' % (name, g['s'], g['calls']))
    for r in out['rows'][:args.rows]:
        print('  %9.4f s %6d  %-10s %s' % (r['s'], r['calls'], r['cat'], r['name']))
    out['rows'] = out['rows'][:args.rows]
    print(json.dumps(out))


if __name__ == '__main__':
    main()
