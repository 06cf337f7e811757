#!/usr/bin/env python
r"""Profile the port's HEALPix entry path on one CUDA device and say where the time goes:

    python examples/profile_healpix_torch.py [--nside 2048] [--lmax 2048] [--nsims 4]
        [--trace plancklens_tpu_torch/_build/healpix_path_trace.json]

Runs the path of chip_smoke.py's phase 5b (`healpix_path` below, which chip_smoke.py
calls too) from a cold start, as chip_smoke.py runs it: the observed T/E/B alms of sims
0..nsims-1 of params/idealized_example_torch.py -> HealpixSHT.alm2map(_spin) (f64) ->
map2alm(_spin)(iter=3) -> healpy FITS alms -> ExternalAlmLib -> IVFSepTP -> QELib ptt,
p_p (f32). Each step runs in a `healpix_path.<step>` profiler range inside one
`healpix_path` range. From the exported Chrome trace it reports:

  * the device idle share of the path and of each step (union of device intervals);
  * device seconds by group: the four Legendre kernels K1-K4 (told apart by kernel name
    and the mode template argument; the second pass of a split analysis counts with its
    kernel), cuFFT kernels, copies and the rest;
  * the longitude phase (`healpix.rings_to_map`/`healpix.map_to_rings` ranges): host
    seconds, and the device seconds of the work launched inside them, found through each
    launch's correlation id;
  * host seconds of the recursion-table builds (`sht.recursion_tables` ranges).

The last line of standard output is one JSON object with these numbers.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (_REPO, os.path.join(_REPO, 'examples')):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch

from profile_qlms_torch import DEVICE_CATS, device_group, summarize, union_seconds  # noqa: F401

STEPS = ('alm2map', 'alm2map_spin', 'map2alm', 'map2alm_spin', 'fits_write', 'fits_read_qe')
LONGITUDE = ('healpix.rings_to_map', 'healpix.map_to_rings')


def healpix_path(par, obs, idxs, keys, tdir, nside, lmax, device):
    """The HEALPix entry path on the observed alms `obs` = (T, E, B), each (len(idxs),
    nalm): f64 alm2map and alm2map_spin to nside maps, map2alm(_spin) back with healpy's
    iter=3 and no ring weights, healpy FITS alms of sims `idxs` in `tdir`, then
    ExternalAlmLib -> IVFSepTP (the parfile's filter) -> QELib (f32 on a CUDA device) for
    `keys`. Returns (maps, alms, qlms, seconds per step); step seconds come from
    run_qlms_torch.StageTimer (CUDA events on the card)."""
    import run_qlms_torch as drv
    from plancklens_tpu_torch.ops.sht import HealpixSHT
    from plancklens_tpu_torch.utils import fitsio
    from plancklens_tpu_torch.models.sims import ExternalAlmLib
    from plancklens_tpu_torch.models.filt import IVFSepTP
    from plancklens_tpu_torch.models.qest import QELib
    secs = {}

    def step(name, fn):
        with torch.profiler.record_function('healpix_path.' + name), \
                drv.StageTimer(device) as tm:
            out = fn()
        secs[name] = tm.seconds
        return out

    with torch.profiler.record_function('healpix_path'):
        hp = HealpixSHT(nside, lmax, dtype=torch.float64, use_ring_weights=False,
                        device=device)
        tmap = step('alm2map', lambda: hp.alm2map(obs[0]))
        qmap, umap = step('alm2map_spin', lambda: hp.alm2map_spin((obs[1], obs[2]), 2))
        tlm = step('map2alm', lambda: hp.map2alm(tmap, iter=3))
        elm, blm = step('map2alm_spin', lambda: hp.map2alm_spin((qmap, umap), 2, iter=3))

        def write():
            for f, a in zip('teb', (tlm, elm, blm)):
                for j, i in enumerate(idxs):
                    fitsio.write_alm(os.path.join(tdir, 'sim_%slm_%04d.fits' % (f, i)),
                                     a[j].cpu().numpy())
        step('fits_write', write)
        ivfs = IVFSepTP(ExternalAlmLib(tdir, ext='fits', device=device), par.transf,
                        par.cl_len, par.ftl, par.fel, par.fbl)
        qdtype = torch.float32 if torch.device(device).type == 'cuda' else torch.float64
        qlib = QELib(ivfs, ivfs, par.cl_len, lmax, lmax, dtype=qdtype, device=device)
        qlms = step('fits_read_qe', lambda: {k: qlib.get_sim_qlm_batch(k, idxs) for k in keys})
    return (tmap, qmap, umap), (tlm, elm, blm), qlms, secs


def attribute(events, names):
    """Device seconds of the activities launched inside each host range named in `names`:
    a launch (cuda_runtime/cuda_driver event) is matched to its device activity through
    args['correlation'], and to the innermost of those ranges containing it in time."""
    spans = [e for e in events if e.get('ph') == 'X' and 'dur' in e]
    ranges = sorted(((e['ts'], e['ts'] + e['dur'], e['name']) for e in spans
                     if e.get('cat') == 'user_annotation' and e.get('name') in names),
                    key=lambda r: r[1] - r[0])
    launch_at = {e['args']['correlation']: e['ts'] for e in spans
                 if e.get('cat') in ('cuda_runtime', 'cuda_driver')
                 and 'correlation' in e.get('args', {})}
    out = {n: 0. for n in names}
    for e in spans:
        if e.get('cat') not in DEVICE_CATS:
            continue
        ts = launch_at.get(e.get('args', {}).get('correlation'))
        if ts is None:
            continue
        for a, b, n in ranges:             # the shortest containing range is the innermost
            if a <= ts <= b:
                out[n] += e['dur'] / 1e6
                break
    return out


def summarize_path(events):
    """The path's idle share, per-step busy/idle, device groups, longitude phase and
    table builds, from a Chrome trace holding one `healpix_path` range."""
    out = summarize(events, window='healpix_path')
    spans = [e for e in events if e.get('ph') == 'X' and 'dur' in e]
    dev = [e for e in spans if e.get('cat') in DEVICE_CATS]
    steps = {}
    for e in spans:
        name = e.get('name', '')
        if e.get('cat') != 'user_annotation' or not name.startswith('healpix_path.'):
            continue
        a, b = e['ts'], e['ts'] + e['dur']
        busy = union_seconds([(max(d['ts'], a), min(d['ts'] + d['dur'], b)) for d in dev
                              if d['ts'] < b and d['ts'] + d['dur'] > a])
        steps[name.split('.', 1)[1]] = {'s': e['dur'] / 1e6, 'device_busy_s': busy,
                                        'idle_share': 1. - busy / (e['dur'] / 1e6)}
    lon_host = sum(e['dur'] / 1e6 for e in spans
                   if e.get('cat') == 'user_annotation' and e.get('name') in LONGITUDE)
    out.update(steps=steps,
               longitude={'host_s': lon_host,
                          'device_s': sum(attribute(events, LONGITUDE).values())})
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--nside', type=int, default=2048)
    p.add_argument('--lmax', type=int, default=2048)
    p.add_argument('--nsims', type=int, default=4)
    p.add_argument('--trace', default=os.path.join(_REPO, 'plancklens_tpu_torch', '_build',
                                                   'healpix_path_trace.json'))
    p.add_argument('--rows', type=int, default=15, help='device rows to print')
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('profile_healpix_torch: needs a CUDA device')

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
                      PLK_NSIMS=str(max(args.nsims, 2)))
    os.environ.pop('PLK_CACHE_DIR', None)
    par = drv.load_parfile(os.path.join(_REPO, 'params', 'idealized_example_torch.py'), dev)
    idxs = list(range(args.nsims))
    obs = par.sims.get_sim_teblm_batch(idxs)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory() as tdir, torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with core.counting() as c:
            _, _, _, secs = healpix_path(par, obs, idxs, ('ptt', 'p_p'), tdir, args.nside,
                                         args.lmax, dev)
        torch.cuda.synchronize()
        host_wall = time.perf_counter() - t0
    os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
    prof.export_chrome_trace(args.trace)
    with open(args.trace) as f:
        trace = json.load(f)
    out = summarize_path(trace['traceEvents'] if isinstance(trace, dict) else trace)
    out.update(card=smi, nside=args.nside, lmax=args.lmax, nsims=args.nsims,
               host_wall_s=host_wall, step_event_s=secs,
               calls={str(k): n for k, n in c.calls.items()})
    print(smi)
    print('profiled window %.3f s (host clock %.3f s); device busy %.3f s (union), idle '
          'share %.4f; %d table builds, %.3f s host; longitude phase %.3f s host, %.3f s '
          'device' % (out['window_s'], host_wall, out['device_busy_s'], out['idle_share'],
                      out['table_builds'], out['table_builds_s'], out['longitude']['host_s'],
                      out['longitude']['device_s']))
    for name, st in out['steps'].items():
        print('  step %-13s %8.3f s, device busy %8.3f s, idle share %.4f'
              % (name, st['s'], st['device_busy_s'], st['idle_share']))
    for name, g in out['groups'].items():
        print('  group %-14s %8.4f s %6d' % (name, g['s'], g['calls']))
    for r in out['rows'][:args.rows]:
        print('  %9.4f s %6d  %-10s %s' % (r['s'], r['calls'], r['cat'], r['name']))
    out['rows'] = out['rows'][:args.rows]
    print(json.dumps(out))


if __name__ == '__main__':
    main()
