#!/usr/bin/env python
r"""Time the Legendre kernels K1-K4 alone on one CUDA device:

    python examples/bench_legendre_torch.py [--reps 3] [--sweep] [--ptxas] [--json bench_legendre.json]

A loop of seconds for kernel work, where chip_smoke.py takes minutes. It builds the library,
holds K1-K4 against their plain torch twins at lmax 256 (f32 <= 1e-5, f64 <= 1e-12 of max;
257 rings for the pair kernels, 201 random rings for the plain ones; the analysis kernels
once with the planner's ring segments and once forced to one segment), then times, with
CUDA events, `--reps` launches after one warm-up, without the twins (they take seconds at
these sizes; ten times the launches at the pixel-window shape, which takes ~1 ms):

  K1  spin-1 pair (mode 1), f32, lmax 2048 on the 3073-ring QE grid, batch 8 and batch 4,
      and spin 0 with one input (mode 0) at batch 4: the main path's K1 shapes;
  K3  n = -2, f64, lmax 2048 on all 8191 rings of HEALPix nside 2048, batch 4: the HEALPix
      path's;
  K2  spin-1 pair, f32, lmax 2048 on the 3073-ring QE grid, batch 4 and batch 8;
  K1, K2  the masked filter's CG shapes (models/cinv.py), f64 on the 2049 rings of
      gl_geometry(2048): spin 0 with one input (CinvT) at batch 1 and 8, the spin-2 pair
      (CinvP) at batch 4, each with its bound (ops/sht/roofline.pair_bound);
  K4  n = -2, f64, lmax 2048 on all 8191 rings of HEALPix nside 2048, batch 4;
  K4  n = 2, f64, lmax 512 on the 48 node rings of the exact pixel window of nside 128
      against its 64 pixel shapes.

Every timed shape is run twice and must be bitwise equal; where the planner splits the
rings, the result is also held against the one-segment result (f32 <= 1e-5, f64 <= 1e-12
of max). `--sweep` also times the lmax-2048 analysis shapes with the ring sum forced
into 1, 2, 4, 8 and 16 segments. `--ptxas` prints the registers and spills of every
instantiation of the synthesis and analysis kernels (`legendre_kernels.ptxas_report`).
One line per shape, each with the card's name and power limit (and the block shape of a
synthesis); the last line of standard output is one JSON object with the same numbers.
Raises without a card.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

import torch


LMAX = 2048
NSIDE = 2048


def rel_max(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def event_ms(fn, reps):
    """(mean ms, min ms, last result) of `reps` launches, each between two CUDA events."""
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return sum(times) / len(times), min(times), out


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--reps', type=int, default=3)
    p.add_argument('--sweep', action='store_true',
                   help='also time the lmax-2048 shapes at forced segment counts')
    p.add_argument('--ptxas', action='store_true',
                   help="print the compiler's register and spill report of the synthesis and "
                        "analysis kernels")
    p.add_argument('--json', default=None, help='also write the result object to this file')
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('bench_legendre_torch: needs a CUDA device')

    from plancklens_tpu_torch.ops.sht import core, legendre_kernels as lk, HealpixGeometry
    from plancklens_tpu_torch.ops.sht.geometry import gl_geometry
    from plancklens_tpu_torch.ops.sht.pixwin import _ring_Gm
    from plancklens_tpu_torch.ops.sht.roofline import pair_bound
    dev = torch.device('cuda:0')
    smi = subprocess.run(['nvidia-smi', '-i', '0', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    lk.build()
    lk._load()
    print('built in %.1f s | %s' % (time.perf_counter() - t0, smi), flush=True)
    if args.ptxas:
        for k in lk.build_report():
            if k['kernel'] in ('synth_pair_kernel', 'anal_pair_kernel'):
                print('    %s<%s>: %d registers, %d bytes stack, %d/%d bytes spill stores/loads'
                      % (k['kernel'], ', '.join(map(str, k['args'])), k['registers'],
                         k['stack'], k['spill_stores'], k['spill_loads']))
    gen = torch.Generator(device=dev).manual_seed(256)

    def crandn(shape, cdt):
        return torch.randn(shape, generator=gen, device=dev, dtype=cdt)

    def plan_of(kind):
        pl = lk.last_plan[kind]
        return {'nseg': pl.nseg, 'blocks': pl.blocks, 'workspace_mib': pl.workspace_bytes / 2 ** 20}

    # ------------------------------------------------ the four kernels against their twins
    lmax = 256
    worst = {'synth_pair': 0., 'anal_pair': 0., 'synth': 0., 'anal': 0.}
    nrings = 257
    theta = gl_geometry(nrings - 1).theta
    rng = np.random.RandomState(256)
    th_r = np.sort(rng.uniform(0., np.pi, 201))
    th_r[0], th_r[-1] = 4e-4, np.pi - 7e-4
    segs = set()
    for cdt, tol in ((torch.complex64, 1e-5), (torch.complex128, 1e-12)):
        for spin in (0, 1, 2, 3):
            t_m, t_p = core.pair_tables(lmax, lmax, spin, theta, None, dev)
            C, Cm = crandn((3, lmax + 1, lmax + 1), cdt), crandn((3, lmax + 1, lmax + 1), cdt)
            Q, Qm = crandn((3, nrings, lmax + 1), cdt), crandn((3, nrings, lmax + 1), cdt)
            for cm, qm in ((Cm, Qm), (None, None)):
                ks = lk.synth_pair(C, cm, spin, nrings, t_m, t_p)
                ps = core.legendre_synth_pair_plain(C, cm, spin, nrings, t_m, t_p)
                worst['synth_pair'] = max([worst['synth_pair']] + [
                    rel_max(a, b) for a, b in zip(ks, ps) if b is not None])
                pa = core.legendre_anal_pair_plain(Q, qm, spin, lmax, t_m, t_p)
                for nseg in (None, 1):
                    ka = lk.anal_pair(Q, qm, spin, lmax, t_m, t_p, nseg=nseg)
                    segs.add(lk.last_plan['anal_pair'].nseg)
                    worst['anal_pair'] = max([worst['anal_pair']] + [
                        rel_max(a, b) for a, b in zip(ka, pa) if b is not None])
        for n in range(-3, 4):
            t = core.full_tables(lmax, lmax, n, th_r, None, dev)
            C, Q = crandn((3, lmax + 1, lmax + 1), cdt), crandn((3, len(th_r), lmax + 1), cdt)
            worst['synth'] = max(worst['synth'],
                                 rel_max(lk.synth(C, len(th_r), t), core.legendre_synth_plain(C, t)))
            pa = core.legendre_anal_plain(Q, lmax, t)
            for nseg in (None, 1):
                worst['anal'] = max(worst['anal'], rel_max(lk.anal(Q, lmax, t, nseg=nseg), pa))
                segs.add(lk.last_plan['anal'].nseg)
        torch.cuda.synchronize()
        for k, v in worst.items():
            if not v <= tol:
                raise RuntimeError('%s vs its plain twin at lmax %d, %s: %.2e > %.0e'
                                   % (k, lmax, cdt, v, tol))
        print('lmax 256, %s: worst of max vs the twins %s (segment counts run: %s)'
              % (cdt, ', '.join('%s %.2e' % kv for kv in worst.items()),
                 sorted(segs)), flush=True)
        worst = dict.fromkeys(worst, 0.)

    # ------------------------------------------------------------------ the timed shapes
    results = []

    def timed(label, kind, call, tol, sweep, reps=args.reps, shape=None):
        """Warm up, time, check run-to-run equality and, for a split ring sum, agreement
        with one segment. `call(nseg)` returns a tuple of outputs; the synthesis calls
        ignore `nseg` and name their block shape (`legendre_kernels.synth_shape`)."""
        first = call(None)
        mean, best, out = event_ms(lambda: call(None), reps)
        for a, b in zip(first, out):
            if not torch.equal(a, b):
                raise RuntimeError('%s: two runs differ' % label)
        row = dict(shape=label, kernel=kind, ms=mean, ms_min=best, card=smi)
        note = ''
        if shape is not None:
            row['block_shape'] = shape
            note = ' | %d maps x %d rings x %d warps, %d block(s) an SM' % shape
        if kind in ('anal_pair', 'anal'):
            row.update(plan_of(kind))
            note = ' | NS %d, %d blocks, workspace %.0f MiB' % (
                row['nseg'], row['blocks'], row['workspace_mib'])
        if row.get('nseg', 1) > 1:
            one = call(1)
            row['vs_one_segment'] = max(rel_max(a, b) for a, b in zip(out, one))
            if not row['vs_one_segment'] <= tol:
                raise RuntimeError('%s: %d segments vs one: %.2e > %.0e'
                                   % (label, row['nseg'], row['vs_one_segment'], tol))
            note += ', %.1e of max from one segment' % row['vs_one_segment']
            del one
        if sweep and 'nseg' in row:
            row['sweep'] = {}
            n = 1
            while n <= 16:
                call(n)
                got = plan_of(kind)
                row['sweep']['%d' % got['nseg']] = (event_ms(lambda: call(n), args.reps)[0],
                                                    got['blocks'], got['workspace_mib'])
                n *= 2
        results.append(row)
        print('%s: %.3f ms (min %.3f)%s | %s' % (label, mean, best, note, smi), flush=True)
        for k, v in row.get('sweep', {}).items():
            print('    forced NS %s: %.3f ms, %d blocks, workspace %.0f MiB' % ((k,) + v))
        return row

    geom = gl_geometry(3 * LMAX // 2)                 # the QE grid of lmax 2048: 3073 rings
    nr = geom.nrings
    t_m, t_p = core.pair_tables(LMAX, LMAX, 1, geom.theta, None, dev)
    for B in (8, 4):
        C, Cm = (crandn((B, LMAX + 1, LMAX + 1), torch.complex64) for _ in range(2))
        timed('K1 synth_pair, spin-1 pair, f32, lmax %d, %d rings, batch %d' % (LMAX, nr, B),
              'synth_pair', lambda nseg: lk.synth_pair(C, Cm, 1, nr, t_m, t_p), 1e-5, False,
              shape=lk.synth_shape('pair', 'f32', B))
        del C, Cm
        Qp, Qm = (crandn((B, nr, LMAX + 1), torch.complex64) for _ in range(2))
        timed('K2 anal_pair, spin-1 pair, f32, lmax %d, %d rings, batch %d' % (LMAX, nr, B),
              'anal_pair', lambda nseg: lk.anal_pair(Qp, Qm, 1, LMAX, t_m, t_p, nseg=nseg),
              1e-5, args.sweep)
        del Qp, Qm
    del t_m, t_p
    t_0, _ = core.pair_tables(LMAX, LMAX, 0, geom.theta, None, dev)
    C = crandn((4, LMAX + 1, LMAX + 1), torch.complex64)
    timed('K1 synth_pair, spin 0, one input, f32, lmax %d, %d rings, batch 4' % (LMAX, nr),
          'synth_pair', lambda nseg: lk.synth_pair(C, None, 0, nr, t_0, t_0)[:1], 1e-5, False,
          shape=lk.synth_shape('pair', 'f32', 4))
    del C, t_0
    torch.cuda.empty_cache()

    cg_geom = gl_geometry(LMAX)                      # the cinv grid of lmax 2048: 2049 rings
    ncg, L = cg_geom.nrings, LMAX + 1

    def with_bound(row, tabs, mode, B):
        """roofline.pair_bound of the f64 pair call timed in `row`."""
        row['bound_ms'], row['bound_by'] = pair_bound(tabs, mode, B, ncg, True)
        print('    bound %.3f ms (%s): %.1f%% of it' % (row['bound_ms'], row['bound_by'],
                                                    100. * row['bound_ms'] / row['ms']))

    t_0, _ = core.pair_tables(LMAX, LMAX, 0, cg_geom.theta, None, dev)
    for B in (1, 8):
        C = crandn((B, L, L), torch.complex128)
        with_bound(timed('K1 synth_pair, spin 0, one input, f64, lmax %d, %d rings, batch %d '
                         '(CinvT)' % (LMAX, ncg, B), 'synth_pair',
                         lambda nseg: lk.synth_pair(C, None, 0, ncg, t_0, t_0)[:1], 1e-12,
                         False, shape=lk.synth_shape('pair', 'f64', B)), [t_0], 0, B)
        Q = crandn((B, ncg, L), torch.complex128)
        with_bound(timed('K2 anal_pair, spin 0, one input, f64, lmax %d, %d rings, batch %d '
                         '(CinvT)' % (LMAX, ncg, B), 'anal_pair',
                         lambda nseg: lk.anal_pair(Q, None, 0, LMAX, t_0, t_0, nseg=nseg)[:1],
                         1e-12, args.sweep), [t_0], 0, B)
        del C, Q
    del t_0
    t_m, t_p = core.pair_tables(LMAX, LMAX, 2, cg_geom.theta, None, dev)
    C, Cm = (crandn((4, L, L), torch.complex128) for _ in range(2))
    with_bound(timed('K1 synth_pair, spin-2 pair, f64, lmax %d, %d rings, batch 4 (CinvP)'
                     % (LMAX, ncg), 'synth_pair',
                     lambda nseg: lk.synth_pair(C, Cm, 2, ncg, t_m, t_p), 1e-12, False,
                     shape=lk.synth_shape('pair', 'f64', 4)), [t_m, t_p], 1, 4)
    del C, Cm
    Qp, Qm = (crandn((4, ncg, L), torch.complex128) for _ in range(2))
    with_bound(timed('K2 anal_pair, spin-2 pair, f64, lmax %d, %d rings, batch 4 (CinvP)'
                     % (LMAX, ncg), 'anal_pair',
                     lambda nseg: lk.anal_pair(Qp, Qm, 2, LMAX, t_m, t_p, nseg=nseg), 1e-12,
                     args.sweep), [t_m, t_p], 1, 4)
    del Qp, Qm, t_m, t_p
    torch.cuda.empty_cache()

    hgeom = HealpixGeometry(NSIDE)
    t = core.full_tables(LMAX, LMAX, -2, hgeom.theta, None, dev)
    C = crandn((4, LMAX + 1, LMAX + 1), torch.complex128)
    timed('K3 synth, n -2, f64, lmax %d, %d rings, batch 4' % (LMAX, hgeom.nrings), 'synth',
          lambda nseg: (lk.synth(C, hgeom.nrings, t),), 1e-12, False,
          shape=lk.synth_shape('plain', 'f64', 4))
    del C
    torch.cuda.empty_cache()
    Q = crandn((4, hgeom.nrings, LMAX + 1), torch.complex128)
    timed('K4 anal, n -2, f64, lmax %d, %d rings, batch 4' % (LMAX, hgeom.nrings), 'anal',
          lambda nseg: (lk.anal(Q, LMAX, t, nseg=nseg),), 1e-12, args.sweep)
    del Q, t
    torch.cuda.empty_cache()

    Gm, th_pw, _ = _ring_Gm(128, 128, 512)
    Gm = torch.as_tensor(Gm, device=dev)
    t = core.full_tables(512, 512, 2, th_pw, None, dev)
    timed('K4 anal, pixel-window shape, n 2, f64, lmax 512, %d node rings, batch %d'
          % (len(th_pw), Gm.shape[0]), 'anal',
          lambda nseg: (lk.anal(Gm, 512, t, nseg=nseg),), 1e-12, False,
          reps=10 * args.reps)              # a short kernel: more launches for a steady mean

    out = {'card': smi, 'reps': args.reps, 'shapes': results}
    for k, kind in (('k1', 'synth_pair'), ('k2', 'anal_pair')):
        b8, b4 = [r['ms'] for r in results if r['kernel'] == kind][:2]
        out['%s_batch4_over_batch8' % k] = b4 / b8
        print('%s batch 4 / batch 8 time ratio: %.4f | %s' % (k.upper(), b4 / b8, smi))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, 'w') as f:
            json.dump(out, f)
    print(json.dumps(out))


if __name__ == '__main__':
    main()
