#!/usr/bin/env python
r"""The f32 precision of the JAX package's Legendre engine against its f64 engine, on the
CPU (ROADMAP fault 3.2; the port's counterpart is examples/bench_legendre_torch.py):

    python examples/f32_precision_jax.py [--lmax 512 1024 4096] [--batch 1]

For each lmax: the spin-1 pair synthesis (`ops/sht/core.legendre_synth_pair`, both legs,
the main path's QE shape of kernel K1) on the QE grid gl_geometry(3 lmax / 2) of the same
random alms (numpy seed lmax; l < m zeroed) in f32 (dtype=np.float32: the XLA scan path,
recursion and accumulation in f32) and in f64. It prints, a line each, the relative rms of
the difference (over both legs) and the max of max (max |f32 - f64| / max |f64|), with
the seconds of each call, and last one JSON object of the same numbers. No card: it
forces the CPU.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def alms(lmax, batch):
    """The two legs' (batch, lmax + 1, lmax + 1) complex128 alms of seed `lmax`, l < m
    zeroed (the same recipe as examples/bench_legendre_torch.py's precision rows)."""
    rng = np.random.RandomState(lmax)
    L = lmax + 1
    c = rng.standard_normal((2, batch, L, L)) + 1j * rng.standard_normal((2, batch, L, L))
    return c * np.tril(np.ones((L, L)))[None, None]


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--lmax', type=int, nargs='+', default=[512, 1024, 4096])
    p.add_argument('--batch', type=int, default=1)
    args = p.parse_args()
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    from plancklens_tpu.ops.sht import core, gl_geometry
    rows = []
    for lmax in args.lmax:
        theta = gl_geometry(3 * lmax // 2).theta
        cp, cm = alms(lmax, args.batch)
        out, secs = {}, {}
        for name, dt, cdt in (('f64', np.float64, np.complex128),
                              ('f32', np.float32, np.complex64)):
            t0 = time.perf_counter()
            fp, fm = core.legendre_synth_pair(cp.astype(cdt), cm.astype(cdt), 1, theta,
                                              dtype=dt)
            out[name] = np.stack([np.asarray(fp), np.asarray(fm)]).astype(np.complex128)
            secs[name] = time.perf_counter() - t0
            core.clear_cache()
        d = out['f32'] - out['f64']
        row = {'lmax': lmax, 'nrings': len(theta), 'batch': args.batch,
               'rel_rms': float(np.sqrt(np.mean(np.abs(d) ** 2)
                                        / np.mean(np.abs(out['f64']) ** 2))),
               'max_of_max': float(np.abs(d).max() / np.abs(out['f64']).max()),
               'seconds': secs}
        rows.append(row)
        print('JAX package f32 engine vs f64, spin-1 pair synthesis, lmax %d, %d rings, '
              'batch %d: relative rms %.3e, max of max %.3e (f64 %.1f s, f32 %.1f s; CPU)'
              % (lmax, len(theta), args.batch, row['rel_rms'], row['max_of_max'],
                 secs['f64'], secs['f32']), flush=True)
    print(json.dumps({'engine': 'plancklens_tpu f32 XLA scan vs f64, CPU', 'rows': rows}))


if __name__ == '__main__':
    main()
