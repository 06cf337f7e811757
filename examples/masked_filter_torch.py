#!/usr/bin/env python
r"""Masked inverse-variance filtering of the port on one device, at the anisotropic parameter
file's configuration:

    python examples/masked_filter_torch.py [--lmax 2048] [--device cuda] [--f32]

`masked_path` (below, which chip_smoke.py phases 6b-6d call) runs, on maps synthesised from
the idealized parameter file's simulations (params/idealized_example_torch.py, sims.AlmMapLib)
on the Gauss-Legendre grid of lmax:

  T  cinv.CinvT (f64, dense low-l block to lmax_dense 64, built on the host) on a batch of
     8 maps in one lockstep solve;
  P  cinv.CinvP (f64, the coupled E/B block to lmax_dense 32 probed on the device) on a
     batch of 4 Q/U map pairs;
  route  cinv.IVFCinv (each sim filtered alone) -> filt.IVFFtl (l >= lmax/20) ->
     qest.QELib ptt and p_p in the parameter file's QE dtype, on 2 sims.

The configuration is params/anisofilt_example.py's (lines 40-63, copied: that file imports
JAX): the galactic cut |cos theta| > 0.15 with three holes, a 5' Gaussian beam, 35 / 55
uK-arcmin white noise as inverse pixel variances, FFP10 lensed spectra, eps 1e-5. Seconds
come from CUDA events on the card (run_qlms_torch.StageTimer), kernel calls from the
tracer's sht.legendre spans (`core.kernel_calls`: by kernel, mode, batch and data type;
`fma_k1`: the f64 K1 calls that did not run on the FP64 tensor cores, which should be none).
`--f32` adds the f32 CinvT solve of the same maps (not checked: see PERF.md, open
questions). On the card, the device time of 10 warm CinvT iterations is split by kernel
group (`trace_iterations`). Prints one line per step; the last line is one JSON object
with the numbers.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (_REPO, os.path.join(_REPO, 'examples')):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch

# maps in the lockstep T and P solves; sims of the route, each filtered alone
BATCH_T, BATCH_P, ROUTE_SIMS = 8, 4, (0, 1)


def aniso_inputs(lmax):
    """(geom, transf, {'t': ninv_t, 'p': ninv_p}) of params/anisofilt_example.py at lmax:
    the GL grid of lmax, the galactic cut plus three holes, the 5' Gaussian beam
    (n0s.gauss_beam), and 1 / sigma_pix^2 of 35 / 55 uK-arcmin white noise
    (sims.MapsLenNlevLib.ninv_t/ninv_p) times the mask."""
    from plancklens_tpu_torch.ops.sht import gl_geometry
    geom = gl_geometry(lmax)
    z = np.cos(geom.theta)[:, None]
    phi = (2. * np.pi * np.arange(geom.nphi) / geom.nphi)[None, :]
    mask = (np.abs(z) > 0.15).astype(float) * np.ones((geom.nrings, geom.nphi))
    for zc, pc, r in ((0.6, 1.0, 0.05), (-0.5, 4.0, 0.04), (0.3, 2.5, 0.03)):
        mask *= ((z - zc) ** 2 + (np.cos(phi) - np.cos(pc)) ** 2 * (1 - z ** 2)
                 + (np.sin(phi) - np.sin(pc)) ** 2 * (1 - z ** 2) > r ** 2)
    ls = np.arange(lmax + 1)
    sigma2 = (5. / 60. / 180. * np.pi / np.sqrt(8. * np.log(2.))) ** 2
    transf = np.exp(-0.5 * ls * (ls + 1) * sigma2)
    omega = np.outer(geom.weight, np.full(geom.nphi, 2. * np.pi / geom.nphi))
    ninv = {f: omega / (nlev / 60. / 180. * np.pi) ** 2 * mask
            for f, nlev in (('t', 35.), ('p', 55.))}
    return geom, transf, ninv


def true_rel(cinv, b, x, ms):
    """Relative residual |b - A x| / |b| of each row, recomputed (not the recurred one)."""
    from plancklens_tpu_torch.ops import cg
    w = cg._weights(ms, b.device)
    r = (b - cinv.fwd_op(x)).reshape(b.shape[0], -1)
    bf = b.reshape(b.shape[0], -1)
    return torch.sqrt(cg._dot(r, r, w) / cg._dot(bf, bf, w))


def trace_iterations(cinv, maps, n):
    """Where n warm CG iterations of `cinv` on `maps` spend the card's time: a torch.profiler
    trace of cg.pcg run for exactly n iterations (eps 0) after the right-hand side, read by
    profile_qlms_torch.summarize (busy and idle share, seconds by kernel group, top device
    rows). The traced window holds the n iterations and the initial residual's apply."""
    import tempfile
    from torch.profiler import profile, ProfilerActivity, record_function
    from profile_qlms_torch import summarize
    from plancklens_tpu_torch.ops import cg
    b = cinv.calc_prep(maps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function('cinv_iterations'):
            cg.pcg(cinv.fwd_op, cinv.pre_op, b, torch.zeros_like(b), n, 0., cinv._ms)
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tdir:
        fn = os.path.join(tdir, 'trace.json')
        prof.export_chrome_trace(fn)
        with open(fn) as f:
            events = json.load(f)['traceEvents']
    return summarize(events, window='cinv_iterations')


def fma_k1(records):
    """f64 K1 calls among tracer records whose span does not name the MMA design."""
    return sum(1 for r in records if r['attrs'].get('kernel') == 'K1' and r['attrs']['f64']
               and not r['attrs']['mma'])


def masked_path(par, device, lmax, dense_t=64, dense_p=32, f32=False, dense_cacher=None,
                log=print):
    """Run the masked filters at lmax on `device` (see the module docstring) and return a
    dict of their outputs and numbers. The tracer is on during each counted step, and its
    kernel calls (`calls`) are those of the step's records. On a CUDA device, 10 warm T
    iterations are also traced (`trace_iterations`). The T and E/B dense blocks go to
    `dense_cacher` (a fresh cacher_mem by default), whose keys
    params/anisofilt_example_torch.py's filters share."""
    import run_qlms_torch as drv
    from plancklens_tpu_torch import DATAPATH
    from plancklens_tpu_torch.utils import camb_clfile
    from plancklens_tpu_torch.utils.cachers import cacher_mem
    from plancklens_tpu_torch.ops.sht import core, legendre_kernels as lk
    from plancklens_tpu_torch.models import cinv as pcinv
    from plancklens_tpu_torch.models.sims import AlmMapLib
    from plancklens_tpu_torch.models.filt import IVFFtl
    from plancklens_tpu_torch.models.qest import QELib
    device = torch.device(device)
    cuda = device.type == 'cuda'

    def peak():
        return torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else float('nan')

    def fresh():
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    cl_len = camb_clfile(os.path.join(DATAPATH, 'cls', 'FFP10_wdipole_lensedCls.dat'))
    geom, transf, ninv = aniso_inputs(lmax)
    maps = AlmMapLib(par.sims, geom, lmax, device=device)
    out = {'lmax': lmax, 'grid': (geom.nrings, geom.nphi)}

    # ---- T: host dense block, then one lockstep solve of BATCH_T maps
    dense_cache = cacher_mem() if dense_cacher is None else dense_cacher
    t0 = time.perf_counter()
    cinv_t = pcinv.CinvT(lmax, geom, cl_len, transf, ninv['t'], eps_min=1e-5,
                         lmax_dense=dense_t, dense_cacher=dense_cache, device=device)
    out['t_setup_s'] = time.perf_counter() - t0
    tmaps = torch.stack([maps.get_sim_tmap(i) for i in range(BATCH_T)])
    fresh()
    with core.counting() as c, drv.StageTimer(device) as tm:
        x, it, rel = cinv_t.solve_wf(tmaps)
    out['t'] = dict(it=it, s=tm.seconds, s_it=tm.seconds / max(it, 1),
                    rel=rel.cpu().numpy(), peak_gib=peak(), calls=c.calls,
                    fma_k1=fma_k1(c.records))
    out['t']['true_rel'] = true_rel(cinv_t, cinv_t.calc_prep(tmaps), x,
                                    cinv_t._ms).cpu().numpy()
    out['t_x'] = x
    log('T: setup (host dense block to l %d) %.2fs; batch %d f64: %d iterations, %.3fs, '
        '%.4f s/iteration, peak %.2f GiB; rel resid %s (recomputed %s); kernel calls %s'
        % (dense_t, out['t_setup_s'], BATCH_T, it, tm.seconds, out['t']['s_it'],
           out['t']['peak_gib'], np.array2string(out['t']['rel'], precision=3),
           np.array2string(out['t']['true_rel'], precision=3),
           dict(sorted(out['t']['calls'].items()))))
    if cuda:
        tr = out['t_trace'] = trace_iterations(cinv_t, tmaps, 10)
        log('T, 10 warm iterations traced: window %.3fs, device busy %.3fs (idle share %.4f); '
            'by group %s; top rows %s'
            % (tr['window_s'], tr['device_busy_s'], tr['idle_share'],
               ', '.join('%s %.4fs (%d)' % (k, v['s'], v['calls'])
                         for k, v in tr['groups'].items()),
               '; '.join('%s %.4fs x %d' % (r['name'][:60], r['s'], r['calls'])
                         for r in tr['rows'][:8])))
    if f32:
        cinv32 = pcinv.CinvT(lmax, geom, cl_len, transf, ninv['t'], eps_min=1e-5,
                             lmax_dense=dense_t, dense_cacher=dense_cache,
                             dtype=torch.float32, device=device)
        fresh()
        with drv.StageTimer(device) as tm:
            x32, it32, rel32 = cinv32.solve_wf(tmaps)
        out['t32'] = dict(it=it32, s=tm.seconds, rel=rel32.cpu().numpy())
        log('T f32 (not checked): %d iterations, %.3fs, rel resid %s'
            % (it32, tm.seconds, np.array2string(out['t32']['rel'], precision=3)))
        del cinv32, x32
    del tmaps, x

    # ---- P: the coupled E/B dense block probed on the device, then a BATCH_P solve
    fresh()
    t0 = time.perf_counter()
    with core.counting() as c:
        cinv_p = pcinv.CinvP(lmax, geom, cl_len, transf, ninv['p'], eps_min=1e-5,
                             lmax_dense=dense_p, dense_cacher=dense_cache, device=device)
    if cuda:
        torch.cuda.synchronize()
    chunk = pcinv.probe_chunk(geom, lmax, 2, torch.float64)
    probe = c.calls
    # K2's plan of the probe's last call, from the shape its span recorded
    a = next((r['attrs'] for r in reversed(c.records) if r['attrs'].get('kernel') == 'K2'),
             None)
    plan = None if a is None else lk.plan_pair(a['nrings'], a['M'], a['B'],
                                               lk.pair_mode(a['spin'], a['two']))
    out['p_probe'] = dict(s=time.perf_counter() - t0, chunk=chunk, peak_gib=peak(),
                          k2_plan=None if plan is None else plan._asdict(), calls=probe,
                          fma_k1=fma_k1(c.records))
    log('P: probe of the E/B block to l %d (%d basis vectors) %.2fs in chunks of %d, peak '
        '%.2f GiB, K2 in clusters of %s blocks (no workspace); kernel calls %s'
        % (dense_p, 2 * (dense_p + 1) ** 2, out['p_probe']['s'], chunk,
           out['p_probe']['peak_gib'], None if plan is None else plan.cluster,
           dict(sorted(probe.items()))))
    qu = [maps.get_sim_pmap(i) for i in range(BATCH_P)]
    qmaps, umaps = torch.stack([a for a, _ in qu]), torch.stack([b for _, b in qu])
    del qu
    fresh()
    with core.counting() as c, drv.StageTimer(device) as tm:
        x, it, rel = cinv_p.solve_wf(qmaps, umaps)
    out['p'] = dict(it=it, s=tm.seconds, s_it=tm.seconds / max(it, 1),
                    rel=rel.cpu().numpy(), peak_gib=peak(), calls=c.calls,
                    fma_k1=fma_k1(c.records))
    log('P: batch %d f64: %d iterations, %.3fs, %.4f s/iteration, peak %.2f GiB; rel resid '
        '%s; kernel calls %s'
        % (BATCH_P, it, tm.seconds, out['p']['s_it'], out['p']['peak_gib'],
           np.array2string(out['p']['rel'], precision=3),
           dict(sorted(out['p']['calls'].items()))))
    out['p_x'] = x
    del qmaps, umaps, x

    # ---- the route: IVFCinv (one sim at a time) -> IVFFtl -> QELib
    fl = (np.arange(lmax + 1) >= lmax // 20) * 1.
    ivfs = IVFFtl(pcinv.IVFCinv(cinv_t, cinv_p, maps, cl_len), fl, fl, fl)
    qlib = QELib(ivfs, ivfs, par.cl_len, lmax, lmax, dtype=par.QE_DTYPE, device=device)
    fresh()
    with core.counting() as c, drv.StageTimer(device) as tm:
        qlms = {k: torch.stack([qlib.get_sim_qlm(k, i) for i in ROUTE_SIMS])
                for k in ('ptt', 'p_p')}
    out['route'] = dict(s=tm.seconds, sims=list(ROUTE_SIMS), peak_gib=peak(), calls=c.calls,
                        fma_k1=fma_k1(c.records))
    out['route_qlms'] = qlms
    log('route IVFCinv -> IVFFtl(l >= %d) -> QELib ptt, p_p (%s) on sims %s: %.3fs, peak '
        '%.2f GiB; kernel calls %s'
        % (lmax // 20, par.QE_DTYPE, list(ROUTE_SIMS), tm.seconds, out['route']['peak_gib'],
           dict(sorted(out['route']['calls'].items()))))
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--lmax', type=int, default=2048)
    p.add_argument('--device', default='cuda')
    p.add_argument('--f32', action='store_true', help='also run the f32 CinvT solve')
    args = p.parse_args()
    os.environ.update(PLK_LMAX_IVF=str(args.lmax), PLK_LMAX_QLM=str(args.lmax), PLK_NSIMS='8',
                      PLK_DEVICE=args.device)
    import run_qlms_torch as drv
    par = drv.load_parfile(os.path.join(_REPO, 'params', 'idealized_example_torch.py'),
                           torch.device(args.device))
    res = masked_path(par, args.device, args.lmax, f32=args.f32)

    def plain(v):
        if isinstance(v, dict):
            return {str(k): plain(w) for k, w in v.items() if not isinstance(w, torch.Tensor)
                    and not (isinstance(w, dict) and any(isinstance(u, torch.Tensor)
                                                         for u in w.values()))}
        if isinstance(v, np.ndarray):
            return v.tolist()
        return v
    print(json.dumps(plain(res)))


if __name__ == '__main__':
    main()
