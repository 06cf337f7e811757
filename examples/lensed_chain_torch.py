#!/usr/bin/env python
r"""The port's lensed masked chain on one device, in three steps that chip_smoke.py phase 7
calls (7a, 7b, 7c):

    python examples/lensed_chain_torch.py [--lmax 2048] [--nsims 4] [--device cuda]

  card_vs_cpu    Lensing.alm2lenmap / alm2lenmap_spin on 2 sims (the second deflected by
                 a curl potential too) and CMBLenLib.get_sim_tlm / get_sim_eblm, on the
                 device against the CPU plain path on the same unit phases (lmax 64,
                 dlmax 16, f64), with its kernel calls (`core.kernel_calls`);
  lensed_sims    params/anisofilt_example.py's sims (sims.CMBLenLib + MapsLenNlevLib: 5'
                 beam, 35 / 55 uK-arcmin) at lmax with dlmax 128, oversample 4, order 9,
                 f64: the cold host recursion-table builds of their grids, each sim's time
                 split by step with CUDA events (deflection synthesis, positions, ECP
                 synthesis of T and of Q/U, interpolation, map2alm, beam and noise) and its
                 kernel calls by step, the binned lensed TT / EE / BB of the sims against
                 FFP10_wdipole_lensedCls.dat, and on a CUDA device K1 at the ECP and
                 deflection shapes and K2 at the lensed map2alm shape against their plain
                 versions, with their bounds (ops/sht/roofline.pair_bound);
  parfile_chain  params/anisofilt_example_torch.py at lmax with nsims sims through the
                 run_qlms_torch.py stage functions: filt (masked CinvT/CinvP through IVFCinv, a
                 shared dense-block cacher), qe (ptt, p_p), qcl dd (mc_sims_var), responses
                 (qresp_dd), semi-analytic N0 (nhl_dd, one sim) and the cross with the
                 input phi (qlms_x_in), each timed, and the amplitude
                 <q x phi_in> / (R_L C_L^pp fsky) over 30 <= L <= 1000.

Each function returns a dict of its outputs and numbers; `log` receives one line per step.
Lensed maps are compared to tolerances, never bitwise (the deflection's ring assembly folds m
> nphi/2 with index_add_).
"""
import argparse
import json
import os
import sys
import time
from collections import Counter

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (_REPO, os.path.join(_REPO, 'examples')):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch

DLMAX = 128
NLEV_T, NLEV_P, FWHM = 35., 55., 5.
BINS = [(l, l + 100) for l in range(100, 1500, 100)]     # [lo, hi) of the spectrum check
AMPL_L = (30, 1000)


def _cls(name):
    from plancklens_tpu_torch import DATAPATH
    from plancklens_tpu_torch.utils import camb_clfile
    return camb_clfile(os.path.join(DATAPATH, 'cls', 'FFP10_wdipole_%s.dat' % name))


def _rel_max(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def card_vs_cpu(device, lmax=64, dlmax=16, log=print):
    """The lensing and CMBLenLib on `device` against the CPU plain path (module docstring)."""
    from plancklens_tpu_torch import compat
    from plancklens_tpu_torch.ops.sht import core, gl_geometry
    from plancklens_tpu_torch.models.sims import CMBLenLib
    from plancklens_tpu_torch.utils import alm as ualm
    cls = _cls('lenspotentialCls')
    cls['oo'] = 0.1 * cls['pp']
    fields = ('t', 'e', 'b', 'p', 'o')
    lu = lmax + dlmax
    rng = np.random.RandomState(64)
    _, ms = ualm._lm_indices(lu)
    phases = {}
    for i in (0, 1):
        a = (rng.standard_normal((5, len(ms))) + 1j * rng.standard_normal((5, len(ms))))
        a /= np.sqrt(2.)
        a[:, ms == 0] = a[:, ms == 0].real * np.sqrt(2.)
        phases[i] = a
    out = {}
    for which, d in (('dev', torch.device(device)), ('cpu', torch.device('cpu'))):
        lib = CMBLenLib(cls, lmax, gl_geometry(lmax), fields=fields, dlmax=dlmax, device=d,
                        phases=compat.phases_from_numpy(phases))
        alms = torch.stack([lib.unl_lib.get_sim_alms(i) for i in (0, 1)])
        olm = alms[:, 4].clone()
        olm[0] = 0.                                  # sim 0: gradient deflection only
        with core.counting() as c:
            t = lib.lensing.alm2lenmap(alms[:, 0], alms[:, 3], olm=olm)
            q, u = lib.lensing.alm2lenmap_spin((alms[:, 1], alms[:, 2]), alms[:, 3], 2,
                                               olm=olm)
            eb = [lib.get_sim_eblm(i) for i in (0, 1)]
            alm = [lib.get_sim_tlm(i) for i in (0, 1)] + [x for p in eb for x in p]
            _sync(d)
        out[which] = dict(maps=[x.cpu() for x in (t, q, u)], alms=[x.cpu() for x in alm],
                          calls=c.calls)
        if which == 'dev':      # sim 1 without its curl potential: the curl moves the map
            t_grad = lib.lensing.alm2lenmap(alms[1, 0], alms[1, 3])[0]
            curl_moves = _rel_max(t[1], t_grad)
    dev, ref = out['dev'], out['cpu']
    res = {'maps_err': max(_rel_max(a, b) for a, b in zip(dev['maps'], ref['maps'])),
           'alms_err': max(_rel_max(a, b) for a, b in zip(dev['alms'], ref['alms'])),
           'calls': dev['calls'], 'curl_moves': curl_moves}
    log('(7a) lmax %d (dlmax %d), f64, 2 sims (the second with a curl potential, which moves '
        'its lensed T by %.2e of max): lensed T/Q/U on %s vs the CPU plain path %.2e of max, '
        'CMBLenLib tlm/elm/blm %.2e; kernel calls by (kernel, mode, batch, type) %s'
        % (lmax, dlmax, res['curl_moves'], device, res['maps_err'], res['alms_err'],
           dict(sorted(res['calls'].items()))))
    return res


class _Steps:
    """Device seconds (CUDA events; host clock on the CPU) and kernel calls by (kernel,
    mode, batch, data type) of named steps, summed over the calls of each step: the tracer
    is on during a step, and its calls are those of the step's records."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == 'cuda'
        self.pending = []
        self.calls = {}

    def __call__(self, name, fn):
        from plancklens_tpu_torch.ops.sht import core
        with core.counting() as c:
            if self.cuda:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                r = fn()
                e1.record()
                self.pending.append((name, e0, e1))
            else:
                t0 = time.perf_counter()
                r = fn()
                self.pending.append((name, time.perf_counter() - t0, None))
        self.calls.setdefault(name, Counter()).update(c.calls)
        return r

    def seconds(self):
        """{step: seconds} of the calls so far (synchronises the device)."""
        if self.cuda:
            torch.cuda.synchronize()
        out = Counter()
        for name, a, b in self.pending:
            out[name] += a.elapsed_time(b) / 1e3 if self.cuda else a
        self.pending = []
        return dict(out)


def _lensed_sim(lib, maps, i, steps):
    """Sim i of MapsLenNlevLib over CMBLenLib step by step, as the libraries compute it
    (get_sim_tmap, then get_sim_pmap, each with its own deflection): returns the lensed
    (tlm, elm, blm) before beam and noise and the observed (T, Q, U) maps."""
    from plancklens_tpu_torch.utils import alm as ualm
    lens, sht = lib.lensing, lib.sht
    alms = lib.unl_lib.get_sim_alms(i)
    f = lib.unl_lib._field_index
    olm = lib._olm_unl(alms)
    plm = alms[f('p')]

    def positions():
        red, imd = steps('deflection', lambda: lens.deflection(plm, olm))
        return steps('positions', lambda: lens.positions(red, imd))
    thp, php, _ = positions()
    src = steps('ecp_t', lambda: lens.sht_src.alm2map(alms[f('t')][None]))
    tlen = steps('interp', lambda: lens.interp(src, thp, php, 1.))[0]
    del src
    tlm = steps('map2alm', lambda: sht.map2alm(tlen))
    tmap = steps('beam_noise', lambda: sht.alm2map(ualm.almxfl(tlm, lib.lmax, maps.transf))
                 + maps.get_sim_tnoise(i))
    thp, php, gamma = positions()
    q, u = steps('ecp_qu', lambda: lens.sht_src.alm2map_spin(
        (alms[f('e')][None], alms[f('b')][None]), 2))
    plen = steps('interp', lambda: lens.interp(torch.complex(q, u), thp, php, 1.)
                 * torch.exp(-2j * gamma))[0]
    del q, u
    elm, blm = steps('map2alm', lambda: sht.map2alm_spin((plen.real, plen.imag), 2))

    def obs_p():
        qo, uo = sht.alm2map_spin((ualm.almxfl(elm, lib.lmax, maps.transf),
                                   ualm.almxfl(blm, lib.lmax, maps.transf)), 2)
        nq, nu = maps._pnoise(i)
        return qo + nq, uo + nu
    qmap, umap = steps('beam_noise', obs_p)
    return (tlm, elm, blm), (tmap, qmap, umap)


def binned_ratios(cls_sims, cl_theory, lmax):
    """Per bin of BINS: sum_l (2l+1) C^sims_l / sum_l (2l+1) C_l, and the relative standard
    deviation of that ratio for Gaussian fields over len(cls_sims) full-sky sims,
    sqrt(2 sum (2l+1) C_l^2 / nsims) / sum (2l+1) C_l."""
    mean = np.mean(cls_sims, axis=0)
    ratio, sigma = [], []
    for lo, hi in [b for b in BINS if b[1] <= lmax + 1]:
        ls = np.arange(lo, hi)
        w = 2. * ls + 1.
        ct = cl_theory[ls]
        ratio.append(np.sum(w * mean[ls]) / np.sum(w * ct))
        sigma.append(np.sqrt(2. * np.sum(w * ct ** 2) / len(cls_sims)) / np.sum(w * ct))
    return np.array(ratio), np.array(sigma)


# the bound of a bin ratio's distance to 1: K sigma of its Gaussian cosmic variance plus a
# floor for what the sims do not model (the reckoning is in PERF.md: lensed BB's non-Gaussian
# variance, the unlensed band limit lmax + dlmax)
SPECTRA_BOUND = {'tt': (5., 0.01), 'ee': (5., 0.01), 'bb': (15., 0.03)}


def _kernel_row(kind, spin, mode, L, geom, device, batch=1, m_range=None):
    """K1 (kind 'synth') or K2 ('anal') on `geom` at band limit L, f64, `batch` maps, on the
    columns m_range = (m0, m1) (default all; an even m0, with the tables of those columns):
    kernel ms (3 calls after two untimed ones, each output freed before the next call so no
    cudaMalloc lands between the events, as chip_smoke.cuda_ms), plain-version ms (one
    call), max abs / relative difference, whether the first and the last call are bitwise
    equal, and the bound (roofline.pair_bound)."""
    from plancklens_tpu_torch.ops.sht import core, legendre_kernels as lk
    from plancklens_tpu_torch.ops.sht.roofline import pair_bound
    dev = torch.device(device)
    m0, m1 = (0, L + 1) if m_range is None else m_range
    gen = torch.Generator(device=dev).manual_seed(7 + m0)
    t_m, t_p = core.pair_tables(L, m1 - 1, spin, geom.theta, geom.token(), dev, m0)
    R, M = geom.nrings, m1 - m0
    two = mode == 1
    shape = (batch, L + 1, M) if kind == 'synth' else (batch, R, M)
    x = [torch.randn(shape, generator=gen, device=dev, dtype=torch.complex128)
         for _ in range(2)]
    xm = x[1] if two else None
    if kind == 'synth':
        run = lambda: lk.synth_pair(x[0], xm, spin, R, t_m, t_p)
        plain = lambda: core.legendre_synth_pair_plain(x[0], xm, spin, R, t_m, t_p)
    else:
        run = lambda: lk.anal_pair(x[0], xm, spin, L, t_m, t_p)
        plain = lambda: core.legendre_anal_pair_plain(x[0], xm, spin, L, t_m, t_p)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    first = run()
    k = run()
    e0.record()
    for _ in range(3):
        k = None
        k = run()
    e1.record()
    e1.synchronize()
    ms = e0.elapsed_time(e1) / 3
    e0.record()
    p = plain()
    e1.record()
    e1.synchronize()
    pms = e0.elapsed_time(e1)
    err_abs = max(float((a - b).abs().max()) for a, b in zip(k, p) if b is not None)
    err = max(_rel_max(a, b) for a, b in zip(k, p) if b is not None)
    equal = all(torch.equal(a, b) for a, b, c in zip(first, k, p) if c is not None)
    bound_ms, bound_by = pair_bound((t_m,) if mode == 0 else (t_m, t_p), mode, batch, R, True)
    return dict(ms=ms, plain_ms=pms, max_abs_err=err_abs, rel_err=err, equal=equal,
                bound_ms=bound_ms, bound_by=bound_by, rings=R, lmax=L, mode=mode, batch=batch,
                m=(m0, m1))


def lensed_sims(device, lmax=2048, dlmax=DLMAX, sims=(0, 1, 2, 3), log=print):
    """params/anisofilt_example.py's lensed sims at lmax (module docstring)."""
    from plancklens_tpu_torch.ops.sht import core, gl_geometry
    from plancklens_tpu_torch.models.sims import CMBLenLib, MapsLenNlevLib
    from plancklens_tpu_torch.models.n0s import gauss_beam
    from plancklens_tpu_torch.utils import alm as ualm
    device = torch.device(device)
    cuda = device.type == 'cuda'
    geom = gl_geometry(lmax)
    core.TABLES.clear()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    lib = CMBLenLib(_cls('lenspotentialCls'), lmax, geom, seed=0, dlmax=dlmax, device=device)
    maps = MapsLenNlevLib(lib, gauss_beam(FWHM, lmax), NLEV_T, NLEV_P, seed=2000)
    lens, lu = lib.lensing, lib.lmax_unl
    out = {'lmax': lmax, 'dlmax': dlmax, 'ecp': (lens.src.nrings, lens.src.nphi),
           'grid': (geom.nrings, geom.nphi)}
    # the cold host table builds of the grids a lensed sim runs on, one by one
    builds = {}
    for name, L, spin, g in (('deflection (spin 1, GL)', lu, 1, geom),
                             ('ECP spin 0', lu, 0, lens.src), ('ECP spin 2', lu, 2, lens.src),
                             ('GL spin 0', lmax, 0, geom), ('GL spin 2', lmax, 2, geom)):
        t0 = time.perf_counter()
        core.pair_tables(L, L, spin, g.theta, g.token(), device)
        _sync(device)
        builds[name] = time.perf_counter() - t0
    out['table_builds_s'] = builds
    log('(7b) cold host recursion-table builds (north halves of the ECP grid %d x %d and the '
        'GL grid %d x %d): %s' % (lens.src.nrings, lens.src.nphi, geom.nrings, geom.nphi,
                                  ', '.join('%s %.3fs' % kv for kv in builds.items())))
    steps = _Steps(device)
    per_sim, cls = [], {k: [] for k in ('tt', 'ee', 'bb')}
    for n, i in enumerate(sims):
        (tlm, elm, blm), obs = _lensed_sim(lib, maps, i, steps)
        secs = steps.seconds()
        per_sim.append(secs)
        for k, a in (('tt', tlm), ('ee', elm), ('bb', blm)):
            cls[k].append(ualm.alm2cl(a, lmax).cpu().numpy())
        for x in obs:
            if not (tuple(x.shape) == (geom.nrings, geom.nphi) and bool(torch.isfinite(x).all())):
                raise RuntimeError('lensed sim %d: observed maps of shape %s, finite %s'
                                   % (i, tuple(x.shape), bool(torch.isfinite(x).all())))
        if n == 0:
            # the step-by-step sim is the libraries' own: hold it to them
            ref = (maps.get_sim_tmap(i),) + tuple(maps.get_sim_pmap(i))
            out['split_vs_library'] = max(_rel_max(a, b) for a, b in zip(obs, ref))
            del ref
        log('(7b) sim %d: %s; total %.3fs'
            % (i, ', '.join('%s %.4fs' % kv for kv in secs.items()), sum(secs.values())))
        del tlm, elm, blm, obs
    out['per_sim_s'] = per_sim
    out['calls'] = steps.calls
    out['peak_gib'] = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else float('nan')
    cl_len = _cls('lensedCls')
    out['spectra'] = {}
    for k in ('tt', 'ee', 'bb'):
        r, s = binned_ratios(cls[k], cl_len[k], lmax)
        nsig, floor = SPECTRA_BOUND[k]
        out['spectra'][k] = dict(ratio=r, sigma=s, bound=nsig * s + floor)
        log('(7b) lensed %s / FFP10 lensed, %d sims, bins %s: %s (bound %s)'
            % (k.upper(), len(sims), '%d-%d by 100' % (BINS[0][0], BINS[-1][1]),
               np.array2string(r, precision=4), np.array2string(nsig * s + floor, precision=4)))
    log('(7b) step by step vs MapsLenNlevLib.get_sim_tmap/pmap on sim %d: %.2e of max; peak '
        '%.2f GiB; kernel calls of the %d sims by step and (kernel, mode, batch, type): %s'
        % (sims[0], out['split_vs_library'], out['peak_gib'], len(sims),
           '; '.join('%s %s' % (k, dict(sorted(v.items())))
                     for k, v in out['calls'].items() if v)))
    if cuda:
        rows = {'synth_pair_ecp_t': ('synth', 0, 0, lu, lens.src),
                'synth_pair_ecp_qu': ('synth', 2, 1, lu, lens.src),
                'synth_pair_deflection': ('synth', 1, 1, lu, geom),
                'anal_pair_lensed_eb': ('anal', 2, 1, lmax, geom)}
        out['kernels'] = {}
        for name, (kind, spin, mode, L, g) in rows.items():
            row = out['kernels'][name] = _kernel_row(kind, spin, mode, L, g, device)
            log('(7b) %s: %s spin %d mode %d, f64, batch 1, lmax %d, %d rings: %.3f ms (plain '
                '%.1f ms, %.2e of max), bound %.3f ms (%s, %.1f%%)'
                % (name, 'K1' if kind == 'synth' else 'K2', spin, mode, L, row['rings'],
                   row['ms'], row['plain_ms'], row['rel_err'], row['bound_ms'],
                   row['bound_by'], 100. * row['bound_ms'] / row['ms']))
    return out


def parfile_chain(device, lmax=2048, nsims=4, dense_cacher=None, keys=('ptt', 'p_p'),
                  log=print):
    """params/anisofilt_example_torch.py's chain at lmax on nsims sims (module docstring)."""
    import run_qlms_torch as drv
    from plancklens_tpu_torch.ops import wigner
    device = torch.device(device)
    cuda = device.type == 'cuda'
    os.environ.update(PLK_ANISO_LMAX=str(lmax), PLK_ANISO_NSIMS=str(nsims))
    os.environ.pop('PLK_CACHE_DIR', None)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    wigner.clear_cache()
    t0 = time.perf_counter()
    inject = {} if dense_cacher is None else {'dense_cacher': dense_cacher}
    par = drv.load_parfile(os.path.join(_REPO, 'params', 'anisofilt_example_torch.py'),
                           device, **inject)
    out = {'setup_s': time.perf_counter() - t0, 'nsims': nsims}
    idxs = list(range(nsims))
    (t, e, b), out['filt_s'] = drv.stage_filt(par, idxs)
    qlms, out['qe_s'] = drv.stage_qe(par, keys, idxs)
    var = [int(i) for i in par.mc_sims_var]
    with drv.StageTimer(device) as st:
        qcls = {k: par.qcls_dd.get_sim_qcl_batch(k, var) for k in keys}
    out['qcl_s'] = st.seconds
    with drv.StageTimer(device) as st:
        resp = {k: par.qresp_dd.get_response(k, 'p') for k in keys}
    out['resp_s'] = st.seconds
    out['dmat_cache_bytes'] = wigner.cache_bytes()
    nhl, out['nhl_s'] = drv.stage_nhl(par, keys, idxs[0])
    xin, out['xin_s'] = drv.stage_xin(par, keys, idxs)
    out['peak_gib'] = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else float('nan')
    finite = all(bool(torch.isfinite(x).all()) for x in (t, e, b)) \
        and all(bool(torch.isfinite(q).all()) for q in qlms.values()) \
        and all(np.isfinite(v).all() for d in (qcls, resp, nhl, xin) for v in d.values())
    out['finite'] = finite
    fsky = par.qlms_x_in.fsky12
    cpp = par.cl_unl['pp'][:lmax + 1]
    lo, hi = AMPL_L
    ls = np.arange(lo, min(hi, lmax) + 1)
    out['fsky'] = fsky
    out['ampl'] = {k: float(np.mean(xin[k].mean(0)[ls] / (resp[k][ls] * cpp[ls] * fsky)))
                   for k in keys}
    out['shapes'] = {'qlm': {k: tuple(q.shape) for k, q in qlms.items()},
                     'qcl': {k: v.shape for k, v in qcls.items()}}
    log('(7c) anisofilt_example_torch.py at lmax %d, %d sims, keys %s: setup %.2fs, filt '
        '%.3fs, qe %.3fs, qcl dd (sims %s) %.3fs, responses %.3fs (d-matrix cache %.1f MB, '
        'peak %.1f MB), nhl (sim %d) %.3fs, xin %.3fs; peak %.2f GiB; all finite %s'
        % (lmax, nsims, '/'.join(keys), out['setup_s'], out['filt_s'], out['qe_s'], var,
           out['qcl_s'], out['resp_s'], out['dmat_cache_bytes'][0] / 2 ** 20,
           out['dmat_cache_bytes'][1] / 2 ** 20, idxs[0], out['nhl_s'], out['xin_s'],
           out['peak_gib'], finite))
    log('(7c) <q x phi_in> / (R_L C_L^pp fsky), fsky %.4f, mean over %d <= L <= %d: %s'
        % (fsky, lo, ls[-1], ', '.join('%s %.4f' % kv for kv in out['ampl'].items())))
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--lmax', type=int, default=2048)
    p.add_argument('--nsims', type=int, default=4)
    p.add_argument('--device', default='cuda')
    args = p.parse_args()
    res = {'7a': card_vs_cpu(args.device),
           '7b': lensed_sims(args.device, args.lmax, sims=tuple(range(args.nsims))),
           '7c': parfile_chain(args.device, args.lmax, args.nsims)}

    def plain(v):
        if isinstance(v, dict):
            return {str(k): plain(w) for k, w in v.items()}
        if isinstance(v, (list, tuple)):
            return [plain(w) for w in v]
        if isinstance(v, np.ndarray):
            return v.tolist()
        if isinstance(v, torch.Tensor):
            return None
        return v
    print(json.dumps(plain(res)))


if __name__ == '__main__':
    main()
