#!/usr/bin/env python
r"""Debiased lensing band-powers of the port's masked chain (the twin of
examples/bandpowers_demo.py): lensed masked sims -> CG filtering -> QE spectra with
dd/ds/ss legs -> RDN0 / MCN0 / N1 debiasing -> binned band-powers.

    PLK_DEVICE=cpu python examples/bandpowers_demo_torch.py    # lmax 32, 5 sims, the CPU
    python examples/bandpowers_demo_torch.py --device cuda      # the same on the card
    PLK_ANISO_LMAX=2048 PLK_ANISO_NSIMS=10 python examples/bandpowers_demo_torch.py

At the shrunk size the band-powers are reconstruction-noise dominated and very noisy.
The module also holds the three steps of chip_smoke.py phase 8:

  n1_card_vs_cpu   the N1 quadrature (ops/n1kern) on the device against the CPU: n1L_batch
                   for (ptt, ptt), (pee, peb), (xtt, xtt) and n1L_jtp_batch on three
                   primed-field combinations (one with a shorter leg) at lmax 120, dL 20,
                   then three knots of (ptt, ptt) at the parameter file's configuration;
  n1_full          Binner.get_n1 of each key at the parameter file's configuration: every
                   fundamental key-pair curve timed (CUDA events on a card), the peak
                   memory, and the binned |N1| against the fiducial band-powers;
  bandpower_chain  the parameter file on its sims (data -1 and 0..nsims-1) through
                   filtering, the QEs of the keys and of stt on the dd/ds/ss legs, their
                   spectra, the responses, the semi-analytic N0, N1 and every Binner output,
                   each stage timed, with the checks the phase reads (finite outputs, the
                   debiased data band-powers against a bound reckoned from get_mcn0_cov,
                   RDN0/MCN0 and the data's semi-analytic N0/MCN0 per bin, the amplitude of
                   the cross with the input phi).

  forecasts        ops/lensed_cls of FFP10's unlensed spectra (input to l 4000, output
                   to 1600) and models/n0s.get_N0 at the parfile's noise and beam (35 / 55
                   uK-arcmin, 5', l 102-2048) on the device against the CPU
                   (`n0_card_vs_cpu`: with the CPU's own change of N0 under 1e-15
                   changes of its input spectra, and the device's N0 from spectra
                   rounded to f32), and the device's lensed spectra against
                   FFP10_wdipole_lensedCls.dat.

`load_aniso` loads params/anisofilt_example_torch.py at a size; each step returns a dict
of its outputs and numbers, and `log` receives one line per step.
"""
import argparse
import os
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (_REPO, os.path.join(_REPO, 'examples')):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch

AMPL_LMAX = 900          # amplitude and N1 checks over bins with upper edge <= this
# the debiased data band-powers dat - rdn0 - n1 against fid: within K sigma_b + F |fid|,
# sigma_b from get_mcn0_cov over mc_sims_var (the reckoning is in PERF.md, section 6)
BP_BOUND = (5., 0.3)
RDN0_BAND = (0.85, 1.15)   # RDN0 / MCN0 per bin
NHL_BAND = (0.6, 1.25)     # the data's semi-analytic N0 / MCN0 per bin
AMPL_BAND = (0.7, 1.3)     # get_ampl_x_input's mean, bins with L <= AMPL_LMAX
# lensed spectra against FFP10_wdipole_lensedCls.dat (tests/test_lensed_cls.py's bounds):
# (spectrum, l range, bound of |ratio - 1|; TE: of |dTE| / sqrt(TT EE))
LENSED_BOUNDS = (('tt', (100, 1600), 1e-3), ('ee', (100, 1600), 1e-3),
                 ('bb', (100, 799), 5e-4), ('bb', (800, 1600), 2e-3),
                 ('te', (100, 1600), 1e-3))
# get_N0 on the device against the CPU, per L over 10 <= L <= lmax: N0_FLOOR_X times the
# largest change of the CPU path under N0_DRAWS 1e-15 changes of its spectra (PERF.md
# section 6, ROADMAP fault 3.9)
N0_FLOOR_X, N0_DRAWS = 10., 4


def _sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def _rel(a, ref):
    a, ref = np.asarray(a, dtype=float), np.asarray(ref, dtype=float)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def load_aniso(device, lmax, nsims, dense_cacher=None):
    """params/anisofilt_example_torch.py at PLK_ANISO_LMAX=lmax, PLK_ANISO_NSIMS=nsims on
    `device` (no persistent cache); returns (module, seconds)."""
    import run_qlms_torch as drv
    os.environ.update(PLK_ANISO_LMAX=str(lmax), PLK_ANISO_NSIMS=str(nsims))
    os.environ.pop('PLK_CACHE_DIR', None)
    t0 = time.perf_counter()
    inject = {} if dense_cacher is None else {'dense_cacher': dense_cacher}
    par = drv.load_parfile(os.path.join(_REPO, 'params', 'anisofilt_example_torch.py'),
                           device, **inject)
    return par, time.perf_counter() - t0


def btype_for(lmax):
    """Planck 2018's agr2 bins (upper edge 2048) where they fit, else three bins."""
    return 'agr2' if lmax >= 2048 else '%d_%d_%d' % (max(2, lmax // 8), lmax // 2, lmax)


def _n1_config(par):
    """The N1 inputs of the parameter file: spectra, source spectrum, filters, lmin."""
    from plancklens_tpu_torch.models.bandpowers import _load_fid_clpp
    fls = [par.ivfs.get_ftl(), par.ivfs.get_fel(), par.ivfs.get_fbl()]
    lmin = int(np.min([np.min(np.where(np.abs(f) > 0.)[0], initial=len(f))
                       for f in fls])) + 1
    n1 = par.n1_dd
    return dict(cls=(n1.cltt, n1.clte, n1.clee), clpp=_load_fid_clpp(), fls=fls,
                lmin=max(lmin, 1), dL=n1.dL, lps=n1.lps)


def n1_card_vs_cpu(device, par, log=print):
    """ops/n1kern on `device` against the CPU (module docstring)."""
    from plancklens_tpu_torch.ops import n1kern
    cpu = torch.device('cpu')
    rng = np.random.RandomState(0)
    lmax, dL = 120, 20
    cl = np.abs(rng.standard_normal(lmax)) + .1
    clte = rng.standard_normal(lmax) * .1
    f = 1. / (np.abs(rng.standard_normal(lmax)) + .5)
    lps = np.array([1, 10, 30, 60, 120])
    Ls = np.array([2., 10., 40., 80., 110., 120.])
    out = {'small': {}}
    for kA, kB in (('ptt', 'ptt'), ('pee', 'peb'), ('xtt', 'xtt')):
        args = (Ls, kA, kB, 'p', cl, cl, clte, cl, cl, clte, cl, f, f, f, f, f, f, 2, 2, dL,
                lps)
        a = n1kern.n1L_batch(*args, device=device)
        b = n1kern.n1L_batch(*args, device=cpu)
        out['small'][kA + '_' + kB] = _rel(a, b)
    combos = []
    for i, fields in enumerate(('ttee', 'tetb', 'ebte')):
        n = lmax if i != 1 else lmax - 30           # one combination with a shorter leg
        combos.append((fields,) + tuple(1. / (np.abs(rng.standard_normal(n if j < 2 else lmax))
                                              + .5) for j in range(4)))
    jargs = (Ls, 'ptt', 'ptt', combos, 'p', cl, cl, clte, cl, cl, clte, cl, 1, 1, dL, lps)
    a = n1kern.n1L_jtp_batch(*jargs, device=device)
    b = n1kern.n1L_jtp_batch(*jargs, device=cpu)
    out['small']['jtp'] = max(_rel(x, y) for x, y in zip(a, b))
    # three knots of (ptt, ptt) at the parameter file's configuration
    c = _n1_config(par)
    lq = par.lmax_qlm
    knots = [L for L in (10, 500, 2000) if L <= lq] if lq >= 2000 else [lq // 3, lq // 2, lq]
    fargs = (np.array(knots, dtype=float), 'ptt', 'ptt', 'p', c['clpp'], *c['cls'], *c['cls'],
             *c['fls'], *c['fls'], c['lmin'], c['lmin'], c['dL'], c['lps'])
    t0 = time.perf_counter()
    a = n1kern.n1L_batch(*fargs, device=device)
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = n1kern.n1L_batch(*fargs, device=cpu)
    t_cpu = time.perf_counter() - t0
    out.update(full=_rel(a, b), knots=knots, full_values=a, full_dev_s=t_dev, full_cpu_s=t_cpu)
    log('(8a) N1 on %s vs the CPU, lmax %d, dL %d: %s; at the parfile configuration (lmax '
        '%d, lmin %d, dL %d, %d source knots to %d), (ptt, ptt) at L = %s: %s, %.2e of max '
        '(%.2fs on the device, %.2fs on the CPU)'
        % (device, lmax, dL, ', '.join('%s %.2e' % kv for kv in out['small'].items()),
           lq, c['lmin'], c['dL'], len(c['lps']), c['lps'][-1], knots,
           np.array2string(a, precision=6), out['full'], t_dev, t_cpu))
    return out


def _fundamental_pairs(key):
    """The canonical fundamental key pairs N1Lib.get_n1(key, kB=key) evaluates."""
    from plancklens_tpu_torch.models.n1 import _get_est_derived, estimator_keys
    if key in estimator_keys:
        return [(key, key)]
    ks = [k for k, _ in _get_est_derived(key, 1)]
    return sorted({(max(a, b), min(a, b)) for a in ks for b in ks})


def _timed(device, fn):
    from run_qlms_torch import StageTimer
    with StageTimer(device) as t:
        r = fn()
    return r, t.seconds


def n1_full(par, keys=('ptt', 'p_p'), log=print):
    """Binner.get_n1 of each key at the parameter file's configuration (module docstring)."""
    from plancklens_tpu_torch.models.bandpowers import Binner, _load_fid_clpp
    device = par.DEVICE
    cuda = device.type == 'cuda'
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ivfs, lq = par.ivfs, par.lmax_qlm
    clpp = _load_fid_clpp()
    fls = (ivfs.get_ftl(), ivfs.get_fel(), ivfs.get_fbl())
    curves, binned, fid = {}, {}, {}
    for key in keys:
        for kA, kB in _fundamental_pairs(key):
            # fills n1_dd's cache under the reference's names; Binner.get_n1 reads it back
            _, curves[kA, kB] = _timed(device, lambda: par.n1_dd.get_n1(
                kA, 'p', clpp, *fls, lq, kB=kB))
        b = Binner(key, key, par, btype_for(lq), lmaxphi=lq)
        binned[key], fid[key] = b.get_n1(), b.get_fid_bandpowers()
        upper = b.bin_lmaxs
    out = {'curves_s': curves, 'binned': binned, 'fid': fid,
           'peak_gib': torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else float('nan'),
           'finite': all(np.all(np.isfinite(par.n1_dd.cacher.load(fn)))
                         for fn in par.n1_dd.cacher._cache),
           'low_bins': upper <= AMPL_LMAX}
    out['ratio'] = {k: np.abs(binned[k]) / fid[k] for k in keys}
    log('(8b) N1 at lmax %d (dL %d, %d source knots to %d, %d output knots): seconds per '
        'fundamental curve %s; peak %.2f GiB; all finite %s'
        % (lq, par.n1_dd.dL, len(par.n1_dd.lps), par.n1_dd.lps[-1],
           len(par.n1_dd._ls_grid(lq)),
           ', '.join('%s x %s %.3fs' % (a, b, s) for (a, b), s in curves.items()),
           out['peak_gib'], out['finite']))
    for k in keys:
        log('(8b) %s: binned N1 / fiducial band-power, %s bins: %s'
            % (k, btype_for(lq), np.array2string(out['ratio'][k], precision=4)))
    return out


def bandpower_chain(par, keys=('ptt', 'p_p'), setup_s=None, log=print):
    """The parameter file's band-powers on its sims (module docstring)."""
    import run_qlms_torch as drv
    from plancklens_tpu_torch.models.bandpowers import Binner
    device = par.DEVICE
    cuda = device.type == 'cuda'
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    nsims, lq = par.nsims, par.lmax_qlm
    sims = list(range(nsims))
    var, bias = [int(i) for i in par.mc_sims_var], [int(i) for i in par.mc_sims_bias]
    qkeys = list(keys) + ['stt']
    secs = {'setup': setup_s}
    (t, e, b), secs['filt'] = drv.stage_filt(par, [-1] + sims)
    finite = all(bool(torch.isfinite(x).all()) for x in (t, e, b))
    del t, e, b

    def qe():
        for k in qkeys:
            par.qlms_dd.get_sim_qlm_batch(k, [-1] + sims)
            par.qlms_ds.get_sim_qlm_batch(k, sims)
            par.qlms_ss.get_sim_qlm_batch(k, sims)
    _, secs['qe'] = _timed(device, qe)

    def qcl():
        out = []
        for k in qkeys:
            out.append(par.qcls_dd.get_sim_qcl_batch(k, var))
            out.append(par.qcls_dd.get_sim_qcl(k, -1))
            for lib in (par.qcls_ds, par.qcls_ss):
                out.append(lib.get_sim_qcl_batch(k, sorted(set(var + bias))))
        return out
    spectra, secs['qcl'] = _timed(device, qcl)
    resp, secs['responses'] = _timed(device, lambda: [par.qresp_dd.get_response(k, 'p')
                                                      for k in qkeys])
    nhls, secs['nhl'] = _timed(device, lambda: [par.nhl_dd.get_sim_nhl(i, k, k)
                                                for k in keys for i in [-1] + var])
    finite = finite and all(np.all(np.isfinite(x)) for x in spectra + resp + nhls)

    from plancklens_tpu_torch.models.bandpowers import _load_fid_clpp
    ivfs = par.ivfs
    fls = (ivfs.get_ftl(), ivfs.get_fel(), ivfs.get_fbl())
    n1s, secs['n1'] = _timed(device, lambda: [
        par.n1_dd.get_n1(k, 'p', _load_fid_clpp(), *fls, lq) for k in qkeys])
    finite = finite and all(np.all(np.isfinite(x)) for x in n1s)

    lmin_s4, lmax_s4 = min(100, lq // 4), min(2048, lq)
    bt = btype_for(lq)

    def binner():
        res = {}
        for k in keys:
            bn = Binner(k, k, par, bt, lmaxphi=lq)
            r = res[k] = {'fid': bn.get_fid_bandpowers(), 'dat': bn.get_dat_bandpowers(),
                          'mcn0': bn.get_mcn0(), 'rdn0': bn.get_rdn0(),
                          'dat_nhl': bn.get_dat_nhl(), 'n1': bn.get_n1(),
                          'ps_data': bn.get_ps_data(lmin_ss_s4=lmin_s4, lmax_ss_s4=lmax_s4),
                          'ps_corr': bn.get_ps_corr(lmin_ss_s4=lmin_s4, lmax_ss_s4=lmax_s4),
                          'bamc': bn.get_bamc(), 'bmmc': bn.get_bmmc(),
                          'nhl_cov': bn.get_nhl_cov(), 'mcn0_cov': bn.get_mcn0_cov()}
            x = bn.get_ampl_x_input()
            r['ampl'], r['ampl_sig'] = x.mean(), x.sigmas_on_mean()
            r['lmaxs'] = bn.bin_lmaxs
        return res
    res, secs['binner'] = _timed(device, binner)
    for r in res.values():
        vals = [r[n] for n in ('fid', 'dat', 'mcn0', 'rdn0', 'dat_nhl', 'n1', 'ps_corr', 'bmmc',
                               'nhl_cov', 'mcn0_cov', 'ampl')]
        vals += list(r['bamc']) + [np.asarray(v, dtype=float) for v in r['ps_data']]
        finite = finite and all(np.all(np.isfinite(v)) for v in vals)
        r['bp'] = r['dat'] - r['rdn0'] - r['n1']
        sig = np.sqrt(np.diag(r['mcn0_cov']))
        nsig, floor = BP_BOUND
        r['bp_bound'] = nsig * sig + floor * np.abs(r['fid'])
        r['bp_dev'] = np.abs(r['bp'] - r['fid'])
        r['rdn0_ratio'] = r['rdn0'] / r['mcn0']
        r['nhl_ratio'] = r['dat_nhl'] / r['mcn0']
        r['low'] = r['lmaxs'] <= AMPL_LMAX
    out = {'seconds': secs, 'finite': finite, 'bins': bt, 'nsims': nsims, 'var': var,
           'bias': bias, 'res': res,
           'peak_gib': torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else float('nan')}
    log('(8c) anisofilt_example_torch.py at lmax %d, %d sims (data -1, mc_sims_bias %s, '
        'mc_sims_var %s), keys %s + stt, %s bins: %s; peak %.2f GiB; all finite %s'
        % (lq, nsims, bias, var, '/'.join(keys), bt,
           ', '.join('%s %.3fs' % (k, v) for k, v in secs.items() if v is not None),
           out['peak_gib'], finite))
    p = lambda v: np.array2string(np.asarray(v), precision=4, max_line_width=200)
    for k, r in res.items():
        log('(8c) %s: fid %s' % (k, p(r['fid'])))
        # where bound / |fid| >= 1 the bound would pass a band-power of zero: those bins
        # cannot see a wrong debias
        log('(8c) %s: (dat - rdn0 - n1) / fid %s; |dat - rdn0 - n1 - fid| / bound %s; '
            'bound / |fid| %s' % (k, p(r['bp'] / r['fid']), p(r['bp_dev'] / r['bp_bound']),
                                  p(r['bp_bound'] / np.abs(r['fid']))))
        log('(8c) %s: rdn0 / mcn0 %s; dat_nhl / mcn0 %s; n1 / fid %s'
            % (k, p(r['rdn0_ratio']), p(r['nhl_ratio']), p(r['n1'] / r['fid'])))
        log('(8c) %s: <q x phi_in> amplitude %s (+- %s); bmmc %s; bamc / fid %s'
            % (k, p(r['ampl']), p(r['ampl_sig']), p(r['bmmc']), p(r['bamc'][0] / r['fid'])))
    return out


def n0_gaps(a, b, lmax, lmin=10):
    """(|1/a - 1/b| over max |1/b|, max |a/b - 1| over lmin <= L <= lmax). N0 = N / R^2 is
    ill-conditioned where the response R_L is small (as 1/L^2 at low L, and a curl key
    towards 2 lmax), so the first holds the inverse-noise weight everywhere and the
    second N0 itself inside the CMB band (inf where a and b differ in finiteness)."""
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    if not np.array_equal(np.isfinite(a), np.isfinite(b)):
        return np.inf, np.inf
    ok = np.isfinite(b) & (b != 0.)
    band = ok.copy()
    band[:lmin] = False
    band[lmax + 1:] = False
    return _rel(1. / a[ok], 1. / b[ok]), float(np.max(np.abs(a[band] / b[band] - 1.)))


def forecasts(device, log=print):
    """lensed_cls and get_N0 on `device` against the CPU (module docstring)."""
    from plancklens_tpu_torch import DATAPATH
    from plancklens_tpu_torch.utils import camb_clfile
    from plancklens_tpu_torch.ops.lensed_cls import lensed_cls
    cpu = torch.device('cpu')
    cls = lambda name, lmax: camb_clfile(os.path.join(DATAPATH, 'cls', 'FFP10_wdipole_%s.dat'
                                                      % name), lmax=lmax)
    unl, target = cls('lenspotentialCls', 4000), cls('lensedCls', 1600)
    out, secs = {}, {}
    for name, d in (('dev', device), ('cpu', cpu)):
        t0 = time.perf_counter()
        out[name] = lensed_cls(unl, unl['pp'], lmax_out=1600, nterms=2, device=d)
        _sync(d)
        secs['lensed_' + name] = time.perf_counter() - t0
    # BB is half the difference of two EE-sized analyses: held to EE's scale
    lens_gap = {k: float(np.abs(out['dev'][k] - out['cpu'][k]).max()
                         / np.abs(out['cpu']['ee' if k == 'bb' else k]).max())
                for k in ('tt', 'ee', 'bb', 'te')}
    vs_ffp10 = []
    for k, (lo, hi), bound in LENSED_BOUNDS:
        sl = slice(lo, hi + 1)
        if k == 'te':
            dev_k = np.abs(out['dev']['te'][sl] - target['te'][sl]) \
                / np.sqrt(target['tt'][sl] * target['ee'][sl])
        else:
            dev_k = np.abs(out['dev'][k][sl] / target[k][sl] - 1.)
        vs_ffp10.append((k, lo, hi, float(dev_k.max()), bound))
    res = {'lens_gap': lens_gap, 'vs_ffp10': vs_ffp10, 'seconds': secs}
    log('(8d) lensed_cls of FFP10 (input to l 4000, output to 1600) on %s vs the CPU: %s '
        '(BB of max EE); against FFP10_wdipole_lensedCls.dat: %s'
        % (device, ', '.join('%s %.2e' % kv for kv in lens_gap.items()),
           ', '.join('%s %d-%d %.2e (bound %g)' % v for v in vs_ffp10)))
    n0 = n0_card_vs_cpu(device, log=log)
    secs.update(n0.pop('seconds'))
    res.update(n0)
    return res


def n0_limit(floor):
    """The per-L limit of N0 on the device against the CPU: N0_FLOOR_X times the floor
    (the CPU path's own change under a 1e-15 change of its inputs), at least 1e-12."""
    return max(1e-12, N0_FLOOR_X * floor)


def n0_card_vs_cpu(device, lmax=2048, draws=N0_DRAWS, log=print):
    """models/n0s.get_N0 at the parfile's noise and beam (35 / 55 uK-arcmin, 5', l 102 to
    `lmax`) on `device` against the CPU (`n0_gaps`), with
      n0_floor  the largest per-L change of the CPU path under `draws` independent 1e-15
                relative changes of its four input spectra: what the conditioning of
                N0 = N / R^2 makes of rounding, the floor the per-L check scales;
      n0_f32    the per-L gap of the device's N0 from the same spectra rounded to f32,
                against the CPU: a precision fault the per-L check has to see."""
    from plancklens_tpu_torch.models import n0s
    cpu = torch.device('cpu')
    kw = dict(beam_fwhm=5., nlev_t=35., nlev_p=55., lmax_CMB=lmax, lmin_CMB=102,
              lmax_out=lmax)
    names = ('cls_filt', 'cls_len', 'cls_weight', 'cls_sky')
    rng = np.random.RandomState(15)
    fid = n0s._default_cls()
    pert = lambda: {k: v * (1. + 1e-15 * rng.standard_normal(v.shape)) for k, v in fid.items()}
    f32 = {k: v.astype(np.float32).astype(float) for k, v in fid.items()}
    runs = [('dev', device, {}), ('cpu', cpu, {}), ('dev_f32', device, dict.fromkeys(names, f32))]
    runs += [('cpu_perturbed%d' % i, cpu, {n: pert() for n in names}) for i in range(draws)]
    n0, secs = {}, {}
    for name, d, extra in runs:
        t0 = time.perf_counter()
        n0[name] = n0s.get_N0(**kw, **extra, device=d)
        _sync(d)
        secs['n0_' + name] = time.perf_counter() - t0
    gap, floor, f32_gap = {}, {}, {}
    for i, which in ((0, 'grad'), (1, 'curl')):
        for k in n0['cpu'][i]:
            name = '%s %s' % (k, which)
            ref = n0['cpu'][i][k]
            gap[name] = n0_gaps(n0['dev'][i][k], ref, lmax)
            floor[name] = max(n0_gaps(n0['cpu_perturbed%d' % j][i][k], ref, lmax)[1]
                              for j in range(draws))
            f32_gap[name] = n0_gaps(n0['dev_f32'][i][k], ref, lmax)[1]
    log('(8d) get_N0 at 35 / 55 uK-arcmin, 5\', l 102-%d on %s vs the CPU: 1/N0 of max, N0 '
        'over 10 <= L <= %d (limit: %g x the largest of %d CPU changes under a 1e-15 change '
        'of the spectra), and N0 from f32-rounded spectra on %s: %s; seconds %s'
        % (lmax, device, lmax, N0_FLOOR_X, draws, device,
           ', '.join('%s %.2e, %.2e (floor %.2e, limit %.2e; f32 %.2e)'
                     % (k, g[0], g[1], floor[k], n0_limit(floor[k]), f32_gap[k])
                     for k, g in gap.items()),
           ', '.join('%s %.2f' % kv for kv in secs.items())))
    return {'n0_gap': gap, 'n0_floor': floor, 'n0_f32': f32_gap, 'seconds': secs}


def main():
    os.environ.setdefault('PLK_ANISO_LMAX', '32')
    os.environ.setdefault('PLK_ANISO_NSIMS', '5')
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--device', default=os.environ.get('PLK_DEVICE', 'cuda'))
    args = p.parse_args()
    from plancklens_tpu_torch.models.bandpowers import Binner
    t0 = time.time()
    par, _ = load_aniso(args.device, int(os.environ['PLK_ANISO_LMAX']),
                        int(os.environ['PLK_ANISO_NSIMS']))
    print('[%6.1fs] parfile loaded: lmax=%d nsims=%d fsky=%.3f device=%s'
          % (time.time() - t0, par.lmax_ivf, par.nsims, par.mask.mean(), par.DEVICE),
          flush=True)
    lmax = par.lmax_qlm
    btype = '%d_%d_%d' % (max(2, lmax // 8), lmax // 2, lmax)
    binner = Binner('ptt', 'ptt', par, btype, lmaxphi=lmax)
    print('[%6.1fs] binner ready, bins %s' % (time.time() - t0, btype), flush=True)
    dat = np.asarray(binner.get_dat_bandpowers())
    print('[%6.1fs] data band-powers      %s' % (time.time() - t0, dat), flush=True)
    mcn0 = np.asarray(binner.get_mcn0())
    print('[%6.1fs] MCN0                  %s' % (time.time() - t0, mcn0), flush=True)
    rdn0 = np.asarray(binner.get_rdn0())
    print('[%6.1fs] RDN0                  %s' % (time.time() - t0, rdn0), flush=True)
    n1 = np.asarray(binner.get_n1())
    print('[%6.1fs] N1                    %s' % (time.time() - t0, n1), flush=True)
    bp = dat - rdn0 - n1
    print('[%6.1fs] debiased band-powers  %s' % (time.time() - t0, bp), flush=True)
    print('fiducial C_L^kk bins        %s' % np.asarray(binner.fid_bandpowers))


if __name__ == '__main__':
    main()
