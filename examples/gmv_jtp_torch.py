#!/usr/bin/env python
r"""Joint T/P filtering and the GMV lensing estimator of the port on one device, in the
steps that chip_smoke.py phase 9 calls (9a-9d):

    python examples/gmv_jtp_torch.py [--lmax 2048] [--device cuda]

  card_vs_cpu   (9a) lmax 64, f64, params/anisofilt_example.py's mask, beam and 35 / 55
                uK-arcmin noise, batch 2: cinv.CinvTP (monopole and dipole marginalised,
                dense block to l 16) on the device against the CPU plain path: the same
                iteration count, the solution within 10x the CPU path's own change under a
                1e-15 change of its maps and inverted dense block, the right-hand side and
                forward op within 1e-12 of max, the dense block probed on the device against
                the CPU's probe; get_fal; filt.IVFJTP's alms and Wiener legs and the GMV 'p'
                qlm on them (injected phases); and (`stage_b_card_vs_cpu`) each of the
                other filters, sims and cinv helpers that runs on the device;
  masked_gmv    (9b, 9c) params/anisofilt_example_torch.py at lmax: its lensed masked sims
                0..nsims-1 filtered by CinvTP.apply_ivf in one lockstep batch (dense block to
                l LMAX_DENSE, probed on the device at band limit LMAX_DENSE), every row's
                residual recurred and recomputed, iterations, seconds, the probe's setup
                seconds, kernel calls by (kernel, mode, batch, type), peak memory; the bar alms
                stored in an IVFCinvJTP cacher under the reference's names, read back through
                IVFCinvJTP -> IVFFtl (l >= lmax/20) -> QELib 'p', crossed with the input phi:
                <q x phi_in> / (R_L^GMV C_L^pp fsky) over 30 <= L <= 1000, R from
                qresp.RespLib on CinvTP.get_fal();
  n0_ratio      (9c) the semi-analytic N0 (N / R^2) of the GMV 'p' on the joint isotropic
                filter against the 'p' of separate T and P filters, at 35 / 55 uK-arcmin
                and 5', cl_weight = cl_len, for 10 <= L <= min(2000, lmax);
  ivfjtp_full   (9d) filt.IVFJTP on nsims Gaussian sims of the lensed spectra (35 / 35 sqrt 2
                uK-arcmin, no beam, as tests/test_gmv_jtp.py builds them): the mean GMV
                spectrum over its semi-analytic N0, 30 <= L <= 1500;
  kernel_rows   K1 and K2 at the joint operator's shapes (spin 0 one input and the spin-2
                pair, f64, batch B, the grid of lmax) against their plain versions, timed,
                with their bounds (ops/sht/roofline.pair_bound).

Each function returns a dict of its outputs and numbers; `log` receives one line per step.
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

NLEV_T, NLEV_P, FWHM = 35., 55., 5.
LMAX_DENSE = 32     # the dense T/E/B block of phase 9b (3267 columns, probed at l <= 32)
SMALL = 64          # 9a's band limit
AMPL_L = (30, 1000)
N0_L = (10, 2000)
SPEC_L = (30, 1500)
SPEC_BOUND = 0.05   # |mean(C_L^qq / N0_L) - 1| over SPEC_L in 9d, set before its first run


def _cls(lmax):
    from plancklens_tpu_torch import DATAPATH
    from plancklens_tpu_torch.utils import camb_clfile
    return camb_clfile(os.path.join(DATAPATH, 'cls', 'FFP10_wdipole_lensedCls.dat'),
                       lmax=lmax)


def _cls_unl(lmax):
    from plancklens_tpu_torch import DATAPATH
    from plancklens_tpu_torch.utils import camb_clfile
    return camb_clfile(os.path.join(DATAPATH, 'cls', 'FFP10_wdipole_lenspotentialCls.dat'),
                       lmax=lmax)


def _rel_max(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def _fresh(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _peak(device):
    if torch.device(device).type == 'cuda':
        return torch.cuda.max_memory_allocated() / 2 ** 30
    return float('nan')


def _sky_maps(geom, lmax, cls, transf, nlev_t, nlev_p, nmaps, rng):
    """nmaps T, Q, U maps (host numpy): correlated T/E and B alms coloured by cls, the
    beam, the geometry's synthesis (on the CPU), white pixel noise of nlev_t / nlev_p."""
    from plancklens_tpu_torch.ops.sht import SHT
    from plancklens_tpu_torch.utils import alm as ualm
    from plancklens_tpu_torch.utils.cls import cli
    ls, ms = ualm._lm_indices(lmax)

    def unit():
        a = rng.standard_normal((nmaps, len(ls))) + 1j * rng.standard_normal((nmaps, len(ls)))
        a[:, ms == 0] = a[:, ms == 0].real * np.sqrt(2.)
        return a / np.sqrt(2.)
    tt, ee, te = cls['tt'][ls], cls['ee'][ls], cls['te'][ls]
    u1, u2 = unit(), unit()
    b = transf[ls]
    tlm = u1 * np.sqrt(tt) * b
    elm = (u1 * te * cli(np.sqrt(tt)) + u2 * np.sqrt(np.maximum(ee - te ** 2 * cli(tt), 0.))) * b
    blm = unit() * np.sqrt(cls['bb'][ls]) * b
    sht = SHT(geom, lmax, device='cpu')
    omega = np.outer(geom.weight, np.full(geom.nphi, 2. * np.pi / geom.nphi))
    sig = 1. / 60. / 180. * np.pi / np.sqrt(omega)
    T = sht.alm2map(torch.as_tensor(tlm)).numpy() \
        + rng.standard_normal((nmaps,) + omega.shape) * sig * nlev_t
    q, u = sht.alm2map_spin((torch.as_tensor(elm), torch.as_tensor(blm)), 2)
    Q = q.numpy() + rng.standard_normal((nmaps,) + omega.shape) * sig * nlev_p
    U = u.numpy() + rng.standard_normal((nmaps,) + omega.shape) * sig * nlev_p
    return T, Q, U


def _perturbed(a, rng):
    return a * (1. + 1e-15 * rng.standard_normal(a.shape))


def _gauss_sims(lmax, seed_cmb, seed_noise, nlev_t, nlev_p, transf, device, phases=None,
                noise_phases=None):
    """CMBUnlLib (t, e, b of the lensed spectra) + MapsNlevLib at lmax on `device`."""
    from plancklens_tpu_torch.models.sims import CMBUnlLib, MapsNlevLib
    cmb = CMBUnlLib(_cls(lmax), lmax, fields=('t', 'e', 'b'), seed=seed_cmb, device=device,
                    phases=phases)
    return MapsNlevLib(cmb, transf, nlev_t, nlev_p, seed=seed_noise, phases=noise_phases)


def gmv_fal(lmax, nlev_t, nlev_p, transf, lmin=2):
    """(cl_len, cls_dat, joint fal, separate fal) at lmax: cls_dat = cl_len + N_l / b_l^2
    (TE kept), the joint fal its 3x3 pseudo-inverse and the separate one the inverses of
    its TT, EE and BB; both zero below lmin."""
    from plancklens_tpu_torch.utils.cls import cl_inverse, cli
    cl_len = _cls(lmax)
    n_t = (nlev_t / 60. / 180. * np.pi) ** 2 * cli(transf[:lmax + 1] ** 2)
    n_p = (nlev_p / 60. / 180. * np.pi) ** 2 * cli(transf[:lmax + 1] ** 2)
    cls_dat = {'tt': cl_len['tt'] + n_t, 'ee': cl_len['ee'] + n_p,
               'bb': cl_len['bb'] + n_p, 'te': np.copy(cl_len['te'])}
    fal_j = cl_inverse(cls_dat)
    fal_s = {k: cli(cls_dat[k]) for k in ('tt', 'ee', 'bb')}
    for fal in (fal_j, fal_s):
        for cl in fal.values():
            cl[:lmin] = 0.
    return cl_len, cls_dat, fal_j, fal_s


def card_vs_cpu(device, lmax=SMALL, log=print):
    """9a (module docstring): the joint filter and IVFJTP on `device` against the CPU."""
    from masked_filter_torch import aniso_inputs, true_rel
    from plancklens_tpu_torch import compat
    from plancklens_tpu_torch.models import cinv as pcinv
    from plancklens_tpu_torch.models.filt import IVFJTP
    from plancklens_tpu_torch.models.qest import QELib
    from plancklens_tpu_torch.ops.sht import core
    from plancklens_tpu_torch.utils import alm as ualm
    from plancklens_tpu_torch.utils.cachers import cacher_mem
    device, cpu = torch.device(device), torch.device('cpu')
    out = {}
    geom, transf, ninv = aniso_inputs(lmax)
    cls = _cls(lmax)
    rng = np.random.RandomState(90)
    maps = _sky_maps(geom, lmax, cls, transf, NLEV_T, NLEV_P, 2, rng)
    ld = lmax // 4

    def filt(d, cacher):
        return pcinv.CinvTP(lmax, geom, cls, transf, ninv['t'], ninv['p'], lmax_dense=ld,
                            marge_monopole=True, marge_dipole=True, dense_cacher=cacher,
                            device=d)
    held = cacher_mem()
    f_cpu = filt(cpu, held)
    with core.counting() as c:
        f_dev = filt(device, held)              # the CPU path's dense block: one system
        (key, minv), = held._cache.items()
        pert = cacher_mem()
        pert.cache(key, 0.5 * (_perturbed(minv, rng) + _perturbed(minv, rng).T))
        f_n = filt(cpu, pert)
        x_d, it_d, rel_d = f_dev.solve_wf(*maps)
        x_c, it_c, rel_c = f_cpu.solve_wf(*maps)
        x_n, it_n, _ = f_n.solve_wf(*[_perturbed(m, rng) for m in maps])
    out['calls'] = c.calls
    out['it'] = (it_d, it_c, it_n)
    out['err'], out['floor'] = _rel_max(x_d.cpu(), x_c), _rel_max(x_n, x_c)
    b_c = f_cpu.calc_prep(*maps)
    out['ops'] = max(_rel_max(f_dev.calc_prep(*maps).cpu(), b_c),
                     _rel_max(f_dev.fwd_op(b_c.to(device)).cpu(), f_cpu.fwd_op(b_c)))
    out['res'] = true_rel(f_cpu, b_c, x_d.cpu(), f_cpu._ms3).numpy()
    out['rel'] = rel_d.cpu().numpy()
    # the dense block probed on the device (K1/K2 at band limit ld on the grid of lmax)
    # against the CPU's probe of the same operator
    probes = []
    for f in (f_dev, f_cpu):
        fwd_ld = f.filt.make_ops(ld, cls, rescal_cl=f.rescal_cl[:ld + 1])[0]
        probes.append(pcinv._probe(fwd_ld, ld, ld, 3, 64, torch.float64, f.device))
    out['probe_err'] = float(np.abs(probes[0] - probes[1]).max() / np.abs(probes[1]).max())
    fal_d, fal_c = f_dev.get_fal(), f_cpu.get_fal()
    out['fal_err'] = max(float(np.abs(fal_d[k] - fal_c[k]).max() / np.abs(fal_c[k]).max())
                         for k in fal_c)
    log('(9a) CinvTP at lmax %d (lmax_dense %d, monopole and dipole marginalised), f64, batch '
        '2, the anisofilt mask, %g / %g uK-arcmin: %d iterations on the device, %d on the '
        'CPU, %d perturbed; right-hand side and forward op %.2e of max from the CPU path\'s; '
        'the device\'s solution has a residual of %s in the CPU system and is %.2e of max from '
        'the CPU solution (limit %.2e = 10x the CPU solution\'s change under a 1e-15 change '
        'of its maps and inverted dense block); the dense block probed on the device %.2e of '
        'max from the CPU\'s; get_fal %.2e; kernel calls %s'
        % (lmax, ld, NLEV_T, NLEV_P, it_d, it_c, it_n, out['ops'],
           np.array2string(out['res'], precision=3), out['err'], 10. * out['floor'],
           out['probe_err'], out['fal_err'], dict(sorted(out['calls'].items()))))
    del f_dev, f_cpu, f_n
    # IVFJTP and the GMV QE on it, injected phases
    cl_len, cls_dat, fal, _ = gmv_fal(lmax, NLEV_T, NLEV_T * np.sqrt(2.), np.ones(lmax + 1))
    nalm = ualm.getsize(lmax)
    ph = {i: rng.standard_normal((3, nalm)) + 1j * rng.standard_normal((3, nalm))
          for i in (0, 1)}
    nph = {i: rng.standard_normal((3, nalm)) + 1j * rng.standard_normal((3, nalm))
           for i in (0, 1)}
    res = {}
    for d in (device, cpu):
        sims = _gauss_sims(lmax, 21, 22, NLEV_T, NLEV_T * np.sqrt(2.), np.ones(lmax + 1), d,
                           phases=compat.phases_from_numpy(ph),
                           noise_phases=compat.phases_from_numpy(nph))
        ivfs = IVFJTP(sims, np.ones(lmax + 1), dict(cl_len, tb=0.1 * cl_len['te']), fal)
        bar = ivfs.get_sim_teblm_batch([0, 1])
        wf = [getattr(ivfs, 'get_sim_%smliklm' % f)(1) for f in 'teb']
        q = QELib(ivfs, ivfs, cl_len, lmax, lmax, device=d).get_sim_qlm_batch('p', [0, 1])
        res[d.type] = [a.cpu() for a in bar] + [a.cpu() for a in wf] + [q.cpu()]
    out['ivfjtp_err'] = max(_rel_max(a, b) for a, b in zip(res[device.type][:6],
                                                           res['cpu'][:6]))
    out['qlm_err'] = _rel_max(res[device.type][6], res['cpu'][6])
    log('(9a) IVFJTP (injected phases, tb Wiener weight) alms and Wiener legs, device vs CPU: '
        '%.2e of max; the GMV \'p\' qlm on them: %.2e of max' % (out['ivfjtp_err'],
                                                                   out['qlm_err']))
    return out


# None: 10x the CPU path's own change under a 1e-15 change of its input (the largest of two
# draws; the masked kappa system amplifies rounding by its condition, ROADMAP fault 3.6)
STAGE_B_LIMITS = {'smooth_map': 1e-12, 'apodize_mask': 1e-12, 'IVFApoSepTP': 1e-12,
                  'IVFFml': 1e-12, 'AlmNlevLib': 1e-12, 'CMBUnlLibFixedPhi': 1e-12,
                  'CMBLenLibFixedPhi': 1e-10, 'CinvKK': None, 'template_uptolmin': 1e-12}


def stage_b_limit(name, errs):
    """The limit of a stage_b_card_vs_cpu line (STAGE_B_LIMITS)."""
    lim = STAGE_B_LIMITS[name]
    return 10. * errs[name + '_floor'] if lim is None else lim


def stage_b_card_vs_cpu(device, lmax=32, log=print):
    """9a's lines for the other filters and sims (module docstring): each module that runs
    on the device, there and on the CPU on the same numpy inputs (injected phases and
    noise), {name: relative max difference} (limits: `stage_b_limit`; CMBLenLibFixedPhi as
    phase 7a's lensing; CinvKK a solve with the same iteration count, its floor the CPU
    solve's change under a 1e-15 change of its map)."""
    from plancklens_tpu_torch import compat
    from plancklens_tpu_torch.models import cinv as pcinv, sims as psims, filt as pfilt
    from plancklens_tpu_torch.ops.sht import gl_geometry
    from plancklens_tpu_torch.utils import alm as ualm, cls as pcls
    from plancklens_tpu_torch.utils.cls import cli
    device, cpu = torch.device(device), torch.device('cpu')
    geom = gl_geometry(lmax)
    rng = np.random.RandomState(91)
    nalm = ualm.getsize(lmax)
    mask = (np.abs(np.cos(geom.theta))[:, None] > 0.3) * np.ones((1, geom.nphi))
    cl_len = _cls(lmax)
    cl_unl = _cls_unl(lmax + 16)
    tf = np.exp(-0.5 * np.arange(lmax + 1) * (np.arange(lmax + 1) + 1) * 1e-4)
    fls = [cli(cl_len[k] + 1e-5) for k in ('tt', 'ee', 'bb')]
    maps = [rng.standard_normal((geom.nrings, geom.nphi)) for _ in range(3)]
    ph = {i: rng.standard_normal((3, nalm)) + 1j * rng.standard_normal((3, nalm))
          for i in (0, 1)}
    ph4 = {i: rng.standard_normal((4, ualm.getsize(lmax + 16)))
           + 1j * rng.standard_normal((4, ualm.getsize(lmax + 16))) for i in (0, 1, 2)}
    noise = {(i, t): rng.standard_normal(nalm) + 1j * rng.standard_normal(nalm)
             for i in (0, 1) for t in range(3)}
    fm = [rng.uniform(0.5, 1.5, (lmax + 1, lmax + 1)) for _ in range(3)]
    kmap = rng.standard_normal((1, geom.nrings, geom.nphi)) * 1e-2
    clpp = cl_unl['pp'][:lmax + 1]

    class _Maps:
        def get_sim_tmap(self, idx):
            return maps[0]

        def get_sim_pmap(self, idx):
            return maps[1], maps[2]

        def hashdict(self):
            return {}

    def run(d):
        obs = psims.MapsNlevLib(
            psims.CMBUnlLib(cl_len, lmax, fields=('t', 'e', 'b'), device=d,
                            phases=compat.phases_from_numpy(ph)),
            tf, 35., 50., phases=compat.phases_from_numpy(ph))
        apo = pcls.apodize_mask(mask, geom, sigma_arcmin=300., device=d)
        apo_ivf = pfilt.IVFApoSepTP(_Maps(), geom, apo, cl_len, tf, *fls, device=d)
        fml = pfilt.IVFFml(pfilt.IVFSepTP(obs, tf, cl_len, *fls), *fm)
        nlev = psims.AlmNlevLib(obs, lmax, tf, 20., 30., device=d,
                                noise=lambda i, t: noise[i, t])
        fixed = psims.CMBUnlLibFixedPhi(cl_unl, lmax + 16, phi_idx=2, device=d,
                                        phases=compat.phases_from_numpy(ph4))
        lens = psims.CMBLenLibFixedPhi(cl_unl, lmax, geom, dlmax=16, phi_idx=2, device=d,
                                       phases=compat.phases_from_numpy(ph4))
        kk = pcinv.CinvKK(lmax, geom, clpp, np.ones(lmax + 1), mask * 1e5, eps_min=1e-6,
                          lmax_dense=0, marge_dipole=False, device=d)
        x, it, _ = kk.solve_wf(kmap)
        out = {'smooth_map': pcls.smooth_map(mask, geom, 0.1, device=d),
               'apodize_mask': apo,
               'IVFApoSepTP': torch.stack([apo_ivf.get_sim_tlm(0), *apo_ivf._eb(0)]),
               'IVFFml': torch.cat(fml.get_sim_teblm_batch([0, 1])
                                   + (fml.get_sim_emliklm(1)[None],)),
               'AlmNlevLib': torch.stack(nlev.get_sim_teblm_batch([0, 1])),
               'CMBUnlLibFixedPhi': fixed.get_sim_alms_batch([0, 1]),
               'CMBLenLibFixedPhi': torch.stack([lens.get_sim_tmap(1), *lens.get_sim_pmap(0)]),
               'CinvKK': x, 'template_uptolmin': pcinv.template_uptolmin(geom, 2, device=d)}
        out = {k: torch.as_tensor(v).cpu() for k, v in out.items()}
        return out, it, kk
    (on_dev, it_d, _), (on_cpu, it_c, kk) = run(device), run(cpu)
    errs = {k: _rel_max(on_dev[k], on_cpu[k]) for k in on_cpu}
    its = [it_d, it_c]
    floors = []
    for _ in range(2):
        x, it, _ = kk.solve_wf(_perturbed(kmap, rng))
        floors.append(_rel_max(x, on_cpu['CinvKK']))
        its.append(it)
    errs['CinvKK_floor'], errs['CinvKK_it'] = max(floors), tuple(its)
    for k in on_cpu:
        log('(9a) %s, lmax %d, f64: device vs CPU %.2e of max (limit %.2e)%s'
            % (k, lmax, errs[k], stage_b_limit(k, errs),
               ', iterations device / CPU / CPU perturbed %s (limit: 10x the largest change '
               'of the CPU solution under two 1e-15 changes of its map)' % (its,)
               if k == 'CinvKK' else ''))
    return errs


def masked_gmv(device, lmax=2048, nsims=4, dense_cacher=None, lmax_dense=LMAX_DENSE,
               log=print):
    """9b and 9c's amplitude (module docstring). `dense_cacher` holds the parameter file's
    CinvT/CinvP dense blocks (phase 6's); the joint block is probed and stored there too."""
    import run_qlms_torch as drv
    from masked_filter_torch import true_rel
    from plancklens_tpu_torch.models import cinv as pcinv, qresp
    from plancklens_tpu_torch.models.filt import IVFFtl
    from plancklens_tpu_torch.models.qest import QELib
    from plancklens_tpu_torch.models.qecl import QeClLib, InputPlmLib
    from plancklens_tpu_torch.ops.sht import core
    from plancklens_tpu_torch.utils.cachers import cacher_mem
    device = torch.device(device)
    os.environ.update(PLK_ANISO_LMAX=str(lmax), PLK_ANISO_NSIMS=str(max(nsims, 5)))
    os.environ.pop('PLK_CACHE_DIR', None)
    dense_cacher = cacher_mem() if dense_cacher is None else dense_cacher
    t0 = time.perf_counter()
    par = drv.load_parfile(os.path.join(_REPO, 'params', 'anisofilt_example_torch.py'),
                           device, dense_cacher=dense_cacher)
    out = {'parfile_s': time.perf_counter() - t0, 'nsims': nsims}
    idxs = list(range(nsims))
    with drv.StageTimer(device) as st:
        T = torch.stack([par.sims.get_sim_tmap(i) for i in idxs])
        QU = [par.sims.get_sim_pmap(i) for i in idxs]
        Q, U = torch.stack([p[0] for p in QU]), torch.stack([p[1] for p in QU])
    out['sims_s'] = st.seconds
    del QU
    _fresh(device)
    t0 = time.perf_counter()
    with core.counting() as c:
        tp = pcinv.CinvTP(lmax, par.geom, par.cl_len, par.transf, par.ninv_t, par.ninv_p,
                          lmax_dense=lmax_dense, marge_monopole=True, marge_dipole=True,
                          dense_cacher=dense_cacher, device=device)
        _sync(device)
    out['setup_s'] = time.perf_counter() - t0
    out['probe_calls'] = c.calls
    out['probe_peak_gib'] = _peak(device)
    _fresh(device)
    with core.counting() as c, drv.StageTimer(device) as st:
        (t, e, b), it, rel, x = tp.apply_ivf(T, Q, U, ret_it=True, ret_wf=True)
    out.update(solve_s=st.seconds, it=int(it), rel=rel.cpu().numpy(), calls=c.calls,
               peak_gib=_peak(device))
    out['s_per_it'] = out['solve_s'] / max(1, out['it'])
    out['true_rel'] = true_rel(tp, tp.calc_prep(T, Q, U), x, tp._ms3).cpu().numpy()
    del T, Q, U, x
    log('(9b) CinvTP at lmax %d, f64, lensed masked sims %s in one lockstep batch, dense '
        'T/E/B block to l %d: parfile %.2fs, sims %.2fs, setup (probe and inverse) %.2fs '
        '(peak %.2f GiB); %d iterations in %.3fs (%.1f ms an iteration), relative residual '
        'recurred %s, recomputed %s; kernel calls by (kernel, mode, batch, type) %s; peak '
        '%.2f GiB'
        % (lmax, idxs, lmax_dense, out['parfile_s'], out['sims_s'], out['setup_s'],
           out['probe_peak_gib'], out['it'], out['solve_s'], 1e3 * out['s_per_it'],
           np.array2string(out['rel'], precision=3),
           np.array2string(out['true_rel'], precision=3), dict(sorted(out['calls'].items())),
           out['peak_gib']))
    # the route: the bar alms under the reference's cacher names, read by IVFCinvJTP
    cacher = cacher_mem()
    for j, i in enumerate(idxs):
        for f, a in zip('teb', (t, e, b)):
            cacher.cache('ivf_%slm_%05d' % (f, i), a[j].cpu().numpy())
    del t, e, b
    ivfs = IVFFtl(pcinv.IVFCinvJTP(tp, par.sims, par.cl_len, cacher=cacher),
                  par.ftl, par.fel, par.fbl)
    qlms = QELib(ivfs, ivfs, par.cl_weight, lmax, lmax, device=device)
    with drv.StageTimer(device) as st:
        q = qlms.get_sim_qlm_batch('p', idxs)
    out['qe_s'] = st.seconds
    out['finite'] = bool(torch.isfinite(q).all())
    xin = QeClLib(qlms, InputPlmLib(par.cmb_len, lmax, device=device), np.array([]))
    xcl = np.stack([xin.get_sim_qcl('p', i) for i in idxs])
    lmin = int(np.argmax(par.ftl > 0))
    fal = {k: v * (np.arange(lmax + 1) >= lmin) for k, v in tp.get_fal().items()}
    with drv.StageTimer(device) as st:
        R = qresp.RespLib(lmax, par.cl_weight, par.cl_len, fal, lmax,
                          device=device).get_response('p', 'p')
    out['resp_s'] = st.seconds
    fsky = xin.fsky12
    cpp = par.cl_unl['pp'][:lmax + 1]
    lo, hi = AMPL_L
    ls = np.arange(lo, min(hi, lmax) + 1)
    out['fsky'] = fsky
    out['ampl'] = float(np.mean(xcl.mean(0)[ls] / (R[ls] * cpp[ls] * fsky)))
    out['finite'] &= bool(np.all(np.isfinite(xcl)) and np.all(np.isfinite(R)))
    log('(9c) IVFCinvJTP (cached bar alms) -> IVFFtl (l >= %d) -> QELib \'p\' on sims %s: qe '
        '%.3fs, response %.3fs (RespLib on CinvTP.get_fal(), keys %s); <q x phi_in> / (R_L '
        'C_L^pp fsky), fsky %.4f, mean over %d <= L <= %d: %.4f; all finite %s'
        % (lmin, idxs, out['qe_s'], out['resp_s'], '/'.join(sorted(fal)), fsky, lo, ls[-1],
           out['ampl'], out['finite']))
    return out


def n0_ratio(device, lmax=2048, log=print):
    """9c's N0 comparison (module docstring): {'ratio': N0_GMV / N0_SQE at N0_L, ...}."""
    from plancklens_tpu_torch.models import nhl, qresp
    from plancklens_tpu_torch.models.n0s import gauss_beam
    from plancklens_tpu_torch.utils.cls import cls_dot
    device = torch.device(device)
    transf = gauss_beam(FWHM, lmax=lmax)
    cl_len, cls_dat, fal_j, fal_s = gmv_fal(lmax, NLEV_T, NLEV_P, transf)
    n0 = {}
    t0 = time.perf_counter()
    for name, fal in (('gmv', fal_j), ('sqe', fal_s)):
        cls_ivfs = cls_dot([fal, cls_dat, fal], ret_dict=True)
        N = nhl.get_nhl('p', 'p', cl_len, cls_ivfs, lmax, lmax, lmax_out=lmax,
                        device=device)[0]
        R = qresp.get_response('p', lmax, 'p', cl_len, cl_len, fal, lmax_qlm=lmax,
                               device=device)[0]
        n0[name] = N * (1. / np.where(R != 0., R, np.inf)) ** 2
    _sync(device)
    lo, hi = N0_L
    ls = np.arange(lo, min(hi, lmax) + 1)
    ratio = n0['gmv'][ls] / n0['sqe'][ls]
    out = {'ratio': ratio, 'seconds': time.perf_counter() - t0, 'L': (lo, int(ls[-1]))}
    log('(9c) semi-analytic N0 of the GMV \'p\' (joint filter) over that of the \'p\' of separate '
        'T and P filters, %g / %g uK-arcmin, %g\', cl_weight = cl_len, lmax %d, %d <= L <= %d: '
        '%.4f - %.4f (max - 1: %.2e); %.2fs'
        % (NLEV_T, NLEV_P, FWHM, lmax, lo, ls[-1], ratio.min(), ratio.max(), ratio.max() - 1.,
           out['seconds']))
    return out


def ivfjtp_full(device, lmax=2048, nsims=4, log=print):
    """9d (module docstring): {'ratio': mean C^qq / N0 over SPEC_L, ...}."""
    import run_qlms_torch as drv
    from plancklens_tpu_torch.models import nhl
    from plancklens_tpu_torch.models.filt import IVFJTP
    from plancklens_tpu_torch.models.qest import QELib
    from plancklens_tpu_torch.utils import alm as ualm
    from plancklens_tpu_torch.utils.cls import cls_dot
    device = torch.device(device)
    transf = np.ones(lmax + 1)
    lmin = 8
    cl_len, cls_dat, fal, _ = gmv_fal(lmax, NLEV_T, NLEV_T * np.sqrt(2.), transf, lmin=lmin)
    _fresh(device)
    sims = _gauss_sims(lmax, 21, 22, NLEV_T, NLEV_T * np.sqrt(2.), transf, device)
    ivfs = IVFJTP(sims, transf, cl_len, fal)
    with drv.StageTimer(device) as st:
        q = QELib(ivfs, ivfs, cl_len, lmax, lmax, device=device).get_sim_qlm_batch(
            'p', np.arange(nsims))
    qe_s = st.seconds
    cls_q = ualm.alm2cl(q, lmax).mean(0).cpu().numpy()
    cls_ivfs = cls_dot([fal, cls_dat, fal], ret_dict=True)
    for cl in cls_ivfs.values():
        cl[:lmin] = 0.
    NG = nhl.get_nhl('p', 'p', cl_len, cls_ivfs, lmax, lmax, lmax_out=lmax, device=device)[0]
    lo, hi = SPEC_L
    ls = np.arange(lo, min(hi, lmax) + 1)
    r = cls_q[ls] / NG[ls]
    out = {'ratio': float(r.mean()), 'ratio_min': float(r.min()), 'ratio_max': float(r.max()),
           'qe_s': qe_s, 'peak_gib': _peak(device), 'finite': bool(torch.isfinite(q).all())}
    log('(9d) IVFJTP on %d Gaussian sims of the lensed spectra at lmax %d (%g / %g uK-arcmin, '
        'l >= %d), GMV \'p\' in f64: qe %.3fs, peak %.2f GiB; C_L^qq / N0_L over %d <= L <= %d: '
        'mean %.4f (bound |mean - 1| <= %g), per L %.3f - %.3f'
        % (nsims, lmax, NLEV_T, NLEV_T * np.sqrt(2.), lmin, qe_s, out['peak_gib'], lo, ls[-1],
           out['ratio'], SPEC_BOUND, out['ratio_min'], out['ratio_max']))
    return out


def kernel_rows(device, lmax=2048, batch=4, log=print):
    """K1 / K2 at the joint operator's shapes (module docstring): {name: row}, each row
    lensed_chain_torch._kernel_row's (ms, plain_ms, max_abs_err, rel_err, equal,
    bound_ms, bound_by, mode, batch)."""
    from lensed_chain_torch import _kernel_row
    from plancklens_tpu_torch.ops.sht import gl_geometry
    geom = gl_geometry(lmax)
    rows = {}
    for kind in ('synth', 'anal'):
        for spin, mode in ((0, 0), (2, 1)):
            name = '%s_pair_tp_%s' % (kind, 'spin0' if mode == 0 else 'spin2')
            row = rows[name] = _kernel_row(kind, spin, mode, lmax, geom, device, batch=batch)
            log('(9b) %s at the joint operator\'s shape (%s, f64, batch %d, %d rings, lmax %d): '
                '%.3f ms (plain %.1f ms, %.2e of max, bitwise equal on a second run: %s), '
                'bound %.3f ms (%s, %.1f%%)'
                % ('K1' if kind == 'synth' else 'K2',
                   'spin 0, one input' if mode == 0 else 'spin-2 pair', batch, geom.nrings,
                   lmax, row['ms'], row['plain_ms'], row['rel_err'], row['equal'],
                   row['bound_ms'], row['bound_by'], 100. * row['bound_ms'] / row['ms']))
    return rows


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--lmax', type=int, default=2048)
    p.add_argument('--nsims', type=int, default=4)
    p.add_argument('--device', default='cuda')
    args = p.parse_args()
    res = {'9a': card_vs_cpu(args.device), '9a_b': stage_b_card_vs_cpu(args.device),
           '9b': masked_gmv(args.device, args.lmax, args.nsims),
           '9c': n0_ratio(args.device, args.lmax),
           '9d': ivfjtp_full(args.device, args.lmax, args.nsims)}
    if torch.device(args.device).type == 'cuda':
        res['kernels'] = kernel_rows(args.device, args.lmax)

    def plain(v):
        if isinstance(v, dict):
            return {str(k): plain(w) for k, w in v.items()}
        if isinstance(v, (list, tuple)):
            return [plain(w) for w in v]
        if isinstance(v, np.ndarray):
            return v.tolist()
        return v
    print(json.dumps(plain(res)))


if __name__ == '__main__':
    main()
