#!/usr/bin/env python
r"""The port's Planck 2018 parameter file (params/smica_dx12_planck2018_torch.py) driven
through its own code on synthetic products in the reference's on-disk formats, the step
chip_smoke.py phase 10 calls:

    python examples/smica_synth_torch.py [--lmax 2048] [--nside 2048] [--device cuda]

The Planck products ($PLK_PLANCK_DATA: SMICA / FFP10 alm FITS files and the lensing mask)
are not in the repository. `write_products` makes stand-ins of the same formats in a
directory: healpy alm FITS files of lensed CMB (sims.CMBLenLib on the GL grid of lmax,
dlmax 128) observed through the parameter file's transfer function (5' beam x the
pixel window of nside) with white noise (sims.AlmNlevLib) for sims 0..nsims-1 and the
'dat' index, the noise-free input phi alms, and a RING HEALPix lensing mask of nside (the
galactic band |z| > 0.15 and two holes). `smica_chain` loads the parameter file on them
(PLK_PLANCK_DATA, PLK_SMICA_LMAX, _NSIDE, _NSIMS) and runs, each step timed: the filters'
construction (mask read and resampled onto the ring grid, the CinvT dense block to l 64 on
the host), the masked filtering of sims 0..nsims-1 (IVFCinv, one sim a solve), the QEs
ptt and p_p at the file's lmax_qlm, the responses, and the cross with the input phi read
back from FITS, <q x phi_in> / (R_L C_L^pp fsky) over 30 <= L <= 1000. Returns a dict of
numbers; `log` receives one line per step.
"""
import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (_REPO, os.path.join(_REPO, 'examples')):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch

KEYS = ('ptt', 'p_p')
AMPL_L = (30, 1000)


def mask_map(nside):
    """RING HEALPix mask of nside: the galactic band |z| > 0.15 and two circular holes."""
    from plancklens_tpu_torch.ops.sht.healpix import HealpixGeometry
    hg = HealpixGeometry(nside)
    z = np.repeat(np.cos(hg.theta), hg.nphi)
    phi = np.concatenate([p0 + 2. * np.pi * np.arange(n) / n
                          for p0, n in zip(hg.phi0, hg.nphi)])
    mask = (np.abs(z) > 0.15).astype(float)
    for zc, pc, r in ((0.6, 1.0, 0.08), (-0.5, 4.0, 0.06)):
        mask *= ((z - zc) ** 2 + (np.cos(phi) - np.cos(pc)) ** 2 * (1 - z ** 2)
                 + (np.sin(phi) - np.sin(pc)) ** 2 * (1 - z ** 2) > r ** 2)
    return mask


def write_products(tdir, lmax, nside, nsims, nlev_t, nlev_p, device, seed=7, dlmax=None,
                   geom=None):
    """The synthetic products in `tdir` (module docstring); returns the CMBLenLib. The
    lensed skies are made on `geom` (default the GL grid of lmax) with dlmax (default
    min(128, max(16, lmax // 4)))."""
    import plancklens_tpu_torch
    from plancklens_tpu_torch.utils import camb_clfile
    from plancklens_tpu_torch.utils.fitsio import write_alm, write_map
    from plancklens_tpu_torch.models.n0s import gauss_beam
    from plancklens_tpu_torch.models.sims import CMBLenLib, AlmNlevLib
    from plancklens_tpu_torch.ops.sht import gl_geometry
    from plancklens_tpu_torch.ops.sht.healpix import pixwin
    cl_unl = camb_clfile(os.path.join(plancklens_tpu_torch.DATAPATH, 'cls',
                                      'FFP10_wdipole_lenspotentialCls.dat'))
    transf = gauss_beam(5., lmax=lmax) * pixwin(nside, lmax, device=device)
    dlmax = min(128, max(16, lmax // 4)) if dlmax is None else dlmax
    cmb_len = CMBLenLib(cl_unl, lmax, gl_geometry(lmax) if geom is None else geom,
                        seed=seed, dlmax=dlmax, device=device)
    obs = AlmNlevLib(cmb_len, lmax, transf, nlev_t, nlev_p, seed=3000, device=device)
    smica = os.path.join(tdir, 'smica_dx12')
    os.makedirs(smica, exist_ok=True)
    for i in range(nsims + 1):
        tag = 'dat' if i == nsims else '%04d' % i     # the extra realisation is 'data'
        for f in 'teb':
            write_alm(os.path.join(smica, 'sim_%slm_%s.fits' % (f, tag)),
                      getattr(obs, 'get_sim_%slm' % f)(i).cpu().numpy())
        write_alm(os.path.join(smica, 'sim_plm_%s.fits' % tag),
                  cmb_len.get_sim_plm(i).cpu().numpy())
    write_map(os.path.join(tdir, 'lensing_mask.fits'), mask_map(nside), nside=nside)
    return cmb_len


def load_parfile(tdir, lmax, nside, nsims, device, **extra_env):
    """params/smica_dx12_planck2018_torch.py on the products in tdir (the environment it
    reads is restored afterwards)."""
    env = {'PLK_PLANCK_DATA': tdir, 'PLK_DEVICE': str(device), 'PLK_SMICA_LMAX': str(lmax),
           'PLK_SMICA_NSIDE': str(nside), 'PLK_SMICA_NSIMS': str(nsims), **extra_env}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        spec = importlib.util.spec_from_file_location(
            'smica_dx12_planck2018_torch',
            os.path.join(_REPO, 'params', 'smica_dx12_planck2018_torch.py'))
        par = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(par)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    return par


def smica_chain(device, lmax=2048, nside=2048, nsims=2, log=print):
    """Products written to a temporary directory, then the parameter file's chain on
    sims 0..nsims-1 (module docstring)."""
    import run_qlms_torch as drv
    from plancklens_tpu_torch.ops.sht import legendre_kernels as lk
    from plancklens_tpu_torch.utils import alm as ualm
    device = torch.device(device)
    cuda = device.type == 'cuda'
    out = {'lmax': lmax, 'nside': nside, 'nsims': nsims}
    idxs = list(range(nsims))
    with tempfile.TemporaryDirectory() as tdir:
        t0 = time.perf_counter()
        cmb_len = write_products(tdir, lmax, nside, nsims, 35., 55., device)
        out['products_s'] = time.perf_counter() - t0
        out['products_mb'] = sum(os.path.getsize(os.path.join(r, f))
                                 for r, _, fs in os.walk(tdir) for f in fs) / 2 ** 20
        del cmb_len
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        par = load_parfile(tdir, lmax, nside, nsims, device)
        out['import_s'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        par.cinv_t.lmax, par.cinv_p.lmax
        out['filters_s'] = time.perf_counter() - t0
        out['fsky_ring'] = float(np.mean(par.cinv_t.filt.ninv > 0))
        lk.reset_launches()
        (t, e, b), out['filt_s'] = drv.stage_filt(par, idxs)
        qlms, out['qe_s'] = drv.stage_qe(par, KEYS, idxs)
        out['launches'] = dict(lk.launches)
        with drv.StageTimer(device) as st:
            resp = {k: par.qresp_dd.get_response(k, 'p') for k in KEYS}
        out['resp_s'] = st.seconds
        xin, out['xin_s'] = drv.stage_xin(par, KEYS, idxs)
        out['peak_gib'] = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else float('nan')
        low = torch.as_tensor(ualm._lm_indices(lmax)[0] < par.lmin_ivf, device=t.device)
        out['lcut_ok'] = bool((t[:, low] == 0).all())
        out['finite'] = all(bool(torch.isfinite(a).all()) for a in (t, e, b)) \
            and all(bool(torch.isfinite(q).all()) for q in qlms.values()) \
            and all(np.isfinite(v).all() for d in (resp, xin) for v in d.values())
        fsky = par.qlms_x_in.fsky12
        cpp = par.cl_unl['pp'][:par.lmax_qlm + 1]
        lo, hi = AMPL_L
        ls = np.arange(lo, min(hi, lmax) + 1)
        out['fsky'] = fsky
        out['ampl'] = {k: float(np.mean(xin[k].mean(0)[ls] / (resp[k][ls] * cpp[ls] * fsky)))
                       for k in KEYS}
        out['lmax_qlm'] = par.lmax_qlm
        out['geom'] = (par.geom.nrings, par.geom.nphi)
        del par, t, e, b, qlms
    log('(10) params/smica_dx12_planck2018_torch.py at lmax %d (lmax_qlm %d), nside %d, on '
        'synthetic products (%.0f MB: alm FITS of sims %s and dat, input phi, a RING mask): '
        'products %.2fs, import %.2fs, filters (mask resampled onto the %d x %d grid, fsky '
        '%.4f; CinvT dense block to l 64) %.2fs, filt %.3fs, qe %s %.3fs, responses %.3fs, '
        'xin %.3fs; peak %.2f GiB; K1/K2 launches %s; l-cut kept %s; all finite %s'
        % (lmax, out['lmax_qlm'], nside, out['products_mb'], idxs, out['products_s'],
           out['import_s'], out['geom'][0], out['geom'][1], out['fsky_ring'],
           out['filters_s'], out['filt_s'], '/'.join(KEYS), out['qe_s'], out['resp_s'],
           out['xin_s'], out['peak_gib'], out['launches'], out['lcut_ok'], out['finite']))
    log('(10) <q x phi_in> / (R_L C_L^pp fsky), fsky %.4f, mean over %d <= L <= %d, %d sims: '
        '%s' % (out['fsky'], lo, ls[-1], nsims,
                ', '.join('%s %.4f' % kv for kv in out['ampl'].items())))
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--lmax', type=int, default=2048)
    p.add_argument('--nside', type=int, default=2048)
    p.add_argument('--nsims', type=int, default=2)
    p.add_argument('--device', default='cuda')
    args = p.parse_args()
    print(json.dumps(smica_chain(args.device, args.lmax, args.nside, args.nsims),
                     default=str))


if __name__ == '__main__':
    main()
