"""Port parity of the lensed masked chain against plancklens_tpu at lmax 32, f64 on the CPU:
lensed sims (CMBLenLib with a curl potential) -> MapsLenNlevLib (5' beam, 35 / 55
uK-arcmin pixel noise) -> cinv.IVFCinv over the anisotropic parameter file's mask ->
filt.IVFFtl -> qest.QELib (ptt, p_p) -> qecl.QeClLib (dd spectra, and the cross with the
input potentials through qecl.InputPlmLib), the reference's unit phases and noise maps
injected (test_torch_lensed_sims.lensed_libs).

Parity follows the rule of ROADMAP fault 3.6: the CG iteration counts are equal; filters
at higher noise (T at 1000, P at 300 uK-arcmin) hold the filtered alms, qlms and spectra
to 1e-10 of max; the masked T filter at the sims' own Planck-like noise holds its Wiener
solution to 10x the port's own response to a 1e-15 change of its maps, measured here.
"""
import os

import numpy as np
import pytest
import torch

from plancklens_tpu import DATAPATH
from plancklens_tpu.utils import camb_clfile
from plancklens_tpu.models import cinv as rcinv, filt as rfilt, qest as rqest, \
    qecl as rqecl, n0s as rn0s
from plancklens_tpu_torch.models import cinv as pcinv, filt as pfilt, qest as pqest, \
    qecl as pqecl

from test_torch_lensed_sims import lensed_libs, LMAX

torch.set_num_threads(1)

LMIN = 4


def _err(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return np.abs(a - ref).max() / np.abs(ref).max()


def _mask(geom):
    """params/anisofilt_example.py's galactic cut and three holes on `geom`."""
    z = np.cos(geom.theta)[:, None]
    phi = (2. * np.pi * np.arange(geom.nphi) / geom.nphi)[None, :]
    mask = (np.abs(z) > 0.15).astype(float) * np.ones((geom.nrings, geom.nphi))
    for zc, pc, r in ((0.6, 1.0, 0.05), (-0.5, 4.0, 0.04), (0.3, 2.5, 0.03)):
        mask *= ((z - zc) ** 2 + (np.cos(phi) - np.cos(pc)) ** 2 * (1 - z ** 2)
                 + (np.sin(phi) - np.sin(pc)) ** 2 * (1 - z ** 2) > r ** 2)
    return mask


def _cls_len():
    return camb_clfile(os.path.join(DATAPATH, 'cls', 'FFP10_wdipole_lensedCls.dat'))


@pytest.fixture(scope='module')
def libs():
    return lensed_libs([0, 1])


def _counted(cinv, its):
    """`cinv` with its solve_wf recording the iteration count of every solve in `its`."""
    solve = cinv.solve_wf

    def counting(*args, **kw):
        x, it, rel = solve(*args, **kw)
        its.append(int(it))
        return x, it, rel
    cinv.solve_wf = counting
    return cinv


def test_lensed_masked_route_matches_reference(libs):
    idxs = [0, 1]
    (rlen, rmaps), (plen, pmaps) = libs
    cls = _cls_len()
    transf = rn0s.gauss_beam(5., LMAX)
    mask = _mask(plen.geom)
    ninv_t = rmaps.ninv_t() * mask * (35. / 1000.) ** 2
    ninv_p = rmaps.ninv_p() * mask * (55. / 300.) ** 2
    kw_t, kw_p = dict(eps_min=1e-5, lmax_dense=24), dict(eps_min=1e-5, lmax_dense=8)
    its = {k: [] for k in ('rt', 'rp', 'pt', 'pp')}
    rt = _counted(rcinv.CinvT(LMAX, rlen.geom, cls, transf, ninv_t, **kw_t), its['rt'])
    rp = _counted(rcinv.CinvP(LMAX, rlen.geom, cls, transf, ninv_p, **kw_p), its['rp'])
    pt = _counted(pcinv.CinvT(LMAX, plen.geom, cls, transf, ninv_t, device='cpu', **kw_t),
                  its['pt'])
    pp = _counted(pcinv.CinvP(LMAX, plen.geom, cls, transf, ninv_p, device='cpu', **kw_p),
                  its['pp'])
    cut = [(np.arange(LMAX + 1) >= LMIN) * 1.] * 3
    ivfs_r = rfilt.IVFFtl(rcinv.IVFCinv(rt, rp, rmaps, cls), *cut)
    ivfs_p = pfilt.IVFFtl(pcinv.IVFCinv(pt, pp, pmaps, cls), *cut)
    assert ivfs_p.hashdict() == ivfs_r.hashdict()
    for i in idxs:
        for f in 'teb':
            name = 'get_sim_%slm' % f
            assert _err(getattr(ivfs_p, name)(i), getattr(ivfs_r, name)(i)) <= 1e-10, (f, i)
    # one T and one P solve a sim in each package, with the same iteration counts
    assert its['pt'] == its['rt'] and len(its['pt']) == 2 and min(its['pt']) > 5, its
    assert its['pp'] == its['rp'] and len(its['pp']) == 2 and min(its['pp']) > 3, its
    qr = rqest.QELib(ivfs_r, ivfs_r, cls, LMAX, LMAX)
    qp = pqest.QELib(ivfs_p, ivfs_p, cls, LMAX, LMAX, device='cpu')
    cr = rqecl.QeClLib(qr, qr, np.array([]))
    cp = pqecl.QeClLib(qp, qp, np.array([]))
    xr = rqecl.QeClLib(qr, rqecl.InputPlmLib(rlen, LMAX), np.array([]))
    xp = pqecl.QeClLib(qp, pqecl.InputPlmLib(plen, LMAX, device='cpu'), np.array([]))
    assert abs(xp.fsky12 - xr.fsky12) <= 1e-12 and 0.7 < xp.fsky12 < 0.9
    for k in ('ptt', 'p_p'):
        for i in idxs:
            assert _err(qp.get_sim_qlm(k, i), qr.get_sim_qlm(k, i)) <= 1e-10, (k, i)
            assert _err(cp.get_sim_qcl(k, i), cr.get_sim_qcl(k, i)) <= 1e-10, (k, i)
            assert _err(xp.get_sim_qcl(k, i), xr.get_sim_qcl(k, i)) <= 1e-10, (k, i)


def test_lensed_masked_t_planck_noise_to_its_conditioning(libs):
    """CinvT at the sims' own 35 uK-arcmin over the cut, monopole and dipole marginalised:
    the same iteration count in both packages, and the Wiener solutions within 10x the
    port's own response to a 1e-15 relative change of its input map."""
    (_, rmaps), (plen, pmaps) = libs
    cls = _cls_len()
    transf = rn0s.gauss_beam(5., LMAX)
    ninv_t = rmaps.ninv_t() * _mask(plen.geom)
    r = rcinv.CinvT(LMAX, rmaps.geom, cls, transf, ninv_t, eps_min=1e-5, lmax_dense=16)
    p = pcinv.CinvT(LMAX, plen.geom, cls, transf, ninv_t, eps_min=1e-5, lmax_dense=16,
                    device='cpu')
    T = pmaps.get_sim_tmap(0)
    assert _err(T, rmaps.get_sim_tmap(0)) <= 1e-10
    rx, rit, _ = r.solve_wf(rmaps.get_sim_tmap(0))
    px, pit, _ = p.solve_wf(T)
    rng = np.random.RandomState(15)
    px2, pit2, _ = p.solve_wf(T * (1. + 1e-15 * torch.as_tensor(rng.standard_normal(T.shape))))
    assert pit == int(rit) == pit2 and pit > 20, (pit, int(rit), pit2)
    floor = _err(px2, px)
    assert 0. < floor < 1e-6, floor
    assert _err(px, rx) <= 10. * floor, (_err(px, rx), floor)
