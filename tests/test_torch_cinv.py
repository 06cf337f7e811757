"""Port parity of masked inverse-variance filtering: plancklens_tpu_torch.models.cinv
(CinvT, CinvP and their pieces) against plancklens_tpu.models.cinv on identical numpy
inputs, f64, on the CPU (the plain twins of the Legendre kernels).

What holds, and to what tolerance:
  * the masked solves take the same iteration count, and their Wiener solutions (and the
    inverse-variance filtered alms) agree to 1e-10 of max, where the system allows it;
  * at Planck-like noise (30 uK-arcmin over a galactic cut) the masked T system is so
    ill-conditioned (the dense block alone has condition ~1e7) that a 1e-15 relative
    change of the input maps moves the solution by ~3e-8 of max in either package, and
    the rounding of two SHT implementations does the same: there the iteration count is
    still equal and the two solutions are held to 10x the port's own response to such a
    change, measured in the test;
  * the analytic dense block equals the reference's to 1e-13 of max (the probed blocks and
    the cache shared across packages: test_torch_cinv_route.py);
  * homogeneous noise gives the isotropic filter (T 1e-4, P 1e-3 of max, mirrors of
    tests/test_cinv.py:28 and :119); Q/U templates are nulled exactly (:343).
"""
import os

import numpy as np
import pytest
import torch

from plancklens_tpu import DATAPATH
from plancklens_tpu.utils import camb_clfile, cli, alm as ralm
from plancklens_tpu.ops.sht import SHT as RSHT, gl_geometry as rgl
from plancklens_tpu.models import cinv as rcinv
from plancklens_tpu_torch.ops.sht import SHT as PSHT, gl_geometry as pgl
from plancklens_tpu_torch.models import cinv as pcinv
from plancklens_tpu_torch.ops import cg as pcg
from plancklens_tpu_torch.utils import alm as palm

torch.set_num_threads(1)


def _err(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return np.abs(a - ref).max() / np.abs(ref).max()


def _cls(lmax):
    return camb_clfile(os.path.join(DATAPATH, 'cls', 'FFP10_wdipole_lensedCls.dat'),
                       lmax=lmax)


def _sky(lmax, nlev, cut, inh, seed=3, pol_fac=1.4):
    """cls, geometry, two T maps, two Q/U map pairs (signal + white noise of `nlev`
    uK-arcmin, `pol_fac` x that in pol) and an inverse pixel-variance map of `nlev` with
    an (1 + inh cos theta) modulation and the cut |cos theta| > cut: all host numpy."""
    cls = _cls(lmax)
    geom = rgl(lmax)
    sht = RSHT(geom, lmax)
    omega = np.outer(geom.weight, np.full(geom.nphi, 2 * np.pi / geom.nphi))
    sig = (nlev / 60. / 180. * np.pi) / np.sqrt(omega)
    rng = np.random.RandomState(seed)
    ls, ms = ralm._lm_indices(lmax)

    def ralms(cl):
        a = (rng.standard_normal((2, len(ls))) + 1j * rng.standard_normal((2, len(ls))))
        a[:, ms == 0] = a[:, ms == 0].real * np.sqrt(2.)
        return a / np.sqrt(2.) * np.sqrt(cl[ls])
    T = np.asarray(sht.alm2map(ralms(cls['tt']))) + rng.standard_normal((2,) + omega.shape) * sig
    q, u = sht.alm2map_spin((ralms(cls['ee']), ralms(cls['bb'])), 2)
    Q = np.asarray(q) + rng.standard_normal((2,) + omega.shape) * sig * pol_fac
    U = np.asarray(u) + rng.standard_normal((2,) + omega.shape) * sig * pol_fac
    ninv = (1. / sig ** 2) * (1. + inh * np.cos(geom.theta))[:, None] \
        * (np.abs(np.cos(geom.theta))[:, None] > cut)
    return cls, geom, T, Q, U, ninv, rng


# (field, lmax, lmax_dense, nlev, cut, inhomogeneity, marginalise monopole+dipole)
MASKED = [('t', 48, 32, 300., 0.2, 0.5, False),
          ('t', 40, 32, 1000., 0.2, 0.5, True),
          ('t', 32, 16, 3000., 0.2, 0.5, False),
          ('p', 24, 8, 40., 0.25, 0.4, None)]


@pytest.mark.parametrize('case', MASKED, ids=['-'.join(map(str, c[:4])) for c in MASKED])
def test_masked_matches_reference(case):
    """Same iteration count; Wiener solution and filtered alms within 1e-10 of max."""
    field, lmax, ld, nlev, cut, inh, marge = case
    cls, geom, T, Q, U, ninv, _ = _sky(lmax, nlev, cut, inh)
    tf = np.ones(lmax + 1)
    kw = dict(eps_min=1e-5, iter_max=400, lmax_dense=ld)
    if field == 't':
        kw.update(marge_monopole=marge, marge_dipole=marge)
        r = rcinv.CinvT(lmax, geom, cls, tf, ninv, **kw)
        p = pcinv.CinvT(lmax, pgl(lmax), cls, tf, ninv, device='cpu', **kw)
        (rout, rit, rrel, rx) = r.apply_ivf(T, ret_it=True, ret_wf=True)
        (pout, pit, prel, px) = p.apply_ivf(T, ret_it=True, ret_wf=True)
        outs = [(pout, rout)]
    else:
        r = rcinv.CinvP(lmax, geom, cls, tf, ninv, **kw)
        p = pcinv.CinvP(lmax, pgl(lmax), cls, tf, ninv, device='cpu', **kw)
        (rout, rit, rrel, rx) = r.apply_ivf(Q, U, ret_it=True, ret_wf=True)
        (pout, pit, prel, px) = p.apply_ivf(Q, U, ret_it=True, ret_wf=True)
        outs = list(zip(pout, rout))
    assert p.hashdict() == r.hashdict()
    assert pit == int(rit) and 5 < pit < 400, (pit, int(rit))
    assert px.dtype == torch.complex128 and px.shape == tuple(rx.shape)
    assert np.all(prel.numpy() <= 1e-5)
    assert _err(px, rx) <= 1e-10, _err(px, rx)
    for a, b in outs:
        assert _err(a, b) <= 1e-10, _err(a, b)


def test_masked_t_planck_noise_matches_reference_to_its_conditioning():
    """Planck-like noise (30 uK-arcmin) over the cut, monopole and dipole marginalised:
    ~100 iterations, the same count in both packages; the solutions within 10x the port's
    own response to a 1e-15 relative change of its input maps (measured ~3e-8 of max)."""
    lmax, ld = 48, 32
    cls, geom, T, Q, U, ninv, rng = _sky(lmax, 30., 0.2, 0.5)
    tf = np.ones(lmax + 1)
    r = rcinv.CinvT(lmax, geom, cls, tf, ninv, eps_min=1e-5, iter_max=400, lmax_dense=ld)
    p = pcinv.CinvT(lmax, pgl(lmax), cls, tf, ninv, eps_min=1e-5, iter_max=400,
                    lmax_dense=ld, device='cpu')
    rx, rit, _ = r.solve_wf(T)
    px, pit, _ = p.solve_wf(T)
    px2, pit2, _ = p.solve_wf(T * (1. + 1e-15 * rng.standard_normal(T.shape)))
    assert pit == int(rit) == pit2 and pit > 50, (pit, int(rit), pit2)
    floor = _err(px2, px)
    assert 1e-12 < floor < 1e-6, floor
    assert _err(px, rx) <= 10. * floor, (_err(px, rx), floor)


def test_dense_block_analytic_t_matches_reference():
    lmax, ld = 32, 16
    cls, geom, T, Q, U, ninv, _ = _sky(lmax, 30., 0.2, 0.5)
    r = rcinv.NinvFilterT(geom, ninv, np.ones(lmax + 1))
    p = pcinv.NinvFilterT(pgl(lmax), ninv, np.ones(lmax + 1), device='cpu')
    assert np.array_equal(pcinv._dmat_np(ld, 0, geom.theta), rcinv._dmat_np(ld, 0, geom.theta))
    dl = np.linspace(1., 2., ld + 1) * 1e3
    bdl = np.linspace(1., .5, ld + 1)
    Mr = rcinv.dense_block_analytic_t(r, ld, dl, bdl)
    Mp = pcinv.dense_block_analytic_t(p, ld, dl, bdl)
    assert _err(Mp, Mr) <= 1e-13
    assert _err(pcinv._dense_inverse(Mp), rcinv._dense_inverse(Mr)) <= 1e-10
    # the device-side apply equals the reference's alm_copy / rlm algebra
    Minv = rcinv._dense_inverse(Mr)
    x = T[:1].ravel()[:palm.getsize(lmax)] * (1. + 0.5j)
    ref = np.asarray(rcinv._dense_apply(Minv, ld, lmax)(x[None]))
    got = pcinv._dense_apply(Minv, ld, lmax, torch.device('cpu'))(torch.as_tensor(x[None]))
    assert _err(got, ref) <= 1e-14


@pytest.mark.parametrize('field', ['t', 'p'])
def test_homogeneous_matches_isotropic(field):
    """Homogeneous noise: the cinv filter is the isotropic 1/(C_l + N_l/b_l^2) filter
    (mirrors of tests/test_cinv.py:28 and :119, on the port alone)."""
    lmax = 48
    cls = _cls(lmax)
    geom = pgl(lmax)
    sht = PSHT(geom, lmax, device='cpu')
    nlev = 30. if field == 't' else 40.
    sig_st = nlev / 60. / 180. * np.pi
    omega = np.outer(geom.weight, np.full(geom.nphi, 2 * np.pi / geom.nphi))
    sig_pix = sig_st / np.sqrt(omega)
    rng = np.random.RandomState(1)
    ls, ms = palm._lm_indices(lmax)
    sel = ls >= 2

    def ralms(cl):
        a = (rng.standard_normal(len(ls)) + 1j * rng.standard_normal(len(ls))) / np.sqrt(2.)
        a[ms == 0] = a[ms == 0].real * np.sqrt(2.)
        a[ls < 2] = 0.
        return torch.as_tensor(a * np.sqrt(cl[ls]))
    if field == 't':
        transf = np.exp(-0.5 * np.arange(lmax + 1) * np.arange(1, lmax + 2)
                        * (10. / 60. / 180. * np.pi / 2.355) ** 2)
        tmap = sht.alm2map(palm.almxfl(ralms(cls['tt']), lmax, transf)).numpy() \
            + rng.standard_normal(omega.shape) * sig_pix
        cinv = pcinv.CinvT(lmax, geom, cls, transf, 1. / sig_pix ** 2, eps_min=1e-7,
                           iter_max=500, lmax_dense=32, device='cpu')
        got = [cinv.apply_ivf(tmap)[0]]
        ftl = cli(cls['tt'][:lmax + 1] + sig_st ** 2 * cli(transf ** 2))
        expect = [palm.almxfl(sht.map2alm(tmap), lmax, ftl * cli(transf))]
        tol = 1e-4
    else:
        q, u = sht.alm2map_spin((ralms(cls['ee']), ralms(cls['bb'])), 2)
        q = q.numpy() + rng.standard_normal(omega.shape) * sig_pix
        u = u.numpy() + rng.standard_normal(omega.shape) * sig_pix
        cinv = pcinv.CinvP(lmax, geom, cls, np.ones(lmax + 1), 1. / sig_pix ** 2,
                           eps_min=1e-7, iter_max=500, device='cpu')
        got = [a[0] for a in cinv.apply_ivf(q, u)]
        e0, b0 = sht.map2alm_spin((q, u), 2)
        expect = [palm.almxfl(e0, lmax, cli(cls['ee'][:lmax + 1] + sig_st ** 2)),
                  palm.almxfl(b0, lmax, cli(cls['bb'][:lmax + 1] + sig_st ** 2))]
        tol = 1e-3
    for a, b in zip(got, expect):
        assert _err(a[sel], b[sel]) < tol, _err(a[sel], b[sel])


def test_ninv_pol_template_deprojection():
    """Q/U template modes are nulled by the deprojected N^{-1} (mirror of
    tests/test_cinv.py:343), and apply_map equals the reference's to 1e-13 of max."""
    lmax = 32
    geom = pgl(lmax)
    omega = np.outer(geom.weight, np.full(geom.nphi, 2 * np.pi / geom.nphi))
    rng = np.random.RandomState(31)
    ninv = (1. + 0.3 * np.cos(geom.theta))[:, None] * np.ones_like(omega) / omega
    tq = np.ones((geom.nrings, geom.nphi))
    tu = np.cos(geom.theta)[:, None] * np.ones((geom.nrings, geom.nphi))
    filt = pcinv.NinvFilterP(geom, ninv, np.ones(lmax + 1), templates_q=[tq],
                             templates_u=[tu], device='cpu')
    q = rng.standard_normal((1, geom.nrings, geom.nphi))
    u = rng.standard_normal((1, geom.nrings, geom.nphi))
    nq, nu = filt.apply_map(torch.as_tensor(q), torch.as_tensor(u))
    pix = np.stack([nq[0].numpy(), nu[0].numpy()]) * omega[None]
    P = filt.templates
    coeffs = np.einsum('tarp,arp->t', P, pix)
    scale = np.einsum('tarp,arp->t', np.abs(P), np.abs(pix))
    assert np.all(np.abs(coeffs) < 1e-10 * scale), (coeffs, scale)
    ref = rcinv.NinvFilterP(rgl(lmax), ninv, np.ones(lmax + 1), templates_q=[tq],
                            templates_u=[tu])
    rq, ru = ref.apply_map(q, u)
    assert _err(nq, rq) <= 1e-13 and _err(nu, ru) <= 1e-13
    assert filt.hashdict() == ref.hashdict()
    # a (QQ, QU, UU) triplet, QU nonzero: the cross terms of N^-1 and of the deprojection
    trip = (ninv, 0.2 * ninv * np.sin(geom.theta)[:, None], 0.7 * ninv)
    filt = pcinv.NinvFilterP(geom, trip, np.ones(lmax + 1), templates_q=[tq], device='cpu')
    ref = rcinv.NinvFilterP(rgl(lmax), trip, np.ones(lmax + 1), templates_q=[tq])
    nq, nu = filt.apply_map(torch.as_tensor(q), torch.as_tensor(u))
    rq, ru = ref.apply_map(q, u)
    assert _err(nq, rq) <= 1e-13 and _err(nu, ru) <= 1e-13 and filt.nlev_ftl == ref.nlev_ftl


def test_monitored_solve_matches_loop():
    """pcg_monitored (no residual replacement) against pcg (mirror of
    tests/test_cinv.py:311): within 2 iterations, solutions within 1e-4 of max, and a
    residual history that falls."""
    lmax = 32
    cls, geom, T, Q, U, ninv, _ = _sky(lmax, 30., 0.3, 0.)
    cinv = pcinv.CinvT(lmax, pgl(lmax), cls, np.ones(lmax + 1), ninv, eps_min=1e-5,
                       iter_max=300, lmax_dense=0, marge_monopole=False, marge_dipole=False,
                       device='cpu')
    x, it, rel = cinv.solve_wf(T[:1])
    mon = pcg.monitor_basic(1e-5, iter_max=300)
    x_mon, it_mon, rel_mon = cinv.solve_wf(T[:1], monitor=mon)
    assert len(mon.history) == it_mon + 1 and mon.history[-1] < 1e-5
    assert np.all(np.diff(np.log(np.maximum(mon.history, 1e-30)))[:5] < 1.)
    assert abs(it_mon - it) <= 2
    assert _err(x_mon, x) < 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the Hopper Legendre kernels)')
    return torch.device('cuda:0')


@pytest.mark.cuda
@pytest.mark.parametrize('field', ['t', 'p'])
def test_masked_solve_on_card_matches_cpu(cuda_device, field):
    """The CG loop on the kernels K1/K2 against the loop on the CPU twins, masked, f64:
    the same iteration count, the solutions within 1e-10 of max (a well-conditioned
    case of MASKED, where the two agree to ~1e-12 between packages)."""
    case = MASKED[1] if field == 't' else MASKED[3]
    _, lmax, ld, nlev, cut, inh, marge = case
    cls, geom, T, Q, U, ninv, _ = _sky(lmax, nlev, cut, inh)
    maps = (T,) if field == 't' else (Q, U)
    out = []
    for d in (cuda_device, torch.device('cpu')):
        if field == 't':
            c = pcinv.CinvT(lmax, pgl(lmax), cls, np.ones(lmax + 1), ninv, lmax_dense=ld,
                            marge_monopole=marge, marge_dipole=marge, device=d)
        else:
            c = pcinv.CinvP(lmax, pgl(lmax), cls, np.ones(lmax + 1), ninv, lmax_dense=ld,
                            device=d)
        out.append(c.solve_wf(*maps))
    (xg, itg, _), (xc, itc, _) = out
    assert xg.is_cuda and itg == itc
    assert _err(xg.cpu(), xc) <= 1e-10
