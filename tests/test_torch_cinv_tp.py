"""Port parity of joint T/P masked filtering: plancklens_tpu_torch.models.cinv
(NinvFilterTP, CinvTP, IVFCinvJTP) against plancklens_tpu.models.cinv on identical numpy
inputs, f64, on the CPU (the plain twins of the Legendre kernels).

What holds, and to what tolerance:
  * NinvFilterTP's forward op, right-hand side and diagonal preconditioner: 1e-12 of max;
  * CinvTP at high noise (lmax 32): the same iteration count, the Wiener solution and the
    filtered alms within 1e-10 of max, with and without the dense block;
  * get_fal: 1e-12 of max; the homogeneous limit is the isotropic 3x3 filter (mirror of
    tests/test_cinv.py:154); with TE zeroed CinvTP is CinvT beside CinvP;
  * IVFCinvJTP (mirror of tests/test_cinv.py:520): alms, cacher, warm start, Wiener legs.
The dense block and the Planck-noise system: test_torch_cinv_tp_dense.py.
"""
import os

import numpy as np
import pytest
import torch

from plancklens_tpu import DATAPATH
from plancklens_tpu.utils import camb_clfile, cli, cl_inverse, alm as ralm
from plancklens_tpu.ops.sht import SHT as RSHT, gl_geometry as rgl
from plancklens_tpu.models import cinv as rcinv
from plancklens_tpu_torch.ops.sht import gl_geometry as pgl
from plancklens_tpu_torch.models import cinv as pcinv
from plancklens_tpu_torch.utils.cachers import cacher_mem

torch.set_num_threads(1)


def _err(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return np.abs(a - ref).max() / np.abs(ref).max()


def _cls(lmax):
    return camb_clfile(os.path.join(DATAPATH, 'cls', 'FFP10_wdipole_lensedCls.dat'),
                       lmax=lmax)


def _sky(lmax, nlev, cut, inh, seed=5, pol_fac=1.4, nmaps=2):
    """cls, geometry, nmaps T/Q/U maps (correlated T/E signal + white noise of `nlev`
    uK-arcmin in T, pol_fac x that in Q/U) and the T and P inverse pixel-variance maps with
    a (1 + inh cos theta) modulation and the cut |cos theta| > cut: host numpy."""
    cls = _cls(lmax)
    geom = rgl(lmax)
    sht = RSHT(geom, lmax)
    omega = np.outer(geom.weight, np.full(geom.nphi, 2 * np.pi / geom.nphi))
    sig = (nlev / 60. / 180. * np.pi) / np.sqrt(omega)
    rng = np.random.RandomState(seed)
    ls, ms = ralm._lm_indices(lmax)

    def unit():
        a = rng.standard_normal((nmaps, len(ls))) + 1j * rng.standard_normal((nmaps, len(ls)))
        a[:, ms == 0] = a[:, ms == 0].real * np.sqrt(2.)
        return a / np.sqrt(2.)
    tt, ee, te = cls['tt'][ls], cls['ee'][ls], cls['te'][ls]
    u1, u2 = unit(), unit()
    tlm = u1 * np.sqrt(tt)
    elm = u1 * te * cli(np.sqrt(tt)) + u2 * np.sqrt(np.maximum(ee - te ** 2 * cli(tt), 0.))
    blm = unit() * np.sqrt(cls['bb'][ls])
    T = np.asarray(sht.alm2map(tlm)) + rng.standard_normal((nmaps,) + omega.shape) * sig
    q, u = sht.alm2map_spin((elm, blm), 2)
    Q = np.asarray(q) + rng.standard_normal((nmaps,) + omega.shape) * sig * pol_fac
    U = np.asarray(u) + rng.standard_normal((nmaps,) + omega.shape) * sig * pol_fac
    mod = (1. + inh * np.cos(geom.theta))[:, None] * (np.abs(np.cos(geom.theta))[:, None] > cut)
    ninv_t = mod / sig ** 2
    ninv_p = mod / (sig * pol_fac) ** 2
    return cls, geom, T, Q, U, ninv_t, ninv_p, rng


def _pair(lmax, cls, geom, ninv_t, ninv_p, cacher=None, rcacher=None, **kw):
    r = rcinv.CinvTP(lmax, geom, cls, np.ones(lmax + 1), ninv_t, ninv_p,
                     dense_cacher=rcacher, **kw)
    p = pcinv.CinvTP(lmax, pgl(lmax), cls, np.ones(lmax + 1), ninv_t, ninv_p,
                     dense_cacher=cacher, device='cpu', **kw)
    return r, p


def test_ninv_filter_tp_ops_match_reference():
    """Forward op, right-hand side and diagonal preconditioner of the joint operator, with
    T monopole/dipole and a Q template deprojected: 1e-12 of max."""
    lmax = 24
    cls, geom, T, Q, U, ninv_t, ninv_p, rng = _sky(lmax, 40., 0.2, 0.5)
    tq = [np.cos(geom.theta)[:, None] * np.ones((1, geom.nphi))]
    kw = dict(marge_monopole=True, marge_dipole=True, templates_q=tq)
    tf = np.exp(-0.5 * np.arange(lmax + 1) ** 2 * 1e-4)
    rf = rcinv.NinvFilterTP(geom, ninv_t, ninv_p, tf, **kw)
    pf = pcinv.NinvFilterTP(pgl(lmax), ninv_t, ninv_p, tf, device='cpu', **kw)
    assert pf.hashdict() == rf.hashdict()
    rops, pops = rf.make_ops(lmax, cls), pf.make_ops(lmax, cls)
    nalm = ralm.getsize(lmax)
    x = rng.standard_normal((2, 3, nalm)) + 1j * rng.standard_normal((2, 3, nalm))
    xt = torch.as_tensor(x)
    got = pops[0](xt)
    assert got.dtype == torch.complex128
    assert _err(got, rops[0](x)) <= 1e-12, _err(got, rops[0](x))
    assert _err(pops[1](T, Q, U), rops[1](T, Q, U)) <= 1e-12
    assert _err(pops[2](xt), rops[2](x)) <= 1e-12
    assert np.array_equal(pops[3][0], rops[3][0])
    assert _err(pops[3][1], rops[3][1]) == 0.


HN_LMAX = 32


@pytest.fixture(scope='module')
def high_noise():
    """lmax 32, 3000 uK-arcmin over the cut: the sky and the two packages' filters without
    a dense block (one reference instance, so its solves compile once)."""
    cls, geom, T, Q, U, ninv_t, ninv_p, _ = _sky(HN_LMAX, 3000., 0.2, 0.5)
    r, p = _pair(HN_LMAX, cls, geom, ninv_t, ninv_p, eps_min=1e-5)
    return cls, geom, (T, Q, U), (ninv_t, ninv_p), r, p


@pytest.mark.parametrize('lmax_dense', [0, 8])
def test_cinv_tp_high_noise_matches_reference(lmax_dense, high_noise):
    """lmax 32, 3000 uK-arcmin over the cut: the same iteration count, the Wiener solution
    and the three filtered alms within 1e-10 of max; the filter's accessors as the
    reference's."""
    lmax = HN_LMAX
    cls, geom, (T, Q, U), (ninv_t, ninv_p), r, p = high_noise
    if lmax_dense:
        # the port loads the reference's dense block (the blocks themselves are held to
        # each other in test_dense_tp_block_from_reference_loads_in_port: their inverses
        # differ by the probes' rounding times the block's condition, ~2e7 here)
        shared = cacher_mem()
        r, p = _pair(lmax, cls, geom, ninv_t, ninv_p, cacher=shared, rcacher=shared,
                     eps_min=1e-5, lmax_dense=lmax_dense)
        assert len(shared._cache) == 1
    assert p.hashdict() == r.hashdict()
    (rout, rit, rrel, rx) = r.apply_ivf(T, Q, U, ret_it=True, ret_wf=True)
    (pout, pit, prel, px) = p.apply_ivf(T, Q, U, ret_it=True, ret_wf=True)
    assert pit == int(rit) and 3 < pit < 400, (pit, int(rit))
    assert px.dtype == torch.complex128 and tuple(px.shape) == tuple(rx.shape)
    assert np.all(prel.numpy() <= 1e-5)
    assert _err(px, rx) <= 1e-10, _err(px, rx)
    for a, b in zip(pout, rout):
        assert _err(a, b) <= 1e-10, _err(a, b)
    assert np.array_equal(p.get_fmask(), np.asarray(r.get_fmask()))
    for k in ('get_ftl', 'get_fel', 'get_fbl'):
        assert _err(getattr(p, k)(), getattr(r, k)()) <= 1e-12


def test_get_fal_matches_reference():
    """The isotropic 3x3 filter of a masked inhomogeneous configuration: the same keys,
    1e-12 of max; the T-only accessors of the T/P adapter as the reference's."""
    lmax = 32
    cls, geom, T, Q, U, ninv_t, ninv_p, _ = _sky(lmax, 35., 0.2, 0.5)
    cls = dict(cls, tb=0.01 * cls['te'])
    r, p = _pair(lmax, cls, geom, ninv_t, ninv_p)
    rf, pf = r.get_fal(), p.get_fal()
    assert sorted(pf) == sorted(rf) and {'tt', 'te', 'tb', 'ee', 'bb'} <= set(pf)
    for k in rf:
        assert _err(pf[k], rf[k]) <= 1e-12, (k, _err(pf[k], rf[k]))


def test_cinv_tp_homogeneous_matches_jtp_isotropic():
    """Homogeneous noise, full sky: the joint CG filter is the isotropic 3x3 filter
    F = (S + N)^{-1} (TE included) applied to the maps' alms, within 1e-3 of max at l >= 2
    (mirror of tests/test_cinv.py:154)."""
    lmax = 40
    cls, geom, T, Q, U, _, _, _ = _sky(lmax, 30., 0., 0., pol_fac=40. / 30., nmaps=1)
    st, sp = 30. / 60. / 180. * np.pi, 40. / 60. / 180. * np.pi
    omega = np.outer(geom.weight, np.full(geom.nphi, 2 * np.pi / geom.nphi))
    p = pcinv.CinvTP(lmax, pgl(lmax), cls, np.ones(lmax + 1), omega / st ** 2,
                     omega / sp ** 2, eps_min=1e-8, iter_max=500, device='cpu')
    bar, it, rel = p.apply_ivf(T, Q, U, ret_it=True)
    assert np.all(rel.numpy() < 1e-7), rel
    cls_dat = {'tt': cls['tt'] + st ** 2, 'ee': cls['ee'] + sp ** 2,
               'bb': cls['bb'] + sp ** 2, 'te': np.copy(cls['te'])}
    fal = cl_inverse(cls_dat)
    sht = RSHT(geom, lmax)
    x = np.stack([np.asarray(sht.map2alm(T[0]))]
                 + [np.asarray(a) for a in sht.map2alm_spin((Q[0], U[0]), 2)])
    F = np.zeros((lmax + 1, 3, 3))
    F[:, 0, 0], F[:, 1, 1], F[:, 2, 2] = fal['tt'], fal['ee'], fal['bb']
    F[:, 0, 1] = F[:, 1, 0] = fal['te']
    ls, _ = ralm._lm_indices(lmax)
    expect = np.einsum('aij,ja->ia', F[ls], x)
    sel = ls >= 2
    for got, exp in zip(bar, expect):
        got = got[0].numpy()
        assert np.abs(got[sel] - exp[sel]).max() / np.abs(exp[sel]).max() < 1e-3


def test_cinv_tp_without_te_is_cinv_t_beside_cinv_p():
    """With cls['te'] zeroed the joint system splits: CinvTP's filtered alms equal CinvT's
    (monopole and dipole marginalised in both) and CinvP's, all solved to eps 1e-10."""
    lmax = 24
    cls, geom, T, Q, U, ninv_t, ninv_p, _ = _sky(lmax, 3000., 0.2, 0.5)
    cls = dict(cls, te=np.zeros_like(cls['te']))
    g, tf = pgl(lmax), np.ones(lmax + 1)
    tp = pcinv.CinvTP(lmax, g, cls, tf, ninv_t, ninv_p, eps_min=1e-10, iter_max=800,
                      marge_monopole=True, marge_dipole=True, device='cpu')
    ct = pcinv.CinvT(lmax, g, cls, tf, ninv_t, eps_min=1e-10, iter_max=800, lmax_dense=0,
                     device='cpu')
    cp = pcinv.CinvP(lmax, g, cls, tf, ninv_p, eps_min=1e-10, iter_max=800, device='cpu')
    (t, e, b), it, _ = tp.apply_ivf(T, Q, U, ret_it=True)
    (t2, it_t, _), ((e2, b2), it_p, _) = ct.apply_ivf(T, ret_it=True), \
        cp.apply_ivf(Q, U, ret_it=True)
    assert it < 800 and it_t < 800 and it_p < 800, (it, it_t, it_p)
    for a, ref in ((t, t2), (e, e2), (b, b2)):
        assert _err(a, ref) <= 1e-8, _err(a, ref)
    assert 'te' not in tp.get_fal()


class _Sims:
    def __init__(self, T, Q, U):
        self.T, self.Q, self.U = T, Q, U

    def get_sim_tmap(self, idx):
        return self.T[idx]

    def get_sim_pmap(self, idx):
        return self.Q[idx], self.U[idx]

    def hashdict(self):
        return {'sims': 'two'}


class _NoSims(_Sims):
    def get_sim_tmap(self, idx):
        raise AssertionError('should have been served from the cacher')
    get_sim_pmap = get_sim_tmap


def test_ivf_cinv_jtp_adapter_matches_reference(high_noise):
    """IVFCinvJTP (mirror of tests/test_cinv.py:520): the bar alms of two sims and the
    joint Wiener legs (with tb/eb weights) within 1e-10 of the reference's; the alm cacher
    under the reference's names serves a second library; the CG solution cached as
    wf_tp_%05d warm-starts a re-solve."""
    from plancklens_tpu.utils.cachers import cacher_mem as rcacher_mem
    lmax = HN_LMAX
    cls, geom, (T, Q, U), _, r, p = high_noise
    clw = dict(cls, tb=0.1 * cls['te'], eb=0.05 * cls['ee'])
    sims = _Sims(T, Q, U)
    rl = rcinv.IVFCinvJTP(r, sims, clw, cacher=rcacher_mem())
    cacher, soltn = cacher_mem(), cacher_mem()
    pl = pcinv.IVFCinvJTP(p, sims, clw, cacher=cacher, soltn_cacher=soltn)
    assert pl.hashdict() == rl.hashdict()
    for i in (0, 1):
        for k in ('tlm', 'elm', 'blm', 'tmliklm', 'emliklm', 'bmliklm'):
            a, b = getattr(pl, 'get_sim_' + k)(i), getattr(rl, 'get_sim_' + k)(i)
            assert a.dtype == torch.complex128
            assert _err(a, b) <= 1e-10, (i, k, _err(a, b))
    tb = pl.get_sim_teblm_batch([1, 0])
    assert torch.equal(tb[2][0], pl.get_sim_blm(1)) and torch.equal(tb[0][1], pl.get_sim_tlm(0))
    assert sorted(cacher._cache) == sorted('ivf_%slm_%05d' % (a, i) for a in 'teb'
                                           for i in (0, 1))
    pl2 = pcinv.IVFCinvJTP(p, _NoSims(T, Q, U), clw, cacher=cacher)
    assert torch.equal(pl2.get_sim_elm(1), pl.get_sim_elm(1))
    # the cached solution is the Wiener solution of sim 0: a warm re-solve converges at once
    x0 = soltn.load('wf_tp_00000')
    assert x0.shape == (1, 3, ralm.getsize(lmax))
    _, it_warm, _ = p.solve_wf(T[0], Q[0], U[0], x0=x0)
    _, it_cold, _ = p.solve_wf(T[0], Q[0], U[0])
    assert it_warm < it_cold and it_warm <= 2, (it_warm, it_cold)
    assert np.array_equal(pl.get_tal('e'), np.ones(lmax + 1))
    assert _err(pl.get_fal()['te'], rl.get_fal()['te']) <= 1e-12
