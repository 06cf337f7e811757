"""Port parity of the preconditioner grammar, the multigrid chains and the
conjugate-directions solver: plancklens_tpu_torch.models.cinv (parse_pre_op_descr,
_split_top_level, degrade_ninv, make_multigrid_pre_op, make_multigrid_pre_op_p) and
plancklens_tpu_torch.ops.cd against plancklens_tpu on identical numpy inputs, f64, on the
CPU (mirrors of tests/test_cinv.py:366, :448, :622, tests/test_round5_review.py:43 and
tests/test_cd.py).

Preconditioners built from descriptors are held to the reference's on the same vectors
(1e-10 of max; the dense blocks are inverted on the host by the same code), the
multigrid chains to 1e-10 of max, and cd_solve's trajectory to the port's own PCG and to
the reference's cd_solve (1e-8 relative per iterate).
"""
import os

import numpy as np
import pytest
import torch

from plancklens_tpu import DATAPATH
from plancklens_tpu.utils import camb_clfile, alm as ralm
from plancklens_tpu.ops.sht import gl_geometry as rgl
from plancklens_tpu.models import cinv as rcinv
from plancklens_tpu.ops import cd as rcd, cg as rcg
from plancklens_tpu_torch.ops.sht import gl_geometry as pgl
from plancklens_tpu_torch.models import cinv as pcinv
from plancklens_tpu_torch.ops import cd as pcd, cg as pcg
from plancklens_tpu_torch.utils.cachers import cacher_mem

torch.set_num_threads(1)


def _err(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return np.abs(a - ref).max() / np.abs(ref).max()


def _cls(lmax):
    return camb_clfile(os.path.join(DATAPATH, 'cls', 'FFP10_wdipole_lensedCls.dat'),
                       lmax=lmax)


def _masked(lmax, nlev, cut=0.2):
    geom = rgl(lmax)
    omega = np.outer(geom.weight, np.full(geom.nphi, 2 * np.pi / geom.nphi))
    sig = (nlev / 60. / 180. * np.pi) / np.sqrt(omega)
    return geom, sig, (1. / sig ** 2) * (np.abs(np.cos(geom.theta))[:, None] > cut)


def _alms(n, lmax, seed, ncomp=None):
    rng = np.random.RandomState(seed)
    shape = (n,) + ((ncomp,) if ncomp else ()) + (ralm.getsize(lmax),)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def test_split_top_level_matches_reference():
    """Balanced top-level splitting, quoted keys with commas, unbalanced input refused
    (mirror of tests/test_round5_review.py:43)."""
    for s in ('dense, 24, split(dense, 8, diag_cl)', 'split(dense(k), 8, diag_cl), 24, diag_cl',
              'dense("a,b"), 64, diag_cl'):
        assert pcinv._split_top_level(s) == rcinv._split_top_level(s)
    assert pcinv._split_top_level('dense("a,b"), 64, diag_cl')[0] == 'dense("a,b")'
    for bad in ('dense(, 8, diag_cl', 'dense), 8, (diag_cl'):
        with pytest.raises(AssertionError):
            pcinv._split_top_level(bad)


def test_parse_pre_op_descr_t_matches_reference_and_builtin_wiring():
    """CinvT: 'split(dense, 24, diag_cl)' builds what lmax_dense=24 wires (1e-12) and what
    the reference builds (1e-10 of max); nested all-diag splits equal the diagonal;
    'diag_cl', 'stage(i)' and unknown descriptors behave as in the reference (mirror of
    tests/test_cinv.py:622)."""
    lmax = 40
    cls = _cls(lmax)
    geom, _, ninv = _masked(lmax, 30.)
    kw = dict(marge_monopole=False, marge_dipole=False)
    built = pcinv.CinvT(lmax, pgl(lmax), cls, np.ones(lmax + 1), ninv, lmax_dense=24,
                        device='cpu', **kw)
    plain = pcinv.CinvT(lmax, pgl(lmax), cls, np.ones(lmax + 1), ninv, lmax_dense=0,
                        device='cpu', **kw)
    rplain = rcinv.CinvT(lmax, geom, cls, np.ones(lmax + 1), ninv, lmax_dense=0, **kw)
    r = _alms(2, lmax, 5)
    parsed = pcinv.parse_pre_op_descr('split(dense, 24, diag_cl)', plain)
    rparsed = rcinv.parse_pre_op_descr('split(dense, 24, diag_cl)', rplain)
    got = parsed(torch.as_tensor(r))
    assert _err(got, built.pre_op(torch.as_tensor(r))) <= 1e-12
    assert _err(got, rparsed(r)) <= 1e-10, _err(got, rparsed(r))
    nested = pcinv.parse_pre_op_descr('split(diag_cl, 8, split(diag_cl, 16, diag_cl))', plain)
    assert torch.equal(nested(torch.as_tensor(r)), plain.pre_diag(torch.as_tensor(r)))
    assert pcinv.parse_pre_op_descr('diag_cl', plain) is plain.pre_diag
    assert pcinv.parse_pre_op_descr('stage(0)', plain, stages=[plain.pre_diag]) \
        is plain.pre_diag
    with pytest.raises(ValueError):
        pcinv.parse_pre_op_descr('nonsense', plain)
    # a named dense block lands in the cacher under that name, a default one under the
    # reference's key
    c = cacher_mem()
    pcinv.parse_pre_op_descr('split(dense(blk), 8, diag_cl)', plain, dense_cacher=c)
    rc = {}

    class _Rc:
        def is_cached(self, k):
            return k in rc

        def cache(self, k, v):
            rc[k] = v

        def load(self, k):
            return rc[k]
    pcinv.parse_pre_op_descr('split(dense, 8, diag_cl)', plain, dense_cacher=c)
    rcinv.parse_pre_op_descr('split(dense, 8, diag_cl)', rplain, dense_cacher=_Rc())
    assert sorted(c._cache) == sorted(['blk'] + list(rc))


@pytest.mark.parametrize('kind', ['p', 'tp'])
def test_parse_pre_op_descr_stacked_matches_reference(kind):
    """CinvP and CinvTP: 'split(dense, 8, diag_cl)' with the probed block; the port loads
    the reference's block under the reference's key and preconditions as it does (1e-10 of
    max); its own probe agrees with the block to the block's conditioning."""
    lmax = 24
    cls = _cls(lmax)
    geom, _, ninv = _masked(lmax, 300.)
    tf = np.ones(lmax + 1)
    if kind == 'p':
        r_s = rcinv.CinvP(lmax, geom, cls, tf, ninv)
        p_s = pcinv.CinvP(lmax, pgl(lmax), cls, tf, ninv, device='cpu')
        ncomp = 2
    else:
        r_s = rcinv.CinvTP(lmax, geom, cls, tf, ninv, ninv)
        p_s = pcinv.CinvTP(lmax, pgl(lmax), cls, tf, ninv, ninv, device='cpu')
        ncomp = 3
    shared = cacher_mem()
    d = 'split(dense, 8, diag_cl)'
    rpre = rcinv.parse_pre_op_descr(d, r_s, dense_cacher=shared)
    ppre = pcinv.parse_pre_op_descr(d, p_s, dense_cacher=shared)
    assert len(shared._cache) == 1
    x = _alms(2, lmax, 7, ncomp)
    got = ppre(torch.as_tensor(x))
    assert _err(got, rpre(x)) <= 1e-10, _err(got, rpre(x))
    own = cacher_mem()
    pcinv.parse_pre_op_descr(d, p_s, dense_cacher=own)
    assert list(own._cache) == list(shared._cache)


def test_degrade_ninv_matches_reference():
    """The spectral restriction of an inverse-variance map to a coarser ring grid."""
    geom, _, ninv = _masked(48, 30.)
    a = pcinv.degrade_ninv(ninv, pgl(48), pgl(24), device='cpu')
    b = rcinv.degrade_ninv(ninv, geom, rgl(24))
    assert a.shape == b.shape and _err(a, b) <= 1e-12


def test_multigrid_pre_op_matches_reference():
    """make_multigrid_pre_op (one coarse stage at l 16, 3 iterations, dense block to l 8)
    on the masked T system: the chain applied to vectors within 1e-10 of the reference's,
    non-zero above the coarse stage, and faster than no preconditioning (mirror of
    tests/test_cinv.py:366)."""
    lmax = 24
    cls = _cls(lmax)
    geom, sig, ninv = _masked(lmax, 30.)
    tf = np.ones(lmax + 1)
    args = (ninv, tf, cls['tt'], lmax, [16], [3])
    mg = pcinv.make_multigrid_pre_op(pgl(lmax), *args, lmax_dense=8, device='cpu')
    rmg = rcinv.make_multigrid_pre_op(geom, *args, lmax_dense=8)
    r = _alms(2, lmax, 3)
    got = mg(torch.as_tensor(r))
    assert _err(got, rmg(r)) <= 1e-10, _err(got, rmg(r))
    ls, _ = ralm._lm_indices(lmax)
    assert float(got[:, torch.as_tensor(ls > 16)].abs().max()) > 0.
    filt = pcinv.NinvFilterT(pgl(lmax), ninv, tf, marge_monopole=False, marge_dipole=False,
                             device='cpu')
    fwd, prep, _, _ = filt.make_ops(lmax, cls['tt'])
    b = prep(np.random.RandomState(4).standard_normal((1, geom.nrings, geom.nphi)) * sig)
    ms = torch.as_tensor(ralm._lm_indices(lmax)[1])
    _, _, rel_mg = pcg.pcg(fwd, mg, b, torch.zeros_like(b), 15, 1e-12, ms)
    _, _, rel_id = pcg.pcg(fwd, lambda x: x, b, torch.zeros_like(b), 15, 1e-12, ms)
    assert float(rel_mg.max()) < float(rel_id.max()), (rel_mg, rel_id)


def test_multigrid_pre_op_p_matches_reference():
    """make_multigrid_pre_op_p on the coupled E/B system: within 1e-10 of the reference's
    on stacked vectors, non-zero above the coarse stage in E and B (mirror of
    tests/test_cinv.py:448)."""
    lmax = 16
    cls = _cls(lmax)
    geom, _, ninv = _masked(lmax, 30.)
    args = (ninv, np.ones(lmax + 1), cls['ee'], cls['bb'], lmax, [12], [2])
    mg = pcinv.make_multigrid_pre_op_p(pgl(lmax), *args, lmax_dense=4, device='cpu')
    rmg = rcinv.make_multigrid_pre_op_p(geom, *args, lmax_dense=4)
    r = _alms(1, lmax, 8, 2)
    got = mg(torch.as_tensor(r))
    assert _err(got, rmg(r)) <= 1e-10, _err(got, rmg(r))
    ls, _ = ralm._lm_indices(lmax)
    hi = torch.as_tensor(ls > 12)
    assert float(got[0, 0, hi].abs().max()) > 0. and float(got[0, 1, hi].abs().max()) > 0.


def _spd(n, cond, seed=0):
    rng = np.random.RandomState(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return q @ np.diag(np.geomspace(1., cond, n)) @ q.T


@pytest.mark.parametrize('tr', ['tr_cg', 'tr_cd', 'ptr'])
def test_cd_solve_matches_reference_on_spd(tr):
    """cd_solve on an SPD system with a two-preconditioner panel and each policy: on numpy
    vectors the reference's iterates exactly (the same code); on torch vectors (another
    BLAS, so another rounding) converged to the same tolerance and within 1e-6 of the
    exact solution (mirror of tests/test_cd.py)."""
    n = 30
    A = _spd(n, 1e3, seed=2)
    b = np.random.RandomState(3).standard_normal(n)
    lo = 10
    Ainv = [np.linalg.inv(A[:lo, :lo]), np.linalg.inv(A[lo:, lo:])]

    def pres(asarr):
        def low(r):
            out = r * 0.
            out[:lo] = asarr(Ainv[0]) @ r[:lo]
            return out

        def high(r):
            out = r * 0.
            out[lo:] = asarr(Ainv[1]) @ r[lo:]
            return out
        return [low, high]
    pol = {'tr_cg': (pcd.tr_cg, rcd.tr_cg), 'tr_cd': (pcd.tr_cd, rcd.tr_cd),
           'ptr': (pcd.ptr(3, 6, 10), rcd.ptr(3, 6, 10))}[tr]
    ndot = lambda u, v: float(np.sum(u * v))
    x, it = pcd.cd_solve(np.zeros(n), b, lambda v: A @ v, pres(np.asarray), ndot,
                         pcd.criterion_rel(1e-9, ndot, b, iter_max=200), tr=pol[0])
    rx, rit = rcd.cd_solve(np.zeros(n), b, lambda v: A @ v, pres(np.asarray), ndot,
                           rcd.criterion_rel(1e-9, ndot, b, iter_max=200), tr=pol[1])
    assert it == rit and it < 200 and np.array_equal(x, rx), (it, rit)
    tdot = lambda u, v: float((u * v).sum())
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    xt, itt = pcd.cd_solve(torch.zeros(n, dtype=torch.float64), bt, lambda v: At @ v,
                           pres(torch.as_tensor), tdot,
                           pcd.criterion_rel(1e-9, tdot, bt, iter_max=200), tr=pol[0])
    resid = bt - At @ xt
    assert itt < 200 and np.sqrt(tdot(resid, resid) / tdot(bt, bt)) < 1e-9
    exact = np.linalg.solve(A, b)
    assert np.abs(xt.numpy() - exact).max() < 1e-6 * np.abs(exact).max()


def test_cd_tr_cg_matches_pcg_trajectory_and_reference():
    """On a masked T cinv system with the split(dense, diag) preconditioner, cd_solve with
    tr_cg retraces the port's PCG residual history (1e-6 relative per iterate, as the
    reference's test holds its own) and the reference's cd_solve (1e-8)."""
    lmax = 32
    cls = _cls(lmax)
    geom, sig, ninv = _masked(lmax, 35.)
    kw = dict(eps_min=1e-6, iter_max=300, lmax_dense=12, marge_monopole=False,
              marge_dipole=False)
    shared = cacher_mem()
    cinv = pcinv.CinvT(lmax, pgl(lmax), cls, np.ones(lmax + 1), ninv, dense_cacher=shared,
                       device='cpu', **kw)
    rcinv_ = rcinv.CinvT(lmax, geom, cls, np.ones(lmax + 1), ninv, dense_cacher=shared, **kw)
    tmap = np.random.RandomState(5).standard_normal((1, geom.nrings, geom.nphi)) * sig[None]
    b = cinv.calc_prep(tmap)
    dot = lambda u, v: float(pcg.dot_alm(u, v, cinv._ms)[0])
    b0 = dot(b, b)
    mon = pcg.monitor_basic(eps_min=1e-12, iter_max=30)
    pcg.pcg_monitored(cinv.fwd_op, cinv.pre_op, b, torch.zeros_like(b), cinv._ms, mon)
    rel_pcg = np.asarray(mon.history)

    def trace(dotf, b_, store):
        def crit(it, x, resid):
            store.append(float(np.sqrt(dotf(resid, resid) / dotf(b_, b_))))
            return it >= 30
        return crit
    rel_cd, rel_ref = [], []
    pcd.cd_solve(torch.zeros_like(b), b, cinv.fwd_op, [cinv.pre_op], dot,
                 trace(dot, b, rel_cd), tr=pcd.tr_cg, roundoff=0)
    rb = rcinv_.calc_prep(tmap)
    rdot = lambda u, v: float(np.asarray(rcg.dot_alm(u, v, rcinv_._ms))[0])
    rcd.cd_solve(rb * 0., rb, rcinv_.fwd_op, [rcinv_.pre_op], rdot, trace(rdot, rb, rel_ref),
                 tr=rcd.tr_cg, roundoff=0)
    n = min(len(rel_pcg), len(rel_cd))
    assert n > 20 and b0 > 0.
    assert np.allclose(rel_pcg[:n], rel_cd[:n], rtol=1e-6)
    assert np.allclose(np.asarray(rel_cd), np.asarray(rel_ref), rtol=1e-8), \
        np.abs(np.asarray(rel_cd) / np.asarray(rel_ref) - 1.).max()
