"""Port parity of the lensed spectra (ops/lensed_cls) and the N0 forecasts (models/n0s)
against plancklens_tpu, f64 on the CPU:

  * `lensed_cls` (nterms 2, and delta_cls) at an input band limit of 600, output 300:
    TT/EE/TE <= 1e-10 of their max; BB <= 1e-10 of max |EE|. BB is half the difference
    of the xi+ and xi- analyses, each of EE's size, so it carries their rounding (the two
    packages' d-matrices differ by ~1e-13, from different recursion code) amplified by
    EE/BB ~ 1e3: measured 2e-10 of BB's own max, ~1e-13 of EE's;
  * `get_N0` (ptt, p_p and the joint-TP p, gradient and curl; separate TP; a Wiener-leg
    T cut) <= 1e-10, and `get_N0_iter` (ptt and p_p, gradient and curl, with the
    delensed spectra) and its include_n1 path (`DelensingForecast._n1_raw` on the port's
    N1Lib) <= 1e-8, in two ways: 1/N0 (the estimator's inverse-noise weight) relative to
    its max, and N0 relative at every L from 10 to the CMB band limit lmax_ivf. Where the
    response R_L is small, N0 = N/R^2 carries the two packages' d-matrix rounding
    amplified: at low L, where R_L is a small difference of large Wigner sums, as 1/L^2
    (get_N0: 1.7e-9 at L = 1, 1.1e-10 at L = 3, 1.1e-11 at L = 10; the curl of ptt at
    L = 1: 2.3e-4), and for the curl keys towards 2 lmax_ivf, where the curl response
    vanishes (get_N0_iter ptt at lmax_ivf 200: 1.2e-12 at L = 200, 3.4e-8 at 380, 1.3e-3
    at 400);
  * the helpers `_per_field`, `_pol_nlevs`, `_bandpass` and `SpectralFilter`.
tests/test_torch_n0s_anchors.py holds the port against FFP10's lensed spectra and the
pinned get_N0_iter anchors.
"""
import os

import numpy as np
import pytest
import torch

import plancklens_tpu
from plancklens_tpu.utils import camb_clfile
from plancklens_tpu.ops.lensed_cls import lensed_cls as rlensed
from plancklens_tpu.models import n0s as rn0s
from plancklens_tpu_torch.ops.lensed_cls import lensed_cls as plensed
from plancklens_tpu_torch.models import n0s as pn0s

torch.set_num_threads(1)

CPU = torch.device('cpu')


def _rel(a, ref, scale=None):
    a, ref = np.asarray(a, dtype=float), np.asarray(ref, dtype=float)
    return np.abs(a - ref).max() / (np.abs(ref).max() if scale is None else scale)


def _n0_close(a, b, tol, lmax, lmin=10):
    """1/N0 within tol of its max, and N0 within tol relative at every lmin <= L <= lmax."""
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    ok = np.isfinite(b) & (b != 0.)
    assert np.array_equal(np.isfinite(a), np.isfinite(b))
    ia, ib = 1. / a[ok], 1. / b[ok]
    hi = ok.copy()
    hi[:lmin] = False
    hi[lmax + 1:] = False
    return max(_rel(ia, ib), np.max(np.abs(a[hi] / b[hi] - 1.))) <= tol


def _unl(lmax):
    return camb_clfile(os.path.join(plancklens_tpu.DATAPATH, 'cls',
                                    'FFP10_wdipole_lenspotentialCls.dat'), lmax=lmax)


@pytest.mark.parametrize('delta', [False, True])
def test_lensed_cls_matches_reference(delta):
    unl = _unl(600)
    r = rlensed(unl, unl['pp'], lmax_out=300, delta_cls=delta)
    p = plensed(unl, unl['pp'], lmax_out=300, delta_cls=delta, device=CPU)
    assert set(p) == set(r) == {'tt', 'ee', 'bb', 'te'}
    # delta_cls = lensed - unlensed: held to the lensed spectra's scale, as BB to EE's
    scale = rlensed(unl, unl['pp'], lmax_out=300) if delta else r
    for k in ('tt', 'ee', 'te', 'bb'):
        top = np.abs(scale['ee' if k == 'bb' else k]).max()
        assert p[k].shape == (301,) and _rel(p[k], r[k], top) <= 1e-10, (k, _rel(p[k], r[k], top))


def test_lensed_cls_default_band_limit():
    unl = _unl(120)
    r, p = rlensed(unl, unl['pp']), plensed(unl, unl['pp'], device=CPU)
    assert len(p['tt']) == len(r['tt']) == 71        # min(lmax - 50, 500) for short inputs
    assert _rel(p['tt'], r['tt']) <= 1e-10


def test_get_n0_matches_reference():
    kw = dict(beam_fwhm=5., nlev_t=35., nlev_p=55., lmax_CMB=300, lmin_CMB=30, lmax_out=300)
    for extra in ({}, {'joint_TP': False}, {'wfleg_Tcut': 200}):
        rN, rC = rn0s.get_N0(**kw, **extra)
        pN, pC = pn0s.get_N0(**kw, **extra, device=CPU)
        assert sorted(pN) == sorted(rN) == ['p', 'p_p', 'ptt']
        for k in rN:
            for a, b in ((pN[k], rN[k]), (pC[k], rC[k])):
                assert _n0_close(a, b, 1e-10, 300), (extra, k)


def test_helpers_match_reference():
    for v in (3, {'t': 2, 'e': 5, 'b': 7}):
        assert pn0s._per_field(v, floor=4) == rn0s._per_field(v, floor=4)
    for v in (55., (50., 60.), np.ones((2, 10))):
        for a, b in zip(pn0s._pol_nlevs(v), rn0s._pol_nlevs(v)):
            assert np.array_equal(a, b)
    cls = {k: np.ones(20) for k in ('tt', 'ee', 'te')}
    lo, hi = {'t': 3, 'e': 5, 'b': 2}, {'t': 15, 'e': 12, 'b': 19}
    for k, v in pn0s._bandpass({k: v.copy() for k, v in cls.items()}, lo, hi).items():
        assert np.array_equal(v, rn0s._bandpass({k: v.copy() for k, v in cls.items()},
                                                lo, hi)[k])
    assert np.array_equal(pn0s.gauss_beam(5., 100), rn0s.gauss_beam(5., 100))
    cl = {k: np.linspace(1., 2., 30) for k in ('tt', 'ee', 'bb')}
    cl['te'] = 0.3 * cl['tt']
    for meth in ('separate', 'joint'):
        p = getattr(pn0s.SpectralFilter, meth)(cl, cl, wf_tcut=20)
        r = getattr(rn0s.SpectralFilter, meth)(cl, cl, wf_tcut=20)
        for leg in ('gg', 'gw', 'wg', 'ww'):
            for k in r.cov[leg]:
                assert np.allclose(p.cov[leg][k], r.cov[leg][k], rtol=1e-14, atol=0)


@pytest.mark.parametrize('key', ['ptt', 'p_p'])
def test_get_n0_iter_matches_reference(key):
    unl = _unl(700)
    args = (key, 1.0, 1.4, 2.0, unl, 30, 200, 1)
    r = rn0s.get_N0_iter(*args, ret_curl=True, ret_delcls=True)
    p = pn0s.get_N0_iter(*args, ret_curl=True, ret_delcls=True, device=CPU)
    assert len(p) == len(r) == 6
    for i in range(4):
        assert np.asarray(p[i]).shape == np.asarray(r[i]).shape
        for a, b in zip(p[i], r[i]):
            assert _n0_close(a, b, 1e-8, 200), (key, i)
    for pd, rd in zip(p[4] + p[5], r[4] + r[5]):
        for k in ('tt', 'ee', 'te', 'bb', 'pp'):
            top = np.abs(rd['ee' if k == 'bb' else k]).max()
            assert _rel(pd[k], rd[k], top) <= 1e-8, (key, k, _rel(pd[k], rd[k], top))


def test_get_n0_iter_include_n1_matches_reference():
    """The iterated N1 (DelensingForecast._n1_raw on the port's N1Lib)."""
    unl = _unl(300)
    kw = dict(lmin_ivf=30, lmax_ivf=150, itermax=1, lmax_qlm=120, include_n1=True,
              n1_lmax=120, n1_kwargs={'dL': 20})
    r = rn0s.get_N0_iter('p_p', 1.0, 1.4, 2.0, unl, **kw)
    p = pn0s.get_N0_iter('p_p', 1.0, 1.4, 2.0, unl, **kw, device=CPU)
    for i in range(2):
        for a, b in zip(p[i], r[i]):
            assert _n0_close(a, b, 1e-8, 120), i
    # the iterated N1 curves (biased, unbiased), in band
    sel = slice(30, 121)
    for i in (2, 3):
        for a, b in zip(p[i], r[i]):
            assert _rel(a[sel], b[sel]) <= 1e-8, (i, _rel(a[sel], b[sel]))
    assert np.all(np.asarray(p[3])[0][sel] > 0.)
