"""Port parity of the isotropic joint T/P filter and the GMV estimator:
plancklens_tpu_torch.models.filt.IVFJTP and the 'p' QE, N0 and response on it, against
plancklens_tpu on identical numpy inputs (the reference's unit phases injected), f64, on
the CPU; and chip_smoke.py phase 9's functions (examples/gmv_jtp_torch.py) rehearsed at
small lmax.

  * IVFJTP's alms and joint Wiener legs (tb/eb weights included): 1e-12 of max; the
    IVFCinvJTP Wiener rows (mirror of tests/test_round5_review.py:145): exact;
  * the GMV 'p' qlm on IVFJTP legs: 1e-10 relative rms;
  * N0 = 1/R for the GMV key with joint filtering (mirror of
    tests/test_n0_response_identity.py:85): 1e-6 relative, and both to the reference's;
  * the GMV/SQE N0 ratio of phase 9c equals the reference's (1e-10) and stays below 1.
"""
import os
import sys

import numpy as np
import pytest
import torch

from plancklens_tpu import DATAPATH
from plancklens_tpu.utils import camb_clfile, cli, cl_inverse, cls_dot
from plancklens_tpu.models import sims as rsims, filt as rfilt, qest as rqest
from plancklens_tpu.models import nhl as rnhl, qresp as rqresp
from plancklens_tpu_torch import compat
from plancklens_tpu_torch.models import sims as psims, filt as pfilt, qest as pqest
from plancklens_tpu_torch.models import nhl as pnhl, qresp as pqresp
from plancklens_tpu_torch.models import cinv as pcinv
from plancklens_tpu_torch.utils import alm as palm

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                'examples'))
import gmv_jtp_torch as gmv   # noqa: E402

torch.set_num_threads(1)

LMAX = 48
LMIN = 4
NT, NP = 35., 35. * np.sqrt(2.)


def _err(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return np.abs(a - ref).max() / np.abs(ref).max()


def _rrms(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return np.sqrt(np.sum(np.abs(a - ref) ** 2) / np.sum(np.abs(ref) ** 2))


def _libs(idxs):
    """The reference's and the port's IVFJTP over the same Gaussian sims (the reference's
    unit phases injected), with tb/eb Wiener weights and a tb filter entry."""
    cl_len = camb_clfile(os.path.join(DATAPATH, 'cls', 'FFP10_wdipole_lensedCls.dat'),
                         lmax=LMAX)
    transf = np.exp(-0.5 * np.arange(LMAX + 1) * (np.arange(LMAX + 1) + 1) * 1e-4)
    cls_dat = {'tt': cl_len['tt'] + (NT / 60. / 180. * np.pi) ** 2 / transf ** 2,
               'ee': cl_len['ee'] + (NP / 60. / 180. * np.pi) ** 2 / transf ** 2,
               'bb': cl_len['bb'] + (NP / 60. / 180. * np.pi) ** 2 / transf ** 2,
               'te': np.copy(cl_len['te'])}
    fal = cl_inverse(cls_dat)
    for cl in fal.values():
        cl[:LMIN] = 0.
    fal['tb'] = 0.01 * fal['te']
    clw = dict(cl_len, tb=0.1 * cl_len['te'], eb=0.05 * cl_len['ee'])
    rcmb = rsims.CMBUnlLib(cl_len, LMAX, fields=('t', 'e', 'b'), seed=21)
    robs = rsims.MapsNlevLib(rcmb, transf, NT, NP, seed=22)
    cmb_ph = {i: np.asarray(rsims.unit_phases(rsims.sim_key(rcmb._base_key, i), 3, LMAX))
              for i in idxs}
    noise_ph = {i: np.asarray(rsims.unit_phases(rsims.sim_key(robs._noise_key, i), 3, LMAX))
                for i in idxs}
    pcmb = psims.CMBUnlLib(cl_len, LMAX, fields=('t', 'e', 'b'), seed=21, device='cpu',
                           phases=compat.phases_from_numpy(cmb_ph))
    pobs = psims.MapsNlevLib(pcmb, transf, NT, NP, seed=22,
                             phases=compat.phases_from_numpy(noise_ph))
    return (rfilt.IVFJTP(robs, transf, clw, fal), pfilt.IVFJTP(pobs, transf, clw, fal),
            cl_len)


def test_ivfjtp_alms_and_wiener_legs_match_reference():
    """IVFJTP bar alms (single and batched) and the joint Wiener legs C_w bar X with tb/eb
    weights: 1e-12 of max; the isotropic accessors as the reference's."""
    idxs = [0, 2]
    r, p, _ = _libs(idxs)
    assert p.hashdict() == r.hashdict()
    for i in idxs:
        for k in ('tlm', 'elm', 'blm', 'tmliklm', 'emliklm', 'bmliklm'):
            a, b = getattr(p, 'get_sim_' + k)(i), getattr(r, 'get_sim_' + k)(i)
            assert a.dtype == torch.complex128 and a.shape == (palm.getsize(LMAX),)
            assert _err(a, b) <= 1e-12, (i, k, _err(a, b))
    for a, b in zip(p.get_sim_teblm_batch(idxs), r.get_sim_teblm_batch(np.array(idxs))):
        assert a.shape == (2, palm.getsize(LMAX)) and _err(a, b) <= 1e-12
    for k in ('get_ftl', 'get_fel', 'get_fbl'):
        assert np.array_equal(getattr(p, k)(), getattr(r, k)())
    assert sorted(p.get_fal()) == sorted(r.get_fal())
    assert np.array_equal(p.get_tal('b'), np.asarray(r.get_tal('b')))


def test_jtp_wiener_includes_tb_eb():
    """IVFCinvJTP's Wiener rows route cl['tb'] / cl['eb'] as the reference's
    (mirror of tests/test_round5_review.py:145)."""
    lmax = 8
    sz = palm.getsize(lmax)

    class _TP:
        pass
    tp = _TP()
    tp.lmax = lmax
    lib = pcinv.IVFCinvJTP.__new__(pcinv.IVFCinvJTP)
    lib.cinv_tp = tp
    teb = tuple(torch.full((sz,), v + 0j, dtype=torch.complex128) for v in (1., 2., 3.))
    lib._teb = lambda idx: teb
    one = np.ones(lmax + 1)
    lib.cl = {'tt': 1. * one, 'te': 2. * one, 'tb': 5. * one,
              'ee': 3. * one, 'eb': 7. * one, 'bb': 4. * one}
    assert torch.all(lib.get_sim_tmliklm(0) == 20.)
    assert torch.all(lib.get_sim_emliklm(0) == 29.)
    assert torch.all(lib.get_sim_bmliklm(0) == 31.)


def test_gmv_qlm_on_ivfjtp_matches_reference():
    """The GMV 'p' QE (gradient and curl) on IVFJTP legs: 1e-10 relative rms."""
    idxs = [0, 1]
    r, p, cl_len = _libs(idxs)
    rq = rqest.QELib(r, r, cl_len, LMAX, LMAX)
    pq = pqest.QELib(p, p, cl_len, LMAX, LMAX, device='cpu')
    for k in ('p', 'x'):
        a, b = pq.get_sim_qlm_batch(k, idxs), rq.get_sim_qlm_batch(k, np.array(idxs))
        assert a.dtype == torch.complex128
        assert _rrms(a, b) <= 1e-10, (k, _rrms(a, b))


@pytest.mark.parametrize('ksource', ['p', 'f'])
def test_n0_equals_response_gmv_joint_filter(ksource):
    """With filter == weights == data spectra (joint 3x3, TE included) the semi-analytic N0
    of the GMV key equals its response to 1e-6 relative, the G/C crosses vanish, and each
    equals the reference's to 1e-10 of max (mirror of
    tests/test_n0_response_identity.py:85)."""
    import test_n0_response_identity as ref
    lmax = ref.LMAX_IVF
    N = pnhl.get_nhl(ksource, ksource, ref.CLS_LEN, ref.IVFS_JT, lmax, lmax, lmax_out=lmax,
                     device='cpu')
    R = pqresp.get_response(ksource, lmax, ksource, ref.CLS_LEN, ref.CLS_LEN, ref.FAL_JT,
                            lmax_qlm=lmax, device='cpu')
    assert np.allclose(N[0][1:], R[0][1:], rtol=1e-6)
    assert np.allclose(N[1][2:], R[1][2:], rtol=1e-6)
    assert np.all(N[2] == 0.) and np.all(N[3] == 0.)
    assert np.all(R[2] == 0.) and np.all(R[3] == 0.)
    Nr = rnhl.get_nhl(ksource, ksource, ref.CLS_LEN, ref.IVFS_JT, lmax, lmax, lmax_out=lmax)
    Rr = rqresp.get_response(ksource, lmax, ksource, ref.CLS_LEN, ref.CLS_LEN, ref.FAL_JT,
                             lmax_qlm=lmax)
    # each curve against its own max, or the gradient's where it is rounding ('f' curl)
    for a, b in zip(N[:2] + R[:2], Nr[:2] + Rr[:2]):
        scale = max(np.abs(b).max(), 1e-6 * np.abs(Nr[0]).max())
        assert np.abs(np.asarray(a) - b).max() <= 1e-10 * scale


def test_phase9_n0_ratio_matches_reference():
    """Phase 9c's GMV / SQE N0 ratio at lmax 256 (35 / 55 uK-arcmin, 5'): the port's
    function against the same quantity from the reference's nhl and qresp (1e-10), below
    1 at every L (0.81-0.88)."""
    lmax = 256
    res = gmv.n0_ratio('cpu', lmax=lmax, log=lambda s: None)
    from plancklens_tpu_torch.models.n0s import gauss_beam
    transf = gauss_beam(gmv.FWHM, lmax=lmax)
    cl_len, cls_dat, fal_j, fal_s = gmv.gmv_fal(lmax, gmv.NLEV_T, gmv.NLEV_P, transf)
    n0 = []
    for fal in (fal_j, fal_s):
        N = rnhl.get_nhl('p', 'p', cl_len, cls_dot([fal, cls_dat, fal], ret_dict=True), lmax,
                         lmax, lmax_out=lmax)[0]
        R = rqresp.get_response('p', lmax, 'p', cl_len, cl_len, fal, lmax_qlm=lmax)[0]
        n0.append(np.asarray(N) * cli(np.asarray(R)) ** 2)
    ls = np.arange(gmv.N0_L[0], lmax + 1)
    ref = n0[0][ls] / n0[1][ls]
    assert _err(res['ratio'], ref) <= 1e-10, _err(res['ratio'], ref)
    assert 0.75 < res['ratio'].min() and res['ratio'].max() < 0.9


def test_phase9_rehearsal_small():
    """Phase 9a, 9b-9c and 9d's functions on the CPU at small lmax: the joint filter
    converges with the same iteration count on both paths, IVFJTP and the GMV qlm agree,
    the route's alms come back through IVFCinvJTP finite, and the GMV spectrum sits on its
    N0."""
    log = []
    r9a = gmv.card_vs_cpu('cpu', lmax=24, log=log.append)
    assert r9a['it'][0] == r9a['it'][1] == r9a['it'][2] > 5, r9a['it']
    assert r9a['err'] <= 10. * r9a['floor'] and r9a['ops'] <= 1e-12
    assert r9a['probe_err'] <= 1e-12 and r9a['fal_err'] <= 1e-12
    assert r9a['ivfjtp_err'] <= 1e-12 and r9a['qlm_err'] <= 1e-12
    assert np.all(r9a['res'] < 1e-5)
    r9b = gmv.masked_gmv('cpu', lmax=32, nsims=2, lmax_dense=8, log=log.append)
    assert r9b['it'] < 400 and np.all(r9b['rel'] < 1e-5) and np.all(r9b['true_rel'] < 1e-5)
    assert r9b['finite'] and 0. < r9b['fsky'] < 1.
    r9d = gmv.ivfjtp_full('cpu', lmax=64, nsims=4, log=log.append)
    assert r9d['finite'] and abs(r9d['ratio'] - 1.) <= gmv.SPEC_BOUND, r9d['ratio']
    rb = gmv.stage_b_card_vs_cpu('cpu', lmax=16, log=log.append)
    assert all(rb[k] <= gmv.stage_b_limit(k, rb) for k in gmv.STAGE_B_LIMITS)
    assert len(set(rb['CinvKK_it'])) == 1 and rb['CinvKK_it'][0] > 1
    assert 0. < rb['CinvKK_floor'] < 1e-6
    assert len(log) == 5 + len(gmv.STAGE_B_LIMITS)
    assert all(line.startswith('(9') for line in log)
