"""Port parity of the analytic responses (models/qresp), the semi-analytic N0 (models/nhl)
and the bias-hardened QE keys (models/qest) against plancklens_tpu, f64 on the CPU:

  * `get_response` for the keys ptt, p_p, p, x, s, f and a_p (their own sources) and the
    cross-source pairs ptt/s, stt/p: <= 1e-10 relative (of max) in every channel;
  * `RespLib` including a '_bh_' key, `get_dresponse_dlncl` and `get_mf_resp` against the
    reference to 1e-10;
  * N0 == 1/R (unnormalised N0 equal to the response) to 1e-6 on the port, with the G/C
    cross terms zero, mirroring tests/test_n0_response_identity.py;
  * `NhlLib.get_sim_nhl` on identically filtered sims (plain keys, a '_bh_' key and a
    cross of two keys): <= 1e-10;
  * a '_bh_' qlm (single and batched) <= 1e-10 of max;
  * `QELib.get_mask`/`get_fsky` on masked legs: <= 1e-12.
"""
import os

import numpy as np
import pytest
import torch

import plancklens_tpu
from plancklens_tpu.utils import camb_clfile, cli, alm as ralm
from plancklens_tpu.ops.sht import gl_geometry as rgl
from plancklens_tpu.models import qresp as rqresp, nhl as rnhl, qest as rqest
from plancklens_tpu_torch.ops.sht import gl_geometry as pgl
from plancklens_tpu_torch.models import qresp as pqresp, nhl as pnhl, qest as pqest

torch.set_num_threads(1)

CPU = torch.device('cpu')
LMAX = 40
LMIN = 4


def _rel(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    scale = np.abs(ref).max()
    return 0. if scale == 0. and not np.any(a) else np.abs(a - ref).max() / scale


def _setup(lmax=LMAX):
    cls = camb_clfile(os.path.join(plancklens_tpu.DATAPATH, 'cls',
                                   'FFP10_wdipole_lensedCls.dat'), lmax=2 * lmax)
    nt2 = (35. / 60. / 180. * np.pi) ** 2
    fal = {k: cli(cls[k][:lmax + 1] + nt2 * (1. if k == 'tt' else 2.))
           for k in ('tt', 'ee', 'bb')}
    for v in fal.values():
        v[:LMIN] = 0.
    return cls, fal


@pytest.mark.parametrize('key,source', [('ptt', 'p'), ('p_p', 'p'), ('p', 'p'), ('x', 'x'),
                                        ('stt', 's'), ('s', 's'), ('ftt', 'f'), ('f', 'f'),
                                        ('a_p', 'a'), ('ptt', 's'), ('stt', 'p')])
def test_get_response_matches_reference(key, source):
    cls, fal = _setup()
    ref = rqresp.get_response(key, LMAX, source, cls, cls, fal, lmax_qlm=LMAX)
    out = pqresp.get_response(key, LMAX, source, cls, cls, fal, lmax_qlm=LMAX, device=CPU)
    assert any(np.any(r) for r in ref)
    for o, r in zip(out, ref):
        assert _rel(o, r) <= 1e-10


def test_resplib_bh_dresponse_and_mf_resp_match_reference():
    cls, fal = _setup()
    rl = rqresp.RespLib(LMAX, cls, cls, fal, LMAX)
    pl = pqresp.RespLib(LMAX, cls, cls, fal, LMAX, device=CPU)
    assert pl.hashdict() == rl.hashdict()
    for k, src in (('ptt', 'p'), ('p_p', 'p'), ('xtt', 'x'), ('ptt_bh_s', 'p'), ('ptt', 's')):
        r = rl.get_response(k, src)
        assert _rel(pl.get_response(k, src), r) <= 1e-10, (k, src)
    # the bias-hardened estimator does not respond to its hardening source (both packages
    # return rounding residue there, so it is held to the unhardened response's scale)
    scale = np.abs(rl.get_response('ptt', 's')).max()
    for lib in (pl, rl):
        assert np.abs(lib.get_response('ptt_bh_s', 's')).max() <= 1e-10 * scale
    cls_tt = {'tt': cls['tt'][:LMAX + 1]}
    for l in (5, 17):
        r = rqresp.get_dresponse_dlncl('ptt', l, 'tt', LMAX, 'p', cls_tt, cls_tt, fal,
                                       lmax_out=LMAX)
        o = pqresp.get_dresponse_dlncl('ptt', l, 'tt', LMAX, 'p', cls_tt, cls_tt, fal,
                                       lmax_out=LMAX, device=CPU)
        assert all(_rel(a, b) <= 1e-10 for a, b in zip(o, r))
    for key in ('ptt', 'p_p'):
        r = rqresp.get_mf_resp(key, cls, fal, LMAX, LMAX + 10, retterms=True)
        o = pqresp.get_mf_resp(key, cls, fal, LMAX, LMAX + 10, retterms=True, device=CPU)
        assert _rel(o[0], r[0]) <= 1e-10 and _rel(o[1], r[1]) <= 1e-10
        for t in r[2]:
            assert _rel(o[2][t], r[2][t]) <= 1e-10, (key, t)


@pytest.mark.parametrize('ksource,maps', [('p', 'tt'), ('p', '_p'), ('f', 'tt')])
def test_n0_equals_response(ksource, maps):
    """Filter == weights == data spectra: the QE is optimally filtered, so its unnormalised
    semi-analytic N0 equals its response (reference: tests/test_n0_response_identity.py)."""
    lmax = 96
    cls = camb_clfile(os.path.join(plancklens_tpu.DATAPATH, 'cls',
                                   'FFP10_wdipole_lensedCls.dat'))
    nt2 = (35. / 60. / 180. * np.pi) ** 2
    fal = {k: cli(cls[k][:lmax + 1] + nt2 * (1. if k == 'tt' else 2.))
           for k in ('tt', 'ee', 'bb')}
    for v in fal.values():
        v[:10] = 0.
    ivfs = {k: v.copy() for k, v in fal.items()}
    ivfs['te'] = cls['te'][:lmax + 1] * fal['tt'] * fal['ee']
    k = ksource + maps
    NG, NC, NGC, NCG = pnhl.get_nhl(k, k, cls, ivfs, lmax, lmax, lmax_out=lmax, device=CPU)
    RG, RC, RGC, RCG = pqresp.get_response(k, lmax, ksource, cls, cls, fal, lmax_qlm=lmax,
                                           device=CPU)
    assert np.allclose(NG[1:], RG[1:], rtol=1e-6)
    assert np.allclose(NC[2:], RC[2:], rtol=1e-6)
    assert not np.any(NGC) and not np.any(NCG) and not np.any(RGC) and not np.any(RCG)


class _Ivfs:
    """Filtering library over fixed filtered alms: numpy for the reference, torch for the
    port; optionally masked on a ring grid (get_fmask + geom, as the cinv libraries)."""

    def __init__(self, alms, torch_out, mask=None, geom=None):
        self.alms = alms
        self.torch_out = torch_out
        self.geom = geom
        if mask is not None:
            self.get_fmask = lambda: mask

    def hashdict(self):
        return {'fixed': True}

    def _get(self, f, idx):
        a = self.alms[f][idx]
        return torch.as_tensor(a) if self.torch_out else a

    def get_sim_tlm(self, idx):
        return self._get('t', idx)

    def get_sim_elm(self, idx):
        return self._get('e', idx)

    def get_sim_blm(self, idx):
        return self._get('b', idx)


def _filtered(nsims, fal, seed):
    rng = np.random.RandomState(seed)
    ls, ms = ralm._lm_indices(LMAX)
    out = {}
    for f in 'teb':
        a = rng.standard_normal((nsims, len(ls))) + 1j * rng.standard_normal((nsims, len(ls)))
        a[:, ms == 0] = a[:, ms == 0].real * np.sqrt(2.)
        out[f] = a / np.sqrt(2.) * np.sqrt(fal[f + f][ls])
    return out


def test_nhl_lib_and_bh_qlm_match_reference():
    cls, fal = _setup()
    alms = _filtered(2, fal, 9)
    r_ivfs, p_ivfs = _Ivfs(alms, False), _Ivfs(alms, True)
    rl = rqresp.RespLib(LMAX, cls, cls, fal, LMAX)
    pl = pqresp.RespLib(LMAX, cls, cls, fal, LMAX, device=CPU)
    rn = rnhl.NhlLib(r_ivfs, cls, LMAX, resplib=rl)
    pn = pnhl.NhlLib(p_ivfs, cls, LMAX, resplib=pl, device=CPU)
    assert pn.hashdict() == rn.hashdict()
    for k1, k2 in (('ptt', 'ptt'), ('p_p', 'p_p'), ('p', 'p'), ('ptt', 'p_p'),
                   ('ptt_bh_s', 'ptt_bh_s')):
        for idx in (0, 1):
            r = rn.get_sim_nhl(idx, k1, k2)
            assert _rel(pn.get_sim_nhl(idx, k1, k2), r) <= 1e-10, (k1, k2, idx)
    rq = rqest.QELib(r_ivfs, r_ivfs, cls, LMAX, LMAX, resplib=rl)
    pq = pqest.QELib(p_ivfs, p_ivfs, cls, LMAX, LMAX, resplib=pl, device=CPU)
    for idx in (0, 1):
        r = rq.get_sim_qlm('ptt_bh_s', idx)
        assert _rel(pq.get_sim_qlm('ptt_bh_s', idx).numpy(), r) <= 1e-10
    assert _rel(pq.get_sim_qlm_batch('ptt_bh_s', [0, 1]).numpy(),
                rq.get_sim_qlm_batch('ptt_bh_s', np.array([0, 1]))) <= 1e-10


def test_qelib_mask_and_fsky_match_reference():
    cls, fal = _setup()
    alms = _filtered(1, fal, 2)
    gr, gp = rgl(LMAX), pgl(LMAX)
    z = np.cos(gp.theta)[:, None] * np.ones((1, gp.nphi))
    phi = 2. * np.pi * np.arange(gp.nphi)[None, :] / gp.nphi * np.ones((gp.nrings, 1))
    m1 = (np.abs(z) > 0.2).astype(float)
    m2 = m1 * (np.cos(phi) > -0.8)
    rq = rqest.QELib(_Ivfs(alms, False, m1, gr), _Ivfs(alms, False, m2, gr), cls, LMAX, LMAX)
    pq = pqest.QELib(_Ivfs(alms, True, m1, gp), _Ivfs(alms, True, m2, gp), cls, LMAX, LMAX,
                     device=CPU)
    for leg in (1, 2):
        assert np.array_equal(pq.get_mask(leg), rq.get_mask(leg))
    for i in (11, 22, 12):
        assert abs(pq.get_fsky(i) - rq.get_fsky(i)) <= 1e-12
    assert 0.5 < pq.get_fsky(12) < pq.get_fsky(11) < 1.
    full = pqest.QELib(_Ivfs(alms, True), _Ivfs(alms, True), cls, LMAX, LMAX, device=CPU)
    assert full.get_mask(1) == 1. and full.get_fsky(12) == 1.
