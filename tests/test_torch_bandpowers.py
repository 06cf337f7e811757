"""Port parity of the band-powers (models/bandpowers.Binner) against plancklens_tpu, f64 on
the CPU, on the full-sky fixture of tests/test_bandpowers.py (LMAX 64, mc_sims_var 0-3,
mc_sims_bias 4-7, data sim -1, ds/ss legs by IVFShuffle), with the reference's unit phases
injected into the port's sims (compat.phases_from_numpy):

  * every Binner method — fiducial and data band-powers, MCN0, RDN0, the data's
    semi-analytic N0, N1, the point-source pieces (get_ps_data / get_ps_corr, the stt key
    end to end with nhl.get_nhl on an empty weights dict), the additive and multiplicative
    MC corrections, the covariances and the cross-to-input amplitude — <= 1e-8 relative
    to max in both packages;
  * `get_blbubc` on every named layout and a custom one, exactly.
"""
import os
import types

import numpy as np
import pytest
import torch

import plancklens_tpu
from plancklens_tpu.utils import camb_clfile, cli
from plancklens_tpu.models import sims as rsims, filt as rfilt, qest as rqest, \
    qecl as rqecl, qresp as rqresp, nhl as rnhl, n1 as rn1, bandpowers as rbp
from plancklens_tpu_torch import compat
from plancklens_tpu_torch.models import sims as psims, filt as pfilt, qest as pqest, \
    qecl as pqecl, qresp as pqresp, nhl as pnhl, n1 as pn1, bandpowers as pbp

torch.set_num_threads(1)

CPU = torch.device('cpu')
LMAX = 64
LMIN = 8
NVAR = 4
NSIMS = 64
TOL = 1e-8
BTYPE = '8_25_45_64'


def _rel(a, ref):
    a, ref = np.asarray(a, dtype=float), np.asarray(ref, dtype=float)
    scale = np.abs(ref).max()
    return 0. if scale == 0. and not np.any(a) else np.abs(a - ref).max() / scale


def _parfiles():
    cls_path = os.path.join(plancklens_tpu.DATAPATH, 'cls')
    cls_len = camb_clfile(os.path.join(cls_path, 'FFP10_wdipole_lensedCls.dat'), lmax=LMAX)
    transf = np.ones(LMAX + 1)
    nt2 = (35. / 60. / 180. * np.pi) ** 2
    np2 = 2 * nt2
    ftl, fel, fbl = cli(cls_len['tt'] + nt2), cli(cls_len['ee'] + np2), cli(cls_len['bb'] + np2)
    for fl in (ftl, fel, fbl):
        fl[:LMIN] = 0.
    fal = {'tt': ftl, 'ee': fel, 'bb': fbl}
    rcmb = rsims.CMBUnlLib(cls_len, LMAX, fields=('t', 'e', 'b'), seed=11)
    robs = rsims.MapsNlevLib(rcmb, transf, 35., 35. * np.sqrt(2.), seed=12)
    idxs = list(range(-1, 2 * NVAR + 1))       # data, sims 0-7 and the ss partner 8
    cmb_ph = {i: np.asarray(rsims.unit_phases(rsims.sim_key(rcmb._base_key, i), 3, LMAX))
              for i in idxs}
    noise_ph = {i: np.asarray(rsims.unit_phases(rsims.sim_key(robs._noise_key, i), 3, LMAX))
                for i in idxs}
    pcmb = psims.CMBUnlLib(cls_len, LMAX, fields=('t', 'e', 'b'), seed=11, device=CPU,
                           phases=compat.phases_from_numpy(cmb_ph))
    pobs = psims.MapsNlevLib(pcmb, transf, 35., 35. * np.sqrt(2.), seed=12,
                             phases=compat.phases_from_numpy(noise_ph))
    out = []
    for sims, filt, qest, qecl, qresp, nhl, n1, kw in (
            (robs, rfilt, rqest, rqecl, rqresp, rnhl, rn1, {}),
            (pobs, pfilt, pqest, pqecl, pqresp, pnhl, pn1, {'device': CPU})):
        ivfs = filt.IVFSepTP(sims, transf, cls_len, ftl, fel, fbl)
        ivfs_d = filt.IVFShuffle(ivfs, lambda i: -1)
        ivfs_s = filt.IVFShuffle(ivfs, lambda i: (i + 1) % NSIMS)
        qlms_dd = qest.QELib(ivfs, ivfs, cls_len, LMAX, LMAX, **kw)
        qlms_ds = qest.QELib(ivfs, ivfs_d, cls_len, LMAX, LMAX, **kw)
        qlms_ss = qest.QELib(ivfs, ivfs_s, cls_len, LMAX, LMAX, **kw)
        none = np.array([], dtype=int)
        pf = types.SimpleNamespace()
        pf.ivfs = ivfs
        pf.mc_sims_var = np.arange(NVAR)
        pf.mc_sims_bias = np.arange(NVAR, 2 * NVAR)
        pf.qcls_dd = qecl.QeClLib(qlms_dd, qlms_dd, none, lmax_qlm=LMAX)
        pf.qcls_ds = qecl.QeClLib(qlms_ds, qlms_ds, none, lmax_qlm=LMAX)
        pf.qcls_ss = qecl.QeClLib(qlms_ss, qlms_ss, none, lmax_qlm=LMAX)
        # a stand-in for the input-phi cross (these Gaussian skies carry no phi): the dd
        # QE crossed with the ds QE, averaged over the two orders
        pf.qlms_x_in = qecl.QeClAverage([qecl.QeClLib(qlms_dd, qlms_ds, none, lmax_qlm=LMAX),
                                         qecl.QeClLib(qlms_ds, qlms_dd, none, lmax_qlm=LMAX)])
        pf.qresp_dd = qresp.RespLib(LMAX, cls_len, cls_len, fal, LMAX, **kw)
        pf.nhl_dd = nhl.NhlLib(ivfs, cls_len, LMAX, **kw)
        pf.n1_dd = n1.N1Lib(cls_len['tt'], cls_len['te'], cls_len['ee'], lmaxphi=128, dL=24,
                            **kw)
        out.append(pf)
    return out


@pytest.fixture(scope='module')
def binners():
    rpf, ppf = _parfiles()
    return (rbp.Binner('ptt', 'ptt', rpf, BTYPE, lmaxphi=LMAX),
            pbp.Binner('ptt', 'ptt', ppf, BTYPE, lmaxphi=LMAX))


def test_get_blbubc():
    for bt in list(rbp._BIN_EDGES) + ['1_10_unb', BTYPE]:
        for a, b in zip(pbp.get_blbubc(bt), rbp.get_blbubc(bt)):
            assert np.array_equal(a, b), bt


def test_binner_setup(binners):
    r, p = binners
    assert p.nbins == r.nbins == 3
    for name in ('bin_lavs', 'fid_bandpowers', 'clkk_fid', 'kswitch', '_bmat'):
        assert _rel(getattr(p, name), getattr(r, name)) <= 1e-12, name
    assert _rel(p.get_fid_bandpowers(), r.get_fid_bandpowers()) <= 1e-12
    assert _rel(p._get_bil(1, [30, 40]), r._get_bil(1, [30, 40])) <= 1e-12


@pytest.mark.parametrize('method', ['get_dat_bandpowers', 'get_mcn0', 'get_rdn0',
                                    'get_dat_nhl', 'get_n1', 'get_bmmc', 'get_nhl_cov',
                                    'get_mcn0_cov'])
def test_binner_method_matches_reference(binners, method):
    r, p = binners
    a, b = getattr(p, method)(), getattr(r, method)()
    assert np.shape(a) == np.shape(b)
    assert np.all(np.isfinite(a))
    assert _rel(a, b) <= TOL, (method, _rel(a, b))


def test_binner_bamc_and_ps_match_reference(binners):
    r, p = binners
    for a, b in zip(p.get_bamc(), r.get_bamc()):
        assert _rel(a, b) <= TOL
    pd = p.get_ps_data(lmin_ss_s4=10, lmax_ss_s4=LMAX)
    rd = r.get_ps_data(lmin_ss_s4=10, lmax_ss_s4=LMAX)
    assert len(pd) == len(rd) == 6
    for i, (a, b) in enumerate(zip(pd, rd)):
        assert np.all(np.isfinite(a)) and _rel(a, b) <= TOL, (i, _rel(a, b))
    assert _rel(p.get_ps_corr(lmin_ss_s4=10, lmax_ss_s4=LMAX),
                r.get_ps_corr(lmin_ss_s4=10, lmax_ss_s4=LMAX)) <= TOL


def test_binner_ampl_x_input_matches_reference(binners):
    r, p = binners
    a, b = p.get_ampl_x_input(), r.get_ampl_x_input()
    assert a.N == b.N == 2 * NVAR
    assert _rel(a.mean(), b.mean()) <= TOL
    assert _rel(a.cov(), b.cov()) <= TOL
