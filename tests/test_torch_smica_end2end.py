"""Synthetic-FITS end-to-end of the port's production parameter file,
params/smica_dx12_planck2018_torch.py (mirror of tests/test_smica_end2end.py).

The Planck products (SMICA / FFP10 alm FITS files and the lensing mask) are not in the
repository. The port's parameter file runs its own code on reduced-scale synthetic
products in the reference's on-disk formats, written once in a temporary directory with
the port's libraries (examples/smica_synth_torch.write_products, which chip_smoke.py phase
10 runs at full size): healpy alm FITS files of beam-convolved lensed CMB plus white noise
(sims.CMBLenLib, sims.AlmNlevLib) for sims 0..NSIMS-1 and 'dat', the input phi alms, and
a RING HEALPix lensing mask (galactic band and two holes) that the file resamples onto its
ring grid.

  * without the products the file imports, and a data-dependent library raises with the
    expected path;
  * on the products its inverse-variance maps, transfer function and grid equal the
    reference parameter file's (the same files read by both), its masked filtering keeps
    the l-cut, its ptt reconstruction of a sim is finite, and the input phi reads back;
  * the full chain (slow tier, ~2-4 min on one core as the reference's): detection and
    normalisation against the input phi, the debiased auto-spectrum against the
    fiducial, RDN0 against MCN0, and the 'data' realisation's chi^2.
"""
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

LMAX = 64
NSIDE = 32
NSIMS = 10
NLEV_T = 1.0
NLEV_P = 1.4
KEY = 'p_p'
SEED = 7
_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(_HERE), 'examples'))
import smica_synth_torch as synth   # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def products(tmp_path_factory):
    """The synthetic Planck-like products, written once: (directory, CMBLenLib)."""
    from plancklens_tpu_torch.ops.sht import gl_geometry
    tdir = str(tmp_path_factory.mktemp('planck'))
    cmb_len = synth.write_products(tdir, LMAX, NSIDE, NSIMS, NLEV_T, NLEV_P, 'cpu',
                                   seed=SEED, dlmax=16, geom=gl_geometry(LMAX + 16))
    return tdir, cmb_len


def _load(name, tdir, nsims=NSIMS):
    env = {'PLK_SMICA_NLEV_T': str(NLEV_T), 'PLK_SMICA_NLEV_P': str(NLEV_P)}
    if name.endswith('_torch'):
        return synth.load_parfile(tdir, LMAX, NSIDE, nsims, 'cpu', **env)
    env.update({'PLK_PLANCK_DATA': tdir, 'PLK_SMICA_LMAX': str(LMAX),
                'PLK_SMICA_NSIDE': str(NSIDE), 'PLK_SMICA_NSIMS': str(nsims)})
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        spec = importlib.util.spec_from_file_location(
            'parfile_' + name, os.path.join(_HERE, '..', 'params', name + '.py'))
        par = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(par)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    return par


def test_smica_torch_parfile_without_data(tmp_path):
    """Import works without the products; touching a data-dependent library raises with
    the expected path, as the reference file does."""
    par = _load('smica_dx12_planck2018_torch', str(tmp_path / 'none'))
    assert par.DEVICE == torch.device('cpu') and par.lmax_ivf == LMAX
    for touch in (lambda: par.cinv_t.lmax, lambda: par.ivfs.get_sim_tlm(0),
                  lambda: par.qlms_dd.get_sim_qlm('ptt', 0)):
        with pytest.raises(FileNotFoundError, match='lensing_mask.fits'):
            touch()


def test_smica_torch_parfile_wiring(products):
    """On the synthetic products: the inverse-variance maps, transfer function, fiducial
    filters and grid equal the reference parameter file's; the masked filtering keeps
    the l-cut; the ptt reconstruction of a sim is finite; the input phi reads back from
    FITS (detection and normalisation: the slow test)."""
    from plancklens_tpu_torch.utils import alm as ualm
    tdir, cmb_len = products
    par = _load('smica_dx12_planck2018_torch', tdir)
    ref = _load('smica_dx12_planck2018', tdir)
    assert par.geom.nrings == ref.geom.nrings and par.geom.nphi == ref.geom.nphi
    assert np.abs(par.transf - ref.transf).max() <= 1e-12
    for f in ('tt', 'ee', 'bb'):
        assert np.abs(par.fal[f] - ref.fal[f]).max() <= 1e-12 * np.abs(ref.fal[f]).max()
    for nlev in (NLEV_T, NLEV_P):
        assert np.array_equal(par._ninv(nlev), ref._ninv(nlev))
    ring_mask = par.cinv_t.filt.ninv > 0
    assert 0.5 < ring_mask.mean() < 0.95, ring_mask.mean()
    assert par.ss_dict == ref.ss_dict and par.ds_dict == ref.ds_dict
    tlm0 = par.ivfs.get_sim_tlm(0)
    ls, _ = ualm._lm_indices(par.lmax_ivf)
    assert bool(torch.isfinite(tlm0).all()) and float(tlm0.abs().max()) > 0.
    assert bool((tlm0[torch.as_tensor(ls < par.lmin_ivf)] == 0).all())
    q = par.qlms_dd.get_sim_qlm('ptt', 0)
    assert tuple(q.shape) == (ualm.getsize(par.lmax_qlm),) and bool(torch.isfinite(q).all())
    plm = par.sims_alm.get_sim_plm(0)
    assert torch.equal(plm, cmb_len.get_sim_plm(0))


@pytest.mark.slow
def test_smica_torch_parfile_end2end(products):
    """The reference test's chain through the port's file (tests/test_smica_end2end.py):
    detection and normalisation against the input phi, the debiased auto-spectrum, RDN0
    against MCN0 and the data realisation's chi^2, with the reference's bounds."""
    from plancklens_tpu_torch.models.bandpowers import Binner, _load_fid_clpp
    from plancklens_tpu_torch.models.qecl import stats
    from plancklens_tpu_torch.utils import alm as ualm
    tdir, cmb_len = products
    par = _load('smica_dx12_planck2018_torch', tdir)
    lmax = par.lmax_qlm
    btype = '%d_%d_%d_%d' % (8, lmax // 3, 2 * lmax // 3, lmax)
    binner = Binner(KEY, KEY, par, btype, lmaxphi=lmax)
    nbins = binner.nbins
    rdn0 = np.asarray(binner.get_rdn0())
    mcn0 = np.asarray(binner.get_mcn0())
    n1 = np.asarray(binner.get_n1())
    fid = np.asarray(binner.get_fid_bandpowers())
    btype_x = '%d_%d_%d_%d' % (8, LMAX // 3, 2 * LMAX // 3, LMAX)
    binner_x = Binner(KEY, KEY, par, btype_x, lmaxphi=LMAX)
    resp = np.asarray(par.qresp_dd.get_response(KEY, 'p'))
    fsky = float(par.qcls_dd.fsky12)
    fid_b = np.asarray(binner_x._get_binnedcl(_load_fid_clpp(LMAX)[:LMAX + 1]))
    st_x = stats(binner_x.nbins)
    for idx in par.mc_sims_var:
        qlm = par.qlms_dd.get_sim_qlm(KEY, int(idx))
        plm = ualm.alm_copy(par.sims_alm.get_sim_plm(int(idx)), cmb_len.lmax, lmax)
        cl_x = ualm.alm2cl(qlm, lmax, alm2=plm).numpy()
        st_x.add(np.asarray(binner_x._get_binnedcl(
            (cl_x / np.maximum(resp * fsky, 1e-30))[:LMAX + 1])) / fid_b)
    ratio, sig_x = st_x.mean(), st_x.sigmas_on_mean()
    assert np.all(np.abs(ratio - 1.) < 0.3), ratio
    assert np.all(ratio / sig_x > 4.), (ratio, sig_x)
    amp = binner_x.get_ampl_x_input(mc_sims=par.mc_sims_var)
    assert np.all(np.abs(amp.mean() - 1.) < 0.3), amp.mean()
    st, st_ss = stats(nbins), stats(nbins)
    for idx in par.mc_sims_var:
        st.add(binner._normed_bp(par.qcls_dd.get_sim_qcl(KEY, int(idx))) - mcn0 - n1)
        st_ss.add(binner._normed_bp(2. * par.qcls_ss.get_sim_qcl(KEY, int(idx))))
    mean = st.mean()
    sig_tot = np.sqrt(st.sigmas_on_mean() ** 2 + st_ss.sigmas_on_mean() ** 2)
    assert np.all(np.abs(mean - fid) < 5. * sig_tot), ((mean - fid) / sig_tot)
    assert np.all(np.abs(rdn0 - mcn0) < 6. * np.sqrt(2.) * st_ss.sigmas()), (rdn0, mcn0)
    bp_dat = np.asarray(binner._normed_bp(par.qcls_dd.get_sim_qcl(KEY, -1))) - mcn0 - n1
    pte = st.get_chisq_pte(bp_dat)
    assert 1e-3 < pte < 1. - 1e-3, pte
