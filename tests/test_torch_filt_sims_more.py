"""Port parity of the remaining filters and simulation libraries: plancklens_tpu_torch
filt.IVFFml / IVFApoSepTP, utils.cls.smooth_map / apodize_mask, sims.AlmNlevLib /
SimLibShuffle / SimLibAdd / CMBUnlLibFixedPhi / CMBLenLibFixedPhi and cinv.p2k_fl /
CinvKK / template_uptolmin, against plancklens_tpu on identical numpy inputs (the
reference's unit phases and noise draws injected), f64, on the CPU.

Filters and smoothed maps are held to 1e-12 of max, CinvKK's solve to 1e-10 with the same
iteration count, and the index views (shuffles, sums, the fixed potential) exactly.
"""
import os

import jax
import numpy as np
import pytest
import torch

from plancklens_tpu import DATAPATH
from plancklens_tpu.utils import camb_clfile, cli
from plancklens_tpu.utils import cls as rcls
from plancklens_tpu.ops.sht import gl_geometry as rgl
from plancklens_tpu.models import sims as rsims, filt as rfilt, cinv as rcinv
from plancklens_tpu_torch import compat
from plancklens_tpu_torch.ops.sht import gl_geometry as pgl
from plancklens_tpu_torch.models import sims as psims, filt as pfilt, cinv as pcinv
from plancklens_tpu_torch.utils import cls as pcls, alm as palm

torch.set_num_threads(1)

LMAX = 24
NT, NP = 35., 50.


def _err(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return np.abs(a - ref).max() / np.abs(ref).max()


def _cls(lmax=LMAX, name='lensedCls'):
    return camb_clfile(os.path.join(DATAPATH, 'cls', 'FFP10_wdipole_%s.dat' % name),
                       lmax=lmax)


def _transf(lmax=LMAX):
    return np.exp(-0.5 * np.arange(lmax + 1) * (np.arange(lmax + 1) + 1) * 1e-4)


def _obs_pair(idxs, lmax=LMAX, seed=41):
    """The reference's and the port's MapsNlevLib over the same phases (injected)."""
    cl_len = _cls(lmax)
    rcmb = rsims.CMBUnlLib(cl_len, lmax, fields=('t', 'e', 'b'), seed=seed)
    robs = rsims.MapsNlevLib(rcmb, _transf(lmax), NT, NP, seed=seed + 1)
    ph = {i: np.asarray(rsims.unit_phases(rsims.sim_key(rcmb._base_key, i), 3, lmax))
          for i in idxs}
    nph = {i: np.asarray(rsims.unit_phases(rsims.sim_key(robs._noise_key, i), 3, lmax))
           for i in idxs}
    pcmb = psims.CMBUnlLib(cl_len, lmax, fields=('t', 'e', 'b'), seed=seed, device='cpu',
                           phases=compat.phases_from_numpy(ph))
    pobs = psims.MapsNlevLib(pcmb, _transf(lmax), NT, NP, seed=seed + 1,
                             phases=compat.phases_from_numpy(nph))
    return robs, pobs


def _sep(obs, filt, lmax=LMAX):
    cl_len = _cls(lmax)
    tf = _transf(lmax)
    fls = [cli(cl_len[k] + (n / 60. / 180. * np.pi) ** 2 / tf ** 2)
           for k, n in (('tt', NT), ('ee', NP), ('bb', NP))]
    return filt.IVFSepTP(obs, tf, cl_len, *fls)


def test_ivffml_matches_reference():
    """IVFFml over IVFSepTP: filtered alms, Wiener legs, the batch and the l-spectrum view
    within 1e-12 of max; accessors it does not rescale are refused, others forwarded."""
    idxs = [0, 1]
    robs, pobs = _obs_pair(idxs)
    rng = np.random.RandomState(3)
    fm = [rng.uniform(0.5, 1.5, (LMAX + 1, LMAX + 1)) for _ in range(3)]
    r, p = rfilt.IVFFml(_sep(robs, rfilt), *fm), pfilt.IVFFml(_sep(pobs, pfilt), *fm)
    assert p.hashdict() == r.hashdict()
    for i in idxs:
        for k in ('tlm', 'elm', 'blm', 'tmliklm', 'emliklm', 'bmliklm'):
            a, b = getattr(p, 'get_sim_' + k)(i), getattr(r, 'get_sim_' + k)(i)
            assert a.dtype == torch.complex128 and _err(a, b) <= 1e-12, (k, _err(a, b))
    for a, b in zip(p.get_sim_teblm_batch(idxs), r.get_sim_teblm_batch(np.array(idxs))):
        assert _err(a, b) <= 1e-12
    for k in ('get_ftl', 'get_fel', 'get_fbl'):
        assert _err(getattr(p, k)(), getattr(r, k)()) <= 1e-12
    assert np.array_equal(p.get_tal('t'), np.asarray(r.get_tal('t')))
    with pytest.raises(AttributeError):
        p.get_sim_tnoise
    assert not hasattr(p, 'get_sim_tnoise')


def test_smooth_and_apodize_match_reference():
    """smooth_map and apodize_mask (gaussian and hybrid) on a cut sky: 1e-12 of max."""
    lmax = 32
    geom = rgl(lmax)
    mask = (np.abs(np.cos(geom.theta))[:, None] > 0.3) * np.ones((1, geom.nphi))
    a = pcls.smooth_map(mask, pgl(lmax), 0.1, device='cpu')
    assert isinstance(a, np.ndarray) and _err(a, rcls.smooth_map(mask, geom, 0.1)) <= 1e-12
    for method in ('gaussian', 'hybrid'):
        a = pcls.apodize_mask(mask, pgl(lmax), sigma_arcmin=300., method=method, device='cpu')
        b = rcls.apodize_mask(mask, geom, sigma_arcmin=300., method=method)
        assert _err(a, b) <= 1e-12, (method, _err(a, b))
    assert pcls.apodize_mask(mask, pgl(lmax), sigma_arcmin=0., device='cpu') is mask


class _Maps:
    def __init__(self, T, Q, U):
        self.T, self.Q, self.U = T, Q, U

    def get_sim_tmap(self, idx):
        return self.T[idx]

    def get_sim_pmap(self, idx):
        return self.Q[idx], self.U[idx]

    def hashdict(self):
        return {'maps': 1}


def test_ivf_apo_sep_tp_matches_reference():
    """IVFApoSepTP on random maps with an apodised mask: alms and Wiener legs within 1e-12
    of max; the mask and the filters as the reference's."""
    geom = rgl(LMAX)
    rng = np.random.RandomState(5)
    T, Q, U = (rng.standard_normal((2, geom.nrings, geom.nphi)) for _ in range(3))
    apo = rcls.apodize_mask((np.abs(np.cos(geom.theta))[:, None] > 0.3)
                            * np.ones((1, geom.nphi)), geom, sigma_arcmin=300.)
    cl_len, tf = _cls(), _transf()
    fls = [cli(cl_len[k] + 1e-5) for k in ('tt', 'ee', 'bb')]
    r = rfilt.IVFApoSepTP(_Maps(T, Q, U), geom, apo, cl_len, tf, *fls)
    p = pfilt.IVFApoSepTP(_Maps(T, Q, U), pgl(LMAX), apo, cl_len, tf, *fls, device='cpu')
    assert p.hashdict() == r.hashdict()
    for i in (0, 1):
        for k in ('tlm', 'elm', 'blm', 'tmliklm', 'emliklm', 'bmliklm'):
            a, b = getattr(p, 'get_sim_' + k)(i), getattr(r, 'get_sim_' + k)(i)
            assert _err(a, b) <= 1e-12, (k, _err(a, b))
    assert np.array_equal(p.get_fmask(), r.get_fmask())
    assert np.array_equal(p.get_ftl(), r.get_ftl())


def test_alm_nlev_lib_matches_reference_with_injected_noise():
    """AlmNlevLib over a harmonic library (band-limited down from a larger lmax): with the
    reference's noise draws injected, the observed alms within 1e-12 of max (sims and the
    data index -1); its own generator: the white-noise level and determinism."""
    idxs = [-1, 0, 2]
    robs, pobs = _obs_pair(idxs, lmax=LMAX + 8)
    lmax, seed = LMAX, 3000
    noise = {(i, tag): np.asarray(rsims.unit_phases(
        jax.random.fold_in(jax.random.PRNGKey(seed), (i + 2) * 8 + tag), 1, lmax)[0])
        for i in idxs for tag in range(3)}
    r = rsims.AlmNlevLib(robs, lmax, _transf(lmax), 20., 30., seed=seed)
    p = psims.AlmNlevLib(pobs, lmax, _transf(lmax), 20., 30., seed=seed, device='cpu',
                         noise=lambda i, tag: noise[i, tag])
    assert p.hashdict() == r.hashdict()
    for i in idxs:
        for f in 'teb':
            a, b = getattr(p, 'get_sim_%slm' % f)(i), getattr(r, 'get_sim_%slm' % f)(i)
            assert a.shape == (palm.getsize(lmax),) and _err(a, b) <= 1e-12
    for a, b in zip(p.get_sim_teblm_batch(idxs), r.get_sim_teblm_batch(np.array(idxs))):
        assert _err(a, b) <= 1e-12
    # the port's own draws: noise level and reproducibility per (seed, idx, field)
    zero = type('Z', (), {'get_sim_tlm': lambda s, i: torch.zeros(palm.getsize(64),
                                                                  dtype=torch.complex128),
                          'hashdict': lambda s: {}})()
    own = psims.AlmNlevLib(zero, 64, np.ones(65), 20., 30., seed=seed, device='cpu')
    n = own.get_sim_tlm(3)
    assert torch.equal(n, own.get_sim_tlm(3)) and not torch.equal(n, own.get_sim_tlm(4))
    cl = palm.alm2cl(n, 64)[2:].mean().item()
    assert abs(cl / (20. / 60. / 180. * np.pi) ** 2 - 1.) < 0.05


def test_sim_lib_shuffle_and_add_index_views():
    """SimLibShuffle remaps every get_sim_* accessor exactly; SimLibAdd sums two libraries
    (tuples included) with its sims_only / dat_only gates, exactly as the reference does
    on the same numbers, and refuses a batch that mixes gated and ungated indices."""
    idxs = [-1, 0, 1, 2]
    robs, pobs = _obs_pair(idxs)
    rsh, psh = rsims.SimLibShuffle(robs, {0: 2, 1: -1}), psims.SimLibShuffle(pobs, {0: 2, 1: -1})
    assert psh.hashdict() == rsh.hashdict()
    for i, j in ((0, 2), (1, -1), (2, 2)):
        assert torch.equal(psh.get_sim_elm(i), pobs.get_sim_elm(j))
        assert torch.equal(psh.get_sim_bnoise(i), pobs.get_sim_bnoise(j))
    assert psh.lmax == LMAX
    robs2, pobs2 = _obs_pair(idxs, seed=77)
    for kw in ({}, {'sims_only': True}, {'dat_only': True}):
        add = psims.SimLibAdd(pobs, pobs2, w_a=0.5, w_b=2., **kw)
        radd = rsims.SimLibAdd(robs, robs2, 0.5, 2., **kw)
        assert add.hashdict() == radd.hashdict()
        for i in idxs:
            on = not (kw.get('sims_only') and i < 0) and not (kw.get('dat_only') and i >= 0)
            exp = 0.5 * pobs.get_sim_tlm(i) + 2. * pobs2.get_sim_tlm(i) if on \
                else pobs.get_sim_tlm(i)
            assert torch.equal(add.get_sim_tlm(i), exp)
            assert _err(add.get_sim_tlm(i), radd.get_sim_tlm(i)) <= 1e-12
    add = psims.SimLibAdd(pobs, pobs2, sims_only=True)
    t, e, b = add.get_sim_teblm_batch([0, 2])
    assert torch.equal(t[1], pobs.get_sim_tlm(2) + pobs2.get_sim_tlm(2))
    with pytest.raises(ValueError):
        add.get_sim_teblm_batch([-1, 0])
    # tuple returns: the (Q, U)-style accessor of a map library
    maps = _Maps(*(np.ones((2, 3, 4)) * v for v in (1., 2., 3.)))
    q, u = psims.SimLibAdd(maps, maps, w_a=1., w_b=3.).get_sim_pmap(1)
    assert np.array_equal(q, np.full((3, 4), 8.)) and np.array_equal(u, np.full((3, 4), 12.))


def test_cmb_unl_lib_fixed_phi_matches_reference():
    """CMBUnlLibFixedPhi: with the reference's phases injected, every field within 1e-12 of
    the reference's; the potential is the same tensor value at every index (sim phi_idx's
    draw, or an explicit plm), not an alias of the library's copy."""
    lmax, seed = LMAX, 11
    cl_unl = _cls(lmax, 'lenspotentialCls')
    r = rsims.CMBUnlLibFixedPhi(cl_unl, lmax, seed=seed, phi_idx=1)
    base = jax.random.PRNGKey(seed)
    ph = {i: np.asarray(rsims.unit_phases(rsims.sim_key(base, i), 4, lmax)) for i in range(4)}
    p = psims.CMBUnlLibFixedPhi(cl_unl, lmax, seed=seed, phi_idx=1, device='cpu',
                                phases=compat.phases_from_numpy(ph))
    assert p.hashdict() == r.hashdict()
    for i in (0, 2, 3):
        a, b = p.get_sim_alms(i), r.get_sim_alms(i)
        assert _err(a, b) <= 1e-12
    assert torch.equal(p.get_sim_plm(0), p.get_sim_plm(3))
    batch = p.get_sim_alms_batch([0, 3])
    assert torch.equal(batch[1], p.get_sim_alms(3))
    out = p.get_sim_alms(2)
    out[3] = 0.
    assert torch.equal(p.get_sim_plm(0), p.get_sim_plm(2)) and bool(p.get_sim_plm(0).abs().sum())
    plm = np.array(r.get_sim_plm(2))
    re = rsims.CMBUnlLibFixedPhi(cl_unl, lmax, seed=seed, plm=plm)
    pe = psims.CMBUnlLibFixedPhi(cl_unl, lmax, seed=seed, plm=plm, device='cpu',
                                 phases=compat.phases_from_numpy(ph))
    assert pe.hashdict() == re.hashdict()
    assert np.array_equal(pe.get_sim_plm(0).numpy(), plm)
    plm[:] = 0.
    assert bool(pe.get_sim_plm(1).abs().sum())


def test_cmb_len_lib_fixed_phi_lenses_every_sim_by_one_potential():
    """CMBLenLibFixedPhi: the unlensed library is the fixed-phi one, every sim's phi is sim
    phi_idx's, and its lensed maps are the port's lensing of its own unlensed fields by that
    potential."""
    lmax, dlmax = 16, 8
    cl_unl = _cls(lmax + dlmax, 'lenspotentialCls')
    lib = psims.CMBLenLibFixedPhi(cl_unl, lmax, pgl(lmax), dlmax=dlmax, seed=4, phi_idx=2,
                                  device='cpu')
    assert isinstance(lib.unl_lib, psims.CMBUnlLibFixedPhi)
    assert torch.equal(lib.get_sim_plm(0), lib.get_sim_plm(1))
    assert lib.unl_lib.hashdict()['fixed_phi'] == ('sim', 2)
    alms = lib.unl_lib.get_sim_alms(1)
    plm2 = psims.CMBUnlLib(cl_unl, lmax + dlmax, seed=4, device='cpu').get_sim_plm(2)
    assert torch.equal(alms[3], plm2)
    expect = lib.lensing.alm2lenmap(alms[0], plm2)[0]
    assert torch.equal(lib.get_sim_tmap(1), expect)


def test_cinv_kk_and_templates_match_reference():
    """p2k_fl exactly; CinvKK (a masked convergence map at high noise) with the same
    iteration count and its Wiener solution within 1e-10 of max; template_uptolmin within
    1e-12 of max."""
    lmax = 16
    assert np.array_equal(pcinv.p2k_fl(lmax), rcinv.p2k_fl(lmax))
    geom = rgl(lmax)
    clpp = _cls(lmax, 'lenspotentialCls')['pp']
    rng = np.random.RandomState(9)
    kmap = rng.standard_normal((1, geom.nrings, geom.nphi)) * 1e-2
    ninv = (np.abs(np.cos(geom.theta))[:, None] > 0.2) * np.full((1, geom.nphi), 1e5)
    kw = dict(eps_min=1e-6, lmax_dense=0, marge_monopole=True, marge_dipole=False)
    r = rcinv.CinvKK(lmax, geom, clpp, np.ones(lmax + 1), ninv, **kw)
    p = pcinv.CinvKK(lmax, pgl(lmax), clpp, np.ones(lmax + 1), ninv, device='cpu', **kw)
    assert p.hashdict() == r.hashdict()
    rx, rit, _ = r.solve_wf(kmap)
    px, pit, _ = p.solve_wf(kmap)
    assert pit == int(rit) and _err(px, rx) <= 1e-10, (pit, int(rit), _err(px, rx))
    a = pcinv.template_uptolmin(pgl(lmax), 2, device='cpu')
    b = rcinv.template_uptolmin(geom, 2)
    assert a.shape == (9, geom.nrings, geom.nphi) and _err(a, b) <= 1e-12
