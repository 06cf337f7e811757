"""Port parity of the masked filtering route: sims.AlmMapLib -> cinv.IVFCinv ->
filt.IVFFtl -> qest.QELib, against the same chain of plancklens_tpu on the same numpy
inputs (the reference's unit phases injected through compat.phases_from_numpy), f64, on
the CPU.

  * AlmMapLib maps and IVFFtl alms/filters equal the reference's to 1e-12 of max;
  * the route's ptt and p_p qlms agree to 1e-9 relative rms, sim by sim (two sims at
    lmax 32, each filtered alone, as the reference does);
  * IVFCinv's caches: a warm start from the stored Wiener solution converges at once
    (mirror of tests/test_cinv.py:273), and a filled alm cacher serves a fresh adapter;
  * the f32 filter, held to the f64 one: the f32 solution's residual in the f64 system
    stays within 1e-4 of the right-hand side;
  * utils.maps.read_map reads every map spec as the reference does; the probed dense
    preconditioner equals the reference's to 1e-12 on a well-conditioned system, the probed
    block equals the analytic one, and a block cached by the reference under its key loads
    in the port under the same key.
"""
import os
import sys

import numpy as np
import pytest
import torch

from plancklens_tpu import DATAPATH
from plancklens_tpu.utils import camb_clfile, cli
from plancklens_tpu.utils.cachers import cacher_npy as rcacher_npy
from plancklens_tpu.ops.sht import gl_geometry as rgl
from plancklens_tpu.models import cinv as rcinv, sims as rsims, filt as rfilt, qest as rqest
from plancklens_tpu_torch import compat
from plancklens_tpu_torch.ops import cg as pcg
from plancklens_tpu_torch.ops.sht import gl_geometry as pgl
from plancklens_tpu_torch.models import cinv as pcinv, sims as psims, filt as pfilt, \
    qest as pqest
from plancklens_tpu_torch.utils import alm as palm
from plancklens_tpu_torch.utils.cachers import cacher_mem, cacher_npy as pcacher_npy

torch.set_num_threads(1)

LMAX = 32
LMIN = 4


def _err(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return np.abs(a - ref).max() / np.abs(ref).max()


def _rel_rms(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return np.sqrt(np.sum(np.abs(a - ref) ** 2) / np.sum(np.abs(ref) ** 2))


def _libs(idxs):
    """Reference and port MapsNlevLib over the same unit phases, their AlmMapLibs on the
    GL grid of LMAX, the spectra, beam, and the masked T/P inverse pixel variances."""
    cls = camb_clfile(os.path.join(DATAPATH, 'cls', 'FFP10_wdipole_lensedCls.dat'), lmax=LMAX)
    transf = np.exp(-0.5 * np.arange(LMAX + 1) * np.arange(1, LMAX + 2) * 1e-4)
    rcmb = rsims.CMBUnlLib(cls, LMAX, fields=('t', 'e', 'b'), seed=5)
    robs = rsims.MapsNlevLib(rcmb, transf, 35., 55., seed=6)
    ph_c = {i: np.asarray(rsims.unit_phases(rsims.sim_key(rcmb._base_key, i), 3, LMAX))
            for i in idxs}
    ph_n = {i: np.asarray(rsims.unit_phases(rsims.sim_key(robs._noise_key, i), 3, LMAX))
            for i in idxs}
    pcmb = psims.CMBUnlLib(cls, LMAX, fields=('t', 'e', 'b'), seed=5, device='cpu',
                           phases=compat.phases_from_numpy(ph_c))
    pobs = psims.MapsNlevLib(pcmb, transf, 35., 55., seed=6,
                             phases=compat.phases_from_numpy(ph_n))
    rgeom, pgeom = rgl(LMAX), pgl(LMAX)
    rmaps = rsims.AlmMapLib(robs, rgeom, LMAX)
    pmaps = psims.AlmMapLib(pobs, pgeom, LMAX, device='cpu')
    omega = np.outer(rgeom.weight, np.full(rgeom.nphi, 2 * np.pi / rgeom.nphi))
    cut = np.abs(np.cos(rgeom.theta))[:, None] > 0.2
    # noise levels of the filters well above the sims' keep the masked systems at ~30
    # iterations, where the two packages' solutions agree to ~1e-12 (test_torch_cinv.py)
    ninv_t = omega / (1000. / 60. / 180. * np.pi) ** 2 * cut
    ninv_p = omega / (300. / 60. / 180. * np.pi) ** 2 * cut
    return cls, transf, (rmaps, pmaps), (rgeom, pgeom), ninv_t, ninv_p


def test_almmaplib_and_ivfftl_match_reference():
    idxs = [0, 1]
    cls, transf, (rmaps, pmaps), _, _, _ = _libs(idxs)
    assert pmaps.hashdict() == rmaps.hashdict()
    for i in idxs:
        assert _err(pmaps.get_sim_tmap(i), rmaps.get_sim_tmap(i)) <= 1e-12
        for a, b in zip(pmaps.get_sim_pmap(i), rmaps.get_sim_pmap(i)):
            assert _err(a, b) <= 1e-12
    fl = [np.ones(LMAX + 1) * (np.arange(LMAX + 1) >= LMIN)] * 3
    lt, le, lb = [(np.arange(LMAX + 1) >= l0) * 1. for l0 in (LMIN, LMIN + 1, LMIN + 2)]
    rsep = rfilt.IVFSepTP(rmaps.alm_lib, transf, cls, *fl)
    psep = pfilt.IVFSepTP(pmaps.alm_lib, transf, cls, *fl)
    r, p = rfilt.IVFFtl(rsep, lt, le, lb), pfilt.IVFFtl(psep, lt, le, lb)
    assert p.hashdict() == r.hashdict()
    for f in ('ftl', 'fel', 'fbl'):
        assert np.array_equal(getattr(p, 'get_' + f)(), getattr(r, 'get_' + f)())
    for i in idxs:
        for f in 'teb':
            for kind in ('lm', 'mliklm'):
                name = 'get_sim_%s%s' % (f, kind)
                assert _err(getattr(p, name)(i), getattr(r, name)(i)) <= 1e-12, name


def test_ivfcinv_ivfftl_qelib_route_matches_reference():
    """Masked T and P filtering of two sims, one at a time, then the l >= LMIN cut and
    the ptt / p_p QEs: the qlms within 1e-9 relative rms of the reference's."""
    idxs = [0, 1]
    cls, transf, (rmaps, pmaps), (rgeom, pgeom), ninv_t, ninv_p = _libs(idxs)
    kw_t = dict(eps_min=1e-5, iter_max=400, lmax_dense=24)
    kw_p = dict(eps_min=1e-5, iter_max=400, lmax_dense=8)
    ivf_r = rcinv.IVFCinv(rcinv.CinvT(LMAX, rgeom, cls, transf, ninv_t, **kw_t),
                          rcinv.CinvP(LMAX, rgeom, cls, transf, ninv_p, **kw_p), rmaps, cls)
    ivf_p = pcinv.IVFCinv(pcinv.CinvT(LMAX, pgeom, cls, transf, ninv_t, device='cpu', **kw_t),
                          pcinv.CinvP(LMAX, pgeom, cls, transf, ninv_p, device='cpu', **kw_p),
                          pmaps, cls)
    assert ivf_p.hashdict() == ivf_r.hashdict()
    cut = [(np.arange(LMAX + 1) >= LMIN) * 1.] * 3
    ivfs_r, ivfs_p = rfilt.IVFFtl(ivf_r, *cut), pfilt.IVFFtl(ivf_p, *cut)
    # the port's batch accessor (each sim frozen at its own convergence) reaches through
    # IVFFtl; get_sim_qlm below still filters sim by sim, as the reference does
    assert hasattr(ivf_p, 'get_sim_teblm_batch') and hasattr(ivfs_p, 'get_sim_teblm_batch')
    for f in ('ftl', 'fel', 'fbl'):
        assert _err(getattr(ivfs_p, 'get_' + f)(), getattr(ivfs_r, 'get_' + f)()) <= 1e-13
    assert np.array_equal(ivf_p.get_fmask(), ivf_r.get_fmask())
    qr = rqest.QELib(ivfs_r, ivfs_r, cls, LMAX, LMAX)
    qp = pqest.QELib(ivfs_p, ivfs_p, cls, LMAX, LMAX, device='cpu')
    for k in ('ptt', 'p_p'):
        for i in idxs:
            got, ref = qp.get_sim_qlm(k, i), qr.get_sim_qlm(k, i)
            assert got.dtype == torch.complex128
            assert _rel_rms(got, ref) <= 1e-9, (k, i, _rel_rms(got, ref))
    for i in idxs:
        assert _err(ivf_p.get_sim_tmliklm(i), ivf_r.get_sim_tmliklm(i)) <= 1e-9
        assert _err(ivf_p.get_sim_emliklm(i), ivf_r.get_sim_emliklm(i)) <= 1e-9


def test_ivfcinv_warm_start_and_caches():
    """The solution store warm-starts a fresh adapter, which converges at once (mirror of
    tests/test_cinv.py:273); a filled alm cacher serves a fresh adapter without a solve."""
    idxs = [0]
    cls, transf, (_, pmaps), (_, pgeom), ninv_t, ninv_p = _libs(idxs)
    ninv_t = ninv_t * (1000. / 30.) ** 2           # Planck-like T noise: ~100 iterations
    cinv_t = pcinv.CinvT(LMAX, pgeom, cls, transf, ninv_t, eps_min=1e-5, iter_max=400,
                         lmax_dense=16, device='cpu')
    tmap = pmaps.get_sim_tmap(0)
    x, it0, rel = cinv_t.solve_wf(tmap)
    assert float(rel.max()) < 1e-5 and it0 > 20
    _, it1, _ = cinv_t.solve_wf(tmap, x0=x)
    assert it1 <= max(1, it0 // 10), (it0, it1)
    cinv_p = pcinv.CinvP(LMAX, pgeom, cls, transf, ninv_p, lmax_dense=8, device='cpu')
    soltn, alms = cacher_mem(), cacher_mem()
    ivfs = pcinv.IVFCinv(cinv_t, cinv_p, pmaps, cls, cacher=alms, soltn_cacher=soltn)
    t0, e0 = ivfs.get_sim_tlm(0), ivfs.get_sim_elm(0)
    assert soltn.is_cached('wf_t_00000') and soltn.is_cached('wf_p_00000')
    assert all(alms.is_cached('ivf_%slm_00000' % f) for f in 'teb')
    counts = []
    fwd = cinv_t.fwd_op
    cinv_t.fwd_op = lambda v: counts.append(1) or fwd(v)
    warm = pcinv.IVFCinv(cinv_t, cinv_p, pmaps, cls, soltn_cacher=soltn)
    assert _err(warm.get_sim_tlm(0), t0) < 1e-5 and len(counts) <= 3
    cinv_t.fwd_op = fwd

    class _NoSims:
        def get_sim_tmap(self, idx):
            raise AssertionError('should have been served from the cacher')
        get_sim_pmap = get_sim_tmap

        def hashdict(self):
            return {}
    cached = pcinv.IVFCinv(cinv_t, cinv_p, _NoSims(), cls, cacher=alms)
    assert torch.equal(cached.get_sim_tlm(0), t0) and torch.equal(cached.get_sim_elm(0), e0)


def test_cinv_f32_held_to_f64():
    """f32 filters: T (no templates, dense block) and P, each solution's residual in the
    f64 system within 1e-4 of the right-hand side."""
    cls, transf, (_, pmaps), (_, pgeom), ninv_t, ninv_p = _libs([0])
    tmap, (q, u) = pmaps.get_sim_tmap(0), pmaps.get_sim_pmap(0)
    w = pcg._weights(pcinv._lm_ms(LMAX), torch.device('cpu'))
    for field in 'tp':
        out = {}
        for dt in (torch.float64, torch.float32):
            if field == 't':
                c = pcinv.CinvT(LMAX, pgeom, cls, transf, ninv_t, lmax_dense=16,
                                marge_monopole=False, marge_dipole=False, dtype=dt,
                                device='cpu')
                out[dt] = (c, c.solve_wf(tmap)[0], c.calc_prep(tmap[None]))
            else:
                c = pcinv.CinvP(LMAX, pgeom, cls, transf, ninv_p, lmax_dense=8, dtype=dt,
                                device='cpu')
                out[dt] = (c, c.solve_wf(q, u)[0], c.calc_prep(q[None], u[None]))
        c64, x64, b64 = out[torch.float64]
        _, x32, _ = out[torch.float32]
        assert x32.dtype == torch.complex64
        r = (b64 - c64.fwd_op(x32.to(torch.complex128))).reshape(1, -1)
        b = b64.reshape(1, -1)
        ww = w.repeat(r.shape[-1] // len(w))
        rel = float(torch.sqrt(pcg._dot(r, r, ww) / pcg._dot(b, b, ww)))
        assert rel < 1e-4, (field, rel)


def test_masked_path_on_cpu(monkeypatch):
    """The masked path chip_smoke.py phases 6b-6d drive (examples/masked_filter_torch.py), at
    lmax 32 on the CPU: every solve converges below 1e-5 and the route's qlms are finite;
    its configuration's beam and noise are the reference parameter file's
    (n0s.gauss_beam, sims.MapsLenNlevLib.ninv_t/ninv_p)."""
    from types import SimpleNamespace
    from plancklens_tpu.models.n0s import gauss_beam
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(root, 'examples'))
    import masked_filter_torch as mf
    geom, transf, ninv = mf.aniso_inputs(LMAX)
    assert np.allclose(transf, gauss_beam(5., lmax=LMAX), rtol=1e-14, atol=0)
    rlib = rsims.MapsLenNlevLib(SimpleNamespace(geom=rgl(LMAX), lmax=LMAX), transf, 35., 55.)
    mask = ninv['t'] > 0
    assert 0.5 < mask.mean() < 0.95 and np.array_equal(mask, ninv['p'] > 0)
    assert np.allclose(ninv['t'], rlib.ninv_t() * mask, rtol=1e-14, atol=0)
    assert np.allclose(ninv['p'], rlib.ninv_p() * mask, rtol=1e-14, atol=0)
    for k, v in (('PLK_LMAX_IVF', LMAX), ('PLK_LMAX_QLM', LMAX), ('PLK_NSIMS', 8),
                 ('PLK_DEVICE', 'cpu')):
        monkeypatch.setenv(k, str(v))
    monkeypatch.delenv('PLK_CACHE_DIR', raising=False)
    import run_qlms_torch as drv
    par = drv.load_parfile(os.path.join(root, 'params', 'idealized_example_torch.py'))
    out = mf.masked_path(par, 'cpu', LMAX, dense_t=16, dense_p=8, f32=True, log=lambda s: None)
    for step, batch in (('t', 8), ('p', 4)):
        assert out[step + '_x'].shape[0] == batch and out[step]['it'] > 1
        assert np.all(out[step]['rel'] < 1e-5)
    assert np.all(out['t']['true_rel'] < 1e-5) and out['p_probe']['chunk'] == 256
    for q in out['route_qlms'].values():
        assert tuple(q.shape) == (2, palm.getsize(LMAX)) and bool(torch.isfinite(q).all())


def test_read_map_matches_reference(tmp_path):
    """utils.maps.read_map: arrays, .npy, .npz, FITS (written by the port's fitsio),
    callables and list products, as the reference reads them."""
    from plancklens_tpu.utils.maps import read_map as rread
    from plancklens_tpu_torch.utils.maps import read_map as pread
    from plancklens_tpu_torch.utils import fitsio
    rng = np.random.RandomState(5)
    m = rng.uniform(0.5, 2., 12 * 4 ** 2)
    np.save(tmp_path / 'm.npy', m)
    np.savez(tmp_path / 'm.npz', map=2. * m)
    fitsio.write_map(str(tmp_path / 'm.fits'), m)
    specs = [m, str(tmp_path / 'm.npy'), str(tmp_path / 'm.npz'), str(tmp_path / 'm.fits'),
             lambda: 3. * m, [m, str(tmp_path / 'm.npy'), lambda: m > 1.]]
    for spec in specs:
        got, ref = pread(spec), rread(spec)
        assert got.dtype == np.float64 and np.array_equal(got, ref)
    with pytest.raises(ValueError):
        pread(str(tmp_path / 'm.txt'))


def test_dense_pre_op_matches_reference():
    """The probed (unstacked) dense preconditioner against the reference's, on the masked
    1000 uK-arcmin T system (well conditioned): 1e-12 of max at l >= 2 (the monopole and
    dipole are marginalised: there both carry only rounding)."""
    _, _, (rmaps, pmaps), (rgeom, pgeom), ninv_t, _ = _libs([0])
    cls = camb_clfile(os.path.join(DATAPATH, 'cls', 'FFP10_wdipole_lensedCls.dat'), lmax=LMAX)
    r = rcinv.CinvT(LMAX, rgeom, cls, np.ones(LMAX + 1), ninv_t, lmax_dense=0)
    p = pcinv.CinvT(LMAX, pgeom, cls, np.ones(LMAX + 1), ninv_t, lmax_dense=0, device='cpu')
    x = np.asarray(r.calc_prep(np.asarray(rmaps.get_sim_tmap(0))[None]))
    got = pcinv.dense_pre_op(p.fwd_op, 12, LMAX, device='cpu')(torch.as_tensor(x))
    ref = np.asarray(rcinv.dense_pre_op(r.fwd_op, 12, LMAX)(x))
    hi = palm._lm_indices(LMAX)[0] >= 2
    assert _err(got.numpy()[:, hi], ref[:, hi]) <= 1e-12


@pytest.mark.parametrize('marge', [False, True])
def test_probed_block_is_the_analytic_block(marge):
    """The masked T forward operator probed on its l <= 12 basis (`dense_pre_op`'s block,
    chunks of 50) equals the host analytic block of the same rescaled system to 1e-12 of
    max: the probe, the analytic block and the operator agree with one another."""
    cls, transf, _, (_, pgeom), ninv_t, _ = _libs([])
    c = pcinv.CinvT(LMAX, pgeom, cls, transf, ninv_t * 100., lmax_dense=0, device='cpu',
                    marge_monopole=marge, marge_dipole=marge)
    M = pcinv._probe(c.fwd_op, 12, LMAX, 1, 50, torch.float64, torch.device('cpu'))
    bdl = transf * cli(c.rescal_cl)
    Ma = pcinv.dense_block_analytic_t(c.filt, 12, c.dl[:13], bdl[:13])
    assert _err(M, Ma) <= 1e-12, _err(M, Ma)


@pytest.mark.parametrize('field', ['t', 'p'])
def test_dense_cache_read_across_packages(tmp_path, monkeypatch, field):
    """The reference caches its inverted dense block; the port finds it under the same key
    (building nothing) and applies it as the reference does (1e-13 of max)."""
    cls, transf, (rmaps, _), (rgeom, pgeom), ninv_t, ninv_p = _libs([0])
    if field == 't':
        r = rcinv.CinvT(LMAX, rgeom, cls, transf, ninv_t, lmax_dense=12,
                        dense_cacher=rcacher_npy(str(tmp_path)))
        monkeypatch.setattr(pcinv, 'dense_block_analytic_t', None)   # must not be built
        p = pcinv.CinvT(LMAX, pgeom, cls, transf, ninv_t, lmax_dense=12, device='cpu',
                        dense_cacher=pcacher_npy(str(tmp_path)))
        x = np.asarray(r.calc_prep(np.asarray(rmaps.get_sim_tmap(0))[None]))
    else:
        r = rcinv.CinvP(LMAX, rgeom, cls, transf, ninv_p, lmax_dense=8,
                        dense_cacher=rcacher_npy(str(tmp_path)))
        monkeypatch.setattr(pcinv, '_probe', None)                  # must not be probed
        p = pcinv.CinvP(LMAX, pgeom, cls, transf, ninv_p, lmax_dense=8, device='cpu',
                        dense_cacher=pcacher_npy(str(tmp_path)))
        q, u = rmaps.get_sim_pmap(0)
        x = np.asarray(r.calc_prep(np.asarray(q)[None], np.asarray(u)[None]))
    keys = [f[:-4] for f in os.listdir(tmp_path)]
    assert len(keys) == 1 and keys[0].startswith('dense_%s_' % ('tta' if field == 't' else 'pp'))
    assert _err(p.pre_op(torch.as_tensor(x)), r.pre_op(x)) <= 1e-13
