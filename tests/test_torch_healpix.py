"""Port parity of the plain Legendre transforms and the HEALPix entry path.

* plain engine (twin of kernels K3/K4) against the reference's XLA engine at f64 on
  asymmetric ring sets with rings within 1e-3 of both poles, spins -3..3, mmax < lmax,
  batch 3: <= 1e-12 of max|ref| (both run the same f64 recursion; the difference is
  rounding of the sums);
* the same against the reference's Pallas K3/K4 in interpret mode at f32, lmax 24:
  <= 1e-5 of max, the reference's f32 bar (the port runs the recursion in f64, so the
  difference is the reference's own f32 recursion error, 2e-6..1e-5 of max here; with
  rings within 1e-3 of a pole it grows to 1.6e-5, which is why those rings are held to
  the f64 reference instead);
* HealpixGeometry and resample_to_rings equal to the reference's (same numpy code), ring
  weights to <= 1e-13 (QR against the reference's lstsq); HealpixSHT alm2map / map2alm
  (iter 0 and 2, with and without ring weights) and spin 2 at nside 16, lmax 32 against
  the reference: <= 1e-10 of max; the batched chirp-z DFTs of the polar caps against
  direct sums: <= 1e-12 of max;
* pixwin_exact(8, pol=True) against the reference (<= 1e-12) and its shipped table
  (<= 1e-10), pixwin above nside 128 equal to the reference's;
* fitsio files byte-identical to the reference's and cross-readable; ExternalAlmLib
  reads reference-written FITS/npy files to equal arrays;
* the HEALPix route (alm2map -> map2alm iter 3 -> FITS -> ExternalAlmLib -> IVFSepTP ->
  QELib ptt/p_p) against the same steps through the reference at nside 16: <= 1e-10.
The `cuda`-marked tests hold K3/K4 to the plain engine on the card.
"""
import os

import numpy as np
import pytest
import torch

from plancklens_tpu.ops.sht import core as rcore
from plancklens_tpu.ops.sht import healpix as rhp, pixwin as rpw
from plancklens_tpu.models import filt as rfilt, qest as rqest, sims as rsims
from plancklens_tpu.utils import alm as ralm, fitsio as rfits
from plancklens_tpu.ops.sht.geometry import gl_geometry as rgl
from plancklens_tpu_torch.ops.sht import core as pcore, legendre_kernels as lk
from plancklens_tpu_torch.ops.sht import healpix as php, pixwin as ppw
from plancklens_tpu_torch.ops.sht import HealpixGeometry, HealpixSHT, gl_geometry as pgl
from plancklens_tpu_torch.models import filt as pfilt, qest as pqest, sims as psims
from plancklens_tpu_torch.utils import fitsio as pfits, camb_clfile, cli
from plancklens_tpu_torch import DATAPATH

torch.set_num_threads(1)


def _c(rng, shape, dtype=np.complex128):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


def _err(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return np.abs(a - ref).max() / np.abs(ref).max()


def _t(a):
    return torch.from_numpy(np.array(a))


def _asym_theta(rng, nrings, margin=0.):
    """Sorted random colatitudes, not north-south symmetric; with margin 0 the first and
    last rings sit within 1e-3 of the poles."""
    th = np.sort(rng.uniform(margin + 0.01, np.pi - margin - 0.01, nrings))
    if margin == 0.:
        th[0], th[-1] = 7e-4, np.pi - 9e-4
    return th


def _alms(rng, shape, lmax, lmin=0):
    ls, ms = ralm._lm_indices(lmax)
    a = _c(rng, shape + (len(ls),))
    a[..., ms == 0] = a[..., ms == 0].real
    a[..., ls < lmin] = 0.
    return a


# ---------------------------------------------------------------- plain transforms
@pytest.mark.parametrize('n', [-3, -2, -1, 0, 1, 2, 3])
def test_plain_engine_matches_xla_f64(n):
    rng = np.random.RandomState(20 + n)
    for nrings, lmax, mmax in ((41, 32, 32), (42, 40, 24)):
        theta = _asym_theta(rng, nrings)
        assert not pcore.is_symmetric(theta)
        C = _c(rng, (3, lmax + 1, mmax + 1))
        G = pcore.legendre_synth(_t(C), n, theta)
        assert G.shape == (3, nrings, mmax + 1)
        assert _err(G, rcore.legendre_synth(C, n, theta)) <= 1e-12
        Q = _c(rng, (3, nrings, mmax + 1))
        A = pcore.legendre_anal(_t(Q), n, theta, lmax)
        assert A.shape == (3, lmax + 1, mmax + 1)
        assert _err(A, rcore.legendre_anal(Q, n, theta, lmax)) <= 1e-12


@pytest.mark.parametrize('nrings', [25, 26])
def test_plain_engine_matches_pallas_f32(nrings):
    """f32 against the TPU kernels K3/K4 themselves, in interpret mode on the CPU."""
    lmax = 24
    rng = np.random.RandomState(nrings)
    theta = _asym_theta(rng, nrings, margin=0.1)
    for n in (-3, -2, -1, 0, 1, 2, 3):
        for mmax in (lmax, 16):
            C = _c(rng, (3, lmax + 1, mmax + 1), np.complex64)
            G = pcore.legendre_synth(_t(C), n, theta)
            assert G.dtype == torch.complex64
            assert _err(G, rcore.legendre_synth(C, n, theta, engine='pallas')) <= 1e-5
            Q = _c(rng, (3, nrings, mmax + 1), np.complex64)
            A = pcore.legendre_anal(_t(Q), n, theta, lmax)
            assert _err(A, rcore.legendre_anal(Q, n, theta, lmax, engine='pallas')) <= 1e-5


def test_full_and_half_table_sets_kept_apart():
    """A symmetric grid used by the pair path (northern half) and by the plain path (all
    rings) under one grid token keeps two table sets."""
    theta = pgl(12).theta
    tok = ('test_tables', 12)
    pcore.legendre_synth_pair(torch.zeros((1, 13, 13), dtype=torch.complex128), None, 0,
                              theta, grid_token=tok)
    G = pcore.legendre_synth(_t(_c(np.random.RandomState(0), (1, 13, 13))), 0, theta,
                             grid_token=tok)
    assert G.shape == (1, 13, 13)
    half = pcore.TABLES.get(12, 12, 0, theta[:7], ('ns', tok), 'cpu')
    full = pcore.TABLES.get(12, 12, 0, theta, ('full', tok), 'cpu')
    assert half['x'].shape == (7,) and full['x'].shape == (13,)


def test_plain_kernel_wrappers_refuse_cpu_tensors():
    theta = _asym_theta(np.random.RandomState(1), 9)
    t = pcore.full_tables(8, 8, 2, theta, None, 'cpu')
    with pytest.raises(ValueError, match='CUDA'):
        lk.synth(torch.zeros((1, 9, 9), dtype=torch.complex64), 9, t)
    with pytest.raises(ValueError, match='CUDA'):
        lk.anal(torch.zeros((1, 9, 9), dtype=torch.complex64), 8, t)


# ---------------------------------------------------------------- HEALPix
NSIDE, LMAX = 16, 32


def test_healpix_geometry_equal():
    for nside in (1, 2, 16):
        r, p = rhp.HealpixGeometry(nside), HealpixGeometry(nside)
        for k in ('theta', 'nphi', 'phi0', 'ofs'):
            assert np.array_equal(getattr(p, k), getattr(r, k)), k
        assert (p.npix, p.omega, p.nrings, p.token()) == (r.npix, r.omega, r.nrings, r.token())
    # QR here, numpy's SVD-based lstsq in the reference: the system's condition number
    # is ~2 nside, so the minimal-norm solutions agree to rounding
    assert _err(HealpixGeometry(NSIDE).ring_weights(device='cpu'),
                rhp.HealpixGeometry(NSIDE).ring_weights()) <= 1e-13


def test_resample_to_rings_equal():
    m = np.random.RandomState(2).standard_normal(12 * 8 ** 2)
    assert np.array_equal(php.resample_to_rings(m, 8, pgl(20)),
                          rhp.resample_to_rings(m, 8, rgl(20)))


@pytest.mark.parametrize('use_w', [True, False])
def test_healpix_sht_matches_reference(use_w):
    rng = np.random.RandomState(3)
    r = rhp.HealpixSHT(NSIDE, LMAX, use_ring_weights=use_w)
    p = HealpixSHT(NSIDE, LMAX, use_ring_weights=use_w, device='cpu')
    tlm = _alms(rng, (2,), LMAX)
    m = np.asarray(r.alm2map(tlm))
    pm = p.alm2map(_t(tlm))
    assert pm.shape == (2, 12 * NSIDE ** 2) and _err(pm, m) <= 1e-10
    for it in (0, 2):
        assert _err(p.map2alm(_t(m), iter=it), r.map2alm(m, iter=it)) <= 1e-10
    g, c = _alms(rng, (2,), LMAX, 2), _alms(rng, (2,), LMAX, 2)
    q, u = r.alm2map_spin((g, c), 2)
    pq, pu = p.alm2map_spin((_t(g), _t(c)), 2)
    assert _err(pq, q) <= 1e-10 and _err(pu, u) <= 1e-10
    for it in (0, 2):
        G, C = r.map2alm_spin((q, u), 2, iter=it)
        PG, PC = p.map2alm_spin((_t(q), _t(u)), 2, iter=it)
        assert _err(PG, G) <= 1e-10 and _err(PC, C) <= 1e-10


@pytest.mark.parametrize('chunk', [256, 4])
def test_cap_dft_matches_direct_sums(monkeypatch, chunk):
    """The batched chirp-z DFTs of the polar-cap rings (one or several chunks of ring
    sizes) against direct sums over m and k at nside 8 with mmax 40 > nphi of the small
    rings (so m folds mod nphi): <= 1e-12 of max."""
    monkeypatch.setattr(php._CapDFT, 'CHUNK', chunk)
    nside, lmax = 8, 40
    g = HealpixGeometry(nside)
    sht = HealpixSHT(nside, lmax, device='cpu')
    rng = np.random.RandomState(8)
    F = _c(rng, (2, g.nrings, lmax + 1))
    maps = rng.standard_normal((2, g.npix))
    m, G = sht._rings_to_map(_t(F)).numpy(), sht._map_to_rings(_t(maps)).numpy()
    mm = np.arange(lmax + 1)
    for r in [*range(nside - 1), *range(3 * nside, 4 * nside - 1)]:
        phis = g.phi0[r] + 2. * np.pi * np.arange(g.nphi[r]) / g.nphi[r]
        px = slice(g.ofs[r], g.ofs[r] + g.nphi[r])
        f = F[:, r, :1].real + 2. * (F[:, r, 1:] @ np.exp(1j * np.outer(mm[1:], phis))).real
        assert _err(m[:, px], f) <= 1e-12
        assert _err(G[:, r], maps[:, px] @ np.exp(-1j * np.outer(phis, mm))) <= 1e-12


def test_healpix_sht_refuses_tensors_on_another_device():
    sht = HealpixSHT(4, 8, device='cpu')
    off = torch.zeros((1, ralm.getsize(8)), dtype=torch.complex128, device='meta')
    with pytest.raises(ValueError, match='transform on cpu'):
        sht.alm2map(off)
    with pytest.raises(ValueError, match='transform on cpu'):
        sht.map2alm(torch.zeros((1, 12 * 16), device='meta'))


# ---------------------------------------------------------------- pixel windows
def test_pixwin_exact_matches_reference_and_table():
    wt, wp = ppw.pixwin_exact(8, pol=True, device='cpu')
    rt, rp = rpw.pixwin_exact(8, pol=True)
    assert _err(wt, rt) <= 1e-12 and _err(wp, rp) <= 1e-12
    shipped = np.load(os.path.join(DATAPATH, 'pixwin', 'pixwin_n0008_pol.npy'))
    assert _err(wt, shipped[0]) <= 1e-10 and _err(wp, shipped[1]) <= 1e-10
    assert np.array_equal(ppw.pixwin_tophat(8, 32), rpw.pixwin_tophat(8, 32))


def test_pixwin_richardson_equal_to_reference():
    for pol in (False, True):
        p, r = ppw.pixwin(256, 512, pol=pol, device='cpu'), rpw.pixwin(256, 512, pol=pol)
        assert all(np.array_equal(a, b) for a, b in zip(np.atleast_2d(p), np.atleast_2d(r)))
    assert np.array_equal(php.pixwin(64, 200, device='cpu'), rhp.pixwin(64, 200))


# ---------------------------------------------------------------- FITS and external alms
def test_fitsio_byte_identical_and_cross_readable(tmp_path):
    rng = np.random.RandomState(4)
    alm = _alms(rng, (), 12)
    maps = rng.standard_normal((3, 12 * 16 ** 2))
    cls = rng.standard_normal((4, 30))
    for name, write, args in (('alm', 'write_alm', (alm,)), ('map', 'write_map', (maps,)),
                              ('cl', 'write_cl', (cls,))):
        fp, fr = str(tmp_path / ('p_' + name)), str(tmp_path / ('r_' + name))
        getattr(pfits, write)(fp, *args)
        getattr(rfits, write)(fr, *args)
        with open(fp, 'rb') as f1, open(fr, 'rb') as f2:
            assert f1.read() == f2.read(), name
    assert np.array_equal(pfits.read_alm(str(tmp_path / 'r_alm')), alm)
    assert np.array_equal(rfits.read_alm(str(tmp_path / 'p_alm')), alm)
    assert np.array_equal(pfits.read_map(str(tmp_path / 'r_map'), field=2), maps[2])
    assert np.array_equal(pfits.read_cl(str(tmp_path / 'r_cl')), cls)


@pytest.mark.parametrize('ext', ['fits', 'npy'])
def test_external_alm_lib_reads_reference_files(tmp_path, ext):
    rng = np.random.RandomState(5)
    alms = {(f, i): _alms(rng, (), 10) for f in 'teb' for i in (-1, 0, 1)}
    for (f, i), a in alms.items():
        fn = str(tmp_path / ('sim_%slm_%s.%s' % (f, 'dat' if i == -1 else '%04d' % i, ext)))
        if ext == 'fits':
            rfits.write_alm(fn, a)
        else:
            np.save(fn, a)
    r = rsims.ExternalAlmLib(str(tmp_path), ext=ext)
    p = psims.ExternalAlmLib(str(tmp_path), ext=ext, device='cpu')
    assert p.hashdict() == r.hashdict()
    for i in (-1, 0, 1):
        assert np.array_equal(p.get_sim_elm(i), np.asarray(r.get_sim_elm(i)))
    for pb, rb in zip(p.get_sim_teblm_batch([0, 1]), r.get_sim_teblm_batch([0, 1])):
        assert pb.dtype == torch.complex128 and np.array_equal(pb, np.asarray(rb))


# ---------------------------------------------------------------- the HEALPix route
def test_healpix_route_matches_reference(tmp_path):
    """alm2map -> map2alm(iter=3) -> FITS -> ExternalAlmLib -> IVFSepTP -> QELib."""
    nside, lmax = 16, 16
    rng = np.random.RandomState(6)
    cl = camb_clfile(os.path.join(DATAPATH, 'cls', 'FFP10_wdipole_lensedCls.dat'), lmax=lmax)
    teb = {f: _alms(rng, (2,), lmax, 0 if f == 't' else 2) for f in 'teb'}
    out = {}
    for name, hp, wrap in (('r', rhp.HealpixSHT(nside, lmax, use_ring_weights=False),
                            np.asarray),
                           ('p', HealpixSHT(nside, lmax, use_ring_weights=False,
                                            device='cpu'), lambda x: x.numpy())):
        tdir = tmp_path / name
        tdir.mkdir()
        cast = (lambda a: a) if name == 'r' else _t
        tmap = hp.alm2map(cast(teb['t']))
        qmap, umap = hp.alm2map_spin((cast(teb['e']), cast(teb['b'])), 2)
        tlm = wrap(hp.map2alm(tmap, iter=3))
        elm, blm = (wrap(a) for a in hp.map2alm_spin((qmap, umap), 2, iter=3))
        fits = rfits if name == 'r' else pfits
        for f, a in zip('teb', (tlm, elm, blm)):
            for i in range(2):
                fits.write_alm(str(tdir / ('sim_%slm_%04d.fits' % (f, i))), a[i])
        ftl, fel, fbl = (cli(cl[k] + 1e-5) for k in ('tt', 'ee', 'bb'))
        tr = np.ones(lmax + 1)
        if name == 'r':
            ivfs = rfilt.IVFSepTP(rsims.ExternalAlmLib(str(tdir), ext='fits'), tr, cl,
                                  ftl, fel, fbl)
            q = rqest.QELib(ivfs, ivfs, cl, lmax, lmax)
        else:
            ivfs = pfilt.IVFSepTP(psims.ExternalAlmLib(str(tdir), ext='fits', device='cpu'),
                                  tr, cl, ftl, fel, fbl)
            q = pqest.QELib(ivfs, ivfs, cl, lmax, lmax, device='cpu')
        out[name] = {'alm': (tlm, elm, blm),
                     'qlm': [np.asarray(q.get_sim_qlm_batch(k, [0, 1])) for k in ('ptt', 'p_p')]}
    for a, b in zip(out['p']['alm'], out['r']['alm']):
        assert _err(a, b) <= 1e-10
    for a, b in zip(out['p']['qlm'], out['r']['qlm']):
        assert _err(a, b) <= 1e-10
    # the round trip itself: iter 3 at lmax = nside recovers the alms to ~1e-3 or better
    assert _err(out['p']['alm'][0], teb['t']) <= 1e-2


# ---------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda:0')


@pytest.mark.cuda
@pytest.mark.parametrize('nrings', [63, 64])
def test_plain_kernels_match_plain_on_card(cuda_device, nrings):
    """K3/K4 against the plain engine on the card, rings within 1e-3 of both poles:
    f32 <= 1e-5, f64 <= 1e-12 of max; K4 bitwise reproducible."""
    lmax = 48
    rng = np.random.RandomState(nrings)
    theta = _asym_theta(rng, nrings)
    gen = torch.Generator(device=cuda_device).manual_seed(nrings)
    for cdt, tol in ((torch.complex64, 1e-5), (torch.complex128, 1e-12)):
        for n in (-3, -2, -1, 0, 1, 2, 3):
            for mmax in (lmax, 30):
                t = pcore.full_tables(lmax, mmax, n, theta, None, cuda_device)
                C = torch.randn((3, lmax + 1, mmax + 1), generator=gen, device=cuda_device,
                                dtype=cdt)
                Q = torch.randn((3, nrings, mmax + 1), generator=gen, device=cuda_device,
                                dtype=cdt)
                assert _err(lk.synth(C, nrings, t).cpu(),
                            pcore.legendre_synth_plain(C, t).cpu()) <= tol
                A = lk.anal(Q, lmax, t)
                assert _err(A.cpu(), pcore.legendre_anal_plain(Q, lmax, t).cpu()) <= tol
                assert torch.equal(lk.anal(Q, lmax, t), A)


@pytest.mark.cuda
def test_ring_weights_on_card(cuda_device):
    """The QR solve on the card against the reference's host lstsq: <= 1e-13."""
    assert _err(HealpixGeometry(64).ring_weights(device=cuda_device),
                rhp.HealpixGeometry(64).ring_weights()) <= 1e-13


@pytest.mark.cuda
def test_healpix_sht_refuses_card_tensors_off_its_device(cuda_device):
    nalm = ralm.getsize(8)
    with pytest.raises(ValueError, match='transform on cpu'):
        HealpixSHT(4, 8, device='cpu').alm2map(torch.zeros((1, nalm), dtype=torch.complex128,
                                                           device=cuda_device))
    sht = HealpixSHT(4, 8, device=cuda_device)
    tlm = torch.zeros((1, nalm), dtype=torch.complex128, device=cuda_device)
    with pcore.counting() as c:
        assert sht.alm2map(tlm).is_cuda
    legendre = [r for r in c.records if r['name'] == 'sht.legendre']
    assert [r['attrs'].get('kernel') for r in legendre] == ['K3']
    assert c.calls == {('K3', 3, 1, 'f64'): 1}
