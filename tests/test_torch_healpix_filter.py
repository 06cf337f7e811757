"""The map-based full-sky filter of the port (models/sims.HealpixMapLib and HealpixAlmLib
into models/filt.IVFSepTP, the twins of plancklens maps.cmb_maps and
filt_simple.library_fullsky_sepTP) against the benchmark's plain reference
(portbench/reference/healpix.py: its own RING layout, the reference recurrence, an
explicit DFT per ring), on seeded alms at nside 16 and 32 with lmax 2 nside, batch 3, f64;
the HEALPix transforms' spans and counters (ops/sht/healpix.py); and, on the card, the
nside-2048 synthesis on a sample of rings and the analysis as its adjoint."""
import os
import sys

import numpy as np
import pytest
import torch

from plancklens_tpu_torch.models.filt import IVFSepTP, IVFShuffle
from plancklens_tpu_torch.models.sims import HealpixAlmLib, HealpixMapLib
from plancklens_tpu_torch.ops.sht.healpix import HealpixSHT
from plancklens_tpu_torch.utils import trace
from plancklens_tpu_torch.utils.cachers import cacher_mem

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
from portbench.reference import healpix as ref  # noqa: E402

IDXS = [3, -1, 7]
CASES = [(16, 32), (32, 64)]


class SeededAlms:
    """Alm library: complex Gaussian T, E, B alms of a red spectrum from a seed per (sim,
    field); m = 0 real, E and B zero below l = 2; on `device`."""

    def __init__(self, lmax, device='cpu'):
        self.lmax = lmax
        self.device = torch.device(device)
        ls = np.concatenate([np.arange(m, lmax + 1) for m in range(lmax + 1)])
        ms = np.concatenate([np.full(lmax + 1 - m, m) for m in range(lmax + 1)])
        self._amp = torch.as_tensor(1. / (ls + 1.) ** 1.5)
        self._m0 = torch.as_tensor(ms == 0)
        self._low = torch.as_tensor(ls < 2)

    def hashdict(self):
        return {'lmax': self.lmax}

    def _alm(self, idx, f):
        g = torch.Generator().manual_seed(100 * (idx + 1) + f)
        n = len(self._amp)
        a = torch.complex(torch.randn(n, generator=g, dtype=torch.float64),
                          torch.randn(n, generator=g, dtype=torch.float64)) * self._amp
        a = torch.where(self._m0, a.real.to(a.dtype), a)
        a = a if f == 0 else torch.where(self._low, torch.zeros_like(a), a)
        return a.to(self.device)

    def get_sim_tlm(self, idx):
        return self._alm(idx, 0)

    def get_sim_elm(self, idx):
        return self._alm(idx, 1)

    def get_sim_blm(self, idx):
        return self._alm(idx, 2)

    def get_sim_teblm_batch(self, idxs):
        return tuple(torch.stack([self._alm(i, f) for i in idxs]) for f in range(3))


def _spectra(lmax):
    ls = np.arange(lmax + 1)
    transf = np.exp(-0.5 * ls * (ls + 1) * 0.02 ** 2)
    ftl = 1. / (1. + ls) ** 0.5
    fel, fbl = 2. * ftl, 0.5 * ftl
    fel[:2] = fbl[:2] = 0.
    cl = {k: 1. / (1. + ls) ** 2 for k in ('tt', 'ee', 'bb')}
    return transf, cl, ftl, fel, fbl


def _filter(nside, lmax):
    transf, cl, ftl, fel, fbl = _spectra(lmax)
    maps = HealpixMapLib(SeededAlms(lmax), nside, lmax, device='cpu')
    return IVFSepTP(HealpixAlmLib(maps), transf, cl, ftl, fel, fbl)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture(autouse=True)
def fresh_tracer():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


@pytest.mark.parametrize('nside,lmax', CASES)
def test_maps_match_the_reference(nside, lmax):
    lib = HealpixMapLib(SeededAlms(lmax), nside, lmax, device='cpu')
    sht = ref.HealpixSHT(nside, lmax, device='cpu')
    alms = lib.alm_lib
    t, e, b = (torch.stack([getattr(alms, 'get_sim_%slm' % f)(i) for i in IDXS]) for f in 'teb')
    rt = sht.alm2map(t)
    rq, ru = sht.alm2map_spin(e, b, 2)
    pt, pq, pu = lib.get_sim_tqumap_batch(IDXS)
    assert pt.shape == (3, 12 * nside ** 2)
    for p, r in ((pt, rt), (pq, rq), (pu, ru)):
        assert _rel(p, r) <= 1e-12
    for j, i in enumerate(IDXS):
        assert _rel(lib.get_sim_tmap(i), rt[j]) <= 1e-12
        q, u = lib.get_sim_pmap(i)
        assert _rel(q, rq[j]) <= 1e-12 and _rel(u, ru[j]) <= 1e-12


@pytest.mark.parametrize('nside,lmax', CASES)
def test_filter_matches_the_reference(nside, lmax):
    f = _filter(nside, lmax)
    transf, _, ftl, fel, fbl = _spectra(lmax)
    sht = ref.HealpixSHT(nside, lmax, device='cpu')
    t, q, u = f.sim_lib.map_lib.get_sim_tqumap_batch(IDXS)
    want = ref.fullsky_sepTP(sht, t, q, u, ftl, fel, fbl, transf, iter=3)
    got = f.get_sim_teblm_batch(IDXS)
    for p, r in zip(got, want):
        assert p.dtype == torch.complex128 and _rel(p, r) <= 1e-12


def test_batch_equals_per_sim_calls():
    nside, lmax = CASES[0]
    got = _filter(nside, lmax).get_sim_teblm_batch(IDXS)
    one = _filter(nside, lmax)
    for j, i in enumerate(IDXS):
        for f, x in zip('teb', got):
            assert torch.equal(getattr(one, 'get_sim_%slm' % f)(i), x[j])


@pytest.mark.parametrize('nside,lmax', CASES)
def test_filter_approaches_the_exact_harmonic_filter(nside, lmax):
    """The maps hold band-limited skies, so map2alm's Jacobi steps converge to the alms
    themselves: the filtered alms approach f_l / b_l a_lm as iter grows, and the filter
    takes healpy's default, iter 3."""
    transf, cl, ftl, fel, fbl = _spectra(lmax)
    alms = SeededAlms(lmax)
    lib = HealpixMapLib(alms, nside, lmax, device='cpu')
    fls = [torch.as_tensor(fl / transf)[_ls(lmax)] for fl in (ftl, fel, fbl)]
    exact = [fl * a for fl, a in zip(fls, alms.get_sim_teblm_batch(IDXS))]
    t, q, u = lib.get_sim_tqumap_batch(IDXS)
    errs = []
    for it in range(4):
        got = (lib.sht.map2alm(t, iter=it),) \
            + tuple(lib.sht.map2alm_spin((q, u), 2, iter=it))
        errs.append(max(_rel(fl * p, r) for fl, p, r in zip(fls, got, exact)))
    assert all(b < 0.5 * a for a, b in zip(errs, errs[1:])), errs
    assert errs[-1] < 1e-3, errs
    filt = IVFSepTP(HealpixAlmLib(lib), transf, cl, ftl, fel, fbl)
    got = filt.get_sim_teblm_batch(IDXS)
    assert max(_rel(p, r) for p, r in zip(got, exact)) == pytest.approx(errs[-1], rel=1e-6)


def _ls(lmax):
    return torch.as_tensor(np.concatenate([np.arange(m, lmax + 1) for m in range(lmax + 1)]))


def test_cached_sims_are_not_analysed_again():
    """A second read of a sim, per field, batched or through the ds/ss shuffles, makes no
    new healpix.map2alm span; the first analyses each uncached sim once."""
    nside, lmax = CASES[0]
    f = _filter(nside, lmax)
    trace.enable()
    f.get_sim_teblm_batch([0, 1, 0])
    first = [r for r in trace.records() if r['name'] == 'healpix.map2alm']
    assert [r['attrs']['batch'] for r in first] == [2, 2]         # T, then the Q/U pair
    IVFShuffle(f, lambda i: i - 1).get_sim_teblm_batch([1, 2])   # 0 and 1: cached
    f.get_sim_elm(1)
    assert [r for r in trace.records() if r['name'] == 'healpix.map2alm'] == first
    f.get_sim_teblm_batch([1, 2])                                # only 2 is new
    assert [r['attrs']['batch'] for r in trace.records()
            if r['name'] == 'healpix.map2alm'] == [2, 2, 1, 1]


def test_bounded_cacher_drops_the_least_recently_used():
    c = cacher_mem(maxsize=3)
    for k in 'abc':
        c.cache(k, torch.zeros(1))
    c.load('a')
    c.cache('d', torch.zeros(1))
    assert [k for k in 'abcd' if c.is_cached(k)] == ['a', 'c', 'd']
    c.cache('c', torch.ones(1))              # re-caching a key drops nothing else
    assert [k for k in 'abcd' if c.is_cached(k)] == ['a', 'c', 'd']
    assert float(c.load('c')) == 1.


def test_filter_keeps_the_data_sim_across_steps():
    """With the default bound, the data sim (-1) read every step stays cached while the
    steps' sims stream through: a step analyses its own sims only."""
    nside, lmax = 8, 16
    f = _filter(nside, lmax)
    trace.enable()
    f.get_sim_teblm_batch([-1])
    for s in range(8):
        idxs = list(range(4 * s, 4 * s + 4))
        f.get_sim_teblm_batch(idxs)
        IVFShuffle(f, lambda i: -1).get_sim_teblm_batch(idxs)
        IVFShuffle(f, lambda i: i - 1).get_sim_teblm_batch(idxs[1:])
    batches = [r['attrs']['batch'] for r in trace.records()
               if r['name'] == 'healpix.map2alm' and r['attrs']['spin'] == 0]
    assert batches == [1] + [4] * 8


# ------------------------------------------------------------------ spans and counters
def test_transform_spans_and_counters():
    nside, lmax = 8, 16
    hp = HealpixSHT(nside, lmax, use_ring_weights=False, device='cpu')
    alms = SeededAlms(lmax)
    t = torch.stack([alms.get_sim_tlm(i) for i in range(2)])
    e = torch.stack([alms.get_sim_elm(i) for i in range(2)])
    m = hp.alm2map(t)
    q, u = hp.alm2map_spin((e, e), 2)
    trace.enable()
    hp.alm2map(t)
    hp.map2alm(m, iter=3)
    hp.map2alm_spin((q, u), 2, iter=2)
    hp.alm2map_spin((e, e), 2)
    recs = [r for r in trace.records() if r['name'] in ('healpix.alm2map', 'healpix.map2alm')]
    by_id = {r['id']: r for r in trace.records()}
    outer = [r for r in recs if r['parent'] is None]
    assert [(r['name'], r['attrs']['spin'], r['attrs']['iter']) for r in outer] == [
        ('healpix.alm2map', 0, 0), ('healpix.map2alm', 0, 3), ('healpix.map2alm', 2, 2),
        ('healpix.alm2map', 2, 0)]
    for r in outer:
        assert r['attrs']['nside'] == nside and r['attrs']['lmax'] == lmax
        assert r['attrs']['batch'] == 2 and r['attrs']['f64'] is True
    inner = [r for r in recs if r['parent'] is not None]
    assert len(inner) == 3 + 2                       # the Jacobi steps' syntheses
    assert all(r['name'] == 'healpix.alm2map' and by_id[r['parent']]['name'] ==
               'healpix.map2alm' for r in inner)
    c = trace.counters()
    assert c['healpix.jacobi_iters'] == 5
    assert c['healpix.map_bytes'] == (2 + 4) * 12 * nside ** 2 * 8


def test_only_the_outermost_transform_is_timed(monkeypatch):
    """device_s goes on the outermost span of a call alone (CUDA events; on the CPU the
    timing call is recorded here in their place)."""
    timed = []
    monkeypatch.setattr(trace._Span, 'time_device',
                        lambda self, device: timed.append(self.rec['name']) or
                        self.rec['attrs'].__setitem__('device_s', 1.))
    nside, lmax = 8, 16
    hp = HealpixSHT(nside, lmax, use_ring_weights=False, device='cpu')
    m = hp.alm2map(SeededAlms(lmax).get_sim_tlm(0)[None])
    trace.enable()
    hp.map2alm(m, iter=3)
    hp.alm2map(SeededAlms(lmax).get_sim_tlm(1)[None])
    assert timed == ['healpix.map2alm', 'healpix.alm2map']
    recs = [r for r in trace.records() if r['name'] in ('healpix.alm2map', 'healpix.map2alm')]
    assert [('device_s' in r['attrs']) for r in recs] == [True, False, False, False, True]


def test_nothing_is_recorded_with_the_tracer_off():
    nside, lmax = 8, 16
    f = _filter(nside, lmax)
    f.get_sim_teblm_batch([0, 1])
    assert not trace.live() and trace.records() == [] and trace.counters() == {}


def test_ivfs_interface():
    """The rest of the ivfs interface on the map sims: the Wiener legs C_l bar X, the filters,
    the transfer function's pseudo-inverse and a hash of the settings."""
    nside, lmax = 8, 16
    transf, cl, ftl, fel, fbl = _spectra(lmax)
    f = _filter(nside, lmax)
    ls = _ls(lmax)
    for x, key in zip('teb', ('tt', 'ee', 'bb')):
        want = getattr(f, 'get_sim_%slm' % x)(2) * torch.as_tensor(cl[key])[ls]
        assert torch.allclose(getattr(f, 'get_sim_%smliklm' % x)(2), want, rtol=0, atol=0)
        assert np.array_equal(getattr(f, 'get_f%sl' % x)(), {'t': ftl, 'e': fel, 'b': fbl}[x])
        assert np.allclose(f.get_tal(x), 1. / transf)
    assert f.hashdict() == _filter(nside, lmax).hashdict() \
        != _filter(2 * nside, lmax).hashdict()
    assert f.sim_lib.hashdict()['iter'] == 3


# ------------------------------------------------------------------ nside 2048 on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the Hopper Legendre kernels)')
    return torch.device('cuda:0')


def _rings(nside):
    """A sample of ring indices: the polar rings, the cap-belt edges, the equator and some
    drawn at random, with their mirror images (the reference's Legendre phase wants a
    north-south symmetric grid)."""
    north = np.concatenate([[0, 1, 2, nside - 2, nside - 1, nside, nside + 1, 2 * nside - 1],
                            np.random.default_rng(nside).choice(2 * nside, 4, replace=False)])
    return np.unique(np.concatenate([north, 4 * nside - 2 - north]))


@pytest.mark.cuda
def test_nside2048_maps_match_the_reference_on_card(cuda_device):
    """K3 and the ring phase at the benchmark's size: the program's T, Q, U maps at nside
    2048, lmax 2048, f64, on a sample of rings against the plain reference's synthesis
    on those rings, <= 1e-10 of max."""
    nside, lmax = 2048, 2048
    rings = _rings(nside)
    lib = HealpixMapLib(SeededAlms(lmax, cuda_device), nside, lmax, device=cuda_device)
    full = ref.Geometry(nside)
    pix = torch.as_tensor(np.concatenate([np.arange(full.ofs[r], full.ofs[r] + full.nphi[r])
                                          for r in rings]), device=cuda_device)
    sht = ref.HealpixSHT(nside, lmax, device=cuda_device, rings=rings)
    t, e, b = lib.alm_lib.get_sim_teblm_batch([0, 1])
    want = (sht.alm2map(t),) + tuple(sht.alm2map_spin(e, b, 2))
    got = lib.get_sim_tqumap_batch([0, 1])
    errs = [_rel(p[:, pix], r) for p, r in zip(got, want)]
    print('nside 2048 maps on %d rings, rel to the reference (T, Q, U):' % len(rings), errs)
    assert max(errs) <= 1e-10, errs


@pytest.mark.cuda
def test_nside2048_analysis_is_the_adjoint_on_card(cuda_device):
    """K4 and the ring phase of the analysis at the benchmark's size: without Jacobi steps
    or ring weights map2alm is 4 pi / npix times the adjoint of the synthesis, so
    <S a, m> = npix / (4 pi) sum_lm c_m Re(a conj(A m)) (c_0 = 1, else 2) for random
    alms a and maps m, spin 0 and 2, nside 2048, lmax 2048, f64: <= 1e-10 relative."""
    nside, lmax = 2048, 2048
    sht = HealpixSHT(nside, lmax, use_ring_weights=False, device=cuda_device)
    alms = SeededAlms(lmax, cuda_device)
    c = torch.as_tensor(np.where(np.concatenate(
        [np.full(lmax + 1 - m, m) for m in range(lmax + 1)]) == 0, 1., 2.), device=cuda_device)
    w = 4. * np.pi / (12 * nside ** 2)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    maps = torch.randn((3, 2, 12 * nside ** 2), generator=g, dtype=torch.float64,
                       device=cuda_device)
    t, e, b = alms.get_sim_teblm_batch([0, 1])

    def dot(x, y):
        return (c * (x * torch.conj(y)).real).sum(-1) / w
    lhs = [(sht.alm2map(t) * maps[0]).sum(-1)]
    rhs = [dot(t, sht.map2alm(maps[0], iter=0))]
    q, u = sht.alm2map_spin((e, b), 2)
    lhs.append((q * maps[1] + u * maps[2]).sum(-1))
    ea, ba = sht.map2alm_spin((maps[1], maps[2]), 2, iter=0)
    rhs.append(dot(e, ea) + dot(b, ba))
    errs = [float(((x - y).abs() / x.abs()).max()) for x, y in zip(lhs, rhs)]
    print('nside 2048 adjoint identity, rel (spin 0, spin 2):', errs)
    assert max(errs) <= 1e-10, errs
