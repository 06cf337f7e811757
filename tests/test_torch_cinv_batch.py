"""Batched masked filtering: ops/cg.pcg_frozen and IVFCinv.get_sim_teblm_batch (with
IVFFtl's pass-through and the driver's stage_filt), held to the one-sim solves they
replace. The port alone, f64, on the CPU (the plain twins of the Legendre kernels); no JAX.

  * pcg_frozen at batch 1 is pcg, bitwise (with and without residual replacement, cold and
    warm starts);
  * at batch 4, rows of clearly different difficulty each take the iteration count of
    their own one-row solve, reach a solution within 1e-12 of max of it (dense f64
    systems of test_torch_cg.py's kind) and a rel <= eps; the counters cg.row_iters and
    cg.frozen_row_iters read the per-row counts;
  * IVFCinv's batch on a small masked sky (T with monopole and dipole marginalised, and P)
    against a fresh IVFCinv's per-sim accessors: equal iteration counts, alms within
    ROADMAP fault 3.6's rule (10x the per-sim path's own change under a 1e-15 change of
    its maps); repeated and cached indices; the cachers' per-sim names, a warm start;
  * IVFFtl has the batch accessor exactly when the library it wraps has one, and its rows
    equal its per-sim alms bitwise; stage_filt makes one T and one P solve a batch.

The card test (marked cuda, skipped here) runs the masked cell's configuration at lmax
2048: four pool sims in one batch-4 T solve and one P solve against each solved alone.
"""
import collections
import importlib.util
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from plancklens_tpu_torch.ops import cg
from plancklens_tpu_torch.ops.sht import SHT, gl_geometry
from plancklens_tpu_torch.models import cinv as pcinv
from plancklens_tpu_torch.models.filt import IVFFtl, IVFShuffle
from plancklens_tpu_torch.utils import alm as palm, trace
from plancklens_tpu_torch.utils.cachers import cacher_mem

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LMAX_CG = 16


def _err(a, ref):
    a, ref = torch.as_tensor(a), torch.as_tensor(ref)
    return float((a - ref).abs().max() / ref.abs().max())


@pytest.fixture
def traced():
    trace.reset()
    trace.enable()
    yield trace
    trace.disable()
    trace.reset()


def _solves(name='cg.solve'):
    return [r['attrs'] for r in trace.records() if r['name'] == name]


# ------------------------------------------------------------------ dense systems
def _system(cond=1e4, seed=11):
    """Port-side ops of an SPD (nrlm, nrlm) system of condition `cond` and a preconditioner
    sharing its eigenvectors (each eigenvalue off by up to 30%), the eigenvectors, and two
    generic complex right-hand sides."""
    nrlm = (LMAX_CG + 1) ** 2
    rng = np.random.RandomState(seed)
    Q = np.linalg.qr(rng.standard_normal((nrlm, nrlm)))[0]
    eig = np.geomspace(1., cond, nrlm)
    M = torch.as_tensor((Q * eig) @ Q.T)
    P = torch.as_tensor((Q / (eig * (1. + 0.3 * rng.uniform(-1., 1., nrlm)))) @ Q.T)

    def op(A):
        return lambda x: palm.rlm2alm(palm.alm2rlm(x, LMAX_CG) @ A.T, LMAX_CG)
    b = palm.rlm2alm(torch.as_tensor(rng.standard_normal((2, nrlm))), LMAX_CG)
    return op(M), op(P), M, torch.as_tensor(Q), b


def _rows():
    """Four rows of clearly different difficulty, with their warm starts: a generic
    right-hand side from zero; one in the span of three eigenvectors (three iterations);
    a generic one warm-started near its solution; an all-zero one (no iteration)."""
    fwd, pre, M, Q, b = _system()
    ms = palm._lm_indices(LMAX_CG)[1]
    x_easy = Q[:, :3] @ torch.tensor([1., -2., 0.5], dtype=torch.float64)
    b_easy = palm.rlm2alm(M @ x_easy, LMAX_CG)
    x_true, _, _ = cg.pcg(fwd, pre, b[1:], torch.zeros_like(b[1:]), 500, 1e-14, ms)
    warm = x_true[0] * (1. + 1e-6 * torch.linspace(-1., 1., x_true.shape[-1]))
    B = torch.stack([b[0], b_easy, b[1], torch.zeros_like(b[0])])
    X0 = torch.stack([torch.zeros_like(b[0]), torch.zeros_like(b[0]), warm,
                      torch.zeros_like(b[0])])
    return fwd, pre, ms, B, X0


@pytest.mark.parametrize('roundoff', [25, 4])
@pytest.mark.parametrize('row', [0, 1, 2, 3])
def test_frozen_batch1_is_pcg_bitwise(row, roundoff):
    fwd, pre, ms, B, X0 = _rows()
    b, x0 = B[row:row + 1], X0[row:row + 1]
    xf, itf, relf = cg.pcg_frozen(fwd, pre, b, x0, 500, 1e-9, ms, roundoff)
    xp, itp, relp = cg.pcg(fwd, pre, b, x0, 500, 1e-9, ms, roundoff)
    assert itf == itp
    assert torch.equal(xf, xp) and torch.equal(relf, relp)


@pytest.mark.parametrize('roundoff', [25, 4])
def test_frozen_rows_follow_their_own_solves(roundoff, traced):
    """Each row of a batch-4 solve: its own iteration count, its own solution within 1e-12
    of max, rel <= eps; the counters and the span's row_iters read the per-row counts."""
    fwd, pre, ms, B, X0 = _rows()
    eps = 1e-9
    own = [cg.pcg(fwd, pre, B[j:j + 1], X0[j:j + 1], 500, eps, ms, roundoff) for j in range(4)]
    own_it = [o[1] for o in own]
    assert len(set(own_it)) == 4 and own_it[3] == 0 and own_it[1] <= 4, own_it
    trace.reset()
    x, it, rel = cg.pcg_frozen(fwd, pre, B, X0, 500, eps, ms, roundoff)
    (span,) = _solves()
    assert span['row_iters'] == own_it and span['iters'] == it == max(own_it)
    assert span['batch'] == 4
    assert trace.counters() == {'cg.iters': it, 'cg.row_iters': sum(own_it),
                                'cg.frozen_row_iters': 4 * it - sum(own_it)}
    assert torch.all(rel <= eps)
    for j, (xo, _, relo) in enumerate(own):
        if j == 3:
            assert torch.equal(x[j], xo[0]) and not x[j].abs().any()
        else:
            assert _err(x[j], xo[0]) <= 1e-12, (j, _err(x[j], xo[0]))
            assert abs(float(rel[j] - relo[0])) <= 1e-3 * eps
    # the lockstep solve lets the early rows keep refining: a different result
    xl, itl, rell = cg.pcg(fwd, pre, B, X0, 500, eps, ms, roundoff)
    assert itl == it and float(rell[2]) < 1e-2 * float(rel[2])


# ------------------------------------------------------------------ a small masked sky
LMAX = 32
IDXS = [0, 1, 2, 3]
NLEV_T = 300.


class _Maps:
    """Map-sim library over fixed host maps, counting its calls; `tweak` multiplies every
    map by (1 + 1e-15 noise)."""

    def __init__(self, maps, tweak=False):
        self.maps = maps
        if tweak:
            rng = np.random.RandomState(9)
            self.maps = {k: tuple(m * (1. + 1e-15 * rng.standard_normal(m.shape)) for m in v)
                         for k, v in maps.items()}
        self.calls = collections.Counter()

    def hashdict(self):
        return {}

    def get_sim_tmap(self, idx):
        self.calls['t', idx] += 1
        return self.maps[idx][0]

    def get_sim_pmap(self, idx):
        self.calls['p', idx] += 1
        return self.maps[idx][1:]


def _sky():
    """Spectra, beam, filters (T with monopole and dipole marginalised, P; noise over a
    galactic cut: ~50 T and ~17 P iterations, where a 1e-15 change of the maps moves the T
    solution by ~6e-12 of max) and host maps of five sims (-1, 0..3)."""
    ls = np.arange(LMAX + 1.)
    cls = {'tt': 1e3 / (ls + 10.) ** 2, 'ee': 3e1 / (ls + 10.) ** 2,
           'bb': 3. / (ls + 10.) ** 2, 'te': 1e2 / (ls + 10.) ** 2}
    transf = np.exp(-0.5 * ls * (ls + 1.) * 1e-4)
    geom = gl_geometry(LMAX)
    omega = np.outer(geom.weight, np.full(geom.nphi, 2 * np.pi / geom.nphi))
    cut = (np.abs(np.cos(geom.theta))[:, None] > 0.2) * (1. + 0.4 * np.cos(geom.theta))[:, None]
    arcmin = np.pi / 180. / 60.
    ninv_t = omega / (NLEV_T * arcmin) ** 2 * cut
    ninv_p = omega / (300. * arcmin) ** 2 * cut
    sht = SHT(geom, LMAX, device='cpu')
    g = torch.Generator().manual_seed(5)
    lidx = torch.as_tensor(palm._lm_indices(LMAX)[0])
    maps = {}
    for i in [-1] + IDXS:
        a = [torch.complex(torch.randn(len(lidx), generator=g, dtype=torch.float64),
                           torch.randn(len(lidx), generator=g, dtype=torch.float64))
             * torch.as_tensor(np.sqrt(cls[k] / 2.))[lidx] for k in ('tt', 'ee', 'bb')]
        t = sht.alm2map(a[0]) + 2e-3 * torch.randn(omega.shape, generator=g, dtype=torch.float64)
        q, u = sht.alm2map_spin((a[1], a[2]), 2)
        maps[i] = tuple(m.numpy() for m in (t, q, u))
    cinv_t = pcinv.CinvT(LMAX, geom, cls, transf, ninv_t, marge_monopole=True,
                         marge_dipole=True, eps_min=1e-5, iter_max=400, lmax_dense=16,
                         device='cpu')
    cinv_p = pcinv.CinvP(LMAX, geom, cls, transf, ninv_p, eps_min=1e-5, iter_max=400,
                         lmax_dense=8, device='cpu')
    return cls, cinv_t, cinv_p, maps


@pytest.fixture(scope='module')
def sky():
    return _sky()


def _per_sim(sky, tweak=False):
    """Each sim of IDXS through a fresh IVFCinv's per-sim accessors: ({idx: (t, e, b)},
    {idx: (T iterations, P iterations)})."""
    cls, cinv_t, cinv_p, maps = sky
    lib = pcinv.IVFCinv(cinv_t, cinv_p, _Maps(maps, tweak), cls)
    out, its = {}, {}
    for i in IDXS:
        trace.reset()
        out[i] = (lib.get_sim_tlm(i), lib.get_sim_elm(i), lib.get_sim_blm(i))
        its[i] = tuple(s['iters'] for s in _solves())
    return out, its


def test_ivfcinv_batch_matches_per_sim(sky, traced):
    """One T and one P solve over four sims: each sim's iteration counts those of its own
    solve, its alms within 10x the per-sim path's own change under a 1e-15 change of its
    maps; the maps read once a sim; the per-sim accessors read the batch's alms."""
    cls, cinv_t, cinv_p, maps = sky
    ref, ref_its = _per_sim(sky)
    tweak, _ = _per_sim(sky, tweak=True)
    floor = [max(_err(tweak[i][f], ref[i][f]) for i in IDXS) for f in range(3)]
    assert all(1e-16 < fl < 1e-6 for fl in floor), floor
    sims = _Maps(maps)
    lib = pcinv.IVFCinv(cinv_t, cinv_p, sims, cls)
    trace.reset()
    t, e, b = lib.get_sim_teblm_batch(IDXS)
    solves = _solves()
    assert [s['batch'] for s in solves] == [4, 4]
    assert solves[0]['row_iters'] == [ref_its[i][0] for i in IDXS]
    assert solves[1]['row_iters'] == [ref_its[i][1] for i in IDXS]
    assert min(solves[0]['row_iters']) > 20
    assert [s['attrs']['sims'] for s in trace.records() if s['name'] == 'filt.ivf'] \
        == [[0, 4], [0, 4]]
    assert set(sims.calls.values()) == {1} and len(sims.calls) == 8
    for f, got in enumerate((t, e, b)):
        assert got.shape == (4, palm.getsize(LMAX)) and got.dtype == torch.complex128
        for j, i in enumerate(IDXS):
            assert _err(got[j], ref[i][f]) <= 10. * floor[f], (f, i, _err(got[j], ref[i][f]))
    for j, i in enumerate(IDXS):
        assert torch.equal(lib.get_sim_tlm(i), t[j]) and torch.equal(lib.get_sim_blm(i), b[j])
    assert len(_solves()) == 2


def test_ivfcinv_per_sim_is_the_one_sim_solve_bitwise(sky):
    """get_sim_tlm / get_sim_elm: bitwise the lockstep solve of the sim alone."""
    cls, cinv_t, cinv_p, maps = sky
    lib = pcinv.IVFCinv(cinv_t, cinv_p, _Maps(maps), cls)
    t = cinv_t.apply_ivf(maps[1][0])
    e, b = cinv_p.apply_ivf(*maps[1][1:])
    assert torch.equal(lib.get_sim_tlm(1), t[0])
    assert torch.equal(lib.get_sim_elm(1), e[0]) and torch.equal(lib.get_sim_blm(1), b[0])


def test_ivfcinv_batch_repeats_cached_and_cachers(sky, traced):
    """Repeated and cached indices: each sim solved once, the output in the order of idxs;
    the alm cacher and the solution cacher written under the per-sim names; a fresh
    library warm-started from the solutions converges at once and a filled alm cacher
    serves one with no solve and no map read."""
    cls, cinv_t, cinv_p, maps = sky
    alms, soltn = cacher_mem(), cacher_mem()
    sims = _Maps(maps)
    lib = pcinv.IVFCinv(cinv_t, cinv_p, sims, cls, cacher=alms, soltn_cacher=soltn)
    t2 = lib.get_sim_tlm(2)
    trace.reset()
    idxs = [3, 2, -1, 3, 0]
    t, e, b = lib.get_sim_teblm_batch(np.array(idxs))
    solves = _solves()
    assert [s['batch'] for s in solves] == [3, 4]   # T: 3, -1, 0 (2 cached); P: 3, 2, -1, 0
    assert [r['attrs']['sims'] for r in trace.records() if r['name'] == 'filt.ivf'] \
        == [[3, 3], [3, 4]]
    assert sims.calls == {(f, i): 1 for f in 'tp' for i in (3, 2, -1, 0)}
    assert torch.equal(t[1], t2) and torch.equal(t[0], t[3])
    for j, i in enumerate(idxs):
        assert torch.equal(t[j], lib.get_sim_tlm(i)) and torch.equal(e[j], lib.get_sim_elm(i))
    for i in (3, 2, -1, 0):
        for f, got in zip('teb', (lib.get_sim_tlm(i), lib.get_sim_elm(i), lib.get_sim_blm(i))):
            assert np.array_equal(alms.load('ivf_%slm_%05d' % (f, i)), got.numpy())
        assert soltn.load('wf_t_%05d' % i).shape == (1, palm.getsize(LMAX))
        assert soltn.load('wf_p_%05d' % i).shape == (1, 2, palm.getsize(LMAX))
    trace.reset()
    warm = pcinv.IVFCinv(cinv_t, cinv_p, _Maps(maps), cls, soltn_cacher=soltn)
    tw, ew, _ = warm.get_sim_teblm_batch([0, 1, 3])
    row_iters = [s['row_iters'] for s in _solves()]
    assert all(n <= 3 for n in row_iters[0][::2] + row_iters[1][::2]), row_iters
    assert min(row_iters[0][1], row_iters[1][1]) > 5, row_iters     # sim 1: no solution
    assert _err(tw[0], t[4]) < 1e-4 and _err(ew[2], e[0]) < 1e-4

    class _NoSims:
        def get_sim_tmap(self, idx):
            raise AssertionError('should have been served from the cacher')
        get_sim_pmap = get_sim_tmap
    cached = pcinv.IVFCinv(cinv_t, cinv_p, _NoSims(), cls, cacher=alms)
    trace.reset()
    tc, ec, bc = cached.get_sim_teblm_batch(idxs)
    assert not _solves()
    assert torch.equal(tc, t) and torch.equal(ec, e) and torch.equal(bc, b)


def test_ivfcinv_batch_of_a_partial_library(sky):
    """A library without a T (or P) filter gives None for those fields of a batch."""
    cls, cinv_t, cinv_p, maps = sky
    t, e, b = pcinv.IVFCinv(None, cinv_p, _Maps(maps), cls).get_sim_teblm_batch([0])
    assert t is None and e.shape == b.shape == (1, palm.getsize(LMAX))
    t, e, b = IVFFtl(pcinv.IVFCinv(cinv_t, None, _Maps(maps), cls), *[np.ones(LMAX + 1)] * 3) \
        .get_sim_teblm_batch([0])
    assert e is None and b is None and t.shape == (1, palm.getsize(LMAX))


def test_ivfftl_batch_follows_the_wrapped_library(sky):
    """hasattr(IVFFtl(...), 'get_sim_teblm_batch') is the wrapped library's; the rows equal
    the per-sim alms (IVFFtl._apply of each) bitwise, through IVFShuffle too."""
    cls, cinv_t, cinv_p, maps = sky

    class _PerIndex:
        def get_sim_tlm(self, idx):
            return torch.zeros(palm.getsize(LMAX), dtype=torch.complex128)
    fl = [(np.arange(LMAX + 1) >= l0) * np.linspace(1., 2., LMAX + 1) for l0 in (2, 3, 4)]
    assert not hasattr(IVFFtl(_PerIndex(), *fl), 'get_sim_teblm_batch')
    with pytest.raises(AttributeError):
        IVFFtl(_PerIndex(), *fl).get_sim_teblm_batch
    ivfs = IVFFtl(pcinv.IVFCinv(cinv_t, cinv_p, _Maps(maps), cls), *fl)
    assert hasattr(ivfs, 'get_sim_teblm_batch')
    idxs = [2, 0, 2]
    t, e, b = ivfs.get_sim_teblm_batch(idxs)
    for j, i in enumerate(idxs):
        assert torch.equal(t[j], ivfs.get_sim_tlm(i))
        assert torch.equal(e[j], ivfs.get_sim_elm(i)) and torch.equal(b[j], ivfs.get_sim_blm(i))
    shuffled = IVFShuffle(ivfs, lambda i: i - 1)
    ts, _, bs = shuffled.get_sim_teblm_batch([1, 3])
    assert torch.equal(ts, t[[1, 0]]) and torch.equal(bs[1], b[0])


def _driver():
    spec = importlib.util.spec_from_file_location(
        'run_qlms_torch', os.path.join(REPO, 'examples', 'run_qlms_torch.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_stage_filt_solves_a_batch_at_once(sky, traced):
    """The driver's stage_filt on a masked IVFCinv -> IVFFtl chain: one T and one P
    solve_wf call over the batch's sims, none for a batch already filtered."""
    cls, cinv_t, cinv_p, maps = sky
    calls = []

    def logged(solver, kind):
        fn = solver.solve_wf

        def solve_wf(*a, **kw):
            x, it, rel = fn(*a, **kw)
            calls.append((kind, x.shape[0], type(it)))
            return x, it, rel
        return solve_wf
    cinv_t.solve_wf = logged(cinv_t, 't')
    cinv_p.solve_wf = logged(cinv_p, 'p')
    try:
        cut = [(np.arange(LMAX + 1) >= 2) * 1.] * 3
        par = SimpleNamespace(DEVICE=torch.device('cpu'),
                              ivfs=IVFFtl(pcinv.IVFCinv(cinv_t, cinv_p, _Maps(maps), cls), *cut))
        drv = _driver()
        (t, e, b), _ = drv.stage_filt(par, np.array(IDXS))
        assert calls == [('t', 4, int), ('p', 4, int)]
        assert t.shape == e.shape == b.shape == (4, palm.getsize(LMAX))
        drv.stage_filt(par, np.array(IDXS[1:]))
        assert len(calls) == 2
    finally:
        del cinv_t.solve_wf, cinv_p.solve_wf


# ------------------------------------------------------------------ on the card
@pytest.fixture(scope='module')
def masked_cell():
    """The masked cell's configuration on the card (portbench/configs/masked_l2048.json,
    its mc_chain4 traffic): filters as its builder makes them (the dense blocks cached in
    portbench/_cache/), and the plain reference for the sims and the true residuals."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the Hopper Legendre kernels)')
    from portbench.inputs import Inputs
    from portbench.reference.chain import Reference
    from plancklens_tpu_torch.utils.cachers import cacher_npy
    with open(os.path.join(REPO, 'portbench', 'configs', 'masked_l2048.json')) as f:
        cfg = json.load(f)
    with open(os.path.join(REPO, 'portbench', 'traffic', 'mc_chain4.json')) as f:
        traffic = json.load(f)
    cfg['qe_keys'] = list(traffic['keys'])
    dev = torch.device('cuda:0')
    inp = Inputs(cfg, 0, dev, traffic)
    dense = cacher_npy(os.path.join(REPO, 'portbench', '_cache', 'dense_%s' % cfg['name']))
    geom = gl_geometry(cfg['grid_lmax'])
    lmax, ct, cp = cfg['lmax_ivf'], cfg['cinv_t'], cfg['cinv_p']
    cinv_t = pcinv.CinvT(lmax, geom, inp.cls, inp.transf, inp.ninv_t,
                         marge_monopole=ct['marge_monopole'], marge_dipole=ct['marge_dipole'],
                         eps_min=ct['eps_min'], iter_max=ct['iter_max'],
                         lmax_dense=ct['lmax_dense'], dense_cacher=dense, device=dev)
    cinv_p = pcinv.CinvP(lmax, geom, inp.cls, inp.transf, inp.ninv_p, eps_min=cp['eps_min'],
                         iter_max=cp['iter_max'], lmax_dense=cp['lmax_dense'],
                         dense_cacher=dense, device=dev)
    return cfg, traffic, cinv_t, cinv_p, Inputs, Reference


@pytest.mark.cuda
@pytest.mark.parametrize('seed', [2 ** 31 + 101 * k for k in range(1, 7)])
def test_masked_cell_batch4_on_card(masked_cell, seed, traced):
    """Four pool sims of the masked cell (lmax 2048) in one batch-4 T solve and one P
    solve, against each solved alone: equal iterations a sim, alms within 10x the one-sim
    path's own change under a 1e-15 change of its maps, and every sim's true residual
    under the plain reference's operator at most eps_min."""
    cfg, traffic, cinv_t, cinv_p, Inputs, Reference = masked_cell
    dev = torch.device('cuda:0')
    inp = Inputs(cfg, seed, dev, traffic)
    ref = Reference(cfg, inp, dev)
    idxs = list(range(traffic['warm_sims'], traffic['warm_sims'] + 4))
    t, q, u = ref.maps(idxs)
    maps = {i: (t[j], q[j], u[j]) for j, i in enumerate(idxs)}
    tweak = {i: tuple(m * (1. + 1e-15 * torch.randn(m.shape, generator=torch.Generator(
        device=dev).manual_seed(i), device=dev, dtype=m.dtype)) for m in v)
        for i, v in maps.items()}
    alone, its = {}, {}
    for name, mm in (('alone', maps), ('tweak', tweak)):
        lib = pcinv.IVFCinv(cinv_t, cinv_p, _Maps(mm), inp.cls)
        for i in idxs:
            trace.reset()
            alone[name, i] = (lib.get_sim_tlm(i), lib.get_sim_elm(i), lib.get_sim_blm(i))
            its[name, i] = [s['iters'] for s in _solves()]
    trace.reset()
    tb, eb, bb = pcinv.IVFCinv(cinv_t, cinv_p, _Maps(maps), inp.cls).get_sim_teblm_batch(idxs)
    row_iters = [s['row_iters'] for s in _solves()]
    assert [s['batch'] for s in _solves()] == [4, 4]
    assert row_iters == [[its['alone', i][0] for i in idxs], [its['alone', i][1] for i in idxs]]
    for f, got in enumerate((tb, eb, bb)):
        floor = max(_err(alone['tweak', i][f], alone['alone', i][f]) for i in idxs)
        worst = max(_err(got[j], alone['alone', i][f]) for j, i in enumerate(idxs))
        print('seed %d field %s: batch vs alone %.3e, floor %.3e, iterations %s'
              % (seed, 'teb'[f], worst, floor, row_iters))
        assert worst <= 10. * floor, (f, worst, floor)
    rt = ref.residual_t(t, tb)
    rp = ref.residual_p(q, u, eb, bb)
    print('seed %d true residuals T %s P %s' % (seed, rt.tolist(), rp.tolist()))
    assert float(rt.max()) <= cfg['cinv_t']['eps_min']
    assert float(rp.max()) <= cfg['cinv_p']['eps_min']
