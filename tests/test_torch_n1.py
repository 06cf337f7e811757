"""Port parity of the N1 quadrature (ops/n1kern, models/n1) against plancklens_tpu, f64 on
the CPU, at the sizes of tests/test_n1.py (lmax 100-120, dL 20):

  * `n1L_batch` over ptt/pte/pee/peb/xtt/stt/ftt key pairs (and a swapped pair), `n1L` at
    single knots, `n1L_jtp_batch` on four primed-field combinations (one with a shorter A
    leg, one with unequal B legs) and `n1L_jtp`: <= 1e-10 relative to max |N1|;
  * the four independent continuum anchors of tests/test_n1_anchors.py at their rtols;
  * `N1Lib.get_n1` for p, p_p, p_tp and x_p, and `get_n1_jtp` (p_p and a TE-coupled ptt):
    <= 1e-10 relative to max |N1|;
  * the weight functions `_wf`/`_wf_coded` against the reference's on random wavevectors.

The port compacts the reference's padded grid and sums in another order, so values agree
to rounding (measured ~1e-15), not bitwise.
"""
import numpy as np
import pytest
import torch

from plancklens_tpu.ops import n1kern as rk
from plancklens_tpu.models import n1 as rn1
from plancklens_tpu_torch.ops import n1kern as pk
from plancklens_tpu_torch.models import n1 as pn1

torch.set_num_threads(1)

CPU = torch.device('cpu')
TOL = 1e-10


def _rel(a, ref):
    a, ref = np.asarray(a, dtype=float), np.asarray(ref, dtype=float)
    return np.abs(a - ref).max() / np.abs(ref).max()


def _inputs(seed=0, lmax=120):
    rng = np.random.RandomState(seed)
    cl = np.abs(rng.standard_normal(lmax)) + .1
    clte = rng.standard_normal(lmax) * .1
    f = 1. / (np.abs(rng.standard_normal(lmax)) + .5)
    return cl, clte, f


@pytest.mark.parametrize('kA,kB', [('ptt', 'ptt'), ('pte', 'pte'), ('pee', 'pee'),
                                   ('peb', 'peb'), ('pee', 'peb'), ('peb', 'pee'),
                                   ('xtt', 'xtt'), ('xtt', 'ptt'), ('stt', 'stt'),
                                   ('ftt', 'ftt')])
def test_n1L_batch_matches_reference(kA, kB):
    cl, clte, f = _inputs()
    lps = np.array([1, 10, 30, 60, 120])
    Ls = np.array([2., 10., 40., 80., 110., 120.])
    args = ('p', cl, cl, clte, cl, cl, clte, cl, f, f, f, f, f, f, 2, 2, 20, lps)
    ref = rk.n1L_batch(Ls, kA, kB, *args, chunk=4)
    got = pk.n1L_batch(Ls, kA, kB, *args, chunk=1000, device=CPU)
    assert np.abs(ref).max() > 0.
    assert _rel(got, ref) <= TOL, (kA, kB, _rel(got, ref))


def test_n1L_single_knot_matches_reference():
    """The single-L entry point, on the smooth spectra of tests/test_n1.py, lmax 120."""
    lmax = 120
    ls = np.arange(1, lmax + 1, dtype=float)
    cltt, clee, clte = 1e3 / ls ** 2, 1e2 / ls ** 2, 3e2 / ls ** 2
    clpp = 1e-8 / ls ** 4
    ftl, fel, fbl = 1. / (cltt + 1e-3), 1. / (clee + 2e-3), 1. / (0 * clee + 2e-3)
    lps = np.array([1, 2, 12, 22, 42, 62, 82, 102])
    args = (clpp, cltt, clte, clee, cltt, clte, clee, ftl, fel, fbl, ftl, fel, fbl,
            2, 2, 20, lps)
    for kA, kB in (('ptt', 'ptt'), ('pee', 'ptt'), ('peb', 'peb')):
        ref = np.array([float(rk.n1L(L, kA, kB, 'p', *args)) for L in (10, 57)])
        got = np.array([pk.n1L(L, kA, kB, 'p', *args, device=CPU) for L in (10, 57)])
        assert _rel(got, ref) <= TOL, (kA, kB, _rel(got, ref))


def _jtp_combos():
    rng = np.random.RandomState(1)
    lmax = 100
    combos = []
    for i, fields in enumerate(('ttee', 'tetb', 'ebte', 'bbtt')):
        n = lmax if i != 1 else lmax - 30   # one combo with a shorter A-side leg
        fs = [1. / (np.abs(rng.standard_normal(n)) + .5) for _ in range(2)] \
            + [1. / (np.abs(rng.standard_normal(lmax)) + .5) for _ in range(2)]
        if i == 2:                          # and one with unequal B-side legs
            fs[3] = fs[3][:lmax - 25]
        combos.append((fields,) + tuple(fs))
    return combos


def test_n1L_jtp_batch_and_single_match_reference():
    cl, clte, _ = _inputs(1, 100)
    lps = np.array([1, 10, 30, 60, 100])
    Ls = np.array([2., 20., 60., 100.])
    combos = _jtp_combos()
    args = ('p', cl, cl, clte, cl, cl, clte, cl, 1, 1, 20, lps)
    ref = rk.n1L_jtp_batch(Ls, 'ptt', 'ptt', combos, *args)
    got = pk.n1L_jtp_batch(Ls, 'ptt', 'ptt', combos, *args, device=CPU)
    assert got.shape == ref.shape == (len(combos), len(Ls))
    for i in range(len(combos)):
        assert _rel(got[i], ref[i]) <= TOL, (combos[i][0], _rel(got[i], ref[i]))
    # the single-L path on the combination with unequal B legs
    fields, fX, fY, fI, fJ = combos[2]
    one = pk.n1L_jtp(60., 'ptt', 'ptt', *fields, 'p', cl, cl, clte, cl, cl, clte, cl,
                     fX, fY, fI, fJ, 1, 1, 20, lps, device=CPU)
    r1 = float(rk.n1L_jtp(60., 'ptt', 'ptt', *fields, 'p', cl, cl, clte, cl, cl, clte, cl,
                          fX, fY, fI, fJ, 1, 1, 20, lps))
    assert abs(one - r1) <= TOL * abs(r1), (one, r1)


@pytest.mark.parametrize('key,L,expect,rtol', [
    ('p', 20., 6.83970870e+07, 0.10),
    ('p', 40., 1.22880855e+10, 0.01),
    ('s', 30., 3.12454274e+10, 0.01),
    ('x', 30., -2.06451725e+08, 0.05),
])
def test_n1_anchors(key, L, expect, rtol):
    """The independent continuum anchors of tests/test_n1_anchors.py, through the port."""
    lmax, lpmax = 60, 120
    ls = np.arange(1, lmax + 1, dtype=float)
    lp = np.arange(1, lpmax + 1, dtype=float)
    cltt = 1. / (ls * (ls + 1.) + 1.)
    clpp = 1e-2 * np.exp(-0.5 * ((lp - 30.) / 30.) ** 2) / (lp * (lp + 1.) + 1.)
    win = 0.25 * (1. + np.tanh((ls - 8.) / 3.)) * (1. - np.tanh((ls - 52.) / 3.))
    ftl = win / (1. / (ls * (ls + 1.) + 1.) + 2e-4)
    zeros = np.zeros(lmax)
    kA = key + 'tt'
    val = pk.n1L(L, kA, kA, 'p', clpp, cltt, zeros, zeros, cltt, zeros, zeros,
                 ftl, zeros, zeros, ftl, zeros, zeros, lminA=1, lminB=1, dL=2,
                 lps=np.arange(1, lpmax + 1), device=CPU)
    assert np.isfinite(val)
    assert abs(val / expect - 1.) < rtol, (key, L, val, expect)


def test_wf_and_coded_weights_match_reference():
    import jax.numpy as jnp
    rng = np.random.RandomState(0)
    shp = (7, 5)
    xs = [rng.uniform(-300, 300, shp) for _ in range(4)]
    l1i, l2i = rng.randint(1, 400, shp), rng.randint(1, 400, shp)
    cls = [rng.standard_normal(400) for _ in range(3)]
    T = lambda a: torch.as_tensor(a)
    for src in 'pxsf':
        for pair in ('tt', 'te', 'et', 'tb', 'bt', 'ee', 'eb', 'be', 'bb'):
            k = src + pair
            ref = np.asarray(rk._wf(k, *map(jnp.asarray, xs), jnp.asarray(l1i),
                                    jnp.asarray(l2i), *map(jnp.asarray, cls)))
            a = pk._wf(k, *map(T, xs), T(l1i), T(l2i), *map(T, cls)).numpy()
            b = pk._wf_coded(pk.wf_code(k), *map(T, xs), T(l1i), T(l2i),
                             *map(T, cls)).numpy()
            assert np.array_equal(pk.wf_code(k), rk.wf_code(k)), k
            for got in (a, b):
                assert got.shape == ref.shape
                assert np.allclose(got, ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max()), k


@pytest.fixture(scope='module')
def libs():
    lmax = 120
    ls = np.arange(1, lmax + 1, dtype=float)
    cltt, clee, clte = 1e3 / ls ** 2, 1e2 / ls ** 2, 3e2 / ls ** 2
    clpp = 1e-8 / ls ** 4
    ftl, fel, fbl = 1. / (cltt + 1e-3), 1. / (clee + 2e-3), 1. / (0 * clee + 2e-3)
    for f in (ftl, fel, fbl):
        f[:4] = 0.            # lmin from the first non-zero filter entry (n1.py:121-124)
    lps = np.array([1, 2, 12, 22, 42, 62, 82, 102])
    ref = rn1.N1Lib(cltt, clte, clee, lmaxphi=lmax, dL=20, lps=lps)
    got = pn1.N1Lib(cltt, clte, clee, lmaxphi=lmax, dL=20, lps=lps, device=CPU)
    return ref, got, clpp, (ftl, fel, fbl)


@pytest.mark.parametrize('key', ['p', 'p_p', 'p_tp', 'x_p'])
def test_n1lib_get_n1_matches_reference(libs, key):
    ref, got, clpp, fls = libs
    assert got.hashdict() == ref.hashdict()
    r = ref.get_n1(key, 'p', clpp, *fls, 60)
    g = got.get_n1(key, 'p', clpp, *fls, 60)
    assert g.shape == r.shape == (61,)
    assert _rel(g, r) <= TOL, (key, _rel(g, r))


def test_n1lib_get_n1_jtp_matches_reference(libs):
    ref, got, clpp, (ftl, fel, fbl) = libs
    for key, fal in (('p_p', {'ee': fel, 'bb': fbl}),
                     ('ptt', {'tt': ftl, 'te': 0.3 * ftl})):
        r = ref.get_n1_jtp(key, 'p', clpp, fal, 60)
        g = got.get_n1_jtp(key, 'p', clpp, fal, 60)
        assert _rel(g, r) <= TOL, (key, _rel(g, r))
    # the reference's cache names, so a shared cacher serves both ways
    assert set(got.cacher._cache) == set(ref.cacher._cache)


def test_n1_ls_grid_and_default_lps():
    assert np.array_equal(pn1.default_lps(2500), rn1.default_lps(2500))
    lib = pn1.N1Lib(np.ones(10), np.ones(10), np.ones(10), device=CPU)
    assert np.array_equal(lib._ls_grid(2048), rn1.N1Lib._ls_grid(None, 2048))
    for k in pn1.estimator_keys_derived:
        assert [a for a, _ in pn1._get_est_derived(k, 10)] \
            == [a for a, _ in rn1._get_est_derived(k, 10)]
