"""Port parity of the host accumulators of models/qecl against plancklens_tpu: `stats`
(mean, covariance, sigmas, correlation matrix, the Hartlap-debiased inverse, chi^2, the
PTE with the reference's default ndof = size and an explicit one, and the non-overlapping
rebin, with and without weights) and `QeClAverage` over two spectra libraries. Inputs are
numpy draws from a seed; everything is host f64, held to 1e-12 relative to max."""
import numpy as np
import pytest

from plancklens_tpu.models import qecl as rqecl
from plancklens_tpu_torch.models import qecl as pqecl

TOL = 1e-12


def _rel(a, ref):
    a, ref = np.asarray(a, dtype=float), np.asarray(ref, dtype=float)
    return np.abs(a - ref).max() / np.abs(ref).max()


def _filled(mod, size, n, seed=3, **kw):
    rng = np.random.RandomState(seed)
    st = mod.stats(size, **kw)
    for _ in range(n):
        st.add(rng.standard_normal(size) * np.arange(1, size + 1) + 0.5)
    return st


@pytest.mark.parametrize('docov', [True, False])
def test_stats_moments(docov):
    p, r = _filled(pqecl, 6, 20, docov=docov), _filled(rqecl, 6, 20, docov=docov)
    assert p.N == r.N == 20 and p.docov == r.docov == docov
    assert _rel(p.mean(), r.mean()) <= TOL and _rel(p.avg(), r.avg()) <= TOL
    if not docov:
        assert p.mom is None and r.mom is None
        return
    for name in ('cov', 'sigmas', 'sigmas_on_mean', 'corrcoeffs', 'inverse'):
        assert _rel(getattr(p, name)(), getattr(r, name)()) <= TOL, name
    assert _rel(p.inverse(bias_p=0.7), r.inverse(bias_p=0.7)) <= TOL
    one = pqecl.stats(3)
    one.add(np.ones(3))
    assert np.array_equal(one.cov(), np.zeros((3, 3)))


def test_stats_chisq_and_pte():
    p, r = _filled(pqecl, 5, 40), _filled(rqecl, 5, 40)
    data = np.random.RandomState(9).standard_normal(5) * 3.
    assert abs(p.get_chisq(data) / r.get_chisq(data) - 1.) <= TOL
    # the reference's ndof choice (the data-vector size) and an explicit one
    assert abs(p.get_chisq_pte(data) / r.get_chisq_pte(data) - 1.) <= TOL
    assert abs(p.get_chisq_pte(data, ndof=p.N - 1) / r.get_chisq_pte(data, ndof=r.N - 1)
               - 1.) <= TOL
    with pytest.raises(AssertionError):
        _filled(pqecl, 5, 5).inverse()


@pytest.mark.parametrize('weighted', [False, True])
def test_stats_rebin(weighted):
    p, r = _filled(pqecl, 12, 30, xcoord=np.arange(12)), _filled(rqecl, 12, 30)
    coord = np.arange(12) * 2.
    w = np.linspace(1., 3., 12) if weighted else None
    lmins, lmaxs = np.array([0, 6, 14]), np.array([4, 12, 22])
    pb = p.rebin_that_nooverlap(coord, lmins, lmaxs, weights=w)
    rb = r.rebin_that_nooverlap(coord, lmins, lmaxs, weights=w)
    assert isinstance(pb, pqecl.stats) and pb.N == rb.N == 30
    assert np.array_equal(pb.xcoord, rb.xcoord)
    for name in ('mean', 'cov', 'sigmas'):
        assert _rel(getattr(pb, name)(), getattr(rb, name)()) <= TOL, name


class _Lib:
    """Duck-typed spectra library: deterministic host spectra per (key, sim)."""

    def __init__(self, seed, lmax):
        self.seed, self.lmax_qlm = seed, lmax

    def hashdict(self):
        return {'seed': self.seed}

    def get_sim_qcl(self, k1, idx, k2=None, idx2=None):
        rng = np.random.RandomState(1000 * self.seed + 7 * idx + len(k1 + (k2 or '')))
        return rng.standard_normal(self.lmax_qlm + 1) ** 2

    def get_lmaxqcl(self, k1, k2):
        return self.lmax_qlm - self.seed


@pytest.mark.parametrize('weights', [None, [1., 3.]])
def test_qecl_average(weights):
    libs = [_Lib(1, 16), _Lib(2, 16)]
    p, r = pqecl.QeClAverage(libs, weights=weights), rqecl.QeClAverage(libs, weights=weights)
    assert p.hashdict() == r.hashdict()
    assert _rel(p.get_sim_qcl('ptt', 3), r.get_sim_qcl('ptt', 3)) <= TOL
    assert _rel(p.get_dat_qcl('ptt', k2='p_p'), r.get_dat_qcl('ptt', k2='p_p')) <= TOL
    assert p.get_lmaxqcl('ptt', 'ptt') == r.get_lmaxqcl('ptt', 'ptt') == 14
    ps, rs = p.get_sim_stats_qcl('ptt', [0, 1, 2]), r.get_sim_stats_qcl('ptt', [0, 1, 2])
    assert ps.N == rs.N == 3 and _rel(ps.mean(), rs.mean()) <= TOL
