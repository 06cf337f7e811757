r"""QE power spectra with split-half mean-field subtraction.

Port of plancklens_tpu/models/qecl.py (reference semantics: plancklens/qecl.py:
29-145): the mean-field is estimated from two disjoint halves of mc_sims_mf (even indices
for leg A, odd for leg B) so the MF noise does not bias the cross-spectrum. Requesting the
spectrum of a sim inside mc_sims_mf raises by default (the MF leg would correlate with
it — reference qecl.py:102); leave_out=True subtracts a mean-field recomputed without
that sim on the leg(s) containing it. Spectra are host numpy arrays. `InputPlmLib` is
the qlm-library view of a simulation library's input potentials (the B leg of the
parameter files' `qlms_x_in`); `QeClAverage` averages several spectra libraries;
`stats` is the host numpy accumulator of the band-powers (mean, covariance, chi^2,
rebinning).
"""
import numpy as np
import torch

from ..utils import alm as ualm
from ..utils.hashing import mchash
from ..utils.cachers import cacher_mem
from ..utils import trace


class stats:
    """Running mean/covariance accumulator with consistency-test helpers
    (capability surface of reference plancklens/utils.py:181-266: mean/cov/sigmas,
    correlation matrix, Hartlap-debiased inverse, chi^2 + PTE, non-overlapping rebin)."""

    def __init__(self, size, xcoord=None, docov=True):
        self.N = 0
        self.size = size
        self.sum = np.zeros(size)
        self.mom = np.zeros((size, size)) if docov else None
        self.xcoord = xcoord
        self.docov = docov

    def add(self, v):
        v = np.asarray(v).flatten()
        assert v.size == self.size
        self.sum += v
        if self.docov:
            self.mom += np.outer(v, v)
        self.N += 1

    def mean(self):
        assert self.N > 0
        return self.sum / self.N

    def avg(self):
        return self.mean()

    def cov(self):
        """Unbiased sample covariance (N - 1 normalisation; zeros for a single sample)."""
        assert self.docov and self.N > 0
        if self.N == 1:
            return np.zeros((self.size, self.size))
        mean = self.mean()
        return (self.mom - self.N * np.outer(mean, mean)) / (self.N - 1.)

    def sigmas(self):
        return np.sqrt(np.diag(self.cov()))

    def sigmas_on_mean(self):
        return self.sigmas() / np.sqrt(self.N)

    def corrcoeffs(self):
        s = self.sigmas()
        return self.cov() / np.outer(s, s)

    def inverse(self, bias_p=None):
        """Inverse covariance, debiased by the Hartlap factor (N - size - 2)/(N - 1) for
        Gaussian statistics (or an explicit `bias_p`)."""
        assert self.N > self.size, 'too few samples for an invertible covariance'
        if bias_p is None:
            bias_p = (self.N - self.size - 2.) / (self.N - 1.)
        return bias_p * np.linalg.inv(self.cov())

    def get_chisq(self, data):
        """(data - mean)^T Cov^-1 (data - mean)."""
        dx = np.asarray(data).flatten() - self.mean()
        return float(dx @ self.inverse() @ dx)

    def get_chisq_pte(self, data, ndof=None):
        """Probability to exceed the data chi^2, for `ndof` degrees of freedom.

        Default ndof is the data-vector dimension `size`: the quadratic form
        (x - mean)^T Cov^-1 (x - mean) of a `size`-dimensional Gaussian is chi^2_size
        (the Hartlap factor in `inverse` debiases the estimated-covariance inverse).
        Deliberate deviation: the reference (plancklens/utils.py:238) passes N - 1 (the
        *sample count* minus one), which mis-calibrates the PTE whenever the number of
        sims differs from the number of bins; pass ndof explicitly to reproduce it."""
        from scipy.stats import chi2 as chi2_dist
        return chi2_dist.sf(self.get_chisq(data), self.size if ndof is None else ndof)

    def rebin_that_nooverlap(self, orig_coord, lmins, lmaxs, weights=None):
        """New stats instance over non-overlapping [lmin, lmax] bins of `orig_coord`,
        weight-averaging entries within each bin (moments mapped as T M T^T)."""
        orig_coord = np.asarray(orig_coord)
        lmins, lmaxs = np.asarray(lmins), np.asarray(lmaxs)
        assert orig_coord.size == self.size
        assert lmins.size == lmaxs.size and np.all(lmaxs >= lmins)
        assert np.all(np.diff(lmins) > 0) and np.all(np.diff(lmaxs) > 0), \
            'bins must be sorted / non-overlapping'
        w = np.ones(self.size) if weights is None else np.asarray(weights)
        assert w.size == self.size
        T = np.zeros((lmins.size, self.size))
        for k, (lo, hi) in enumerate(zip(lmins, lmaxs)):
            sel = (orig_coord >= lo) & (orig_coord <= hi)
            if np.any(sel):
                T[k, sel] = w[sel] / np.sum(w[sel])
        out = stats(lmins.size, xcoord=0.5 * (lmins + lmaxs))
        out.sum = T @ self.sum
        out.mom = T @ self.mom @ T.T
        out.N = self.N
        return out


class QeClLib:
    """(Cross-)spectra of QE estimates with split-half mean-field subtraction.

    Args:
        qeA, qeB: QELib instances for the two legs
        mc_sims_mf: sim indices used for the mean-field (split even/odd between legs,
            reference: plancklens/qecl.py:118-119); empty array for no MF subtraction
        lmax_qlm: band limit of the spectra
    """

    def __init__(self, qeA, qeB, mc_sims_mf, lmax_qlm=None, cacher=None):
        self.qeA = qeA
        self.qeB = qeB
        self.mc_sims_mf = np.asarray(mc_sims_mf, dtype=int)
        self.lmax_qlm = lmax_qlm if lmax_qlm is not None else qeA.lmax_qlm
        self.cacher = cacher if cacher is not None else cacher_mem(maxsize=128)
        self.fskies = self._fskies()
        self.fsky1234 = self.fskies[1234]
        self.fsky11 = self.fskies[11]
        self.fsky12 = self.fskies[12]
        self.fsky22 = self.fskies[22]

    def _fskies(self):
        # sky fractions of the four legs' mask products (reference: plancklens/qecl.py:
        # 40-49, 63-68); all 1 when no leg carries a mask
        from .filt import mask_geom, fsky_mean
        ms, mean = fsky_mean([mask_geom(i) for i in (self.qeA.ivfs1, self.qeA.ivfs2,
                                                     self.qeB.ivfs1, self.qeB.ivfs2)])
        if ms is None:
            ones = {10 * i + j: 1. for i in range(1, 5) for j in range(i, 5)}
            ones[1234] = 1.
            return ones
        fskies = {10 * i + j: mean(ms[i - 1] * ms[j - 1])
                  for i in range(1, 5) for j in range(i, 5)}
        fskies[1234] = mean(ms[0] * ms[1] * ms[2] * ms[3])
        return fskies

    def hashdict(self):
        return {'qeA': self.qeA.hashdict(), 'qeB': self.qeB.hashdict(),
                'mc_sims_mf': mchash(self.mc_sims_mf)}

    def _mf(self, leg, k, exclude=()):
        """Mean-field of one leg; `exclude` drops those sims from the MF set (the
        leave-one-out path of get_sim_qcl(..., leave_out=True))."""
        mcs = self.mc_sims_mf[0::2] if leg == 'A' else self.mc_sims_mf[1::2]
        for e in exclude:
            mcs = mcs[mcs != e]
        if len(mcs) == 0:
            return None
        qlib = self.qeA if leg == 'A' else self.qeB
        return qlib.get_sim_qlm_mf(k, mcs)

    def _check_mf_containment(self, idx, idx2, leave_out):
        """Reference guard (plancklens/qecl.py:102): a spectrum sim appearing in either
        leg's MF half correlates with that MF estimate and silently biases the spectrum,
        so both idx and idx2 are checked against the full mc_sims_mf.

        Returns the per-leg leave-one-out exclusion tuples."""
        bad = [i for i in {idx, idx2} if i in self.mc_sims_mf]
        if bad and not leave_out:
            raise ValueError(
                'sim %s is inside the mean-field set: its qcl would be biased '
                'by the MF-leg correlation. Use a sim outside mc_sims_mf, or pass '
                'leave_out=True for the leave-one-out mean-field.' % bad)
        exclA = tuple(i for i in bad if i in self.mc_sims_mf[0::2])
        exclB = tuple(i for i in bad if i in self.mc_sims_mf[1::2])
        return exclA, exclB

    def get_sim_qcl(self, k1, idx, k2=None, idx2=None, leave_out=False):
        """MF-subtracted QE cross-spectrum of sims idx (leg A) and idx2 (leg B)."""
        if k2 is None:
            k2 = k1
        if idx2 is None:
            idx2 = idx
        exclA, exclB = self._check_mf_containment(idx, idx2, leave_out)
        fn = 'qcl_%s_%s_%04d_%04d' % (k1, k2, idx, idx2)
        if exclA or exclB:
            fn += '_loo'
        if not self.cacher.is_cached(fn):
            qA = self.qeA.get_sim_qlm(k1, idx)
            qB = self.qeB.get_sim_qlm(k2, idx2)
            mfA = self._mf('A', k1, exclude=exclA)
            mfB = self._mf('B', k2, exclude=exclB)
            if mfA is not None:
                qA = qA - mfA
            if mfB is not None:
                qB = qB - mfB
            cl = ualm.alm2cl(qA, self.lmax_qlm, alm2=qB)
            self.cacher.cache(fn, trace.to_host(cl, 'qcl'))
        return np.asarray(self.cacher.load(fn))

    def get_dat_qcl(self, k1, k2=None):
        """qcl of the data map (index -1 convention; reference: plancklens/qecl.py:120-124)."""
        return self.get_sim_qcl(k1, -1, k2=k2)

    def get_lmaxqcl(self, k1, k2):
        """Band limit of the (k1, k2) cross-spectrum (reference: plancklens/qecl.py:78-79)."""
        return min(self.qeA.get_lmax_qlm(k1), self.qeB.get_lmax_qlm(k2))

    def load_sim_qcl(self, k1, idx, k2=None, idx2=None):
        """get_sim_qcl without triggering its calculation: loads the cached spectrum or
        raises KeyError (reference: plancklens/qecl.py:81-83, calc=False)."""
        if k2 is None:
            k2 = k1
        if idx2 is None:
            idx2 = idx
        fn = 'qcl_%s_%s_%04d_%04d' % (k1, k2, idx, idx2)
        if not self.cacher.is_cached(fn):
            raise KeyError('qcl not computed yet: %s (use get_sim_qcl)' % fn)
        return np.asarray(self.cacher.load(fn))

    def get_sim_stats_qcl(self, k1, mc_sims, k2=None):
        """stats accumulator of the qcl over the given sims
        (reference: plancklens/qecl.py:126-145)."""
        if k2 is None:
            k2 = k1
        st = stats(self.lmax_qlm + 1, docov=False)
        for idx in mc_sims:
            st.add(self.get_sim_qcl(k1, int(idx), k2=k2))
        return st

    def get_sim_qcl_batch(self, k1, idxs, k2=None):
        """Batched MF-subtracted spectra over sims (one pipeline, sims axis), written
        through to the per-index qcl cache entries."""
        if k2 is None:
            k2 = k1
        idxs = np.atleast_1d(np.asarray(idxs, dtype=int))
        for i in idxs:
            self._check_mf_containment(int(i), int(i), False)
        fns = ['qcl_%s_%s_%04d_%04d' % (k1, k2, i, i) for i in idxs]
        if all(self.cacher.is_cached(fn) for fn in fns):
            return np.stack([np.asarray(self.cacher.load(fn)) for fn in fns])
        qA = self.qeA.get_sim_qlm_batch(k1, idxs)
        qB = qA if (self.qeB is self.qeA and k2 == k1) \
            else self.qeB.get_sim_qlm_batch(k2, idxs)
        mfA = self._mf('A', k1)
        mfB = self._mf('B', k2)
        if mfA is not None:
            qA = qA - mfA[None, :]
        if mfB is not None:
            qB = qB - mfB[None, :]
        cls = trace.to_host(ualm.alm2cl(qA, self.lmax_qlm, alm2=qB), 'qcl')
        for j, fn in enumerate(fns):
            self.cacher.cache(fn, cls[j])
        return cls


class InputPlmLib:
    """qlm-library view over a sim library's input lensing potentials, the B leg of a
    `qlms_x_in` cross-spectra library (reference: plancklens_tpu/models/qecl.py:269-298;
    role of plancklens' optional qlms_x_in parfile attribute). The input alms come back on
    the sim library's device; `device` places the zeros of curl keys and mean fields."""

    def __init__(self, sim_lib, lmax_qlm, *, device):
        self.sim_lib = sim_lib      # needs get_sim_plm
        self.lmax_qlm = lmax_qlm
        self.device = torch.device(device)
        self.ivfs1 = self.ivfs2 = _FullSkyLeg()

    def hashdict(self):
        return {'sim_lib': self.sim_lib.hashdict(), 'lmax_qlm': self.lmax_qlm,
                'input_plm': True}

    def _zeros(self):
        return torch.zeros(ualm.getsize(self.lmax_qlm), dtype=torch.complex128,
                           device=self.device)

    def get_sim_qlm(self, k, idx, grad_only=False):
        """The input potential's alms to lmax_qlm (zeros for a curl key); `grad_only` is
        the JAX package's keyword, unused there too."""
        if k[0] == 'x':   # no input curl: the cross of a curl QE with the input is zero
            return self._zeros()
        plm = self.sim_lib.get_sim_plm(int(idx))
        return ualm.alm_copy(plm, ualm.getlmax(plm.shape[-1]), self.lmax_qlm)

    def get_sim_qlm_mf(self, k, mc_sims):
        return self._zeros()

    def get_sim_qlm_batch(self, k, idxs):
        return torch.stack([self.get_sim_qlm(k, int(i)) for i in np.atleast_1d(idxs)])

    def get_lmax_qlm(self, k):
        return self.lmax_qlm


class _FullSkyLeg:
    """Marker leg with no mask: QeClLib._fskies treats it as the full sky."""

    def hashdict(self):
        return {'fullsky': True}


class QeClAverage:
    """Average of several QE-spectra libraries (e.g. over data splits)
    (reference: plancklens/qecl.py:151-224)."""

    def __init__(self, qcls_libs, weights=None):
        self.libs = list(qcls_libs)
        self.weights = np.full(len(self.libs), 1. / len(self.libs)) if weights is None \
            else np.asarray(weights, dtype=float) / np.sum(weights)
        self.lmax_qlm = self.libs[0].lmax_qlm

    def hashdict(self):
        return {'libs': [lib.hashdict() for lib in self.libs],
                'weights': tuple(self.weights)}

    def get_sim_qcl(self, k1, idx, k2=None, idx2=None):
        ret = 0.
        for w, lib in zip(self.weights, self.libs):
            ret = ret + w * lib.get_sim_qcl(k1, idx, k2=k2, idx2=idx2)
        return ret

    def get_dat_qcl(self, k1, k2=None):
        """Weighted average of the member libraries' data-map qcls
        (reference: plancklens/qecl.py:197-202)."""
        return self.get_sim_qcl(k1, -1, k2=k2)

    def get_lmaxqcl(self, k1, k2):
        """Common band limit across the member libraries (reference: plancklens/qecl.py:175-176)."""
        return min(lib.get_lmaxqcl(k1, k2) for lib in self.libs)

    def get_sim_stats_qcl(self, k1, mc_sims, k2=None):
        st = stats(self.lmax_qlm + 1, docov=False)
        for idx in mc_sims:
            st.add(self.get_sim_qcl(k1, int(idx), k2=k2))
        return st
