r"""N1 lensing-bias library, in torch (port of plancklens_tpu/models/n1.py; reference:
plancklens/n1/n1.py).

Wraps the flat-sky integrand (ops/n1kern.py), evaluated on `device` in f64: the per-L
values on a sparse L grid are cubic-splined on the host (scipy, s=0, k=3) with flattening
weights exactly as the reference (n1/n1.py:235-237); composite estimator keys ('p',
'p_p', 'p_eb', ...) are weighted sums over fundamental key pairs (n1/n1.py:51-81). The
whole knot vector of a key pair is one n1kern.n1L_batch call (the reference distributes
L values over MPI ranks, n1/n1.py:215-226), and the jointly-filtered path evaluates all
uncached primed-field combinations in one n1L_jtp_batch call. Cache keys are the
reference's strings.

Array convention (inherited from the reference's Fortran interface for bit-parity):
spectrum/filter arrays are indexed with entry [i] at multipole i+1; callers passing the
usual l=0-based arrays reproduce the reference's results exactly, including its
effective one-multipole shift in the lookups.
"""
import numpy as np
import torch
from scipy.interpolate import UnivariateSpline as spline

from ..utils.cls import cli
from ..utils.hashing import clhash
from ..utils.cachers import cacher_mem
from ..ops import n1kern

estimator_keys = ['ptt', 'pte', 'pet', 'pee', 'peb', 'pbe', 'ptb', 'pbt',
                  'xtt', 'xte', 'xet', 'xee', 'xeb', 'xbe', 'xtb', 'xbt',
                  'stt', 'ftt']
estimator_keys_derived = ['p', 'p_p', 'p_tp', 'p_eb', 'p_te', 'p_tb',
                          'f', 'f_p', 'f_tp', 'f_eb', 'f_te', 'f_tb',
                          'x', 'x_p', 'x_tp', 'x_eb', 'x_te', 'x_tb']


def _get_est_derived(k, lmax):
    """Fundamental-key decomposition of composite keys
    (reference: plancklens/n1/n1.py:51-81)."""
    clo = np.ones(lmax + 1, dtype=float)
    if k in ['p', 'x', 'f']:
        return [('%stt' % k, clo), ('%ste' % k, 2. * clo), ('%stb' % k, 2. * clo),
                ('%see' % k, clo), ('%seb' % k, 2. * clo)]
    if k in ['p_tp', 'x_tp', 'f_tp']:
        g = k[0]
        return [('%stt' % g, clo), ('%see' % g, clo), ('%seb' % g, 2. * clo)]
    if k in ['p_p', 'x_p', 'f_p']:
        g = k[0]
        return [('%see' % g, clo), ('%seb' % g, 2. * clo)]
    if k in ['p_te', 'x_te', 'p_tb', 'x_tb', 'p_eb', 'x_eb', 'f_te', 'f_tb', 'f_eb']:
        return [(k.replace('_', ''), 2. * clo)]
    if k in estimator_keys:
        return [(k, clo)]
    assert 0, k


def default_lps(lmaxphi=2500):
    """Default anisotropy-source multipole knots (reference: plancklens/n1/n1.py:104-116)."""
    lps = [1]
    for l in range(2, 111, 10):
        lps.append(l)
    for l in range(lps[-1] + 30, 580, 30):
        lps.append(l)
    for l in range(lps[-1] + 100, lmaxphi // 2, 100):
        lps.append(l)
    for l in range(lps[-1] + 300, lmaxphi, 300):
        lps.append(l)
    if lps[-1] != lmaxphi:
        lps.append(lmaxphi)
    return np.array(lps)


class N1Lib:
    """N1 biases for arbitrary QE key pairs.

    Args:
        cltt, clte, clee: CMB spectra of the maps (and, by default, of the QE weights)
        lmaxphi: max anisotropy-source multipole
        dL: radial integration step
        lps: source multipole knots (defaults to the reference grid)
        device: where the integrand is evaluated (f64)
    """

    def __init__(self, cltt, clte, clee, lmaxphi=2500, dL=10, lps=None, cacher=None, *,
                 device):
        self.device = torch.device(device)
        self.cltt = np.asarray(cltt)
        self.clte = np.asarray(clte)
        self.clee = np.asarray(clee)
        self.dL = dL
        self.lps = default_lps(lmaxphi) if lps is None else np.asarray(lps)
        self.lmaxphi = self.lps[-1]
        self.cacher = cacher if cacher is not None else cacher_mem()

    def hashdict(self):
        return {'cltt': clhash(self.cltt), 'clte': clhash(self.clte),
                'clee': clhash(self.clee), 'dL': self.dL, 'lps': tuple(self.lps)}

    def _ls_grid(self, Lmax):
        return np.unique(np.concatenate([np.arange(1, 11), np.arange(1, Lmax + 1)[::20],
                                         [Lmax]]))

    def get_n1(self, kA, k_ind, cl_kind, ftlA, felA, fblA, Lmax, kB=None, ftlB=None,
               felB=None, fblB=None, clttfid=None, cltefid=None, cleefid=None,
               n1_flat=None):
        """N1 curve up to Lmax for QE keys (kA, kB) and anisotropy source k_ind with
        spectrum cl_kind (reference: plancklens/n1/n1.py:142-315)."""
        if kB is None:
            kB = kA
        if ftlB is None:
            ftlB, felB, fblB = ftlA, felA, fblA
        clttfid = self.cltt if clttfid is None else np.asarray(clttfid)
        cltefid = self.clte if cltefid is None else np.asarray(cltefid)
        cleefid = self.clee if cleefid is None else np.asarray(cleefid)
        if n1_flat is None:
            n1_flat = lambda ell: np.ones(len(ell), dtype=float)

        if kA in estimator_keys and kB in estimator_keys:
            if kA < kB:
                return self.get_n1(kB, k_ind, cl_kind, ftlB, felB, fblB, Lmax, kB=kA,
                                   ftlB=ftlA, felB=felA, fblB=fblA, clttfid=clttfid,
                                   cltefid=cltefid, cleefid=cleefid, n1_flat=n1_flat)
            fn = '_'.join(['n1', kA, kB, k_ind, clhash(cl_kind), clhash(ftlA),
                           clhash(felA), clhash(fblA), clhash(ftlB), clhash(felB),
                           clhash(fblB), clhash(clttfid), clhash(cltefid),
                           clhash(cleefid), str(Lmax)])
            if not self.cacher.is_cached(fn):
                lminA = int(np.min([np.min(np.where(np.abs(f) > 0.)[0], initial=len(f))
                                    for f in [ftlA, felA, fblA]])) + 1
                lminB = int(np.min([np.min(np.where(np.abs(f) > 0.)[0], initial=len(f))
                                    for f in [ftlB, felB, fblB]])) + 1
                Ls = self._ls_grid(Lmax)
                # the whole knot vector in one call (the reference distributes L over
                # MPI ranks, n1/n1.py:215-226)
                n1L = n1kern.n1L_batch(
                    Ls, kA, kB, k_ind, cl_kind, self.cltt, self.clte, self.clee,
                    clttfid, cltefid, cleefid, ftlA, felA, fblA, ftlB, felB, fblB,
                    max(lminA, 1), max(lminB, 1), self.dL, self.lps, device=self.device)
                ret = np.zeros(Lmax + 1)
                ret[1:] = spline(Ls, n1L * n1_flat(Ls), s=0., ext='raise', k=3)(
                    np.arange(1, Lmax + 1) * 1.)
                ret[1:] *= cli(n1_flat(np.arange(1, Lmax + 1) * 1.))
                self.cacher.cache(fn, ret)
            return np.asarray(self.cacher.load(fn))

        if kA in estimator_keys_derived and kB in estimator_keys_derived:
            ret = 0.
            for tk1, cl1 in _get_est_derived(kA, Lmax):
                for tk2, cl2 in _get_est_derived(kB, Lmax):
                    tret = self.get_n1(tk1, k_ind, cl_kind, ftlA, felA, fblA, Lmax,
                                       kB=tk2, ftlB=ftlB, felB=felB, fblB=fblB,
                                       clttfid=clttfid, cltefid=cltefid, cleefid=cleefid,
                                       n1_flat=n1_flat)
                    ret = ret + tret * cl1[:Lmax + 1] * cl2[:Lmax + 1]
            return ret
        if kA in estimator_keys_derived:
            ret = 0.
            for tk1, cl1 in _get_est_derived(kA, Lmax):
                ret = ret + cl1[:Lmax + 1] * self.get_n1(
                    tk1, k_ind, cl_kind, ftlA, felA, fblA, Lmax, kB=kB, ftlB=ftlB,
                    felB=felB, fblB=fblB, clttfid=clttfid, cltefid=cltefid,
                    cleefid=cleefid, n1_flat=n1_flat)
            return ret
        if kB in estimator_keys_derived:
            ret = 0.
            for tk2, cl2 in _get_est_derived(kB, Lmax):
                ret = ret + cl2[:Lmax + 1] * self.get_n1(
                    kA, k_ind, cl_kind, ftlA, felA, fblA, Lmax, kB=tk2, ftlB=ftlB,
                    felB=felB, fblB=fblB, clttfid=clttfid, cltefid=cltefid,
                    cleefid=cleefid, n1_flat=n1_flat)
            return ret
        assert 0, (kA, kB)


def get_n1_jtp(self, kA, k_ind, cl_kind, fAlmat, Lmax, kB=None, fBlmat=None,
               clttfid=None, cltefid=None, cleefid=None, n1_flat=None):
    """N1 for jointly-filtered (3x3 matrix) legs: sums the kernel over all primed-field
    combinations weighted by the filtering-matrix elements
    (reference: plancklens/n1/n1.py:318-437)."""
    if kB is None:
        kB = kA
    if kA[0] == 's' or kB[0] == 's':
        assert kA[0] == kB[0]
    if fBlmat is None:
        fBlmat = fAlmat
    clttfid = self.cltt if clttfid is None else np.asarray(clttfid)
    cltefid = self.clte if cltefid is None else np.asarray(cltefid)
    cleefid = self.clee if cleefid is None else np.asarray(cleefid)
    if n1_flat is None:
        n1_flat = lambda ell: np.ones(len(ell), dtype=float)

    if kA in estimator_keys and kB in estimator_keys:
        if kA < kB:
            return self.get_n1_jtp(kB, k_ind, cl_kind, fBlmat, Lmax, kB=kA, fBlmat=fAlmat,
                                   clttfid=clttfid, cltefid=cltefid, cleefid=cleefid,
                                   n1_flat=n1_flat)
        X, Y = kA[1:]
        I, J = kB[1:]
        # enumerate the non-zero primed-field combinations (reference loops them on the
        # host, one MPI-distributed L sequence each: n1/n1.py:361-406); all uncached
        # combinations x all L knots go to one n1L_jtp_batch call
        combos = []
        for Xp in 'teb':
            FXXp = fAlmat.get(X + Xp, fAlmat.get(Xp + X, np.array([0.])))
            if not np.any(FXXp):
                continue
            for Yp in 'teb':
                FYYp = fAlmat.get(Y + Yp, fAlmat.get(Yp + Y, np.array([0.])))
                if not np.any(FYYp):
                    continue
                for Ip in 'teb':
                    FIIp = fBlmat.get(I + Ip, fBlmat.get(Ip + I, np.array([0.])))
                    if not np.any(FIIp):
                        continue
                    for Jp in 'teb':
                        FJJp = fBlmat.get(J + Jp, fBlmat.get(Jp + J, np.array([0.])))
                        if not np.any(FJJp):
                            continue
                        fn = '_'.join(['n1jtp', kA, kB, k_ind, X + Xp + Y + Yp + I + Ip
                                       + J + Jp, clhash(cl_kind), clhash(FXXp),
                                       clhash(FYYp), clhash(FIIp), clhash(FJJp),
                                       clhash(clttfid), clhash(cltefid),
                                       clhash(cleefid), str(Lmax)])
                        combos.append((fn, Xp + Yp + Ip + Jp, FXXp, FYYp, FIIp, FJJp))
        todo = [c for c in combos if not self.cacher.is_cached(c[0])]
        if todo:
            Ls = self._ls_grid(Lmax)
            n1mat = n1kern.n1L_jtp_batch(
                Ls, kA, kB, [c[1:] for c in todo], k_ind, cl_kind,
                self.cltt, self.clte, self.clee, clttfid, cltefid, cleefid,
                1, 1, self.dL, self.lps, device=self.device)
            ells = np.arange(1, Lmax + 1) * 1.
            for (fn, _f, _x, _y, _i, _j), n1L in zip(todo, n1mat):
                out = np.zeros(Lmax + 1)
                out[1:] = spline(Ls, n1L * n1_flat(Ls), s=0., ext='raise', k=3)(ells)
                out[1:] *= cli(n1_flat(ells))
                self.cacher.cache(fn, out)
        ret = 0.
        for c in combos:
            ret = ret + np.asarray(self.cacher.load(c[0]))
        return ret
    if kA in estimator_keys_derived or kB in estimator_keys_derived:
        ret = 0.
        for tk1, cl1 in _get_est_derived(kA, Lmax):
            for tk2, cl2 in _get_est_derived(kB, Lmax):
                tret = self.get_n1_jtp(tk1, k_ind, cl_kind, fAlmat, Lmax, kB=tk2,
                                       fBlmat=fBlmat, clttfid=clttfid, cltefid=cltefid,
                                       cleefid=cleefid, n1_flat=n1_flat)
                ret = ret + tret * cl1[:Lmax + 1] * cl2[:Lmax + 1]
        return ret
    assert 0, (kA, kB)


N1Lib.get_n1_jtp = get_n1_jtp
