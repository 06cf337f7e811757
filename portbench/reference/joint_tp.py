"""The plain reference of the joint T/P chain: upstream's library_cinv_jTP (one coupled
T/E/B C^-1 solve a sim) under the GMV estimator 'p', in plain torch. Imports nothing of the
program.

Each joint solve whose filtered alms the check reads is judged by its residual under the
reference's own coupled operator,

    (S^-1 + B^T Y^T N^-1 Y B) x = B^T Y^T N^-1 m,   x = (T, E, B),

with S the 3x3 signal matrix of TT, TE, EE, BB rescaled by R_l^2 = l (l + 1) / 2 pi, B the
beam over R_l, N^-1 the deprojected T noise of the chain's reference and the Q/U noise, and
x recovered from the program's filtered alms, bar X = R_l S^-1 x, as x = S bar X / R_l. As
in the separate masked chain, the estimators start from the program's filtered alms (the
exact solve amplifies rounding by its condition number) and take the l >= lmin cut.

The GMV estimator 'p' is plancklens's (qresp.get_qes with every spin pair of 0, -2, +2):
a term for each first-leg spin s_a, the delta leg of the spin-s_a field (weight 1/2 for
s_a = -+2) times a second leg of output spin 1 - s_a that sums, over input spins s_b, the
spin-s_b field with weight 2 w(s_b) R^-(-s_a) C^{-s_a s_b}, where w = 1 (spin 0) or 1/2,
R^-(s) = -sqrt((l - s)(l + s + 1)) / 2 and C^{s1 s2} the spin cross-spectra of the QE
weights (C^{00} = TT, C^{0,+-2} = C^{+-2,0} = -TE, C^{2,2} = EE + BB, C^{2,-2} = EE - BB).
Its gradient legs thus carry C^TE. Departures, none of which changes the estimator: TB and
EB are zero (the configuration's spectra have none), so every weight is real; the terms are
not merged or compressed as qe_simplify and qe_compress merge them; each second leg is one
spin field of its T and E/B inputs, as plancklens's qeleg_multi evaluates it. With C^TE = 0
'p' is 'ptt' + 'p_p' term by term.
"""
import numpy as np
import torch

from ..harness import check
from .chain import Reference as ChainReference, _cli, _fl, _rel
from .qe import _sq, qe_terms


def gmv_terms(key, cls, lmax):
    """qe_terms, and the GMV 'p' with its C^TE legs."""
    if key != 'p':
        return qe_terms(key, cls, lmax)
    ls = np.arange(lmax + 1, dtype=float)
    one = np.ones(lmax + 1)
    tt, te, ee, bb = (np.asarray(cls[k][:lmax + 1], dtype=float)
                      for k in ('tt', 'te', 'ee', 'bb'))
    c0 = _sq(ls * (ls + 1.))
    a, b = _sq((ls - 2.) * (ls + 3.)), _sq((ls + 2.) * (ls - 1.))
    return [(([(0, one)], 0),
             ([(0, -tt * c0), (-2, 0.5 * te * c0), (2, 0.5 * te * c0)], 1)),
            (([(-2, 0.5 * one)], -2),
             ([(-2, -0.5 * (ee - bb) * a), (2, -0.5 * (ee + bb) * a), (0, te * a)], 3)),
            (([(2, 0.5 * one)], 2),
             ([(-2, -0.5 * (ee + bb) * b), (2, -0.5 * (ee - bb) * b), (0, te * b)], -1))]


class Reference(ChainReference):
    """The chain's reference with the GMV terms and the coupled T/E/B residual."""

    qe_terms = staticmethod(gmv_terms)

    def _signal(self):
        """(lmax + 1, 3, 3) signal matrix of the filter's TT, TE, EE, BB, times R_l^2."""
        c, n = self.inp.cls, self.lmax + 1
        S = np.zeros((n, 3, 3))
        for k, i, j in (('tt', 0, 0), ('te', 0, 1), ('te', 1, 0), ('ee', 1, 1), ('bb', 2, 2)):
            S[:, i, j] = c[k][:n]
        return S * (self._rescal() ** 2)[:, None, None]

    def _apply3(self, M, v):
        """Per-l 3x3 matrices M applied to (t, e, b) alms."""
        return [sum(_fl(M[:, i, j], self.lmax, self.device) * v[j] for j in range(3)
                    if np.any(M[:, i, j])) for i in range(3)]

    def residual_tp(self, tmaps, qmaps, umaps, ivf_t, ivf_e, ivf_b):
        """|b - A x| / |b| a sim of the coupled system (module docstring), over the
        stacked (t, e, b) alms with weights 1 (m = 0) and 2 (m > 0)."""
        s, lmax = self._sims_sht(), self.lmax
        r = self._rescal()
        S = self._signal()
        bdl = _fl(self.inp.transf * _cli(r), lmax, self.device)
        ir = _fl(_cli(r), lmax, self.device)
        x = self._apply3(S, [ivf_t * ir, ivf_e * ir, ivf_b * ir])
        ninv = torch.as_tensor(self.inp.ninv_p / self.inp.grid.omega(), device=self.device)

        def op(t, q, u):
            e, b = s.map2alm_spin(q * ninv, u * ninv, 2)
            return [s.map2alm(self._ninv_t(t)) * bdl, e * bdl, b * bdl]
        rhs = op(tmaps, qmaps, umaps)
        ax = op(s.alm2map(x[0] * bdl), *s.alm2map_spin(x[1] * bdl, x[2] * bdl, 2))
        ax = [a + c for a, c in zip(ax, self._apply3(np.linalg.pinv(S), x))]
        return _rel(torch.cat([p - q for p, q in zip(rhs, ax)], -1), torch.cat(rhs, -1),
                    lmax, 3)


def compare(cfg, prog, ref):
    """{name: value} of the numbers compared, and {name: value} of finer readings:
    maps_rel of the sampled sims, cg_resid_tp (the coupled residual of the joint solve of
    every sim whose filtered alms the check reads: the sampled sims, the data sim, the
    sims before them and the warm sims) and the GMV estimators' qlm_rel, mf_rel and
    qcl_rel (portbench/harness/check.py)."""
    nums, detail = {}, {}
    check.maps_rel(prog, ref, nums)
    need, teb = sorted(prog['raw']), check.raw_teb(prog)
    r = torch.cat([ref.residual_tp(*ref.maps(need[j:j + 4]), *teb(need[j:j + 4]))
                   for j in range(0, len(need), 4)])      # four sims at a time
    detail['cg_resid_tp_by_sim'] = {str(i): float(x) for i, x in zip(need, r)}
    nums['cg_resid_tp'] = check.fmax(r)
    check.estimator_checks(prog, ref, check.raw_legs(prog, ref), nums, detail)
    return nums, detail
