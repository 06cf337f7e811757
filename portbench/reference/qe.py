"""Plain quadratic estimators of the lensing gradient (and curl) from filtered alms.

The estimators are plancklens's, written out:
    ptt: d = T(n) [sum_lm -C^TT_l sqrt(l (l + 1)) T_lm  _1Y_lm](n)        (spin 0 x spin 1)
    p_p: d = 1/2 P_{-2}(n) [spin-3 leg from E, B with sqrt((l - 2)(l + 3))]
           + 1/2 P_{+2}(n) [spin-(-1) leg with sqrt((l + 2)(l - 1))]
with the legs' E/B weights -(C^EE -+ C^BB)/2 by input spin, and the spin-1 product analysed
to (g, c) and scaled by sqrt(L (L + 1)). Each leg turns its input spins into one spin
field as plancklens's leg evaluation does: inputs of spin -+2 read (E, B), of spin 0 read
T; the signs are healpy's. A cross estimator of two sims is symmetrised: the mean of
d(X, Y) and d(Y, X).
"""
import numpy as np
import torch

from ..inputs import lm_of_index


def _sq(v):
    return np.sqrt(np.maximum(v, 0.))


def qe_terms(key, cls, lmax):
    """[(leg_a, leg_b)], a leg = ([(spin_in, weight_l)], spin_out)."""
    ls = np.arange(lmax + 1, dtype=float)
    one = np.ones(lmax + 1)
    if key == 'ptt':
        return [(([(0, one)], 0), ([(0, -cls['tt'][:lmax + 1] * _sq(ls * (ls + 1.)))], 1))]
    if key == 'p_p':
        ee, bb = cls['ee'][:lmax + 1], cls['bb'][:lmax + 1]
        a, b = _sq((ls - 2.) * (ls + 3.)), _sq((ls + 2.) * (ls - 1.))
        return [(([(-2, 0.5 * one)], -2),
                 ([(-2, -0.5 * (ee - bb) * a), (2, -0.5 * (ee + bb) * a)], 3)),
                (([(2, 0.5 * one)], 2),
                 ([(-2, -0.5 * (ee + bb) * b), (2, -0.5 * (ee - bb) * b)], -1))]
    raise ValueError('no reference for QE key %s' % key)


class QE:
    """Estimators of band limit lmax_qlm from filtered alms of band limit lmax, on the
    Gauss-Legendre grid exact for the products (rings and longitudes from `grid_of`).
    `terms(key, cls, lmax)` gives the key's terms (qe_terms by default; a reference module
    brings its own for keys that qe_terms lacks)."""

    def __init__(self, key, cls, lmax, lmax_qlm, sht_of, device, terms=qe_terms):
        self.terms = terms(key, cls, lmax)
        self.lmax, self.lmax_qlm = lmax, lmax_qlm
        self.sht_leg = sht_of(lmax)
        self.sht_out = sht_of(lmax_qlm)
        ls, _ = lm_of_index(lmax)
        self._l = torch.as_tensor(ls, device=device)
        L = np.arange(lmax_qlm + 1, dtype=float)
        lq, _ = lm_of_index(lmax_qlm)
        self._cL = torch.as_tensor(_sq(L * (L + 1.)), device=device)[torch.as_tensor(lq)]

    def _w(self, cl):
        return torch.as_tensor(np.asarray(cl, dtype=float), device=self._l.device)[self._l]

    def leg(self, leg, teb):
        """Complex spin field of a leg on filtered (t, e, b), each (B, nalm)."""
        ins, so = leg
        t, e, b = teb
        glm = clm = None
        for si, cl in ins:
            w = self._w(cl)
            if si == 0:
                g, c = w * t, None
            else:
                g, c = -w * e, (w if si < 0 else -w) * b
            glm = g if glm is None else glm + g
            if c is not None:
                clm = c if clm is None else clm + c
        glm = -glm
        sht = self.sht_leg
        if so == 0:
            return sht.alm2map(-glm).to(sht.cdtype)
        clm = torch.zeros_like(glm) if clm is None else (-clm if so > 0 else clm)
        f = sht.alm2field_spin(glm, clm, abs(so))
        if so < 0:          # a negative output spin flips re (odd spin) or im (even)
            f = -torch.conj(f) if so % 2 else torch.conj(f)
        return f

    def analyse(self, d):
        """(g, c) of the spin-1 product maps d, scaled by sqrt(L (L + 1))."""
        g, c = self.sht_out.field2alm_spin(d, 1)
        return g * self._cL, c * self._cL

    def __call__(self, teb1, teb2=None):
        """(g, c) of the estimator; with teb2 the symmetrised cross estimator."""
        d = None
        for la, lb in self.terms:
            x = self.leg(la, teb1) * self.leg(lb, teb1 if teb2 is None else teb2)
            if teb2 is not None:
                x = x + self.leg(la, teb2) * self.leg(lb, teb1)
            d = x if d is None else d + x
        g, c = self.analyse(d)
        if teb2 is not None:
            g, c = 0.5 * g, 0.5 * c
        return g, c


def alm2cl(a, b, lmax):
    """Cross-spectra of (B, nalm) alms: sum_m (2 - delta_m0) Re(a b*) / (2 l + 1)."""
    ls, ms = lm_of_index(lmax)
    lt = torch.as_tensor(ls, device=a.device)
    w = torch.as_tensor(np.where(ms == 0, 1., 2.), device=a.device)
    prod = (a * torch.conj(b)).real.to(torch.float64) * w
    out = torch.zeros((a.shape[0], lmax + 1), dtype=torch.float64, device=a.device)
    out.index_add_(1, lt, prod)
    return out / torch.as_tensor(2. * np.arange(lmax + 1) + 1., device=a.device)
