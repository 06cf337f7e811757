r"""Lensed CMB power spectra from unlensed spectra + C_L^phiphi, in torch (f64).

Port of plancklens_tpu/ops/lensed_cls.py. Correlation-function method (Challinor & Lewis
2005, astro-ph/0502425): lensed correlation functions are the unlensed ones smoothed by
the Gaussian deflection dispersion sigma^2(beta) (non-perturbatively) and convolved with
the deflection correlation Cgl,2(beta) order by order. The Wigner-d syntheses and
analyses run on the GL grid through ops/wigner (host f64 recursions, cached d-matrices and
f64 matrix products on `device`).

The reference delegates this operation to CAMB (reference: plancklens/nhl.py:217-397 calls
camb.correlations.lensed_cls for the iterative-N0 forecasts); this is the JAX package's
self-contained implementation, validated against the shipped FFP10 lensed spectra.

Series kept: exact exp(-l(l+1) sigma^2/2) smoothing, Cgl,2 terms through second order in
the exponential ladder sum_k (l(l+1)/2 Cgl2)^k / k! d^l_{s1+k, s2-k}-type couplings.
Accuracy is set by the input band limit, not the Cgl,2 order: give input spectra ~500
multipoles beyond the highest output l (the default lmax_out keeps that margin).
"""
import numpy as np
import torch
from math import factorial as _factorial

from .gauleg import gauleg, nquad_for
from .wigner import wignerpos, wignercoeff, wigner_dmat


def lensed_cls(cls_unl, clpp, lmax_out=None, nterms=2, delta_cls=False, *, device):
    """Lensed TT/EE/BB/TE spectra (host numpy), computed on `device`.

    Args:
        cls_unl: dict with unlensed 'tt', 'ee', 'bb', 'te'
        clpp: lensing potential spectrum C_L^phiphi
        lmax_out: output band limit (defaults to input lmax - 500; for inputs too short
            to afford it, min(lmax - 50, 500))
        nterms: order in Cgl,2 kept (2 recommended; 3 changes BB by <4e-6 relative)
        delta_cls: return the lensing-induced difference (lensed - unlensed) instead of
            the lensed spectra (camb.correlations.lensed_cls delta_cls convention)
        device: where the Wigner products and the smoothing run (f64)

    Returns:
        dict with lensed 'tt', 'ee', 'bb', 'te'.
    """
    device = torch.device(device)
    lmax = len(cls_unl['tt']) - 1
    lmaxp = len(clpp) - 1
    if lmax_out is None:
        lmax_out = max(lmax - 500, min(lmax - 50, 500), 1)
    npts = nquad_for(2 * max(lmax, lmaxp) + lmax_out)
    xg, wg = gauleg(npts)
    tok = ('gl', npts)
    ls = np.arange(lmax + 1, dtype=float)
    lp = np.arange(lmaxp + 1, dtype=float)
    T = lambda a: torch.as_tensor(np.asarray(a, dtype=float), device=device)
    wg_t = T(wg)

    # deflection correlation functions
    cdd = lp * (lp + 1.) * np.asarray(clpp)
    Cgl = wignerpos(cdd, xg, 1, 1, grid_token=tok, device=device)
    Cgl2 = wignerpos(cdd, xg, -1, 1, grid_token=tok, device=device)
    # sigma^2(beta) = Cgl(0) - Cgl(beta); Cgl(0) = sum (2l+1)/4pi l(l+1) Cpp
    sig2 = float(np.sum((2 * lp + 1) / (4 * np.pi) * cdd)) - Cgl

    llp1 = ls * (ls + 1.)
    fac = (2. * ls + 1.) / (4. * np.pi)

    def _ladder(s, n_up, n_dn):
        """Path-ordered eigenvalue product for n_up raisings then n_dn lowerings from
        spin s (order-symmetric for the terms kept here)."""
        f = np.ones_like(ls, dtype=float)
        cur = s
        for _ in range(n_up):
            f *= np.sqrt(np.maximum((ls - cur) * (ls + cur + 1.), 0.))
            cur += 1
        for _ in range(n_dn):
            f *= np.sqrt(np.maximum((ls + cur) * (ls - cur + 1.), 0.))
            cur -= 1
        return f

    def _smoothed_synth(coef, expo_fac, sa, sb):
        """sum_l (2l+1)/4pi coef_l exp(-expo_l sig2(beta)/2) d^l_{sa sb}(beta)."""
        dm = wigner_dmat(len(coef) - 1, sa, sb, xg, grid_token=tok, device=device)
        E = torch.exp(-0.5 * T(expo_fac)[:, None] * sig2[None, :])
        return (E * dm).T @ T(coef * fac)

    def series_pos(cl, s1, s2, smooth_expo):
        """Lensed correlation of a (s1, s2) spectral series: each power of Cgl,2 shifts
        the spins by (+1, -1) or (-1, +1); terms up to total order `nterms`."""
        xi = torch.zeros(npts, dtype=torch.float64, device=device)
        for k in range(nterms + 1):
            xi_k = torch.zeros_like(xi)
            for u in range(k + 1):
                v = k - u
                lad = _ladder(s1, u, v) * _ladder(s2, v, u)
                coef = cl * lad / (4. ** k) / (_factorial(u) * _factorial(v))
                xi_k = xi_k + _smoothed_synth(coef, smooth_expo, s1 + u - v, s2 - u + v)
            xi = xi + (Cgl2 ** k) * xi_k
        return xi

    def coeff(xi, s1, s2):
        return wignercoeff(xi * wg_t, xg, s1, s2, lmax_out, grid_token=tok,
                           device=device).cpu().numpy()

    out = {}
    out['tt'] = coeff(series_pos(np.asarray(cls_unl['tt'])[:lmax + 1], 0, 0, llp1), 0, 0)
    # EE/BB via xi+ (spins (2,2), CE+CB) and xi- (spins (2,-2), CE-CB)
    ce = np.asarray(cls_unl['ee'])[:lmax + 1]
    cb = np.asarray(cls_unl.get('bb', np.zeros(lmax + 1)))[:lmax + 1]
    expo_p = llp1 - 4.  # exp factor for spin-2 correlations (CL05)
    clp = coeff(series_pos(ce + cb, 2, 2, expo_p), 2, 2)
    clm = coeff(series_pos(ce - cb, 2, -2, expo_p), 2, -2)
    out['ee'] = 0.5 * (clp + clm)
    out['bb'] = 0.5 * (clp - clm)
    # TE via xi_X (spins (2,0))
    te = np.asarray(cls_unl['te'])[:lmax + 1]
    out['te'] = coeff(series_pos(te, 2, 0, llp1 - 2.), 2, 0)
    if delta_cls:
        for k in out:
            unl = np.zeros(lmax_out + 1)
            cl_in = np.asarray(cls_unl.get(k, unl))
            n = min(len(cl_in), lmax_out + 1)
            unl[:n] = cl_in[:n]
            out[k] = out[k] - unl
    return out
