"""Wigner small-d transforms on Gauss-Legendre grids, in torch.

Port of plancklens_tpu/ops/wigner.py (role of plancklens/wigners/wigners.f90:313-561 and
the wignerpos/wignercoeff entry points of plancklens/utils_spin.py:52-93). The Wigner
functions d^l_{s1 s2}(x) are materialised once per (a, b) = (|s1-s2|, |s1+s2|) pair on a GL
grid by the scaled-Jacobi three-term recursion, run on the host in f64 over all nodes at
once (numpy: the reference's `lax.scan` step, within 2e-13 of it at lmax 300) and
uploaded; every synthesis/analysis afterwards is one f64 matrix product with the cached
d-matrix on the device (`torch.matmul`: the reference computes these products outside any
Pallas kernel, so they are no kernel of the port either).

Math: d^l_{s1 s2}(x) = xi * r_k * sin(b/2)^a cos(b/2)^b * P_k^{(a,b)}(x), with
k = l - (a+b)/2, r_k = sqrt(k! (k+a+b)! / ((k+a)! (k+b)!)), and xi = -1 iff
(s1 > s2 and s1 - s2 odd) else +1.

Normalisations (identical to the reference):
  wignerpos(cl, x, s1, s2)        = sum_l cl_l (2l+1)/(4 pi) d^l_{s1 s2}(x)
  wignercoeff(xi, x, s1, s2, lmax) = 2 pi sum_i xi_i d^l_{s1 s2}(x_i)

Cache: an LRU of device d-matrices keyed by (a, b, lmax, grid token, device), PLK_DMAT_CACHE
entries (default 24, as the reference's). The responses and N0 of lmax 2048 (spectra cut at
lmax 2048) use matrices of 2049 x 3073 f64, 50 MB each; `cache_bytes()` reports what the
cache holds and the most it has held.
"""
import os
from collections import OrderedDict

import numpy as np
import torch
from scipy.special import gammaln

from .gauleg import gauleg, nquad_for
from .sht.transforms import _resolve_device

_F64 = np.float64


def _xi_sign(s1, s2):
    return -1.0 if (s1 > s2 and (s1 - s2) % 2 == 1) else 1.0


def _jacobi_rec_coeffs(K, a, b):
    """Three-term recursion coefficients for the *scaled* Jacobi polynomials
    p_k = r_k P_k^{(a,b)}: p_{k+1} = (At_k x + Bt_k) p_k - Ct_k p_{k-1}, k = 1..K-1.

    Returns float64 arrays (At, Bt, Ct) of length max(K-1, 0) plus the scale factors r_0, r_1.
    """
    a = float(a)
    b = float(b)
    k = np.arange(1, max(K, 1), dtype=_F64)
    tkab = 2. * k + a + b
    A = (tkab + 1.) * (tkab + 2.) / (2. * (k + 1.) * (k + a + b + 1.))
    B = (tkab + 1.) * (a * a - b * b) / (2. * (k + 1.) * (k + a + b + 1.) * tkab)
    C = (k + a) * (k + b) * (tkab + 2.) / ((k + 1.) * (k + a + b + 1.) * tkab)
    # rho_k = r_k / r_{k-1}
    kk = np.arange(0, max(K, 1) + 1, dtype=_F64)
    rho = np.ones_like(kk)
    rho[1:] = np.sqrt(kk[1:] * (kk[1:] + a + b) / ((kk[1:] + a) * (kk[1:] + b)))
    At = A * rho[2:2 + len(k)]
    Bt = B * rho[2:2 + len(k)]
    Ct = C * rho[2:2 + len(k)] * rho[1:1 + len(k)]
    lnr0 = 0.5 * (gammaln(1.) + gammaln(a + b + 1.) - gammaln(a + 1.) - gammaln(b + 1.))
    r0 = np.exp(lnr0)
    r1 = r0 * rho[1] if K >= 1 else r0
    return At, Bt, Ct, r0, r1


def _jacobi_pmat(K, coeffs, p0, p1, x):
    """[p_0(x), ..., p_K(x)] as a (K+1, nx) float64 matrix (host numpy)."""
    out = np.empty((K + 1, len(x)), dtype=_F64)
    out[0] = p0
    if K == 0:
        return out
    out[1] = p1
    At, Bt, Ct = coeffs
    for i in range(K - 1):
        out[i + 2] = (At[i] * x + Bt[i]) * out[i + 1] - Ct[i] * out[i]
    return out


class _DmatCache:
    """LRU of device d-matrices keyed by (a, b, lmax, grid token, device)."""

    def __init__(self, maxsize):
        self.maxsize = maxsize
        self._d = OrderedDict()
        self.peak_bytes = 0

    def get(self, key):
        if key in self._d:
            self._d.move_to_end(key)
            return self._d[key]
        return None

    def put(self, key, val):
        self._d[key] = val
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)
        self.peak_bytes = max(self.peak_bytes, self.nbytes())

    def nbytes(self):
        return sum(v.numel() * v.element_size() for v in self._d.values())

    def clear(self):
        self._d.clear()
        self.peak_bytes = 0


_DMAT_CACHE = _DmatCache(int(os.environ.get('PLK_DMAT_CACHE', 24)))


def clear_cache():
    _DMAT_CACHE.clear()


def cache_bytes():
    """(bytes the d-matrix cache holds now, the most it has held since the last clear)."""
    return _DMAT_CACHE.nbytes(), _DMAT_CACHE.peak_bytes


def _dmat_ab_np(lmax, a, b, x):
    """Host (lmax+1, nx) matrix of xi-free d-functions: rows l < (a+b)/2 are zero, rows
    l >= l0 are r_k sin^a cos^b P_k^{(a,b)}(x)."""
    l0 = (a + b) // 2
    x = np.asarray(x, dtype=_F64)
    nx = x.shape[0]
    if lmax < l0:
        return np.zeros((lmax + 1, nx), dtype=_F64)
    K = lmax - l0
    At, Bt, Ct, r0, r1 = _jacobi_rec_coeffs(K, a, b)
    pref = np.ones_like(x)
    if a > 0:
        pref = pref * (0.5 * (1. - x)) ** (0.5 * a)
    if b > 0:
        pref = pref * (0.5 * (1. + x)) ** (0.5 * b)
    p0 = r0 * pref
    p1 = (r1 * ((a + 1.) + 0.5 * (a + b + 2.) * (x - 1.))) * pref if K >= 1 else p0
    pmat = _jacobi_pmat(K, (At, Bt, Ct), p0, p1, x)
    if l0 > 0:
        pmat = np.concatenate([np.zeros((l0, nx), dtype=_F64), pmat], axis=0)
    return pmat


def _dmat_ab(lmax, a, b, x, grid_token=None, *, device):
    """(lmax+1, nx) f64 device matrix of xi-free d-functions (see _dmat_ab_np), cached
    under (a, b, lmax, grid_token, device) when a grid token is given."""
    device = _resolve_device(device)
    key = None if grid_token is None else (a, b, lmax, grid_token, str(device))
    if key is not None:
        hit = _DMAT_CACHE.get(key)
        if hit is not None:
            return hit
    out = torch.as_tensor(_dmat_ab_np(lmax, a, b, x), device=device)
    if key is not None:
        _DMAT_CACHE.put(key, out)
    return out


def wigner_dmat(lmax, s1, s2, x, grid_token=None, *, device):
    """Dense (lmax+1, nx) f64 device matrix of d^l_{s1 s2}(x_i)."""
    base = _dmat_ab(lmax, abs(s1 - s2), abs(s1 + s2), x, grid_token=grid_token, device=device)
    return base if _xi_sign(s1, s2) > 0 else -base


def _as_tensor(v, device):
    """numpy input -> f64 (or complex128) tensor on `device`; a tensor on another device
    raises, as for the transforms (ops/sht/transforms._on_device)."""
    if isinstance(v, torch.Tensor):
        if v.device != _resolve_device(device):
            raise ValueError('input on %s, Wigner transform on %s' % (v.device, device))
        return v
    v = np.asarray(v)
    return torch.as_tensor(v if np.iscomplexobj(v) else v.astype(_F64), device=device)


def wignerpos(cl, x, s1, s2, grid_token=None, *, device):
    """Position-space synthesis sum_l cl_l (2l+1)/(4 pi) d^l_{s1 s2}(x), a device tensor.
    `cl` may have leading batch dimensions; real or complex."""
    cl = _as_tensor(cl, device)
    lmax = cl.shape[-1] - 1
    dmat = wigner_dmat(lmax, s1, s2, x, grid_token=grid_token, device=device)
    fac = torch.as_tensor((2. * np.arange(lmax + 1) + 1.) / (4. * np.pi), device=cl.device)
    return (cl * fac) @ (dmat.to(cl.dtype) if cl.is_complex() else dmat)


def wignercoeff(xi, x, s1, s2, lmax, grid_token=None, *, device):
    """Analysis 2 pi sum_i xi_i d^l_{s1 s2}(x_i) for l = 0..lmax, a device tensor. For exact
    quadrature xi must include the GL weights. `xi` may have leading batch dimensions."""
    xi = _as_tensor(xi, device)
    dmat = wigner_dmat(lmax, s1, s2, x, grid_token=grid_token, device=device)
    dm = dmat.to(xi.dtype) if xi.is_complex() else dmat
    return 2. * np.pi * (xi @ dm.T)


def wignerc(cl1, cl2, sp1, s1, sp2, s2, lmax_out=None, *, device):
    """Legendre/Wigner coefficients of the product of two correlation functions: the
    harmonic-space convolution by exact GL quadrature (reference:
    plancklens/utils_spin.py:52-93). Returns a host float64 (or complex128) array."""
    cl1 = np.asarray(cl1)
    cl2 = np.asarray(cl2)
    lmax1 = len(cl1) - 1
    lmax2 = len(cl2) - 1
    if lmax_out is None:
        lmax_out = lmax1 + lmax2
    if not (np.any(cl1) and np.any(cl2)):
        return np.zeros(lmax_out + 1, dtype=float)
    npts = nquad_for(lmax1 + lmax2 + lmax_out)
    xg, wg = gauleg(npts)
    tok = ('gl', npts)
    xi1 = wignerpos(cl1, xg, sp1, s1, grid_token=tok, device=device)
    xi2 = wignerpos(cl2, xg, sp2, s2, grid_token=tok, device=device)
    wgt = torch.as_tensor(wg, device=xi1.device)
    ret = wignercoeff(xi1 * xi2 * wgt, xg, sp1 + sp2, s1 + s2, lmax_out, grid_token=tok,
                      device=device).cpu().numpy()
    if not (np.iscomplexobj(cl1) or np.iscomplexobj(cl2)):
        return ret.real.copy() if np.iscomplexobj(ret) else ret
    return ret


def wignerc_stack(specs, lmax_out, *, device):
    """Batched harmonic-space convolutions: row i of the returned host
    (len(specs), lmax_out + 1) array equals
    ``wignerc(cl1, cl2, sp1, s1, sp2, s2, lmax_out=lmax_out)`` for
    ``specs[i] = (cl1, (sp1, s1), cl2, (sp2, s2))``.

    All terms share one GL grid sized for the widest bandwidth (GL quadrature stays exact on
    a finer grid). The synthesis legs and the analysis leg are grouped by their d-matrix
    identity (the spin pair); each group is one (n_group, lmax+1) x (lmax+1, npts) matrix
    product on the cached device d-matrix. Rows whose product vanishes identically are
    zeros, as in `wignerc`."""
    n = len(specs)
    if n == 0:
        return np.zeros((0, lmax_out + 1), dtype=float)
    cl1s = [np.atleast_1d(np.asarray(s[0])) for s in specs]
    cl2s = [np.atleast_1d(np.asarray(s[2])) for s in specs]
    live = np.array([bool(np.any(c1)) and bool(np.any(c2)) for c1, c2 in zip(cl1s, cl2s)])
    any_cplx = any(np.iscomplexobj(c) for c in cl1s + cl2s)
    np_dt = np.complex128 if any_cplx else np.float64
    out = np.zeros((n, lmax_out + 1), dtype=np_dt)
    if not np.any(live):
        return out
    device = _resolve_device(device)
    t_dt = torch.complex128 if any_cplx else torch.float64

    idx_live = np.flatnonzero(live)
    bandwidth = max(len(cl1s[i]) + len(cl2s[i]) - 2 for i in idx_live)
    npts = nquad_for(bandwidth + lmax_out)
    xg, wg = gauleg(npts)
    tok = ('gl', npts)

    def _synth_grouped(cls_list, spin_pairs):
        """All position-space legs, one matrix product per distinct spin pair."""
        xi = torch.zeros((len(idx_live), npts), dtype=t_dt, device=device)
        groups = {}
        for row, i in enumerate(idx_live):
            groups.setdefault(spin_pairs[i], []).append(row)
        for (sa, sb), rows in groups.items():
            lmax_g = max(len(cls_list[idx_live[r]]) for r in rows) - 1
            stack = np.zeros((len(rows), lmax_g + 1), dtype=np_dt)
            for j, r in enumerate(rows):
                cl = cls_list[idx_live[r]]
                stack[j, :len(cl)] = cl
            xi[torch.as_tensor(rows, device=device)] = \
                wignerpos(stack, xg, sa, sb, grid_token=tok, device=device)
        return xi

    sp1s = [s[1] for s in specs]
    sp2s = [s[3] for s in specs]
    prod = _synth_grouped(cl1s, sp1s) * _synth_grouped(cl2s, sp2s) \
        * torch.as_tensor(wg, device=device)

    out_groups = {}
    for row, i in enumerate(idx_live):
        so = (sp1s[i][0] + sp2s[i][0], sp1s[i][1] + sp2s[i][1])
        out_groups.setdefault(so, []).append(row)
    res = torch.zeros((len(idx_live), lmax_out + 1), dtype=t_dt, device=device)
    for (sa, sb), rows in out_groups.items():
        r = torch.as_tensor(rows, device=device)
        res[r] = wignercoeff(prod[r], xg, sa, sb, lmax_out, grid_token=tok, device=device)
    res = res.cpu().numpy()
    out[idx_live] = res if any_cplx else res.real
    return out
