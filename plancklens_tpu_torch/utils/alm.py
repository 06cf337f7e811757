"""Harmonic-coefficient (alm) array layout and algebra on torch tensors.

Layout convention is the healpy triangular complex storage for m >= 0:
index(l, m) = m (2 lmax + 1 - m) / 2 + l, size = (lmax+1)(lmax+2)/2 — exactly the layout of
plancklens_tpu/utils/alm.py (reference: plancklens/utils.py:19-69 for alm_copy / alm2rlm /
rlm2alm behaviour). The dense zero-padded (lmax+1, mmax+1) matrix of `alm2lm`/`lm2alm` is
the form the Legendre kernels consume. Every function accepts leading batch dimensions
and runs on the device of its input; the index maps are host numpy, uploaded once per
(lmax, device).
"""
from functools import lru_cache

import numpy as np
import torch


def getsize(lmax, mmax=None):
    mmax = lmax if mmax is None else mmax
    return ((mmax + 1) * (mmax + 2)) // 2 + (mmax + 1) * (lmax - mmax)


def getlmax(size, mmax=None):
    """lmax for a given triangular-array size (mmax == lmax assumed if mmax is None)."""
    if mmax is not None and mmax >= 0:
        x = (2 * size + mmax ** 2 - mmax - 2) / (2 * mmax + 2)
    else:
        x = (-3 + np.sqrt(1 + 8 * size)) / 2
    if x != np.floor(x):
        return -1
    return int(x)


def getidx(lmax, l, m):
    return m * (2 * lmax + 1 - m) // 2 + l


def _lm_indices(lmax, mmax=None):
    """(l, m) integer numpy arrays indexed by triangular position."""
    mmax = lmax if mmax is None else mmax
    ls = np.concatenate([np.arange(m, lmax + 1) for m in range(mmax + 1)])
    ms = np.concatenate([np.full(lmax + 1 - m, m) for m in range(mmax + 1)])
    return ls, ms


@lru_cache(maxsize=32)
def _dev_index(lmax, device, which):
    """Device copies of the layout index maps: 'l' (l of each triangular slot) or 'lm'
    (flat position l (lmax+1) + m of each slot in the dense grid)."""
    ls, ms = _lm_indices(lmax)
    arr = ls if which == 'l' else ls * (lmax + 1) + ms
    return torch.as_tensor(arr, dtype=torch.int64, device=device)


def _real_dtype(t):
    return t.real.dtype if t.is_complex() else t.dtype


def almxfl(alm, lmax, fl):
    """Multiply alm by the l-dependent array fl (length >= lmax+1; numpy or tensor, cast
    to the alm's precision)."""
    fl = torch.as_tensor(fl, device=alm.device)
    fl = fl.to(alm.dtype if fl.is_complex() else _real_dtype(alm))
    return alm * fl[..., _dev_index(lmax, alm.device, 'l')]


def alm2cl(alm, lmax, alm2=None):
    """Power spectrum 1/(2l+1) sum_m Re(alm alm2^*), healpy convention. Summed over m on
    the dense grid (deterministic on every device)."""
    if alm2 is None:
        alm2 = alm
    prod = alm2lm(alm * torch.conj(alm2), lmax).real
    w = torch.full((lmax + 1,), 2., dtype=prod.dtype, device=prod.device)
    w[0] = 1.
    ls = torch.arange(lmax + 1, dtype=prod.dtype, device=prod.device)
    return (prod * w).sum(-1) / (2. * ls + 1.)


def alm_copy(alm, lmax_in, lmax_out):
    """Truncate/zero-pad an alm array to a new lmax (reference: plancklens/utils.py:19-35)."""
    if lmax_out == lmax_in:
        return alm
    ls_o, ms_o = _lm_indices(lmax_out)
    valid = (ls_o <= lmax_in) & (ms_o <= lmax_in)
    idx_in = np.where(valid, getidx(lmax_in, np.minimum(ls_o, lmax_in),
                                    np.minimum(ms_o, lmax_in)), 0)
    idx = torch.as_tensor(idx_in, device=alm.device)
    return alm[..., idx] * torch.as_tensor(valid, dtype=alm.dtype, device=alm.device)


def alm_splice(alm_lo, alm_hi, lsplit):
    """Merge two alm tensors: coefficients of `alm_lo` at l <= lsplit, of `alm_hi` above
    (reference: plancklens/qcinv/util_alm.py:8-24; used to splice coarse/fine solutions).
    The output carries the band limit of `alm_hi`; both lie on one device."""
    lmax_hi = getlmax(alm_hi.shape[-1])
    lo = alm_copy(alm_lo, getlmax(alm_lo.shape[-1]), lmax_hi)
    ls = _dev_index(lmax_hi, alm_hi.device, 'l')
    return torch.where(ls <= lsplit, lo, alm_hi)


def alm2lm(alm, lmax):
    """Triangular alm -> dense (..., lmax+1, lmax+1) zero-padded (l, m) matrix."""
    out = torch.zeros(alm.shape[:-1] + ((lmax + 1) ** 2,), dtype=alm.dtype,
                      device=alm.device)
    out[..., _dev_index(lmax, alm.device, 'lm')] = alm
    return out.reshape(alm.shape[:-1] + (lmax + 1, lmax + 1))


def lm2alm(lm, lmax):
    """Dense (l, m) matrix -> triangular alm array."""
    flat = lm.reshape(lm.shape[:-2] + ((lmax + 1) ** 2,))
    return flat[..., _dev_index(lmax, lm.device, 'lm')]


@lru_cache(maxsize=32)
def _rlm_maps(lmax):
    """Index maps between the triangular complex layout and the real (rlm) packing:
    rlm index l^2 <-> a_l0 (real); l^2+2m-1 / l^2+2m <-> sqrt(2) Re / Im a_lm."""
    nr = (lmax + 1) ** 2
    src = np.zeros(nr, dtype=np.int64)      # triangular index feeding each rlm slot
    imag = np.zeros(nr, dtype=bool)         # take the imaginary part
    scale = np.ones(nr)
    ls0 = np.arange(lmax + 1)
    src[ls0 ** 2] = ls0                     # (l, 0)
    rt2 = np.sqrt(2.)
    for m in range(1, lmax + 1):
        lm = np.arange(m, lmax + 1)
        ti = getidx(lmax, lm, m)
        src[lm ** 2 + 2 * m - 1] = ti
        scale[lm ** 2 + 2 * m - 1] = rt2
        src[lm ** 2 + 2 * m] = ti
        imag[lm ** 2 + 2 * m] = True
        scale[lm ** 2 + 2 * m] = rt2
    ls, ms = _lm_indices(lmax)
    re_idx = np.where(ms == 0, ls ** 2, ls ** 2 + 2 * ms - 1)
    im_idx = np.where(ms == 0, ls ** 2, ls ** 2 + 2 * ms)   # dummy for m = 0
    has_im = (ms > 0).astype(float)
    inv_scale = np.where(ms == 0, 1., 1. / rt2)
    return src, imag, scale, re_idx, im_idx, has_im, inv_scale


def alm2rlm(alm, lmax):
    """Real-valued packing of a complex alm array (reference: plancklens/utils.py:37-54)."""
    src, imag, scale, *_ = _rlm_maps(lmax)
    dev = alm.device
    g = alm[..., torch.as_tensor(src, device=dev)]
    rdt = _real_dtype(alm)
    return torch.where(torch.as_tensor(imag, device=dev), g.imag, g.real) \
        * torch.as_tensor(scale, dtype=rdt, device=dev)


def rlm2alm(rlm, lmax):
    """Inverse of :func:`alm2rlm` (reference: plancklens/utils.py:56-69)."""
    _, _, _, re_idx, im_idx, has_im, inv_scale = _rlm_maps(lmax)
    dev = rlm.device
    re = rlm[..., torch.as_tensor(re_idx, device=dev)]
    im = rlm[..., torch.as_tensor(im_idx, device=dev)] \
        * torch.as_tensor(has_im, dtype=rlm.dtype, device=dev)
    cdt = torch.complex64 if rlm.dtype == torch.float32 else torch.complex128
    # scaled in f64 and rounded once, as the reference does
    return (torch.complex(re, im)
            * torch.as_tensor(inv_scale, dtype=torch.float64, device=dev)).to(cdt)


_SYM3 = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


class TEBMatrix:
    """A real symmetric 3x3 matrix per multipole, (lmax+1, 3, 3) host numpy, applied to
    stacked (..., 3, nalm) T/E/B alms: out_i = sum_j M_ij(l) x_j. Its six entries are
    expanded over the alm layout once, on `device`, in the real `dtype` (the (nalm, 3, 3)
    gather of the reference takes 151 MB at lmax 2048 in f64); the product of complex alms
    keeps their complex dtype. An entry that is zero at every l is skipped (its terms add
    exact zeros). The matrix is read from its upper triangle."""

    def __init__(self, mat, lmax, dtype=torch.float64, *, device):
        mat = np.asarray(mat, dtype=np.float64)[:lmax + 1]
        idx = _dev_index(lmax, torch.device(device), 'l')
        self.lmax = lmax
        self.ent = {ij: torch.as_tensor(np.ascontiguousarray(mat[:, ij[0], ij[1]]),
                                        dtype=dtype, device=device)[idx]
                    for ij in _SYM3 if np.any(mat[:, ij[0], ij[1]])}

    def __call__(self, x):
        rows = []
        for i in range(3):
            acc = None
            for j in range(3):
                e = self.ent.get((min(i, j), max(i, j)))
                if e is not None:
                    acc = x[..., j, :] * e if acc is None else acc + x[..., j, :] * e
            rows.append(torch.zeros_like(x[..., i, :]) if acc is None else acc)
        return torch.stack(rows, dim=-2)
