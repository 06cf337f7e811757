r"""Exact HEALPix pixel window functions, in torch.

Port of plancklens_tpu/ops/sht/pixwin.py (see its docstring for the method). With
per-pixel integrals w_lm(p) = int_p Y*_lm dOmega (Gorski et al. 2005),

    W_l^2 = 4 pi / ((2l+1) Npix Omega_pix^2) * sum_p sum_m |w_lm(p)|^2,

and the same formula with spin-2 harmonics (n = +-2 analysis legs) gives the
polarisation window (healpy's pixwin(pol=True)). Each ring of pixel shapes is one batched
plain Legendre analysis (:func:`core.legendre_anal`, kernel K4 on the card) on a grid of
latitude quadrature nodes inside the ring's band: a few dozen node "rings" against a batch
of up to 2^k pixel shapes. The host parts (`_ring_shapes`, `_ring_nodes`, `_ring_Gm`,
`_spline_x`) are copied from the reference; the sum over m and shapes runs on the device.

The shipped exact tables of the reference (nside 4..128, computed by the JAX package in
f64) are read in place; a table computed here is kept in a memory cache only.
"""
import os

import numpy as np
import torch

from .core import legendre_anal
from .transforms import _CDTYPE, _facl
from ... import DATAPATH

_EXACT_NSIDE_MAX = 128     # exact evaluation bound of the shipped scheme (healpy parity)
_TABLE_DIR = os.path.join(DATAPATH, 'pixwin')
_MEM_CACHE = {}


def _ring_shapes(nside, i):
    """Distinct pixel shapes of northern ring i (1-based) as (x_offset_index d, mult).

    Cap rings (i <= nside, including the straddling bottom row of the cap faces at
    i = nside): pixel centres sit at x_c = d h off the face centre, d = a - b with
    a + b = i - 1; reflections d -> -d and the 4-fold face symmetry make |d| the shape
    label.  Belt rings: all 4 nside pixels are congruent (x translation only)."""
    if i <= nside:
        return [(d, 4 if d == 0 else 8) for d in range(i - 1, -1, -2)]
    return [(0, 4 * nside)]


def _ring_nodes(nside, i, k):
    """Latitude quadrature nodes shared by all shapes of northern ring i.

    Returns (y, gw, theta): 4 GL segments of k nodes between the diamond's vertices,
    split at the waist y_c (kink of the width function) and at the segment midpoints;
    for the cap-face bottom row (i = nside) the waist coincides with the belt/cap zone
    boundary y = pi/4, so the piecewise projection map never crosses a segment."""
    from ..gauleg import gauleg
    h = np.pi / (4. * nside)
    y_c = np.pi / 2. - i * h
    edges = np.array([y_c - h, y_c - 0.5 * h, y_c, y_c + 0.5 * h, y_c + h])
    xg, wg = gauleg(k)
    y = np.concatenate([(0.5 * (a + b) + 0.5 * (b - a) * xg)
                        for a, b in zip(edges[:-1], edges[1:])])
    gw = np.concatenate([0.5 * (b - a) * wg for a, b in zip(edges[:-1], edges[1:])])
    cap = y > np.pi / 4. + 1e-14
    sigma = np.where(cap, 2. - 4. * y / np.pi, 1.)
    z = np.where(cap, 1. - sigma ** 2 / 3., 8. * y / (3. * np.pi))
    jac = 8. / (3. * np.pi) * np.where(cap, sigma, 1.)
    theta = np.arccos(np.clip(z, -1., 1.))
    return y, y_c, gw * jac, sigma, cap, theta


def _ring_Gm(nside, i, mmax, k=12):
    """Ring Fourier data G (nshapes, nnodes, mmax+1) and theta for northern ring i:
    G[s, j, m] = c_j * int_{pixel s phi-interval at node j} e^{-i m phi} dphi."""
    shapes = _ring_shapes(nside, i)
    y, y_c, cw, sigma, cap, theta = _ring_nodes(nside, i, k)
    h = np.pi / (4. * nside)
    whw = h - np.abs(y - y_c)                       # projection half-width at node
    ms = np.arange(mmax + 1, dtype=np.float64)
    # int_{phi_c-hw}^{phi_c+hw} e^{-im phi} dphi = 2 e^{-im phi_c} sin(m hw)/m: only
    # the phase depends on the shape offset d, so weight x amplitude is hoisted
    phi_hw = whw / sigma                            # sphere half-width (sigma=1 in belt)
    amp = np.where(ms[None, :] > 0,
                   2. * np.sin(ms[None, :] * phi_hw[:, None])
                   / np.where(ms[None, :] > 0, ms[None, :], 1.),
                   2. * phi_hw[:, None])
    wamp = cw[:, None] * amp
    G = np.empty((len(shapes), len(y), mmax + 1), dtype=np.complex128)
    for s, (d, _) in enumerate(shapes):
        phi_c = (d * h) / sigma                     # sphere centre offset (phi_face = 0)
        G[s] = wamp * np.exp(-1j * ms[None, :] * phi_c[:, None])
    return G, theta, np.array([m for _, m in shapes], dtype=np.float64)


def _pad_pow2(n):
    p = 1
    while p < n:
        p *= 2
    return p


def _sum_m_sq(A, n):
    """sum over the full m in [-l, l] of |w_lm|^2 from the m >= 0 analysis outputs.

    For a real integration region, |w_{l,-m}| = |w_lm| at spin 0 (fold m > 0 twice);
    at spin n != 0, |w^{(n)}_{l,-m}| = |w^{(-n)}_{l,m}|, so the caller sums the two
    +-n legs over m >= 1 and the (leg-equal) m = 0 term is halved here to land once."""
    a2 = A.abs() ** 2
    if n == 0:
        return a2[..., 0] + 2. * a2[..., 1:].sum(-1)
    return 0.5 * a2[..., 0] + a2[..., 1:].sum(-1)


def pixwin_exact(nside, lmax=None, pol=False, k=12, *, device, dtype=torch.float64):
    """Exact pixel window by the per-shape boundary integral (see module docstring).

    Cost grows as nside^2 shape integrals; intended for nside <= 128 (like the exact
    regime of healpy's own tables) - :func:`pixwin` handles larger nside by rescaling.
    The analyses run in `dtype` (their tables in f64) on `device`.

    Returns numpy W_l (lmax+1,) for pol=False, else (W_l^T, W_l^P)."""
    nside = int(nside)
    if lmax is None:
        lmax = 4 * nside
    device = torch.device(device)
    npix = 12 * nside ** 2
    omega = 4. * np.pi / npix
    legs = (0,) if not pol else (0, 2, -2)
    tot = {n: torch.zeros(lmax + 1, dtype=torch.float64, device=device) for n in legs}
    fac = torch.as_tensor(_facl(lmax), dtype=dtype, device=device)[:, None]
    for i in range(1, 2 * nside + 1):
        G, theta, mult = _ring_Gm(nside, i, lmax, k=k)
        nsh = len(mult)
        nb = _pad_pow2(nsh)
        if nb != nsh:
            G = np.concatenate([G, np.zeros((nb - nsh,) + G.shape[1:], dtype=G.dtype)])
        Gt = torch.as_tensor(G, device=device).to(_CDTYPE[dtype])
        mult_t = torch.as_tensor(mult, dtype=torch.float64, device=device)
        wring = 2. if i < 2 * nside else 1.    # southern mirror rings
        for n in legs:
            A = legendre_anal(Gt, n, theta, lmax) * fac
            S = _sum_m_sq(A[:nsh], n).to(torch.float64)   # (nshapes, lmax+1)
            tot[n] += wring * (mult_t @ S)
    tot = {n: v.cpu().numpy() for n, v in tot.items()}
    ls = np.arange(lmax + 1, dtype=np.float64)
    norm = 4. * np.pi / ((2. * ls + 1.) * npix) / omega ** 2
    wt = np.sqrt(norm * tot[0])
    if not pol:
        return wt
    wp = np.sqrt(norm * (tot[2] + tot[-2]))
    return wt, wp


def pixwin_tophat(nside, lmax):
    """Closed-form azimuthally-averaged circular-tophat model of the pixel window:
    W_l = (P_{l-1}(x0) - P_{l+1}(x0)) / ((2l+1)(1-x0)), x0 = 1 - Omega_pix / (2 pi).
    Sub-percent for l <~ 2 nside; the dependency-free cross-check of the exact
    evaluation."""
    from scipy.special import eval_legendre
    x0 = 1. - (4. * np.pi / (12 * nside ** 2)) / (2. * np.pi)
    ls = np.arange(lmax + 1)
    pm1 = np.where(ls == 0, 1., eval_legendre(np.maximum(ls - 1, 0), x0))
    pp1 = eval_legendre(ls + 1, x0)
    return (pm1 - pp1) / (2. * ls + 1.) / (1. - x0)


def _exact_table(nside, pol, device):
    """Exact W table to lmax = 4 nside: the reference's shipped file, read in place, or
    computed in f64 on `device` and kept in a memory cache (never written to disk)."""
    key = (int(nside), bool(pol))
    if key in _MEM_CACHE:
        return _MEM_CACHE[key]
    fn = os.path.join(_TABLE_DIR, 'pixwin_n%04d%s.npy' % (nside, '_pol' if pol else ''))
    if os.path.exists(fn):
        out = np.load(fn)
        out = tuple(out) if pol else out
    else:
        out = pixwin_exact(nside, 4 * nside, pol=pol, device=device)
    _MEM_CACHE[key] = out
    return out


def _spline_x(table, nside_tab, x, pol_leg=False):
    """Cubic spline of an exact table onto the self-similar coordinate x = l / nside.

    For a pol table the l < 2 zeros are a mode-counting artifact of the tabulating
    nside, not a shape property (the self-similar x -> 0 limit is 1): spline through
    [x=0: 1] + the l >= 2 entries."""
    from scipy.interpolate import CubicSpline
    xs = np.arange(len(table), dtype=np.float64) / nside_tab
    if pol_leg:
        return CubicSpline(np.concatenate([[0.], xs[2:]]),
                           np.concatenate([[1.], table[2:]]))(x)
    return CubicSpline(xs, table)(x)


def pixwin(nside, lmax, pol=False, *, device):
    """HEALPix pixel window W_l (temperature, plus polarisation when pol=True), the
    role of healpy's hp.pixwin; numpy output.

    nside <= 128: exact boundary-integral evaluation (shipped tables for nside
    4..128, computed on `device` and memory-cached otherwise). nside > 128: Richardson
    extrapolation in 1/nside of the exact 64 and 128 tables on the self-similar
    coordinate x = l/nside (the window obeys W_nside(x) = W_inf(x) + c(x)/nside to high
    accuracy; reference: plancklens_tpu/ops/sht/pixwin.py:226-261).
    lmax must be <= 4 nside (the tabulated band, as for healpy)."""
    nside, lmax = int(nside), int(lmax)
    assert lmax <= 4 * nside, (lmax, nside, 'pixel window tabulated to 4 nside only')
    if nside <= _EXACT_NSIDE_MAX:
        t = _exact_table(nside, pol, device)
        return tuple(a[:lmax + 1] for a in t) if pol else t[:lmax + 1]
    base, half = _EXACT_NSIDE_MAX, _EXACT_NSIDE_MAX // 2
    tb = _exact_table(base, pol, device)
    th = _exact_table(half, pol, device)
    x = np.arange(lmax + 1, dtype=np.float64) / nside

    def _richardson(wb, wh, pol_leg=False):
        fb = _spline_x(wb, base, x, pol_leg=pol_leg)
        fh = _spline_x(wh, half, x, pol_leg=pol_leg)
        cx = (fh - fb) / (1. / half - 1. / base)
        return (fb - cx / base) + cx / nside

    if pol:
        wt = _richardson(tb[0], th[0])
        wp = _richardson(tb[1], th[1], pol_leg=True)
        wp[:min(2, lmax + 1)] = 0.
        return wt, wp
    return _richardson(tb, th)
