r"""Sky lensing (deflection remapping) operator, in torch.

Port of plancklens_tpu/ops/lensing.py:24-194 (role of lenspyx's alm2lenmap(_spin) in the
reference simulations, plancklens/sims/cmbs.py:104-233): lensed fields are the unlensed
fields evaluated at the geodesically deflected positions n' = exp_n(d), d = grad phi (+ the
curl part), spin fields also rotated by the parallel-transport angle.

The unlensed field is synthesised once on an oversampled equidistant (theta, phi) grid (one
batched SHT: the Legendre pair kernels on the card, then the ring FFTs), and the deflected
evaluation is separable Lagrange interpolation: a fixed (order+1)^2-point stencil per output
pixel, as torch gathers (advanced indexing with int64 index tensors) and multiply-adds on
the device of the maps. Deflected positions and the rotation angle come from exact
3-vector geodesic algebra.

The deflection is synthesised at lmax_p on the output grid; where mmax exceeds nphi/2 (a
GL grid of lmax with lmax_p = lmax + dlmax) the ring assembly folds m into the FFT bins by
`index_add_` (transforms._to_rings), as the reference does. Lensed maps are held to
tolerances against the reference and from run to run, never bitwise.
"""
import numpy as np
import torch

from ..utils import alm as ualm
from .sht import SHT, RingGeometry, good_fft_size
from .sht.transforms import _resolve_device


def ecp_rings(ntheta):
    """Midpoint equidistant colatitude rows (no rows at the poles)."""
    return (np.arange(ntheta) + 0.5) * np.pi / ntheta


def _ecp_geom(lmax, oversample):
    """The synthesis-only source grid of the interpolation: oversample x (lmax + 1) rows and
    an even nphi >= oversample x (2 lmax + 1). Zero weights: nothing is analysed on it."""
    nth = int(np.ceil(oversample * (lmax + 1)))
    # nphi must be even: the pole folding in _interp2d applies the phi + pi half turn as an
    # nphi//2 column shift, exact only then (good_fft_size alone returns odd 3^b 5^c sizes)
    nphi = good_fft_size(int(np.ceil(oversample * (2 * lmax + 1))))
    while nphi % 2:
        nphi = good_fft_size(nphi + 1)
    th = ecp_rings(nth)
    return RingGeometry('ecp_lens_%d_%d' % (nth, nphi), th, np.zeros(nth), nphi)


def _lagrange_weights(frac, order):
    """(..., order+1) separable Lagrange weights at fractional offsets in [0, 1)."""
    # stencil nodes at integer offsets -(order//2) .. order - order//2
    offs = np.arange(order + 1) - order // 2
    w = []
    for i, oi in enumerate(offs):
        num = torch.ones_like(frac)
        den = 1.
        for j, oj in enumerate(offs):
            if i == j:
                continue
            num = num * (frac - float(oj))
            den = den * float(oi - oj)
        w.append(num / den)
    return torch.stack(w, dim=-1), offs


def _interp2d(fmaps, theta_t, phi_t, order, th0, dth, spin_sign):
    """Separable Lagrange interpolation of (batch, nth, nphi) maps at target positions.

    theta rows at th0 + i dth; phi columns at 2 pi k / nphi (nphi = fmaps.shape[-1], even).
    Rows beyond a pole are folded back through f(-theta, phi + pi) = spin_sign f(theta, phi),
    the half turn as an nphi//2 column shift. Integer semantics as the reference's: floor
    to int64, and columns wrapped by `torch.remainder` (never `fmod`, which keeps the sign
    of a negative column)."""
    batch, nth, nphi = fmaps.shape
    flat = fmaps.reshape(batch, nth * nphi)
    x = (theta_t - th0) / dth           # fractional row index
    y = phi_t * nphi / (2. * np.pi)     # fractional column index
    i0 = torch.floor(x).long()
    j0 = torch.floor(y).long()
    wx, offs = _lagrange_weights(x - i0, order)
    wy, _ = _lagrange_weights(y - j0, order)
    out = torch.zeros((batch,) + tuple(theta_t.shape), dtype=fmaps.dtype, device=fmaps.device)
    one = torch.ones((), dtype=fmaps.dtype, device=fmaps.device)
    for a, oa in enumerate(offs):
        row = i0 + int(oa)
        # pole folding: row < 0 -> -(row+1) with phi + pi; row >= nth -> 2 nth - 1 - row
        below = row < 0
        above = row >= nth
        fold = below | above
        row_f = torch.where(below, -(row + 1), torch.where(above, 2 * nth - 1 - row, row))
        shift = torch.where(fold, nphi // 2, 0)
        sgn = torch.where(fold, spin_sign * one, one)
        base = row_f * nphi
        for b, ob in enumerate(offs):
            col = torch.remainder(j0 + int(ob) + shift, nphi)
            vals = flat[:, base + col]
            out = out + vals * (wx[..., a] * wy[..., b])[None] * sgn[None]
    return out


def deflection_field(plm, lmax_p, geom, sht=None, olm=None, *, device):
    """(d_theta, d_phi) deflection components on the geometry's pixels from the lensing
    potential (and optional curl potential) alms: d = eth phi (+ the curl part)."""
    if sht is None:
        sht = SHT(geom, lmax_p, device=device)
    ls = np.arange(lmax_p + 1, dtype=float)
    fl = -np.sqrt(ls * (ls + 1.))
    plm = sht._on_device(plm)
    glm = ualm.almxfl(plm, lmax_p, fl)
    clm = torch.zeros_like(glm) if olm is None \
        else ualm.almxfl(sht._on_device(olm), lmax_p, fl)
    return sht.alm2map_spin((glm, clm), 1)


def _deflect(theta, phi, red, imd):
    """Exact geodesic displacement by the deflection vector (red e_theta + imd e_phi),
    plus the parallel-transport rotation angle gamma of the local basis."""
    st, ct = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(phi), torch.cos(phi)
    n = torch.stack(torch.broadcast_tensors(st * cp, st * sp, ct), dim=-1)
    eth = torch.stack(torch.broadcast_tensors(ct * cp, ct * sp, -st), dim=-1)
    eph = torch.stack(torch.broadcast_tensors(-sp, cp, torch.zeros_like(sp)), dim=-1)
    alpha = torch.sqrt(red ** 2 + imd ** 2)
    alpha = torch.clamp(alpha, min=1e-30)
    that = (red[..., None] * eth + imd[..., None] * eph) / alpha[..., None]
    ca, sa = torch.cos(alpha), torch.sin(alpha)
    npr = ca[..., None] * n + sa[..., None] * that
    thp = torch.arccos(torch.clamp(npr[..., 2], -1., 1.))
    php = torch.remainder(torch.arctan2(npr[..., 1], npr[..., 0]), 2. * np.pi)
    # parallel transport of e_theta along the geodesic: v' = v - (v.t)(sa n + (1-ca) t)
    vdott = (eth * that).sum(-1)
    vpr = eth - vdott[..., None] * (sa[..., None] * n + (1. - ca)[..., None] * that)
    stp = torch.sin(thp)
    stp = torch.where(stp < 1e-12, torch.full_like(stp, 1e-12), stp)
    ethp = torch.stack([npr[..., 2] * torch.cos(php), npr[..., 2] * torch.sin(php), -stp],
                       dim=-1)
    ephp = torch.stack([-torch.sin(php), torch.cos(php), torch.zeros_like(php)], dim=-1)
    cosg = (vpr * ethp).sum(-1)
    sing = (vpr * ephp).sum(-1)
    gamma = torch.arctan2(sing, cosg)
    return thp, php, gamma


class Lensing:
    """Deflection-remapping operator bound to an output geometry and a device.

    Args:
        geom: output RingGeometry (e.g. the GL grid of the map simulations)
        lmax_unl: band limit of the unlensed skies
        lmax_p: band limit of the lensing potential
        oversample: ECP source-grid oversampling factor
        order: Lagrange interpolation order (odd; (order+1)^2-point stencil)
        dtype: real dtype of the transforms and the interpolation
        device: where the transforms and the interpolation run

    Entry points take alms as numpy arrays (placed on the device) or tensors on the device,
    with a leading batch axis or none; the ECP synthesis runs once for the whole batch and
    the interpolation sim by sim, as the reference's loop does.
    """

    def __init__(self, geom, lmax_unl, lmax_p=None, oversample=4.0, order=9,
                 dtype=torch.float64, *, device):
        self.geom = geom
        self.lmax_unl = lmax_unl
        self.lmax_p = lmax_unl if lmax_p is None else lmax_p
        self.device = _resolve_device(device)
        self.dtype = dtype
        self.src = _ecp_geom(lmax_unl, oversample)
        self.sht_src = SHT(self.src, lmax_unl, dtype=dtype, device=self.device)
        self.sht_p = SHT(geom, self.lmax_p, dtype=dtype, device=self.device)
        self.order = order
        th = self.src.theta
        self._th0 = float(th[0])
        self._dth = float(th[1] - th[0])
        self._theta_grid = torch.as_tensor(geom.theta, dtype=dtype, device=self.device)[:, None]
        self._phi_grid = torch.as_tensor(
            geom.phi0 + 2 * np.pi * np.arange(geom.nphi) / geom.nphi, dtype=dtype,
            device=self.device)[None, :]

    def _batch(self, alm):
        alm = self.sht_p._on_device(alm)
        return alm[None] if alm.ndim == 1 else alm

    def deflection(self, plm, olm=None):
        """(d_theta, d_phi) maps of a batch of potentials (the first step of a lensing)."""
        plm = self._batch(plm)
        olm = None if olm is None else self._batch(olm)
        return deflection_field(plm, self.lmax_p, self.geom, sht=self.sht_p, olm=olm,
                                device=self.device)

    def positions(self, red, imd):
        """Deflected (theta', phi') and the rotation angle gamma of every output pixel."""
        return _deflect(self._theta_grid[None], self._phi_grid[None], red, imd)

    def interp(self, src, thp, php, spin_sign):
        """Each source map of the batch evaluated at its own deflected positions."""
        return torch.stack([_interp2d(src[i:i + 1], thp[i], php[i], self.order, self._th0,
                                      self._dth, spin_sign)[0]
                            for i in range(src.shape[0])])

    def alm2lenmap(self, tlm, plm, olm=None):
        """Lensed temperature map(s) on the output geometry, (batch, nrings, nphi)."""
        tlm = self._batch(tlm)
        thp, php, _ = self.positions(*self.deflection(plm, olm))
        return self.interp(self.sht_src.alm2map(tlm), thp, php, 1.)

    def alm2lenmap_spin(self, gclm, plm, spin=2, olm=None):
        """Lensed spin-s maps (e.g. Q, U from unlensed E, B alms), with the exact
        parallel-transport rotation."""
        glm = self._batch(gclm[0])
        clm = self._batch(gclm[1]).broadcast_to(glm.shape)
        thp, php, gamma = self.positions(*self.deflection(plm, olm))
        q, u = self.sht_src.alm2map_spin((glm, clm), spin)
        sgn = (-1.) ** spin  # pole-crossing parity of the spin-s field
        out = self.interp(torch.complex(q, u), thp, php, sgn)
        # components in the basis parallel-transported from n pick up e^{-is gamma}
        out = out * torch.exp(-1j * spin * gamma)
        return out.real, out.imag
