r"""Expected pixel-variance maps from per-frequency variance maps and l-weights (port of
plancklens_tpu/models/freq_weighting.py).

Planck 2018 lensing paper Eqs. 16-17: the variance map of a frequency-weighted map is the
sum of the input variance maps convolved with the Legendre coefficients of the *squared*
weight correlation functions (reference: plancklens/freq_weighting.py:13-79). Runs on any
ring geometry with the port's SHT: the frequencies go through one batched `map2alm`
(kernel K2, mode 0, on a CUDA device), their sum through one `alm2map` (K1, mode 0). The
squared correlation functions come from `ops/wigner` on the same device, and the data stay
there: the maps in and out are device tensors (numpy inputs are placed on `device`; a
tensor on another device raises).
"""
import numpy as np
import torch

from ..ops.wigner import wignerpos, wignercoeff
from ..ops.gauleg import gauleg
from ..ops.sht import SHT
from ..ops.sht.transforms import _resolve_device
from ..utils import alm as ualm


def w2wsq(wl, s1, s2, lmax_out, *, device):
    """Legendre coefficients of the squared Wigner correlation function of wl, an f64
    device tensor of length lmax_out + 1 (reference: plancklens/freq_weighting.py:13-20)."""
    wl = np.asarray(wl, dtype=float)
    lmax = len(wl) - 1
    npts = (2 * lmax + lmax_out) // 2 + 1
    xg, wg = gauleg(npts)
    xi = wignerpos(wl, xg, s1, s2, device=device)
    return wignercoeff(xi ** 2 * torch.as_tensor(wg, device=xi.device), xg, 0, 0, lmax_out,
                       device=device)


def _mean_omega(geom, omega_pix):
    """Mean pixel solid angle: of `omega_pix`, or of the geometry's quadrature areas
    (weight_ring x 2 pi / nphi, the reference's default map, averaged without building it)."""
    if omega_pix is None:
        return float(np.mean(geom.weight)) * 2. * np.pi / geom.nphi
    if isinstance(omega_pix, torch.Tensor):
        return float(omega_pix.double().mean())
    return float(np.mean(omega_pix))


def _stack_maps(pix_vmaps, device):
    """The maps as one f64 (nfreq, nrings, nphi) tensor on `device`: numpy maps are placed
    there, a tensor on another device raises (as for the transforms)."""
    maps = []
    for m in pix_vmaps:
        if not isinstance(m, torch.Tensor):
            m = torch.as_tensor(np.asarray(m, dtype=float), device=device)
        elif m.device != device:
            raise ValueError('variance map on %s, transform on %s' % (m.device, device))
        maps.append(m.to(torch.float64))
    return torch.stack(maps)


def _combine(pix_vmaps, wl2s, geom, lmax_out, omega_pix, device):
    """sum_i alm2map(almxfl(map2alm(V_i), wl2_i mean(omega))) with one batched map2alm."""
    sht = SHT(geom, lmax_out, dtype=torch.float64, device=device)
    s2lm = sht.map2alm(_stack_maps(pix_vmaps, sht.device))
    scale = _mean_omega(geom, omega_pix)
    ret_lm = 0.
    for i, wl2 in enumerate(wl2s):
        ret_lm = ret_lm + ualm.almxfl(s2lm[i], lmax_out, wl2 * scale)
    return sht.alm2map(ret_lm)


def vmaps2vmap_I(pix_vmaps, weights, geom, omega_pix=None, *, device):
    """Expected intensity pixel-variance map from per-frequency variance maps + weights,
    an f64 (nrings, nphi) tensor on `device`.

    Args:
        pix_vmaps: list of (nrings, nphi) variance maps on `geom` (numpy or tensors)
        weights: (nfreq, lmax+1) weights applied to the frequency noise maps
        geom: RingGeometry
        omega_pix: pixel solid angles (defaults to the geometry quadrature areas)
    """
    device = _resolve_device(device)
    weights = np.atleast_2d(np.asarray(weights, dtype=float))
    nf, lmaxp1 = weights.shape
    # the squared correlation function carries power to 2 lmax; analysis is clamped to
    # the geometry's invertible band (the variance map holds no information beyond it)
    lmax_out = min(2 * lmaxp1 - 2, (geom.nphi - 1) // 2, geom.nrings - 1)
    wl2s = [w2wsq(wl, 0, 0, lmax_out, device=device) for wl in weights]
    return _combine(pix_vmaps, wl2s, geom, lmax_out, omega_pix, device)


def vmaps2vmap_P(pix_vmaps, weights_e, weights_b, geom, omega_pix=None, *, device):
    """Polarisation analogue: pix_vmaps are ~(s2_Q + s2_U)/2
    (reference: plancklens/freq_weighting.py:46-79)."""
    device = _resolve_device(device)
    weights_e = np.atleast_2d(np.asarray(weights_e, dtype=float))
    weights_b = np.atleast_2d(np.asarray(weights_b, dtype=float))
    nf, lmaxp1 = weights_e.shape
    lmax_out = min(2 * max(lmaxp1, weights_b.shape[1]) - 2,
                   (geom.nphi - 1) // 2, geom.nrings - 1)
    wl2s = [0.25 * w2wsq(wle + wlb, 2, 2, lmax_out, device=device)
            + 0.25 * w2wsq(wle - wlb, 2, -2, lmax_out, device=device)
            for wle, wlb in zip(weights_e, weights_b)]
    return _combine(pix_vmaps, wl2s, geom, lmax_out, omega_pix, device)
