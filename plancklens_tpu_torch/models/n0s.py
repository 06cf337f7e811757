"""Forecast layer (reference: plancklens_tpu/models/n0s.py). Ported so far: `gauss_beam`,
which the parameter files import; `get_N0`/`get_N0_iter` are ROADMAP queue 1 item 5."""
import numpy as np

_ARCMIN = np.pi / 180. / 60.


def gauss_beam(fwhm_amin, lmax):
    """Gaussian beam transfer function for a FWHM given in arcminutes
    (reference: plancklens_tpu/models/n0s.py:31-35)."""
    ls = np.arange(lmax + 1)
    sigma2 = (fwhm_amin * _ARCMIN / np.sqrt(8. * np.log(2.))) ** 2
    return np.exp(-0.5 * ls * (ls + 1) * sigma2)
