"""The port's lensed spectra and iterative N0 against the references of
tests/test_lensed_cls.py, at that file's sizes and tolerances (f64 on the CPU):

  * `lensed_cls` of FFP10's unlensed spectra (input to l 4000, output to 1600) against
    FFP10_wdipole_lensedCls.dat (CAMB): TT, EE < 1e-3 over 100-1600, BB < 5e-4 over
    100-800 and < 2e-3 over 800-1600, TE < 1e-3 of sqrt(TT EE);
  * `get_N0_iter` (ptt and p_p, 1 / 1.4 uK-arcmin, 2', l 30-400, three iterations,
    gradient and curl) against the pinned anchors of tests/test_lensed_cls.py (rtol 1e-4),
    biased equal to unbiased when the data spectra are the fiducial ones, and the
    iterations improving on the QE and converging.
"""
import os

import numpy as np
import pytest
import torch

from test_lensed_cls import _ANCHORS, _LS                        # noqa: E402
from plancklens_tpu_torch import DATAPATH
from plancklens_tpu_torch.utils import camb_clfile
from plancklens_tpu_torch.ops.lensed_cls import lensed_cls
from plancklens_tpu_torch.models.n0s import get_N0_iter

torch.set_num_threads(1)

CPU = torch.device('cpu')


def _cls(name, lmax):
    return camb_clfile(os.path.join(DATAPATH, 'cls', 'FFP10_wdipole_%s.dat' % name),
                       lmax=lmax)


def test_lensed_cls_vs_ffp10():
    unl = _cls('lenspotentialCls', 4000)
    target = _cls('lensedCls', 1600)
    out = lensed_cls(unl, unl['pp'], lmax_out=1600, nterms=2, device=CPU)
    sel = slice(100, 1601)
    assert np.abs(out['tt'][sel] / target['tt'][sel] - 1.).max() < 1e-3
    assert np.abs(out['ee'][sel] / target['ee'][sel] - 1.).max() < 1e-3
    assert np.abs(out['bb'][100:800] / target['bb'][100:800] - 1.).max() < 5e-4
    assert np.abs(out['bb'][800:1601] / target['bb'][800:1601] - 1.).max() < 2e-3
    with np.errstate(invalid='ignore', divide='ignore'):
        te_err = np.abs(out['te'] - target['te']) / np.sqrt(target['tt'] * target['ee'])
    assert te_err[sel].max() < 1e-3


@pytest.mark.parametrize('key', ['ptt', 'p_p'])
def test_n0_iter_anchors(key):
    unl = _cls('lenspotentialCls', 2448)
    Nb, Nu, Ncu, Ncb = get_N0_iter(key, 1.0, 1.4, 2.0, unl, 30, 400, 3, ret_curl=True,
                                   device=CPU)
    for it in (0, 1, 3):
        np.testing.assert_array_equal(Nb[it], Nu[it])
        np.testing.assert_array_equal(Ncu[it], Ncb[it])
        np.testing.assert_allclose(np.asarray(Nu[it])[_LS], _ANCHORS[key][('grad', it)],
                                   rtol=1e-4, err_msg=f'{key} grad iter {it}')
        np.testing.assert_allclose(np.asarray(Ncu[it])[_LS], _ANCHORS[key][('curl', it)],
                                   rtol=1e-4, err_msg=f'{key} curl iter {it}')
    assert np.all(np.asarray(Nu[3])[_LS] <= np.asarray(Nu[0])[_LS])
    rel13 = np.abs(np.asarray(Nu[3])[_LS] / np.asarray(Nu[1])[_LS] - 1.)
    assert rel13.max() < 0.02, rel13
