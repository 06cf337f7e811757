"""Port parity of the lensing operator (plancklens_tpu_torch/ops/lensing.py) against
plancklens_tpu/ops/lensing.py on the same numpy inputs, f64, on the CPU.

  * the ECP source grid: nphi even (mirror of tests/test_lensing.py:125-135), its own token;
  * `_interp2d` on random maps at targets crossing both poles, spin sign +-1: <= 1e-12 of max;
  * `_deflect`: theta' and gamma <= 1e-12 rad, phi' compared on the circle;
  * `deflection_field` with and without a curl potential: <= 1e-12 of max;
  * `Lensing.alm2lenmap`/`alm2lenmap_spin` with lmax_unl 64 on the GL grid of 48 (nphi 100,
    so the deflection's m > nphi/2 folds into the FFT bins): <= 1e-10 of max;
  * zero deflection is the identity (the unlensed synthesis), T and spin 2, to the
    interpolation's accuracy (< 3e-6 of max, the bound of tests/test_lensing.py:33-57).
"""
import os

import numpy as np
import pytest
import torch

from plancklens_tpu import DATAPATH
from plancklens_tpu.utils import camb_clfile
from plancklens_tpu.ops import lensing as rlens
from plancklens_tpu.ops.sht import gl_geometry as rgl
from plancklens_tpu_torch.ops import lensing as plens
from plancklens_tpu_torch.ops.sht import SHT, gl_geometry as pgl
from plancklens_tpu_torch.utils import alm as palm

torch.set_num_threads(1)

LMAX, LMAX_UNL = 48, 64


def _err(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return np.abs(a - ref).max() / np.abs(ref).max()


def _random_alm(cl, lmax, rng):
    ls, ms = palm._lm_indices(lmax)
    a = (rng.standard_normal(len(ls)) + 1j * rng.standard_normal(len(ls))) / np.sqrt(2.)
    a[ms == 0] = a[ms == 0].real * np.sqrt(2.)
    return a * np.sqrt(cl[ls])


def _cls():
    return camb_clfile(os.path.join(DATAPATH, 'cls', 'FFP10_wdipole_lenspotentialCls.dat'),
                       lmax=LMAX_UNL)


@pytest.mark.parametrize('lmax', [135, 250, 251, 256, 1000, 2048])
def test_ecp_geom_nphi_even_and_as_reference(lmax):
    g, r = plens._ecp_geom(lmax, 4.0), rlens._ecp_geom(lmax, 4.0)
    assert g.nphi % 2 == 0 and g.nphi >= 4 * (2 * lmax + 1) - 8
    assert (g.nphi, g.nrings, g.name) == (r.nphi, r.nrings, r.name)
    assert np.array_equal(g.theta, r.theta) and not np.any(g.weight)
    assert g.token() != pgl(lmax).token()


@pytest.mark.parametrize('spin_sign', [1., -1.])
def test_interp2d_matches_reference_across_both_poles(spin_sign):
    rng = np.random.RandomState(7)
    nth, nphi, order = 24, 40, 9
    th = plens.ecp_rings(nth)
    f = rng.standard_normal((2, nth, nphi)) + 1j * rng.standard_normal((2, nth, nphi))
    # targets within a stencil half-width of both poles, and anywhere, phi in [0, 2 pi)
    tt = np.concatenate([rng.uniform(0., 0.3, 40), rng.uniform(np.pi - 0.3, np.pi, 40),
                         rng.uniform(0., np.pi, 40)]).reshape(3, 40)
    pp = rng.uniform(0., 2. * np.pi, tt.shape)
    dth = float(th[1] - th[0])
    for i in range(2):
        ref = np.asarray(rlens._interp2d(f[i:i + 1], tt, pp, order, float(th[0]), dth,
                                         spin_sign))
        out = plens._interp2d(torch.as_tensor(f[i:i + 1]), torch.as_tensor(tt),
                              torch.as_tensor(pp), order, float(th[0]), dth, spin_sign)
        assert out.shape == ref.shape and _err(out.numpy(), ref) <= 1e-12


def test_deflect_matches_reference():
    rng = np.random.RandomState(3)
    theta = np.concatenate([[1e-4, np.pi - 1e-4], rng.uniform(0., np.pi, 298)])
    phi = rng.uniform(0., 2. * np.pi, 300)
    red, imd = rng.standard_normal((2, 300)) * 3e-3
    red[:2] = [-5e-3, 5e-3]                  # across the north and the south pole
    imd[2] = 0.
    red[2] = 0.                              # no deflection
    ref = [np.asarray(a) for a in rlens._deflect(theta, phi, red, imd)]
    out = [a.numpy() for a in plens._deflect(*(torch.as_tensor(a)
                                               for a in (theta, phi, red, imd)))]
    assert np.abs(out[0] - ref[0]).max() <= 1e-12
    dphi = np.angle(np.exp(1j * (out[1] - ref[1])))
    assert np.abs(dphi).max() <= 1e-12
    assert np.abs(np.angle(np.exp(1j * (out[2] - ref[2])))).max() <= 1e-12


@pytest.mark.parametrize('curl', [False, True])
def test_deflection_field_matches_reference(curl):
    rng = np.random.RandomState(11)
    cls = _cls()
    plm = _random_alm(cls['pp'], LMAX_UNL, rng)
    olm = _random_alm(cls['pp'] * 0.1, LMAX_UNL, rng) if curl else None
    ref = rlens.deflection_field(plm, LMAX_UNL, rgl(LMAX), olm=olm)
    out = plens.deflection_field(plm, LMAX_UNL, pgl(LMAX), olm=olm, device='cpu')
    for a, r in zip(out, ref):
        assert _err(a.numpy(), r) <= 1e-12


def test_alm2lenmap_matches_reference_with_folded_deflection():
    rng = np.random.RandomState(5)
    cls = _cls()
    geom_r, geom_p = rgl(LMAX), pgl(LMAX)
    assert geom_p.nphi < 2 * LMAX_UNL + 1       # the deflection's m folds into the bins
    rl = rlens.Lensing(geom_r, LMAX_UNL)
    pl = plens.Lensing(geom_p, LMAX_UNL, device='cpu')
    tlm = np.stack([_random_alm(cls['tt'], LMAX_UNL, rng) for _ in range(2)])
    elm = np.stack([_random_alm(cls['ee'], LMAX_UNL, rng) for _ in range(2)])
    blm = np.stack([_random_alm(cls['ee'] * 0.1, LMAX_UNL, rng) for _ in range(2)])
    plm = np.stack([_random_alm(cls['pp'], LMAX_UNL, rng) for _ in range(2)])
    olm = np.stack([_random_alm(cls['pp'] * 0.05, LMAX_UNL, rng) for _ in range(2)])
    assert _err(pl.alm2lenmap(tlm, plm).numpy(), rl.alm2lenmap(tlm, plm)) <= 1e-10
    assert _err(pl.alm2lenmap(tlm, plm, olm=olm).numpy(),
                rl.alm2lenmap(tlm, plm, olm=olm)) <= 1e-10
    for a, r in zip(pl.alm2lenmap_spin((elm, blm), plm, 2, olm=olm),
                    rl.alm2lenmap_spin((elm, blm), plm, 2, olm=olm)):
        assert a.shape == (2, geom_p.nrings, geom_p.nphi) and _err(a.numpy(), r) <= 1e-10


def test_zero_deflection_is_identity():
    rng = np.random.RandomState(1)
    cls = _cls()
    geom = pgl(LMAX)
    pl = plens.Lensing(geom, LMAX, device='cpu')
    sht = SHT(geom, LMAX, device='cpu')
    tlm = _random_alm(cls['tt'], LMAX, rng)
    zero = np.zeros_like(tlm)
    direct = sht.alm2map(torch.as_tensor(tlm)).numpy()
    assert _err(pl.alm2lenmap(tlm, zero)[0].numpy(), direct) < 3e-6
    elm, blm = _random_alm(cls['ee'], LMAX, rng), _random_alm(cls['ee'], LMAX, rng) * 0.3
    q, u = pl.alm2lenmap_spin((elm, blm), zero, 2)
    q0, u0 = sht.alm2map_spin((torch.as_tensor(elm), torch.as_tensor(blm)), 2)
    assert _err(q[0].numpy(), q0.numpy()) < 3e-6 and _err(u[0].numpy(), u0.numpy()) < 3e-6
