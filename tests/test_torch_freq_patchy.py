"""Port parity: the noise-model tools of plancklens_tpu_torch.models against the JAX
package on the same seed-made numpy inputs, f64 on the CPU.

  * `freq_weighting.vmaps2vmap_I`/`vmaps2vmap_P` on gl_geometry(128) within 1e-10 of max
    (three frequencies through one batched map2alm in the port, one at a time in the JAX
    package), `w2wsq` within 1e-12, and the JAX tests' identities
    (tests/test_forecasts.py:82, :199): a uniform map gives sum_i s_i^2 mean(Omega)
    sum_l (2l+1) w_il^2 / (4 pi) everywhere (exact for a monopole, 1e-10 relative),
    halving, and the E/B swap symmetry of P;
  * `patchy.mk_patches` equal but for the fiducial level, where the port departs (the JAX
    package's carries an extra pixel area, ROADMAP fault 3.11: the port's reads 30
    uK-arcmin for a uniform 30 uK-arcmin map); `get_patchy_N0s` (ptt, p_p) at lmax 128
    against the JAX package given the same fiducial level, N0 by ROADMAP fault 3.9's rule
    (1/N0 of its max and N0 per L over 10 <= L <= lmax_ivf, 1e-10) and MC / cMC within
    1e-10; the homogeneous and two-level cases of tests/test_forecasts.py:100, :149 on
    the port.
"""
import os

import numpy as np
import pytest
import torch

import plancklens_tpu
from plancklens_tpu.utils import camb_clfile
from plancklens_tpu.ops.sht import gl_geometry as r_gl
from plancklens_tpu.models import freq_weighting as rfw, patchy as rpatchy
from plancklens_tpu_torch.ops.sht import gl_geometry as p_gl
from plancklens_tpu_torch.models import freq_weighting as pfw, patchy as ppatchy

torch.set_num_threads(1)

CPU = torch.device('cpu')


def _rel(a, ref):
    a, ref = np.asarray(a, dtype=float), np.asarray(ref, dtype=float)
    return np.abs(a - ref).max() / np.abs(ref).max()


def _weights(nf, lmax, seed):
    """l-dependent positive weights summing to 1 at each l (a SMICA-like combination)."""
    rng = np.random.RandomState(seed)
    ls = np.arange(lmax + 1)
    w = np.stack([1. + 0.5 * np.cos(ls / (20. + 10 * i) + rng.uniform(0, np.pi))
                  for i in range(nf)])
    return w / w.sum(0)


def _vmaps(geom, nf, seed):
    rng = np.random.RandomState(seed)
    z = np.cos(geom.theta)[:, None]
    ph = 2. * np.pi * np.arange(geom.nphi)[None, :] / geom.nphi
    return [(1. + i) * (2. + z + 0.3 * z ** 2 + 0.2 * np.sin(ph + rng.uniform(0, 6)) * (1 - z ** 2))
            + 0.05 * rng.uniform(size=(geom.nrings, geom.nphi)) for i in range(nf)]


@pytest.mark.parametrize('s1,s2', [(0, 0), (2, 2), (2, -2)])
def test_w2wsq_matches_reference(s1, s2):
    wl = _weights(1, 48, 1)[0]
    ref = np.asarray(rfw.w2wsq(wl, s1, s2, 90))
    out = pfw.w2wsq(wl, s1, s2, 90, device=CPU)
    assert isinstance(out, torch.Tensor) and out.shape == (91,)
    assert _rel(out.numpy(), ref) <= 1e-12


def test_vmaps2vmap_I_matches_reference():
    rgeom, pgeom = r_gl(128), p_gl(128)
    V, w = _vmaps(rgeom, 3, 2), _weights(3, 64, 3)
    ref = np.asarray(rfw.vmaps2vmap_I(V, w, rgeom))
    out = pfw.vmaps2vmap_I(V, w, pgeom, device=CPU)
    assert out.shape == ref.shape and out.dtype == torch.float64
    assert _rel(out.numpy(), ref) <= 1e-10
    # tensor inputs and an explicit omega give the same map
    omega = np.outer(pgeom.weight, np.full(pgeom.nphi, 2 * np.pi / pgeom.nphi))
    out2 = pfw.vmaps2vmap_I([torch.as_tensor(v) for v in V], w, pgeom,
                            omega_pix=torch.as_tensor(omega), device=CPU)
    assert _rel(out2.numpy(), ref) <= 1e-10


def test_vmaps2vmap_map_on_another_device_raises():
    geom = p_gl(16)
    meta = torch.empty((geom.nrings, geom.nphi), dtype=torch.float64, device='meta')
    with pytest.raises(ValueError, match='variance map on meta'):
        pfw.vmaps2vmap_I([meta], np.ones((1, 9)), geom, device=CPU)


def test_vmaps2vmap_P_matches_reference():
    rgeom, pgeom = r_gl(128), p_gl(128)
    V, we, wb = _vmaps(rgeom, 3, 4), _weights(3, 64, 5), _weights(3, 64, 6)
    ref = np.asarray(rfw.vmaps2vmap_P(V, we, wb, rgeom))
    out = pfw.vmaps2vmap_P(V, we, wb, pgeom, device=CPU)
    assert _rel(out.numpy(), ref) <= 1e-10


def test_freq_weighting_identities():
    """Uniform maps: the monopole identity (exact, 1e-10 relative everywhere); halving;
    P's E/B swap symmetry (tests/test_forecasts.py:82, :199 on the port)."""
    lmax = 64
    geom = p_gl(2 * lmax)
    s2 = [1.5, 0.7, 2.2]
    w = _weights(3, lmax, 7)
    V = [np.full((geom.nrings, geom.nphi), s) for s in s2]
    out = pfw.vmaps2vmap_I(V, w, geom, device=CPU).numpy()
    omega = float(np.mean(np.outer(geom.weight, np.full(geom.nphi, 2 * np.pi / geom.nphi))))
    ls = np.arange(lmax + 1)
    expect = sum(s * omega * np.sum((2 * ls + 1.) * wl ** 2) / (4. * np.pi)
                 for s, wl in zip(s2, w))
    assert np.abs(out / expect - 1.).max() <= 1e-10
    z = np.cos(geom.theta)[:, None]
    Vz = (2. + z) * np.ones((geom.nrings, geom.nphi))
    we, wb = np.ones(lmax + 1), np.linspace(1., 0.5, lmax + 1)
    v1 = pfw.vmaps2vmap_P([Vz], we, wb, geom, device=CPU).numpy()
    v2 = pfw.vmaps2vmap_P([Vz, Vz], np.stack([we * .5] * 2), np.stack([wb * .5] * 2), geom,
                          device=CPU).numpy()
    assert np.abs(v2 - 0.5 * v1).max() <= 1e-10 * np.abs(v1).max()
    v_swap = pfw.vmaps2vmap_P([Vz], wb, we, geom, device=CPU).numpy()
    assert np.abs(v_swap - v1).max() <= 1e-10 * np.abs(v1).max()
    assert np.all(v1 > 0.)


def _ivmap(geom, levels, seed=0):
    """Inverse pixel-variance map of a noise level per hemisphere plus a scan pattern."""
    rng = np.random.RandomState(seed)
    z = np.cos(geom.theta)[:, None]
    omega = np.outer(geom.weight, np.full(geom.nphi, 2 * np.pi / geom.nphi))
    nl = np.where(z > 0, levels[0], levels[1]) * (1. + 0.1 * rng.uniform(size=omega.shape))
    return omega / (nl / 60. / 180. * np.pi) ** 2, omega, nl


@pytest.mark.parametrize('method,data', [('percentiles', False), ('linear', False),
                                         ('percentiles', True)])
def test_mk_patches_equal(method, data):
    geom = r_gl(64)
    ivmap, omega, nl = _ivmap(geom, (20., 40.), seed=1)
    ivmap[:3] = 0.     # masked rings
    rv = nl.ravel() * 1.1 if data else None
    ref = rpatchy.mk_patches(3, ivmap.ravel(), omega.ravel(), rvmap_uKamin_data=rv,
                             method=method, ret_masks=True)
    out = ppatchy.mk_patches(3, torch.as_tensor(ivmap.ravel()), omega.ravel(),
                             rvmap_uKamin_data=rv, method=method, ret_masks=True)
    for i in (0, 1, 3):       # levels of the patches (filter, data), their sky fractions
        assert np.array_equal(np.asarray(out[i]), np.asarray(ref[i]))
    assert all(np.array_equal(a, b) for a, b in zip(out[4], ref[4]))
    # the fiducial level: the port's departure (ROADMAP fault 3.11), in a fixed relation
    sel = ivmap.ravel() > 0
    iv, om = ivmap.ravel()[sel], omega.ravel()[sel]
    assert abs(out[2] / np.sqrt(np.sum(om) / np.sum(iv)) / (60. * 180. / np.pi) - 1.) <= 1e-14
    assert abs(ref[2] / out[2] - np.sqrt(np.sum(iv) / np.sum(om * iv))) <= 1e-12 * ref[2] / out[2]


def test_patchy_fiducial_level():
    """A uniform map's fiducial level is the map's: 30 uK-arcmin (the JAX package's reads
    the level times sqrt(sum Omega / sum Omega^2), 374 uK-arcmin on gl_geometry(32))."""
    geom = p_gl(32)
    omega = np.outer(geom.weight, np.full(geom.nphi, 2 * np.pi / geom.nphi))
    ivmap = omega / (30. / 60. / 180. * np.pi) ** 2
    rv = np.full(ivmap.size, 30.)
    fid = ppatchy.mk_patches(3, ivmap.ravel(), omega.ravel(), rvmap_uKamin_data=rv)[2]
    assert abs(fid / 30. - 1.) <= 1e-13
    ref = rpatchy.mk_patches(3, ivmap.ravel(), omega.ravel(), rvmap_uKamin_data=rv)[2]
    assert abs(ref / 30. - np.sqrt(np.sum(omega) / np.sum(omega ** 2))) <= 1e-10 * ref


def _cls(lmax):
    d = os.path.join(plancklens_tpu.DATAPATH, 'cls')
    return (camb_clfile(os.path.join(d, 'FFP10_wdipole_lensedCls.dat'), lmax=lmax),
            camb_clfile(os.path.join(d, 'FFP10_wdipole_lenspotentialCls.dat'), lmax=lmax))


def _n0_close(a, b, tol, lmax, lmin=10):
    """ROADMAP fault 3.9's rule: 1/N0 within tol of its max, N0 within tol relative at
    every lmin <= L <= lmax."""
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    ok = np.isfinite(b) & (b != 0.)
    assert np.array_equal(np.isfinite(a), np.isfinite(b))
    band = ok.copy()
    band[:lmin] = False
    band[lmax + 1:] = False
    return max(_rel(1. / a[ok], 1. / b[ok]), np.max(np.abs(a[band] / b[band] - 1.))) <= tol


@pytest.mark.parametrize('key', ['ptt', 'p_p'])
def test_patchy_n0s_match_reference(key):
    lmax = 128
    cls_len, cls_unl = _cls(2 * lmax)
    geom = r_gl(32)
    ivmap, omega, _ = _ivmap(geom, (20., 40.), seed=2)
    ivp = ivmap / 2.
    transf = np.ones(lmax + 1)
    args = (key, 3, ivmap.ravel(), ivp.ravel(), omega.ravel(), cls_unl, cls_len, cls_len,
            cls_len, 10, lmax, lmax, transf)
    # the same fiducial level to both (the port's default one departs, see mk_patches)
    fid = ppatchy.mk_patches(3, (ivmap if key == 'ptt' else ivp).ravel(), omega.ravel())[2]
    kw = {'nlevt_fid': fid} if key == 'ptt' else {'nlevp_fid': fid}
    rN0, rMC, rcMC = rpatchy.get_patchy_N0s(*args, **kw)
    pN0, pMC, pcMC = ppatchy.get_patchy_N0s(*args, **kw, device=CPU)
    assert sorted(pN0) == sorted(rN0)
    for k in rN0:
        assert _n0_close(pN0[k], rN0[k], 1e-10, lmax), k
    assert _rel(pMC, rMC) <= 1e-10 and _rel(pcMC, rcMC) <= 1e-10


def test_patchy_homogeneous_limit():
    """Uniform variance map: the four schemes coincide (1e-4) and |MC - 1| < 0.1
    (tests/test_forecasts.py:100 on the port)."""
    lmax = 128
    cls_len, cls_unl = _cls(2 * lmax)
    geom = p_gl(32)
    omega = np.outer(geom.weight, np.full(geom.nphi, 2 * np.pi / geom.nphi))
    nlev = 30.
    ivmap = omega / (nlev / 60. / 180. * np.pi) ** 2
    rv = np.full(ivmap.size, nlev)
    N0s, MC, cMC = ppatchy.get_patchy_N0s(
        'ptt', 3, ivmap.ravel(), ivmap.ravel(), omega.ravel(), cls_unl, cls_len, cls_len,
        cls_len, 10, lmax, lmax, np.ones(lmax + 1), rvmap_uKamin_t_data=rv,
        rvmap_uKamin_p_data=rv, device=CPU)
    vals = {k: np.asarray(v)[20:100] for k, v in N0s.items()}
    ref = list(vals.values())[0]
    for k, v in vals.items():
        assert np.allclose(v, ref, rtol=1e-4), k
    assert np.all(np.abs(np.asarray(MC)[20:100] - 1.) < 0.1)
    assert np.all(np.abs(np.asarray(cMC)[20:100] - 1.) < 0.1)


@pytest.mark.parametrize('levels', [(20., 40.), (1000., 2000.)])
def test_patchy_inhomogeneous_two_level(levels):
    """Two noise levels by hemisphere: every scheme between the homogeneous extremes, MV
    re-weighting never worse (tests/test_forecasts.py:149 on the port), and MC departs
    from 1 where the noise matters at these multipoles. At 20 / 40 uK-arcmin the noise is
    ~1e-4 of C_l^TT at L <= 128, so with the fiducial filter at the map's level (24.9
    uK-arcmin) MC stays within 1e-3 of 1 (the JAX test's departure there comes from its
    fiducial level of 310 uK-arcmin, ROADMAP fault 3.11); at 1000 / 2000 uK-arcmin the
    noise is ~C_l and MC departs."""
    from plancklens_tpu_torch.utils import cli
    lmax, lmin = 128, 10
    cls_len, cls_unl = _cls(2 * lmax)
    geom = p_gl(32)
    z = np.cos(geom.theta)[:, None]
    omega = np.outer(geom.weight, np.full(geom.nphi, 2 * np.pi / geom.nphi))
    nl = np.where(z > 0, *levels) * np.ones_like(omega)
    ivmap = omega / (nl / 60. / 180. * np.pi) ** 2
    transf = np.ones(lmax + 1)
    N0s, MC, cMC = ppatchy.get_patchy_N0s('ptt', 2, ivmap.ravel(), ivmap.ravel(),
                                          omega.ravel(), cls_unl, cls_len, cls_len, cls_len,
                                          lmin, lmax, lmax, transf, device=CPU)
    sel = slice(20, 100)

    def hom_n0(nlev):
        r = ppatchy.get_responses('ptt', cls_len, cls_len, cls_len, lmin, lmax, lmax,
                                  transf, [nlev], [1e30], device=CPU)[0][0]
        n = ppatchy.get_nhls('ptt', 'ptt', cls_len, cls_len, cls_len, lmin, lmax, lmax,
                             transf, [nlev], [nlev], [1e30], [1e30], device=CPU)[0][0]
        return (np.asarray(n) * cli(np.asarray(r)) ** 2)[sel]

    n0_deep, n0_shallow = hom_n0(levels[0]), hom_n0(levels[1])
    assert np.all(n0_deep < n0_shallow)
    for k, v in N0s.items():
        vv = np.asarray(v)[sel]
        assert np.all(vv > 0.95 * n0_deep) and np.all(vv < 1.05 * n0_shallow), k
    for f in ('hom-filt', 'inhom-filt'):
        assert np.all(np.asarray(N0s[f + ', mv-rew'])[sel]
                      <= 1.001 * np.asarray(N0s[f + ', no-rew'])[sel])
    departs = np.abs(np.asarray(MC)[sel] - 1.).max() > 1e-3
    assert departs == (levels[0] > 100.)
    assert np.all(np.isfinite(np.asarray(cMC)[sel]))
