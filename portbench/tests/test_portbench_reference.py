"""The plain reference's arithmetic: its transforms against a direct sum over Wigner's
closed-form d at a tiny band limit, exact round trips on its grid, its estimators and
spectra against the program's CPU path (this test may import the program; the reference
may not)."""
from math import factorial

import numpy as np
import pytest
import torch

from portbench.inputs import Grid, nalm, camb_cls, gl_nodes, lm_of_index
from portbench.reference.sht import SHT
from portbench.reference.qe import QE, alm2cl

RNG = np.random.default_rng(11)


def wigner_d(j, mp, m, beta):
    """Wigner's closed-form sum for d^j_{m' m}(beta)."""
    out = np.zeros_like(beta)
    for k in range(max(0, m - mp), min(j + m, j - mp) + 1):
        c = (-1.) ** (k - m + mp) * np.sqrt(float(factorial(j + mp) * factorial(j - mp)
                                                  * factorial(j + m) * factorial(j - m)))
        c /= factorial(j + m - k) * factorial(k) * factorial(j - k - mp) * factorial(k - m + mp)
        out += c * np.cos(beta / 2) ** (2 * j - 2 * k + m - mp) \
            * np.sin(beta / 2) ** (2 * k - m + mp)
    return out


def _alms(b, lmax):
    a = RNG.standard_normal((b, nalm(lmax))) + 1j * RNG.standard_normal((b, nalm(lmax)))
    a[:, :lmax + 1] = a[:, :lmax + 1].real
    return torch.as_tensor(a)


def direct(g, c, s, lmax, grid):
    """sum over l and every m of _sa_lm N_l d^l_{m,-s}(theta) e^{i m phi}."""
    ls, ms = lm_of_index(lmax)
    phi = 2 * np.pi * np.arange(grid.nphi) / grid.nphi
    f = np.zeros((grid.nrings, grid.nphi), complex)
    for i, (l, m) in enumerate(zip(ls, ms)):
        if l < abs(s):
            continue
        if s == 0:
            ap, bm = g[i], (-1.) ** m * np.conj(g[i])
        else:
            ap = -(g[i] + 1j * c[i])
            bm = (-1.) ** (m + s) * np.conj(-(-1.) ** s * (g[i] - 1j * c[i]))
        nl = np.sqrt((2 * l + 1) / (4 * np.pi))
        f += ap * nl * wigner_d(l, m, -s, grid.theta)[:, None] * np.exp(1j * m * phi)[None]
        if m > 0:
            f += bm * nl * wigner_d(l, -m, -s, grid.theta)[:, None] \
                * np.exp(-1j * m * phi)[None]
    return f


@pytest.mark.parametrize('s', [0, 1, 2, 3])
def test_synthesis_against_a_direct_sum(s):
    lmax, grid = 6, Grid(9)
    sht = SHT(grid.theta, grid.weight, grid.nphi, lmax, device='cpu')
    g, c = _alms(1, lmax), _alms(1, lmax)
    f = direct(g[0].numpy(), c[0].numpy(), s, lmax, grid)
    if s == 0:
        got = sht.alm2map(g)[0].numpy()
        assert np.abs(f.imag).max() < 1e-12
        np.testing.assert_allclose(got, f.real, atol=1e-12 * np.abs(f).max())
    else:
        re, im = sht.alm2map_spin(g, c, s)
        np.testing.assert_allclose(re[0].numpy() + 1j * im[0].numpy(), f,
                                   atol=1e-12 * np.abs(f).max())


@pytest.mark.parametrize('s', [0, 1, 2])
def test_round_trip_is_exact(s):
    lmax = 20
    grid = Grid(lmax)
    sht = SHT(grid.theta, grid.weight, grid.nphi, lmax, device='cpu')
    g, c = _alms(3, lmax), _alms(3, lmax)
    if s == 0:
        back = sht.map2alm(sht.alm2map(g))
        assert (back - g).abs().max() < 1e-12 * g.abs().max()
    else:
        ls, _ = lm_of_index(lmax)
        keep = torch.as_tensor(ls >= s)
        g, c = g * keep, c * keep
        g2, c2 = sht.map2alm_spin(*sht.alm2map_spin(g, c, s), s)
        assert max((g2 - g).abs().max(), (c2 - c).abs().max()) < 1e-12 * g.abs().max()


def test_gl_nodes_integrate_exactly():
    x, w = gl_nodes(40)
    for k in range(80):
        want = 2. / (k + 1) if k % 2 == 0 else 0.
        assert abs(np.sum(w * x ** k) - want) < 1e-14


def test_against_the_program_cpu_path():
    from plancklens_tpu_torch.ops.sht import SHT as PSHT, gl_geometry
    from plancklens_tpu_torch.models.qest import eval_qe
    from plancklens_tpu_torch.utils import alm as ualm
    lmax, lq = 20, 30
    geo = gl_geometry(lmax)
    grid = Grid(lmax)
    ps = PSHT(geo, lmax, device='cpu')
    rs = SHT(grid.theta, grid.weight, grid.nphi, lmax, device='cpu')
    g, c = _alms(2, lmax), _alms(2, lmax)
    m1, m2 = ps.alm2map(g), rs.alm2map(g)
    assert (m1 - m2).abs().max() < 1e-12 * m1.abs().max()
    for s in (1, 2, 3):
        r1, i1 = ps.alm2map_spin((g, c), s)
        r2, i2 = rs.alm2map_spin(g, c, s)
        assert max((r1 - r2).abs().max(), (i1 - i2).abs().max()) < 1e-12 * r1.abs().max()
    cls = camb_cls('FFP10_wdipole_lensedCls.dat', lmax)
    qgrid = Grid((2 * lmax + lq) // 2)
    t1, e1, b1, t2, e2, b2 = (_alms(2, lmax) for _ in range(6))
    for key in ('ptt', 'p_p'):
        q = QE(key, cls, lmax, lq, lambda L: SHT(qgrid.theta, qgrid.weight, qgrid.nphi, L,
                                                 device='cpu'), 'cpu')
        d1, d2 = {'t': t1, 'e': e1, 'b': b1}, {'t': t2, 'e': e2, 'b': b2}
        for cross in (False, True):
            gp, cp = eval_qe(key, lmax, cls, lambda f: d1[f], lq, device='cpu',
                             get_alm2=(lambda f: d2[f]) if cross else None)
            gr, cr = q((t1, e1, b1), (t2, e2, b2) if cross else None)
            assert (gp - gr).abs().max() < 1e-11 * gp.abs().max()
            assert (cp - cr).abs().max() < 1e-11 * cp.abs().max()
            cl = ualm.alm2cl(gp, lq, alm2=cp)
            assert (torch.as_tensor(cl) - alm2cl(gp, cp, lq)).abs().max() \
                < 1e-13 * torch.as_tensor(cl).abs().max()


@pytest.mark.parametrize('n', [0, -2])
def test_scaled_recurrence_at_lmax_2048(n):
    """Above lmax ~1900 a first degree below the smallest double grows to its true size
    inside the band: the reference's tables of the band m 900..1100 at lmax 2048 equal
    the program's scaled recursion."""
    from plancklens_tpu_torch.ops.sht import core, gl_geometry
    from portbench.reference.sht import _Rec
    L, m0, mmax = 2048, 900, 1100
    th = gl_geometry(L).theta[:(L + 2) // 2]
    rec = _Rec(L, mmax, n, th, 'cpu', m0=m0)
    T = torch.cat([torch.nn.functional.pad(tab, (0, 0, 0, 0, 0, rec.M - tab.shape[0]))
                   for _, _, tab in rec.blocks()], 1)
    t = core.tables_to_device(core.recursion_tables(L, mmax, n, th, m0), 'cpu')
    for l in (1024, 1536, 2000, 2048):
        C = torch.zeros((1, L + 1, mmax + 1 - m0), dtype=torch.complex128)
        C[0, l, :] = 1
        want = core.legendre_synth_plain(C, t)[0].real
        assert (want - T[:, l, :].T).abs().max() < 1e-12 * want.abs().max()
