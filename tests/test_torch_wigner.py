"""Port parity of the Wigner-d transforms (plancklens_tpu_torch/ops/wigner.py) against
plancklens_tpu/ops/wigner.py, mirroring tests/test_wigner.py, f64 on the CPU:

  * the d-matrices (spins up to 3, both xi signs, rows below l0) equal the reference's
    `lax.scan` recursion to 1e-12 of max at lmax 300 (1.6e-13 at worst: the same step, run
    by numpy here and compiled by XLA there), and hold the analytic spin-0/1/2 values;
  * `wignerpos`/`wignercoeff` round trips recover the spectrum, and both equal the
    reference's to 1e-12 of max, batched and complex;
  * `wignerc` and `wignerc_stack` (real and complex, mixed spins and lengths, zero rows)
    equal the reference's to 1e-12 of max;
  * the d-matrix cache serves a second call and reports its size; a tensor on another
    device than the transform's raises.
"""
import numpy as np
import pytest
import torch
from scipy.special import eval_legendre

from plancklens_tpu.ops import wigner as rw
from plancklens_tpu_torch.ops import wigner as pw
from plancklens_tpu_torch.ops import gauleg as gl

torch.set_num_threads(1)

CPU = torch.device('cpu')


def _err(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return np.abs(a - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize('s1,s2', [(0, 0), (1, 0), (0, 1), (1, -1), (2, 2), (2, -2),
                                   (-2, 1), (3, 1), (1, -3), (3, -3), (0, 2)])
def test_dmat_matches_reference(s1, s2):
    lmax = 300
    x, _ = gl.gauleg(257)
    ref = np.asarray(rw.wigner_dmat(lmax, s1, s2, x))
    out = pw.wigner_dmat(lmax, s1, s2, x, device=CPU).numpy()
    assert out.shape == ref.shape and _err(out, ref) <= 1e-12
    assert not np.any(out[:(abs(s1 - s2) + abs(s1 + s2)) // 2])


def test_dmat_analytic_values():
    x, _ = gl.gauleg(40)
    d0 = pw.wigner_dmat(120, 0, 0, x, device=CPU).numpy()
    for l in (0, 1, 2, 7, 64, 120):
        assert np.allclose(d0[l], eval_legendre(l, x), atol=1e-12), l
    c, s = x, np.sqrt(1. - x ** 2)
    assert np.allclose(pw.wigner_dmat(3, 1, 0, x, device=CPU).numpy()[1], -s / np.sqrt(2.),
                       atol=1e-13)
    assert np.allclose(pw.wigner_dmat(4, 2, -2, x, device=CPU).numpy()[2],
                       ((1 - c) / 2) ** 2, atol=1e-13)
    assert np.allclose(pw.wigner_dmat(4, 1, 0, x, device=CPU).numpy()[2],
                       -np.sqrt(3. / 8.) * 2 * s * c, atol=1e-13)


@pytest.mark.parametrize('s1,s2', [(0, 0), (2, 0), (2, 2), (-2, 2), (3, 1), (1, 0), (2, -3)])
def test_pos_coeff_roundtrip_and_reference(s1, s2):
    lmax = 100
    rng = np.random.RandomState(0)
    cl = rng.standard_normal(lmax + 1)
    cl[:max(abs(s1), abs(s2))] = 0.
    npts = gl.nquad_for(2 * lmax)
    x, w = gl.gauleg(npts)
    xi = pw.wignerpos(cl, x, s1, s2, device=CPU).numpy()
    assert _err(xi, rw.wignerpos(cl, x, s1, s2)) <= 1e-12
    clb = pw.wignercoeff(xi * w, x, s1, s2, lmax, device=CPU).numpy()
    assert np.allclose(clb, cl, atol=1e-10)
    assert _err(clb, rw.wignercoeff(xi * w, x, s1, s2, lmax)) <= 1e-12


def test_wignerpos_batched_complex():
    lmax = 40
    x, _ = gl.gauleg(64)
    rng = np.random.RandomState(1)
    cls = rng.standard_normal((5, lmax + 1)) + 1j * rng.standard_normal((5, lmax + 1))
    out = pw.wignerpos(cls, x, 2, -2, device=CPU).numpy()
    assert _err(out, rw.wignerpos(cls, x, 2, -2)) <= 1e-12
    for i in range(5):
        assert np.allclose(out[i], pw.wignerpos(cls[i], x, 2, -2, device=CPU).numpy(),
                           atol=1e-13)


def test_wignerc_real_and_complex():
    lmax = 30
    rng = np.random.RandomState(3)
    cl1 = rng.standard_normal(lmax + 1) + 1j * rng.standard_normal(lmax + 1)
    cl2 = rng.standard_normal(lmax + 11)
    for a in (cl1, cl1.real):
        out = pw.wignerc(a, cl2, 2, 0, -2, 0, lmax_out=lmax, device=CPU)
        ref = rw.wignerc(a, cl2, 2, 0, -2, 0, lmax_out=lmax)
        assert out.dtype == ref.dtype and _err(out, ref) <= 1e-12
    delta0 = np.zeros(lmax + 1)
    delta0[0] = 1.
    assert np.allclose(pw.wignerc(cl1.real, delta0, 0, 0, 0, 0, lmax_out=lmax, device=CPU),
                       cl1.real / (4. * np.pi), atol=1e-12)
    assert not np.any(pw.wignerc(cl2, np.zeros(5), 0, 0, 0, 0, device=CPU))


@pytest.mark.parametrize('cplx', [False, True])
def test_wignerc_stack_matches_reference(cplx):
    rng = np.random.RandomState(4)
    specs = []
    for i, (sp1, sp2) in enumerate([((0, 0), (0, 0)), ((2, 0), (-2, 1)), ((1, -2), (2, 2)),
                                    ((-2, 2), (2, -1)), ((0, 2), (0, -2)), ((2, 0), (-2, 1))]):
        c1 = rng.standard_normal(40 + 3 * i)
        c2 = rng.standard_normal(50 - 2 * i)
        if cplx and i % 2:
            c1 = c1 + 1j * rng.standard_normal(len(c1))
        specs.append((c1, sp1, c2, sp2))
    specs.append((np.zeros(20), (0, 0), rng.standard_normal(20), (0, 0)))   # a zero row
    out = pw.wignerc_stack(specs, 60, device=CPU)
    ref = rw.wignerc_stack(specs, 60)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert _err(out, ref) <= 1e-12 and not np.any(out[-1])
    for i, (c1, (a1, b1), c2, (a2, b2)) in enumerate(specs[:-1]):
        row = pw.wignerc(c1, c2, a1, b1, a2, b2, lmax_out=60, device=CPU)
        assert np.allclose(out[i], row, rtol=0, atol=1e-12 * np.abs(row).max())


def test_dmat_cache_serves_and_reports():
    pw.clear_cache()
    x, _ = gl.gauleg(33)
    a = pw.wigner_dmat(64, 2, -2, x, grid_token=('gl', 33), device=CPU)
    b = pw.wigner_dmat(64, -2, 2, x, grid_token=('gl', 33), device=CPU)   # same (a, b) pair
    now, peak = pw.cache_bytes()
    assert now == peak == 65 * 33 * 8
    assert torch.equal(a, b) or torch.equal(a, -b)
    pw.clear_cache()
    assert pw.cache_bytes()[0] == 0


def test_tensor_on_another_device_raises():
    x, _ = gl.gauleg(8)
    with pytest.raises(ValueError, match='another|input on'):
        pw.wignerpos(torch.zeros(5, device='meta'), x, 0, 0, device=CPU)
    assert pw.wignerpos(torch.ones(5, dtype=torch.float64), x, 0, 0, device=CPU).shape == (8,)
