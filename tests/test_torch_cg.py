"""Port parity of the conjugate-gradient solvers (plancklens_tpu_torch.ops.cg against
plancklens_tpu.ops.cg) on small dense systems, with no SHT.

The same f64 SPD matrix (real-harmonic basis, so the euclidean rlm product is dot_alm) and
the same right-hand sides go through both packages: pcg, pcg_ir, pcg_fixed, pcg_monitored
and solve take the same iteration count, and their solutions agree to 1e-12 of max. The
f32 cases mirror tests/test_cinv.py:402 and :493 on the port alone: pcg_ir in f32 reaches
1e-5 and agrees with the f64 solution to 1e-3 of max, and an all-zero right-hand-side row
stays finite and zero.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from plancklens_tpu.ops import cg as rcg
from plancklens_tpu.utils import alm as ralm
from plancklens_tpu_torch.ops import cg as pcg
from plancklens_tpu_torch.utils import alm as palm

torch.set_num_threads(1)

LMAX = 16


def _err(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return np.abs(a - ref).max() / np.abs(ref).max()


def _system(cond, seed=11):
    """(M, P, b): SPD (nrlm, nrlm) matrix of condition `cond`, an SPD preconditioner (the
    inverse of M with each eigenvalue off by up to 30%, so PCG needs ~15 iterations and
    stops far from a rounding-sensitive tie), and two complex right-hand sides."""
    nrlm = (LMAX + 1) ** 2
    rng = np.random.RandomState(seed)
    Q = np.linalg.qr(rng.standard_normal((nrlm, nrlm)))[0]
    eig = np.geomspace(1., cond, nrlm)
    M = (Q * eig) @ Q.T
    P = (Q / (eig * (1. + 0.3 * rng.uniform(-1., 1., nrlm)))) @ Q.T
    b = np.asarray(ralm.rlm2alm(rng.standard_normal((2, nrlm)), LMAX))
    return M, P, b


def _ops_ref(M, dtype=np.float64):
    Mj = jnp.asarray(M, dtype=dtype)
    return lambda x: ralm.rlm2alm(ralm.alm2rlm(x, LMAX) @ Mj.T, LMAX)


def _ops_port(M, dtype=torch.float64):
    Mt = torch.as_tensor(M, dtype=dtype)
    return lambda x: palm.rlm2alm(palm.alm2rlm(x, LMAX) @ Mt.T, LMAX)


@pytest.mark.parametrize('solver', ['pcg', 'pcg_roundoff', 'pcg_ir', 'pcg_fixed', 'solve',
                                    'monitored'])
def test_solvers_match_reference(solver):
    """Same iteration count, solutions within 1e-12 of max (f64, condition 1e3, preconditioned to ~1.9)."""
    M, P, b = _system(1e3)
    _, ms = ralm._lm_indices(LMAX)
    rf, rp = _ops_ref(M), _ops_ref(P)
    pf, pp = _ops_port(M), _ops_port(P)
    bj, bt = jnp.asarray(b), torch.as_tensor(b)
    x0j, x0t = jnp.zeros_like(bj), torch.zeros_like(bt)
    if solver in ('pcg', 'pcg_roundoff'):
        ro = 25 if solver == 'pcg' else 4      # 4: several residual replacements
        xr, ir, relr = rcg.pcg(rf, rp, bj, x0j, 500, 1e-9, jnp.asarray(ms), ro)
        xp, ip, relp = pcg.pcg(pf, pp, bt, x0t, 500, 1e-9, ms, ro)
    elif solver == 'pcg_ir':
        xr, ir, relr = rcg.pcg_ir(rf, rp, bj, x0j, 500, 1e-9, jnp.asarray(ms))
        xp, ip, relp = pcg.pcg_ir(pf, pp, bt, x0t, 500, 1e-9, ms)
    elif solver == 'solve':
        xr, ir, relr = rcg.solve(rf, rp, bj, x0j, 500, 1e-9, jnp.asarray(ms))
        xp, ip, relp = pcg.solve(pf, pp, bt, x0t, 500, 1e-9, ms)
    elif solver == 'pcg_fixed':
        xr = rcg.pcg_fixed(rf, rp, bj, x0j, 10, jnp.asarray(ms))
        xp = pcg.pcg_fixed(pf, pp, bt, x0t, 10, ms)
        ir = ip = 10
        relr = relp = np.zeros(2)
    else:
        mr, mp = rcg.monitor_basic(1e-9, iter_max=500), pcg.monitor_basic(1e-9, iter_max=500)
        xr, ir, relr = rcg.pcg_monitored(rf, rp, bj, x0j, jnp.asarray(ms), mr)
        xp, ip, relp = pcg.pcg_monitored(pf, pp, bt, x0t, ms, mp)
        assert len(mp.history) == ip + 1 and np.allclose(mp.history, mr.history, rtol=1e-8)
    assert int(ip) == int(ir) and 0 < int(ip) < 40, (int(ip), int(ir))
    assert xp.dtype == torch.complex128
    assert _err(xp, xr) <= 1e-12, _err(xp, xr)
    if solver != 'pcg_fixed':
        # the final residuals (~1e-10 of |b|) carry rounding of ~1e-14 of |b|
        assert np.all(np.asarray(relp) <= 1e-9) and np.allclose(relp, relr, rtol=1e-3, atol=0)
        # the true residual of the port's solution
        res = np.asarray(palm.alm2rlm(pf(xp) - bt, LMAX))
        assert np.linalg.norm(res) <= 1e-8 * np.linalg.norm(np.asarray(palm.alm2rlm(bt, LMAX)))


def test_dot_alm_matches_reference_and_accumulates_in_f64():
    _, _, b = _system(10.)
    _, ms = ralm._lm_indices(LMAX)
    ref = np.asarray(rcg.dot_alm(jnp.asarray(b), jnp.asarray(b[::-1]), jnp.asarray(ms)))
    got = pcg.dot_alm(torch.as_tensor(b), torch.as_tensor(b[::-1].copy()), ms)
    assert got.dtype == torch.float64 and np.abs(got.numpy() - ref).max() <= 1e-13 * np.abs(ref).max()
    # f32 data: products rounded in f32, sum in f64, result in f32
    b32 = torch.as_tensor(b.astype(np.complex64))
    got32 = pcg.dot_alm(b32, b32, ms)
    w = np.where(ms == 0, 1., 2.)
    prod = (b32 * b32.conj()).real.numpy().astype(np.float64)
    assert got32.dtype == torch.float32
    assert np.array_equal(got32.numpy(), (w * prod).sum(-1).astype(np.float32))


def test_pcg_ir_matches_pcg_f32():
    """pcg_ir in f32 (mirror of tests/test_cinv.py:402): reaches 1e-5 and agrees with the
    f64 pcg solution to 1e-3 of max; solve() routes f32 through it."""
    M, _, b = _system(50.)
    _, ms = palm._lm_indices(LMAX)
    ident = lambda r: r  # noqa: E731
    x64, _, rel64 = pcg.solve(_ops_port(M), ident, torch.as_tensor(b),
                              torch.zeros(b.shape, dtype=torch.complex128), 4000, 1e-9, ms)
    assert float(rel64.max()) < 1e-9
    b32 = torch.as_tensor(b.astype(np.complex64))
    f32 = _ops_port(M, torch.float32)
    x32, it, rel = pcg.pcg_ir(f32, ident, b32, torch.zeros_like(b32), 4000, 1e-5, ms)
    assert x32.dtype == torch.complex64 and float(rel.max()) < 1e-5 and it < 4000
    assert _err(palm.alm2rlm(x32, LMAX).double(), palm.alm2rlm(x64, LMAX)) < 1e-3
    xs, its, rels = pcg.solve(f32, ident, b32, torch.zeros_like(b32), 4000, 1e-5, ms)
    assert its == it and torch.equal(xs, x32)


def test_pcg_zero_rhs_row_stays_finite_f32():
    """An all-zero RHS row converges to zero, not NaN (mirror of tests/test_cinv.py:493):
    the guards use the dtype's tiny."""
    lmax = 12
    ls, ms = palm._lm_indices(lmax)
    diag = torch.as_tensor(1. + ls.astype(np.float32))
    rng = np.random.RandomState(11)
    b = (rng.standard_normal((2, len(ls))) + 1j * rng.standard_normal((2, len(ls)))
         ).astype(np.complex64)
    b[0] = 0.
    bt = torch.as_tensor(b)
    x, it, rel = pcg.pcg(lambda x: x * diag, lambda r: r, bt, torch.zeros_like(bt), 50,
                         np.float32(1e-6), ms)
    assert bool(torch.isfinite(x).all()) and not bool(x[0].abs().any())
    assert (x[1] - bt[1] / diag).abs().max() < 1e-5 * bt[1].abs().max()
    assert bool(torch.isfinite(rel).all())

