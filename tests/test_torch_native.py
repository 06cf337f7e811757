"""Port parity: the native C++/OpenMP host kernels of plancklens_tpu_torch.native (its own
copy of plkcore.cc, built with g++ at first use) and the PLK_NATIVE=1 dispatch of
`ops/gauleg.gauleg` and `ops/wigner.wignerpos`/`wignercoeff`: the build in a temporary
directory, GL nodes against scipy, the native Wigner transforms against the port's torch
path and the JAX package within 1e-12 (poles included), the dispatch conditions (1-D real
host numpy operands and the variable set), and a failed build that raises."""
import ctypes
import os
import shutil

import numpy as np
import pytest
import torch

from plancklens_tpu.ops import wigner as rwigner
from plancklens_tpu_torch import native
from plancklens_tpu_torch.native import build as nbuild
from plancklens_tpu_torch.ops import wigner as pwigner
from plancklens_tpu_torch.ops import gauleg as pgauleg

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _compiler():
    if shutil.which(nbuild.compiler()) is None:
        pytest.skip('no C++ compiler to build the native kernels')


def test_build_in_temporary_directory(tmp_path):
    so = nbuild.build(build_dir=str(tmp_path / 'b'))
    assert so.startswith(str(tmp_path)) and so.endswith('.so')
    assert nbuild.build(build_dir=str(tmp_path / 'b')) == so      # built once
    lib = ctypes.CDLL(so)
    lib.plk_version.restype = ctypes.c_int
    assert lib.plk_version() == 1
    assert native.have_native()


def test_serial_build_without_openmp(tmp_path, monkeypatch):
    """A compiler without OpenMP's runtime builds the same source serially: the same
    nodes and transforms."""
    monkeypatch.setattr(nbuild, 'VARIANTS', (('serial', ()),))
    so = nbuild.build(build_dir=str(tmp_path))
    assert os.path.basename(so).startswith('plkcore_serial_')
    lib = ctypes.CDLL(so)
    d = ctypes.POINTER(ctypes.c_double)
    lib.plk_gauleg.argtypes = [ctypes.c_int, d, d]
    x, w = np.empty(33), np.empty(33)
    lib.plk_gauleg(33, x.ctypes.data_as(d), w.ctypes.data_as(d))
    xr, wr = native.gauleg(33)
    assert np.allclose(x, xr, atol=1e-15) and np.allclose(w, wr, atol=1e-15)


@pytest.mark.parametrize('n', [1, 2, 7, 64, 257, 1024])
def test_native_gauleg_matches_scipy(n):
    from scipy.special import roots_legendre
    x, w = native.gauleg(n)
    xr, wr = roots_legendre(n)
    assert np.allclose(x, xr, atol=5e-15) and np.allclose(w, wr, atol=1e-12)
    assert abs(np.sum(w) - 2.0) < 5e-14
    for k in {2, 7, min(2 * n - 1, 31)}:
        if k <= 2 * n - 1:
            exact = 0.0 if k % 2 else 2.0 / (k + 1)
            assert abs(np.sum(w * x ** k) - exact) < 5e-14, (n, k)
    assert np.array_equal(x, -x[::-1]) and np.array_equal(w, w[::-1])


@pytest.mark.parametrize('s1,s2', [(0, 0), (2, 2), (2, -2), (1, -1), (-2, 2), (3, 1)])
def test_native_wigner_matches_torch_and_reference(s1, s2):
    lmax = 40
    cl = np.random.default_rng(3).standard_normal(lmax + 1)
    xg, wg = pgauleg.gauleg(48)
    x = np.concatenate([[-1.0], xg, [1.0]])   # the poles: no NaN from the prefactor
    xi_nat = native.wignerpos(cl, x, s1, s2)
    xi_tor = pwigner.wignerpos(torch.as_tensor(cl), x, s1, s2, device='cpu').numpy()
    xi_ref = np.asarray(rwigner.wignerpos(cl, x, s1, s2))
    assert np.all(np.isfinite(xi_nat))
    scale = np.abs(xi_ref).max()
    assert np.abs(xi_nat - xi_tor).max() <= 1e-12 * scale
    assert np.abs(xi_nat - xi_ref).max() <= 1e-12 * scale
    q = xi_ref[1:-1] * wg
    cl_nat = native.wignercoeff(q, xg, s1, s2, lmax)
    cl_tor = pwigner.wignercoeff(torch.as_tensor(q), xg, s1, s2, lmax, device='cpu').numpy()
    cl_ref = np.asarray(rwigner.wignercoeff(q, xg, s1, s2, lmax))
    scale = np.abs(cl_ref).max()
    assert np.abs(cl_nat - cl_tor).max() <= 1e-12 * scale
    assert np.abs(cl_nat - cl_ref).max() <= 1e-12 * scale


def test_plk_native_dispatch(monkeypatch):
    """PLK_NATIVE=1 routes 1-D real host numpy operands through the native kernels (the
    result placed on the device as a tensor); batched, tensor and complex operands keep the
    d-matrix path; without the variable nothing runs natively."""
    lmax = 16
    cl = np.random.default_rng(0).standard_normal(lmax + 1)
    x, w = pgauleg.gauleg(20)
    ref = pwigner.wignerpos(cl, x, 2, 2, device='cpu')
    ref_c = pwigner.wignercoeff(ref.numpy() * w, x, 2, 2, lmax, device='cpu')
    before = dict(native.calls)
    monkeypatch.setenv('PLK_NATIVE', '1')
    out = pwigner.wignerpos(cl, x, 2, 2, device='cpu')
    assert native.calls['wignerpos'] == before['wignerpos'] + 1
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float64
    assert np.allclose(out.numpy(), ref.numpy(), rtol=1e-10, atol=1e-13)
    clo = pwigner.wignercoeff(out.numpy() * w, x, 2, 2, lmax, device='cpu')
    assert native.calls['wignercoeff'] == before['wignercoeff'] + 1
    assert np.allclose(clo.numpy(), ref_c.numpy(), rtol=1e-10, atol=1e-12)
    n_pos = native.calls['wignerpos']
    outb = pwigner.wignerpos(np.stack([cl, cl]), x, 2, 2, device='cpu')     # batched
    outt = pwigner.wignerpos(torch.as_tensor(cl), x, 2, 2, device='cpu')    # a tensor
    outc = pwigner.wignerpos(cl + 0j, x, 2, 2, device='cpu')                # complex
    assert native.calls['wignerpos'] == n_pos
    for o in (outb[0], outt, outc.real):
        assert np.allclose(o.numpy(), ref.numpy(), rtol=1e-10, atol=1e-12)
    n_gl = native.calls['gauleg']
    xn, wn = pgauleg.gauleg(23)
    assert native.calls['gauleg'] == n_gl + 1
    xs, ws = pgauleg._gauleg_host(23)
    assert np.allclose(xn, xs, atol=5e-15) and np.allclose(wn, ws, atol=1e-12)
    monkeypatch.delenv('PLK_NATIVE')
    pwigner.wignerpos(cl, x, 2, 2, device='cpu')
    pgauleg.gauleg(29)
    assert native.calls['wignerpos'] == n_pos and native.calls['gauleg'] == n_gl + 1


def test_failed_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / 'bad.cc'
    bad.write_text('this is not C++\n')
    with pytest.raises(RuntimeError, match='native build failed'):   # both variants
        nbuild.build(source=str(bad), build_dir=str(tmp_path / 'b'))
    # PLK_NATIVE=1 with a compiler that cannot run: the dispatch raises, it does not fall
    # back to the torch path
    monkeypatch.setenv('CXX', str(tmp_path / 'no-such-compiler'))
    monkeypatch.setattr(nbuild, 'BUILD_DIR', str(tmp_path / 'empty'))
    monkeypatch.setattr(native, '_lib', None)
    assert not native.have_native()
    monkeypatch.setenv('PLK_NATIVE', '1')
    x, _ = pgauleg._gauleg_host(8)
    with pytest.raises(RuntimeError, match='cannot run'):
        pwigner.wignerpos(np.ones(5), x, 0, 0, device='cpu')
    with pytest.raises(RuntimeError, match='cannot run'):
        pgauleg.gauleg(31)


@pytest.mark.parametrize('n', [33, 1051, 2048, 2049, 3073, 4097])
def test_default_gauleg_against_the_jax_package(n, monkeypatch):
    """The default route (no PLK_NATIVE): up to NEWTON_ABOVE = 2048 nodes the JAX
    package's (scipy's) nodes, bitwise; above, the numpy Newton iteration, within 1e-13
    relative of the native kernel and, against the JAX package, nodes within 5e-16 and
    weights within scipy's drift (3e-7 relative; 1.3e-8 at 2049, 1.8e-7 at 3073 and
    8.8e-8 at 4097 measured)."""
    from plancklens_tpu.ops import gauleg as rgauleg
    monkeypatch.delenv('PLK_NATIVE', raising=False)
    x, w = pgauleg.gauleg(n)
    xr, wr = (np.asarray(a) for a in rgauleg.gauleg(n))
    if n <= pgauleg.NEWTON_ABOVE:
        assert np.array_equal(x, xr) and np.array_equal(w, wr)
        return
    xn, wn = native.gauleg(n)
    assert np.abs(x - xn).max() <= 5e-16 and np.abs(w / wn - 1.).max() <= 1e-13
    assert np.abs(x - xr).max() <= 5e-16 and np.abs(w / wr - 1.).max() <= 3e-7
    assert np.array_equal(x, -x[::-1]) and np.array_equal(w, w[::-1])
    assert abs(w.sum() - 2.) <= 1e-13
