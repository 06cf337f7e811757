"""The port's twins of the JAX package's user entry points (examples/*_torch.py) held to the
JAX scripts, run unchanged, f64 on the CPU. Each JAX script is loaded from examples/ with
importlib and run with its own arguments (sys.argv monkeypatched) and its stdout captured;
the calls it makes into the JAX package are recorded as they pass (a wrapper set on the
package's module with monkeypatch), so the port's returned curves are held to the very
values the JAX script printed from.

  * lensingrec_quickstart: `main(lmax=64, nsims=2)` of both, from the same numpy draws.
    cross, auto and N0 within 1e-10 of their max over 2 <= L <= lmax. At L = 1 the
    response R_1 is ~1e-6 of its max (a small difference of large Wigner sums), so the
    normalised products carry the two packages' d-matrix rounding amplified (ROADMAP
    fault 3.9; measured 1.4e-10 of max there): R_G and N_G are held within 1e-12 of their
    max over every L, and 1/N0 within 1e-12 of its max. The printed lines agree within one
    unit of their last digit.
  * plot_noiselevels, for each source p, f, a and stt at --lmax 256: the printed table
    within one unit of its last digit, and each returned curve (gradient and curl) against
    N / R^2 of the JAX package's nhl.get_nhl / qresp.get_response from the same calls, by
    fault 3.9's rule as tests/test_torch_n0s.py holds get_N0 (1/N0 within 1e-10 of its
    max, N0 within 1e-10 at every 10 <= L <= lmax).
  * No fallback: each port script raises when a CUDA device is asked for (the default)
    and torch.cuda.is_available() is False.

tests/test_torch_examples_n0s.py holds examples/n0s_forecast_torch.py the same way.
"""
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, 'examples')

torch.set_num_threads(1)


def load_example(name):
    """examples/<name>.py as a fresh module."""
    spec = importlib.util.spec_from_file_location('_example_' + name,
                                                  os.path.join(EXAMPLES, name + '.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def record(monkeypatch, module, name):
    """Wrap module.name so that every call's (args, kwargs, result) is appended to the
    returned list."""
    calls, fn = [], getattr(module, name)

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out
    monkeypatch.setattr(module, name, wrapper)
    return calls


def _unit(token):
    """One unit of the last printed digit of a number token."""
    mant, _, exp = token.lower().partition('e')
    decimals = len(mant.split('.')[1]) if '.' in mant else 0
    return 10. ** ((int(exp) if exp else 0) - decimals)


def assert_same_table(port_out, jax_out):
    """Both scripts printed the same lines; numbers within one unit of the JAX script's
    last printed digit, everything else equal."""
    pl, jl = port_out.strip().splitlines(), jax_out.strip().splitlines()
    assert len(pl) == len(jl), (port_out, jax_out)
    for p, j in zip(pl, jl):
        if p == j:
            continue
        pt, jt = p.replace('=', ' ').split(), j.replace('=', ' ').split()
        assert len(pt) == len(jt), (p, j)
        for a, b in zip(pt, jt):
            try:
                fb = float(b)
            except ValueError:
                assert a == b, (p, j)
                continue
            assert abs(float(a) - fb) <= _unit(b) * (1. + 1e-9), (p, j)


def rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.abs(a - b).max() / np.abs(b).max())


def n0_close(a, b, tol, lmax, lmin=10):
    """ROADMAP fault 3.9's rule as tests/test_torch_n0s.py applies it: 1/N0 within tol of
    its max, and N0 within tol relative at every lmin <= L <= lmax."""
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    assert np.array_equal(np.isfinite(a), np.isfinite(b))
    ok = np.isfinite(b) & (b != 0.)
    if not ok.any():                       # a curl with no response: zero in both
        return bool(np.all(a == 0.))
    band = ok.copy()
    band[:lmin] = False
    band[lmax + 1:] = False
    return max(rel(1. / a[ok], 1. / b[ok]), float(np.max(np.abs(a[band] / b[band] - 1.)))) \
        <= tol


def test_quickstart_matches_the_jax_script(capsys, monkeypatch):
    from plancklens_tpu.models import qresp as jqresp, nhl as jnhl
    jax_resp = record(monkeypatch, jqresp, 'get_response')
    jax_nhl = record(monkeypatch, jnhl, 'get_nhl')
    jx = load_example('lensingrec_quickstart').main(lmax=64, nsims=2)
    jax_out = capsys.readouterr().out
    port = load_example('lensingrec_quickstart_torch')
    r = port.reconstruct(64, 2, device='cpu')
    port.report(r)
    port_out = capsys.readouterr().out
    assert_same_table(port_out, jax_out)
    px = port.main(lmax=64, nsims=2, device='cpu')
    capsys.readouterr()
    for a, b in zip(px, (r['cross'], r['auto'], r['N0'])):
        assert np.array_equal(a, b)
    for name, a, b in zip(('cross', 'auto', 'N0'), px, jx):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape == (65,) and np.all(np.isfinite(a))
        assert np.abs(a - b)[2:].max() <= 1e-10 * np.abs(b[2:]).max(), (name, rel(a, b))
    (_, _, RG), (_, _, NG) = jax_resp[0], jax_nhl[0]
    assert rel(r['RG'], np.asarray(RG[0])) <= 1e-12
    assert rel(r['NG'], np.asarray(NG[0])) <= 1e-12
    ok = np.asarray(jx[2]) != 0.
    assert rel(1. / r['N0'][ok], 1. / np.asarray(jx[2])[ok]) <= 1e-12


@pytest.mark.parametrize('source', ['p', 'f', 'a', 'stt'])
def test_plot_noiselevels_matches_the_jax_script(source, capsys, monkeypatch):
    from plancklens_tpu.models import qresp as jqresp, nhl as jnhl
    from plancklens_tpu.utils import cli
    lmax = 256
    argv = ['--lmax', str(lmax), '--source', source]
    jax_resp = record(monkeypatch, jqresp, 'get_response')
    jax_nhl = record(monkeypatch, jnhl, 'get_nhl')
    jmod = load_example('plot_noiselevels')
    monkeypatch.setattr(sys, 'argv', ['plot_noiselevels.py'] + argv)
    jmod.main()
    jax_out = capsys.readouterr().out
    curves = load_example('plot_noiselevels_torch').main(argv + ['--device', 'cpu'])
    port_out = capsys.readouterr().out
    assert_same_table(port_out, jax_out)
    assert len(curves) == len(jax_resp) == len(jax_nhl) == (4 if source != 'stt' else 1)
    for (lab, grad, curl), (_, _, R), (_, _, N) in zip(curves, jax_resp, jax_nhl):
        R, N = [np.asarray(x) for x in R], [np.asarray(x) for x in N]
        assert n0_close(grad, cli(R[0] ** 2) * N[0], 1e-10, lmax), lab
        if curl is not None:
            assert n0_close(curl, cli(R[1] ** 2) * N[1], 1e-10, lmax), lab


@pytest.mark.parametrize('script', ['lensingrec_quickstart_torch', 'n0s_forecast_torch',
                                    'plot_noiselevels_torch'])
def test_port_script_raises_without_a_card(script, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    mod = load_example(script)
    if script == 'lensingrec_quickstart_torch':
        calls = [lambda: mod.main(lmax=64, nsims=1, device='cuda')]
    else:
        calls = [lambda: mod.main([]), lambda: mod.main(['--device', 'cuda'])]
    for call in calls:
        with pytest.raises(RuntimeError, match='no CUDA device'):
            call()
