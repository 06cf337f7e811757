"""examples/n0s_forecast_torch.py held to examples/n0s_forecast.py, run unchanged at
`--lmax 300 --iter 1`, f64 on the CPU (the way tests/test_torch_examples.py holds the other
entry points; apart from it because the iterated forecast lenses the whole FFP10 spectra
file, to l 7000, in both packages: ~65 s of the JAX script, ~30 s of the port's).

  * the printed tables within one unit of their last digit;
  * the port's n0s.get_N0 and get_N0_iter are called with the JAX script's arguments
    (each call recorded as it passes), and the returned curves are held to the JAX
    package's results of those calls by ROADMAP fault 3.9's rule as tests/test_torch_n0s.py
    holds them: 1/N0 within tol of its max and N0 within tol at every 10 <= L <= lmax,
    tol 1e-10 for get_N0 (gradient and curl, TT / PP / MV) and 1e-8 for the iterated
    unbiased N0.

The iterated forecast's lensed spectra integrate over more than 2048 Gauss-Legendre nodes,
where the port serves its Newton nodes and the JAX package scipy's, whose edge weights
drift (ROADMAP fault 3.12: the iterated N0 then differ by ~3e-6 relative at low L). The
port runs here on scipy's nodes (`ops.gauleg._gauleg_host` replaced for the test), so the
two scripts integrate with the same rule and the comparison holds the code.
"""
import sys

import numpy as np

from test_torch_examples import assert_same_table, load_example, n0_close, record


def _same_arguments(port_call, jax_call):
    (pa, pk, _), (ja, jk, _) = port_call, jax_call
    pk = {k: v for k, v in pk.items() if k != 'device'}
    assert len(pa) == len(ja) and sorted(pk) == sorted(jk)
    for a, b in list(zip(pa, ja)) + [(pk[k], jk[k]) for k in jk]:
        if isinstance(b, dict):
            assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in b)
        else:
            assert np.array_equal(a, b), (a, b)


def test_n0s_forecast_matches_the_jax_script(capsys, monkeypatch):
    from plancklens_tpu.models import n0s as jn0s
    from plancklens_tpu_torch.models import n0s as pn0s
    lmax = 300
    argv = ['--lmax', str(lmax), '--iter', '1']
    from plancklens_tpu_torch.ops import gauleg as pgauleg
    from scipy.special import roots_legendre
    monkeypatch.setattr(pgauleg, '_gauleg_host', roots_legendre)
    jax_calls = {k: record(monkeypatch, jn0s, k) for k in ('get_N0', 'get_N0_iter')}
    port_calls = {k: record(monkeypatch, pn0s, k) for k in ('get_N0', 'get_N0_iter')}
    jmod = load_example('n0s_forecast')
    monkeypatch.setattr(sys, 'argv', ['n0s_forecast.py'] + argv)
    jmod.main()
    jax_out = capsys.readouterr().out
    got = load_example('n0s_forecast_torch').main(argv + ['--device', 'cpu'])
    port_out = capsys.readouterr().out
    assert_same_table(port_out, jax_out)
    for k in ('get_N0', 'get_N0_iter'):
        assert len(port_calls[k]) == len(jax_calls[k]) == 1, k
        _same_arguments(port_calls[k][0], jax_calls[k][0])
    N0s, N0_curls = jax_calls['get_N0'][0][2]
    assert list(got['N0s']) == list(N0s) == ['ptt', 'p_p', 'p']
    for k in N0s:
        assert n0_close(got['N0s'][k], N0s[k], 1e-10, lmax), k
        assert n0_close(got['N0_curls'][k], N0_curls[k], 1e-10, lmax), k
    unbiased = np.asarray(jax_calls['get_N0_iter'][0][2][1])
    assert got['unbiased'].shape == unbiased.shape == (2, 2 * lmax + 1)
    for a, b in zip(got['unbiased'], unbiased):
        assert n0_close(a, b, 1e-8, lmax)
    assert list(got['Ls']) == [10, 30, 100, 300]
