"""The library yardstick of kernels K1/K2 on the CPU: examples/bench_legendre_torch.py's
`PackedLegendre` (the pair transforms as `torch.bmm` products over lambda tables built by
the f64 recursion, the m columns packed in pairs (m, mmax - m)) against the plain twins
of K1/K2 (`core.legendre_synth_pair_plain`/`legendre_anal_pair_plain`), which the bench
holds it to on the card through the kernels. Spin 0 with one input, spin-1 and spin-2
pairs, an odd and an even ring count and column count, an m-block (even m0), f64 (1e-13
of max) and f32 (1e-5); and the packed box: no slot unused but the middle column's
partner, `precision_alms`' l < m zeros."""
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'examples'))

from bench_legendre_torch import PackedLegendre, precision_alms    # noqa: E402
from plancklens_tpu_torch.ops.sht import core, gl_geometry        # noqa: E402

torch.set_num_threads(1)

CASES = {   # lmax, rings, (m0, m1), spin, two inputs, dtype
    'spin 0, one input, f64': (20, 31, (0, 21), 0, False, torch.float64),
    'spin-1 pair, even rings, f64': (20, 30, (0, 21), 1, True, torch.float64),
    'spin-2 pair, even columns, f32': (19, 29, (0, 20), 2, True, torch.float32),
    'spin-2 pair, m-block 6..14, f64': (20, 31, (6, 15), 2, True, torch.float64),
    'spin 0, m-block 6..15, f64': (20, 31, (6, 16), 0, False, torch.float64),
}


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize('kind', ['synth', 'anal'])
@pytest.mark.parametrize('name', sorted(CASES))
def test_packed_bmm_matches_the_twins(name, kind):
    lmax, nr, (m0, m1), spin, two, rdt = CASES[name]
    cdt = torch.complex64 if rdt == torch.float32 else torch.complex128
    th = gl_geometry(nr - 1).theta
    t_m, t_p = core.pair_tables(lmax, m1 - 1, spin, th, None, 'cpu', m0)
    pk = PackedLegendre(t_m, t_p, lmax, nr, rdt, m0=m0, single=not two)
    gen = torch.Generator().manual_seed(m0 + 10 * spin)
    shape = (3, lmax + 1, m1 - m0) if kind == 'synth' else (3, nr, m1 - m0)
    x = [torch.randn(shape, generator=gen, dtype=cdt) for _ in range(2)]
    xm = x[1] if two else None
    if kind == 'synth':
        got = pk.synth(x[0], xm)
        ref = core.legendre_synth_pair_plain(x[0], xm, spin, nr, t_m, t_p)
    else:
        got = pk.anal(x[0], xm)
        ref = core.legendre_anal_pair_plain(x[0], xm, spin, lmax, t_m, t_p)
    tol = 1e-5 if rdt == torch.float32 else 1e-13
    assert (got[1] is None) == (ref[1] is None)
    for a, b in zip(got, ref):
        if b is not None:
            assert a.dtype == b.dtype and a.shape == b.shape
            assert _rel(a, b) <= tol


@pytest.mark.parametrize('lmax,M', [(20, 21), (20, 20), (31, 12)])
def test_packed_box_has_no_padding_but_the_middle(lmax, M):
    """Every (l >= m, m) of the columns m0..m0 + M - 1 has its own slot, and the slots left
    over are the middle column's missing partner only."""
    m0 = lmax + 1 - M if (lmax + 1 - M) % 2 == 0 else lmax - M
    th = gl_geometry(8).theta
    t_m, t_p = core.pair_tables(lmax, m0 + M - 1, 0, th, None, 'cpu', m0)
    pk = PackedLegendre(t_m, t_p, lmax, len(th), torch.float64, m0=m0, single=True)
    used = int(pk.slot_mask.sum())
    assert used == sum(lmax + 1 - m for m in range(m0, m0 + M))
    assert pk.P * pk.K - used == (0 if M % 2 == 0 else pk.K - (lmax + 1 - m0 - M // 2))


def test_precision_alms_zero_below_the_diagonal():
    c = precision_alms(6, batch=2)
    assert c.shape == (2, 2, 7, 7) and c.dtype == np.complex128
    assert np.all(np.triu(c[0, 0], 1) == 0) and np.all(np.diag(c[1, 1]) != 0)
