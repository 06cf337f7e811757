"""The library yardstick of kernels K1/K2 on the CPU: examples/bench_legendre_torch.py's
`PackedLegendre` (the pair transforms as `torch.bmm` products over lambda tables built by
the f64 recursion, the m columns packed in pairs (m, mmax - m)) against the plain twins
of K1/K2 (`core.legendre_synth_pair_plain`/`legendre_anal_pair_plain`), which the bench
holds it to on the card through the kernels. Spin 0 with one input, spin-1 and spin-2
pairs, an odd and an even ring count and column count, an m-block (even m0), f64 (1e-13
of max) and f32 (1e-5); and the packed box: no slot unused but the middle column's
partner, `precision_alms`' l < m zeros.

The rows whose tables exceed the card are streamed over m-blocks (`stream_blocks`,
`streamed_transform`): over 3 or more blocks the yardstick equals the one-block one (1e-13)
and the K1/K2 twins; its no-mirror mode (K3/K4's yardstick) equals the plain twins within
1e-12 of max on random rings and on HEALPix nside 16, in one block and in three; and the
bench's four streamed rows split into even-start blocks of at most 16 GiB."""
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'examples'))

from bench_legendre_torch import (PackedLegendre, STREAM_CAP, STREAMED_CASES,    # noqa: E402
                                  precision_alms, stream_blocks, streamed_transform)
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


STREAM_CASES = {   # lmax, rings, spin, two inputs
    'spin 0, one input': (20, 31, 0, False),
    'spin-1 pair, even rings': (20, 30, 1, True),
    'spin-2 pair': (21, 29, 2, True),
}


@pytest.mark.parametrize('kind', ['synth', 'anal'])
@pytest.mark.parametrize('name', sorted(STREAM_CASES))
def test_streamed_blocks_equal_one_block_and_the_twins(name, kind):
    """The yardstick streamed over 3 or more m-blocks (a block's tables built, used and
    freed in turn, the outputs assembled over m) equals the one-block yardstick within 1e-13
    of max, and the plain twins of K1/K2."""
    lmax, nr, spin, two = STREAM_CASES[name]
    th = gl_geometry(nr - 1).theta
    gen = torch.Generator().manual_seed(7 + spin)
    shape = (2, lmax + 1, lmax + 1) if kind == 'synth' else (2, nr, lmax + 1)
    x = [torch.randn(shape, generator=gen, dtype=torch.complex128) for _ in range(2)]
    xm = x[1] if two else None
    whole = stream_blocks(lmax, lmax, nr, 8, 2 if two else 1, cap=np.inf)[1][0]
    blocks, box = stream_blocks(lmax, lmax, nr, 8, 2 if two else 1, cap=whole / 2.5)
    assert len(blocks) >= 3 and blocks[0][0] == 0 and blocks[-1][1] == lmax + 1
    assert max(box) <= whole / 2.5
    assert all(a[1] == b[0] and b[0] % 2 == 0 for a, b in zip(blocks[:-1], blocks[1:]))
    got, info = streamed_transform(kind, x[0], xm, spin, th, lmax, torch.float64, blocks)
    assert [b['m'] for b in info] == [list(b) for b in blocks]
    one, _ = streamed_transform(kind, x[0], xm, spin, th, lmax, torch.float64,
                                [(0, lmax + 1)])
    t_m, t_p = core.pair_tables(lmax, lmax, spin, th, None, 'cpu')
    if kind == 'synth':
        ref = core.legendre_synth_pair_plain(x[0], xm, spin, nr, t_m, t_p)
    else:
        ref = core.legendre_anal_pair_plain(x[0], xm, spin, lmax, t_m, t_p)
    for g, o, r in zip(got, one, ref):
        assert (g is None) == (o is None) == (r is None)
        if r is not None:
            assert g.shape == r.shape and _rel(g, o) <= 1e-13 and _rel(g, r) <= 1e-13


def _healpix_theta(nside):
    from plancklens_tpu_torch.ops.sht import HealpixGeometry
    return HealpixGeometry(nside).theta


def _random_theta(n=37):
    th = np.sort(np.random.RandomState(3).uniform(0., np.pi, n))
    th[0], th[-1] = 4e-4, np.pi - 7e-4
    return th


@pytest.mark.parametrize('kind', ['synth', 'anal'])
@pytest.mark.parametrize('n', [-2, 0, 1])
@pytest.mark.parametrize('grid', ['random rings', 'HEALPix nside 16'])
def test_no_mirror_mode_matches_the_plain_twins(grid, n, kind):
    """The yardstick of K3/K4 (`mirror=False`: one table on every ring, no north-south
    pairing, fold or hemisphere sum), in one block and streamed over 3 or more, against
    the twins `core.legendre_synth_plain`/`legendre_anal_plain` within 1e-12 of max (f64)."""
    th = _random_theta() if grid == 'random rings' else _healpix_theta(16)
    lmax, nr = 24, len(th)
    gen = torch.Generator().manual_seed(11 + n)
    shape = (3, lmax + 1, lmax + 1) if kind == 'synth' else (3, nr, lmax + 1)
    x = torch.randn(shape, generator=gen, dtype=torch.complex128)
    t = core.full_tables(lmax, lmax, n, th, None, 'cpu')
    ref = core.legendre_synth_plain(x, t) if kind == 'synth' \
        else core.legendre_anal_plain(x, lmax, t)
    pk = PackedLegendre(t, t, lmax, nr, torch.float64, mirror=False)
    assert pk.single and pk.nh == nr
    got, none = pk.transform(kind, x)
    assert none is None and got.shape == ref.shape and _rel(got, ref) <= 1e-12
    whole = stream_blocks(lmax, lmax, nr, 8, 1, mirror=False, cap=np.inf)[1][0]
    blocks, _ = stream_blocks(lmax, lmax, nr, 8, 1, mirror=False, cap=whole / 2.5)
    assert len(blocks) >= 3
    (got3, _), _ = streamed_transform(kind, x, None, n, th, lmax, torch.float64, blocks,
                                      mirror=False)
    assert _rel(got3, ref) <= 1e-12


@pytest.mark.parametrize('case', range(4))
def test_stream_blocks_of_the_streamed_rows(case):
    """The bench's streamed rows split into contiguous even-start m-blocks of at most 16 GiB
    of tables each, as few as that allows and within 5% of one another, together the
    whole table (82.6, 165.2, 137.5 and 137.6 GB)."""
    name, batches, spin, two, lmax, grid, mirror = STREAMED_CASES[case]
    nrings = {'ecp': 8708, 'gl4096': 4097, 'healpix': 8191}[grid]
    blocks, box = stream_blocks(lmax, lmax, nrings, 8, 2 if two else 1, mirror)
    assert blocks[0][0] == 0 and blocks[-1][1] == lmax + 1
    assert all(a[1] == b[0] and b[0] % 2 == 0 for a, b in zip(blocks[:-1], blocks[1:]))
    assert max(box) <= STREAM_CAP and max(box) <= 1.05 * min(box)
    rows = (nrings + 1) // 2 if mirror else nrings
    whole = sum(lmax + 1 - m for m in range(lmax + 1)) * rows * 8 * (2 if two else 1)
    assert int(np.ceil(whole / STREAM_CAP)) == len(blocks)
    assert abs(whole / 1e9 - (82.6, 165.2, 137.5, 137.6)[case]) < 0.05
    assert whole <= sum(box) <= whole * 1.001
