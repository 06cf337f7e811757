"""The roofline bounds of the Legendre kernels (plancklens_tpu_torch.ops.sht.roofline), on
the CPU: the mirror identity that lets a spin-0 pair call take one product a term for both
hemispheres (the count its bound rests on), checked on the plain twin, and the bounds'
operation and byte counts against a direct count at a small size."""
import numpy as np
import pytest
import torch

from plancklens_tpu_torch.ops.sht import core, roofline as rf
from plancklens_tpu_torch.ops.sht.geometry import gl_geometry


@pytest.mark.parametrize('nrings', [17, 18])
def test_spin0_south_from_even_and_odd_sums(nrings):
    """Mode 0: the sums over even and odd l + m on a northern ring, E and O, give the ring
    (E + O) and its mirror (E - O), to 1e-13 of max in f64."""
    lmax = 20
    theta = gl_geometry(nrings - 1).theta
    t, _ = core.pair_tables(lmax, lmax, 0, theta, None, 'cpu')
    rng = np.random.RandomState(5)
    C = torch.as_tensor(rng.standard_normal((2, lmax + 1, lmax + 1))
                        + 1j * rng.standard_normal((2, lmax + 1, lmax + 1)))
    l, m = np.meshgrid(np.arange(lmax + 1), np.arange(lmax + 1), indexing='ij')
    even = torch.as_tensor((l + m) % 2 == 0)
    F = core.legendre_synth_pair_plain(C, None, 0, nrings, t, t)[0]
    E = core.legendre_synth_pair_plain(C * even, None, 0, nrings, t, t)[0]
    O = core.legendre_synth_pair_plain(C * ~even, None, 0, nrings, t, t)[0]
    nh = (nrings + 1) // 2
    j = torch.arange(nrings - nh)
    scale = F.abs().max()
    assert ((E[:, :nh] + O[:, :nh] - F[:, :nh]).abs().max() / scale) <= 1e-13
    assert ((E[:, j] - O[:, j] - F[:, nrings - 1 - j]).abs().max() / scale) <= 1e-13


@pytest.mark.parametrize('mode', [0, 1])
@pytest.mark.parametrize('f64', [False, True])
def test_pair_bound_counts(mode, f64):
    """pair_bound against a direct count: per (l >= l0(m), northern ring, m) point, 5 flops
    a recursion (one in mode 0, two in mode 1) and 4 flops a map for each of one (mode 0)
    or four (mode 1) accumulators; bytes: inputs, outputs and tables once."""
    lmax, nrings, B = 24, 25, 3
    theta = gl_geometry(nrings - 1).theta
    spin = 0 if mode == 0 else 2
    t_m, t_p = core.pair_tables(lmax, lmax, spin, theta, None, 'cpu')
    tabs = (t_m,) if mode == 0 else (t_m, t_p)
    l0 = t_m['l0'].numpy()
    points = 0
    for mm in range(lmax + 1):
        for _ in range((nrings + 1) // 2):
            points += sum(1 for ll in range(lmax + 1) if ll >= l0[mm])
    nrec, nacc, nio = (1, 1, 1) if mode == 0 else (2, 4, 2)
    rec, acc = 5. * nrec * points, 4. * nacc * B * points
    t_ops = max(rec / 34e12, acc / 67e12)    # FP64 tensor cores (f64) or FP32 (f32): both 67
    nbytes = nio * B * ((lmax + 1) ** 2 + nrings * (lmax + 1)) * (16 if f64 else 8) \
        + sum(rf.table_bytes(t) for t in tabs)
    want = 1e3 * max(t_ops, nbytes / 3.35e12)
    got, by = rf.pair_bound(tabs, mode, B, nrings, f64)
    assert got == pytest.approx(want, rel=1e-12)
    assert by == ('operations' if t_ops >= nbytes / 3.35e12 else 'bytes')


def test_plain_bound_counts():
    """plain_bound: one recursion and one accumulator a map on every ring."""
    lmax, nrings, B = 16, 11, 2
    theta = np.linspace(0.1, 3.0, nrings)
    t = core.full_tables(lmax, lmax, -2, theta, None, 'cpu')
    points = nrings * int(np.maximum(lmax + 1 - t['l0'].numpy(), 0).sum())
    t_ops = max(5. * points / 34e12, 4. * B * points / 67e12)
    nbytes = B * ((lmax + 1) ** 2 + nrings * (lmax + 1)) * 16 + rf.table_bytes(t)
    assert rf.plain_bound(t, B, nrings, True)[0] == pytest.approx(
        1e3 * max(t_ops, nbytes / 3.35e12), rel=1e-12)
