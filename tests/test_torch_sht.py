"""Port parity of the spherical harmonic transforms.

* recursion tables: plancklens_tpu_torch.ops.sht.core.recursion_tables equals the
  reference's f64 set exactly, and compat.tables_from_numpy carries it across;
* plain NS-pair engine against the reference's XLA pair engine at f64: <= 1e-12 of
  max|ref|; against the reference's Pallas pair kernels in interpret mode at f32:
  <= 1e-5 of max (the port runs the recursion in f64 for f32 data too, so the difference
  is the reference's own f32 recursion error: up to 6e-6 of max at lmax 24, 8e-6 at 32);
* SHT transforms and round trips against the reference SHT at f64: <= 1e-12 of max, on
  the GL grid and on an asymmetric ring set (two plain transforms per pair call).
Spins 0-3, single transforms (Cm/Qm None), odd and even ring counts, mmax < lmax, batch 1
and 3. The kernel wrappers refuse CPU tensors; the kernels themselves are held against
the plain engine on a CUDA device by the `cuda`-marked test (and by chip_smoke.py).

* the ring split of the analysis kernels, as far as the CPU reaches: K2's cluster planner
  (`legendre_kernels.plan_pair`/`pair_slices`) and K4's segment planner
  (`plan_segments`/`segment_rows`) at the shapes the paths use and over hypothesis sweeps,
  and each split itself as a sum: the plain analysis of each block's ring slice (K2) or
  ring segment (K4) alone, added in rank or segment order, equals the whole call to 1e-12
  of max.
"""
import re
from collections import Counter

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from plancklens_tpu.ops.sht import core as rcore, SHT as RSHT, gl_geometry as rgl
from plancklens_tpu.ops.sht.pallas_kernel import (legendre_synth_pair_pallas,
                                                  legendre_anal_pair_pallas)
from plancklens_tpu_torch import compat
from plancklens_tpu_torch.ops.sht import core as pcore, legendre_kernels as lk
from plancklens_tpu_torch.ops.sht import SHT as PSHT, gl_geometry as pgl, HealpixGeometry
from plancklens_tpu.utils import alm as ralm

torch.set_num_threads(1)


def _c(rng, shape, dtype=np.complex128):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


def _err(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return np.abs(a - ref).max() / np.abs(ref).max()


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


@pytest.mark.parametrize('spin', [0, 1, 2, 3])
def test_recursion_tables_identical(spin):
    theta = rgl(20).theta[:11]
    for n in (-spin, spin):
        ref = rcore.recursion_tables(20, 14, n, theta, dtype=np.float64)
        port = pcore.recursion_tables(20, 14, n, theta)
        assert port['S'] == ref['S'] == 256
        for k, v in ref['np'].items():
            assert port[k].dtype == v.dtype and np.array_equal(port[k], v), k
        dev = compat.tables_from_numpy(ref['np'], 'cpu')
        assert all(torch.equal(dev[k], torch.from_numpy(v)) for k, v in ref['np'].items())


# (lmax, nrings, mmax): odd and even ring counts, mmax < lmax
GRIDS = [(32, 33, 32), (32, 34, 32), (40, 41, 24)]


@pytest.mark.parametrize('lmax,nrings,mmax', GRIDS)
@pytest.mark.parametrize('spin', [0, 1, 2, 3])
def test_plain_pair_engine_matches_xla_f64(lmax, nrings, mmax, spin):
    rng = np.random.RandomState(10 * spin + nrings)
    theta = rgl(nrings - 1).theta
    for B in (1, 3):
        Cp = _c(rng, (B, lmax + 1, mmax + 1))
        Cm = _c(rng, (B, lmax + 1, mmax + 1))
        Q = _c(rng, (B, nrings, mmax + 1))
        Qm = _c(rng, (B, nrings, mmax + 1))
        # pair (spin 0: Cm on the same recursion) and single transforms
        Fp, Fm = rcore.legendre_synth_pair(Cp, Cm, spin, theta)
        Gp, Gm = pcore.legendre_synth_pair(_t(Cp), _t(Cm), spin, theta)
        assert _err(Gp, Fp) <= 1e-12 and _err(Gm, Fm) <= 1e-12
        A, Bc = rcore.legendre_anal_pair(Q, Qm, spin, theta, lmax)
        PA, PB = pcore.legendre_anal_pair(_t(Q), _t(Qm), spin, theta, lmax)
        assert _err(PA, A) <= 1e-12 and _err(PB, Bc) <= 1e-12
        # single transform: the reference's XLA pair engine runs one recursion for a
        # missing second input, right only at spin 0; compare spin != 0 against a zero
        # second input instead
        zC, zQ = np.zeros_like(Cm), np.zeros_like(Qm)
        Fs = rcore.legendre_synth_pair(Cp, None if spin == 0 else zC, spin, theta)[0]
        Gs, Gn = pcore.legendre_synth_pair(_t(Cp), None, spin, theta)
        assert Gn is None and _err(Gs, Fs) <= 1e-12
        As = rcore.legendre_anal_pair(Q, None if spin == 0 else zQ, spin, theta, lmax)[0]
        PAs, PBn = pcore.legendre_anal_pair(_t(Q), None, spin, theta, lmax)
        assert PBn is None and _err(PAs, As) <= 1e-12


@pytest.mark.parametrize('nrings,spins', [(25, (0, 1, 2, 3)), (26, (2,))])
def test_plain_pair_engine_matches_pallas_f32(nrings, spins):
    """f32 against the TPU pair kernels themselves, in interpret mode on the CPU."""
    lmax = 24
    rng = np.random.RandomState(nrings)
    theta = rgl(nrings - 1).theta
    for spin in spins:
        t_m, t_p, _ = rcore._pallas_pair_setup(spin, theta, lmax, lmax, None)
        Cp = _c(rng, (3, lmax + 1, lmax + 1), np.complex64)
        Cm = None if spin == 0 else _c(rng, (3, lmax + 1, lmax + 1), np.complex64)
        Fp, Fm = legendre_synth_pair_pallas(Cp, Cm, spin, theta, t_m, t_p, interpret=True)
        Gp, Gm = pcore.legendre_synth_pair(_t(Cp), _t(Cm), spin, theta)
        assert Gp.dtype == torch.complex64
        assert _err(Gp, Fp) <= 1e-5
        if Cm is not None:
            assert _err(Gm, Fm) <= 1e-5
        Q = _c(rng, (3, nrings, lmax + 1), np.complex64)
        Qm = None if spin == 0 else _c(rng, (3, nrings, lmax + 1), np.complex64)
        A, Bc = legendre_anal_pair_pallas(Q, Qm, spin, theta, lmax, t_m, t_p, interpret=True)
        PA, PB = pcore.legendre_anal_pair(_t(Q), _t(Qm), spin, theta, lmax)
        assert _err(PA, A) <= 1e-5
        if Qm is not None:
            assert _err(PB, Bc) <= 1e-5


def _alms(rng, shape, lmax, lmin=0):
    ls, ms = ralm._lm_indices(lmax)
    a = _c(rng, shape + (len(ls),))
    a[..., ms == 0] = a[..., ms == 0].real
    a[..., ls < lmin] = 0.
    return a


@pytest.mark.parametrize('mmax', [None, 20])
def test_sht_matches_reference_f64(mmax):
    lmax = 32
    rng = np.random.RandomState(3)
    rs, ps = RSHT(rgl(44), lmax, mmax=mmax), PSHT(pgl(44), lmax, mmax=mmax, device='cpu')
    g = _alms(rng, (2, 3), lmax)
    m = np.asarray(rs.alm2map(g))
    mp = ps.alm2map(_t(g))
    assert mp.shape == (2, 3, 45, rs.geom.nphi) and _err(mp, m) <= 1e-12
    assert _err(ps.map2alm(_t(m)), rs.map2alm(m)) <= 1e-12
    for spin in (1, 2, 3):
        g, c = _alms(rng, (3,), lmax, spin), _alms(rng, (3,), lmax, spin)
        q, u = rs.alm2map_spin((g, c), spin)
        pq, pu = ps.alm2map_spin((_t(g), _t(c)), spin)
        assert _err(pq, q) <= 1e-12 and _err(pu, u) <= 1e-12
        G, C = rs.map2alm_spin((q, u), spin)
        PG, PC = ps.map2alm_spin((_t(np.asarray(q)), _t(np.asarray(u))), spin)
        assert _err(PG, G) <= 1e-12 and _err(PC, C) <= 1e-12


@pytest.mark.parametrize('dtype,tol', [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_sht_round_trips(dtype, tol):
    lmax = 40
    rng = np.random.RandomState(4)
    sht = PSHT(pgl(lmax), lmax, dtype=dtype, device='cpu')
    cdt = torch.complex64 if dtype == torch.float32 else torch.complex128
    t = _t(_alms(rng, (3,), lmax)).to(cdt)
    back = sht.map2alm(sht.alm2map(t))
    assert back.dtype == cdt and _err(back, t) <= tol
    for spin in (1, 2, 3):
        g, c = _t(_alms(rng, (3,), lmax, spin)).to(cdt), _t(_alms(rng, (3,), lmax, spin)).to(cdt)
        G, C = sht.map2alm_spin(sht.alm2map_spin((g, c), spin), spin)
        assert _err(G, g) <= tol and _err(C, c) <= tol


def test_kernel_wrappers_refuse_cpu_tensors():
    theta = pgl(16).theta
    t_m, t_p = pcore.pair_tables(16, 16, 2, theta, None, 'cpu')
    C = torch.zeros((1, 17, 17), dtype=torch.complex64)
    with pytest.raises(ValueError, match='CUDA'):
        lk.synth_pair(C, C, 2, 17, t_m, t_p)
    with pytest.raises(ValueError, match='CUDA'):
        lk.anal_pair(torch.zeros((1, 17, 17), dtype=torch.complex64), None, 2, 16, t_m, t_p)


def test_sht_refuses_tensors_on_another_device():
    """Inputs are never moved between devices: a tensor off the transform's device
    raises (a meta tensor stands in for a card tensor here); numpy input is placed."""
    sht = PSHT(pgl(8), 8, device='cpu')
    nalm = ralm.getsize(8)
    off = torch.zeros((1, nalm), dtype=torch.complex128, device='meta')
    with pytest.raises(ValueError, match='transform on cpu'):
        sht.alm2map(off)
    with pytest.raises(ValueError, match='transform on cpu'):
        sht.alm2map_spin((off, off), 2)
    maps = torch.zeros((1,) + sht.alm2map(np.zeros((1, nalm))).shape[-2:], device='meta')
    with pytest.raises(ValueError, match='transform on cpu'):
        sht.map2alm(maps)
    with pytest.raises(ValueError, match='transform on cpu'):
        sht.map2alm_spin((maps, maps), 2)


def test_asymmetric_grid_not_ported():
    """SHT on a ring set that is not north-south symmetric (it raised before the plain
    transforms were ported; the name is kept): the pair calls fall back to two plain
    transforms, and every entry point agrees with the reference's SHT at f64 to <= 1e-12
    of max."""
    from plancklens_tpu.ops.sht.geometry import RingGeometry as RRing
    from plancklens_tpu_torch.ops.sht import RingGeometry as PRing
    lmax, nphi = 16, 40
    rng = np.random.RandomState(7)
    theta = np.sort(rng.uniform(0.05, np.pi - 0.05, 23))
    theta[0], theta[-1] = 8e-4, np.pi - 6e-4
    weight = rng.uniform(0.5, 1.5, 23) * 2. / 23
    rs = RSHT(RRing('asym', theta, weight, nphi), lmax)
    ps = PSHT(PRing('asym', theta, weight, nphi), lmax, device='cpu')
    assert not pcore.is_symmetric(theta)
    g = _alms(rng, (2,), lmax)
    m = np.asarray(rs.alm2map(g))
    assert _err(ps.alm2map(_t(g)), m) <= 1e-12
    assert _err(ps.map2alm(_t(m)), rs.map2alm(m)) <= 1e-12
    for spin in (1, 2):
        g, c = _alms(rng, (2,), lmax, spin), _alms(rng, (2,), lmax, spin)
        q, u = rs.alm2map_spin((g, c), spin)
        pq, pu = ps.alm2map_spin((_t(g), _t(c)), spin)
        assert _err(pq, q) <= 1e-12 and _err(pu, u) <= 1e-12
        G, C = rs.map2alm_spin((q, u), spin)
        PG, PC = ps.map2alm_spin((_t(np.asarray(q)), _t(np.asarray(u))), spin)
        assert _err(PG, G) <= 1e-12 and _err(PC, C) <= 1e-12


# ------------------------------------------------ the ring split of the analysis kernels
SMS = 132                                     # SMs of an H100; the planner takes the count


def _check_plan(plan, rows, L, M, B, bt, rpp, nout, esize, sms, cap):
    """Segments cover every ring pass exactly once, in order, each a whole number of
    passes and none empty; one segment needs no workspace; the partials fit the cap."""
    segs = lk.segment_rows(plan, rows)
    assert len(segs) == plan.nseg >= 1
    assert plan.passes == -(-rows // rpp)
    assert segs[0][0] == 0 and segs[-1][1] == rows
    for (a, b), (a2, _) in zip(segs, segs[1:] + [(rows, None)]):
        assert a < b == a2                                  # in order, adjacent, not empty
        assert a % rpp == 0 and (b % rpp == 0 or b == rows)  # whole passes
        assert -(-(b - a) // rpp) <= plan.passes_per_seg
    assert sum(-(-(b - a) // rpp) for a, b in segs) == plan.passes
    base = -(-M // 32) * -(-B // bt)
    assert plan.blocks == base * plan.nseg
    assert plan.workspace_bytes == (plan.nseg - 1) * nout * B * L * M * esize <= cap
    if plan.passes == 1:
        assert plan.nseg == 1
    if sms is not None:                 # the planner's own count: no more than fill the card
        assert plan.nseg <= max(1, -(-lk.WAVES * sms // base))


def _check_pair_plan(plan, nrings, M, B, mode):
    """K2's cluster: every northern ring in exactly one block's slice, in rank order; every
    (m, batch tile) one cluster; the slices fit a block; the block fits 227 KB of shared
    memory and the register budget."""
    nh = (nrings + 1) // 2
    slices = lk.pair_slices(plan, nrings)
    assert len(slices) == plan.cluster <= lk.PAIR_MAX_CLUSTER
    seen = np.zeros(nh, int)
    for a, b in slices:
        assert 0 <= a < b <= nh and b - a <= plan.rings_per_block
        seen[a:b] += 1
    assert (seen == 1).all()
    assert plan.rings_per_block <= lk.pair_rings(mode, plan.warps, plan.batch_tile)
    assert plan.m_per_block == 1 and plan.lc == lk.PAIR_LC
    assert plan.blocks == plan.cluster * -(-B // plan.batch_tile) * M
    assert plan.batch_tile == (4 if B <= 4 else 8) and plan.warps in lk.PAIR_WARPS
    assert plan.smem_bytes == lk.pair_smem(mode, plan.warps, plan.batch_tile) <= lk.SMEM_BYTES
    # the B operands (<= 32 doubles), the accumulators and the chains' states in 128
    # registers, and 128 registers for every thread of the blocks an SM holds
    assert lk.pair_operand_doubles(mode, plan.batch_tile) <= 32
    assert plan.warps * 32 * lk.PAIR_MAX_REGS * (16 // plan.warps) <= 65536
    if plan.cluster > lk.PAIR_PORTABLE_CLUSTER:
        assert plan.warps == lk.PAIR_WARPS[-1]      # non-portable only at the most warps


# (rows or rings, L, M, B, 'pair'/'plain', dtype, outputs or mode, expected): the shapes
# the paths run. K4 ('plain'): recursion rows and its segment count on a 132-SM card. K2
# ('pair'): the grid's rings, the mode and its plan (cluster, rings a block, warps, batch
# tile)
PATH_SHAPES = [
    (3073, 2049, 2049, 8, 'pair', 'f32', 1, (7, 220, 16, 8)),   # K2, QE grid of lmax 2048
    (3073, 2049, 2049, 8, 'pair', 'f32', 2, (7, 220, 16, 8)),
    (3073, 2049, 2049, 4, 'pair', 'f32', 1, (7, 220, 8, 4)),
    (3073, 2049, 2049, 4, 'pair', 'f32', 2, (7, 220, 8, 4)),
    (8191, 2049, 2049, 4, 'plain', 'f64', 1, 5),   # K4, all rings of nside 2048
    (48, 513, 513, 64, 'plain', 'f64', 1, 1),      # the exact pixel window's node grids
    (48, 513, 513, 1, 'plain', 'f64', 1, 1),
    (257, 257, 257, 3, 'pair', 'f32', 1, (1, 129, 8, 4)),   # the 257-ring checks at lmax 256
    (257, 257, 257, 3, 'pair', 'f64', 0, (1, 129, 8, 4)),
]


@pytest.mark.parametrize('rows,L,M,B,kind,dt,nout,want', PATH_SHAPES)
def test_segment_plan_at_path_shapes(rows, L, M, B, kind, dt, nout, want):
    if kind == 'pair':                 # K2: `rows` are the grid's rings, `nout` the mode
        plan = lk.plan_pair(rows, M, B, nout)
        _check_pair_plan(plan, rows, M, B, nout)
        assert (plan.cluster, plan.rings_per_block, plan.warps, plan.batch_tile) == want
        if rows >= 3073:                  # the QE grid's calls fill the card many times
            assert plan.blocks >= 50 * SMS
        return
    bt, rpp = lk.ANAL_TILE[kind, dt]
    esize = 8 if dt == 'f32' else 16
    plan = lk.plan_segments(rows, L, M, B, bt, rpp, nout, esize, SMS)
    _check_plan(plan, rows, L, M, B, bt, rpp, nout, esize, SMS, lk.WORKSPACE_CAP)
    assert plan.nseg == want
    if rows >= 1537:                      # the table shapes fill the card twice at least
        assert plan.blocks >= 2 * SMS
    # a forced count is clipped to the passes and leaves no segment empty
    for force in (1, 2, 3, 1000):
        forced = lk.plan_segments(rows, L, M, B, bt, rpp, nout, esize, SMS, nseg=force)
        _check_plan(forced, rows, L, M, B, bt, rpp, nout, esize, None, float('inf'))
        assert forced.nseg <= min(force, forced.passes)
        assert forced.nseg == 1 or forced.passes_per_seg == -(-forced.passes // force) \
            or force > forced.passes


@settings(max_examples=300, deadline=None)
@given(rows=st.integers(1, 20000), lmax=st.integers(1, 4096), mfrac=st.floats(0.05, 1.),
       B=st.integers(1, 96), dt=st.sampled_from(['f32', 'f64']), nout=st.integers(1, 2),
       sms=st.integers(1, 264), cap_mib=st.integers(0, 8192))
def test_segment_plan_sweep(rows, lmax, mfrac, B, dt, nout, sms, cap_mib):
    L, M = lmax + 1, max(1, int(mfrac * (lmax + 1)))
    bt, rpp = lk.ANAL_TILE['plain', dt]
    esize = 8 if dt == 'f32' else 16
    cap = cap_mib * 2 ** 20
    plan = lk.plan_segments(rows, L, M, B, bt, rpp, nout, esize, sms, cap=cap)
    _check_plan(plan, rows, L, M, B, bt, rpp, nout, esize, sms, cap)


@settings(max_examples=300, deadline=None)
@given(nrings=st.integers(1, 20000), M=st.integers(1, 4097), B=st.integers(1, 96),
       mode=st.sampled_from([0, 1, 2]))
def test_pair_plan_sweep(nrings, M, B, mode):
    """K2's planner over ring counts, columns, batches and modes: a plan that holds
    `_check_pair_plan`, or, past the most rings 16 blocks of 16 warps hold, a ValueError."""
    nh = (nrings + 1) // 2
    bt = 4 if B <= 4 else 8
    most = lk.PAIR_MAX_CLUSTER * lk.pair_rings(mode, lk.PAIR_WARPS[-1], bt)
    if nh > most:
        with pytest.raises(ValueError, match='northern rings'):
            lk.plan_pair(nrings, M, B, mode)
        return
    _check_pair_plan(lk.plan_pair(nrings, M, B, mode), nrings, M, B, mode)


def _segment_mask(nrings, a, b, pair):
    """1 on the rings of the segment of recursion rows [a, b): those rows and, on a pair
    grid, their mirror rings nrings - 1 - j (the equator row of an odd grid has none)."""
    keep = np.zeros(nrings)
    keep[a:b] = 1.
    if pair:
        n_s = nrings - (nrings + 1) // 2
        js = np.arange(a, min(b, n_s))
        keep[nrings - 1 - js] = 1.
    return torch.from_numpy(keep)[None, :, None]


@pytest.mark.parametrize('nrings', [1537, 1538])
@pytest.mark.parametrize('spin', [0, 1, 2, 3])
def test_ring_segments_add_up_pair(nrings, spin):
    """K2's cluster on the CPU: the plain pair analysis of each block's ring slice (zero
    weights elsewhere, mirror rings included), summed in rank order, is the whole call to
    1e-12 of max in f64; 769 northern rings make a ragged last slice, and 1537 rings an
    equator ring."""
    lmax, B = 24, 2
    rng = np.random.RandomState(100 * spin + nrings)
    theta = pgl(nrings - 1).theta
    t_m, t_p = pcore.pair_tables(lmax, lmax, spin, theta, None, 'cpu')
    Q, Qm = _t(_c(rng, (B, nrings, lmax + 1))), _t(_c(rng, (B, nrings, lmax + 1)))
    for qm in (None, Qm):
        mode = 1 if qm is not None else (0 if spin == 0 else 2)
        plan = lk.plan_pair(nrings, lmax + 1, B, mode)
        assert plan.cluster == (2 if mode == 0 else 4)
        sl = lk.pair_slices(plan, nrings)
        assert sl[-1][1] - sl[-1][0] < plan.rings_per_block        # a ragged last slice
        whole = pcore.legendre_anal_pair_plain(Q, qm, spin, lmax, t_m, t_p)
        total, seen = [0., 0.], torch.zeros(1, nrings, 1, dtype=torch.float64)
        for a, b in sl:
            keep = _segment_mask(nrings, a, b, True)
            seen += keep
            part = pcore.legendre_anal_pair_plain(Q * keep, None if qm is None else qm * keep,
                                                  spin, lmax, t_m, t_p)
            total = [x + (0. if y is None else y) for x, y in zip(total, part)]
        assert torch.equal(seen, torch.ones_like(seen))      # every ring in one slice
        assert all(_err(x, y) <= 1e-12 for x, y in zip(total, whole) if y is not None)


@pytest.mark.parametrize('nrings', [191, 192])
@pytest.mark.parametrize('n', [-2, 0, 3])
def test_ring_segments_add_up_plain(nrings, n):
    """K4's split on the CPU, on sliced table sets: the plain analysis of each segment's
    rings with that segment's rows of the tables, added in order, is the whole call."""
    lmax = 20
    rng = np.random.RandomState(10 * n + nrings)
    theta = np.sort(rng.uniform(1e-3, np.pi - 1e-3, nrings))
    t = pcore.full_tables(lmax, lmax, n, theta, None, 'cpu')
    Q = _t(_c(rng, (3, nrings, lmax + 1)))
    whole = pcore.legendre_anal_plain(Q, lmax, t)
    bt, rpp = lk.ANAL_TILE['plain', 'f64']
    plan = lk.plan_segments(nrings, lmax + 1, lmax + 1, 3, bt, rpp, 1, 16, SMS)
    assert plan.nseg == 3
    total = 0.
    for a, b in lk.segment_rows(plan, nrings):
        ts = dict(t, seed_v=t['seed_v'][a:b], seed_k=t['seed_k'][a:b], x=t['x'][a:b])
        total = total + pcore.legendre_anal_plain(Q[:, a:b], lmax, ts)
    assert _err(total, whole) <= 1e-12


# ------------------------------------------------ the synthesis kernels K1/K3, on the CPU
_PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117synth_pair_kernelIfLi4ELi3ELi8ELi1ELi1EEEvPKN3C2tIT_E4typeES6_PS4_S7_NS_6TablesES8_PKdiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117synth_pair_kernelIfLi4ELi3ELi8ELi1ELi1EEEvPKN3C2tIT_E4typeES6_PS4_S7_NS_6TablesES8_PKdiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 234 registers, used 1 barriers, 520 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116anal_pair_kernelIdLi2ELi8ELi8ELi1ELi3EEEvPKN3C2tIT_E4typeES6_PS4_S7_S7_NS_6TablesES8_PKdiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116anal_pair_kernelIdLi2ELi8ELi8ELi1ELi3EEEvPKN3C2tIT_E4typeES6_PS4_S7_S7_NS_6TablesES8_PKdiiiii
    72 bytes stack frame, 112 bytes spill stores, 104 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 528 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120anal_pair_sum_kernelIfLi1EEEvPN3C2tIT_E4typeES5_PKS3_PKiS9_iiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120anal_pair_sum_kernelIfLi1EEEvPN3C2tIT_E4typeES5_PKS3_PKiS9_iiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 24 registers, used 0 barriers, 400 bytes cmem[0]
"""


def test_ptxas_report_parses_both_templates():
    """The register and spill report of `nvcc -Xptxas -v` (made-up lines in its format):
    kernel, template arguments, registers and spill bytes of each instantiation."""
    rep = lk.ptxas_report(_PTXAS_LOG)
    assert [(k['kernel'], k['args'], k['registers'], k['stack'], k['spill_stores'],
             k['spill_loads']) for k in rep] == [
        ('synth_pair_kernel', ('float', 4, 3, 8, 1, 1), 234, 0, 0, 0),
        ('anal_pair_kernel', ('double', 2, 8, 8, 1, 3), 255, 72, 112, 104),
        ('anal_pair_sum_kernel', ('float', 1), 24, 0, 0, 0)]
    assert lk._template_args('dLin1ELi7EEEv') == ('double', -1, 7)


def _source_defines(prefix):
    with open(lk.SOURCE) as f:
        text = f.read()
    return {ln.split()[1]: tuple(int(x) for x in ln.split(None, 2)[2].split(','))
            for ln in text.splitlines() if ln.startswith('#define ' + prefix)}, text


def test_synth_shapes_mirror_the_source_and_fit():
    """`legendre_kernels.SYNTH_SHAPES` is the source's PLK_S_* block shapes (the library
    checks the same at load, on the card), each fits the register file at its blocks an
    SM, and its two staging buffers fit a block's 227 KB of shared memory in every mode."""
    defs, text = _source_defines('PLK_S_')
    lcs = int(re.search(r'constexpr int LCS = (\d+);', text).group(1))
    for (kind, dt), shapes in lk.SYNTH_SHAPES.items():
        for wide, shape in enumerate(shapes):
            name = 'PLK_S_%s%s%s' % (kind.upper(), dt[1:], '_WIDE' if wide else '')
            assert defs[name] == shape, name
            bt, rpt, nws, minb = shape
            assert nws * 32 * minb <= 65536 // 128       # at least 128 registers a thread
            esize = 8 if dt == 'f32' else 16
            for nin, nt in ((2, 6), (1, 6), (1, 3)) if kind == 'pair' else ((1, 3),):
                assert 2 * lcs * 32 * (nin * bt * esize + nt * 8) <= 232448, (name, nin)


@pytest.mark.parametrize('B', [1, 3, 4, 5, 8])
def test_synth_batch_tile_choice(B):
    """The launcher's choice of block shape by batch, mirrored: f32 pair data (K1 on the
    main path) and plain grids run batch 1-8 as one batch tile, so the f64 recursion runs
    once per (ring, m) at batch 4 and 8; f64 pair data run K1's MMA design, with no
    synth_pair_kernel shape (the source defines none)."""
    assert ('pair', 'f64') not in lk.SYNTH_SHAPES
    assert not [d for d in _source_defines('PLK_S_PAIR64')[0]]
    tiles = {'pair': {'f32': 1}, 'plain': {'f32': 1, 'f64': 1}}
    for (kind, dt), (narrow, wide) in lk.SYNTH_SHAPES.items():
        got = lk.synth_shape(kind, dt, B)
        assert got == (narrow if B <= narrow[0] else wide)
        assert -(-B // got[0]) == tiles[kind][dt], (kind, dt)


# today's block shapes of synth_pair_kernel, which f32 pair data (K1) and the plain mode
# (K3) keep: (narrow, wide) by kind of grid and data type
FMA_SHAPES = {('pair', 'f32'): ((4, 3, 8, 1), (8, 2, 8, 1)),
              ('plain', 'f32'): ((4, 6, 8, 1), (8, 4, 8, 1)),
              ('plain', 'f64'): ((4, 6, 8, 1), (8, 3, 8, 1))}


@pytest.mark.parametrize('B', [1, 2, 4, 5, 8, 9])
@pytest.mark.parametrize('mode', [0, 1, 2, 3])
@pytest.mark.parametrize('dt', ['f32', 'f64'])
def test_synth_plan(dt, mode, B):
    """`legendre_kernels.synth_plan` on the masked cell's grid (2049 rings, lmax 2048): f64
    pair data (modes 0-2) run K1 on the FP64 tensor cores, one recursion for a batch tile of
    4 maps up to batch 4 and of 8 above; the blocks cover every northern ring, none empty,
    and fit a block's 227 KB of shared memory and the SM's registers and shared memory at
    the blocks meant for it. f32 pair data and the plain mode (K3) keep today's
    synth_pair_kernel shapes (their shared memory: `test_synth_shapes_mirror_the_source_and_
    fit`). The warps of a block are the source's SNW."""
    nrings, M = 2049, 2049
    nh = (nrings + 1) // 2
    plan = lk.synth_plan(dt, mode, nrings, M, B)
    assert plan.mma == (dt == 'f64' and mode != 3)
    if not plan.mma:
        kind = 'plain' if mode == 3 else 'pair'
        narrow, wide = FMA_SHAPES[kind, dt]
        assert lk.SYNTH_SHAPES[kind, dt] == (narrow, wide)
        assert plan.shape == lk.synth_shape(kind, dt, B) == (narrow if B <= narrow[0] else wide)
        assert plan.batch_tile == plan.shape[0]
        return
    with open(lk.SOURCE) as f:
        snw = int(re.search(r'constexpr int SNW = (\d+);', f.read()).group(1))
    assert plan.warps == lk.SYNTH_MMA_WARPS == snw
    assert plan.batch_tile == (4 if B <= 4 else 8) and plan.shape is None
    assert plan.rings_per_warp == lk.synth_mma_rings(mode, plan.batch_tile)
    rpb = plan.warps * plan.rings_per_warp
    assert plan.blocks_per_m * rpb >= nh > (plan.blocks_per_m - 1) * rpb
    assert plan.blocks == plan.blocks_per_m * -(-B // plan.batch_tile) * M
    assert plan.smem_bytes == lk.synth_mma_smem(mode, plan.batch_tile) <= lk.SMEM_BYTES
    acc = lk.synth_mma_acc(mode, plan.batch_tile)
    minb = lk.synth_mma_blocks_an_sm(mode, plan.batch_tile)
    regs = min(255, 65536 // (minb * plan.warps * 32))   # what __launch_bounds__ allows
    assert regs >= 2 * acc + 32                          # the accumulators and the chains
    assert minb * (plan.smem_bytes + 1024) <= 233472  # the SM's shared memory holds them


def _pow2_sk(k):
    """2^(256 k) as csrc/legendre_pair.cu's pow2_sk builds it from the exponent bits."""
    if k >= -3:
        return np.array((1023 + 256 * k) << 52, dtype=np.int64).view(np.float64)[()]
    return np.array(1 << 50, dtype=np.int64).view(np.float64)[()] if k == -4 else 0.


@pytest.mark.parametrize('k', [0, -1, -2, -3, -4, -5, -6, -9])
def test_deff_mul_is_ldexp(k):
    """The synthesis's deff_mul (one multiplication by 2^(256 k)) is ldexp(d, 256 k) bit for
    bit, for every |d| <= 2^128 that a state with k < 0 can hold: normal, subnormal (k = -4)
    and zero (k <= -5) results, signs and rounding included; also after the cast to f32."""
    rng = np.random.RandomState(10 - k)
    d = rng.choice([-1., 1.], 40000) * np.exp2(rng.uniform(-140., 128., 40000))
    d = np.concatenate([d, [0., -0., 2. ** 128, -2. ** 128, 1.5 * 2. ** -51, 3. * 2. ** -52,
                            2. ** -51 + 2. ** -103, 2. ** -102]])
    want, got = np.ldexp(d, 256 * k), d * _pow2_sk(k)
    assert np.array_equal(want.view(np.int64), got.view(np.int64))
    with np.errstate(over='ignore'):
        assert np.array_equal(want.astype(np.float32).view(np.int32),
                              got.astype(np.float32).view(np.int32))


@pytest.mark.parametrize('n', [-2, 0, 3])
def test_scaled_state_bound_for_deff_mul(n):
    """The precondition of deff_mul on the twin's recursion: whenever k < 0, |d| <= 2^128,
    at every l, on the HEALPix rings of nside 32 and a ring at theta = 4e-4."""
    lmax = 192
    theta = np.concatenate([[4e-4], HealpixGeometry(32).theta])
    t = pcore.full_tables(lmax, lmax, n, theta, None, 'cpu')
    st = pcore._init_state(t)
    xc = t['x'][:, None]
    thresh = torch.tensor(2. ** 128, dtype=torch.float64)
    down = torch.tensor(2. ** -256, dtype=torch.float64)
    seen_neg = False
    for l in range(lmax + 1):
        neg = st[2] < 0
        seen_neg |= bool(neg.any())
        assert bool((st[1].abs()[neg] <= 2. ** 128).all())
        st = pcore._rec_step(l, st, t['alpha'][l], t['beta'][l], t['gamma'][l], xc, t['l0'],
                             t['seed_v'], t['seed_k'], thresh, down)
    assert seen_neg


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda:0')


@pytest.mark.cuda
@pytest.mark.parametrize('nrings', [65, 66, 513])
def test_kernels_match_plain_on_card(cuda_device, nrings):
    """K1/K2 against the plain engine on the card: f32 <= 1e-5, f64 <= 1e-12 of max; both
    bitwise reproducible. 513 rings are 257 northern rings: K2 splits them over a cluster
    of blocks in modes 1 and 2. K1 also at batch 5 and with mmax < lmax; K2 also at batch 1
    and 9 (a second batch tile), with mmax < lmax and on the tables of an m-block that
    starts at m0 = 10."""
    lmax = 64
    theta = pgl(nrings - 1).theta
    gen = torch.Generator(device=cuda_device).manual_seed(nrings)
    for cdt, tol in ((torch.complex64, 1e-5), (torch.complex128, 1e-12)):
        for spin in (0, 1, 2, 3):
            t_m, t_p = pcore.pair_tables(lmax, lmax, spin, theta, None, cuda_device)
            C = torch.randn((3, lmax + 1, lmax + 1), generator=gen, device=cuda_device,
                            dtype=cdt)
            Q = torch.randn((3, nrings, lmax + 1), generator=gen, device=cuda_device,
                            dtype=cdt)
            # single and pair transforms (spin 0 pair: both inputs on one recursion)
            for cm, qm in ((None, None), (C.flip(0).contiguous(), Q.flip(0).contiguous())):
                ks = lk.synth_pair(C, cm, spin, nrings, t_m, t_p)
                ps = pcore.legendre_synth_pair_plain(C, cm, spin, nrings, t_m, t_p)
                assert all(_err(a.cpu(), b.cpu()) <= tol
                           for a, b in zip(ks, ps) if b is not None)
                ka = lk.anal_pair(Q, qm, spin, lmax, t_m, t_p)
                pa = pcore.legendre_anal_pair_plain(Q, qm, spin, lmax, t_m, t_p)
                assert all(_err(a.cpu(), b.cpu()) <= tol
                           for a, b in zip(ka, pa) if b is not None)
                # deterministic: the ring sums are reduced in a fixed order
                again = lk.anal_pair(Q, qm, spin, lmax, t_m, t_p)
                assert all(torch.equal(a, b) for a, b in zip(again, ka) if b is not None)
                # K1: every output element written by one thread, so bitwise reproducible
                again = lk.synth_pair(C, cm, spin, nrings, t_m, t_p)
                assert all(torch.equal(a, b) for a, b in zip(again, ks) if b is not None)
            # K1's ragged shapes: batch 5 (no multiple of a batch tile; the wide shape in
            # f32), mmax 40 < lmax (M = 41, no multiple of 32); L = 65 is no multiple of
            # the staged chunk
            h_m, h_p = pcore.pair_tables(lmax, 40, spin, theta, None, cuda_device)
            for tm_, tp_, M in ((t_m, t_p, lmax + 1), (h_m, h_p, 41)):
                C5, C5m = (torch.randn((5, lmax + 1, M), generator=gen, device=cuda_device,
                                       dtype=cdt) for _ in range(2))
                for cm in (None, C5m):
                    ks = lk.synth_pair(C5, cm, spin, nrings, tm_, tp_)
                    ps = pcore.legendre_synth_pair_plain(C5, cm, spin, nrings, tm_, tp_)
                    assert all(_err(a.cpu(), b.cpu()) <= tol
                               for a, b in zip(ks, ps) if b is not None)
            # K2's ragged shapes: batch 1 and 9, mmax 40 < lmax, and the columns m0 = 10..64
            # of an m-block (its own tables)
            b_m, b_p = pcore.pair_tables(lmax, lmax, spin, theta, None, cuda_device, 10)
            for tm_, tp_, M, batches in ((t_m, t_p, lmax + 1, (1, 9)), (h_m, h_p, 41, (3,)),
                                         (b_m, b_p, lmax - 9, (4,))):
                for B in batches:
                    Q2, Q2m = (torch.randn((B, nrings, M), generator=gen, device=cuda_device,
                                           dtype=cdt) for _ in range(2))
                    for qm in (None, Q2m):
                        ka = lk.anal_pair(Q2, qm, spin, lmax, tm_, tp_)
                        pa = pcore.legendre_anal_pair_plain(Q2, qm, spin, lmax, tm_, tp_)
                        assert all(_err(a.cpu(), b.cpu()) <= tol
                                   for a, b in zip(ka, pa) if b is not None), (B, M)
                        again = lk.anal_pair(Q2, qm, spin, lmax, tm_, tp_)
                        assert all(torch.equal(a, b) for a, b in zip(again, ka)
                                   if b is not None)


@pytest.mark.cuda
@pytest.mark.parametrize('B', [1, 4, 5, 8])
@pytest.mark.parametrize('nrings', [65, 66, 513])
def test_k1_mma_matches_plain_on_card(cuda_device, nrings, B):
    """K1 on f64 data (the FP64 tensor-core design) against the plain engine on the card,
    modes 0-2 (spins 0-3, one input and two), batch 1, 4, 5 (a ragged batch tile of 8) and
    8, on odd and even ring counts (513: 257 northern rings, a block and a ring more), mmax
    40 < lmax and the columns m0 = 10..64 of an m-block: <= 1e-12 of max and bitwise
    reproducible."""
    lmax = 64
    theta = pgl(nrings - 1).theta
    gen = torch.Generator(device=cuda_device).manual_seed(1000 * B + nrings)
    for spin in (0, 1, 2, 3):
        for mmax, m0 in ((lmax, 0), (40, 0), (lmax, 10)):
            t_m, t_p = pcore.pair_tables(lmax, mmax, spin, theta, None, cuda_device, m0)
            C, C2 = (torch.randn((B, lmax + 1, mmax + 1 - m0), generator=gen, device=cuda_device,
                                 dtype=torch.complex128) for _ in range(2))
            for cm in (None, C2):
                assert lk.synth_pair_plan(C, cm, spin, nrings).mma
                ks = lk.synth_pair(C, cm, spin, nrings, t_m, t_p)
                ps = pcore.legendre_synth_pair_plain(C, cm, spin, nrings, t_m, t_p)
                again = lk.synth_pair(C, cm, spin, nrings, t_m, t_p)
                for a, b, c in zip(ks, ps, again):
                    if b is not None:
                        assert _err(a.cpu(), b.cpu()) <= 1e-12, (spin, mmax, m0, cm is None)
                        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize('nrings,spin,two', [(2049, 0, False), (2049, 2, True), (3073, 1, True),
                                             (2049, 2, False)])
def test_k1_mma_at_masked_shapes_on_card(cuda_device, nrings, spin, two):
    """K1 on f64 data at the masked cell's shapes (lmax 2048, batch 4): the solves' spin 0
    (mode 0) and spin-2 pair (mode 1) on 2049 rings, the QE grid's spin-1 pair on 3073 rings
    and a spin-2 single input (mode 2), against the plain engine (<= 1e-12 of max) and as
    K2's adjoint: <K1 C, Q> = <C, K2 Q> to 1e-13 of |K1 C| |Q|."""
    lmax, B = 2048, 4
    theta = pgl(nrings - 1).theta
    gen = torch.Generator(device=cuda_device).manual_seed(nrings + spin)
    t_m, t_p = pcore.pair_tables(lmax, lmax, spin, theta, None, cuda_device)

    def x(R):
        return torch.randn((B, R, lmax + 1), generator=gen, device=cuda_device,
                           dtype=torch.complex128)
    C, Cm = x(lmax + 1), (x(lmax + 1) if two else None)
    Q, Qm = x(nrings), (x(nrings) if two else None)
    F = [f for f in lk.synth_pair(C, Cm, spin, nrings, t_m, t_p) if f is not None]
    P = [f for f in pcore.legendre_synth_pair_plain(C, Cm, spin, nrings, t_m, t_p)
         if f is not None]
    assert all(_err(a.cpu(), b.cpu()) <= 1e-12 for a, b in zip(F, P))
    A = [a for a in lk.anal_pair(Q, Qm, spin, lmax, t_m, t_p) if a is not None]
    lhs = sum((f * q).sum() for f, q in zip(F, (Q, Qm)))
    rhs = sum((c * a).sum() for c, a in zip((C, Cm), A))
    scale = (sum(f.abs().pow(2).sum() for f in F) * sum(q.abs().pow(2).sum()
                                                        for q in (Q, Qm) if q is not None)).sqrt()
    assert (lhs - rhs).abs().item() <= 1e-13 * scale.item()


@pytest.mark.cuda
def test_k1_records_its_design_on_card(cuda_device):
    """Every f64 pair-mode K1 call records `mma` True in its sht.legendre span, at every
    batch (there is no crossover); f32 K1 calls record False; the kernel count keeps its
    key."""
    lmax = 16
    g = pgl(lmax).theta
    gen = torch.Generator(device=cuda_device).manual_seed(17)

    def x(B, cdt):
        return torch.randn((B, lmax + 1, lmax + 1), generator=gen, device=cuda_device,
                           dtype=cdt)
    want = Counter()
    with pcore.counting() as c:
        for cdt, dt in ((torch.complex128, 'f64'), (torch.complex64, 'f32')):
            for B in (1, 2, 4, 8):
                for spin, two in ((0, False), (2, True), (1, False)):
                    pcore.legendre_synth_pair(x(B, cdt), x(B, cdt) if two else None, spin, g)
                    want['K1', lk.pair_mode(spin, two), B, dt] += 1
        torch.cuda.synchronize()
    recs = [r['attrs'] for r in c.records if r['name'] == 'sht.legendre']
    assert len(recs) == 24 and c.calls == want
    assert all(a['mma'] == a['f64'] for a in recs)


@pytest.mark.cuda
@pytest.mark.parametrize('nrings', [97, 130])
def test_plain_synthesis_ragged_on_card(cuda_device, nrings):
    """K3 on a random polar-heavy ring set (rings within 1e-3 of both poles) against the
    plain engine at batch 3, 4 and 5 (the narrow and wide shapes, one not a multiple of a
    batch tile), mmax = lmax and mmax 40 (M = 41): f32 <= 1e-5, f64 <= 1e-12 of max; and
    bitwise equal on a second run."""
    lmax = 64
    rng = np.random.RandomState(nrings)
    theta = np.sort(np.concatenate([rng.uniform(4e-4, 0.3, nrings // 3),
                                    rng.uniform(0., np.pi, nrings - 2 * (nrings // 3)),
                                    np.pi - rng.uniform(7e-4, 0.3, nrings // 3)]))
    gen = torch.Generator(device=cuda_device).manual_seed(nrings)
    for cdt, tol in ((torch.complex64, 1e-5), (torch.complex128, 1e-12)):
        for n in (-2, 0, 3):
            for mmax in (lmax, 40):
                t = pcore.full_tables(lmax, mmax, n, theta, None, cuda_device)
                for B in (3, 4, 5):
                    C = torch.randn((B, lmax + 1, mmax + 1), generator=gen, device=cuda_device,
                                    dtype=cdt)
                    G = lk.synth(C, nrings, t)
                    assert _err(G.cpu(), pcore.legendre_synth_plain(C, t).cpu()) <= tol
                    assert torch.equal(lk.synth(C, nrings, t), G)


@pytest.mark.cuda
def test_sht_refuses_card_tensors_off_its_device(cuda_device):
    """A card tensor given to a CPU transform raises, and so does a CPU tensor given to a
    card transform: nothing is copied across silently."""
    nalm = ralm.getsize(8)
    with pytest.raises(ValueError, match='transform on cpu'):
        PSHT(pgl(8), 8, device='cpu').alm2map(torch.zeros((1, nalm), dtype=torch.complex128,
                                                           device=cuda_device))
    with pytest.raises(ValueError, match='transform on cuda'):
        PSHT(pgl(8), 8, device=cuda_device).alm2map(torch.zeros((1, nalm),
                                                                dtype=torch.complex128))


@pytest.mark.cuda
def test_entry_points_record_their_kernel_on_card(cuda_device):
    """Each `core.legendre_*` entry call on card tensors records the kernel it ran in its
    sht.legendre span (K1-K4), and `core.counting` counts the calls made, by mode, batch
    and data type."""
    lmax = 16
    g = pgl(lmax).theta
    rng = np.random.RandomState(16)
    th = np.sort(rng.uniform(0.1, 3., 11))
    gen = torch.Generator(device=cuda_device).manual_seed(16)

    def x(B, R, cdt=torch.complex128):
        return torch.randn((B, R, lmax + 1), generator=gen, device=cuda_device, dtype=cdt)
    calls = [(lambda: pcore.legendre_synth_pair(x(2, lmax + 1), x(2, lmax + 1), 2, g),
              ('K1', 1, 2, 'f64')),
             (lambda: pcore.legendre_synth_pair(x(3, lmax + 1, torch.complex64), None, 0, g),
              ('K1', 0, 3, 'f32')),
             (lambda: pcore.legendre_anal_pair(x(1, len(g)), None, 1, g, lmax),
              ('K2', 2, 1, 'f64')),
             (lambda: pcore.legendre_synth(x(4, lmax + 1), -1, th), ('K3', 3, 4, 'f64')),
             (lambda: pcore.legendre_anal(x(2, len(th), torch.complex64), 2, th, lmax),
              ('K4', 3, 2, 'f32'))]
    with pcore.counting() as c:
        for run, _ in calls:
            run()
        # an asymmetric-grid pair call: two plain calls, each on K3
        pcore.legendre_synth_pair(x(1, lmax + 1), x(1, lmax + 1), 2, th)
        torch.cuda.synchronize()
    recs = [r for r in c.records if r['name'] == 'sht.legendre']
    assert [r['attrs'].get('kernel') for r in recs] == ['K1', 'K1', 'K2', 'K3', 'K4', None,
                                                        'K3', 'K3']
    want = Counter(key for _, key in calls)
    want['K3', 3, 1, 'f64'] += 2
    assert c.calls == want


@pytest.mark.cuda
def test_card_calls_the_wrappers_refuse_name_no_kernel(cuda_device):
    """A card call that its kernel's wrapper refuses (a non-contiguous input) leaves its
    sht.legendre record without `kernel`, and counting counts nothing."""
    lmax = 16
    g = pgl(lmax).theta
    C = torch.zeros((2, lmax + 1, lmax + 1), dtype=torch.complex128,
                    device=cuda_device).transpose(1, 2)
    with pcore.counting() as c, pytest.raises(ValueError, match='contiguous'):
        pcore.legendre_synth_pair(C, None, 0, g)
    recs = [r for r in c.records if r['name'] == 'sht.legendre']
    assert len(recs) == 1 and 'kernel' not in recs[0]['attrs'] and c.calls == {}
