#!/usr/bin/env python
r"""Time the Legendre kernels K1-K4 alone on one CUDA device:

    python examples/bench_legendre_torch.py [--reps 3] [--sweep] [--ptxas] [--json bench_legendre.json]

A loop of seconds for kernel work, where chip_smoke.py takes minutes. It builds the library,
holds K1-K4 against their plain torch twins at lmax 256 (f32 <= 1e-5, f64 <= 1e-12 of max;
257 rings for the pair kernels, 201 random rings for the plain ones; K4 once with the
planner's ring segments and once forced to one segment), then times, with
CUDA events, `--reps` launches after one warm-up, without the twins (they take seconds at
these sizes; ten times the launches at the pixel-window shape, which takes ~1 ms):

  K1  spin-1 pair (mode 1), f32, lmax 2048 on the 3073-ring QE grid, batch 8 and batch 4,
      and spin 0 with one input (mode 0) at batch 4: the main path's K1 shapes;
  K3  n = -2, f64, lmax 2048 on all 8191 rings of HEALPix nside 2048, batch 4: the HEALPix
      path's;
  K2  spin-1 pair, f32, lmax 2048 on the 3073-ring QE grid, batch 4 and batch 8;
  K1, K2  the masked filter's CG shapes (models/cinv.py), f64 on the 2049 rings of
      gl_geometry(2048): spin 0 with one input (CinvT) at batch 1, 2, 4 and 8, the spin-2
      pair (CinvP) at batch 1 and 4; and the masked cell's f64 QE shape, the spin-1 pair on
      the 3073-ring QE grid at batch 4; each with its bound (ops/sht/roofline.pair_bound);
  K4  n = -2, f64, lmax 2048 on all 8191 rings of HEALPix nside 2048, batch 4;
  K4  n = 2, f64, lmax 512 on the 48 node rings of the exact pixel window of nside 128
      against its 64 pixel shapes.

Then the library yardstick (`library_rows`, `PackedLegendre`): at each of PERF.md's K1/K2
rows whose lambda table fits in 40 GiB (LIBRARY_CASES: the QE, CinvT, CinvP, deflection
and m-block shapes) the table is built once on the card, and the same transform runs as
`torch.bmm` calls (cuBLAS) over the table, held to the kernel (f64 <= 1e-12, f32 <= 1e-5
of max) and timed beside it. The rows whose tables exceed that (`streamed_rows`,
STREAMED_CASES: K1 at the lensing ECP T and Q/U shapes, K1/K2 at the freq_weighting shape,
K3/K4 on all rings of HEALPix nside 2048, the latter without the north-south mirror) are
streamed over contiguous m-blocks of at most 16 GiB of tables each: a block's tables are
built, its columns transformed and timed, and the tables freed; the times are summed over
the blocks and the assembled output held to the kernel (f64 <= 1e-12 of max). Last,
ROADMAP fault 3.2's record (`precision_rows`): K1's spin-1 pair synthesis in f32 against
f64 at lmax 512, 1024, 2048 and 4096 on the QE grid, on the alms of
examples/f32_precision_jax.py, which measures the JAX package's f32 engine.

Every timed shape is run twice and must be bitwise equal; where K4's planner splits the
rings, the result is also held against the one-segment result (f32 <= 1e-5, f64 <= 1e-12
of max). `--sweep` also times K4's lmax-2048 shape with the ring sum forced into 1, 2, 4,
8 and 16 segments. `--ptxas` prints the registers and spills of every instantiation of the
synthesis and analysis kernels (`legendre_kernels.ptxas_report`). One line per shape, each
with the card's name and power limit (and the block shape of a synthesis, K2's cluster
plan); the library rows give each kernel's time over the bmm calls' in the same call.
The last line of standard output is one JSON object with the same numbers.
Raises without a card.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

import torch


LMAX = 2048
NSIDE = 2048


def rel_max(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def event_ms(fn, reps):
    """(mean ms, min ms, last result) of `reps` launches, each between two CUDA events."""
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return sum(times) / len(times), min(times), out


class PackedLegendre:
    """The fused north-south Legendre pair transforms of one geometry as cuBLAS batched
    products, the library yardstick of K1/K2 (nothing on the main path calls it).

    For a fixed geometry a synthesis is, per m, the product of the table
    lambda_lm(theta_j) = d^l_{m,-s}(theta_j) of the northern rings with the alms, and an
    analysis its transpose. The tables are built once on the device from the port's own
    f64 recursion (`core._rec_step`, the twins' step), each value rounded once to the
    data's type as K1/K2 round theirs. The columns m of the triangle l >= m pair up as
    (m, mmax - m), whose l ranges have lengths summing to the same K, so the tables fill
    a (P, K, nh) box with P = ceil(M / 2) and no padding but the middle column's partner.
    A synthesis is one `torch.bmm` a table over the pairs (each pair's data zero outside
    its own column's rows, so the two columns' outputs land in separate halves), an
    analysis one `torch.bmm` the other way (the cross terms of a pair are dropped); the
    mirror signs (-1)^l, (-1)^m and the sums of the two hemispheres run as torch
    elementwise operations, as in the twins (`core._plain_pair`). `t_m`/`t_p` are the
    device tables of `core.pair_tables` for the columns m0..m0 + M - 1 (t_p is t_m for
    spin 0); `single` is spin 0 with one input, which builds one table.

    `mirror=False` is the yardstick of the plain kernels K3/K4: one table of d^l_{m,n} on
    every ring (t_m = t_p, the tables of `core.full_tables`), no north-south pairing, no
    (-1)^l fold and no hemisphere sum; `synth`/`anal` then take one input."""

    def __init__(self, t_m, t_p, lmax, nrings, dtype, m0=0, single=False, mirror=True):
        from plancklens_tpu_torch.ops.sht import core
        dev = t_m['seed_v'].device
        L, M = lmax + 1, int(t_m['l0'].shape[0])
        P = (M + 1) // 2
        K = 2 * L - 2 * m0 - M + 1
        self.L, self.M, self.P, self.K, self.m0 = L, M, P, K, m0
        self.mirror, self.single = mirror, single or not mirror
        self.nrings, self.nh, self.dtype = nrings, (nrings + 1) // 2 if mirror else nrings, dtype
        j = torch.arange(M, device=dev)
        first = j < P
        self.pair = torch.where(first, j, M - 1 - j)             # the pair of column j
        self.half = (~first).long()                               # its half of the pair
        self.off = torch.where(first, 0, L - m0 - self.pair)      # its first slot
        # slot (p, k): degree l of column j of half h (k beyond a middle column: not valid)
        pp, kk = torch.arange(P, device=dev)[:, None], torch.arange(K, device=dev)[None, :]
        len1 = L - m0 - pp
        in1 = kk < len1
        j2 = M - 1 - pp
        self.slot_j = torch.where(in1, pp, j2).expand(P, K)
        self.slot_l = torch.where(in1, m0 + pp + kk, m0 + j2 + kk - len1).clamp(max=lmax)
        valid = in1 | (j2 > pp)
        self.slot_mask = torch.stack([in1 & valid, ~in1 & valid], -1).to(dtype)[..., None]
        ls = torch.arange(L, device=dev)[:, None]
        self.lm_mask = (ls >= m0 + j[None, :]).to(dtype)[..., None]
        self.lm_slot = (self.off[None, :] + ls - m0 - j[None, :]).clamp(0, K - 1)
        self.sgn_l = (1. - 2. * (ls % 2)).to(dtype)               # (-1)^l, (L, 1)
        self.sgn_m = core._sgn_m(M, dtype, dev)
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        self.T_m = self._table(t_m)
        self.T_p = self.T_m if self.single else self._table(t_p)
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        self.build_seconds = time.perf_counter() - t0
        self.table_bytes = (1 if self.single else 2) * self.T_m.numel() * self.T_m.element_size()

    def _table(self, t):
        from plancklens_tpu_torch.ops.sht import core
        S, dev = t['S'], t['seed_v'].device
        rdt = t['seed_v'].dtype
        xc = t['x'][:, None]
        thresh = torch.tensor(2.0 ** (S // 2), dtype=rdt, device=dev)
        down = torch.tensor(2.0 ** (-S), dtype=rdt, device=dev)
        T = torch.zeros((self.P, self.K, self.nh), dtype=self.dtype, device=dev)
        st = core._init_state(t)
        js = torch.arange(self.M, device=dev)
        for l in range(self.L):
            n = min(l - self.m0 + 1, self.M)                     # columns with m <= l
            if n > 0:
                d = core._deff(st, S, self.dtype)
                T[self.pair[:n], self.off[:n] + l - self.m0 - js[:n]] = d[:, :n].T
            st = core._rec_step(l, st, t['alpha'][l], t['beta'][l], t['gamma'][l], xc,
                                t['l0'], t['seed_v'], t['seed_k'], thresh, down)
        return T

    @staticmethod
    def _columns(xs):
        """(.., L or nh, M, Nc) real columns of the complex (B, *, M) tensors `xs`."""
        x = torch.view_as_real(torch.stack(xs))                  # (n, B, R, M, 2)
        return x.permute(2, 3, 0, 1, 4).reshape(x.shape[2], x.shape[3], -1)

    @staticmethod
    def _complex(y, n):
        """(n, B, R, M) complex of (R, M, Nc) real columns."""
        R, M = y.shape[:2]
        y = y.reshape(R, M, n, -1, 2).permute(2, 3, 0, 1, 4).contiguous()
        return torch.view_as_complex(y)

    def pack_synth(self, xs):
        """(P, K, 2 Nc) operand of a synthesis of the inputs `xs`."""
        g = self._columns(xs)[self.slot_l, self.slot_j]          # (P, K, Nc)
        return (g[:, :, None] * self.slot_mask).reshape(self.P, self.K, -1)

    def unpack_synth(self, Y, n):
        Y = Y.view(self.P, self.nh, 2, -1)[self.pair, :, self.half]   # (M, nh, Nc)
        return self._complex(Y.transpose(0, 1), n)

    def pack_anal(self, xs):
        """(P, nh, 2 Nc) operand of an analysis of the (B, nh, M) inputs `xs`."""
        d = self._columns(xs).transpose(0, 1)                    # (M, nh, Nc)
        jp = torch.stack([self.pair[:self.P], self.M - 1 - self.pair[:self.P]], 1)
        return d[jp].permute(0, 2, 1, 3).reshape(self.P, self.nh, -1)

    def unpack_anal(self, Y, n):
        Y = Y.view(self.P, self.K, 2, -1)[self.pair, self.lm_slot, self.half] * self.lm_mask
        return self._complex(Y, n)

    def synth_products(self, Cp, Cm):
        """[(table, operand)] of a synthesis, one `torch.bmm(table^T, operand)` each: the
        northern sums of Cp (and the signed southern ones of Cm) on d_{m,-s}, the signed
        southern ones of Cp and the northern ones of Cm on d_{m,+s}."""
        if not self.mirror:
            return [(self.T_m, self.pack_synth([Cp]))]
        sCp = self.sgn_l * Cp
        if self.single:
            return [(self.T_m, self.pack_synth([Cp, sCp]))]
        return [(self.T_m, self.pack_synth([Cp, self.sgn_l * Cm])),
                (self.T_p, self.pack_synth([sCp, Cm]))]

    def synth(self, Cp, Cm):
        """(Fp, Fm) as kernel K1 (`legendre_kernels.synth_pair`) computes them; Fm None
        when Cm is None."""
        if not self.mirror:
            (T, X), = self.synth_products(Cp, Cm)
            return self.unpack_synth(torch.bmm(T.transpose(1, 2), X), 1)[0], None
        ys = [self.unpack_synth(torch.bmm(T.transpose(1, 2), X), 2)
              for T, X in self.synth_products(Cp, Cm)]
        if self.single:
            return self._assemble(*ys[0]), None
        (acc0, acc3), (acc1, acc2) = ys
        return self._assemble(acc0, acc1), self._assemble(acc2, acc3)

    def _assemble(self, north, south):
        n_s = self.nrings - self.nh
        return torch.cat([north, (south * self.sgn_m)[:, :n_s].flip(1)], 1)

    def _fold(self, Q):
        n_s = self.nrings - self.nh
        Qs = torch.zeros_like(Q[:, :self.nh])
        Qs[:, :n_s] = Q[:, self.nh:].flip(1) * self.sgn_m
        return Q[:, :self.nh], Qs

    def anal_products(self, Qp, Qm):
        """[(table, operand)] of an analysis, one `torch.bmm(table, operand)` each."""
        if not self.mirror:
            return [(self.T_m, self.pack_anal([Qp]))]
        Qp_n, Qp_s = self._fold(Qp)
        if self.single:
            return [(self.T_m, self.pack_anal([Qp_n, Qp_s]))]
        Qm_n, Qm_s = self._fold(Qm)
        return [(self.T_m, self.pack_anal([Qp_n, Qm_s])),
                (self.T_p, self.pack_anal([Qp_s, Qm_n]))]

    def anal(self, Qp, Qm):
        """(A, B) as kernel K2 (`legendre_kernels.anal_pair`) computes them; B None when
        Qm is None."""
        if not self.mirror:
            (T, X), = self.anal_products(Qp, Qm)
            return self.unpack_anal(torch.bmm(T, X), 1)[0], None
        ys = [self.unpack_anal(torch.bmm(T, X), 2) for T, X in self.anal_products(Qp, Qm)]
        if self.single:
            a, b = ys[0]
            return a + self.sgn_l * b, None
        (a0, a3), (a1, a2) = ys
        return a0 + self.sgn_l * a1, a2 + self.sgn_l * a3

    def transform(self, kind, x, xm=None):
        """`synth` or `anal` (`kind`) of x (and a pair's second input xm)."""
        return self.synth(x, xm) if kind == 'synth' else self.anal(x, xm)

    def products(self, kind, x, xm=None):
        """[(A, X)]: the transform's matrix products, one `torch.bmm(A, X)` each."""
        if kind == 'synth':
            return [(T.transpose(1, 2), X) for T, X in self.synth_products(x, xm)]
        return self.anal_products(x, xm)


def precision_alms(lmax, batch=1):
    """The two legs' (batch, lmax + 1, lmax + 1) complex128 alms of numpy seed `lmax`, l < m
    zeroed: the recipe of examples/f32_precision_jax.py, so both packages' precision rows
    transform the same alms."""
    rng = np.random.RandomState(lmax)
    L = lmax + 1
    c = rng.standard_normal((2, batch, L, L)) + 1j * rng.standard_normal((2, batch, L, L))
    return c * np.tril(np.ones((L, L)))[None, None]


# (name, spin, two inputs, data type, lmax, grid band limit, batches, kernels, m block)
LIBRARY_CASES = (
    ('QE', 1, True, 'f32', 2048, 3072, (8, 4), ('synth', 'anal'), None),
    ('CinvT', 0, False, 'f64', 2048, 2048, (8, 4), ('synth', 'anal'), None),
    ('CinvP', 2, True, 'f64', 2048, 2048, (4, 1), ('synth', 'anal'), None),
    ('deflection', 1, True, 'f64', 2176, 2048, (1,), ('synth',), None),
    ('m-block 0, spin 0', 0, False, 'f64', 2048, 2048, (4,), ('synth', 'anal'), 0),
    ('m-block 1, spin 0', 0, False, 'f64', 2048, 2048, (4,), ('synth', 'anal'), 1),
    ('m-block 0, spin-2 pair', 2, True, 'f64', 2048, 2048, (4,), ('synth', 'anal'), 0),
    ('m-block 1, spin-2 pair', 2, True, 'f64', 2048, 2048, (4,), ('synth', 'anal'), 1),
)


# PERF.md's kernel rows whose lambda tables exceed 40 GiB, streamed over m-blocks of at
# most STREAM_CAP bytes of tables: (row, {kind: batch}, spin (n of a plain transform),
# two inputs, lmax, grid, north-south mirror). All f64.
STREAMED_CASES = (
    ('lensing, ECP T (spin 0, one input)', {'synth': 1}, 0, False, 2176, 'ecp', True),
    ('lensing, ECP Q/U (spin-2 pair)', {'synth': 1}, 2, True, 2176, 'ecp', True),
    ('freq_weighting (spin 0, one input, gl_geometry(4096))', {'synth': 1, 'anal': 4}, 0,
     False, 4094, 'gl4096', True),
    ('HEALPix nside 2048 (n = -2, all rings)', {'synth': 4, 'anal': 4}, -2, False, 2048,
     'healpix', False),
)
STREAM_CAP = 16 * 2 ** 30


def stream_blocks(lmax, mmax, nrings, itemsize, ntables, mirror=True, cap=STREAM_CAP):
    """(blocks, bytes): contiguous m-blocks [(m0, m1)] covering m = 0..mmax, each starting
    at an even m (the pair transforms' rule, `core._check_m0`), of about equal table bytes:
    the fewest whose packed boxes (`PackedLegendre`: ceil(M/2) pairs x (2 L - 2 m0 - M + 1)
    slots x rings) each hold at most `cap` bytes, and those boxes' bytes."""
    L = lmax + 1
    ring_bytes = ((nrings + 1) // 2 if mirror else nrings) * itemsize * ntables

    def box(m0, m1):
        M = m1 - m0
        return (M + 1) // 2 * (2 * L - 2 * m0 - M + 1) * ring_bytes

    cum = np.cumsum([L - m for m in range(mmax + 1)], dtype=float)
    n = max(1, int(np.ceil(box(0, mmax + 1) / cap)))
    while True:
        edges = [0]
        for k in range(1, n):
            e = int(np.searchsorted(cum, k * cum[-1] / n)) + 1
            e += e % 2
            if edges[-1] < e <= mmax:
                edges.append(e)
        edges.append(mmax + 1)
        blocks = list(zip(edges[:-1], edges[1:]))
        if max(box(*b) for b in blocks) <= cap:
            return blocks, [box(*b) for b in blocks]
        n += 1


def streamed_transform(kind, x, xm, spin, theta, lmax, dtype, blocks, mirror=True,
                       timer=None):
    """The yardstick transform `kind` ('synth' or 'anal') of x (and a pair's second input
    xm, else None), one m-block's tables at a time: for each block of `blocks` its tables
    (`core.pair_tables`, or `core.full_tables` without the mirror, spin then being n) are
    built, the block's columns transformed, and the tables freed. Returns the outputs
    assembled over m (the second None without xm) and one dict a block: its columns, the
    tables' GB and build seconds, and with `timer` (fn -> ms) the packed transform's and
    the `torch.bmm` calls' ms."""
    from plancklens_tpu_torch.ops.sht import core
    dev, nrings = x.device, len(theta)
    outs, info = [], []
    for m0, m1 in blocks:
        if mirror:
            t_m, t_p = core.pair_tables(lmax, m1 - 1, spin, theta, None, dev, m0)
        else:
            t_m = t_p = core.full_tables(lmax, m1 - 1, spin, theta, None, dev, m0)
        pk = PackedLegendre(t_m, t_p, lmax, nrings, dtype, m0=m0, single=xm is None,
                            mirror=mirror)
        xb = x[..., m0:m1].contiguous()
        xmb = None if xm is None else xm[..., m0:m1].contiguous()
        row = dict(m=[m0, m1], table_gb=pk.table_bytes / 1e9, build_s=pk.build_seconds)
        if timer is not None:
            products = pk.products(kind, xb, xmb)
            row['packed_ms'] = timer(lambda: pk.transform(kind, xb, xmb))
            row['bmm_ms'] = timer(lambda: [torch.bmm(A, X) for A, X in products])
            del products
        outs.append(pk.transform(kind, xb, xmb))
        info.append(row)
        del pk, t_m, t_p, xb, xmb
        if dev.type == 'cuda':
            torch.cuda.empty_cache()
    first = torch.cat([o[0] for o in outs], -1)
    return (first, None if xm is None else torch.cat([o[1] for o in outs], -1)), info


def streamed_rows(dev, gen, smi, reps):
    """The cuBLAS yardstick of PERF.md's kernel rows whose tables exceed 40 GiB
    (STREAMED_CASES), streamed over m-blocks of at most 16 GiB of tables
    (`stream_blocks`, `streamed_transform`): at each kernel and batch, the kernel's ms at
    the row's whole shape, the packed transform's and the `torch.bmm` calls' ms summed
    over the blocks (one warm-up and `reps` calls a block, CUDA events), the blocks, the
    largest block's GB, the summed build seconds (outside the times, as in
    `library_rows`), and the assembled output's largest difference from the kernel's,
    relative to max (<= 1e-12)."""
    from plancklens_tpu_torch.ops.sht import core, legendre_kernels as lk, HealpixGeometry
    from plancklens_tpu_torch.ops.sht.geometry import gl_geometry
    from plancklens_tpu_torch.ops.lensing import _ecp_geom

    def timer(fn):
        fn()
        return event_ms(fn, reps)[0]

    grids = {'ecp': lambda: _ecp_geom(2176, 4.0).theta,
             'gl4096': lambda: gl_geometry(4096).theta,
             'healpix': lambda: HealpixGeometry(NSIDE).theta}
    rows = []
    for name, batches, spin, two, lmax, grid, mirror in STREAMED_CASES:
        theta = grids[grid]()
        R = len(theta)
        if mirror:
            t_m, t_p = core.pair_tables(lmax, lmax, spin, theta, None, dev)
        else:
            t_m = t_p = core.full_tables(lmax, lmax, spin, theta, None, dev)
        blocks, box = stream_blocks(lmax, lmax, R, 8, 2 if two else 1, mirror)
        for kind, B in batches.items():
            shape = (B, lmax + 1, lmax + 1) if kind == 'synth' else (B, R, lmax + 1)
            x = [torch.randn(shape, generator=gen, device=dev, dtype=torch.complex128)
                 for _ in range(2 if two else 1)]
            xm = x[1] if two else None
            if mirror and kind == 'synth':
                kernel = lambda: lk.synth_pair(x[0], xm, spin, R, t_m, t_p)
            elif mirror:
                kernel = lambda: lk.anal_pair(x[0], xm, spin, lmax, t_m, t_p)
            elif kind == 'synth':
                kernel = lambda: (lk.synth(x[0], R, t_m), None)
            else:
                kernel = lambda: (lk.anal(x[0], lmax, t_m), None)
            k_ms = timer(kernel)
            k_out = kernel()
            out, info = streamed_transform(kind, x[0], xm, spin, theta, lmax, torch.float64,
                                           blocks, mirror, timer)
            err = max(rel_max(a, b) for a, b in zip(out, k_out) if b is not None)
            if not err <= 1e-12:
                raise RuntimeError('%s %s batch %d: the streamed bmm vs the kernel %.2e > 1e-12'
                                   % (name, kind, B, err))
            kname = {('synth', True): 'K1', ('anal', True): 'K2', ('synth', False): 'K3',
                     ('anal', False): 'K4'}[kind, mirror]
            row = dict(case=name, kernel=kname, spin=spin, two=two, dtype='f64', lmax=lmax,
                       rings=R, batch=B, kernel_ms=k_ms,
                       packed_ms=sum(b['packed_ms'] for b in info),
                       bmm_ms=sum(b['bmm_ms'] for b in info), rel_err=err,
                       kernel_over_bmm=k_ms / sum(b['bmm_ms'] for b in info),
                       blocks=len(info), largest_block_gb=max(box) / 1e9,
                       table_gb=sum(b['table_gb'] for b in info),
                       build_s=sum(b['build_s'] for b in info), per_block=info, card=smi)
            rows.append(row)
            print('  %s %s batch %d, streamed over %d m-blocks (largest %.2f GB, %.1f GB in '
                  'all, built in %.2f s): kernel %.3f ms, torch.bmm %.3f ms (the kernel takes '
                  '%.2fx), the packed transform %.3f ms; %.2e of max from the kernel | %s'
                  % (kname, name, B, row['blocks'], row['largest_block_gb'], row['table_gb'],
                     row['build_s'], k_ms, row['bmm_ms'], row['kernel_over_bmm'],
                     row['packed_ms'], err, smi), flush=True)
            del x, xm, k_out, out
            torch.cuda.empty_cache()
        del t_m, t_p
        torch.cuda.empty_cache()
    return rows


def library_rows(dev, gen, smi, reps):
    """The cuBLAS yardstick of each PERF.md K1/K2 row whose table fits in 40 GiB
    (LIBRARY_CASES; `PackedLegendre`): the table's GB and build seconds, then at each batch
    the kernel's ms, the packed transform's ms (operand packing, the `torch.bmm` calls and
    the elementwise combination) and the `torch.bmm` calls' ms alone, its largest
    difference from the kernel relative to max (f64 <= 1e-12, f32 <= 1e-5), all CUDA
    events over `reps` calls after one warm-up."""
    from plancklens_tpu_torch.ops.sht import core, legendre_kernels as lk
    from plancklens_tpu_torch.ops.sht.geometry import gl_geometry
    from plancklens_tpu_torch.parallel.mesh import m_blocks
    rows = []
    for name, spin, two, dt, lmax, grid, batches, kinds, block in LIBRARY_CASES:
        geom = gl_geometry(grid)
        R = geom.nrings
        m0, m1 = (0, lmax + 1) if block is None else m_blocks(lmax, lmax, 2)[block]
        rdt, cdt, tol = ((torch.float32, torch.complex64, 1e-5) if dt == 'f32'
                         else (torch.float64, torch.complex128, 1e-12))
        t_m, t_p = core.pair_tables(lmax, m1 - 1, spin, geom.theta, None, dev, m0)
        pk = PackedLegendre(t_m, t_p, lmax, R, rdt, m0=m0, single=not two)
        print('%s: tables of %d pairs x %d slots x %d rings, %.2f GB (%d table%s), built on '
              'the card in %.2f s | %s' % (name, pk.P, pk.K, pk.nh, pk.table_bytes / 1e9,
                                           1 if pk.single else 2, '' if pk.single else 's',
                                           pk.build_seconds, smi), flush=True)
        for B in batches:
            for kind in kinds:
                shape = (B, lmax + 1, m1 - m0) if kind == 'synth' else (B, R, m1 - m0)
                x = [torch.randn(shape, generator=gen, device=dev, dtype=cdt)
                     for _ in range(2 if two else 1)]
                xm = x[1] if two else None
                if kind == 'synth':
                    kernel = lambda: lk.synth_pair(x[0], xm, spin, R, t_m, t_p)
                else:
                    kernel = lambda: lk.anal_pair(x[0], xm, spin, lmax, t_m, t_p)
                packed = lambda: pk.transform(kind, x[0], xm)
                products = pk.products(kind, x[0], xm)
                gemm = lambda: [torch.bmm(T, X) for T, X in products]
                for fn in (kernel, packed, gemm):        # warm-up: cuBLAS handles, caches
                    fn()
                k_ms, _, k_out = event_ms(kernel, reps)
                p_ms, _, p_out = event_ms(packed, reps)
                g_ms, _, _ = event_ms(gemm, reps)
                err = max(rel_max(a, b) for a, b in zip(p_out, k_out) if b is not None)
                if not err <= tol:
                    raise RuntimeError('%s %s batch %d: the packed bmm vs the kernel %.2e > %.0e'
                                       % (name, kind, B, err, tol))
                row = dict(case=name, kernel='K1' if kind == 'synth' else 'K2', spin=spin,
                           two=two, dtype=dt, lmax=lmax, rings=R, m=[m0, m1], batch=B,
                           kernel_ms=k_ms, packed_ms=p_ms, bmm_ms=g_ms,
                           kernel_over_bmm=k_ms / g_ms, rel_err=err,
                           table_gb=pk.table_bytes / 1e9, build_s=pk.build_seconds, card=smi)
                rows.append(row)
                print('  %s %s batch %d: kernel %.3f ms, torch.bmm %.3f ms (%d call%s; the '
                      'kernel takes %.2fx), the packed transform %.3f ms; %.2e of max from the '
                      'kernel | %s' % (row['kernel'], name, B, k_ms, g_ms, len(products),
                                       '' if len(products) == 1 else 's', k_ms / g_ms, p_ms,
                                       err, smi), flush=True)
                del x, xm, products, k_out, p_out
        del pk, t_m, t_p
        torch.cuda.empty_cache()
    return rows


def precision_rows(dev, smi, lmaxs=(512, 1024, 2048, 4096)):
    """ROADMAP fault 3.2's record for the port: K1's spin-1 pair synthesis on the QE grid
    gl_geometry(3 lmax / 2) of `precision_alms(lmax)` in f32 against f64 (the recursion
    runs in f64 for both; f32 accumulates in f32): relative rms of the difference over
    both legs and max of max."""
    from plancklens_tpu_torch.ops.sht import core, legendre_kernels as lk
    from plancklens_tpu_torch.ops.sht.geometry import gl_geometry
    rows = []
    for lmax in lmaxs:
        geom = gl_geometry(3 * lmax // 2)
        R = geom.nrings
        t_m, t_p = core.pair_tables(lmax, lmax, 1, geom.theta, None, dev)
        cp, cm = (torch.as_tensor(c, device=dev) for c in precision_alms(lmax))
        f64 = torch.stack(lk.synth_pair(cp, cm, 1, R, t_m, t_p))
        f32 = torch.stack(lk.synth_pair(cp.to(torch.complex64), cm.to(torch.complex64), 1, R,
                                        t_m, t_p)).to(torch.complex128)
        d = f32 - f64
        row = dict(lmax=lmax, rings=R, rel_rms=float(d.abs().pow(2).mean().sqrt()
                                                     / f64.abs().pow(2).mean().sqrt()),
                   max_of_max=rel_max(f32, f64), card=smi)
        rows.append(row)
        print('f32 vs f64, K1 spin-1 pair synthesis, lmax %d, %d rings, batch 1: relative rms '
              '%.3e, max of max %.3e | %s' % (lmax, R, row['rel_rms'], row['max_of_max'], smi),
              flush=True)
        del t_m, t_p, cp, cm, f64, f32, d
        torch.cuda.empty_cache()
    return rows


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--reps', type=int, default=3)
    p.add_argument('--sweep', action='store_true',
                   help="also time K4's lmax-2048 shape at forced segment counts")
    p.add_argument('--ptxas', action='store_true',
                   help="print the compiler's register and spill report of the synthesis and "
                        "analysis kernels")
    p.add_argument('--json', default=None, help='also write the result object to this file')
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('bench_legendre_torch: needs a CUDA device')

    from plancklens_tpu_torch.ops.sht import core, legendre_kernels as lk, HealpixGeometry
    from plancklens_tpu_torch.ops.sht.geometry import gl_geometry
    from plancklens_tpu_torch.ops.sht.pixwin import _ring_Gm
    from plancklens_tpu_torch.ops.sht.roofline import pair_bound
    dev = torch.device('cuda:0')
    smi = subprocess.run(['nvidia-smi', '-i', '0', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    lk.build()
    lk._load()
    print('built in %.1f s | %s' % (time.perf_counter() - t0, smi), flush=True)
    if args.ptxas:
        for k in lk.build_report():
            if k['kernel'] in ('synth_pair_kernel', 'synth_pair_mma_kernel', 'anal_pair_kernel',
                               'anal_pair_mma_kernel'):
                print('    %s<%s>: %d registers, %d bytes stack, %d/%d bytes spill stores/loads'
                      % (k['kernel'], ', '.join(map(str, k['args'])), k['registers'],
                         k['stack'], k['spill_stores'], k['spill_loads']))
    gen = torch.Generator(device=dev).manual_seed(256)

    def crandn(shape, cdt):
        return torch.randn(shape, generator=gen, device=dev, dtype=cdt)

    def plan_of(pl):
        if isinstance(pl, lk.PairPlan):            # K2's cluster plan
            return dict(pl._asdict())
        return {'nseg': pl.nseg, 'blocks': pl.blocks, 'workspace_mib': pl.workspace_bytes / 2 ** 20}

    # ------------------------------------------------ the four kernels against their twins
    lmax = 256
    worst = {'synth_pair': 0., 'anal_pair': 0., 'synth': 0., 'anal': 0.}
    nrings = 257
    theta = gl_geometry(nrings - 1).theta
    rng = np.random.RandomState(256)
    th_r = np.sort(rng.uniform(0., np.pi, 201))
    th_r[0], th_r[-1] = 4e-4, np.pi - 7e-4
    segs, clusters = set(), set()
    for cdt, tol in ((torch.complex64, 1e-5), (torch.complex128, 1e-12)):
        for spin in (0, 1, 2, 3):
            t_m, t_p = core.pair_tables(lmax, lmax, spin, theta, None, dev)
            C, Cm = crandn((3, lmax + 1, lmax + 1), cdt), crandn((3, lmax + 1, lmax + 1), cdt)
            Q, Qm = crandn((3, nrings, lmax + 1), cdt), crandn((3, nrings, lmax + 1), cdt)
            for cm, qm in ((Cm, Qm), (None, None)):
                ks = lk.synth_pair(C, cm, spin, nrings, t_m, t_p)
                ps = core.legendre_synth_pair_plain(C, cm, spin, nrings, t_m, t_p)
                worst['synth_pair'] = max([worst['synth_pair']] + [
                    rel_max(a, b) for a, b in zip(ks, ps) if b is not None])
                pa = core.legendre_anal_pair_plain(Q, qm, spin, lmax, t_m, t_p)
                ka = lk.anal_pair(Q, qm, spin, lmax, t_m, t_p)
                clusters.add(lk.anal_pair_plan(Q, qm, spin).cluster)
                worst['anal_pair'] = max([worst['anal_pair']] + [
                    rel_max(a, b) for a, b in zip(ka, pa) if b is not None])
        for n in range(-3, 4):
            t = core.full_tables(lmax, lmax, n, th_r, None, dev)
            C, Q = crandn((3, lmax + 1, lmax + 1), cdt), crandn((3, len(th_r), lmax + 1), cdt)
            worst['synth'] = max(worst['synth'],
                                 rel_max(lk.synth(C, len(th_r), t), core.legendre_synth_plain(C, t)))
            pa = core.legendre_anal_plain(Q, lmax, t)
            for nseg in (None, 1):
                worst['anal'] = max(worst['anal'], rel_max(lk.anal(Q, lmax, t, nseg=nseg), pa))
                segs.add(lk.anal_plan(*Q.shape, lmax + 1, cdt, dev, nseg).nseg)
        torch.cuda.synchronize()
        for k, v in worst.items():
            if not v <= tol:
                raise RuntimeError('%s vs its plain twin at lmax %d, %s: %.2e > %.0e'
                                   % (k, lmax, cdt, v, tol))
        print('lmax 256, %s: worst of max vs the twins %s (K2 clusters of %s blocks, K4 '
              'segment counts %s)' % (cdt, ', '.join('%s %.2e' % kv for kv in worst.items()),
                                      sorted(clusters), sorted(segs)), flush=True)
        worst = dict.fromkeys(worst, 0.)

    # ------------------------------------------------------------------ the timed shapes
    results = []

    def timed(label, kind, call, tol, sweep, reps=args.reps, shape=None, plan=None):
        """Warm up, time, check run-to-run equality and, for K4's split ring sum, agreement
        with one segment. `call(nseg)` returns a tuple of outputs; the other kernels ignore
        `nseg`, K3 names its block shape (`legendre_kernels.synth_shape`), and K1, K2 and
        K4 their plan (`plan(nseg)`: `synth_pair_plan`'s, `anal_pair_plan`'s,
        `anal_plan`'s)."""
        first = call(None)
        mean, best, out = event_ms(lambda: call(None), reps)
        for a, b in zip(first, out):
            if not torch.equal(a, b):
                raise RuntimeError('%s: two runs differ' % label)
        row = dict(shape=label, kernel=kind, ms=mean, ms_min=best, card=smi)
        note = ''
        if shape is not None:
            row['block_shape'] = shape
            note = ' | %d maps x %d rings x %d warps, %d block(s) an SM' % shape
        if kind == 'synth_pair':
            pl = plan(None)
            row['plan'] = dict(pl._asdict())
            note = (' | MMA, batch tile %d, %d blocks of %d warps x %d rings a column'
                    % (pl.batch_tile, pl.blocks_per_m, pl.warps, pl.rings_per_warp) if pl.mma
                    else ' | %d maps x %d rings x %d warps, %d block(s) an SM' % pl.shape)
        if kind == 'anal_pair':
            row['plan'] = plan_of(plan(None))
            note = (' | clusters of %(cluster)d blocks x %(rings_per_block)d rings, %(warps)d '
                    'warps, batch tile %(batch_tile)d, %(blocks)d blocks, %(smem_bytes)d bytes '
                    'of shared memory a block' % row['plan'])
        if kind == 'anal':
            row.update(plan_of(plan(None)))
            note = ' | NS %d, %d blocks, workspace %.0f MiB' % (
                row['nseg'], row['blocks'], row['workspace_mib'])
        if row.get('nseg', 1) > 1:
            one = call(1)
            row['vs_one_segment'] = max(rel_max(a, b) for a, b in zip(out, one))
            if not row['vs_one_segment'] <= tol:
                raise RuntimeError('%s: %d segments vs one: %.2e > %.0e'
                                   % (label, row['nseg'], row['vs_one_segment'], tol))
            note += ', %.1e of max from one segment' % row['vs_one_segment']
            del one
        if sweep and 'nseg' in row:
            row['sweep'] = {}
            n = 1
            while n <= 16:
                call(n)                            # warm-up: the workspace's allocation
                got = plan_of(plan(n))
                row['sweep']['%d' % got['nseg']] = (event_ms(lambda: call(n), args.reps)[0],
                                                    got['blocks'], got['workspace_mib'])
                n *= 2
        results.append(row)
        print('%s: %.3f ms (min %.3f)%s | %s' % (label, mean, best, note, smi), flush=True)
        for k, v in row.get('sweep', {}).items():
            print('    forced NS %s: %.3f ms, %d blocks, workspace %.0f MiB' % ((k,) + v))
        return row

    geom = gl_geometry(3 * LMAX // 2)                 # the QE grid of lmax 2048: 3073 rings
    nr = geom.nrings
    t_m, t_p = core.pair_tables(LMAX, LMAX, 1, geom.theta, None, dev)
    for B in (8, 4):
        C, Cm = (crandn((B, LMAX + 1, LMAX + 1), torch.complex64) for _ in range(2))
        timed('K1 synth_pair, spin-1 pair, f32, lmax %d, %d rings, batch %d' % (LMAX, nr, B),
              'synth_pair', lambda nseg: lk.synth_pair(C, Cm, 1, nr, t_m, t_p), 1e-5, False,
              plan=lambda nseg: lk.synth_pair_plan(C, Cm, 1, nr))
        del C, Cm
        Qp, Qm = (crandn((B, nr, LMAX + 1), torch.complex64) for _ in range(2))
        timed('K2 anal_pair, spin-1 pair, f32, lmax %d, %d rings, batch %d' % (LMAX, nr, B),
              'anal_pair', lambda nseg: lk.anal_pair(Qp, Qm, 1, LMAX, t_m, t_p), 1e-5, False,
              plan=lambda nseg: lk.anal_pair_plan(Qp, Qm, 1))
        del Qp, Qm
    del t_m, t_p
    t_0, _ = core.pair_tables(LMAX, LMAX, 0, geom.theta, None, dev)
    C = crandn((4, LMAX + 1, LMAX + 1), torch.complex64)
    timed('K1 synth_pair, spin 0, one input, f32, lmax %d, %d rings, batch 4' % (LMAX, nr),
          'synth_pair', lambda nseg: lk.synth_pair(C, None, 0, nr, t_0, t_0)[:1], 1e-5, False,
          plan=lambda nseg: lk.synth_pair_plan(C, None, 0, nr))
    del C, t_0
    torch.cuda.empty_cache()

    cg_geom = gl_geometry(LMAX)                      # the cinv grid of lmax 2048: 2049 rings
    ncg, L = cg_geom.nrings, LMAX + 1

    def with_bound(row, tabs, mode, B, nrings=ncg):
        """roofline.pair_bound of the f64 pair call timed in `row`."""
        row['bound_ms'], row['bound_by'] = pair_bound(tabs, mode, B, nrings, True)
        print('    bound %.3f ms (%s): %.1f%% of it' % (row['bound_ms'], row['bound_by'],
                                                    100. * row['bound_ms'] / row['ms']))

    t_0, _ = core.pair_tables(LMAX, LMAX, 0, cg_geom.theta, None, dev)
    for B in (1, 2, 4, 8):
        C = crandn((B, L, L), torch.complex128)
        with_bound(timed('K1 synth_pair, spin 0, one input, f64, lmax %d, %d rings, batch %d '
                         '(CinvT)' % (LMAX, ncg, B), 'synth_pair',
                         lambda nseg: lk.synth_pair(C, None, 0, ncg, t_0, t_0)[:1], 1e-12,
                         False, plan=lambda nseg: lk.synth_pair_plan(C, None, 0, ncg)),
                   [t_0], 0, B)
        Q = crandn((B, ncg, L), torch.complex128)
        with_bound(timed('K2 anal_pair, spin 0, one input, f64, lmax %d, %d rings, batch %d '
                         '(CinvT)' % (LMAX, ncg, B), 'anal_pair',
                         lambda nseg: lk.anal_pair(Q, None, 0, LMAX, t_0, t_0)[:1],
                         1e-12, False, plan=lambda nseg: lk.anal_pair_plan(Q, None, 0)),
                   [t_0], 0, B)
        del C, Q
    del t_0
    t_m, t_p = core.pair_tables(LMAX, LMAX, 2, cg_geom.theta, None, dev)
    for B in (1, 4):
        C, Cm = (crandn((B, L, L), torch.complex128) for _ in range(2))
        with_bound(timed('K1 synth_pair, spin-2 pair, f64, lmax %d, %d rings, batch %d (CinvP)'
                         % (LMAX, ncg, B), 'synth_pair',
                         lambda nseg: lk.synth_pair(C, Cm, 2, ncg, t_m, t_p), 1e-12, False,
                         plan=lambda nseg: lk.synth_pair_plan(C, Cm, 2, ncg)), [t_m, t_p], 1, B)
        del C, Cm
    Qp, Qm = (crandn((4, ncg, L), torch.complex128) for _ in range(2))
    with_bound(timed('K2 anal_pair, spin-2 pair, f64, lmax %d, %d rings, batch 4 (CinvP)'
                     % (LMAX, ncg), 'anal_pair',
                     lambda nseg: lk.anal_pair(Qp, Qm, 2, LMAX, t_m, t_p), 1e-12,
                     False, plan=lambda nseg: lk.anal_pair_plan(Qp, Qm, 2)), [t_m, t_p], 1, 4)
    del Qp, Qm, t_m, t_p
    # the masked cell's QEs in f64: the spin-1 pair on the 3073-ring QE grid at batch 4
    t_m, t_p = core.pair_tables(LMAX, LMAX, 1, geom.theta, None, dev)
    C, Cm = (crandn((4, L, L), torch.complex128) for _ in range(2))
    with_bound(timed('K1 synth_pair, spin-1 pair, f64, lmax %d, %d rings, batch 4 (masked QE)'
                     % (LMAX, nr), 'synth_pair',
                     lambda nseg: lk.synth_pair(C, Cm, 1, nr, t_m, t_p), 1e-12, False,
                     plan=lambda nseg: lk.synth_pair_plan(C, Cm, 1, nr)), [t_m, t_p], 1, 4, nr)
    del C, Cm
    Qp, Qm = (crandn((4, nr, L), torch.complex128) for _ in range(2))
    with_bound(timed('K2 anal_pair, spin-1 pair, f64, lmax %d, %d rings, batch 4 (masked QE)'
                     % (LMAX, nr), 'anal_pair',
                     lambda nseg: lk.anal_pair(Qp, Qm, 1, LMAX, t_m, t_p), 1e-12,
                     False, plan=lambda nseg: lk.anal_pair_plan(Qp, Qm, 1)), [t_m, t_p], 1, 4, nr)
    del Qp, Qm, t_m, t_p
    torch.cuda.empty_cache()

    hgeom = HealpixGeometry(NSIDE)
    t = core.full_tables(LMAX, LMAX, -2, hgeom.theta, None, dev)
    C = crandn((4, LMAX + 1, LMAX + 1), torch.complex128)
    timed('K3 synth, n -2, f64, lmax %d, %d rings, batch 4' % (LMAX, hgeom.nrings), 'synth',
          lambda nseg: (lk.synth(C, hgeom.nrings, t),), 1e-12, False,
          shape=lk.synth_shape('plain', 'f64', 4))
    del C
    torch.cuda.empty_cache()
    Q = crandn((4, hgeom.nrings, LMAX + 1), torch.complex128)
    timed('K4 anal, n -2, f64, lmax %d, %d rings, batch 4' % (LMAX, hgeom.nrings), 'anal',
          lambda nseg: (lk.anal(Q, LMAX, t, nseg=nseg),), 1e-12, args.sweep,
          plan=lambda nseg: lk.anal_plan(*Q.shape, LMAX + 1, Q.dtype, dev, nseg))
    del Q, t
    torch.cuda.empty_cache()

    Gm, th_pw, _ = _ring_Gm(128, 128, 512)
    Gm = torch.as_tensor(Gm, device=dev)
    t = core.full_tables(512, 512, 2, th_pw, None, dev)
    timed('K4 anal, pixel-window shape, n 2, f64, lmax 512, %d node rings, batch %d'
          % (len(th_pw), Gm.shape[0]), 'anal',
          lambda nseg: (lk.anal(Gm, 512, t, nseg=nseg),), 1e-12, False,
          reps=10 * args.reps,              # a short kernel: more launches for a steady mean
          plan=lambda nseg: lk.anal_plan(*Gm.shape, 513, Gm.dtype, dev, nseg))

    del Gm, t
    torch.cuda.empty_cache()
    out = {'card': smi, 'reps': args.reps, 'shapes': results,
           'library': library_rows(dev, gen, smi, args.reps),
           'streamed': streamed_rows(dev, gen, smi, args.reps),
           'precision': precision_rows(dev, smi)}
    for k, kind in (('k1', 'synth_pair'), ('k2', 'anal_pair')):
        b8, b4 = [r['ms'] for r in results if r['kernel'] == kind][:2]
        out['%s_batch4_over_batch8' % k] = b4 / b8
        print('%s batch 4 / batch 8 time ratio: %.4f | %s' % (k.upper(), b4 / b8, smi))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, 'w') as f:
            json.dump(out, f)
    print(json.dumps(out))


if __name__ == '__main__':
    main()
