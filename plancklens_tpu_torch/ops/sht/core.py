r"""Spin-weighted Legendre engine: recursion tables, the plain torch engines and the
device dispatch of the Legendre transforms.

For all m >= 0 and the rings theta_j of a north-south symmetric grid, the fused pair

    synthesis:  F^{-s}_{jm} = sum_l Cp_{lm} d^l_{m,-s}(theta_j),  F^{+s} likewise from Cm
    analysis:   A_{lm} = sum_j Qp_{jm} d^l_{m,-s}(theta_j),       B from Qm with d^l_{m,+s}

is computed on the northern half only: the mirror identity
d^l_{m n}(pi - t) = (-1)^{l+m} d^l_{m,-n}(t) gives the southern values of each transform
from the other recursion (spin 0: from its own). On any other grid (HEALPix through
HealpixSHT, the exact pixel window's node grids, asymmetric ring sets) the plain
transforms run one recursion over every ring:

    synthesis:  G_{jm} = sum_l C_{lm} d^l_{m,n}(theta_j)
    analysis:   A_{lm} = sum_j Q_{jm} d^l_{m,n}(theta_j)

Numerical stability at high m follows libsharp: the recursion carries a per-(ring, m)
power-of-2^S exponent k, so the sin^m(theta/2)-type underflow of the seed is represented
exactly (the "scaled recursion"; JAX reference: plancklens_tpu/ops/sht/core.py).

`legendre_synth_pair`/`legendre_anal_pair` and `legendre_synth`/`legendre_anal` keep the
contracts of the reference's functions of the same names and dispatch on the input
tensor's device: a CUDA tensor goes to the hand-written Hopper kernels
(legendre_kernels.py), a CPU tensor to the plain torch engines below. The plain engines
are also the references the kernels are held against, on the card, by the tests and by
chip_smoke.py. On an asymmetric grid the pair functions make two plain calls, as the
reference does.

Precision: the recursion always runs in f64 (S = 256); the accumulation runs in the data
type (f32 in production on the card, f64 in the tests), but for kernel K2, which
accumulates in f64 on the tensor cores and rounds each output once. The reference's f32 engine runs
the recursion in f32, which near the poles cannot resolve the small angles (cos theta
rounds to within 1e-7 of 1): at lmax 2048 on the 3073-ring QE grid an f32-recursion
spin-1 synthesis is off by 5.4e-4 rms and 9.6e-3 of max against f64 (H100), and by up to
4e-2 on single polar rings.
"""
import time
from collections import Counter, OrderedDict

import numpy as np
import torch
from scipy.special import gammaln

from . import legendre_kernels
from ...utils import trace


def _xi_sign(m, n):
    return -1.0 if (m > n and (m - n) % 2 == 1) else 1.0


def recursion_tables(lmax, mmax, n, theta, m0=0):
    """Per-(l, m) recursion coefficients and scaled seed values for d^l_{m, n}(theta),
    host numpy float64 (copy of plancklens_tpu/ops/sht/core.py:71-138 at dtype float64),
    for the columns m = m0..mmax (an m-block of a transform split over ranks builds only
    its own columns; m0 = 0 is the whole set).

    Returns dict with (M = mmax + 1 - m0 columns, column j holding m = m0 + j):
      alpha, beta, gamma: (lmax+1, M) float arrays; step l -> l+1 reads row l
      l0:       (M,) int32, first nonzero degree max(m, |n|)
      seed_v:   (nrings, M) scaled seed value at l = l0(m)
      seed_k:   (nrings, M) int32 exponent: true seed = seed_v * 2^(S k)
      x:        (nrings,) cos(theta)
      S:        exponent chunk size (256, sized to the f64 exponent range: these seeds
                overflow when cast to f32)
    """
    ls = np.arange(lmax + 1, dtype=np.float64)[:, None]
    ms = np.arange(m0, mmax + 1, dtype=np.float64)[None, :]
    l0 = np.maximum(np.abs(n), np.arange(m0, mmax + 1)).astype(np.int64)
    with np.errstate(divide='ignore', invalid='ignore'):
        D = ls * np.sqrt(((ls + 1.) ** 2 - ms ** 2) * ((ls + 1.) ** 2 - float(n) ** 2))
        alpha = (2. * ls + 1.) * ls * (ls + 1.) / D
        beta = -(2. * ls + 1.) * ms * float(n) / D
        gamma = (ls + 1.) * np.sqrt((ls ** 2 - ms ** 2) * (ls ** 2 - float(n) ** 2)) / D
    # rows below l0(m) - and the l = 0 row when l0 = 0 - are never used meaningfully
    invalid = ls < np.maximum(l0[None, :], 1)
    for arr in (alpha, beta, gamma):
        arr[invalid] = 0.
        arr[~np.isfinite(arr)] = 0.
    if n == 0 and m0 == 0 and mmax >= 0 and l0[0] == 0:
        # explicit l=0 step for the m=0 Legendre branch: d^1 = x d^0
        alpha[0, 0], beta[0, 0], gamma[0, 0] = 1., 0., 0.

    # scaled seeds: d^{l0}_{m n} = xi sqrt(binom(a+b, a)) sin^a(theta/2) cos^b(theta/2)
    S = 256
    a = np.abs(ms - n)
    b = np.abs(ms + n)
    lnr0 = 0.5 * (gammaln(a + b + 1.) - gammaln(a + 1.) - gammaln(b + 1.))
    lnsin = np.log(np.sin(0.5 * np.asarray(theta, dtype=np.float64)))[:, None]
    lncos = np.log(np.cos(0.5 * np.asarray(theta, dtype=np.float64)))[:, None]
    log2v = (lnr0 + a * lnsin + b * lncos) / np.log(2.)
    xi = np.array([_xi_sign(int(m), n) for m in range(m0, mmax + 1)])[None, :]
    seed_k = np.minimum(np.floor(log2v / S), 0.).astype(np.int32)
    seed_v = xi * np.exp2(log2v - S * seed_k.astype(np.float64))
    return dict(S=S, alpha=alpha, beta=beta, gamma=gamma, l0=l0.astype(np.int32),
                seed_v=seed_v, seed_k=seed_k, x=np.cos(np.asarray(theta, dtype=np.float64)))


def tables_to_device(tab, device):
    """f64 recursion-table set (numpy dict) -> contiguous torch tensors on `device`."""
    out = {'S': int(tab['S'])}
    for k in ('alpha', 'beta', 'gamma', 'l0', 'seed_v', 'seed_k', 'x'):
        out[k] = torch.from_numpy(np.ascontiguousarray(tab[k])).to(device)
    return out


class _TableCache:
    """LRU of f64 device table sets keyed by (lmax, mmax, n, grid token, device, m0). A QE at
    one band limit touches ~7 sets (spins 0..3 of the legs, the output spin); one set at
    lmax 2048 on the 3073-ring QE grid is ~150 MB, one on all 8191 rings of HEALPix
    nside 2048 ~300 MB. The token says which rings a set covers: ('ns', grid) the
    northern half of a pair grid, ('full', grid) every ring of a plain one; m0 says which
    columns (m0..mmax: a rank's m-block of a split transform).

    It keeps the host interval of every build in `builds` ((start, end) of
    time.perf_counter_ns), so that a run can tell the seconds its set-up spent on tables
    from those a later phase spent; while the tracer is live each build is also a span
    sht.recursion_tables, and hits and misses count in sht.tables_hit / sht.tables_miss."""

    def __init__(self, maxsize=16):
        self.maxsize = maxsize
        self._d = OrderedDict()
        self.builds = []

    def get(self, lmax, mmax, n, theta_half, grid_token, device, m0=0):
        key = None if grid_token is None else \
            (lmax, mmax, n, grid_token, str(torch.device(device)), m0)
        if key is not None and key in self._d:
            self._d.move_to_end(key)
            trace.count('sht.tables_hit')
            return self._d[key]
        trace.count('sht.tables_miss')
        t0 = time.perf_counter_ns()
        with trace.span('sht.recursion_tables', lmax=int(lmax), n=int(n),
                        nrings=len(theta_half), m0=int(m0)) as s:
            tab = tables_to_device(recursion_tables(lmax, mmax, n, theta_half, m0), device)
            s.set(bytes=sum(v.numel() * v.element_size() for v in tab.values()
                            if isinstance(v, torch.Tensor)))
        self.builds.append((t0, time.perf_counter_ns()))
        if key is not None:
            self._d[key] = tab
            while len(self._d) > self.maxsize:
                self._d.popitem(last=False)
        return tab

    def clear(self):
        """Drop every cached set, so that the next path builds its own tables cold."""
        self._d.clear()


TABLES = _TableCache()


def clear_cache():
    """Empty the recursion-table cache (the JAX package's `core.clear_cache`)."""
    TABLES.clear()


def pair_tables(lmax, mmax, spin, theta, grid_token, device, m0=0):
    """(t_m, t_p): f64 device tables of d^l_{m,-spin} and d^l_{m,+spin}, m = m0..mmax, on
    the northern half (equator included) of the symmetric grid `theta`; t_p is t_m for
    spin 0."""
    theta = np.asarray(theta)
    nh = (len(theta) + 1) // 2
    th = theta[:nh]
    tok = None if grid_token is None else ('ns', grid_token)
    t_m = TABLES.get(lmax, mmax, -spin, th, tok, device, m0)
    t_p = t_m if spin == 0 else TABLES.get(lmax, mmax, spin, th, tok, device, m0)
    return t_m, t_p


def full_tables(lmax, mmax, n, theta, grid_token, device, m0=0):
    """f64 device tables of d^l_{m,n}, m = m0..mmax, on every ring of `theta` (the plain
    transforms)."""
    tok = None if grid_token is None else ('full', grid_token)
    return TABLES.get(lmax, mmax, n, np.asarray(theta), tok, device, m0)


def is_symmetric(theta):
    th = np.asarray(theta, dtype=np.float64)
    return bool(np.allclose(th + th[::-1], np.pi, atol=1e-12))


# ------------------------------------------------------------------ plain torch engine
def _rec_step(l, st, al, bl, gl, xc, l0, sv, sk, thresh, down):
    """One scaled Wigner-d recursion step l -> l+1 (twin of the reference's core._rec_step
    and of rec_step in csrc/legendre_pair.cu): seed injection at l+1 == l0(m) zeroes d
    and REPLACES k by seed_k; 2^-S down-scaling of both d and d_next when k < 0 and
    |d_next| > 2^(S/2), with k += 1. st = (d_{l-1}, d_l, k) on (rings, m)."""
    d_m1, d, k = st
    d_next = (al * xc + bl) * d - gl * d_m1
    inject = (l + 1) == l0
    d_new = torch.where(inject, torch.zeros_like(d), d)
    d_next = torch.where(inject, sv, d_next)
    k = torch.where(inject, sk, k)
    cond = (k < 0) & (d_next.abs() > thresh)
    fac = torch.where(cond, down, torch.ones_like(d_next))
    return d_new * fac, d_next * fac, k + cond.to(torch.int32)


def _init_state(t):
    l0 = t['l0'][None, :]
    sv = t['seed_v']
    return (torch.zeros_like(sv), torch.where(l0 == 0, sv, torch.zeros_like(sv)),
            torch.where(l0 == 0, t['seed_k'], torch.zeros_like(t['seed_k'])))


def _deff(st, S, dtype):
    """Effective d = d 2^(S k), rounded once to the data's real dtype."""
    return (st[1] * torch.exp2((S * st[2]).to(st[1].dtype))).to(dtype)


def _sgn_m(M, dtype, device):
    return 1. - 2. * (torch.arange(M, device=device) % 2).to(dtype)


def _plain_pair(mode, data_p, data_m, spin, nrings, t_m, t_p, lmax):
    """Shared l-loop of the plain pair engine. `single` (spin 0 with no second input)
    runs one recursion; otherwise both run, and a missing second input only drops its
    output (the reference Pallas wrapper feeds zeros instead)."""
    single = data_m is None and spin == 0
    nh = (nrings + 1) // 2
    n_s = nrings - nh
    S = t_m['S']
    rdt = t_m['seed_v'].dtype          # recursion dtype (f64)
    adt = data_p.real.dtype            # accumulation dtype
    dev = data_p.device
    M = data_p.shape[-1]
    L = lmax + 1
    xc = t_m['x'][:, None]
    thresh = torch.tensor(2.0 ** (S // 2), dtype=rdt, device=dev)
    down = torch.tensor(2.0 ** (-S), dtype=rdt, device=dev)
    sgn_m = _sgn_m(M, adt, dev)
    st_m = _init_state(t_m)
    st_p = st_m if single else _init_state(t_p)
    B = data_p.shape[0]
    if mode == 'synth':
        acc = torch.zeros((4, B, nh, M), dtype=data_p.dtype, device=dev)
    else:
        Qp_n, Qp_s = _fold(data_p, nh, n_s, sgn_m)
        Qm_n, Qm_s = (None, None) if data_m is None else _fold(data_m, nh, n_s, sgn_m)
        outs = torch.zeros((2, B, L, M), dtype=data_p.dtype, device=dev)
    for l in range(L):
        dm = _deff(st_m, S, adt)
        dp = dm if single else _deff(st_p, S, adt)
        sgn_l = -1. if l % 2 else 1.
        if mode == 'synth':
            cp = data_p[:, l, None, :]
            acc[0] += cp * dm
            acc[1] += cp * (sgn_l * dp)
            if data_m is not None:
                cm = data_m[:, l, None, :]
                acc[2] += cm * dp
                acc[3] += cm * (sgn_l * dm)
        else:
            outs[0, :, l] = (Qp_n * dm).sum(1) + sgn_l * (Qp_s * dp).sum(1)
            if data_m is not None:
                outs[1, :, l] = (Qm_n * dp).sum(1) + sgn_l * (Qm_s * dm).sum(1)
        st_m = _rec_step(l, st_m, t_m['alpha'][l], t_m['beta'][l], t_m['gamma'][l], xc,
                         t_m['l0'], t_m['seed_v'], t_m['seed_k'], thresh, down)
        if not single:
            st_p = _rec_step(l, st_p, t_p['alpha'][l], t_p['beta'][l], t_p['gamma'][l],
                             xc, t_p['l0'], t_p['seed_v'], t_p['seed_k'], thresh, down)
    if mode == 'synth':
        def assemble(F_n, F_s):
            return torch.cat([F_n, (F_s * sgn_m)[:, :n_s].flip(1)], dim=1)
        Fp = assemble(acc[0], acc[1])
        return Fp, (None if data_m is None else assemble(acc[2], acc[3]))
    return outs[0], (None if data_m is None else outs[1])


def _fold(Q, nh, n_s, sgn_m):
    """(north rows, sgn_m-signed southern rows in mirror order, zero-padded to nh)."""
    Qn = Q[:, :nh]
    Qs = torch.zeros_like(Qn)
    Qs[:, :n_s] = Q[:, nh:].flip(1) * sgn_m
    return Qn, Qs


def _plain(mode, data, t, lmax):
    """l-loop of the plain engine: one recursion over every ring, no mirror."""
    S = t['S']
    rdt = t['seed_v'].dtype
    adt = data.real.dtype
    dev = data.device
    B, M = data.shape[0], data.shape[-1]
    xc = t['x'][:, None]
    thresh = torch.tensor(2.0 ** (S // 2), dtype=rdt, device=dev)
    down = torch.tensor(2.0 ** (-S), dtype=rdt, device=dev)
    st = _init_state(t)
    if mode == 'synth':
        out = torch.zeros((B, len(t['x']), M), dtype=data.dtype, device=dev)
    else:
        out = torch.zeros((B, lmax + 1, M), dtype=data.dtype, device=dev)
    for l in range(lmax + 1):
        d = _deff(st, S, adt)
        if mode == 'synth':
            out += data[:, l, None, :] * d
        else:
            out[:, l] = (data * d).sum(1)
        st = _rec_step(l, st, t['alpha'][l], t['beta'][l], t['gamma'][l], xc, t['l0'],
                       t['seed_v'], t['seed_k'], thresh, down)
    return out


def legendre_synth_plain(C, t):
    """Plain torch synthesis G_jm = sum_l C_lm d^l_{m,n}(theta_j) (twin of kernel K3, any
    device). C: (B, lmax+1, M) complex; t: device tables of d_{m,n} on all rings.
    Returns (B, nrings, M) complex."""
    return _plain('synth', C, t, C.shape[-2] - 1)


def legendre_anal_plain(Q, lmax, t):
    """Plain torch analysis A_lm = sum_j Q_jm d^l_{m,n}(theta_j) (twin of kernel K4, any
    device). Q: (B, nrings, M) complex, quadrature-weighted. Returns (B, lmax+1, M)."""
    return _plain('anal', Q, t, lmax)


def legendre_synth_pair_plain(Cp, Cm, spin, nrings, t_m, t_p):
    """Plain torch fused NS-pair synthesis (twin of kernel K1, any device).

    Cp, Cm: (B, lmax+1, M) complex (Cm may be None); t_m/t_p: device tables of
    d_{m,-spin}/d_{m,+spin} on the northern nh = ceil(nrings/2) rings. Returns (Fp, Fm),
    (B, nrings, M) complex, Fm None when Cm is None."""
    return _plain_pair('synth', Cp, Cm, spin, nrings, t_m, t_p, Cp.shape[-2] - 1)


def legendre_anal_pair_plain(Qp, Qm, spin, lmax, t_m, t_p):
    """Plain torch fused NS-pair analysis (twin of kernel K2, any device).

    Qp, Qm: (B, nrings, M) complex, quadrature-weighted (Qm may be None). Returns (A, Bc),
    (B, lmax+1, M) complex, Bc None when Qm is None."""
    return _plain_pair('anal', Qp, Qm, spin, Qp.shape[1], t_m, t_p, lmax)


# ------------------------------------------------------------------ public API
# Every entry point takes `m0`, the true m of the data's first column (default 0: columns
# 0..M-1). A rank of a transform split over m (parallel/mesh.shard_sht) passes its block's
# first m, and gets the tables of its own columns. The pair kernels K1/K2 and their twins
# read the parity of the mirror sign (-1)^m off the column index, so a pair call's block
# must start at an even m; an odd m0 raises.
def _check_m0(m0):
    if m0 < 0 or m0 % 2:
        raise ValueError('an m-block of a pair transform starts at an even m (got m0=%d): '
                         'the kernels take the mirror sign from the column parity' % m0)


def _span(kind, pair, x, second, spin, theta, lmax, m0):
    """The span sht.legendre of one entry call, with its shape (NOOP when not live). A call
    whose hand-written kernel launched adds its name, `kernel` 'K1'..'K4' (K1 also `mma`,
    True where it ran on the FP64 tensor cores: `legendre_kernels.synth_plan`); a call on
    the plain engine, or one that its kernel's wrapper refused, adds none."""
    if not trace.live():
        return trace.NOOP
    return trace.span('sht.legendre', kind=kind, pair=pair, lmax=int(lmax), m0=int(m0),
                      M=int(x.shape[-1]), spin=int(spin), two=second is not None,
                      nrings=len(theta), B=int(x.shape[0]),
                      f64=x.dtype in (torch.complex128, torch.float64))


def legendre_synth(C, n, theta, grid_token=None, m0=0):
    """G_jm = sum_l C_lm d^l_{m,n}(theta_j) on any ring set; C (B, lmax+1, M) complex64
    or complex128, columns m0..m0+M-1. CUDA tensors run kernel K3, CPU tensors the plain
    engine."""
    lmax, M = C.shape[-2] - 1, C.shape[-1]
    with _span('synth', False, C, None, n, theta, lmax, m0) as s:
        t = full_tables(lmax, m0 + M - 1, n, theta, grid_token, C.device, m0)
        if C.is_cuda:
            out = legendre_kernels.synth(C, len(theta), t)
            s.set(kernel='K3')
            return out
        return legendre_synth_plain(C, t)


def legendre_anal(Q, n, theta, lmax, grid_token=None, m0=0):
    """A_lm = sum_j Q_jm d^l_{m,n}(theta_j); Q (B, nrings, M) complex, quadrature-
    weighted, columns m0..m0+M-1. CUDA tensors run kernel K4, CPU tensors the plain
    engine."""
    with _span('anal', False, Q, None, n, theta, lmax, m0) as s:
        t = full_tables(lmax, m0 + Q.shape[-1] - 1, n, theta, grid_token, Q.device, m0)
        if Q.is_cuda:
            out = legendre_kernels.anal(Q, lmax, t)
            s.set(kernel='K4')
            return out
        return legendre_anal_plain(Q, lmax, t)


def legendre_synth_pair(Cp, Cm, spin, theta, grid_token=None, m0=0):
    """(Fp, Fm) = (sum_l Cp d^l_{m,-spin}, sum_l Cm d^l_{m,+spin}) on the rings `theta`;
    Cm may be None (then Fm is None). Cp (B, lmax+1, M) complex64 or complex128, columns
    m0..m0+M-1 (m0 even). On a symmetric grid CUDA tensors run kernel K1, CPU tensors the
    plain pair engine; on any other grid it makes two plain calls (reference:
    core.py:704-710)."""
    lmax, M = Cp.shape[-2] - 1, Cp.shape[-1]
    with _span('synth', True, Cp, Cm, spin, theta, lmax, m0) as s:
        if not is_symmetric(theta):
            Fp = legendre_synth(Cp, -spin, theta, grid_token, m0)
            return Fp, (None if Cm is None
                        else legendre_synth(Cm, spin, theta, grid_token, m0))
        _check_m0(m0)
        t_m, t_p = pair_tables(lmax, m0 + M - 1, spin, theta, grid_token, Cp.device, m0)
        if Cp.is_cuda:
            out = legendre_kernels.synth_pair(Cp, Cm, spin, len(theta), t_m, t_p)
            s.set(kernel='K1', mma=legendre_kernels.synth_pair_plan(Cp, Cm, spin,
                                                                    len(theta)).mma)
            return out
        return legendre_synth_pair_plain(Cp, Cm, spin, len(theta), t_m, t_p)


def legendre_anal_pair(Qp, Qm, spin, theta, lmax, grid_token=None, m0=0):
    """(A, Bc) = (sum_j Qp d^l_{m,-spin}, sum_j Qm d^l_{m,+spin}); Qm may be None. Qp
    (B, nrings, M) complex, quadrature-weighted, columns m0..m0+M-1 (m0 even). On a
    symmetric grid CUDA tensors run kernel K2, CPU tensors the plain pair engine; on any
    other grid two plain calls."""
    with _span('anal', True, Qp, Qm, spin, theta, lmax, m0) as s:
        if not is_symmetric(theta):
            A = legendre_anal(Qp, -spin, theta, lmax, grid_token, m0)
            return A, (None if Qm is None
                       else legendre_anal(Qm, spin, theta, lmax, grid_token, m0))
        _check_m0(m0)
        M = Qp.shape[-1]
        t_m, t_p = pair_tables(lmax, m0 + M - 1, spin, theta, grid_token, Qp.device, m0)
        if Qp.is_cuda:
            out = legendre_kernels.anal_pair(Qp, Qm, spin, lmax, t_m, t_p)
            s.set(kernel='K2')
            return out
        return legendre_anal_pair_plain(Qp, Qm, spin, lmax, t_m, t_p)


def kernel_calls(records):
    """Kernel calls among tracer records (trace.records(), or its slice after a mark): a
    Counter of the sht.legendre records that carry `kernel`, keyed by (kernel, mode, batch,
    'f32' or 'f64'). The mode is csrc/legendre_pair.cu's: `legendre_kernels.pair_mode` for
    K1/K2, 3 for K3/K4."""
    out = Counter()
    for r in records:
        a = r['attrs']
        if r['name'] != 'sht.legendre' or 'kernel' not in a:
            continue
        mode = (3 if a['kernel'] in ('K3', 'K4')
                else legendre_kernels.pair_mode(a['spin'], a['two']))
        out[a['kernel'], mode, a['B'], 'f64' if a['f64'] else 'f32'] += 1
    return out


class counting:
    """The kernel calls of a section of code:

        with core.counting() as c:
            ...
        c.calls      # kernel_calls of the records the section added
        c.records    # those records

    The tracer is on inside the section and back as it was after it. No record is dropped,
    so the other readers of the records (the copy spans, a profiler's join) keep theirs."""

    def __enter__(self):
        self._was_on = trace.enabled()
        self._n0 = len(trace.records())
        trace.enable()
        return self

    def __exit__(self, *exc):
        if not self._was_on:
            trace.disable()
        self.records = trace.records()[self._n0:]
        self.calls = kernel_calls(self.records)
        return False
