"""Plain spin-weighted spherical harmonic transforms on a north-south symmetric ring grid.

The reference's own transforms, in plain torch; nothing of the program is imported.
Conventions (healpy's):
    _sY_lm = N_l d^l_{m,-s}(theta) e^{i m phi},  N_l = sqrt((2l + 1) / 4 pi)
    _{+s}a_lm = -(g_lm + i c_lm),  _{-s}a_lm = -(-1)^s (g_lm - i c_lm)
    alm2map_spin((g, c), s) = (re, im) of sum_lm _sa_lm _sY_lm;  spin 0: map = sum t_lm Y_lm.

Wigner d^l_{m,n} comes from the three-term recurrence in l from its closed-form first
degree l0 = max(m, |n|), computed in log space and exponentiated (a seed below the
smallest double is zero: it stays below 1e-100 of the largest value up to l = m + 4096).
The recurrence runs in f64 over the northern rings for all m at once, l by l; each block
of `LB` degrees is then contracted with the data by one batched matrix product over m
(maps x l by l x rings). The southern rings follow from d^l_{mn}(pi - t) =
(-1)^{l+m} d^l_{m,-n}(t).

`dtype` is the precision of the data and of the products; the tables are rounded to it
from f64. `tf32=True` lets the products of f32 data run on the TF32 tensor cores.
"""
import contextlib

import numpy as np
import torch
from scipy.special import gammaln

from ..inputs import lm_of_index

LB = 32              # degrees a block
MAX_BATCH = 16       # maps a pass over the tables, at most
CHUNK_BYTES = 20e9   # working memory of a pass, about ten (rings x m) complex maps a map
FFT_MAPS = 4         # maps a ring transform

_CPLX = {torch.float64: torch.complex128, torch.float32: torch.complex64}


def _round_tf32(x):
    """f32 rounded to TF32's 10-bit mantissa: what the TF32 tensor cores read, for a CPU
    run (on the card the matrix products themselves run in TF32)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def _tf32(on):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = bool(on)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


class _Rec:
    """Recurrence of d^l_{m,n}(theta_j), j over the northern rings, for m0 <= m <= mmax.

    The recurrence carries each value as v 2^(S k) with an integer k <= 0 per (m, ring):
    a first degree far below the smallest double (high m near the poles) still grows to
    its true size at the turning point l ~ m / sin(theta), which lies inside the band from
    lmax ~ 1900 on. Every `RESCALE` degrees a v above 2^(S / 2) moves up one k."""

    S = 256
    RESCALE = 4

    def __init__(self, lmax, mmax, n, theta, device, m0=0):
        dev = torch.device(device)
        f64 = dict(dtype=torch.float64, device=dev)
        mi = np.arange(m0, mmax + 1)
        self.l0 = np.maximum(mi, abs(n))
        ls = torch.arange(lmax + 1, **f64)[:, None]
        ms = torch.as_tensor(mi, **f64)[None, :]
        nn = float(n)
        den = ls * torch.sqrt(((ls + 1.) ** 2 - ms ** 2) * ((ls + 1.) ** 2 - nn ** 2))
        bad = (ls < torch.as_tensor(np.maximum(self.l0, 1), **f64)[None, :]) | (den == 0)
        den = torch.where(bad, torch.ones_like(den), den)
        zero = torch.zeros((), **f64)
        self.al = torch.where(bad, zero, (2. * ls + 1.) * ls * (ls + 1.) / den)
        self.be = torch.where(bad, zero, -(2. * ls + 1.) * ms * nn / den)
        self.ga = torch.where(bad, zero, (ls + 1.) * torch.sqrt(torch.clamp(
            (ls ** 2 - ms ** 2) * (ls ** 2 - nn ** 2), min=0.)) / den)
        if n == 0 and m0 == 0:           # d^1_{00} = cos theta d^0_{00}
            self.al[0, 0], self.be[0, 0], self.ga[0, 0] = 1., 0., 0.
        # first degree: d^{l0}_{mn} = sign sqrt(C(a + b, a)) sin^a(t/2) cos^b(t/2)
        a = (ms - nn).abs()
        b = (ms + nn).abs()
        an, bn = np.abs(mi - nn), np.abs(mi + nn)
        lnc = torch.as_tensor(0.5 * (gammaln(an + bn + 1.) - gammaln(an + 1.)
                                     - gammaln(bn + 1.)), **f64)[None, :]
        th = torch.as_tensor(np.asarray(theta, dtype=float), **f64)[:, None]
        log2v = (lnc + a * torch.log(torch.sin(0.5 * th))
                 + b * torch.log(torch.cos(0.5 * th))) / np.log(2.)
        k0 = torch.clamp(torch.floor(log2v / self.S), max=0.)
        sign = torch.as_tensor(np.where((mi > n) & ((mi - n) % 2 == 1), -1., 1.), **f64)
        self.seed = (sign[None, :] * torch.exp2(log2v - self.S * k0)).T.contiguous()
        self.seed_k = k0.T.contiguous()                                   # (M, rings)
        self.x = torch.cos(th).T.contiguous()
        self.lmax, self.m0, self.M = lmax, m0, len(mi)
        self.n = n

    def _rows(self, l):
        """Columns that can be non-zero at degree l (m <= l)."""
        return int(np.clip(l - self.m0 + 1, 0, self.M))

    def blocks(self):
        """Yields (l_start, l_end, table) with table (M_b, l_end - l_start, rings) f64 of
        d^l_{m,n} for l in [l_start, l_end) and the first M_b columns (m <= l_end - 1)."""
        R = self.x.shape[1]
        dev = self.x.device
        v1 = torch.zeros((self.M, R), dtype=torch.float64, device=dev)
        v2, vn = torch.zeros_like(v1), torch.zeros_like(v1)
        k = torch.zeros_like(v1)
        scale = torch.ones_like(v1)
        up, big = 2. ** (-self.S), 2. ** (self.S // 2)
        for ls in range(0, self.lmax + 1, LB):
            le = min(ls + LB, self.lmax + 1)
            Mb = self._rows(le - 1)
            tab = torch.zeros((Mb, le - ls, R), dtype=torch.float64, device=dev)
            for l in range(ls, le):
                r = self._rows(l)
                if r == 0:
                    continue
                kk = self._rows(l - 1) if l > 0 else 0
                if kk:
                    t = torch.addcmul(self.be[l - 1, :kk, None], self.al[l - 1, :kk, None],
                                      self.x)
                    torch.mul(t, v1[:kk], out=vn[:kk])
                    vn[:kk].addcmul_(self.ga[l - 1, :kk, None], v2[:kk], value=-1.)
                lo = int(np.searchsorted(self.l0[:r], l, side='left'))
                hi = int(np.searchsorted(self.l0[:r], l, side='right'))
                if hi > lo:
                    vn[lo:hi] = self.seed[lo:hi]
                    k[lo:hi] = self.seed_k[lo:hi]
                    scale[lo:hi] = torch.exp2(self.S * k[lo:hi])
                if l % self.RESCALE == 0:
                    grow = vn[:r].abs() > big
                    f = torch.ones_like(vn[:r]).masked_fill_(grow, up)
                    vn[:r] *= f
                    v1[:r] *= f
                    k[:r] += grow
                    scale[:r] = torch.exp2(self.S * k[:r])
                torch.mul(vn[:r], scale[:r], out=tab[:r, l - ls])
                v2, v1, vn = v1, vn, v2
            yield ls, le, tab


def _parity(lmax, M, device):
    """(-1)^(l + m) as an (l, m) tensor."""
    ls = np.arange(lmax + 1)[:, None]
    ms = np.arange(M)[None, :]
    return torch.as_tensor((-1.) ** (ls + ms), device=device)


class SHT:
    """Spin-s transforms of band limit lmax on a symmetric ring grid (theta, weight, nphi)."""

    def __init__(self, theta, weight, nphi, lmax, dtype=torch.float64, tf32=False, *,
                 device):
        self.theta = np.asarray(theta, dtype=float)
        self.R = len(self.theta)
        assert np.allclose(self.theta + self.theta[::-1], np.pi), 'grid not symmetric'
        self.nN = (self.R + 1) // 2
        self.nS = self.R // 2
        self.nphi = int(nphi)
        self.lmax = lmax
        self.M = lmax + 1
        assert self.nphi >= 2 * lmax + 1
        self.dtype = dtype
        self.cdtype = _CPLX[dtype]
        self.tf32 = tf32
        self.device = torch.device(device)
        self.w = torch.as_tensor(np.asarray(weight, dtype=float), device=self.device)
        ls, ms = lm_of_index(lmax)
        self._flat = torch.as_tensor(ls * self.M + ms, device=self.device)
        self.N = torch.as_tensor(np.sqrt((2. * np.arange(lmax + 1) + 1.) / (4. * np.pi)),
                                 device=self.device)[:, None]
        self.P = _parity(lmax, self.M, self.device)
        self._recs = {}

    def _rec(self, n):
        if n not in self._recs:
            self._recs[n] = _Rec(self.lmax, self.lmax, n, self.theta[:self.nN], self.device)
        return self._recs[n]

    # ------------------------------------------------------------ layouts
    def to_grid(self, alm):
        """(B, nalm) -> (B, lmax + 1, M) complex, zero for l < m."""
        out = torch.zeros((alm.shape[0], self.M * self.M), dtype=alm.dtype,
                          device=alm.device)
        out[:, self._flat] = alm
        return out.reshape(alm.shape[0], self.M, self.M)

    def from_grid(self, A):
        return A.reshape(A.shape[0], -1)[:, self._flat]

    # ------------------------------------------------------------ Legendre phase
    def _operands(self, a, tab):
        """The operands of a block's product in the data's precision (TF32-rounded on the
        CPU when `tf32`)."""
        a, tab = a.contiguous(), tab.to(self.dtype)
        if self.tf32 and not a.is_cuda:
            a, tab = _round_tf32(a), _round_tf32(tab)
        return a, tab

    def _synth(self, srcs, n):
        """sum_l S_lm d^l_{m,n}(theta_j), j northern, for complex sources S (K, L, M)."""
        rec = self._rec(n)
        K = srcs.shape[0]
        X = torch.view_as_real(srcs.permute(2, 0, 1).contiguous())   # (M, K, L, 2)
        X = X.permute(0, 1, 3, 2).reshape(self.M, 2 * K, self.M).to(self.dtype)
        out = torch.zeros((self.M, 2 * K, self.nN), dtype=self.dtype, device=self.device)
        with _tf32(self.tf32):
            for ls, le, tab in rec.blocks():
                Mb = tab.shape[0]
                out[:Mb] += torch.bmm(*self._operands(X[:Mb, :, ls:le], tab))
        out = out.reshape(self.M, K, 2, self.nN).permute(1, 3, 0, 2)   # (K, rings, M, 2)
        return torch.view_as_complex(out.contiguous())

    def _anal(self, G, n):
        """sum_j G_jm d^l_{m,n}(theta_j), j northern, for complex G (K, rings, M)."""
        rec = self._rec(n)
        K = G.shape[0]
        Y = torch.view_as_real(G.permute(2, 0, 1).contiguous())      # (M, K, R, 2)
        Y = Y.permute(0, 1, 3, 2).reshape(self.M, 2 * K, self.nN).to(self.dtype)
        out = torch.zeros((self.M, 2 * K, self.M), dtype=self.dtype, device=self.device)
        with _tf32(self.tf32):
            for ls, le, tab in rec.blocks():
                Mb = tab.shape[0]
                out[:Mb, :, ls:le] = torch.bmm(*self._operands(Y[:Mb], tab.transpose(1, 2)))
        out = out.reshape(self.M, K, 2, self.M).permute(1, 3, 0, 2)   # (K, L, M, 2)
        return torch.view_as_complex(out.contiguous())

    def _south(self, FN, FS):
        """Rings from the northern sums and the mirrored southern ones."""
        return torch.cat([FN, FS[:, :self.nS].flip(1)], dim=1)

    def _split(self, G):
        GN = G[:, :self.nN]
        GS = torch.zeros_like(GN)
        GS[:, :self.nS] = G[:, self.nN:].flip(1)
        return GN, GS

    def _legendre_synth(self, A, Bc, s):
        """Fp = sum_l A d_{m,-s}, Fm = sum_l Bc d_{m,s} on every ring (Bc None: spin 0)."""
        B = A.shape[0]
        if Bc is None:
            F = self._synth(torch.cat([A, A * self.P]), 0)
            return self._south(F[:B], F[B:]), None
        Xm = self._synth(torch.cat([A, Bc * self.P]), -s)     # Fp north, Fm south
        Xp = self._synth(torch.cat([Bc, A * self.P]), s)      # Fm north, Fp south
        return self._south(Xm[:B], Xp[B:]), self._south(Xp[:B], Xm[B:])

    def _legendre_anal(self, Gp, Gmc, s):
        """A = sum_j Gp d_{m,-s}, B = sum_j Gmc d_{m,s} over every ring (Gmc None: spin 0)."""
        B = Gp.shape[0]
        GpN, GpS = self._split(Gp)
        if Gmc is None:
            X = self._anal(torch.cat([GpN, GpS]), 0)
            return X[:B] + X[B:] * self.P, None
        GmN, GmS = self._split(Gmc)
        Xm = self._anal(torch.cat([GpN, GmS]), -s)
        Xp = self._anal(torch.cat([GmN, GpS]), s)
        return Xm[:B] + Xp[B:] * self.P, Xp[:B] + Xm[B:] * self.P

    # ------------------------------------------------------------ longitude phase
    def _rings(self, Fp, Fm):
        """Ring values sum_m Fp e^{i m phi} + sum_{m > 0} Fm e^{-i m phi}, FFT_MAPS maps a
        transform."""
        out = torch.empty(Fp.shape[:2] + (self.nphi,), dtype=Fp.dtype, device=self.device)
        for i in range(0, Fp.shape[0], FFT_MAPS):
            X = torch.zeros((min(FFT_MAPS, Fp.shape[0] - i),) + out.shape[1:],
                            dtype=Fp.dtype, device=self.device)
            X[..., :self.M] = Fp[i:i + FFT_MAPS]
            X[..., self.nphi - self.M + 1:] += Fm[i:i + FFT_MAPS, :, 1:].flip(-1)
            out[i:i + FFT_MAPS] = torch.fft.ifft(X, dim=-1) * self.nphi
        return out

    def _bins(self, f):
        """(G+, conj G-): quadrature-weighted Fourier coefficients of m >= 0 and m <= 0."""
        Gp = torch.empty(f.shape[:2] + (self.M,), dtype=self.cdtype, device=self.device)
        Gmc = torch.empty_like(Gp)
        for i in range(0, f.shape[0], FFT_MAPS):
            T = torch.fft.fft(f[i:i + FFT_MAPS].to(self.cdtype), dim=-1)
            T = T * (2. * np.pi / self.nphi) * self.w[:, None]
            Gp[i:i + FFT_MAPS] = T[..., :self.M]
            Gmc[i:i + FFT_MAPS] = torch.conj(torch.cat(
                [T[..., :1], T[..., self.nphi - self.M + 1:].flip(-1)], dim=-1))
        return Gp, Gmc

    def _chunks(self, n):
        c = int(max(1, min(MAX_BATCH, CHUNK_BYTES // (10 * self.R * self.M * 16))))
        return [(i, min(i + c, n)) for i in range(0, n, c)]

    # ------------------------------------------------------------ public
    def alm2map(self, tlm):
        """(B, nalm) -> (B, R, nphi) real."""
        out = torch.empty((tlm.shape[0], self.R, self.nphi), dtype=self.dtype,
                          device=self.device)
        for i, j in self._chunks(tlm.shape[0]):
            A = self.to_grid(tlm[i:j].to(self.cdtype)) * self.N
            F, _ = self._legendre_synth(A, None, 0)
            for k in range(0, j - i, FFT_MAPS):
                kk = min(k + FFT_MAPS, j - i)
                out[i + k:i + kk] = torch.fft.irfft(F[k:kk], n=self.nphi, dim=-1) * self.nphi
        return out

    def map2alm(self, maps):
        """(B, R, nphi) real -> (B, nalm)."""
        out = []
        for i, j in self._chunks(maps.shape[0]):
            G = torch.cat([torch.fft.rfft(maps[k:min(k + FFT_MAPS, j)].to(self.dtype),
                                          dim=-1)[..., :self.M]
                           for k in range(i, j, FFT_MAPS)])
            G = G * (2. * np.pi / self.nphi) * self.w[:, None]
            A, _ = self._legendre_anal(G.to(self.cdtype), None, 0)
            out.append(self.from_grid(A * self.N))
        return torch.cat(out)

    def alm2field_spin(self, g, c, s):
        """(B, nalm) g, c -> the complex spin-s field (B, R, nphi), re + i im."""
        out = torch.empty((g.shape[0], self.R, self.nphi), dtype=self.cdtype,
                          device=self.device)
        for i, j in self._chunks(g.shape[0]):
            G = self.to_grid(g[i:j].to(self.cdtype))
            C = self.to_grid(c[i:j].to(self.cdtype))
            A = -(G + 1j * C) * self.N
            Bc = torch.conj(-((-1.) ** s) * (G - 1j * C)) * self.N
            Fp, Fm = self._legendre_synth(A, Bc, s)
            out[i:j] = self._rings(Fp, Fm)
        return out

    def alm2map_spin(self, g, c, s):
        """(B, nalm) g, c -> (re, im) of the spin-s field, each (B, R, nphi)."""
        f = self.alm2field_spin(g, c, s)
        return f.real, f.imag

    def field2alm_spin(self, f, s):
        """Complex spin-s field (B, R, nphi) -> (g, c) alms."""
        gs, cs = [], []
        for i, j in self._chunks(f.shape[0]):
            Gp, Gmc = self._bins(f[i:j])
            A, Bm = self._legendre_anal(Gp, Gmc, s)
            A = A * self.N
            Bm = Bm * self.N * ((-1.) ** s)
            gs.append(self.from_grid(-0.5 * (A + Bm)))
            cs.append(self.from_grid(0.5j * (A - Bm)))
        return torch.cat(gs), torch.cat(cs)

    def map2alm_spin(self, re, im, s):
        """(re, im) of a spin-s field -> (g, c) alms."""
        return self.field2alm_spin(torch.complex(re.to(self.dtype), im.to(self.dtype)), s)
