r"""Flat-sky N1 lensing-bias integrand, in torch (f64).

Port of plancklens_tpu/ops/n1kern.py (reference: plancklens/n1/n1f.f90): the N^(1) bias
of QE cross-spectra, Eq. A.3 of arXiv:1807.06210, as a quadruple flat-sky integral over the
CMB wavevector l1 (radial step dL, adaptive azimuth count) and the anisotropy-source vector
(sparse multipole knots `lps`, adaptive azimuth count).

The reference pads every azimuth axis to its largest count (weight zero beyond it) and
scans L1 inside one XLA program. Here the grid is compacted instead: the rows are the
(L, L1, phi1) points whose outer weight is not zero (the half-azimuth of each L1 ring, the
|l2| cut and the filters), the columns the (lps, phi_s) source points, and the integrand
is evaluated on the (rows x columns) box in chunks of `chunk` points, so the live
temporaries stay bounded (about 25 f64 arrays of the chunk). Each weight's geometry is
computed once and shared by the weights that use it (W13/W14, W24/W23, and the two kB
weights, whose geometries are permutations of one another). The value equals the
reference's up to the order of summation: the rows' sums are added per output L on the
host in f64.

Conventions replicated exactly, including the kernel's 1-based spectrum lookup
(Fortran cltt(l) == python cl[l-1]), rint rounding half to even (`torch.round`) and the
1e-30 guard of the angle factors.

Every entry point takes a required `device`; inputs are host arrays, results host numpy.
"""
from functools import cached_property

import numpy as np
import torch


def _cl_at(cl, li, lmin, lmax):
    """cl[l-1] lookup with [lmin, lmax] bounds mask (Fortran 1-based convention).

    l beyond the array's own band limit reads as 0 (not a clamped last entry), so a
    leg array shorter than the lmax another leg sets behaves as zero-padded."""
    idx = torch.clamp(li - 1, 0, cl.shape[0] - 1)
    ok = (li >= lmin) & (li <= lmax) & (li <= cl.shape[0])
    return torch.where(ok, cl[idx], torch.zeros((), dtype=cl.dtype, device=cl.device))


def _geom(l1x, l2x, l1y, l2y):
    """Shared angular/radial geometry of a wavevector pair: (cos2phi12, sin2phi12,
    L.l1, L.l2, Lxl1, Lxl2) with L = l1 + l2."""
    g = _Geo(l1x, l2x, l1y, l2y)
    return g.cos2p, g.sin2p, g.Lql1, g.Lql2, g.Lxl1, g.Lxl2


def _wf(k, l1x, l2x, l1y, l2y, l1i, l2i, cltt, clte, clee):
    """QE flat-sky weight functions W^k(l1, l2) (reference: n1f.f90:1-99).

    k is a 3-char key: source in 'pxsf' + field pair in tt/te/et/tb/bt/ee/eb/be/bb.
    Index tensors l1i/l2i are rounded integer moduli; spectra are (len lmax) tensors.
    """
    if k not in _WF_CODES:
        raise ValueError('unknown N1 weight key ' + k)
    return _wf_coded(_WF_CODES[k], l1x, l2x, l1y, l2y, l1i, l2i, cltt, clte, clee)


# ----------------------------------------------------------------------------- coded W^k
# Every flat-sky QE weight above is a two-term product sum
#     W^k = s1 * C_{c1}(l1) * A_{a1}(phi12) * R_{r1}(L, l1)
#         + s2 * C_{c2}(l2) * A_{a2}(phi12) * R_{r2}(L, l2)
# with C in {0, cltt, clte, clee, 1}, A in {1, cos2phi, sin2phi}, R in {1, L.l_i, Lxl_i}
# and s a sign, encoded as eight small integers. The box evaluation below reads every
# weight from its code, and skips the terms whose spectrum code is 0.
_SPEC_IDX = {'0': 0, 'tt': 1, 'te': 2, 'ee': 3, '1': 4}
_ANG_IDX = {'1': 0, 'c': 1, 's': 2}
_RAD_IDX = {'1': 0, 'q': 1, 'x': 2}


def _enc(term):
    if term is None:
        return [0, 0, 0, 1]
    c, a, r, s = term
    return [_SPEC_IDX[c], _ANG_IDX[a], _RAD_IDX[r], s]


def _build_codes():
    codes = {}
    for src, rad in (('p', 'q'), ('x', 'x')):
        table = {
            'tt': (('tt', '1', rad, 1), ('tt', '1', rad, 1)),
            'te': (('te', 'c', rad, 1), ('te', '1', rad, 1)),
            'et': (('te', '1', rad, 1), ('te', 'c', rad, 1)),
            'tb': (('te', 's', rad, 1), None),
            'bt': (None, ('te', 's', rad, -1)),
            'ee': (('ee', 'c', rad, 1), ('ee', 'c', rad, 1)),
            'eb': (('ee', 's', rad, 1), None),
            'be': (None, ('ee', 's', rad, -1)),
            'bb': (None, None),
        }
        for pair, (t1, t2) in table.items():
            codes[src + pair] = _enc(t1) + _enc(t2)
    codes['stt'] = _enc(('1', '1', '1', 1)) + _enc(None)
    codes['ftt'] = _enc(('tt', '1', '1', 1)) + _enc(('tt', '1', '1', 1))
    for pair in ('tt', 'te', 'et', 'tb', 'bt', 'ee', 'eb', 'be', 'bb'):
        codes.setdefault('s' + pair, _enc(None) + _enc(None))
        codes.setdefault('f' + pair, _enc(None) + _enc(None))
    return {k: np.asarray(v, dtype=np.int32) for k, v in codes.items()}


_WF_CODES = _build_codes()


def wf_code(k):
    """The 8-int coefficient code of weight key `k` (see _wf_coded)."""
    return _WF_CODES[k]


def _wf_coded(code, l1x, l2x, l1y, l2y, l1i, l2i, cltt, clte, clee):
    """W^k from its 8-int code (host integers), code = wf_code(k)."""
    spectra = (cltt, clte, clee)
    geo = _Geo(l1x, l2x, l1y, l2y)
    look = (lambda c: _cl_at(spectra[c - 1], l1i, 1, spectra[c - 1].shape[0]),
            lambda c: _cl_at(spectra[c - 1], l2i, 1, spectra[c - 1].shape[0]))
    w = _eval_code(code, geo, look[0], look[1])
    if w is None:
        return torch.zeros_like(geo.Lql1)
    return w * torch.ones_like(geo.Lql1) if isinstance(w, float) else w


class _Geo:
    """_geom of a wavevector pair, each member computed on first use and kept; the squared
    norms may be passed in when the caller has them already."""

    def __init__(self, l1x, l2x, l1y, l2y, l1sq=None, l2sq=None):
        self.l1x, self.l2x, self.l1y, self.l2y = l1x, l2x, l1y, l2y
        self._l1sq, self._l2sq = l1sq, l2sq

    @cached_property
    def sx(self):
        return self.l1x + self.l2x

    @cached_property
    def sy(self):
        return self.l1y + self.l2y

    @cached_property
    def _safe(self):
        l1sq = self.l1x * self.l1x + self.l1y * self.l1y if self._l1sq is None else self._l1sq
        l2sq = self.l2x * self.l2x + self.l2y * self.l2y if self._l2sq is None else self._l2sq
        return torch.clamp(l1sq * l2sq, min=1e-30)

    @cached_property
    def _dot(self):
        return self.l1x * self.l2x + self.l1y * self.l2y

    @cached_property
    def cos2p(self):
        return 2. * self._dot * self._dot / self._safe - 1.

    @cached_property
    def sin2p(self):
        cross = -self.l1y * self.l2x + self.l1x * self.l2y
        return 2. * self._dot * cross / self._safe

    @cached_property
    def Lql1(self):
        return self.sx * self.l1x + self.sy * self.l1y

    @cached_property
    def Lql2(self):
        return self.sx * self.l2x + self.sy * self.l2y

    @cached_property
    def Lxl1(self):
        return -self.sy * self.l1x + self.sx * self.l1y

    @cached_property
    def Lxl2(self):
        return -self.sy * self.l2x + self.sx * self.l2y

    def ang(self, a):
        return (None, lambda: self.cos2p, lambda: self.sin2p)[a]

    def rad(self, r, side):
        if r == 0:
            return None
        return (lambda: self.Lql1, lambda: self.Lxl1)[r - 1] if side == 1 \
            else (lambda: self.Lql2, lambda: self.Lxl2)[r - 1]


class _Swapped:
    """The geometry of the swapped pair (l2, l1), read off that of (l1, l2): the sums,
    dot and norms are symmetric, the cross product changes sign, so cos2p is shared,
    sin2p negates, and the two legs' radial factors trade places (bit for bit)."""

    def __init__(self, geo):
        self.g = geo

    def ang(self, a):
        if a == 2:
            return lambda: -self.g.sin2p
        return self.g.ang(a)

    def rad(self, r, side):
        return self.g.rad(r, 2 if side == 1 else 1)


def _eval_code(code, geo, spec1, spec2):
    """Sum of the non-zero terms of an 8-int code: None when both vanish, a python float
    for a constant weight, else a tensor. spec1/spec2 map a spectrum code (1-3) to its
    values at the first / second leg's multipoles."""
    out = None
    for (c, a, r, s), spec, side in ((code[0:4], spec1, 1), (code[4:8], spec2, 2)):
        c, a, r, s = int(c), int(a), int(r), int(s)
        if c == 0:
            continue
        t = 1. if c == 4 else spec(c)
        for f in (geo.ang(a), geo.rad(r, side)):
            if f is not None:
                t = f() * t if isinstance(t, float) else t * f()
        if s < 0:
            t = -t
        out = t if out is None else out + t
    return out


def _grids(lminA, lmaxA, dL, lps):
    """Static integration-grid descriptors (numpy)."""
    L1s = np.arange(max(lminA, dL // 2), lmaxA + 1, dL, dtype=float)
    nphi = np.where(L1s.astype(int) > 3 * dL,
                    2 * np.rint(0.5 * L1s / dL).astype(int) + 1,
                    2 * L1s.astype(int) + 1)
    nphi_half = (nphi - 1) // 2 + 1
    lps = np.asarray(lps, dtype=int)
    dlps = np.empty(len(lps), dtype=float)
    dlps[0] = lps[1] - lps[0]
    dlps[1:-1] = 0.5 * (lps[2:] - lps[:-2])
    dlps[-1] = lps[-1] - lps[-2]
    ns = np.where(lps > 20,
                  2 * np.rint(0.5 * (2 * lps + 1) / dlps).astype(int) + 1,
                  2 * lps + 1)
    return L1s, nphi, int(nphi_half.max()), lps, dlps, ns, int(ns.max())


def _default_chunk(device):
    return 1 << 24 if device.type == 'cuda' else 1 << 20


class _Tables:
    """Masked lookup tables: entry l of a table is the reference's _cl_at(cl, l, lmin,
    lmax); indices are clamped to the last entry, which is zero."""

    def __init__(self, arrays, device):
        self.nt = max(len(a) for a, _, _ in arrays.values()) + 2
        self.tab = {}
        for name, (a, lmin, lmax) in arrays.items():
            a = np.asarray(a, dtype=float)
            t = np.zeros(self.nt)
            hi = min(lmax, len(a))
            lo = max(lmin, 1)
            if hi >= lo:
                t[lo:hi + 1] = a[lo - 1:hi]
            if lmin <= 0 <= lmax and len(a):   # l = 0 reads cl[0] (the clipped index)
                t[0] = a[0]
            self.tab[name] = torch.as_tensor(t, device=device)

    def index(self, x):
        return torch.clamp(torch.round(x), max=self.nt - 1).long()


def _n1_rows(Ls, kA, grids, lminA, lmaxA, bndA, dL, tabs, device):
    """The (L, L1, phi1) rows whose outer weight `pref` is not zero, as the reference
    evaluates them (n1kern._n1L_body, per_L1): returns the row quantities and the output
    index of each row."""
    L1s, nphi = grids[0], grids[1]
    # every (L1, phi1) of the half azimuth grids (phi1 = 0 weighted once, others twice)
    n_half = (nphi - 1) // 2 + 1
    ring = np.repeat(np.arange(len(L1s)), n_half)
    p = np.arange(len(ring)) - np.repeat(np.cumsum(n_half) - n_half, n_half)
    dphi = 2. * np.pi / nphi.astype(float)
    phis = dphi[ring] * p
    L1 = L1s[ring]
    wphi = np.where(p == 0, 1., 2.)
    fac = dphi[ring] * L1 * dL
    L1x1 = L1 * np.cos(phis)
    L1y1 = L1 * np.sin(phis)
    T = lambda a: torch.as_tensor(a, device=device)
    nL, nP = len(Ls), len(ring)
    Lx = T(np.repeat(np.asarray(Ls, dtype=float), nP))
    L1x, L1y = T(np.tile(L1x1, nL)), T(np.tile(L1y1, nL))
    L1t = T(np.tile(L1, nL))
    L2x = Lx - L1x
    L2y = 0. - L1y
    L2 = torch.sqrt(L2x * L2x + L2y * L2y)
    L1i = tabs.index(L1t)
    L2i = tabs.index(L2)
    ok2 = (L2 >= lminA) & (L2 <= bndA)
    geo = _Geo(L1x, L2x, L1y, L2y)
    fid = {1: 'ttf', 2: 'tef', 3: 'eef'}
    wA = _eval_code(wf_code(kA), geo, lambda c: tabs.tab[fid[c]][L1i],
                    lambda c: tabs.tab[fid[c]][L2i])
    if wA is None:
        return None
    f12 = tabs.tab['f1'][L1i] * tabs.tab['f2'][L2i]
    pref = T(np.tile(wphi, nL)) * ok2 * wA * f12 * T(np.tile(fac, nL)) \
        / (2. * np.pi) ** 4 * 0.25
    keep = torch.nonzero(pref != 0.).flatten()
    rows = {'Lx': Lx[keep], 'L1x': L1x[keep], 'L1y': L1y[keep], 'L2x': L2x[keep],
            'L2y': L2y[keep], 'L1i': L1i[keep], 'L2i': L2i[keep], 'pref': pref[keep]}
    return rows, (keep // nP).cpu().numpy()


def _n1_cols(cl_kI, grids, device):
    """The (lps, phi_s) source points with their weights dphi_s lps dlps C^kI(lps)."""
    lps, dlps, ns = grids[3], grids[4], grids[5]
    # a knot list that is not increasing (default_lps of a small lmaxphi ends on a step
    # back) gives counts <= 0, which the reference's mask reads as no point
    n = np.maximum(ns, 0)
    knot = np.repeat(np.arange(len(lps)), n)
    j = np.arange(len(knot)) - np.repeat(np.cumsum(n) - n, n) - np.repeat((ns - 1) // 2, n)
    dphi_s = 2. * np.pi / ns.astype(float)
    phi_s = dphi_s[knot] * j
    lp = lps[knot].astype(float)
    cl = np.asarray(cl_kI, dtype=float)
    clk = np.where((lps >= 1) & (lps <= len(cl)), cl[np.clip(lps - 1, 0, len(cl) - 1)], 0.)
    w = dphi_s * lps * dlps * clk
    T = lambda a: torch.as_tensor(a, device=device)
    return T(lp * np.cos(phi_s)), T(lp * np.sin(phi_s)), T(w[knot])


def _box(rows, r0, r1, cols, codes, kB, lminB, bndB, tabs):
    """Sum over the source points of the integrand on rows r0:r1 (one value a row)."""
    PhiLx, PhiLy, wcol = cols
    g = lambda name: rows[name][r0:r1, None]
    L1x, L1y, L2x, L2y, Lx = g('L1x'), g('L1y'), g('L2x'), g('L2y'), g('Lx')
    L3x = PhiLx[None, :] - L1x
    L3y = PhiLy[None, :] - L1y
    L3sq = L3x * L3x + L3y * L3y
    L3 = torch.sqrt(L3sq)
    L4x = -Lx - L3x
    L4y = -0. - L3y
    L4sq = L4x * L4x + L4y * L4y
    L4 = torch.sqrt(L4sq)
    ok34 = (L3 >= lminB) & (L3 <= bndB) & (L4 >= lminB) & (L4 <= bndB)
    idx = {'1': g('L1i'), '2': g('L2i'), '3': tabs.index(L3), '4': tabs.index(L4)}
    del L3, L4
    looked = {}

    def at(name, site):
        if (name, site) not in looked:
            looked[name, site] = tabs.tab[name][idx[site]]
        return looked[name, site]

    true = {1: 'tt', 2: 'te', 3: 'ee'}
    fid = {1: 'ttf', 2: 'tef', 3: 'eef'}
    g13 = _Geo(L1x, L3x, L1y, L3y, l2sq=L3sq)
    g24 = _Geo(L2x, L4x, L2y, L4y, l2sq=L4sq)
    g34 = _Geo(L3x, L4x, L3y, L4y, l1sq=L3sq, l2sq=L4sq)
    sp = lambda site, names: (lambda c: at(names[c], site))
    k13, k24, k14, k23 = codes
    terms = []
    # term1 = W^kB(l3, l4) W13 W24 f3(l3) f4(l4); term2 = W^kB(l4, l3) W14 W23 f3(l4) f4(l3)
    for cB, geoB, s3, s4, c1, c2, f3s, f4s in (
            (wf_code(kB), g34, '3', '4', k13, k24, '3', '4'),
            (wf_code(kB), _Swapped(g34), '4', '3', k14, k23, '4', '3')):
        w1 = _eval_code(c1, g13, sp('1', true), sp('3', true))
        if w1 is None:
            continue
        w2 = _eval_code(c2, g24, sp('2', true), sp('4', true))
        if w2 is None:
            continue
        wB = _eval_code(cB, geoB, sp(s3, fid), sp(s4, fid))
        if wB is None:
            continue
        t = wB
        for f in (w1, w2, at('f3', f3s), at('f4', f4s)):
            t = t * f
        terms.append(t)
    if not terms:
        return None
    tot = terms[0] if len(terms) == 1 else terms[0] + terms[1]
    return torch.mv(tot * ok34, wcol)


def _n1_core(Ls, kA, kB, codes, cl_kI, spectra, fids, legs, lminA, lmaxA, lminB, lmaxB,
             bndA, bndB, dL, lps, chunk, device):
    """N1 on the output knots Ls for one set of inner weight codes (k13, k24, k14, k23)
    and filter legs (fal1, fal2, fal3, fal4); numpy (len(Ls),)."""
    device = torch.device(device)
    chunk = _default_chunk(device) if chunk is None else int(chunk)
    grids = _grids(lminA, lmaxA, dL, lps)
    arrays = {n: (a, 1, len(a)) for n, a in zip(('tt', 'te', 'ee'), spectra)}
    arrays.update({n: (a, 1, len(a)) for n, a in zip(('ttf', 'tef', 'eef'), fids)})
    for n, a in zip(('f1', 'f2'), legs[:2]):
        arrays[n] = (a, lminA, lmaxA)
    for n, a in zip(('f3', 'f4'), legs[2:]):
        arrays[n] = (a, lminB, lmaxB)
    tabs = _Tables(arrays, device)
    out = np.zeros(len(Ls))
    made = _n1_rows(Ls, kA, grids, lminA, lmaxA, bndA, dL, tabs, device)
    if made is None:
        return out
    rows, which = made
    nrows = len(which)
    if nrows == 0:
        return out
    cols = _n1_cols(cl_kI, grids, device)
    per = max(1, chunk // cols[0].shape[0])
    vals = torch.zeros(nrows, dtype=torch.float64, device=device)
    for r0 in range(0, nrows, per):
        r1 = min(nrows, r0 + per)
        inner = _box(rows, r0, r1, cols, codes, kB, lminB, bndB, tabs)
        if inner is None:
            return out
        vals[r0:r1] = rows['pref'][r0:r1] * inner
    vals = vals.cpu().numpy()
    np.add.at(out, which, vals)
    return out


def _fal(kA, kB, ftlA, felA, fblA, ftlB, felB, fblB):
    fal = {'t': ftlA, 'e': felA, 'b': fblA}
    fbl = {'t': ftlB, 'e': felB, 'b': fblB}
    return [np.asarray(fal[kA[1]]), np.asarray(fal[kA[2]]),
            np.asarray(fbl[kB[1]]), np.asarray(fbl[kB[2]])]


def n1L_batch(Ls, kA, kB, kI, cl_kI, cltt, clte, clee, clttfid, cltefid, cleefid,
              ftlA, felA, fblA, ftlB, felB, fblB, lminA, lminB, dL, lps, chunk=None, *,
              device):
    """The N1 curve on the output knots `Ls` (reference: n1kern.n1L_batch).

    Spectrum and filter arrays follow the reference convention: entry [i] is multipole
    i + 1, valid range [lmin, len(array)]. `chunk` is the number of box
    points evaluated at once (default 2^24 on a CUDA device, 2^20 on the CPU). Returns a
    numpy (len(Ls),) array."""
    lmaxA, lmaxB = len(ftlA), len(ftlB)
    codes = [wf_code(kI + kA[1] + kB[1]), wf_code(kI + kA[2] + kB[2]),
             wf_code(kI + kA[1] + kB[2]), wf_code(kI + kA[2] + kB[1])]
    return _n1_core(np.asarray(Ls, dtype=float), kA, kB, codes, cl_kI,
                    (cltt, clte, clee), (clttfid, cltefid, cleefid),
                    _fal(kA, kB, ftlA, felA, fblA, ftlB, felB, fblB),
                    lminA, lmaxA, lminB, lmaxB, lmaxA, lmaxB, dL, lps, chunk, device)


def n1L(L, kA, kB, kI, cl_kI, cltt, clte, clee, clttfid, cltefid, cleefid,
        ftlA, felA, fblA, ftlB, felB, fblB, lminA, lminB, dL, lps, *, device):
    """N1 contribution at a single output multipole L (reference: n1f.f90:129-277)."""
    return float(n1L_batch([L], kA, kB, kI, cl_kI, cltt, clte, clee, clttfid, cltefid,
                           cleefid, ftlA, felA, fblA, ftlB, felB, fblB, lminA, lminB, dL,
                           lps, device=device)[0])


def n1L_jtp_batch(Ls, kA, kB, combos, kI, cl_kI, cltt, clte, clee,
                  clttfid, cltefid, cleefid, lminA, lminB, dL, lps, chunk=None, *, device):
    """All jtp combinations: `combos` is a list of (Xp + Yp + Ip + Jp, FXXp, FYYp, FIIp,
    FJJp) tuples; returns a numpy (ncombo, len(Ls)) array of N1 values.

    As in the reference, the legs are read as zero-padded to the common band limits (the
    integration grid follows the longest A leg), and each combination keeps its own
    continuous |l| <= lmax integration cuts (the length of its FXXp and of its FIIp)."""
    lmaxA = max(len(c[1]) for c in combos)
    lmaxB = max(len(c[3]) for c in combos)
    Ls = np.asarray(Ls, dtype=float)
    out = np.zeros((len(combos), len(Ls)))
    for i, (fields, fX, fY, fI, fJ) in enumerate(combos):
        Xp, Yp, Ip, Jp = fields
        codes = [wf_code(kI + Xp + Ip), wf_code(kI + Yp + Jp),
                 wf_code(kI + Xp + Jp), wf_code(kI + Yp + Ip)]
        out[i] = _n1_core(Ls, kA, kB, codes, cl_kI, (cltt, clte, clee),
                          (clttfid, cltefid, cleefid),
                          [np.asarray(f) for f in (fX, fY, fI, fJ)],
                          lminA, lmaxA, lminB, lmaxB, float(len(fX)), float(len(fI)),
                          dL, lps, chunk, device)
    return out


def n1L_jtp(L, kA, kB, Xp, Yp, Ip, Jp, kI, cl_kI, cltt, clte, clee,
            clttfid, cltefid, cleefid, fXXp, fYYp, fIIp, fJJp, lminA, lminB, dL, lps, *,
            device):
    """Joint-TP-filtering N1 at a single L (reference: n1f.f90:280-396): the QE legs couple
    to primed fields (Xp, Yp, Ip, Jp) through explicit filtering-matrix elements."""
    return float(n1L_jtp_batch([L], kA, kB, [(Xp + Yp + Ip + Jp, fXXp, fYYp, fIIp, fJJp)],
                               kI, cl_kI, cltt, clte, clee, clttfid, cltefid, cleefid,
                               lminA, lminB, dL, lps, device=device)[0, 0])
