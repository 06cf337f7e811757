r"""Exact C^{-1} (Wiener / inverse-variance) filtering by conjugate gradients, in torch.

Port of plancklens_tpu/models/cinv.py (reference: plancklens/qcinv/opfilt_tt.py,
opfilt_pp.py, opfilt_tp.py, plancklens/filt/filt_cinv.py:56-626). The linear system

    (S^{-1} + B^T Y^T N^{-1} Y B) x = B^T Y^T N^{-1} m

is solved by the PCG of ops/cg.py; its forward op costs one synthesis and one analysis
(kernels K1/K2 on the card: spin 0 for T, the spin-2 pair for P, both for the joint T/P
filter CinvTP), and a batch of maps is a leading axis of one lockstep solve. The system
is D_l-rescaled for a scale-balanced criterion (filt_cinv.py:82-92). Preconditioners:
the diagonal, a dense low-l block (analytic for T, probed for P and T/E/B), the
reference's descriptor grammar (`parse_pre_op_descr`) and its multigrid chains. Templates (monopole/dipole or arbitrary maps) are
deprojected from N^{-1} exactly (opfilt_tt.py:99-205).

Every operator constant (N^{-1} per steradian, templates, (P^T N^{-1} P)^{-1}, the
spectra and beam of the rescaled system, the preconditioner diagonals, the dense block's
inverse and its index maps) is put on the filter's device once, when the operators are
made: a solve uploads nothing per iteration. Each operator returns its input's dtype; the
dense inverse is applied in f64 and the result cast back. The host-side f64 pieces
(`dense_block_analytic_t`, `_dmat_np`, the template algebra) are copies of the
reference's numpy code.
"""
import numpy as np
import torch

from ..utils import alm as ualm
from ..utils.cls import cli, cldict2arr
from ..utils.hashing import clhash
from ..ops.sht import SHT
from ..ops.sht.core import recursion_tables
from ..ops.sht.transforms import _resolve_device, _on_device
from ..ops import cg

_CDTYPE = {torch.float32: torch.complex64, torch.float64: torch.complex128}
# device memory the stacked probe of `dense_pre_op_stacked` may take for its basis vectors,
# their forward applies and the analysis workspace (one H100 holds 80 GB)
PROBE_BUDGET = 24 * 2 ** 30


def _dense_cache_key(tag, lmax_dense, lmax, arrays):
    """Cache key for a persisted dense preconditioner, the reference's string for the same
    inputs (a block cached by either package loads in the other).

    Hashes *every* input that shapes the probed operator (all ninv components, the signal
    cls slice, the transfer function, and the template-deprojection stack incl. its count)
    and uses the clamped dense lmax actually built, so a changed configuration can never
    silently load a stale matrix."""
    ld = min(lmax_dense, lmax)
    hs = '_'.join(str(clhash(np.atleast_1d(np.asarray(a, dtype=float)).ravel()))[:8]
                  for a in arrays)
    return 'dense_%s_%d_%d_%s' % (tag, ld, lmax, hs)


def _lm_ms(lmax):
    _, ms = ualm._lm_indices(lmax)
    return np.asarray(ms)


def template_maps(geom, which=('monopole', 'dipole')):
    """Pixel-space template maps to marginalise over: monopole and the three dipoles
    (reference: plancklens/qcinv/template_removal.py). Host numpy."""
    th = geom.theta
    phi = geom.phi0 + 2. * np.pi * np.arange(geom.nphi) / geom.nphi
    sth, cth = np.sin(th)[:, None], np.cos(th)[:, None]
    out = []
    if 'monopole' in which:
        out.append(np.ones((geom.nrings, geom.nphi)))
    if 'dipole' in which:
        out.append(np.broadcast_to(cth, (geom.nrings, geom.nphi)).copy())
        out.append(sth * np.cos(phi)[None, :])
        out.append(sth * np.sin(phi)[None, :])
    return np.stack(out) if out else np.zeros((0, geom.nrings, geom.nphi))


def _omega(geom):
    """(nrings, nphi) pixel solid angles of the ring quadrature."""
    return np.outer(geom.weight, np.full(geom.nphi, 2. * np.pi / geom.nphi))


def _default_rescal(lmax):
    ls = np.arange(lmax + 1, dtype=float)
    rescal_cl = np.sqrt(ls * (ls + 1.) / (2. * np.pi))
    rescal_cl[0] = 1.
    return rescal_cl


def _fl_alm(fl, lmax, dtype, device):
    """l-dependent factor fl expanded over the triangular alm layout, on `device`: x * it
    is `ualm.almxfl(x, lmax, fl)` with no gather and no upload."""
    fl = torch.as_tensor(np.asarray(fl, dtype=np.float64)[:lmax + 1], dtype=dtype,
                         device=device)
    return fl[ualm._dev_index(lmax, device, 'l')]


def _maps_in(maps, device, dtype):
    """Maps (numpy, placed on `device`; or a tensor on it) in the real dtype."""
    return _on_device(maps, device).to(dtype)


class NinvFilterT:
    """Pixel-space inverse-noise filtering with template deprojection, spin 0.

    Args:
        geom: RingGeometry the maps live on
        ninv: (nrings, nphi) inverse noise variance per *pixel* (0 where masked); any map
              spec of utils.maps.read_map
        b_transf: beam/transfer function applied in the forward op
        marge_monopole, marge_dipole: marginalise these modes
        templates: optional extra (ntemp, nrings, nphi) template maps
        dtype: real dtype of the operators; device: where they run
    """

    def __init__(self, geom, ninv, b_transf, marge_monopole=True, marge_dipole=True,
                 templates=None, dtype=torch.float64, *, device):
        from ..utils.maps import read_map
        self.geom = geom
        self.dtype = dtype
        self.device = _resolve_device(device)
        self.ninv = read_map(ninv).reshape(geom.nrings, geom.nphi)
        self.b_transf = np.asarray(b_transf)
        # per-pixel inverse variance -> inverse variance per steradian, so that
        # Y^T N^{-1} Y = quadrature-analysis(ninv_st * synthesis(.))
        omega = _omega(geom)
        self.ninv_st = self.ninv / omega
        which = (('monopole',) if marge_monopole else ()) + (('dipole',) if marge_dipole else ())
        tmpl = template_maps(geom, which)
        if templates is not None:
            tmpl = np.concatenate([tmpl, np.asarray(templates)], axis=0)
        self.templates = np.asarray(tmpl)
        if len(tmpl):
            PtNP = np.einsum('arp,brp->ab', tmpl * self.ninv[None], tmpl)
            eigv, eigw = np.linalg.eigh(PtNP)
            self.PtNP_inv = eigw @ np.diag(cli(eigv)) @ eigw.T
        else:
            self.PtNP_inv = None
        # average noise level over the UNMASKED sky for the effective ftl: the reference
        # normalises by the unmasked pixel count (filt_cinv.py:455-458 _calc_fal nnz)
        omega_nnz = float(np.sum(omega[self.ninv > 0]))
        self.nlev_ftl = 10800. / np.sqrt(np.sum(self.ninv) / max(omega_nnz, 1e-300)) / np.pi

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=self.device)
        self._ninv_st = dev(self.ninv_st)
        self._omega = dev(omega)
        if self.PtNP_inv is not None:
            self._tmpl = dev(self.templates)
            self._PtNP_inv_T = dev(self.PtNP_inv.T)

    def hashdict(self):
        return {'ninv': clhash(self.ninv), 'b_transf': clhash(self.b_transf),
                'ntempl': int(self.templates.shape[0]), 'geom': self.geom.hashdict()}

    def apply_map(self, tmap):
        """N^{-1} with template modes deprojected, per-steradian units, on (batch, nrings,
        nphi) tensors on the filter's device."""
        tmap = tmap * self._ninv_st
        if self.PtNP_inv is not None:
            # templates are deprojected in per-pixel units, as in the reference
            tpix = tmap * self._omega
            coeffs = torch.einsum('trp,brp->bt', self._tmpl, tpix) @ self._PtNP_inv_T
            pmodes = torch.einsum('bt,trp->brp', coeffs, self._tmpl)
            tmap = tmap - pmodes * self._ninv_st
        return tmap

    def make_ops(self, lmax, s_cltt, rescal_cl=None):
        """(fwd_op, calc_prep, pre_op_diag, (rescal_cl, dl)) of the rescaled system at band
        limit lmax, on (batch, nalm) complex tensors."""
        if rescal_cl is None:
            rescal_cl = _default_rescal(lmax)
        dl = rescal_cl ** 2 * s_cltt[:lmax + 1]
        bdl = self.b_transf[:lmax + 1] * cli(rescal_cl)
        sht = SHT(self.geom, lmax, dtype=self.dtype, device=self.device)
        dli = _fl_alm(cli(dl), lmax, self.dtype, self.device)
        bdlj = _fl_alm(bdl, lmax, self.dtype, self.device)

        def apply_alm(x):
            """Y^T N^{-1} Y with beams, in rescaled units (opfilt_tt.apply_alm)."""
            m = self.apply_map(sht.alm2map(x * bdlj))
            return sht.map2alm(m) * bdlj

        def fwd_op(x):
            return x * dli + apply_alm(x)

        def calc_prep(maps):
            m = self.apply_map(_maps_in(maps, self.device, self.dtype))
            return sht.map2alm(m) * bdlj

        ninv_cl = np.sum(self.ninv) / (4. * np.pi)
        diagj = _fl_alm(cli(cli(dl) + ninv_cl * bdl ** 2), lmax, self.dtype, self.device)

        def pre_op_diag(r):
            return r * diagj

        return fwd_op, calc_prep, pre_op_diag, (rescal_cl, dl)


def _dmat_np(lmax, n, theta):
    """f64 numpy (lmax+1, mmax+1, nrings) array of d^l_{m,n}(theta): the engine's scaled
    Wigner recursion (ops/sht/core.recursion_tables) run on host, so the conventions are
    exactly the Legendre kernels'."""
    tb = recursion_tables(lmax, lmax, n, np.asarray(theta, dtype=np.float64))
    S = tb['S']
    alpha, beta, gamma = tb['alpha'], tb['beta'], tb['gamma']
    l0, sv, sk, x = tb['l0'], tb['seed_v'], tb['seed_k'], tb['x']
    nrings, mm = len(np.asarray(theta)), lmax + 1
    out = np.zeros((mm, mm, nrings))
    d_m1 = np.zeros((nrings, mm))
    d = np.where(l0[None, :] == 0, sv, 0.)
    k = np.where(l0[None, :] == 0, sk, 0).astype(np.int64)
    thresh, down = 2.0 ** (S // 2), 2.0 ** (-S)
    for l in range(mm):
        out[l] = (d * np.exp2(S * k.astype(np.float64))).T
        d_next = (alpha[l][None, :] * x[:, None] + beta[l][None, :]) * d \
            - gamma[l][None, :] * d_m1
        inject = (l + 1) == l0[None, :]
        d_new = np.where(inject, 0., d)
        d_next = np.where(inject, sv, d_next)
        k = np.where(inject, sk, k)
        cond = (k < 0) & (np.abs(d_next) > thresh)
        fac = np.where(cond, down, 1.)
        d_m1, d, k = d_new * fac, d_next * fac, k + cond
    return out


def _rlm_l_of(lmax):
    """l of every real-harmonic (rlm) packing index."""
    return np.floor(np.sqrt(np.arange((lmax + 1) ** 2))).astype(int)


def dense_block_analytic_t(filt, lmax_dense, dl, bdl):
    """Exact host-side (f64) low-l block of the rescaled T forward operator, in the
    real-harmonic basis, assembled analytically from the separable ring structure

        M[(lm),(l'm')] = S^{-1} delta + bdl_l bdl_l' fac_l fac_l'
                         sum_j d^l_m(j) d^{l'}_{m'}(j) x [ring Fourier modes of N^{-1}]

    with template deprojection as the exact low-rank correction (copy of the reference's
    numpy code, plancklens_tpu/models/cinv.py:196-292). Exact at any solver precision and
    far cheaper than probing, which needs (lmax_dense+1)^2 full-resolution forward applies.
    """
    geom = filt.geom
    Ld = lmax_dense
    theta = np.asarray(geom.theta, dtype=np.float64)
    nphi = geom.nphi
    phis = geom.phi0 + 2. * np.pi * np.arange(nphi) / nphi
    ninv = np.asarray(filt.ninv, dtype=np.float64)  # per-pixel inverse variance
    fac = np.sqrt((2. * np.arange(Ld + 1) + 1.) / (4. * np.pi))
    D = _dmat_np(Ld, 0, theta) * fac[:, None, None]          # [l, m, j], fac included
    ks = np.arange(2 * Ld + 1)
    CC = ninv @ np.cos(np.outer(phis, ks))                   # (nrings, 2 Ld + 1)
    SA = ninv @ np.sin(np.outer(phis, ks))
    nr = (Ld + 1) ** 2
    M = np.zeros((nr, nr))
    ls = np.arange(Ld + 1)
    rt2 = np.sqrt(2.)

    def idx(m, kind):  # rlm packing indices of (all l, m); kind 'c'/'s'
        # rows/cols with l < m alias other rlm slots, but their D rows are identically
        # zero, so the scatters only add zeros there
        if m == 0:
            return ls ** 2
        return ls ** 2 + 2 * m - (1 if kind == 'c' else 0)

    # one einsum per (m1, block kind) over all m2 at once (O(Ld) numpy calls)
    m2s = np.arange(Ld + 1)
    idx_c = [idx(m, 'c') for m in range(Ld + 1)]
    idx_s = [idx(m, 's') for m in range(Ld + 1)]
    Dt = np.ascontiguousarray(D.transpose(1, 2, 0))          # [m2, j, l']

    def add_blocks(rows, col_idx, B, m2_from=0):
        for m2 in range(m2_from, Ld + 1):
            M[np.ix_(rows, col_idx[m2])] += B[:, m2, :]

    for m1 in range(Ld + 1):
        dk, sk_ = np.abs(m2s - m1), m2s + m1
        sgn = np.where(m2s >= m1, 1., -1.)   # SA(m2 - m1) = sgn * SA(|m2 - m1|)
        D1 = D[:, m1, :]
        # cos-cos: the dk == sk degeneracy at m = 0 folds into the coefficient
        one0 = (m1 == 0) != (m2s == 0)
        ccoef = np.where(one0, rt2 / 2., np.where((m1 == 0) & (m2s == 0), 0.5, 1.))
        Wcc = ccoef[None, :] * (CC[:, dk] + CC[:, sk_])
        add_blocks(idx_c[m1], idx_c,
                   np.einsum('lj,jm,mjk->lmk', D1, Wcc, Dt, optimize=True))
        # cos-sin
        Wcs = -(rt2 / 2. if m1 == 0 else 1.) * (SA[:, sk_] + sgn[None, :] * SA[:, dk])
        add_blocks(idx_c[m1], idx_s,
                   np.einsum('lj,jm,mjk->lmk', D1, Wcs, Dt, optimize=True), m2_from=1)
        if m1 > 0:
            # sin-cos and sin-sin
            sccoef = np.where(m2s == 0, rt2 / 2., 1.)
            Wsc = -sccoef[None, :] * (SA[:, sk_] - sgn[None, :] * SA[:, dk])
            add_blocks(idx_s[m1], idx_c,
                       np.einsum('lj,jm,mjk->lmk', D1, Wsc, Dt, optimize=True))
            Wss = CC[:, dk] - CC[:, sk_]
            add_blocks(idx_s[m1], idx_s,
                       np.einsum('lj,jm,mjk->lmk', D1, Wss, Dt, optimize=True),
                       m2_from=1)

    if filt.PtNP_inv is not None:
        # exact low-rank template-deprojection correction: M -= U^T (P^T N^-1 P)^-1 U
        ntmpl = filt.templates.shape[0]
        U = np.zeros((ntmpl, nr))
        cosm = np.cos(np.outer(phis, ls))
        sinm = np.sin(np.outer(phis, ls))
        for t in range(ntmpl):
            Wt = ninv * np.asarray(filt.templates[t], dtype=np.float64)
            RWc = Wt @ cosm                                   # (nrings, Ld+1)
            RWs = Wt @ sinm
            U[t, ls ** 2] = np.einsum('lj,j->l', D[:, 0, :], RWc[:, 0])
            for m in range(1, Ld + 1):
                lm = np.arange(m, Ld + 1)   # rlm slots l^2+2m-1/2m exist only for l >= m
                U[t, lm ** 2 + 2 * m - 1] = rt2 * np.einsum('lj,j->l',
                                                            D[lm, m, :], RWc[:, m])
                U[t, lm ** 2 + 2 * m] = -rt2 * np.einsum('lj,j->l',
                                                         D[lm, m, :], RWs[:, m])
        M -= U.T @ np.asarray(filt.PtNP_inv) @ U

    lof = _rlm_l_of(Ld)
    bl = np.asarray(bdl, dtype=np.float64)[lof]
    M = bl[:, None] * M * bl[None, :]
    M[np.arange(nr), np.arange(nr)] += cli(np.asarray(dl, dtype=np.float64))[lof]
    return 0.5 * (M + M.T)


def _dense_inverse(M, probe_noise=0.):
    """Eigen-pseudo-inverse of a dense block. `probe_noise`: relative matrix noise level
    (nonzero for f32-probed blocks); eigenvalues below a few x that level are unreliable
    and their inverses are clamped instead of amplifying the noise."""
    eigv, eigw = np.linalg.eigh(M)
    lmax_abs = np.max(np.abs(eigv))
    keep = eigv > 1e-12 * lmax_abs
    floor = max(3. * probe_noise, 1e-14) * lmax_abs
    inv = 1. / np.maximum(eigv[keep], floor)
    return (eigw[:, keep] * inv) @ eigw[:, keep].T


class _RlmMap:
    """The real-harmonic (rlm) vector of the l <= lmax_dense part of full-band (lmax)
    alms, and back, by gathers on `device`: `to_rlm(a)` is
    ualm.alm2rlm(ualm.alm_copy(a, lmax, lmax_dense), lmax_dense) and `from_rlm` is
    ualm.alm_copy(ualm.rlm2alm(x, lmax_dense), lmax_dense, lmax), with the index maps
    uploaded once."""

    def __init__(self, lmax_dense, lmax, device):
        src, imag, scale, re_idx, im_idx, has_im, inv_scale = ualm._rlm_maps(lmax_dense)
        ls_d, ms_d = ualm._lm_indices(lmax_dense)
        full = ualm.getidx(lmax, ls_d, ms_d)   # the lmax position of each dense slot
        self.nalm = ualm.getsize(lmax)

        def dev(a, dt=None):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=device)
        self.src = dev(full[src])
        self.imag = dev(imag)
        self.scale = dev(scale, torch.float64)
        self.re_idx, self.im_idx = dev(re_idx), dev(im_idx)
        self.has_im = dev(has_im, torch.float64)
        self.inv_scale = dev(inv_scale, torch.float64)
        self.dst = dev(full)

    def to_rlm(self, a):
        g = a[..., self.src]
        return torch.where(self.imag, g.imag, g.real) * self.scale.to(g.real.dtype)

    def from_rlm(self, x, cdtype):
        re = x[..., self.re_idx]
        im = x[..., self.im_idx] * self.has_im.to(x.dtype)
        x_d = (torch.complex(re, im) * self.inv_scale).to(cdtype)
        out = torch.zeros(x.shape[:-1] + (self.nalm,), dtype=cdtype, device=x.device)
        out[..., self.dst] = x_d
        return out


def _dense_apply(Minv, lmax_dense, lmax, device):
    """pre_op applying the inverted dense block to the l <= lmax_dense part: on (batch,
    nalm) vectors, or on stacked (batch, ncomp, nalm) ones with one coupled block. Minv is
    uploaded once and applied in f64; the result has its input's dtype."""
    rm = _RlmMap(lmax_dense, lmax, device)
    MinvT = torch.as_tensor(np.ascontiguousarray(np.asarray(Minv, dtype=np.float64).T),
                            device=device)

    def pre_op(r):
        bsz = r.shape[0]
        rr = rm.to_rlm(r).reshape(bsz, -1).to(torch.float64)
        xr = (rr @ MinvT).reshape(r.shape[:-1] + (-1,))
        return rm.from_rlm(xr, r.dtype)
    return pre_op


def dense_pre_op_analytic_t(filt, lmax_dense, lmax, dl, bdl, cacher=None, cache_key=None):
    """Dense low-l preconditioner from the analytic f64 block (see dense_block_analytic_t),
    the CinvT default, on the filter's device. A cacher holding `cache_key` (from either
    package) serves the inverted block instead."""
    if cacher is not None and cache_key is not None and cacher.is_cached(cache_key):
        Minv = np.asarray(cacher.load(cache_key))
    else:
        M = dense_block_analytic_t(filt, lmax_dense, dl[:lmax_dense + 1],
                                   bdl[:lmax_dense + 1])
        Minv = _dense_inverse(M)
        if cacher is not None and cache_key is not None:
            cacher.cache(cache_key, Minv)
    return _dense_apply(Minv, lmax_dense, lmax, filt.device)


def probe_chunk(geom, lmax, ncomp, dtype):
    """Basis vectors a probe applies the forward op to at once: `PROBE_BUDGET` over the
    memory one vector's forward apply holds at its peak, taken as 4 complex alms and 4
    complex maps of the grid per component (1 to 256)."""
    csize = torch.finfo(dtype).bits // 4
    per_vec = ncomp * 4 * (ualm.getsize(lmax) + geom.nrings * geom.nphi) * csize
    return int(max(1, min(256, PROBE_BUDGET // per_vec)))


def _probe(fwd_op, lmax_dense, lmax, ncomp, chunk, dtype, device):
    """(n, n) matrix of fwd_op on every (component, rlm) basis vector, n = ncomp
    (lmax_dense+1)^2, row j = the rlm vector of fwd_op(e_j) at l <= lmax_dense, flat index
    c * nrlm + r. fwd_op acts on alms of band limit lmax. The basis is made chunk by chunk
    on the device and every apply is cut to l <= lmax_dense at once, so only `chunk`
    full-band vectors are ever alive."""
    nrlm = (lmax_dense + 1) ** 2
    n = ncomp * nrlm
    rm = _RlmMap(lmax_dense, lmax, device)
    cdt = _CDTYPE[dtype]
    rows = []
    for i in range(0, n, chunk):
        j = torch.arange(i, min(n, i + chunk), device=device)
        e = torch.zeros((len(j), ncomp, nrlm), dtype=dtype, device=device)
        e[torch.arange(len(j), device=device), j // nrlm, j % nrlm] = 1.
        basis = rm.from_rlm(e, cdt)
        out = fwd_op(basis if ncomp > 1 else basis[:, 0])
        rows.append(rm.to_rlm(out).reshape(len(j), n).to(torch.float64).cpu().numpy())
        del basis, out
    M = np.concatenate(rows, axis=0)
    return 0.5 * (M + M.T)


def dense_pre_op_stacked(fwd_op, lmax_dense, lmax, ncomp, chunk=256, cacher=None,
                         cache_key=None, dtype=torch.float64, *, device, op_lmax=None):
    """Dense low-l preconditioner of a stacked (batch, ncomp, nalm) operator (E/B pairs,
    T/E/B triplets): probe the coupled operator on every (component, real-harmonic) basis
    vector with batched applies of `chunk` vectors (the columns do not depend on it;
    `probe_chunk` sizes it for a grid), eigendecompose the (ncomp nrlm) x (ncomp nrlm)
    matrix, pseudo-invert (role of reference plancklens/qcinv/dense.py:123-285
    pre_op_dense_pp). The preconditioner acts on alms of band limit lmax; `fwd_op` acts on
    those of `op_lmax` (default lmax), which may be any band limit >= lmax_dense: the same
    operator built at op_lmax = lmax_dense on the same grid has the same low-l block, for
    a fraction of the probe's cost. cacher/cache_key persist the inverted matrix."""
    if cacher is not None and cache_key is not None and cacher.is_cached(cache_key):
        Minv = np.asarray(cacher.load(cache_key))
    else:
        M = _probe(fwd_op, lmax_dense, lmax if op_lmax is None else op_lmax, ncomp, chunk,
                   dtype, _resolve_device(device))
        # f32 probing leaves ~1e-6 relative noise in M: clamp the noisy small-eigenvalue
        # subspace (it destroyed the f32 preconditioner outright, cf.
        # dense_block_analytic_t)
        Minv = _dense_inverse(M, probe_noise=1e-6 if dtype == torch.float32 else 0.)
        if cacher is not None and cache_key is not None:
            cacher.cache(cache_key, Minv)
    return _dense_apply(Minv, lmax_dense, lmax, _resolve_device(device))


def dense_pre_op(fwd_op, lmax_dense, lmax, chunk=512, cacher=None, cache_key=None,
                 dtype=torch.float64, *, device):
    """`dense_pre_op_stacked` of a (batch, nalm) operator: the (lmax_dense+1)^2 block
    (reference: plancklens/qcinv/dense.py:57-119)."""
    return dense_pre_op_stacked(fwd_op, lmax_dense, lmax, 1, chunk=chunk, cacher=cacher,
                                cache_key=cache_key, dtype=dtype, device=device)


def split_pre_op(low_op, diag_op, lmax_split, lmax, *, device):
    """Apply low_op below lmax_split, diag_op above (reference:
    plancklens/qcinv/multigrid.py:163-182). Works on (batch, nalm) and stacked
    (batch, ncomp, nalm) vectors alike (the l mask broadcasts over components)."""
    low = ualm._dev_index(lmax, _resolve_device(device), 'l') <= lmax_split

    def pre_op(r):
        return torch.where(low, low_op(r.masked_fill(~low, 0)),
                           diag_op(r.masked_fill(low, 0)))

    return pre_op


class CinvT:
    """Temperature cinv filter (reference: plancklens/filt/filt_cinv.py:56-203).

    Args:
        lmax: band limit of the reconstruction
        geom: map geometry
        cl: dict with 'tt' fiducial spectrum
        transf: beam transfer function
        ninv: (nrings, nphi) inverse pixel-variance map (any read_map spec)
        eps_min: CG convergence criterion (relative residual)
        lmax_dense: band limit of the dense low-l preconditioner block (0 to disable)
        dense_cacher: cacher of the inverted dense block (keys shared with the reference)
        dtype: real dtype of the system (torch.float64 or torch.float32)
        device: where the operators and the solve run
    """

    def __init__(self, lmax, geom, cl, transf, ninv, marge_monopole=True, marge_dipole=True,
                 eps_min=1e-5, iter_max=300, lmax_dense=64, dense_cacher=None,
                 dtype=torch.float64, *, device):
        self.lmax = lmax
        self.geom = geom
        self.cl = cl
        self.dtype = dtype
        self.device = _resolve_device(device)
        self.transf = np.asarray(transf)[:lmax + 1]
        self.filt = NinvFilterT(geom, ninv, self.transf, marge_monopole=marge_monopole,
                                marge_dipole=marge_dipole, dtype=dtype, device=self.device)
        self.eps_min = eps_min
        self.iter_max = iter_max
        self.fwd_op, self.calc_prep, self.pre_diag, (self.rescal_cl, self.dl) = \
            self.filt.make_ops(lmax, cl['tt'])
        self._ms = torch.as_tensor(_lm_ms(lmax), device=self.device)
        self._ivf_fl = _fl_alm(self.rescal_cl * cli(self.dl), lmax, dtype, self.device)
        if lmax_dense > 0:
            # the template stack (marge flags + extra templates) enters the operator via
            # the deprojection: it is part of the key
            key = _dense_cache_key('tta', lmax_dense, lmax,
                                   [self.filt.ninv, self.cl['tt'][:lmax + 1], self.transf,
                                    self.filt.templates.ravel(),
                                    [float(self.filt.templates.shape[0])]])
            ld = min(lmax_dense, lmax)
            # bdl of the rescaled system: beam x 1/rescal (cf. make_ops)
            bdl = self.transf[:lmax + 1] * cli(self.rescal_cl)
            dense = dense_pre_op_analytic_t(self.filt, ld, lmax, self.dl, bdl,
                                            cacher=dense_cacher, cache_key=key)
            self.pre_op = split_pre_op(dense, self.pre_diag, ld, lmax, device=self.device)
        else:
            self.pre_op = self.pre_diag

    def hashdict(self):
        return {'lmax': self.lmax, 'cltt': clhash(self.cl['tt'][:self.lmax + 1]),
                'transf': clhash(self.transf), 'ninv': self.filt.hashdict(),
                'eps': self.eps_min}

    def get_ftl(self):
        """Isotropic approximation to the filtering (reference: filt_cinv.py:157-175)."""
        nlev = self.filt.nlev_ftl
        ftl = cli(self.cl['tt'][:self.lmax + 1]
                  + (nlev / 60. / 180. * np.pi) ** 2 * cli(self.transf ** 2))
        if self.filt.PtNP_inv is not None:
            ftl[:2] *= 0.
        return ftl

    def get_tal(self):
        return cli(self.transf)

    def get_fmask(self):
        return np.where(self.filt.ninv > 0, 1., 0.)

    def solve_wf(self, tmaps, x0=None, monitor=None):
        """Rescaled Wiener solution (x, n_iter, rel) of the system for (batch, nrings,
        nphi) maps (numpy, or tensors on the filter's device). With `monitor` (e.g.
        ops/cg.monitor_basic) the solve runs cg.pcg_monitored."""
        tmaps = _maps_in(tmaps, self.device, self.dtype)
        if tmaps.ndim == 2:
            tmaps = tmaps[None]
        b = self.calc_prep(tmaps)
        x0 = torch.zeros_like(b) if x0 is None else _on_device(x0, self.device).to(b.dtype)
        if monitor is not None:
            return cg.pcg_monitored(self.fwd_op, self.pre_op, b, x0, self._ms, monitor)
        return cg.pcg(self.fwd_op, self.pre_op, b, x0, self.iter_max, self.eps_min, self._ms)

    def apply_ivf(self, tmaps, x0=None, ret_it=False, ret_wf=False):
        """bar t = C^{-1}-weighted inverse-variance filtered alms of the input maps.

        x0 warm-starts the CG; ret_wf additionally returns the rescaled Wiener solution
        (reusable as the next x0, reference filt_cinv.py:196-203)."""
        x, it, rel = self.solve_wf(tmaps, x0=x0)
        # x solves the rescaled system; the ivf alm is x * rescal_cl / dl
        out = x * self._ivf_fl
        extras = ((it, rel) if ret_it else ()) + ((x,) if ret_wf else ())
        return (out,) + extras if extras else out


class NinvFilterP:
    """Polarisation (Q, U) pixel-space inverse-noise filtering, spin 2
    (reference: plancklens/qcinv/opfilt_pp.py:113-303).

    ninv is either a (nrings, nphi) map spec (QQ = UU, QU = 0) or a triplet (QQ, QU, UU)
    of them. `templates_q` / `templates_u` are lists of (nrings, nphi) maps living purely
    in Q (resp. U); their pixel modes are projected out of N^{-1} exactly, via
    (P^T N^{-1} P)^{-1}.
    """

    def __init__(self, geom, ninv, b_transf, templates_q=None, templates_u=None,
                 dtype=torch.float64, *, device):
        from ..utils.maps import read_map
        self.geom = geom
        self.dtype = dtype
        self.device = _resolve_device(device)
        shape = (geom.nrings, geom.nphi)
        if isinstance(ninv, (list, tuple)):
            # (QQ,) or (QQ, QU, UU); each entry itself a map spec
            if len(ninv) not in (1, 3):
                raise ValueError('ninv: one map or a (QQ, QU, UU) triplet, got %d' % len(ninv))
            qq = read_map(ninv[0]).reshape(shape)
            if len(ninv) == 3:
                qu = read_map(ninv[1]).reshape(shape)
                uu = read_map(ninv[2]).reshape(shape)
            else:
                qu, uu = np.zeros_like(qq), qq.copy()
        else:
            qq = read_map(ninv).reshape(shape)
            qu, uu = np.zeros_like(qq), qq.copy()
        self.ninv = (qq, qu, uu)
        self.b_transf = np.asarray(b_transf)
        omega = _omega(geom)
        # unmasked-sky normalisation, as for the T filter (reference filt_cinv.py:455-458)
        omega_nnz = float(np.sum(omega[(qq > 0) | (uu > 0)]))
        self.nlev_ftl = 10800. / np.sqrt(np.sum(0.5 * (qq + uu))
                                         / max(omega_nnz, 1e-300)) / np.pi
        # (ntempl, 2, nrings, nphi) stack of QU-space template maps
        tmpl = []
        for tq in (templates_q or []):
            tmpl.append(np.stack([np.asarray(tq), np.zeros_like(np.asarray(tq))]))
        for tu in (templates_u or []):
            tmpl.append(np.stack([np.zeros_like(np.asarray(tu)), np.asarray(tu)]))
        self.templates = np.stack(tmpl) if tmpl \
            else np.zeros((0, 2, geom.nrings, geom.nphi))
        if tmpl:
            # N^{-1} P in per-pixel units
            ninv_mat = np.stack([np.stack([qq, qu]), np.stack([qu, uu])])  # (2,2,r,p)
            NP = np.einsum('abrp,tbrp->tarp', ninv_mat, self.templates)
            PtNP = np.einsum('tarp,sarp->ts', self.templates, NP)
            eigv, eigw = np.linalg.eigh(PtNP)
            self.PtNP_inv = eigw @ np.diag(cli(eigv)) @ eigw.T
        else:
            self.PtNP_inv = None

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=self.device)
        self._st = tuple(dev(m / omega) for m in self.ninv)
        # QU = 0 (one ninv map): the cross terms add exact zeros, so they are skipped
        self._cross = bool(np.any(qu))
        self._omega = dev(omega)
        if self.PtNP_inv is not None:
            self._tmpl = dev(self.templates)
            self._PtNP_inv_T = dev(self.PtNP_inv.T)

    def hashdict(self):
        return {'ninv': [clhash(m) for m in self.ninv], 'b_transf': clhash(self.b_transf),
                'ntempl': int(self.templates.shape[0]), 'geom': self.geom.hashdict()}

    def _nmul(self, q, u):
        qq, qu, uu = self._st
        if self._cross:
            return q * qq + u * qu, q * qu + u * uu
        return q * qq, u * uu

    def apply_map(self, qmap, umap):
        """N^{-1} (Q, U) with template modes deprojected, per-steradian units, on (batch,
        nrings, nphi) tensors on the filter's device."""
        nq, nu = self._nmul(qmap, umap)
        if self.PtNP_inv is not None:
            # deproject template modes (per-pixel units, as in the T filter)
            pix = torch.stack([nq, nu], dim=1) * self._omega             # (b, 2, r, p)
            coeffs = torch.einsum('tarp,barp->bt', self._tmpl, pix) @ self._PtNP_inv_T
            modes = torch.einsum('bt,tarp->barp', coeffs, self._tmpl)
            # N^{-1} modes in per-steradian units: the _st maps already carry 1/omega
            mq, mu = self._nmul(modes[:, 0], modes[:, 1])
            nq, nu = nq - mq, nu - mu
        return nq, nu

    def make_ops(self, lmax, s_clee, s_clbb, rescal_cl=None):
        """(fwd_op, calc_prep, pre_op_diag, (rescal_cl, dle, dlb)) on stacked (batch, 2,
        nalm) E/B alms."""
        if rescal_cl is None:
            rescal_cl = _default_rescal(lmax)
        dle = rescal_cl ** 2 * s_clee[:lmax + 1]
        dlb = rescal_cl ** 2 * s_clbb[:lmax + 1]
        bdl = self.b_transf[:lmax + 1] * cli(rescal_cl)
        sht = SHT(self.geom, lmax, dtype=self.dtype, device=self.device)

        def fl2(fe, fb):
            return torch.stack([_fl_alm(fe, lmax, self.dtype, self.device),
                                _fl_alm(fb, lmax, self.dtype, self.device)])
        si = fl2(cli(dle), cli(dlb))
        bdlj = _fl_alm(bdl, lmax, self.dtype, self.device)

        def analysis(q, u):
            e, b = sht.map2alm_spin(self.apply_map(q, u), 2)
            return torch.stack([e, b], dim=1) * bdlj

        def fwd_op(x):
            y = x * bdlj
            return x * si + analysis(*sht.alm2map_spin((y[:, 0], y[:, 1]), 2))

        def calc_prep(qmaps, umaps):
            return analysis(_maps_in(qmaps, self.device, self.dtype),
                            _maps_in(umaps, self.device, self.dtype))

        qq, qu, uu = self.ninv
        ninv_cl = np.sum(0.5 * (qq + uu)) / (4. * np.pi)
        diag = fl2(cli(cli(dle) + ninv_cl * bdl ** 2), cli(cli(dlb) + ninv_cl * bdl ** 2))

        def pre_op_diag(r):
            return r * diag

        return fwd_op, calc_prep, pre_op_diag, (rescal_cl, dle, dlb)


class CinvP:
    """Polarisation cinv filter (reference: plancklens/filt/filt_cinv.py:206-338).

    lmax_dense > 0 enables the dense low-l preconditioner of the coupled E/B operator
    (role of reference dense.py pre_op_dense_pp), probed on the filter's device in chunks
    of `probe_chunk(geom, lmax, 2, dtype)` basis vectors; templates_q/u marginalise Q/U
    pixel modes. dtype and device as for CinvT."""

    def __init__(self, lmax, geom, cl, transf, ninv, eps_min=1e-5, iter_max=300,
                 lmax_dense=0, templates_q=None, templates_u=None, dense_cacher=None,
                 dtype=torch.float64, *, device):
        self.lmax = lmax
        self.geom = geom
        self.cl = cl
        self.dtype = dtype
        self.device = _resolve_device(device)
        self.transf = np.asarray(transf)[:lmax + 1]
        self.filt = NinvFilterP(geom, ninv, self.transf, templates_q=templates_q,
                                templates_u=templates_u, dtype=dtype, device=self.device)
        self.eps_min = eps_min
        self.iter_max = iter_max
        self.fwd_op, self.calc_prep, self.pre_diag, (self.rescal_cl, self.dle, self.dlb) = \
            self.filt.make_ops(lmax, cl['ee'], cl['bb'])
        ms = _lm_ms(lmax)
        self._ms2 = torch.as_tensor(np.concatenate([ms, ms]), device=self.device)
        self._ivf_fl = torch.stack([_fl_alm(self.rescal_cl * cli(dl), lmax, dtype, self.device)
                                    for dl in (self.dle, self.dlb)])
        if lmax_dense > 0:
            key = _dense_cache_key('pp', lmax_dense, lmax,
                                   list(self.filt.ninv) + [self.cl['ee'][:lmax + 1],
                                                           self.cl['bb'][:lmax + 1],
                                                           self.transf,
                                                           self.filt.templates.ravel(),
                                                           [float(self.filt.templates
                                                                  .shape[0])]])
            ld = min(lmax_dense, lmax)
            dense = dense_pre_op_stacked(self.fwd_op, ld, lmax, 2,
                                         chunk=probe_chunk(geom, lmax, 2, dtype),
                                         cacher=dense_cacher, cache_key=key, dtype=dtype,
                                         device=self.device)
            self.pre_op = split_pre_op(dense, self.pre_diag, ld, lmax, device=self.device)
        else:
            self.pre_op = self.pre_diag

    def hashdict(self):
        return {'lmax': self.lmax, 'clee': clhash(self.cl['ee'][:self.lmax + 1]),
                'clbb': clhash(self.cl['bb'][:self.lmax + 1]),
                'transf': clhash(self.transf), 'ninv': self.filt.hashdict()}

    def _fl(self, key):
        nlev = self.filt.nlev_ftl
        fl = cli(self.cl[key][:self.lmax + 1]
                 + (nlev / 60. / 180. * np.pi) ** 2 * cli(self.transf ** 2))
        fl[:2] *= 0.
        return fl

    def get_fel(self):
        return self._fl('ee')

    def get_fbl(self):
        return self._fl('bb')

    def get_fmask(self):
        qq, _, uu = self.filt.ninv
        return np.where((qq > 0) | (uu > 0), 1., 0.)

    def solve_wf(self, qmaps, umaps, x0=None):
        """Rescaled (batch, 2, nalm) E/B Wiener solution (x, n_iter, rel), solved as one
        (batch, 2 nalm) vector a row."""
        qmaps = _maps_in(qmaps, self.device, self.dtype)
        umaps = _maps_in(umaps, self.device, self.dtype)
        if qmaps.ndim == 2:
            qmaps, umaps = qmaps[None], umaps[None]
        b = self.calc_prep(qmaps, umaps)
        x0 = torch.zeros_like(b) if x0 is None else _on_device(x0, self.device).to(b.dtype)
        shape = b.shape
        bsz = shape[0]

        def fwd_flat(xf):
            return self.fwd_op(xf.reshape(shape)).reshape(bsz, -1)

        def pre_flat(rf):
            return self.pre_op(rf.reshape(shape)).reshape(bsz, -1)

        xf, it, rel = cg.pcg(fwd_flat, pre_flat, b.reshape(bsz, -1),
                             x0.expand(shape).reshape(bsz, -1), self.iter_max,
                             self.eps_min, self._ms2)
        return xf.reshape(shape), it, rel

    def apply_ivf(self, qmaps, umaps, x0=None, ret_it=False, ret_wf=False):
        """(bar e, bar b) = C^{-1}-weighted inverse-variance filtered E/B alms.

        x0 warm-starts the CG from a previous rescaled Wiener solution; with ret_wf the
        solution is returned too (for a solution library, reference
        filt_cinv.py:196-203)."""
        x, it, rel = self.solve_wf(qmaps, umaps, x0=x0)
        eb = x * self._ivf_fl
        out = (eb[:, 0], eb[:, 1])
        extras = ((it, rel) if ret_it else ()) + ((x,) if ret_wf else ())
        return (out,) + extras if extras else out


class IVFCinv:
    """ivfs-interface adapter over CinvT/CinvP instances filtering a map-space sim library
    (reference: plancklens/filt/filt_cinv.py:515-626). It filters one sim at a time, as the
    reference does: a lockstep solve over several sims would let the early ones keep
    refining, a different result. Alms are returned on the filters' device.

    `cacher` persists the filtered alms (restartability); `soltn_cacher` persists the raw
    CG solutions so re-runs warm-start the solver instead of starting from zero (role of
    the reference's soltn_lib, filt_cinv.py:196-203, filt_simple.py:27-33)."""

    def __init__(self, cinv_t, cinv_p, sim_lib, cl_weights, cacher=None,
                 soltn_cacher=None):
        self.cinv_t = cinv_t
        self.cinv_p = cinv_p
        self.sim_lib = sim_lib
        self.cl = cl_weights
        self._cache = {}
        self.cacher = cacher
        self.soltn_cacher = soltn_cacher
        self.device = (cinv_t if cinv_t is not None else cinv_p).device

    def _load(self, cacher, name):
        return torch.as_tensor(np.asarray(cacher.load(name))).to(self.device)

    def _soltn(self, name):
        if self.soltn_cacher is not None and self.soltn_cacher.is_cached(name):
            return self._load(self.soltn_cacher, name)
        return None

    def _store_soltn(self, name, x):
        if self.soltn_cacher is not None:
            self.soltn_cacher.cache(name, x.cpu().numpy())

    def hashdict(self):
        return {'cinv_t': self.cinv_t.hashdict() if self.cinv_t else 0,
                'cinv_p': self.cinv_p.hashdict() if self.cinv_p else 0,
                'sims': self.sim_lib.hashdict()}

    def get_ftl(self):
        if self.cinv_t is None:
            raise ValueError('pol-only IVFCinv (cinv_t=None) has no temperature ftl')
        return self.cinv_t.get_ftl()

    def get_fel(self):
        if self.cinv_p is None:
            raise ValueError('T-only IVFCinv (cinv_p=None) has no polarisation fel')
        return self.cinv_p.get_fel()

    def get_fbl(self):
        if self.cinv_p is None:
            raise ValueError('T-only IVFCinv (cinv_p=None) has no polarisation fbl')
        return self.cinv_p.get_fbl()

    def get_tal(self, a):
        cinv = self.cinv_t if a == 't' else self.cinv_p
        if cinv is None:
            raise ValueError('IVFCinv has no %s sub-filter: cannot return tal(%r)'
                             % ('temperature' if a == 't' else 'polarisation', a))
        return cli(cinv.transf)

    def get_fmask(self):
        # pol-only libraries (cinv_t=None) report the polarisation mask
        return self.cinv_t.get_fmask() if self.cinv_t is not None \
            else self.cinv_p.get_fmask()

    def get_sim_tlm(self, idx):
        key = ('t', idx)
        if key not in self._cache:
            fn = 'ivf_tlm_%05d' % idx
            if self.cacher is not None and self.cacher.is_cached(fn):
                self._cache[key] = self._load(self.cacher, fn)
            else:
                tmap = self.sim_lib.get_sim_tmap(idx)
                out, x = self.cinv_t.apply_ivf(tmap, x0=self._soltn('wf_t_%05d' % idx),
                                               ret_wf=True)
                self._store_soltn('wf_t_%05d' % idx, x)
                self._cache[key] = out[0]
                if self.cacher is not None:
                    self.cacher.cache(fn, out[0].cpu().numpy())
        return self._cache[key]

    def _eb(self, idx):
        key = ('eb', idx)
        if key not in self._cache:
            fn_e, fn_b = 'ivf_elm_%05d' % idx, 'ivf_blm_%05d' % idx
            # gate the cached branch on *both* files so a crash between the two writes
            # falls back to recomputation instead of failing on the missing half
            if self.cacher is not None and self.cacher.is_cached(fn_e) \
                    and self.cacher.is_cached(fn_b):
                self._cache[key] = (self._load(self.cacher, fn_e),
                                    self._load(self.cacher, fn_b))
            else:
                q, u = self.sim_lib.get_sim_pmap(idx)
                (e, b), x = self.cinv_p.apply_ivf(q, u, x0=self._soltn('wf_p_%05d' % idx),
                                                  ret_wf=True)
                self._store_soltn('wf_p_%05d' % idx, x)
                self._cache[key] = (e[0], b[0])
                if self.cacher is not None:
                    self.cacher.cache(fn_b, b[0].cpu().numpy())
                    self.cacher.cache(fn_e, e[0].cpu().numpy())
        return self._cache[key]

    def get_sim_elm(self, idx):
        return self._eb(idx)[0]

    def get_sim_blm(self, idx):
        return self._eb(idx)[1]

    def get_sim_tmliklm(self, idx):
        lmax = self.cinv_t.lmax
        return ualm.almxfl(self.get_sim_tlm(idx), lmax, self.cl['tt'][:lmax + 1])

    def get_sim_emliklm(self, idx):
        lmax = self.cinv_p.lmax
        return ualm.almxfl(self.get_sim_elm(idx), lmax, self.cl['ee'][:lmax + 1])

    def get_sim_bmliklm(self, idx):
        lmax = self.cinv_p.lmax
        return ualm.almxfl(self.get_sim_blm(idx), lmax, self.cl['bb'][:lmax + 1])


def p2k_fl(lmax):
    """phi -> kappa scaling l(l+1)/2 (reference: plancklens/qcinv/opfilt_kk.py:29-45)."""
    ls = np.arange(lmax + 1, dtype=float)
    return 0.5 * ls * (ls + 1.)


class CinvKK(CinvT):
    """Wiener filter for reconstructed lensing-convergence maps: the spin-0 cinv machinery
    with C_L^kk = [L(L+1)/2]^2 C_L^pp spectra (reference: plancklens/qcinv/opfilt_kk.py).

    Args:
        lmax, geom, transf, ninv: as CinvT (and its keywords, device among them)
        clpp: lensing potential spectrum (converted to kappa internally)
    """

    def __init__(self, lmax, geom, clpp, transf, ninv, *, device, **kwargs):
        clkk = {'tt': p2k_fl(lmax) ** 2 * np.asarray(clpp)[:lmax + 1]}
        super().__init__(lmax, geom, clkk, transf, ninv, device=device, **kwargs)


def template_uptolmin(geom, lmin, *, device):
    """All real-harmonic modes with l <= lmin as pixel-space template maps, for full
    low-l marginalisation (reference: plancklens/qcinv/template_removal.py
    template_uptolmin): ((lmin+1)^2, nrings, nphi) host numpy, synthesised on `device`."""
    sht = SHT(geom, lmin, device=device)
    rlm = torch.eye((lmin + 1) ** 2, dtype=torch.float64, device=sht.device)
    return sht.alm2map(ualm.rlm2alm(rlm, lmin)).cpu().numpy()


class NinvFilterTP:
    """Joint T/E/B pixel-space inverse-noise filtering (reference:
    plancklens/qcinv/opfilt_tp.py:164-326): T and (Q, U) noise treated jointly with the
    full 3x3 per-multipole signal matrix (including TE) in the prior. T is filtered by a
    NinvFilterT (monopole/dipole/extra templates), Q/U by a NinvFilterP (Q/U templates).

    The 3x3 pseudo-inverses are taken on the host in f64 numpy, once per operator set, as
    the reference takes them (S is singular at l < 2 in E/B), and applied as six per-l
    vectors on the device (utils.alm.TEBMatrix)."""

    def __init__(self, geom, ninv_t, ninv_p, b_transf, marge_monopole=False,
                 marge_dipole=False, templates_t=None, templates_q=None, templates_u=None,
                 dtype=torch.float64, *, device):
        self.geom = geom
        self.dtype = dtype
        self.device = _resolve_device(device)
        self.filt_t = NinvFilterT(geom, ninv_t, b_transf, marge_monopole=marge_monopole,
                                  marge_dipole=marge_dipole, templates=templates_t,
                                  dtype=dtype, device=self.device)
        self.filt_p = NinvFilterP(geom, ninv_p, b_transf, templates_q=templates_q,
                                  templates_u=templates_u, dtype=dtype, device=self.device)
        self.b_transf = np.asarray(b_transf)
        self.nlev_ftl = self.filt_t.nlev_ftl
        self.nlev_fpl = self.filt_p.nlev_ftl

    def hashdict(self):
        return {'t': self.filt_t.hashdict(), 'p': self.filt_p.hashdict()}

    def make_ops(self, lmax, cls, rescal_cl=None):
        """(fwd_op, calc_prep, pre_op, (rescal_cl, S)) on stacked (batch, 3, nalm) T/E/B
        alms; S is the rescaled (lmax+1, 3, 3) signal matrix of cls' 'tt', 'ee', 'bb' and
        'te'. The forward op costs one spin-0 and one spin-2 synthesis and analysis."""
        if rescal_cl is None:
            rescal_cl = _default_rescal(lmax)
        S = cldict2arr({k: cls[k][:lmax + 1] for k in ['tt', 'ee', 'bb', 'te']
                        if k in cls})[:, :, :lmax + 1]
        S = np.moveaxis(S, -1, 0) * (rescal_cl ** 2)[:, None, None]
        Sinv = np.linalg.pinv(S)
        bdl = self.b_transf[:lmax + 1] * cli(rescal_cl)
        sht = SHT(self.geom, lmax, dtype=self.dtype, device=self.device)
        sinv = ualm.TEBMatrix(Sinv, lmax, self.dtype, device=self.device)
        bdlj = _fl_alm(bdl, lmax, self.dtype, self.device)

        def analysis(tmap, qmap, umap):
            t = sht.map2alm(self.filt_t.apply_map(tmap))
            e, b = sht.map2alm_spin(self.filt_p.apply_map(qmap, umap), 2)
            return torch.stack([t, e, b], dim=1) * bdlj

        def fwd_op(x):
            y = x * bdlj
            return sinv(x) + analysis(sht.alm2map(y[:, 0]),
                                      *sht.alm2map_spin((y[:, 1], y[:, 2]), 2))

        def calc_prep(tmaps, qmaps, umaps):
            return analysis(*(_maps_in(m, self.device, self.dtype)
                              for m in (tmaps, qmaps, umaps)))

        # 3x3 diagonal-in-l preconditioner: (Sinv + mean ninv b^2 I)^-1
        nt = np.sum(self.filt_t.ninv) / (4. * np.pi)
        qq, _, uu = self.filt_p.ninv
        npol = np.sum(0.5 * (qq + uu)) / (4. * np.pi)
        M = Sinv.copy()
        M[:, 0, 0] += nt * bdl ** 2
        M[:, 1, 1] += npol * bdl ** 2
        M[:, 2, 2] += npol * bdl ** 2
        pre_op = ualm.TEBMatrix(np.linalg.pinv(M), lmax, self.dtype, device=self.device)
        return fwd_op, calc_prep, pre_op, (rescal_cl, S)


class CinvTP:
    """Joint T/E/B cinv filter (reference: plancklens/filt/filt_cinv.py:341-512).

    lmax_dense > 0 adds the dense low-l preconditioner of the coupled 3x3 operator (role of
    reference dense.py pre_op_dense_tp), probed on the filter's device at band limit
    lmax_dense on the full grid (the same block as a probe of the full-band operator);
    marge/template kwargs go to the pixel-space N^{-1} blocks. dtype and device as for
    CinvT."""

    def __init__(self, lmax, geom, cls, transf, ninv_t, ninv_p, eps_min=1e-5,
                 iter_max=400, lmax_dense=0, marge_monopole=False, marge_dipole=False,
                 templates_t=None, templates_q=None, templates_u=None, dense_cacher=None,
                 dtype=torch.float64, *, device):
        self.lmax = lmax
        self.geom = geom
        self.cls = cls
        self.dtype = dtype
        self.device = _resolve_device(device)
        self.transf = np.asarray(transf)[:lmax + 1]
        self.filt = NinvFilterTP(geom, ninv_t, ninv_p, self.transf,
                                 marge_monopole=marge_monopole, marge_dipole=marge_dipole,
                                 templates_t=templates_t, templates_q=templates_q,
                                 templates_u=templates_u, dtype=dtype, device=self.device)
        self.eps_min = eps_min
        self.iter_max = iter_max
        self.fwd_op, self.calc_prep, self.pre_diag, (self.rescal_cl, self._S) = \
            self.filt.make_ops(lmax, cls)
        # bar X = rescal * S_rescaled^{-1} x for the rescaled Wiener solution x
        self._ivf_sinv = ualm.TEBMatrix(np.linalg.pinv(self._S), lmax, dtype,
                                        device=self.device)
        self._ivf_fl = _fl_alm(self.rescal_cl, lmax, dtype, self.device)
        ms = _lm_ms(lmax)
        self._ms3 = torch.as_tensor(np.concatenate([ms] * 3), device=self.device)
        if lmax_dense > 0:
            ft, fp = self.filt.filt_t, self.filt.filt_p
            key = _dense_cache_key(
                'tp', lmax_dense, lmax,
                [ft.ninv] + list(fp.ninv)
                + [np.asarray(cls[k])[:lmax + 1] for k in sorted(cls)] + [self.transf]
                + [ft.templates.ravel(), [float(ft.templates.shape[0])],
                   fp.templates.ravel(), [float(fp.templates.shape[0])]])
            ld = min(lmax_dense, lmax)
            fwd_ld = self.filt.make_ops(ld, cls, rescal_cl=self.rescal_cl[:ld + 1])[0]
            dense = dense_pre_op_stacked(fwd_ld, ld, lmax, 3,
                                         chunk=probe_chunk(geom, ld, 3, dtype),
                                         cacher=dense_cacher, cache_key=key, dtype=dtype,
                                         device=self.device, op_lmax=ld)
            self.pre_op = split_pre_op(dense, self.pre_diag, ld, lmax, device=self.device)
        else:
            self.pre_op = self.pre_diag

    def hashdict(self):
        return {'lmax': self.lmax, 'transf': clhash(self.transf),
                'ninv': self.filt.hashdict(),
                **{k: clhash(self.cls[k][:self.lmax + 1]) for k in ['tt', 'ee', 'bb', 'te']
                   if k in self.cls}}

    def solve_wf(self, tmaps, qmaps, umaps, x0=None):
        """Rescaled (batch, 3, nalm) T/E/B Wiener solution (x, n_iter, rel) of (batch,
        nrings, nphi) maps, solved as one (batch, 3 nalm) vector a row."""
        maps = [_maps_in(m, self.device, self.dtype) for m in (tmaps, qmaps, umaps)]
        if maps[0].ndim == 2:
            maps = [m[None] for m in maps]
        b = self.calc_prep(*maps)
        x0 = torch.zeros_like(b) if x0 is None else _on_device(x0, self.device).to(b.dtype)
        shape = b.shape
        bsz = shape[0]

        def fwd_flat(xf):
            return self.fwd_op(xf.reshape(shape)).reshape(bsz, -1)

        def pre_flat(rf):
            return self.pre_op(rf.reshape(shape)).reshape(bsz, -1)

        xf, it, rel = cg.pcg(fwd_flat, pre_flat, b.reshape(bsz, -1),
                             x0.expand(shape).reshape(bsz, -1), self.iter_max,
                             self.eps_min, self._ms3)
        return xf.reshape(shape), it, rel

    def apply_ivf(self, tmaps, qmaps, umaps, x0=None, ret_it=False, ret_wf=False):
        """(bar t, bar e, bar b): jointly inverse-variance filtered alms, the rescaled
        Wiener solution mapped through the 3x3 S^{-1}. x0 warm-starts the CG; ret_wf also
        returns the rescaled Wiener solution."""
        x, it, rel = self.solve_wf(tmaps, qmaps, umaps, x0=x0)
        bar = self._ivf_sinv(x) * self._ivf_fl
        out = (bar[:, 0], bar[:, 1], bar[:, 2])
        extras = ((it, rel) if ret_it else ()) + ((x,) if ret_wf else ())
        return (out,) + extras if extras else out

    def get_fal(self):
        """Isotropic approximation to the joint 3x3 filtering matrix, per multipole
        (reference: plancklens/filt/filt_cinv.py:446-475 cinv_tp._calc_fal): fiducial
        signal covariance plus the mean white-noise level seen through the beam,
        pseudo-inverted per l on the host. A dict of the non-zero entries ('tt', 'te',
        'ee', 'bb', ...), a qresp/nhl fal argument or models.filt.IVFJTP's."""
        lmax = self.lmax
        fals = np.zeros((lmax + 1, 3, 3))
        for k, i, j in [('tt', 0, 0), ('te', 0, 1), ('tb', 0, 2), ('ee', 1, 1),
                        ('eb', 1, 2), ('bb', 2, 2)]:
            if k in self.cls:
                fals[:, i, j] = np.asarray(self.cls[k])[:lmax + 1]
                fals[:, j, i] = fals[:, i, j]
        nt = self.filt.nlev_ftl / 60. / 180. * np.pi
        npol = self.filt.nlev_fpl / 60. / 180. * np.pi
        ibl2 = cli(self.transf ** 2)
        fals[1:, 0, 0] += nt ** 2 * ibl2[1:]
        fals[2:, 1, 1] += npol ** 2 * ibl2[2:]
        fals[2:, 2, 2] += npol ** 2 * ibl2[2:]
        F = np.linalg.pinv(fals)
        out = {}
        for i, a in enumerate('teb'):
            for j, b in enumerate('teb'[i:]):
                if np.any(F[:, i, i + j]):
                    out[a + b] = F[:, i, i + j]
        return out

    def get_ftl(self):
        return self.get_fal()['tt']

    def get_fel(self):
        return self.get_fal()['ee']

    def get_fbl(self):
        return self.get_fal()['bb']

    def get_fmask(self):
        """Pixels unmasked in both the T and the P inverse-variance maps (reference:
        filt_cinv.py:477-482 calc_mask); QU is legitimately zero on unmasked pixels."""
        qq, _, uu = self.filt.filt_p.ninv
        return np.where((self.filt.filt_t.ninv > 0) & (qq > 0) & (uu > 0), 1., 0.)


class IVFCinvJTP:
    """ivfs-interface adapter over a joint CinvTP filter of a map-space sim library
    (reference: plancklens/filt/filt_cinv.py:585-626 library_cinv_jTP): one coupled T/E/B
    CG solve per sim feeds all three bar-alm accessors. The alms stay on the filter's
    device; `cacher` persists them as host numpy under the reference's names
    (ivf_{t,e,b}lm_%05d), `soltn_cacher` the raw CG solution (wf_tp_%05d), which a re-run
    warm-starts from."""

    def __init__(self, cinv_tp, sim_lib, cl_weights, cacher=None, soltn_cacher=None):
        self.cinv_tp = cinv_tp
        self.sim_lib = sim_lib
        self.cl = cl_weights
        self._cache = {}
        self.cacher = cacher
        self.soltn_cacher = soltn_cacher
        self.device = cinv_tp.device

    def hashdict(self):
        return {'cinv_tp': self.cinv_tp.hashdict(), 'sims': self.sim_lib.hashdict(),
                **{'clw_' + k: clhash(np.asarray(v)) for k, v in sorted(self.cl.items())}}

    def _load(self, cacher, name):
        return torch.as_tensor(np.asarray(cacher.load(name))).to(self.device)

    def get_fal(self):
        return self.cinv_tp.get_fal()

    def get_ftl(self):
        return self.cinv_tp.get_ftl()

    def get_fel(self):
        return self.cinv_tp.get_fel()

    def get_fbl(self):
        return self.cinv_tp.get_fbl()

    def get_tal(self, a):
        assert a.lower() in ['t', 'e', 'b']
        return cli(self.cinv_tp.transf)

    def get_fmask(self):
        return self.cinv_tp.get_fmask()

    def _teb(self, idx):
        key = ('teb', idx)
        if key not in self._cache:
            fns = ['ivf_%slm_%05d' % (a, idx) for a in 'teb']
            # gate on all three files so a crash mid-write falls back to recompute
            if self.cacher is not None and all(self.cacher.is_cached(f) for f in fns):
                self._cache[key] = tuple(self._load(self.cacher, f) for f in fns)
            else:
                tmap = self.sim_lib.get_sim_tmap(idx)
                q, u = self.sim_lib.get_sim_pmap(idx)
                fn_x = 'wf_tp_%05d' % idx
                sol = None
                if self.soltn_cacher is not None and self.soltn_cacher.is_cached(fn_x):
                    sol = self._load(self.soltn_cacher, fn_x)
                (t, e, b), x = self.cinv_tp.apply_ivf(tmap, q, u, x0=sol, ret_wf=True)
                if self.soltn_cacher is not None:
                    self.soltn_cacher.cache(fn_x, x.cpu().numpy())
                self._cache[key] = (t[0], e[0], b[0])
                if self.cacher is not None:
                    for f, a in zip(fns, self._cache[key]):
                        self.cacher.cache(f, a.cpu().numpy())
        return self._cache[key]

    def get_sim_tlm(self, idx):
        return self._teb(idx)[0]

    def get_sim_elm(self, idx):
        return self._teb(idx)[1]

    def get_sim_blm(self, idx):
        return self._teb(idx)[2]

    def get_sim_teblm_batch(self, idxs):
        outs = [self._teb(int(i)) for i in np.atleast_1d(idxs)]
        return tuple(torch.stack([o[i] for o in outs]) for i in range(3))

    def _wiener(self, idx, row):
        """Joint Wiener leg: row of C_w applied to (bar t, bar e, bar b), with the tb/eb
        legs whenever cl_weights has them (reference: filt_simple.py:293-342)."""
        t, e, b = self._teb(idx)
        lmax = self.cinv_tp.lmax
        z = np.zeros(lmax + 1)
        C = {k: np.asarray(self.cl[k])[:lmax + 1] if k in self.cl else z
             for k in ('tt', 'te', 'tb', 'ee', 'eb', 'bb')}
        rows = {'t': (C['tt'], C['te'], C['tb']), 'e': (C['te'], C['ee'], C['eb']),
                'b': (C['tb'], C['eb'], C['bb'])}[row]
        out = None
        for cl_row, alm in zip(rows, (t, e, b)):
            term = ualm.almxfl(alm, lmax, cl_row)
            out = term if out is None else out + term
        return out

    def get_sim_tmliklm(self, idx):
        return self._wiener(idx, 't')

    def get_sim_emliklm(self, idx):
        return self._wiener(idx, 'e')

    def get_sim_bmliklm(self, idx):
        return self._wiener(idx, 'b')


def parse_pre_op_descr(descr, cinv, dense_cacher=None, stages=None):
    """Build a CG preconditioner from the reference's descriptor-string grammar
    (reference: plancklens/qcinv/multigrid.py:163-210 parse_pre_op_descr), against an
    existing CinvT / CinvP / CinvTP / CinvKK solver object, on its device:

      - ``diag_cl``                  the solver's diagonal preconditioner
      - ``dense`` / ``dense(key)``   dense low-l block over the enclosing band limit
                                     (analytic for T-like solvers, probed for the stacked
                                     P / TEB operators); a non-empty ``key`` names the
                                     entry in `dense_cacher`
      - ``split(low, lsplit, high)`` `low` built at band limit lsplit, `high` above
      - ``stage(i)``                 entry i of `stages` (prebuilt pre-ops, e.g. from
                                     make_multigrid_pre_op)

    e.g. the reference's production T chain descriptor ``split(dense(""), 64, diag_cl)``
    gives what ``CinvT(..., lmax_dense=64)`` wires by construction."""
    descr = descr.strip()
    if descr.startswith('split(') and descr.endswith(')'):
        # balance-parse the three arguments at top-level commas (a greedy regex mis-parses
        # a split nested in the high slot, e.g. 'split(dense, 24, split(dense, 8, diag_cl))')
        args = _split_top_level(descr[len('split('):-1])
        assert len(args) == 3, 'split() takes exactly 3 arguments: %r' % descr
        low_descr, lsplit, high_descr = args[0], int(args[1]), args[2]
        low = _parse_pre_op_at(low_descr, cinv, lsplit, dense_cacher, stages)
        high = _parse_pre_op_at(high_descr, cinv, cinv.lmax, dense_cacher, stages)
        return split_pre_op(low, high, min(lsplit, cinv.lmax), cinv.lmax, device=cinv.device)
    return _parse_pre_op_at(descr, cinv, cinv.lmax, dense_cacher, stages)


def _split_top_level(s):
    """Split a descriptor argument list on commas at paren depth 0, honouring quoted
    strings (dense cache keys may carry commas, e.g. ``split(dense("a,b"), 64, ...)``)."""
    parts, depth, start, quote = [], 0, 0, None
    for i, c in enumerate(s):
        if quote is not None:
            if c == quote:
                quote = None
        elif c in '"\'':
            quote = c
        elif c == '(':
            depth += 1
        elif c == ')':
            depth -= 1
            assert depth >= 0, 'unbalanced parens in descriptor: %r' % s
        elif c == ',' and depth == 0:
            parts.append(s[start:i].strip())
            start = i + 1
    assert depth == 0 and quote is None, 'unbalanced descriptor: %r' % s
    parts.append(s[start:].strip())
    return parts


def _parse_pre_op_at(descr, cinv, ctx_lmax, dense_cacher, stages):
    """One descriptor at an enclosing band limit (the role of the lmax the reference
    threads through nested parse_pre_op_descr calls). Cache keys are the reference's."""
    import re
    descr = descr.strip()
    if re.match(r'split\(', descr):
        return parse_pre_op_descr(descr, cinv, dense_cacher=dense_cacher, stages=stages)
    if descr == 'diag_cl':
        return cinv.pre_diag
    m = re.match(r'dense(?:\((.*)\))?\Z', descr)
    if m:
        ld = min(ctx_lmax, cinv.lmax)
        key = m.group(1) or None
        kw = dict(cacher=dense_cacher, dtype=cinv.dtype, device=cinv.device)
        if isinstance(cinv, CinvP):
            if key is None:
                key = _dense_cache_key('pp', ld, cinv.lmax,
                                       list(cinv.filt.ninv)
                                       + [cinv.cl['ee'][:cinv.lmax + 1],
                                          cinv.cl['bb'][:cinv.lmax + 1], cinv.transf,
                                          cinv.filt.templates.ravel(),
                                          [float(cinv.filt.templates.shape[0])]])
            return dense_pre_op_stacked(cinv.fwd_op, ld, cinv.lmax, 2, cache_key=key,
                                        chunk=probe_chunk(cinv.geom, cinv.lmax, 2,
                                                          cinv.dtype), **kw)
        if isinstance(cinv, CinvTP):
            if key is None:
                key = _dense_cache_key('tp', ld, cinv.lmax,
                                       [cinv.filt.filt_t.ninv] + list(cinv.filt.filt_p.ninv)
                                       + [np.asarray(cinv.cls[k])[:cinv.lmax + 1]
                                          for k in sorted(cinv.cls)] + [cinv.transf])
            fwd_ld = cinv.filt.make_ops(ld, cinv.cls, rescal_cl=cinv.rescal_cl[:ld + 1])[0]
            return dense_pre_op_stacked(fwd_ld, ld, cinv.lmax, 3, cache_key=key, op_lmax=ld,
                                        chunk=probe_chunk(cinv.geom, ld, 3, cinv.dtype),
                                        **kw)
        # T-like (CinvT and its CinvKK subclass): the analytic f64 assembly
        if key is None:
            key = _dense_cache_key('tta', ld, cinv.lmax,
                                   [cinv.filt.ninv, cinv.cl['tt'][:cinv.lmax + 1],
                                    cinv.transf, cinv.filt.templates.ravel(),
                                    [float(cinv.filt.templates.shape[0])]])
        bdl = cinv.transf[:cinv.lmax + 1] * cli(cinv.rescal_cl)
        return dense_pre_op_analytic_t(cinv.filt, ld, cinv.lmax, cinv.dl, bdl,
                                       cacher=dense_cacher, cache_key=key)
    m = re.match(r'stage\((.*)\)\Z', descr)
    if m:
        assert stages is not None, 'stage(%s) needs the stages argument' % m.group(1)
        return stages[int(m.group(1))]
    raise ValueError('pre_op descriptor %r is unrecognized' % descr)


def degrade_ninv(ninv, geom_fine, geom_coarse, lmax_interp=None, *, device):
    """Restrict an inverse pixel-variance map to a coarser ring geometry: interpolate the
    per-steradian inverse variance spectrally (transforms on `device`) and convert back to
    per-pixel units (role of hp.ud_grade(ninv, power=-2) in the reference,
    opfilt_tt.py:172-181). Host numpy."""
    lmax = geom_coarse.nrings - 1 if lmax_interp is None else lmax_interp
    sht_f = SHT(geom_fine, lmax, device=device)
    sht_c = SHT(geom_coarse, lmax, device=device)
    alm = sht_f.map2alm(torch.as_tensor(np.asarray(ninv) / _omega(geom_fine),
                                        device=sht_f.device))
    out = sht_c.alm2map(alm).cpu().numpy()
    return np.maximum(out, 0.) * _omega(geom_coarse)


def make_multigrid_pre_op(geom, ninv, b_transf, cltt, lmax, stage_lmaxs, stage_iters,
                          lmax_dense=32, marge_monopole=False, marge_dipole=False, *,
                          device):
    """Multigrid-style preconditioner chain (reference: plancklens/qcinv/multigrid.py):
    each stage solves the same system restricted to a coarser band limit and geometry with
    a few fixed PCG iterations (ops/cg.pcg_fixed), preconditioned by the next stage; the
    innermost stage uses the dense low-l block. Returns a pre_op for the full-resolution
    system; modes above stage_lmaxs[0] get the full-resolution diagonal.

    Structurally the reference's chain but not the recommended preconditioner: plain diag
    and split(dense, diag) reach a lower residual in the same iterations at a fraction of
    the cost in every measured configuration (docs/PERF.md round-4 arms)."""
    from ..ops.sht import gl_geometry
    device = _resolve_device(device)

    def build(level):
        lm = stage_lmaxs[level]
        geom_l = gl_geometry(lm)
        ninv_l = degrade_ninv(ninv, geom, geom_l, device=device)
        filt_l = NinvFilterT(geom_l, ninv_l, b_transf[:lm + 1], marge_monopole=marge_monopole,
                             marge_dipole=marge_dipole, device=device)
        fwd_l, _, diag_l, _ = filt_l.make_ops(lm, cltt)
        if level + 1 < len(stage_lmaxs):
            inner_pre = split_pre_op(build(level + 1), diag_l, stage_lmaxs[level + 1], lm,
                                     device=device)
        else:
            dense = dense_pre_op(fwd_l, min(lmax_dense, lm), lm, device=device)
            inner_pre = split_pre_op(dense, diag_l, min(lmax_dense, lm), lm, device=device)
        ms_l = torch.as_tensor(_lm_ms(lm), device=device)
        n_it = stage_iters[level]

        def pre_op(r):
            # r at the parent's band limit; restrict, solve approximately, prolongate
            lmax_parent = ualm.getlmax(r.shape[-1])
            r_c = ualm.alm_copy(r, lmax_parent, lm)
            x_c = cg.pcg_fixed(fwd_l, inner_pre, r_c, torch.zeros_like(r_c), n_it, ms_l)
            return ualm.alm_copy(x_c, lm, lmax_parent)

        return pre_op

    chain = build(0)
    if stage_lmaxs[0] >= lmax:
        return chain
    filt_top = NinvFilterT(geom, ninv, b_transf[:lmax + 1], marge_monopole=marge_monopole,
                           marge_dipole=marge_dipole, device=device)
    _, _, diag_top, _ = filt_top.make_ops(lmax, cltt)
    return split_pre_op(chain, diag_top, stage_lmaxs[0], lmax, device=device)


def make_multigrid_pre_op_p(geom, ninv, b_transf, clee, clbb, lmax, stage_lmaxs,
                            stage_iters, lmax_dense=16, *, device):
    """Polarisation multigrid preconditioner chain for the coupled E/B (spin-2) system
    (reference: plancklens/qcinv/multigrid.py with opfilt_pp, multigrid.py:113-160): the
    T chain's structure (make_multigrid_pre_op) on stacked (batch, 2, nalm) E/B vectors,
    the innermost stage preconditioned by the probed dense E/B block. Like the T chain,
    not the recommended preconditioner (docs/PERF.md round-4 pol arm)."""
    from ..ops.sht import gl_geometry
    device = _resolve_device(device)
    trip = ninv if isinstance(ninv, (list, tuple)) else (ninv,)

    def build(level):
        lm = stage_lmaxs[level]
        geom_l = gl_geometry(lm)
        ninv_l = tuple(degrade_ninv(m, geom, geom_l, device=device) for m in trip)
        filt_l = NinvFilterP(geom_l, ninv_l, b_transf[:lm + 1], device=device)
        fwd_l, _, diag_l, _ = filt_l.make_ops(lm, clee, clbb)
        if level + 1 < len(stage_lmaxs):
            inner_pre = split_pre_op(build(level + 1), diag_l, stage_lmaxs[level + 1], lm,
                                     device=device)
        else:
            dense = dense_pre_op_stacked(fwd_l, min(lmax_dense, lm), lm, 2, device=device)
            inner_pre = split_pre_op(dense, diag_l, min(lmax_dense, lm), lm, device=device)
        ms2_l = torch.as_tensor(np.concatenate([_lm_ms(lm)] * 2), device=device)
        nalm_l = ualm.getsize(lm)
        n_it = stage_iters[level]

        def pre_op(r):
            # r stacked (batch, 2, nalm) at the parent's band limit
            lmax_parent = ualm.getlmax(r.shape[-1])
            r_c = ualm.alm_copy(r, lmax_parent, lm)
            bsz = r_c.shape[0]

            def fwd_flat(xf):
                return fwd_l(xf.reshape(bsz, 2, nalm_l)).reshape(bsz, -1)

            def pre_flat(rf):
                return inner_pre(rf.reshape(bsz, 2, nalm_l)).reshape(bsz, -1)

            x_c = cg.pcg_fixed(fwd_flat, pre_flat, r_c.reshape(bsz, -1),
                               torch.zeros((bsz, 2 * nalm_l), dtype=r_c.dtype,
                                           device=r_c.device),
                               n_it, ms2_l).reshape(bsz, 2, nalm_l)
            return ualm.alm_copy(x_c, lm, lmax_parent)

        return pre_op

    chain = build(0)
    if stage_lmaxs[0] >= lmax:
        return chain
    filt_top = NinvFilterP(geom, ninv, b_transf[:lmax + 1], device=device)
    _, _, diag_top, _ = filt_top.make_ops(lmax, clee, clbb)
    return split_pre_op(chain, diag_top, stage_lmaxs[0], lmax, device=device)
