r"""HEALPix pixelisation support, in torch.

Port of plancklens_tpu/ops/sht/healpix.py: the ring layout of the HEALPix sphere
(theta, nphi, phi0, per-pixel area) and spin-s synthesis/analysis on it, so that
healpy-pixelised data can enter the pipeline directly (reference role:
plancklens/shts.py healpy backend).

The Legendre phase is the plain transform of core.py on all 4 nside - 1 rings (kernels
K3/K4 for CUDA tensors, the plain torch engine for CPU tensors). The longitude phase
splits by ring structure: the equatorial belt (all rings with nphi = 4 nside) is one
batched FFT, as in the reference; the polar-cap rings (nphi = 4i) are exact DFTs of
their coefficients folded mod nphi, batched over ring sizes by a chirp z-transform
(`_CapDFT`), where the reference multiplies each ring by a DFT matrix it builds per call
(the same sum; at nside 2048 those 2047 matrix builds took two thirds of the transform
time on an H100, PERF.md).

Analysis uses per-ring quadrature weights by default (the role of healpy's ring-weight
files: a minimal-norm correction to the pixel area making the m=0 quadrature exact up to
l <= 3 nside); use_ring_weights=False gives healpy's plain map2alm, whose default is
iter=3 with no weights. Either way analysis is an approximate inverse, exactly as in the
reference pipeline.

While the tracer is live (utils/trace.py) each public transform is a span
`healpix.alm2map` or `healpix.map2alm` (attrs nside, lmax, spin, batch, iter, f64); the
outermost of them in a call also carries `device_s`, its device seconds by CUDA events
around the call (the syntheses of map2alm's Jacobi steps nest inside its span). Counters:
`healpix.jacobi_iters` (Jacobi steps, one a map2alm call and iteration) and
`healpix.map_bytes` (bytes of the maps map2alm was given).
"""
import contextlib

import numpy as np
import torch

from ...utils import alm as ualm
from ...utils import trace
from .core import legendre_synth, legendre_anal
from .transforms import _CDTYPE, _facl, _on_device, _resolve_device

TRANSFORM_SPANS = ('healpix.alm2map', 'healpix.map2alm')


class HealpixGeometry:
    """Ring description of the HEALPix sphere (RING ordering); host numpy, copied from
    the reference (plancklens_tpu/ops/sht/healpix.py:28-93)."""

    def __init__(self, nside):
        self.nside = int(nside)
        ns = self.nside
        nrings = 4 * ns - 1
        i = np.arange(1, nrings + 1)
        z = np.empty(nrings)
        nphi = np.empty(nrings, dtype=int)
        phi0 = np.empty(nrings)
        # north cap
        cap = i < ns
        z[cap] = 1. - (i[cap] ** 2) / (3. * ns ** 2)
        nphi[cap] = 4 * i[cap]
        phi0[cap] = np.pi / (4. * i[cap])
        # equatorial belt
        eq = (i >= ns) & (i <= 3 * ns)
        z[eq] = 4. / 3. - 2. * i[eq] / (3. * ns)
        nphi[eq] = 4 * ns
        phi0[eq] = np.pi / (4. * ns) * (((i[eq] - ns) + 1) % 2)
        # south cap
        south = i > 3 * ns
        isouth = 4 * ns - i[south]
        z[south] = -(1. - (isouth ** 2) / (3. * ns ** 2))
        nphi[south] = 4 * isouth
        phi0[south] = np.pi / (4. * isouth)
        self.theta = np.arccos(z)
        self.nphi = nphi
        self.phi0 = phi0
        self.ofs = np.concatenate([[0], np.cumsum(nphi)])[:-1]
        self.npix = 12 * ns ** 2
        self.omega = 4. * np.pi / self.npix  # equal-area pixels

    @property
    def nrings(self):
        return len(self.theta)

    def ring_weights(self, *, device):
        """Per-ring quadrature weights making the m=0 analysis exact up to l < nrings
        (the role of healpy's ring weight files): solve sum_j w_j nphi_j P_l(z_j) =
        4 pi delta_l0. Numpy output, computed once per geometry.

        The minimal-norm correction comes from a QR factorisation of the system's
        transpose on `device`, where the reference calls numpy's SVD-based lstsq: the
        system has full rank and a condition number of ~2 nside, so the two agree to
        ~1e-15, and at nside 2048 the SVD took 54 s on the host of an H100 machine
        (PERF.md)."""
        if not hasattr(self, '_ring_w'):
            from numpy.polynomial.legendre import legvander
            z = np.cos(self.theta)
            # demand exact m=0 quadrature only up to 3*nside (the grid's reliable band;
            # exactness to nrings-1 = 4*nside-2 gives wildly oscillating weights), and take
            # the minimal-norm correction around the equal-area weights
            lmax_w = min(3 * self.nside, self.nrings - 1)
            V = legvander(z, lmax_w).T * self.nphi[None, :]
            rhs = np.zeros(lmax_w + 1)
            rhs[0] = 4. * np.pi
            w0 = np.full(self.nrings, self.omega)
            # V = R^T Q^T, so dw = Q R^-T (rhs - V w0) solves V dw = rhs - V w0 with the
            # least norm
            Q, R = torch.linalg.qr(torch.as_tensor(V.T, device=device))
            y = torch.linalg.solve_triangular(
                R.T, torch.as_tensor(rhs - V @ w0, device=device)[:, None], upper=False)
            self._ring_w = w0 + (Q @ y)[:, 0].cpu().numpy()
        return self._ring_w

    def token(self):
        return ('healpix', self.nside)

    def hashdict(self):
        return {'name': 'healpix', 'nside': self.nside}

    def pix2rings(self, m):
        """Flat RING-ordered map -> list of per-ring arrays (ragged)."""
        return [m[o:o + n] for o, n in zip(self.ofs, self.nphi)]


class _CapDFT:
    """Exact DFTs of the polar-cap rings, D(x)_k = sum_{b<n} x_b e^{2 pi i b k / n} for
    every cap ring size n = 4i (i < nside), north and south rings of one size together.

    The rings are taken in chunks of consecutive sizes, and each chunk in one batched FFT
    of one power-of-2 length N >= 2 n_max - 1 (Bluestein's chirp z-transform): with
    c_j = e^{i pi j^2 / n}, D(x)_k = c_k sum_b (x_b c_b) conj(c_{k-b}), a convolution.
    The reference multiplies each ring by a DFT matrix instead; one FFT length per chunk
    avoids a cuFFT plan per ring size (2047 sizes at nside 2048). Tables per chunk: the
    chirp (sizes, n_max), the FFT of the convolution kernel (sizes, N), the flat map
    index of each (pole, ring, k) and the fold index m -> (ring, m mod n)."""

    CHUNK = 256     # ring sizes per batched FFT: bounds the (batch, 2, CHUNK, N) buffers

    def __init__(self, geom, mmax, cdtype, device):
        ns = geom.nside

        def dev(a, dtype=None):
            return torch.as_tensor(np.ascontiguousarray(a), device=device, dtype=dtype)

        self.chunks = []
        for i0 in range(1, ns, self.CHUNK):
            i = np.arange(i0, min(i0 + self.CHUNK, ns))
            n = 4 * i
            nmax = int(n[-1])
            N = 1 << int(np.ceil(np.log2(2 * nmax - 1)))
            j = np.arange(nmax)
            valid = j[None, :] < n[:, None]
            # j^2 mod 2n is exact in integers, so the chirp's angle is rounded once
            ang = ((j[None, :] ** 2) % (2 * n[:, None])) * (np.pi / n[:, None])
            c = np.where(valid, np.exp(1j * ang), 0.)
            h = np.zeros((len(i), N), dtype=np.complex128)
            h[:, :nmax] = np.conj(c)
            h[:, N - nmax + 1:] = np.conj(c[:, :0:-1])
            rows = np.stack([i - 1, 4 * ns - 1 - i])                       # (2, sizes)
            pix = geom.ofs[rows][:, :, None] + j[None, None, :]
            keep = np.broadcast_to(valid, pix.shape).ravel()
            fold = np.arange(len(i))[:, None] * nmax + np.arange(mmax + 1) % n[:, None]
            self.chunks.append(dict(
                rows=dev(rows.ravel()), nmax=nmax, N=N, c=dev(c, cdtype),
                hhat=torch.fft.fft(dev(h)).to(cdtype), pix=dev(pix.ravel()[keep]),
                sel=dev(np.flatnonzero(keep)), fold=dev(fold.ravel())))

    @staticmethod
    def _dft(x, ch):
        """D(x) of one chunk, x (batch, 2, sizes, nmax) zero beyond each ring's size."""
        a = torch.fft.fft(x * ch['c'], n=ch['N'], dim=-1)
        return ch['c'] * torch.fft.ifft(a * ch['hhat'], dim=-1)[..., :ch['nmax']]

    def synth(self, F, out):
        """out[cap pixels] = 2 Re D(F folded mod n), F (batch, nrings, mmax+1) with the
        m = 0 term already halved."""
        batch = F.shape[0]
        for ch in self.chunks:
            Fc = F[:, ch['rows'], :]                                  # (batch, 2 sizes, M)
            X = torch.zeros((batch, 2, ch['c'].numel()), dtype=F.dtype, device=F.device)
            X.index_add_(-1, ch['fold'], Fc.reshape(batch, 2, -1))
            f = 2. * self._dft(X.reshape(batch, 2, -1, ch['nmax']), ch).real
            out[:, ch['pix']] = f.reshape(batch, -1)[:, ch['sel']]

    def anal(self, maps, G):
        """G[cap rings, m] = sum_k f_k e^{-2 pi i m k / n} = conj D(f)_{m mod n}, maps real."""
        batch = maps.shape[0]
        for ch in self.chunks:
            x = torch.zeros((batch, 2 * ch['c'].numel()), dtype=maps.dtype,
                            device=maps.device)
            x[:, ch['sel']] = maps[:, ch['pix']]
            y = torch.conj(self._dft(x.reshape(batch, 2, -1, ch['nmax']), ch))
            G[:, ch['rows'], :] = y.reshape(batch, 2, -1)[..., ch['fold']] \
                .reshape(batch, len(ch['rows']), -1).to(G.dtype)


class HealpixSHT:
    """Spin-s SHT on the HEALPix grid, bound to a band limit, dtype and device.

    alm2map / alm2map_spin are exact (synthesis); map2alm / map2alm_spin use ring-weight
    quadrature by default (use_ring_weights=False gives healpy's equal-area behaviour),
    with optional Jacobi refinement (healpy's iter>0) via the iter argument. Maps are flat
    (..., npix) RING-ordered tensors on the transform's device (numpy input is placed
    there; a tensor on another device raises)."""

    def __init__(self, nside, lmax, dtype=torch.float64, use_ring_weights=True, *, device):
        self.geom = HealpixGeometry(nside)
        self.lmax = lmax
        self.mmax = lmax
        self.use_ring_weights = use_ring_weights
        self.dtype = dtype
        self.cdtype = _CDTYPE[dtype]
        self.device = _resolve_device(device)
        g = self.geom
        ns = g.nside
        self._eq = slice(ns - 1, 3 * ns)           # rings with nphi = 4 nside
        self._fac = torch.as_tensor(_facl(lmax), dtype=dtype, device=self.device)[:, None]
        m = torch.arange(self.mmax + 1, dtype=torch.float64, device=self.device)
        phi0 = torch.as_tensor(g.phi0, dtype=torch.float64, device=self.device)
        # per-ring phase alignment e^{i m phi0}, (nrings, mmax+1)
        self._rot = torch.polar(torch.ones_like(phi0[:, None] * m), phi0[:, None] * m) \
            .to(self.cdtype)
        mm = np.arange(self.mmax + 1)
        nphi_eq = 4 * ns
        eq_ofs = g.ofs[self._eq]
        self._eq_idx = torch.as_tensor((eq_ofs[:, None] + np.arange(nphi_eq)[None, :]).ravel(),
                                       device=self.device)
        fold = mm % nphi_eq
        self._fold = torch.as_tensor(fold, device=self.device)
        # the belt's rfft bins: m folds to bin min(m mod nphi, nphi - m mod nphi), through
        # a conjugate above nphi/2; irfft doubles interior bins (0 < b < nphi/2) itself, so
        # m > 0 terms folding onto the DC or Nyquist bin carry the factor 2 explicitly
        conj = fold > nphi_eq // 2
        bin_idx = np.where(conj, nphi_eq - fold, fold)
        edge = ((bin_idx == 0) | (bin_idx == nphi_eq // 2)) & (mm > 0)
        self._bin_conj = torch.as_tensor(conj, device=self.device)
        self._bin_idx = torch.as_tensor(bin_idx, device=self.device)
        self._bin_edge = torch.as_tensor(np.where(edge, 2., 1.), dtype=dtype, device=self.device)
        self._caps = _CapDFT(g, self.mmax, self.cdtype, self.device)

    def _on_device(self, x):
        return _on_device(x, self.device)

    @contextlib.contextmanager
    def _span(self, name, batch, spin, iter=0):
        """Span `name` of a public transform of `batch` maps; the outermost transform span
        also times the call's device seconds."""
        if not trace.live():
            yield
            return
        outermost = not trace.within(*TRANSFORM_SPANS)
        with trace.span(name, nside=self.geom.nside, lmax=self.lmax, spin=int(spin),
                        batch=int(batch), iter=int(iter),
                        f64=self.dtype == torch.float64) as s:
            if outermost:
                s.time_device(self.device)
            yield

    def _count_analysis(self, iter, *maps):
        trace.count('healpix.jacobi_iters', iter)
        trace.count('healpix.map_bytes', sum(m.numel() * m.element_size() for m in maps))

    # -------------------------------------------------------- longitude phase
    # (named spans in profiler traces; examples/profile_healpix_torch.py reads them)
    @trace.traced('healpix.rings_to_map')
    def _rings_to_map(self, F):
        """F (batch, nrings, mmax+1) complex ring Fourier coefficients (F+ convention with
        hermitian m<0 part folded via the real-field relation) -> flat maps.

        For real output maps with coefficients G_m = F[..., m]:
        f_k = G_0 + 2 sum_{m>0} Re(G_m e^{i m phi_k}).
        """
        g = self.geom
        batch = F.shape[0]
        out = torch.empty((batch, g.npix), dtype=self.dtype, device=self.device)
        F = F * self._rot                    # phase alignment to each ring's phi0
        # equatorial belt: one irfft
        nphi_eq = 4 * g.nside
        Feq = F[:, self._eq, :]
        nbins = nphi_eq // 2 + 1
        # fold aliases m -> m mod nphi into rfft bins (m <= lmax may exceed nphi/2)
        vals = torch.where(self._bin_conj, torch.conj(Feq), Feq) * self._bin_edge
        spec = torch.zeros(Feq.shape[:2] + (nbins,), dtype=F.dtype, device=self.device)
        spec.index_add_(-1, self._bin_idx, vals)
        # the DC and Nyquist bins enter through their real parts (Re(G e^{i pi k}) =
        # Re(G) (-1)^k); an irfft ignores their imaginary parts, made explicit here
        spec[..., 0] = spec[..., 0].real
        spec[..., -1] = spec[..., -1].real
        eqmaps = torch.fft.irfft(spec, n=nphi_eq, dim=-1) * nphi_eq
        out[:, self._eq_idx] = eqmaps.reshape(batch, -1)
        # caps: f_k = 2 Re sum_m G'_m e^{2 pi i m k / n} with G'_0 = G_0 / 2
        F[..., 0] *= 0.5                  # F is this call's own product; the belt is done
        self._caps.synth(F, out)
        return out

    @trace.traced('healpix.map_to_rings')
    def _map_to_rings(self, maps):
        """Adjoint-ish: flat maps -> G_m per ring = sum_k f_k e^{-i m phi_k} (no weights)."""
        g = self.geom
        batch = maps.shape[0]
        G = torch.empty((batch, g.nrings, self.mmax + 1), dtype=self.cdtype, device=self.device)
        nphi_eq = 4 * g.nside
        eqmaps = maps[:, self._eq_idx].reshape(batch, -1, nphi_eq)
        # bins fold with conjugation for m mod nphi > nphi/2 handled by fft symmetry of
        # real input: T[-m] = conj(T[m])
        T = torch.fft.fft(eqmaps, dim=-1)
        G[:, self._eq, :] = T[:, :, self._fold].to(self.cdtype)
        self._caps.anal(maps, G)
        return G * torch.conj(self._rot)

    # -------------------------------------------------------------- transforms
    def _token(self):
        return self.geom.token()

    def _to_grid(self, alm):
        return ualm.alm2lm(alm.reshape((-1, alm.shape[-1])).to(self.cdtype), self.lmax)

    def alm2map(self, tlm):
        """Real map from scalar alm (healpy convention, map = sum t_lm Y_lm)."""
        tlm = self._on_device(tlm)
        batch_shape = tlm.shape[:-1]
        A = self._to_grid(tlm)
        with self._span('healpix.alm2map', A.shape[0], 0):
            Fp = legendre_synth(A * self._fac, 0, self.geom.theta, grid_token=self._token())
            f = self._rings_to_map(Fp)
        return f.reshape(batch_shape + (self.geom.npix,))

    def _quad_w(self):
        if self.use_ring_weights:
            return torch.as_tensor(self.geom.ring_weights(device=self.device), dtype=self.dtype,
                                   device=self.device)[None, :, None]
        return self.geom.omega

    def map2alm(self, m, iter=0):
        """Quadrature analysis, optionally Jacobi-refined (healpy map2alm iter semantics:
        alm <- alm + A(m - S(alm)), iter times)."""
        m = self._on_device(m)
        batch_shape = m.shape[:-1]
        mc = m.reshape((-1, m.shape[-1])).to(self.dtype)
        with self._span('healpix.map2alm', mc.shape[0], 0, iter):
            self._count_analysis(iter, mc)
            out = self._map2alm_once(mc)
            for _ in range(iter):
                resid = mc - self.alm2map(out)
                out = out + self._map2alm_once(resid)
        return out.reshape(batch_shape + out.shape[-1:])

    def _map2alm_once(self, mc):
        G = self._map_to_rings(mc) * self._quad_w()  # ring-weight quadrature
        A = legendre_anal(G, 0, self.geom.theta, self.lmax, grid_token=self._token())
        return ualm.lm2alm(A * self._fac, self.lmax)

    def alm2map_spin(self, gclm, spin):
        """(re, im) flat maps of the spin field; healpy conventions as transforms.SHT."""
        assert spin > 0
        glm, clm = gclm
        glm = self._on_device(glm)
        clm = self._on_device(clm).broadcast_to(glm.shape)
        batch_shape = glm.shape[:-1]
        Gg, Cc = self._to_grid(glm), self._to_grid(clm)
        with self._span('healpix.alm2map', Gg.shape[0], spin):
            A = -(Gg + 1j * Cc)
            Abar = -(Gg - 1j * Cc)
            tok = self._token()
            Fp = legendre_synth(A * self._fac, -spin, self.geom.theta, grid_token=tok)
            Fm = legendre_synth(((-1.) ** spin) * torch.conj(Abar) * self._fac, spin,
                                self.geom.theta, grid_token=tok)
            # complex map f = sum_{m>=0} Fp e^{im phi} + sum_{m>0} Fm e^{-im phi}:
            # Re f = Re(Fp_0) + sum_{m>0} Re[(Fp + conj(Fm)) e^{im phi}]
            # Im f = Im(Fp_0) + sum_{m>0} Re[-i (Fp - conj(Fm)) e^{im phi}]
            # and _rings_to_map(G) = Re(G_0) + 2 sum_{m>0} Re(G_m e^{im phi}):
            m0 = (torch.arange(self.mmax + 1, device=self.device) == 0)[None, None, :]
            G1 = torch.where(m0, Fp, 0.5 * (Fp + torch.conj(Fm)))
            G2 = torch.where(m0, -1j * Fp, -0.5j * (Fp - torch.conj(Fm)))
            re = self._rings_to_map(G1)
            im = self._rings_to_map(G2)
        return (re.reshape(batch_shape + (self.geom.npix,)),
                im.reshape(batch_shape + (self.geom.npix,)))

    def map2alm_spin(self, maps, spin, iter=0):
        assert spin > 0
        m1, m2 = self._on_device(maps[0]), self._on_device(maps[1])
        batch_shape = m1.shape[:-1]
        mc1 = m1.reshape((-1, m1.shape[-1])).to(self.dtype)
        mc2 = m2.reshape(mc1.shape).to(self.dtype)
        with self._span('healpix.map2alm', mc1.shape[0], spin, iter):
            self._count_analysis(iter, mc1, mc2)
            glm, clm = self._map2alm_spin_once(mc1, mc2, spin)
            for _ in range(iter):
                r1, r2 = self.alm2map_spin((glm, clm), spin)
                dg, dc = self._map2alm_spin_once(mc1 - r1, mc2 - r2, spin)
                glm = glm + dg
                clm = clm + dc
        return (glm.reshape(batch_shape + glm.shape[-1:]),
                clm.reshape(batch_shape + clm.shape[-1:]))

    def _map2alm_spin_once(self, mc1, mc2, spin):
        # G+_m = DFT_m(m1 + i m2), G-_m the same with e^{+im phi}: both from the real
        # transforms of m1 and m2, taken once in one batch
        R = self._map_to_rings(torch.cat([mc1, mc2]))
        R1, R2 = R[:len(mc1)], R[len(mc1):]
        w = self._quad_w()
        Gp = (R1 + 1j * R2) * w
        Gm = (torch.conj(R1) + 1j * torch.conj(R2)) * w
        tok = self._token()
        A = legendre_anal(Gp, -spin, self.geom.theta, self.lmax, grid_token=tok) * self._fac
        Bc = legendre_anal(Gm, spin, self.geom.theta, self.lmax, grid_token=tok)
        B = ((-1.) ** spin) * torch.conj(Bc) * self._fac
        glm = ualm.lm2alm(-0.5 * (A + B), self.lmax)
        clm = ualm.lm2alm(0.5j * (A - B), self.lmax)
        return glm, clm


def pixwin(nside, lmax, pol=False, *, device):
    """HEALPix pixel window function (the role of healpy's tabulated hp.pixwin): see
    :func:`.pixwin.pixwin`."""
    from .pixwin import pixwin as _pixwin
    return _pixwin(nside, lmax, pol=pol, device=device)


def resample_to_rings(m, nside, geom):
    """Nearest-neighbour resampling of a RING-ordered HEALPix map onto a RingGeometry
    (uniform-nphi rings). For masks / inverse-variance maps entering the cinv filters,
    where values are piecewise constant and SHT interpolation would ring. Host numpy,
    copied from the reference."""
    m = np.asarray(m)
    hg = HealpixGeometry(nside)
    # nearest healpix ring for each output ring
    r_of = np.searchsorted(hg.theta, geom.theta)
    r_of = np.clip(r_of, 1, hg.nrings - 1)
    r_of -= (geom.theta - hg.theta[r_of - 1]) < (hg.theta[np.minimum(r_of, hg.nrings - 1)]
                                                 - geom.theta)
    r_of = np.clip(r_of, 0, hg.nrings - 1)
    out = np.empty((geom.nrings, geom.nphi), dtype=m.dtype)
    phis = 2. * np.pi * np.arange(geom.nphi) / geom.nphi
    for i, r in enumerate(r_of):
        npr = hg.nphi[r]
        j = np.rint((phis - hg.phi0[r]) / (2. * np.pi) * npr).astype(np.int64) % npr
        out[i] = m[hg.ofs[r] + j]
    return out
