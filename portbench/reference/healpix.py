"""Plain HEALPix transforms and the map-based full-sky filter, in plain torch.

The reference's own RING layout (theta, nphi, phi0 per ring, from nside), the Legendre
phase of reference/sht.py (its recurrence, run on all 4 nside - 1 rings: the HEALPix
rings are north-south symmetric) and an explicit DFT per ring for the longitude phase.
Analysis is the equal-area quadrature (weight 4 pi / npix a pixel), refined as healpy's
map2alm refines it: alm <- alm + A(m - S alm), `iter` times. The filter is plancklens
filt_simple.library_fullsky_sepTP's, written out: bar X = f_l / b_l map2alm(X).
Nothing of the program is imported. For small nside: the ring loop is plain Python.
"""
import numpy as np
import torch

from .sht import SHT


class Geometry:
    """RING-ordered HEALPix layout: per ring (north to south) theta, nphi, phi0 and the
    offset of its first pixel; with `rings` (ring indices, 0 the northernmost) those rings
    alone, their pixels one after the other (npix stays the whole sphere's)."""

    def __init__(self, nside, rings=None):
        ns = int(nside)
        self.nside = ns
        i = np.arange(1, 4 * ns)
        k = np.minimum(i, 4 * ns - i)              # ring number counted from its pole
        cap = k < ns
        z = np.where(cap, 1. - k ** 2 / (3. * ns ** 2), 4. / 3. - 2. * i / (3. * ns))
        z = np.where(cap & (i > 2 * ns), -z, z)
        self.theta = np.arccos(z)
        self.nphi = np.where(cap, 4 * k, 4 * ns)
        shifted = (i - ns + 1) % 2 == 1          # belt rings alternate a half-pixel shift
        self.phi0 = np.where(cap, np.pi / (4. * k), np.where(shifted, np.pi / (4. * ns), 0.))
        if rings is not None:
            self.theta, self.nphi, self.phi0 = (x[np.asarray(rings)] for x in
                                                (self.theta, self.nphi, self.phi0))
        self.ofs = np.concatenate([[0], np.cumsum(self.nphi)[:-1]])
        self.npix = 12 * ns * ns


class HealpixSHT:
    """Spin-0 and spin-s transforms of band limit lmax on the HEALPix rings of `nside`
    (healpy's conventions, as reference/sht.py states them). With `rings` the syntheses
    give those rings' pixels alone (a sample of a large map; analysis needs every ring)."""

    def __init__(self, nside, lmax, dtype=torch.float64, *, device, rings=None):
        self.geom = g = Geometry(nside, rings)
        self.lmax = lmax
        self.device = torch.device(device)
        self.dtype = dtype
        # the Legendre phase on every ring; its ring phase (nphi, weights) is unused here
        self.leg = SHT(g.theta, np.full(len(g.theta), 4. * np.pi / g.npix), 2 * lmax + 1,
                       lmax, dtype=dtype, device=device)
        self.cdtype = self.leg.cdtype
        m = np.arange(lmax + 1)
        self._E = [torch.as_tensor(np.exp(1j * np.outer(p0 + 2. * np.pi * np.arange(n) / n, m)),
                                   dtype=self.cdtype, device=self.device)
                   for n, p0 in zip(g.nphi, g.phi0)]              # (nphi, M) e^{i m phi_j}

    # ------------------------------------------------------------ ring phase
    def _rings(self, Fp, Fm):
        """(B, npix) complex: sum_{m >= 0} Fp e^{i m phi} + sum_{m > 0} Fm e^{-i m phi}
        on each ring (Fm None: the conjugate of Fp's, a real field)."""
        out = []
        for r, E in enumerate(self._E):
            f = Fp[:, r] @ E.T
            if Fm is None:
                f = 2. * f.real - Fp[:, r, :1].real
            else:
                f = f + Fm[:, r, 1:] @ torch.conj(E[:, 1:]).T
            out.append(f)
        return torch.cat(out, -1)

    def _bins(self, maps):
        """(G+, conj G-): w sum_j f_j e^{-i m phi_j} and conj(w sum_j f_j e^{+i m phi_j})
        per ring, w = 4 pi / npix."""
        g, w = self.geom, 4. * np.pi / self.geom.npix
        f = maps.to(self.cdtype)
        gp, gm = [], []
        for r, E in enumerate(self._E):
            fr = f[:, g.ofs[r]:g.ofs[r] + g.nphi[r]]
            gp.append(w * (fr @ torch.conj(E)))
            gm.append(torch.conj(w * (fr @ E)))
        return torch.stack(gp, 1), torch.stack(gm, 1)

    # ------------------------------------------------------------ transforms
    def alm2map(self, tlm):
        """(B, nalm) -> (B, npix) real."""
        A = self.leg.to_grid(tlm.to(self.cdtype)) * self.leg.N
        F, _ = self.leg._legendre_synth(A, None, 0)
        return self._rings(F, None).real

    def alm2map_spin(self, g, c, s):
        """(B, nalm) g, c -> (re, im) of the spin-s field, each (B, npix)."""
        G = self.leg.to_grid(g.to(self.cdtype))
        C = self.leg.to_grid(c.to(self.cdtype))
        A = -(G + 1j * C) * self.leg.N
        Bc = torch.conj(-((-1.) ** s) * (G - 1j * C)) * self.leg.N
        f = self._rings(*self.leg._legendre_synth(A, Bc, s))
        return f.real, f.imag

    def _map2alm_once(self, maps):
        Gp, _ = self._bins(maps)
        A, _ = self.leg._legendre_anal(Gp, None, 0)
        return self.leg.from_grid(A * self.leg.N)

    def _map2alm_spin_once(self, re, im, s):
        Gp, Gmc = self._bins(torch.complex(re.to(self.dtype), im.to(self.dtype)))
        A, Bm = self.leg._legendre_anal(Gp, Gmc, s)
        A = A * self.leg.N
        Bm = Bm * self.leg.N * ((-1.) ** s)
        return self.leg.from_grid(-0.5 * (A + Bm)), self.leg.from_grid(0.5j * (A - Bm))

    def map2alm(self, maps, iter=0):
        """(B, npix) real -> (B, nalm), Jacobi-refined `iter` times."""
        alm = self._map2alm_once(maps)
        for _ in range(iter):
            alm = alm + self._map2alm_once(maps - self.alm2map(alm))
        return alm

    def map2alm_spin(self, re, im, s, iter=0):
        """(re, im) of a spin-s field -> (g, c) alms, Jacobi-refined `iter` times."""
        g, c = self._map2alm_spin_once(re, im, s)
        for _ in range(iter):
            r, i = self.alm2map_spin(g, c, s)
            dg, dc = self._map2alm_spin_once(re - r, im - i, s)
            g, c = g + dg, c + dc
        return g, c


def fullsky_sepTP(sht, t, q, u, ftl, fel, fbl, transf, iter=3):
    """plancklens filt_simple.library_fullsky_sepTP on (B, npix) maps: (bar T, bar E,
    bar B) = (ftl, fel, fbl) / b_l times map2alm(T) and map2alm_spin((Q, U), 2)."""
    from ..inputs import lm_of_index
    ls, _ = lm_of_index(sht.lmax)
    ls = torch.as_tensor(ls, device=sht.device)
    b = np.asarray(transf, dtype=float)[:sht.lmax + 1]

    def fl(f):
        return torch.as_tensor(np.asarray(f, dtype=float)[:sht.lmax + 1] / b,
                               device=sht.device)[ls]
    e, bb = sht.map2alm_spin(q, u, 2, iter)
    return sht.map2alm(t, iter) * fl(ftl), e * fl(fel), bb * fl(fbl)
