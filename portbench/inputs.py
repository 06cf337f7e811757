"""Inputs of a run, made from the seed and handed alike to the program and the reference.

Plain numpy and torch; imports nothing of the program. Everything a configuration states
(spectra, beam, grid, mask, noise levels) and everything drawn from `--seed` (CMB alms,
noise alms or noise maps) comes from here, so the two sides read the same numbers.

Alms use the triangular layout with m outermost: index(l, m) = m (2 lmax + 1 - m) / 2 + l.
"""
import os

import numpy as np
import torch

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'data')
ARCMIN = np.pi / 180. / 60.


def nalm(lmax):
    return (lmax + 1) * (lmax + 2) // 2


def lm_of_index(lmax):
    """(l, m) numpy arrays of every index of the triangular layout."""
    ms = np.concatenate([np.full(lmax + 1 - m, m) for m in range(lmax + 1)])
    ls = np.concatenate([np.arange(m, lmax + 1) for m in range(lmax + 1)])
    return ls, ms


def camb_cls(fname, lmax):
    """Bare C_l (tt, ee, bb, te) of a CAMB lensedCls file, indexed by multipole."""
    data = np.loadtxt(os.path.join(DATA, fname))
    ls = data[:, 0].astype(int)
    keep = ls <= lmax
    ls = ls[keep]
    fac = ls * (ls + 1.) / (2. * np.pi)
    out = {}
    for col, key in enumerate(('tt', 'ee', 'bb', 'te'), start=1):
        cl = np.zeros(lmax + 1)
        cl[ls] = data[keep, col] / fac
        out[key] = cl
    return out


def gauss_beam(fwhm_arcmin, lmax):
    ls = np.arange(lmax + 1)
    sigma2 = (fwhm_arcmin * ARCMIN / np.sqrt(8. * np.log(2.))) ** 2
    return np.exp(-0.5 * ls * (ls + 1) * sigma2)


def gl_nodes(n):
    """Gauss-Legendre nodes cos(theta) (descending: north to south) and weights, by
    Newton's iteration on P_n from the asymptotic first guess."""
    i = np.arange(1, n + 1)
    x = np.cos(np.pi * (i - 0.25) / (n + 0.5))
    for _ in range(100):
        p0, p1 = np.ones_like(x), x.copy()
        for k in range(2, n + 1):
            p0, p1 = p1, ((2 * k - 1) * x * p1 - (k - 1) * p0) / k
        dp = n * (x * p1 - p0) / (x * x - 1.)
        dx = p1 / dp
        x = x - dx
        if np.max(np.abs(dx)) < 1e-15:
            break
    p0, p1 = np.ones_like(x), x.copy()
    for k in range(2, n + 1):
        p0, p1 = p1, ((2 * k - 1) * x * p1 - (k - 1) * p0) / k
    dp = n * (x * p1 - p0) / (x * x - 1.)
    return x, 2. / ((1. - x * x) * dp * dp)


def good_fft_size(n):
    """Smallest 2^a 3^b 5^c >= n."""
    best = 1 << int(np.ceil(np.log2(n)))
    p5 = 1
    while p5 < best:
        p3 = p5
        while p3 < best:
            p2 = p3
            while p2 < n:
                p2 *= 2
            best = min(best, p2)
            p3 *= 3
        p5 *= 5
    return best


class Grid:
    """Gauss-Legendre ring grid exact for band limit `lmax` (lmax + 1 rings)."""

    def __init__(self, lmax):
        x, w = gl_nodes(lmax + 1)
        self.lmax = lmax
        self.x = x
        self.theta = np.arccos(x)
        self.weight = w
        self.nrings = lmax + 1
        self.nphi = good_fft_size(2 * lmax + 2)

    def omega(self):
        """(nrings, nphi) pixel solid angles."""
        return np.outer(self.weight, np.full(self.nphi, 2. * np.pi / self.nphi))

    def mask(self, band_z, holes):
        """Galactic band |cos theta| > band_z times circular holes (z, phi, radius)."""
        z = self.x[:, None]
        phi = (2. * np.pi * np.arange(self.nphi) / self.nphi)[None, :]
        m = (np.abs(z) > band_z).astype(float) * np.ones((self.nrings, self.nphi))
        for zc, pc, r in holes:
            m *= ((z - zc) ** 2 + (np.cos(phi) - np.cos(pc)) ** 2 * (1 - z ** 2)
                  + (np.sin(phi) - np.sin(pc)) ** 2 * (1 - z ** 2) > r ** 2)
        return m


def generator(seed, idx, tag, device):
    """torch.Generator of stream `tag` of sim `idx` (-1: the data sim) of a run's seed."""
    state = np.random.SeedSequence([int(seed), int(idx) + 1, int(tag)]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) & ((1 << 63) - 1))


class Sims:
    """Seeded sky inputs of one configuration: Gaussian CMB T/E/B alms with the
    configuration's spectra, and white noise, as alms (harmonic sims) or as maps on the
    grid (map sims). One torch.Generator per (seed, sim, stream) on the device, so a sim is
    the same whatever order the sims are asked for in."""

    def __init__(self, cls, lmax, nlev_t, nlev_p, seed, device, grid=None, pool=None):
        self.lmax = lmax
        self.seed = int(seed)
        self.pool = pool
        if pool is not None:
            self._perm = np.random.default_rng([self.seed, 11]).permutation(pool['sims'])
        self.device = torch.device(device)
        self.grid = grid
        ls, ms = lm_of_index(lmax)
        self._l = torch.as_tensor(ls, device=self.device)
        self._m0 = torch.as_tensor(ms == 0, device=self.device)
        tt, ee, bb, te = (np.asarray(cls[k][:lmax + 1], dtype=float)
                          for k in ('tt', 'ee', 'bb', 'te'))
        with np.errstate(divide='ignore', invalid='ignore'):
            a = np.sqrt(tt)
            b = np.where(tt > 0, te / np.where(tt > 0, a, 1.), 0.)
            c = np.sqrt(np.maximum(ee - b * b, 0.))
        self._col = torch.as_tensor(np.stack([a, b, c, np.sqrt(bb)]), device=self.device)
        self.nlev_t, self.nlev_p = nlev_t, nlev_p
        if grid is not None:
            om = grid.omega()
            self._sig_map = torch.as_tensor(
                np.stack([nlev_t * ARCMIN / np.sqrt(om), nlev_p * ARCMIN / np.sqrt(om)]),
                device=self.device)

    def _gen(self, idx, tag):
        """The generator of sim idx: with a pool, the stream's sims (idx >= pool['first'])
        are the pool's realizations, drawn from its own seed, in an order drawn from the
        run's seed, so that every seed does the same work."""
        p = self.pool
        if p is not None and idx >= p['first']:
            r = int(self._perm[(idx - p['first']) % p['sims']])
            return generator(p['seed'], r, tag, self.device)
        return generator(self.seed, idx, tag, self.device)

    def _unit_alms(self, idx, tag, n):
        """(n, nalm) complex128 unit-variance alms (m = 0 real)."""
        g = self._gen(idx, tag)
        r = torch.randn((n, 2, nalm(self.lmax)), generator=g, device=self.device,
                        dtype=torch.float64)
        re = torch.where(self._m0, r[:, 0], r[:, 0] * np.sqrt(0.5))
        im = torch.where(self._m0, torch.zeros_like(r[:, 1]), r[:, 1] * np.sqrt(0.5))
        return torch.complex(re, im)

    def cmb(self, idx):
        """(3, nalm) CMB T, E, B alms of sim idx."""
        u = self._unit_alms(idx, 0, 3)
        a, b, c, d = (self._col[i][self._l] for i in range(4))
        return torch.stack([a * u[0], b * u[0] + c * u[1], d * u[2]])

    def noise_alms(self, idx):
        """(3, nalm) white noise T, E, B alms of sim idx."""
        u = self._unit_alms(idx, 1, 3)
        s = torch.as_tensor([self.nlev_t, self.nlev_p, self.nlev_p],
                            dtype=torch.float64, device=self.device) * ARCMIN
        return u * s[:, None]

    def noise_maps(self, idx):
        """(3, nrings, nphi) white pixel noise T, Q, U maps of sim idx on the grid."""
        g = self._gen(idx, 2)
        u = torch.randn((3, self.grid.nrings, self.grid.nphi), generator=g,
                        device=self.device, dtype=torch.float64)
        return u * self._sig_map[[0, 1, 1]]


class Inputs:
    """Everything a configuration and a seed give both sides: spectra (`cls` for the
    filter, `cl_weight` for the QE weights), beam `transf`, the grid, mask and inverse
    pixel noise of map sims, and the seeded sims."""

    def __init__(self, cfg, seed, device, traffic=None):
        lmax = cfg['lmax_ivf']
        self.cfg = cfg
        self.cls = camb_cls(cfg['cls'], lmax)
        self.cl_weight = dict(self.cls)
        if cfg.get('cl_weight_bb_zero'):
            self.cl_weight['bb'] = np.zeros_like(self.cls['bb'])
        self.transf = gauss_beam(cfg['beam_fwhm_arcmin'], lmax)
        self.grid = Grid(cfg['grid_lmax']) if 'grid_lmax' in cfg else None
        if self.grid is not None:
            self.mask = self.grid.mask(cfg['mask']['band_z'], cfg['mask']['holes'])
            om = self.grid.omega()
            self.ninv_t = self.mask * om / (cfg['nlev_t'] * ARCMIN) ** 2
            self.ninv_p = self.mask * om / (cfg['nlev_p'] * ARCMIN) ** 2
        pool = None
        if traffic and traffic.get('pool_sims'):
            pool = {'first': int(traffic['warm_sims']), 'sims': int(traffic['pool_sims']),
                    'seed': int(traffic['pool_seed'])}
        self.sims = Sims(self.cls, lmax, cfg['nlev_t'], cfg['nlev_p'], seed, device,
                         grid=self.grid, pool=pool)
        ls, _ = lm_of_index(lmax)
        self._bl = torch.as_tensor(self.transf, device=torch.device(device))[
            torch.as_tensor(ls, device=torch.device(device))]

    def observed(self, idx):
        """(3, nalm) observed T, E, B alms b_l X + n of harmonic sim idx."""
        return self.sims.cmb(idx) * self._bl + self.sims.noise_alms(idx)
