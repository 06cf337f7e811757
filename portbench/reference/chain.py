"""The plain reference of a step of the chain: filtered alms, quadratic estimators, mean
fields and spectra, computed in plain torch from the run's inputs (portbench/inputs.py).

Isotropic configurations: everything from the inputs. Masked configurations: the sims'
maps from the inputs, and each C^-1 solve judged by its residual under the reference's own
operator; the exact solve of a masked sky amplifies rounding by its condition number, so
the reference's estimators start from the program's filtered alms (the reference reads them
only to judge them) and take the l >= lmin cut itself.
"""
import numpy as np
import torch

from ..inputs import ARCMIN, Grid, lm_of_index
from .qe import QE, alm2cl, qe_terms
from .sht import SHT, _CPLX

_RS = {}


def sht(grid, lmax, dtype, tf32, device):
    """Reference transforms on a grid (one per grid, band limit and precision)."""
    key = (grid.nrings, lmax, dtype, tf32)
    if key not in _RS:
        _RS[key] = SHT(grid.theta, grid.weight, grid.nphi, lmax, dtype=dtype, tf32=tf32,
                       device=device)
    return _RS[key]


def _fl(fl, lmax, device):
    ls, _ = lm_of_index(lmax)
    return torch.as_tensor(np.asarray(fl, dtype=float)[:lmax + 1], device=device)[
        torch.as_tensor(ls, device=device)]


def _cli(cl):
    out = np.zeros_like(cl)
    out[cl > 0] = 1. / cl[cl > 0]
    return out


class Reference:
    """The reference of one configuration and run (`inp`: the run's inputs), in `dtype`
    (`tf32`: products of f32 data on the TF32 tensor cores). `qe_terms` gives the
    estimators' terms by key: a subclass brings its own for keys that qe.py lacks."""

    qe_terms = staticmethod(qe_terms)

    def __init__(self, cfg, inp, device, dtype=torch.float64, tf32=False):
        self.cfg, self.inp, self.device = cfg, inp, torch.device(device)
        self.dtype, self.tf32 = dtype, tf32
        self.lmax, self.lq = cfg['lmax_ivf'], cfg['lmax_qlm']
        qgrid = Grid((2 * self.lmax + self.lq) // 2)
        self.qes = {k: QE(k, inp.cl_weight, self.lmax, self.lq,
                          lambda L: sht(qgrid, L, dtype, tf32, device), device,
                          terms=self.qe_terms)
                    for k in cfg['qe_keys']}

    # ------------------------------------------------------------ isotropic filter
    def filtered(self, idxs):
        """(t, e, b) of bar X = f_l / b_l X_obs, f_l = 1 / (C_l + N_l / b_l^2) on
        lmin <= l <= lmax: harmonic sims."""
        cfg, inp = self.cfg, self.inp
        ls = np.arange(self.lmax + 1)
        obs = torch.stack([inp.observed(int(i)) for i in idxs])
        out = []
        for j, (key, nlev) in enumerate((('tt', cfg['nlev_t']), ('ee', cfg['nlev_p']),
                                         ('bb', cfg['nlev_p']))):
            cl = inp.cls[key][:self.lmax + 1]
            fl = 1. / (cl * inp.transf + (nlev * ARCMIN) ** 2 / inp.transf)
            fl[ls < cfg['lmin_ivf']] = 0.
            out.append((obs[:, j] * _fl(fl, self.lmax, self.device)).to(_CPLX[self.dtype]))
        return tuple(out)

    def cut(self, teb):
        """The l >= lmin cut of the masked chain's filtered alms."""
        c = _fl((np.arange(self.lmax + 1) >= self.cfg['lmin_ivf']) * 1., self.lmax,
                self.device)
        return tuple(x * c for x in teb)

    # ------------------------------------------------------------ masked sims and solves
    def _sims_sht(self):
        return sht(self.inp.grid, self.lmax, torch.float64, False, self.device)

    def maps(self, idxs):
        """T, Q, U maps of map sims: the beamed CMB synthesised on the grid plus noise."""
        s = self._sims_sht()
        bl = _fl(self.inp.transf, self.lmax, self.device)
        cmb = torch.stack([self.inp.sims.cmb(int(i)) for i in idxs])
        noise = torch.stack([self.inp.sims.noise_maps(int(i)) for i in idxs])
        t = s.alm2map(cmb[:, 0] * bl) + noise[:, 0]
        q, u = s.alm2map_spin(cmb[:, 1] * bl, cmb[:, 2] * bl, 2)
        return t, q + noise[:, 1], u + noise[:, 2]

    def _rescal(self):
        ls = np.arange(self.lmax + 1, dtype=float)
        r = np.sqrt(ls * (ls + 1.) / (2. * np.pi))
        r[0] = 1.
        return r

    def _ninv_t(self, m):
        """Inverse noise per steradian with the monopole and dipole deprojected."""
        g, inp = self.inp.grid, self.inp
        ninv = torch.as_tensor(inp.ninv_t, device=self.device)
        om = torch.as_tensor(g.omega(), device=self.device)
        th = torch.as_tensor(g.theta, device=self.device)[:, None]
        ph = torch.as_tensor(2. * np.pi * np.arange(g.nphi) / g.nphi, device=self.device)
        P = torch.stack([torch.ones_like(om), torch.cos(th).expand_as(om),
                         torch.sin(th) * torch.cos(ph), torch.sin(th) * torch.sin(ph)])
        PtNP = torch.einsum('arp,brp->ab', P * ninv, P)
        n = m * ninv
        coef = torch.linalg.solve(PtNP, torch.einsum('arp,brp->ab', P, n))   # (4, B)
        n = n - ninv * torch.einsum('ab,arp->brp', coef, P)
        return n / om

    def residual_t(self, tmaps, ivf_t):
        """|b - A x| / |b| of the T system (S^-1 + B^T Y^T N^-1 Y B) x = B^T Y^T N^-1 m,
        rescaled by R_l = sqrt(l (l + 1) / 2 pi), with x from the filtered alms
        ivf = x R_l / (R_l^2 C_l)."""
        s, lmax = self._sims_sht(), self.lmax
        r = self._rescal()
        dl = r ** 2 * self.inp.cls['tt'][:lmax + 1]
        bdl = _fl(self.inp.transf * _cli(r), lmax, self.device)
        x = ivf_t * _fl(dl * _cli(r), lmax, self.device)
        b = s.map2alm(self._ninv_t(tmaps)) * bdl
        ax = x * _fl(_cli(dl), lmax, self.device) \
            + s.map2alm(self._ninv_t(s.alm2map(x * bdl))) * bdl
        return _rel(b - ax, b, lmax)

    def residual_p(self, qmaps, umaps, ivf_e, ivf_b):
        """The same for the E/B system of the Q/U maps."""
        s, lmax = self._sims_sht(), self.lmax
        r = self._rescal()
        dle = r ** 2 * self.inp.cls['ee'][:lmax + 1]
        dlb = r ** 2 * self.inp.cls['bb'][:lmax + 1]
        bdl = _fl(self.inp.transf * _cli(r), lmax, self.device)
        ninv = torch.as_tensor(self.inp.ninv_p / self.inp.grid.omega(), device=self.device)
        xe = ivf_e * _fl(dle * _cli(r), lmax, self.device)
        xb = ivf_b * _fl(dlb * _cli(r), lmax, self.device)

        def op(q, u):
            e, b = s.map2alm_spin(q * ninv, u * ninv, 2)
            return e * bdl, b * bdl
        be, bb = op(qmaps, umaps)
        ae, ab = op(*s.alm2map_spin(xe * bdl, xb * bdl, 2))
        ae = ae + xe * _fl(_cli(dle), lmax, self.device)
        ab = ab + xb * _fl(_cli(dlb), lmax, self.device)
        return _rel(torch.cat([be - ae, bb - ab], -1), torch.cat([be, bb], -1), lmax, 2)

    # ------------------------------------------------------------ estimators and spectra
    def estimators(self, teb, teb_data, teb_prev, teb_warm):
        """{(key, leg): (g, c)} for legs dd, ds (with the data sim), ss (each sim with
        the one before it, `teb_prev`), and {key: (mf of the even warm sims, mf of the odd
        ones)}. Each leg field is synthesised once a row (the sims, the data sim and the
        previous sims; then the warm sims), and every product is analysed in one batch."""
        B, W = teb[0].shape[0], teb_warm[0].shape[0]
        rows = tuple(torch.cat([a, b, c]) for a, b, c in zip(teb, teb_data, teb_prev))
        data, prev = B, list(range(B + 1, 2 * B + 1))
        qlm, mf = {}, {}
        for k, q in self.qes.items():
            d = None
            for la, lb in q.terms:
                fa, fb = q.leg(la, rows), q.leg(lb, rows)
                if d is None:
                    d = torch.zeros((3 * B + 2,) + fa.shape[1:], dtype=fa.dtype,
                                    device=fa.device)
                for i in range(B):          # one map at a time: no batch-sized temporaries
                    d[i] += fa[i] * fb[i]
                    d[B + i] += fa[i] * fb[data] + fa[data] * fb[i]
                    d[2 * B + i] += fa[i] * fb[prev[i]] + fa[prev[i]] * fb[i]
                del fa, fb
                fa, fb = q.leg(la, teb_warm), q.leg(lb, teb_warm)
                for j, h in ((3 * B, range(0, W, 2)), (3 * B + 1, range(1, W, 2))):
                    for w in h:
                        d[j] += fa[w] * fb[w] / len(h)
                del fa, fb
            g, c = q.analyse(d)
            del d
            half = torch.ones(g.shape[0], 1, dtype=g.real.dtype, device=g.device)
            half[B:3 * B] = 0.5
            g, c = g * half, c * half
            qlm[(k, 'dd')] = (g[:B], c[:B])
            qlm[(k, 'ds')] = (g[B:2 * B], c[B:2 * B])
            qlm[(k, 'ss')] = (g[2 * B:3 * B], c[2 * B:3 * B])
            mf[k] = (g[3 * B], g[3 * B + 1])
        return qlm, mf

    def spectra(self, qlm, mf):
        """{(key, leg): (B, lmax_qlm + 1)}: dd with the split-half mean fields subtracted."""
        out = {}
        for (k, leg), (g, _) in qlm.items():
            if leg == 'dd':
                out[(k, leg)] = alm2cl(g - mf[k][0], g - mf[k][1], self.lq)
            else:
                out[(k, leg)] = alm2cl(g, g, self.lq)
        return out


def _rel(r, b, lmax, ncomp=1):
    """sqrt(<r, r> / <b, b>) per row, with weights 1 (m = 0) and 2 (m > 0)."""
    _, ms = lm_of_index(lmax)
    w = torch.as_tensor(np.tile(np.where(ms == 0, 1., 2.), ncomp), device=r.device)
    num = (w * (r.real ** 2 + r.imag ** 2)).sum(-1)
    den = (w * (b.real ** 2 + b.imag ** 2)).sum(-1)
    return torch.sqrt(num / den)
