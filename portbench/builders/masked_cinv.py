"""Masked curved-sky chain with exact C^-1 filtering: the program's CinvT (monopole and
dipole marginalised, dense block) and CinvP (dense block) under IVFCinv -> IVFFtl ->
QELib (ptt, p_p) -> QeClLib, as params/anisofilt_example_torch.py builds it, on the
benchmark's sims: seeded CMB alms, beamed and synthesised on the grid by the program, plus
seeded white pixel noise maps. The dense preconditioner blocks load from and store to a
fixed directory of the checkout (the parameter file's dense_cacher)."""
import os
from types import SimpleNamespace

import numpy as np
import torch

from ..harness.chain import StepCacher


class MapSims:
    """Beamed CMB synthesised on the grid by the program, plus the seeded noise maps (the
    program's map-sim interface). Keeps the maps of the current step."""

    def __init__(self, inp, sht, almxfl, lmax):
        self.inp, self.sht, self.almxfl, self.lmax = inp, sht, almxfl, lmax
        self.maps = {}

    def hashdict(self):
        return {'seed': self.inp.sims.seed}

    def _beamed(self, alm):
        return self.almxfl(alm, self.lmax, self.inp.transf)

    def get_sim_tmap(self, idx):
        t = self.sht.alm2map(self._beamed(self.inp.sims.cmb(idx)[0]))
        t = t + self.inp.sims.noise_maps(idx)[0]
        self.maps[('t', int(idx))] = t
        return t

    def get_sim_pmap(self, idx):
        cmb = self.inp.sims.cmb(idx)
        q, u = self.sht.alm2map_spin((self._beamed(cmb[1]), self._beamed(cmb[2])), 2)
        n = self.inp.sims.noise_maps(idx)
        q, u = q + n[1], u + n[2]
        self.maps[('p', int(idx))] = (q, u)
        return q, u


def _logged(solver, kind, log):
    """solve_wf that appends (kind, iterations, relative residual) to `log`."""
    fn = solver.solve_wf

    def solve_wf(*a, **kw):
        x, it, rel = fn(*a, **kw)
        log.append((kind, int(it), rel))
        return x, it, rel
    solver.solve_wf = solve_wf


def failed_sims(idxs, runs, solver):
    """The sims of `idxs` whose solve stopped at the solver's iteration limit above its
    criterion: `runs` [(iterations, relative residual a row)] of the step's solves, in
    order, each row the next sim of idxs."""
    rows = [(it, r) for it, rel in runs for r in torch.as_tensor(rel).reshape(-1).tolist()]
    return {int(i) for i, (it, r) in zip(idxs, rows)
            if it >= solver.iter_max and r > solver.eps_min}


def chain_libs(cfg, traffic, inp, ivfs_raw, qdt, device):
    """The parfile's libraries over a raw filter: IVFFtl (l >= lmin) -> IVFShuffle (ds with
    the data sim, ss with the previous sim) -> QELib -> QeClLib (split-half mean field of
    the warm-up sims on dd)."""
    from plancklens_tpu_torch.models.filt import IVFFtl, IVFShuffle
    from plancklens_tpu_torch.models.qest import QELib
    from plancklens_tpu_torch.models.qecl import QeClLib
    lmax, lq = cfg['lmax_ivf'], cfg['lmax_qlm']
    cut = (np.arange(lmax + 1) >= cfg['lmin_ivf']) * 1.
    ivfs = IVFFtl(ivfs_raw, cut, cut, cut)
    ivfs_d = IVFShuffle(ivfs, lambda i: -1)
    ivfs_s = IVFShuffle(ivfs, lambda i: i - 1)
    cachers = [StepCacher() for _ in range(6)]
    qlms = [QELib(ivfs, i2, inp.cl_weight, lmax, lq, cacher=c,
                  dtype=None if qdt == torch.float64 else qdt, device=device)
            for i2, c in zip((ivfs, ivfs_d, ivfs_s), cachers)]
    warm = np.arange(traffic['warm_sims'])
    qcls = [QeClLib(q, q, mf, lmax_qlm=lq, cacher=c)
            for q, mf, c in zip(qlms, (warm, [], []), cachers[3:])]
    return dict(DEVICE=torch.device(device), ivfs=ivfs, ivfs_raw=ivfs_raw,
                qlms_dd=qlms[0], qlms_ds=qlms[1], qlms_ss=qlms[2],
                qcls_dd=qcls[0], qcls_ds=qcls[1], qcls_ss=qcls[2],
                mc_sims_mf_dd=warm, cachers=cachers)


def build(cfg, traffic, inp, device, cache_dir, control=None):
    from plancklens_tpu_torch.ops.sht import SHT, gl_geometry
    from plancklens_tpu_torch.utils import alm as ualm
    from plancklens_tpu_torch.utils.cachers import cacher_npy
    from plancklens_tpu_torch.models.cinv import CinvT, CinvP, IVFCinv
    lmax = cfg['lmax_ivf']
    fdt = getattr(torch, cfg['filter_dtype'] if control != 'f32' else 'float32')
    qdt = getattr(torch, cfg['qe_dtype'] if control not in ('f32', 'qe_f32') else 'float32')
    geom = gl_geometry(cfg['grid_lmax'])
    dense = cacher_npy(os.path.join(cache_dir, 'dense_%s' % cfg['name']))
    ct, cp = cfg['cinv_t'], cfg['cinv_p']
    cinv_t = CinvT(lmax, geom, inp.cls, inp.transf, inp.ninv_t,
                   marge_monopole=ct['marge_monopole'], marge_dipole=ct['marge_dipole'],
                   eps_min=ct['eps_min'], iter_max=ct['iter_max'],
                   lmax_dense=ct['lmax_dense'], dense_cacher=dense, dtype=fdt, device=device)
    cinv_p = CinvP(lmax, geom, inp.cls, inp.transf, inp.ninv_p, eps_min=cp['eps_min'],
                   iter_max=cp['iter_max'], lmax_dense=cp['lmax_dense'], dense_cacher=dense,
                   dtype=fdt, device=device)
    log = []
    _logged(cinv_t, 't', log)
    _logged(cinv_p, 'p', log)
    sims = MapSims(inp, SHT(geom, lmax, dtype=fdt, device=device), ualm.almxfl, lmax)
    libs = chain_libs(cfg, traffic, inp, IVFCinv(cinv_t, cinv_p, sims, inp.cls), qdt, device)

    def end_step(idxs):
        """The step's maps and the sims whose solve stopped at its iteration limit above
        its criterion (T solves, then P solves, in the order of idxs)."""
        maps, sims.maps = sims.maps, {}
        failed = set()
        for kind, solver in (('t', cinv_t), ('p', cinv_p)):
            failed |= failed_sims(idxs, [(it, rel) for k, it, rel in log if k == kind],
                                  solver)
        solves = list(log)
        log.clear()
        return dict(maps=maps, solves=solves, failed=failed)
    return SimpleNamespace(**libs, end_step=end_step, solvers={'t': cinv_t, 'p': cinv_p},
                           log=log)
