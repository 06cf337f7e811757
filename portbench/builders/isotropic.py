"""Full-sky chain with isotropic filtering on harmonic sims: the program's IVFSepTP ->
QELib (ptt, p_p) -> QeClLib, as its parameter files build it, on the benchmark's sims."""
from types import SimpleNamespace

import numpy as np
import torch

from ..harness.chain import StepCacher
from ..inputs import ARCMIN


class HarmonicSims:
    """Observed sky alms b_l X + n of the seeded inputs (the program's sim-library
    interface)."""

    def __init__(self, inp):
        self.inp = inp

    def hashdict(self):
        return {'seed': self.inp.sims.seed}

    def _obs(self, idx):
        return self.inp.observed(int(idx))

    def get_sim_tlm(self, idx):
        return self._obs(idx)[0]

    def get_sim_elm(self, idx):
        return self._obs(idx)[1]

    def get_sim_blm(self, idx):
        return self._obs(idx)[2]

    def get_sim_teblm_batch(self, idxs):
        obs = torch.stack([self._obs(i) for i in np.atleast_1d(idxs)])
        return obs[:, 0], obs[:, 1], obs[:, 2]


def filters(cfg, inp):
    """(ftl, fel, fbl): 1 / (C_l + N_l / b_l^2) for lmin <= l <= lmax, else 0."""
    ls = np.arange(cfg['lmax_ivf'] + 1)
    b2 = inp.transf ** 2
    out = []
    for key, nlev in (('tt', cfg['nlev_t']), ('ee', cfg['nlev_p']), ('bb', cfg['nlev_p'])):
        fl = 1. / (inp.cls[key][:cfg['lmax_ivf'] + 1] + (nlev * ARCMIN) ** 2 / b2)
        fl[ls < cfg['lmin_ivf']] = 0.
        out.append(fl)
    return out


def build(cfg, traffic, inp, device, cache_dir, control=None):
    from plancklens_tpu_torch.models.filt import IVFSepTP, IVFShuffle
    from plancklens_tpu_torch.models.qest import QELib
    from plancklens_tpu_torch.models.qecl import QeClLib
    lmax, lq = cfg['lmax_ivf'], cfg['lmax_qlm']
    ftl, fel, fbl = filters(cfg, inp)
    ivfs = IVFSepTP(HarmonicSims(inp), inp.transf, inp.cls, ftl, fel, fbl)
    ivfs_d = IVFShuffle(ivfs, lambda i: -1)
    ivfs_s = IVFShuffle(ivfs, lambda i: i - 1)
    dtype = getattr(torch, cfg['qe_dtype'])
    cachers = [StepCacher() for _ in range(6)]
    qlms = [QELib(ivfs, i2, inp.cl_weight, lmax, lq, cacher=c, dtype=dtype, device=device)
            for i2, c in zip((ivfs, ivfs_d, ivfs_s), cachers)]
    warm = np.arange(traffic['warm_sims'])
    qcls = [QeClLib(q, q, mf, lmax_qlm=lq, cacher=c)
            for q, mf, c in zip(qlms, (warm, [], []), cachers[3:])]
    return SimpleNamespace(DEVICE=torch.device(device), ivfs=ivfs, qlms_dd=qlms[0],
                           qlms_ds=qlms[1], qlms_ss=qlms[2], qcls_dd=qcls[0],
                           qcls_ds=qcls[1], qcls_ss=qcls[2], mc_sims_mf_dd=warm,
                           cachers=cachers, end_step=lambda idxs: {'failed': set()},
                           solvers={})
