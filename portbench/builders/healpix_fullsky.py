"""Full-sky chain on HEALPix map sims (plancklens params/idealized_example.py as upstream
wrote it): the program's HealpixMapLib (the seeded observed alms synthesised to nside maps)
-> HealpixAlmLib (healpy's map2alm, iter 3) -> IVFSepTP (f_l / b_l) -> QELib (ptt, p_p)
-> QeClLib, as its parameter files build them, on the benchmark's sims."""
from types import SimpleNamespace

import numpy as np
import torch

from ..harness.chain import StepCacher
from .isotropic import HarmonicSims, filters


def build(cfg, traffic, inp, device, cache_dir, control=None):
    from plancklens_tpu_torch.models.sims import HealpixAlmLib, HealpixMapLib
    from plancklens_tpu_torch.models.filt import IVFSepTP, IVFShuffle
    from plancklens_tpu_torch.models.qest import QELib
    from plancklens_tpu_torch.models.qecl import QeClLib
    lmax, lq = cfg['lmax_ivf'], cfg['lmax_qlm']
    # the f32 control: maps and HEALPix transforms in f32
    dtype = torch.float32 if control == 'f32' else getattr(torch, cfg['map_dtype'])
    ftl, fel, fbl = filters(cfg, inp)
    maps = HealpixMapLib(HarmonicSims(inp), cfg['nside'], lmax, dtype=dtype, device=device)
    ivfs = IVFSepTP(HealpixAlmLib(maps), inp.transf, inp.cls, ftl, fel, fbl)
    ivfs_d = IVFShuffle(ivfs, lambda i: -1)
    ivfs_s = IVFShuffle(ivfs, lambda i: i - 1)
    qdtype = getattr(torch, cfg['qe_dtype'])
    cachers = [StepCacher() for _ in range(6)]
    qlms = [QELib(ivfs, i2, inp.cl_weight, lmax, lq, cacher=c, dtype=qdtype, device=device)
            for i2, c in zip((ivfs, ivfs_d, ivfs_s), cachers)]
    warm = np.arange(traffic['warm_sims'])
    qcls = [QeClLib(q, q, mf, lmax_qlm=lq, cacher=c)
            for q, mf, c in zip(qlms, (warm, [], []), cachers[3:])]
    return SimpleNamespace(DEVICE=torch.device(device), ivfs=ivfs, qlms_dd=qlms[0],
                           qlms_ds=qlms[1], qlms_ss=qlms[2], qcls_dd=qcls[0],
                           qcls_ds=qcls[1], qcls_ss=qcls[2], mc_sims_mf_dd=warm,
                           cachers=cachers, end_step=lambda idxs: {'failed': set()},
                           solvers={})
