"""Masked curved-sky chain with joint T/P C^-1 filtering: the program's CinvTP (T monopole
and dipole marginalised, dense T/E/B block) under IVFCinvJTP -> IVFFtl -> QELib (the GMV
key 'p') -> QeClLib, as upstream's library_cinv_jTP feeds its estimators, on the map sims of
masked_cinv: seeded CMB alms, beamed and synthesised on the grid by the program, plus seeded
white pixel noise maps. IVFCinvJTP solves one sim a solve. The dense block loads from and
stores to a fixed directory of the checkout, one a filter precision."""
import os
from types import SimpleNamespace

import torch

from .masked_cinv import MapSims, _logged, chain_libs, failed_sims


def build(cfg, traffic, inp, device, cache_dir, control=None):
    from plancklens_tpu_torch.ops.sht import SHT, gl_geometry
    from plancklens_tpu_torch.utils import alm as ualm
    from plancklens_tpu_torch.utils.cachers import cacher_npy
    from plancklens_tpu_torch.models.cinv import CinvTP, IVFCinvJTP
    lmax = cfg['lmax_ivf']
    fname = cfg['filter_dtype'] if control != 'f32' else 'float32'
    fdt = getattr(torch, fname)
    qdt = getattr(torch, cfg['qe_dtype'] if control not in ('f32', 'qe_f32') else 'float32')
    geom = gl_geometry(cfg['grid_lmax'])
    dense = cacher_npy(os.path.join(cache_dir, 'dense_%s_%s' % (cfg['name'], fname)))
    ct = cfg['cinv_tp']
    cinv_tp = CinvTP(lmax, geom, inp.cls, inp.transf, inp.ninv_t, inp.ninv_p,
                     eps_min=ct['eps_min'], iter_max=ct['iter_max'],
                     lmax_dense=ct['lmax_dense'], marge_monopole=ct['marge_monopole'],
                     marge_dipole=ct['marge_dipole'],
                     dense_cacher=dense, dtype=fdt, device=device)
    log = []
    _logged(cinv_tp, 'tp', log)
    sims = MapSims(inp, SHT(geom, lmax, dtype=fdt, device=device), ualm.almxfl, lmax)
    libs = chain_libs(cfg, traffic, inp, IVFCinvJTP(cinv_tp, sims, inp.cls), qdt, device)

    def end_step(idxs):
        """The step's maps and the sims whose joint solve stopped at its iteration limit
        above its criterion (one solve a sim, in the order of idxs)."""
        maps, sims.maps = sims.maps, {}
        failed = failed_sims(idxs, [(it, rel) for _, it, rel in log], cinv_tp)
        solves = list(log)
        log.clear()
        return dict(maps=maps, solves=solves, failed=failed)
    return SimpleNamespace(**libs, end_step=end_step, solvers={'tp': cinv_tp}, log=log)
