r"""Inverse-variance filtering libraries (the 'ivfs' interface): isotropic, shuffled and
l-rescaled.

Port of plancklens_tpu/models/filt.py:22-153, 258-289 and 290-336 (the masked filters
are models/cinv.py). The ivfs contract (reference:
plancklens/filt/filt_simple.py:16-183):
  get_sim_tlm/elm/blm(idx)        inverse-variance filtered alms  (bar X = F X_data)
  get_sim_tmliklm/emliklm/bmliklm Wiener-filtered alms            (X^WF = C_l bar X)
  get_ftl/fel/fbl                 isotropic approximation of the filter
  get_tal                         transfer-function pseudo-inverse
Filtering is one almxfl on the device of the simulation alms.
"""
import numpy as np

from ..utils import alm as ualm
from ..utils.cls import cli
from ..utils.hashing import clhash


def base_ivfs(ivfs):
    """Unwrap decorator views (forwarding through an `ivfs` attribute) down to the first
    library exposing `get_fmask`; returns the innermost library reached (which may still
    lack get_fmask, e.g. a purely harmonic full-sky library)."""
    base = ivfs
    while not hasattr(base, 'get_fmask') and hasattr(base, 'ivfs'):
        base = base.ivfs
    return base


def mask_geom(ivfs):
    """(mask, geom) of a filtering library: the sky mask exposed by the innermost
    `get_fmask` library (None for maskless legs) and the ring geometry its solver runs
    on when discoverable (None otherwise)."""
    base = base_ivfs(ivfs)
    m = np.asarray(base.get_fmask()) if hasattr(base, 'get_fmask') else None
    if np.ndim(m) == 0:  # scalar full-sky sentinel
        m = None
    geom = getattr(base, 'geom', None)
    if geom is None:
        for attr in ('cinv_t', 'cinv_p', 'cinv_tp'):
            g = getattr(getattr(base, attr, None), 'geom', None)
            if g is not None:
                geom = g
                break
    return m, geom


def fsky_mean(mask_geoms):
    """Aligned masks + area-proportional mean functional for a list of (mask, geom)
    pairs as returned by :func:`mask_geom`. Full-sky legs (mask None) become ones.
    Returns (None, None) when no leg carries a mask, or when the legs' mask grids have
    different shapes (callers degrade to fsky = 1 in both cases). Ring grids are
    quadrature-weighted (reference plain means: plancklens/qecl.py:40-49)."""
    ms = [m for m, _ in mask_geoms]
    shapes = {m.shape for m in ms if m is not None}
    if not shapes or len(shapes) > 1:
        return None, None
    shape = shapes.pop()
    ms = [np.ones(shape) if m is None else m for m in ms]
    geom = next((g for _, g in mask_geoms if g is not None), None)
    if geom is not None and len(shape) == 2 and len(np.asarray(geom.weight)) == shape[0]:
        w = np.outer(np.asarray(geom.weight),
                     np.full(shape[-1], 2. * np.pi / shape[-1]))
        mean = lambda m: float(np.sum(m * w) / (4. * np.pi))
    else:
        mean = lambda m: float(np.mean(m))
    return ms, mean


class IVFSepTP:
    """Isotropic full-sky filtering with independent T and E/B filters, harmonic inputs:
    bar X = ftl/b_l * X_obs with X_obs = b_l X + n (reference:
    plancklens/filt/filt_simple.py:409-470).

    Args:
        sim_lib: harmonic-space sim library (get_sim_tlm/elm/blm [+ _batch])
        transf: beam/transfer function b_l (array or dict with 't','e','b')
        cl_len: spectra used for the Wiener leg (dict 'tt','ee','bb')
        ftl, fel, fbl: isotropic filters (typically 1/(C_l + N_l/b_l^2))
    """

    def __init__(self, sim_lib, transf, cl_len, ftl, fel, fbl):
        transfd = transf if isinstance(transf, dict) else {'t': transf, 'e': transf,
                                                           'b': transf}
        self.sim_lib = sim_lib
        self.transf = transfd
        self.cl = cl_len
        self.ftl = np.asarray(ftl)
        self.fel = np.asarray(fel)
        self.fbl = np.asarray(fbl)
        self.lmax_fl = max(len(ftl), len(fel), len(fbl)) - 1

    def hashdict(self):
        return {'sim_lib': self.sim_lib.hashdict(), 'transf': clhash(self.transf['t']),
                'ftl': clhash(self.ftl), 'fel': clhash(self.fel), 'fbl': clhash(self.fbl)}

    def get_ftl(self):
        return np.copy(self.ftl)

    def get_fel(self):
        return np.copy(self.fel)

    def get_fbl(self):
        return np.copy(self.fbl)

    def get_tal(self, a):
        assert a.lower() in ['t', 'e', 'b']
        return cli(self.transf[a.lower()])

    def _filt(self, alm, f, b):
        lmax = ualm.getlmax(alm.shape[-1])
        fl = np.zeros(lmax + 1)
        n = min(lmax + 1, len(f))
        fl[:n] = f[:n] * cli(b[:n])
        return ualm.almxfl(alm, lmax, fl)

    def get_sim_tlm(self, idx):
        return self._filt(self.sim_lib.get_sim_tlm(idx), self.ftl, self.transf['t'])

    def get_sim_elm(self, idx):
        return self._filt(self.sim_lib.get_sim_elm(idx), self.fel, self.transf['e'])

    def get_sim_blm(self, idx):
        return self._filt(self.sim_lib.get_sim_blm(idx), self.fbl, self.transf['b'])

    def get_sim_teblm_batch(self, idxs):
        t, e, b = self.sim_lib.get_sim_teblm_batch(idxs)
        return (self._filt(t, self.ftl, self.transf['t']),
                self._filt(e, self.fel, self.transf['e']),
                self._filt(b, self.fbl, self.transf['b']))

    # Wiener-filtered alms (reference: plancklens/filt/filt_simple.py:149-183)
    def _wiener(self, alm, key):
        lmax = ualm.getlmax(alm.shape[-1])
        return ualm.almxfl(alm, lmax, self.cl[key][:lmax + 1])

    def get_sim_tmliklm(self, idx):
        return self._wiener(self.get_sim_tlm(idx), 'tt')

    def get_sim_emliklm(self, idx):
        return self._wiener(self.get_sim_elm(idx), 'ee')

    def get_sim_bmliklm(self, idx):
        return self._wiener(self.get_sim_blm(idx), 'bb')


class IVFShuffle:
    """Index-remapped view of an ivfs library — the mechanism behind the ds/ss RDN0 legs
    (reference: plancklens/filt/filt_util.py:186-236)."""

    def __init__(self, ivfs, idx_map):
        self.ivfs = ivfs
        self.idx_map = dict(idx_map) if not callable(idx_map) else idx_map

    def _m(self, idx):
        return self.idx_map(idx) if callable(self.idx_map) else self.idx_map.get(idx, idx)

    def hashdict(self):
        h = {'ivfs': self.ivfs.hashdict()}
        if not callable(self.idx_map):
            h['map'] = tuple(sorted(self.idx_map.items()))
        return h

    def __getattr__(self, name):
        if name == 'get_sim_teblm_batch':
            # batched accessor: remap elementwise; an AttributeError from the inner
            # lookup propagates, so hasattr() reports the batch interface honestly
            inner = getattr(self.ivfs, name)
            return lambda idxs: inner(
                np.array([self._m(int(i)) for i in np.atleast_1d(idxs)]))
        if name.startswith('get_sim_'):
            inner = getattr(self.ivfs, name)
            return lambda idx, *a, **kw: inner(self._m(idx), *a, **kw)
        return getattr(self.ivfs, name)


class IVFFtl:
    """Post-hoc l-rescaling of a filtering library, e.g. for l-cuts
    (reference: plancklens/filt/filt_util.py:39-103)."""

    def __init__(self, ivfs, lfilt_t, lfilt_e, lfilt_b):
        self.ivfs = ivfs
        self.lt = np.asarray(lfilt_t)
        self.le = np.asarray(lfilt_e)
        self.lb = np.asarray(lfilt_b)

    def hashdict(self):
        return {'ivfs': self.ivfs.hashdict(), 'lt': clhash(self.lt),
                'le': clhash(self.le), 'lb': clhash(self.lb)}

    def get_ftl(self):
        return self.ivfs.get_ftl()[:len(self.lt)] * self.lt

    def get_fel(self):
        return self.ivfs.get_fel()[:len(self.le)] * self.le

    def get_fbl(self):
        return self.ivfs.get_fbl()[:len(self.lb)] * self.lb

    def get_tal(self, a):
        return self.ivfs.get_tal(a)

    def _apply(self, alm, fl):
        lmax = ualm.getlmax(alm.shape[-1])
        return ualm.almxfl(alm, lmax, np.pad(fl, (0, max(0, lmax + 1 - len(fl)))))

    def get_sim_tlm(self, idx):
        return self._apply(self.ivfs.get_sim_tlm(idx), self.lt)

    def get_sim_elm(self, idx):
        return self._apply(self.ivfs.get_sim_elm(idx), self.le)

    def get_sim_blm(self, idx):
        return self._apply(self.ivfs.get_sim_blm(idx), self.lb)

    def get_sim_tmliklm(self, idx):
        return self._apply(self.ivfs.get_sim_tmliklm(idx), self.lt)

    def get_sim_emliklm(self, idx):
        return self._apply(self.ivfs.get_sim_emliklm(idx), self.le)

    def get_sim_bmliklm(self, idx):
        return self._apply(self.ivfs.get_sim_bmliklm(idx), self.lb)
