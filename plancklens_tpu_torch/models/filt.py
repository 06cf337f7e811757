r"""Inverse-variance filtering libraries (the 'ivfs' interface): isotropic (separate or
joint T/P), apodised-mask, shuffled, and l- or (l, m)-rescaled.

Port of plancklens_tpu/models/filt.py (the masked filters are models/cinv.py). The ivfs
contract (reference: plancklens/filt/filt_simple.py:16-183):
  get_sim_tlm/elm/blm(idx)        inverse-variance filtered alms  (bar X = F X_data)
  get_sim_tmliklm/emliklm/bmliklm Wiener-filtered alms            (X^WF = C_l bar X)
  get_ftl/fel/fbl                 isotropic approximation of the filter
  get_tal                         transfer-function pseudo-inverse
Filtering is one almxfl on the device of the simulation alms (IVFJTP: a 3x3 matrix per
l; IVFApoSepTP: an analysis of the apodised maps first).
"""
import numpy as np
import torch

from ..utils import alm as ualm
from ..utils.cls import cli, cldict2arr, extcl
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


class IVFApoSepTP:
    """Apodised-mask pseudo-inverse filtering of map-space sims (role of reference
    plancklens/filt/filt_simple.py:473-535 library_apo_sepTP): maps are multiplied by the
    (presumably apodised) mask, analysed on `device`, and isotropically filtered, bar X =
    fxl/b_l map2alm(apo * X). Wiener legs and the ivfs interface come with the same
    conventions as IVFSepTP; the filtered alms are cached on the device.

    Args:
        sim_lib: map-space sim library (get_sim_tmap/get_sim_pmap) on `geom`
        geom: RingGeometry of the maps
        apomask: (nrings, nphi) apodised mask (e.g. utils.cls.apodize_mask output)
        cl_len: spectra for the Wiener legs
        transf: beam/transfer function
        ftl, fel, fbl: isotropic filters
        dtype, device: real precision and place of the analysis
    """

    def __init__(self, sim_lib, geom, apomask, cl_len, transf, ftl, fel, fbl,
                 dtype=torch.float64, *, device):
        from ..ops.sht import SHT
        self.sim_lib = sim_lib
        self.geom = geom
        self.apomask = np.asarray(apomask)
        self.cl = cl_len
        self.transf = np.asarray(transf)
        self.ftl = np.asarray(ftl)
        self.fel = np.asarray(fel)
        self.fbl = np.asarray(fbl)
        self.lmax_fl = max(len(ftl), len(fel), len(fbl)) - 1
        assert len(self.transf) >= self.lmax_fl + 1
        self._sht = SHT(geom, self.lmax_fl, dtype=dtype, device=device)
        self.device = self._sht.device
        self._apo = torch.as_tensor(self.apomask, dtype=dtype, device=self.device)
        self._cache = {}

    def hashdict(self):
        return {'sim_lib': self.sim_lib.hashdict(), 'apomask': clhash(self.apomask),
                'transf': clhash(self.transf),
                'cl_len': {k: clhash(self.cl[k]) for k in ['tt', 'ee', 'bb']},
                'ftl': clhash(self.ftl), 'fel': clhash(self.fel), 'fbl': clhash(self.fbl)}

    def get_fmask(self):
        return np.copy(self.apomask)

    def get_tal(self, a):
        assert a.lower() in ['t', 'e', 'b']
        return cli(self.transf)

    def get_ftl(self):
        return np.copy(self.ftl)

    def get_fel(self):
        return np.copy(self.fel)

    def get_fbl(self):
        return np.copy(self.fbl)

    def _fl(self, f):
        fl = np.zeros(self.lmax_fl + 1)
        n = min(len(f), self.lmax_fl + 1)
        fl[:n] = f[:n] * cli(self.transf[:n])
        return fl

    def _map(self, m):
        return self._sht._on_device(m).to(self._apo.dtype) * self._apo

    def get_sim_tlm(self, idx):
        key = ('t', idx)
        if key not in self._cache:
            alm = self._sht.map2alm(self._map(self.sim_lib.get_sim_tmap(idx)))
            self._cache[key] = ualm.almxfl(alm, self.lmax_fl, self._fl(self.ftl))
        return self._cache[key]

    def _eb(self, idx):
        key = ('eb', idx)
        if key not in self._cache:
            q, u = self.sim_lib.get_sim_pmap(idx)
            e, b = self._sht.map2alm_spin((self._map(q), self._map(u)), 2)
            self._cache[key] = (ualm.almxfl(e, self.lmax_fl, self._fl(self.fel)),
                                ualm.almxfl(b, self.lmax_fl, self._fl(self.fbl)))
        return self._cache[key]

    def get_sim_elm(self, idx):
        return self._eb(idx)[0]

    def get_sim_blm(self, idx):
        return self._eb(idx)[1]

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


class IVFJTP:
    """Joint temperature-polarization isotropic filtering, harmonic inputs (reference:
    plancklens/filt/filt_simple.py:187-343): bar X = F X_obs / b_l with the 3x3
    per-multipole matrix F = (C + N/b^2)^{-1} (including TE mixing), and joint Wiener legs
    X^WF = C_w bar X mixing T/E/B. F and C_w are applied as six per-l vectors
    (utils.alm.TEBMatrix) on the device of the simulation alms.

    Args:
        sim_lib: harmonic-space sim library (get_sim_tlm/elm/blm [+ _batch])
        transf: beam b_l (array or dict 't','e','b')
        cl_weights: spectra for the Wiener legs ('tt','te','ee','bb', optionally 'tb','eb')
        fal: dict of 3x3 filter entries ('tt','te','ee','bb', optionally 'tb','eb')
    """

    def __init__(self, sim_lib, transf, cl_weights, fal):
        transfd = transf if isinstance(transf, dict) else {'t': transf, 'e': transf,
                                                           'b': transf}
        self.sim_lib = sim_lib
        self.transf = transfd
        self.cl = cl_weights
        self.fal = {k: np.asarray(v) for k, v in fal.items()}
        self.lmax_fl = max(len(v) for v in self.fal.values()) - 1
        self._mats = {}

    def hashdict(self):
        return {'sim_lib': self.sim_lib.hashdict(), 'transf': clhash(self.transf['t']),
                **{'fal' + k: clhash(v) for k, v in self.fal.items()}}

    def get_fal(self):
        return {k: np.copy(v) for k, v in self.fal.items()}

    def get_ftl(self):
        return np.copy(self.fal['tt'])

    def get_fel(self):
        return np.copy(self.fal['ee'])

    def get_fbl(self):
        return np.copy(self.fal['bb'])

    def get_tal(self, a):
        assert a.lower() in ['t', 'e', 'b']
        return cli(self.transf[a.lower()])

    def _fmat(self, lmax):
        """(lmax+1, 3, 3) filtering matrix, zero-padded."""
        F = np.zeros((lmax + 1, 3, 3))
        for k, i, j in [('tt', 0, 0), ('te', 0, 1), ('tb', 0, 2), ('ee', 1, 1),
                        ('eb', 1, 2), ('bb', 2, 2)]:
            if k in self.fal:
                F[:, i, j] = extcl(lmax, self.fal[k])
                F[:, j, i] = F[:, i, j]
        return F

    def _mat(self, which, lmax, device):
        """The filter ('F') or Wiener ('C') matrix at lmax on `device`, made once."""
        key = (which, lmax, device)
        if key not in self._mats:
            if which == 'F':
                m = self._fmat(lmax)
            else:
                m = np.moveaxis(np.stack([np.stack([extcl(lmax, c) for c in row])
                                          for row in cldict2arr(self.cl)]), -1, 0)
            self._mats[key] = ualm.TEBMatrix(m, lmax, device=device)
        return self._mats[key]

    def _bar(self, t, e, b):
        """Beam-deconvolved, then mixed by F: (..., 3, nalm)."""
        lmax = ualm.getlmax(t.shape[-1])
        x = torch.stack([ualm.almxfl(a, lmax, cli(self.transf[f][:lmax + 1]))
                         for a, f in zip((t, e, b), 'teb')], dim=-2)
        return self._mat('F', lmax, x.device)(x)

    def _bar_teb(self, idx):
        return self._bar(self.sim_lib.get_sim_tlm(idx), self.sim_lib.get_sim_elm(idx),
                         self.sim_lib.get_sim_blm(idx))

    def get_sim_tlm(self, idx):
        return self._bar_teb(idx)[0]

    def get_sim_elm(self, idx):
        return self._bar_teb(idx)[1]

    def get_sim_blm(self, idx):
        return self._bar_teb(idx)[2]

    def get_sim_teblm_batch(self, idxs):
        if hasattr(self.sim_lib, 'get_sim_teblm_batch'):
            bar = self._bar(*self.sim_lib.get_sim_teblm_batch(idxs))
        else:
            bar = torch.stack([self._bar_teb(int(i)) for i in np.atleast_1d(idxs)])
        return bar[:, 0], bar[:, 1], bar[:, 2]

    def _wiener_teb(self, idx):
        """Joint Wiener legs C_w bar X (reference: filt_simple.py:294-343)."""
        bar = self._bar_teb(idx)
        return self._mat('C', ualm.getlmax(bar.shape[-1]), bar.device)(bar)

    def get_sim_tmliklm(self, idx):
        return self._wiener_teb(idx)[0]

    def get_sim_emliklm(self, idx):
        return self._wiener_teb(idx)[1]

    def get_sim_bmliklm(self, idx):
        return self._wiener_teb(idx)[2]


class IVFFml:
    """m-dependent rescaling of a filtering library (reference:
    plancklens/filt/filt_util.py:106-182): filtered alms (and the Wiener legs) are
    multiplied by fml(l, m), expanded over the alm layout once per (field, lmax, device)."""

    def __init__(self, ivfs, fmlmat_t, fmlmat_e, fmlmat_b):
        self.ivfs = ivfs
        self._fm = {'t': np.asarray(fmlmat_t), 'e': np.asarray(fmlmat_e),
                    'b': np.asarray(fmlmat_b)}
        self._fml = {}

    def hashdict(self):
        return {'ivfs': self.ivfs.hashdict(),
                **{'fml' + k: clhash(v) for k, v in self._fm.items()}}

    def _apply(self, alm, key):
        lmax = ualm.getlmax(alm.shape[-1])
        ck = (key, lmax, alm.device)
        if ck not in self._fml:
            ls, ms = ualm._lm_indices(lmax)
            self._fml[ck] = torch.as_tensor(self._fm[key][ls, ms], device=alm.device)
        return alm * self._fml[ck].to(ualm._real_dtype(alm))

    def get_sim_tlm(self, idx):
        return self._apply(self.ivfs.get_sim_tlm(idx), 't')

    def get_sim_elm(self, idx):
        return self._apply(self.ivfs.get_sim_elm(idx), 'e')

    def get_sim_blm(self, idx):
        return self._apply(self.ivfs.get_sim_blm(idx), 'b')

    # the Wiener legs carry the same (l, m) rescale (filt_util.py:175-182)
    def get_sim_tmliklm(self, idx):
        return self._apply(self.ivfs.get_sim_tmliklm(idx), 't')

    def get_sim_emliklm(self, idx):
        return self._apply(self.ivfs.get_sim_emliklm(idx), 'e')

    def get_sim_bmliklm(self, idx):
        return self._apply(self.ivfs.get_sim_bmliklm(idx), 'b')

    def _fl_spectrum(self, key, inner_fl):
        """l-spectrum view of the (l, m) rescale: per l, the multiplicity-weighted mean of
        fml over |m| <= l, sqrt-applied at the spectrum level (the reference's heuristic for
        its m-filters, filt_util.py:151-164)."""
        fm = self._fm[key]
        lmaxp1 = min(len(inner_fl), fm.shape[0])
        ls = np.arange(lmaxp1)
        w = np.full(fm.shape[1], 2.)
        w[0] = 1.
        tri = np.tril(np.ones((lmaxp1, min(fm.shape[1], lmaxp1))))
        mean = (fm[:lmaxp1, :tri.shape[1]] * w[None, :tri.shape[1]] * tri).sum(axis=1) \
            / (2. * ls + 1.)
        return np.asarray(inner_fl)[:lmaxp1] * np.sqrt(np.maximum(mean, 0.))

    def get_ftl(self):
        return self._fl_spectrum('t', self.ivfs.get_ftl())

    def get_fel(self):
        return self._fl_spectrum('e', self.ivfs.get_fel())

    def get_fbl(self):
        return self._fl_spectrum('b', self.ivfs.get_fbl())

    def __getattr__(self, name):
        if name == 'get_sim_teblm_batch':
            # rescale the batch per field; an AttributeError from the inner lookup
            # propagates so hasattr() is honest about the batch interface
            inner = getattr(self.ivfs, name)

            def batch(idxs):
                t, e, b = inner(idxs)
                return self._apply(t, 't'), self._apply(e, 'e'), self._apply(b, 'b')
            return batch
        if name.startswith('get_sim_'):
            # refuse to forward filtered-alm accessors it does not rescale: a silent
            # pass-through would return inner-library alms missing the fml factor
            raise AttributeError('IVFFml does not expose %r' % name)
        return getattr(self.ivfs, name)
