r"""Simulation libraries: reproducible Gaussian CMB + noise skies in harmonic space.

Port of plancklens_tpu/models/sims.py (`unit_phases`, `cls_to_coloring`, `CMBUnlLib` and
its fixed-phi variant, `MapsNlevLib`, `CMBLenLib` and its fixed-phi variant,
`ExternalAlmLib`, `AlmNlevLib`, `SimLibShuffle`, `SimLibAdd`, `AlmMapLib`,
`MapsLenNlevLib`), `HealpixMapLib`, the HEALPix maps of an alm library, and
`HealpixAlmLib`, the alms analysed from those maps. Determinism comes from one
`torch.Generator` per (library seed, simulation index), seeded through numpy's
SeedSequence (pixel noise: per (seed, index, field tag)); the streams differ from the
reference's `jax.random` draws. For parity tests each library also takes `phases=`, a
callable idx -> numpy (nfields, nalm) complex unit phases (e.g. the reference's own,
through `compat.phases_from_numpy`), which replaces the generator; `MapsLenNlevLib` takes
`noise=`, a callable (idx, tag) -> numpy unit-variance pixel noise
(`compat.noise_from_numpy`).

Correlated fields are coloured by a per-multipole eigen-decomposition of the N_f x N_f
spectral matrix, as in the reference (reference: plancklens/sims/cmbs.py:25-101).
"""
import os

import numpy as np
import torch

from ..utils import alm as ualm
from ..utils.hashing import clhash

_CDTYPE = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def sim_generator(seed, idx, device, tag=None):
    """Generator of simulation idx of a library seeded `seed`; idx -1 is the 'data'
    convention (reference: plancklens/sims/planck2018_sims.py:47-49). `tag` picks one of
    several independent streams of the same simulation (the pixel-noise fields)."""
    entropy = [int(seed), int(idx) + 1] + ([] if tag is None else [int(tag)])
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) & ((1 << 63) - 1))


def unit_phases(gen, nfields, lmax, device, dtype=torch.float64):
    """(nfields, nalm) unit-variance complex alm phases: <|xi_lm|^2> = 1, m=0 real.

    Drawn in the real-harmonic basis so statistics are exact by construction
    (reference analogue: plancklens/sims/phas.py:157-195)."""
    rlm = torch.randn((nfields, (lmax + 1) ** 2), generator=gen, device=device, dtype=dtype)
    return ualm.rlm2alm(rlm, lmax)


def cls_to_coloring(cls_dict, fields, lmax):
    """(lmax+1, nf, nf) matrix square root L(l) with L L^T = spectral matrix, via eigh
    (reference: plancklens/sims/cmbs.py:46-49)."""
    nf = len(fields)
    mat = np.zeros((lmax + 1, nf, nf))
    for i, f1 in enumerate(fields):
        for j, f2 in enumerate(fields):
            cl = cls_dict.get(f1 + f2, cls_dict.get(f2 + f1, None))
            if cl is not None:
                mat[:, i, j] = cl[:lmax + 1] if len(cl) > lmax else \
                    np.pad(cl, (0, lmax + 1 - len(cl)))
    w, v = np.linalg.eigh(mat)
    w = np.maximum(w, 0.)
    return np.einsum('lij,lj->lij', v, np.sqrt(w))


def _phases(lib, seed, idx, nfields):
    if lib.phases is not None:
        return torch.as_tensor(np.array(lib.phases(idx))).to(device=lib.device,
                                                               dtype=_CDTYPE[lib.dtype])
    return unit_phases(sim_generator(seed, idx, lib.device), nfields, lib.lmax,
                       lib.device, lib.dtype)


class CMBUnlLib:
    """Unlensed (or Gaussian-lensed-spectra) correlated CMB alm simulations.

    Args:
        cls: dict of spectra ('tt', 'te', 'ee', 'bb', 'pp', 'pt', ... as available)
        lmax: band limit of the simulations
        fields: tuple of field letters to generate, e.g. ('t', 'e', 'b', 'p')
        seed: integer seed of the whole library
        device, dtype: where and in which real precision the alms are made
        phases: optional callable idx -> numpy (nfields, nalm) unit phases
    """

    def __init__(self, cls, lmax, fields=('t', 'e', 'b', 'p'), seed=0, *, device,
                 dtype=torch.float64, phases=None):
        self.cls = cls
        self.lmax = lmax
        self.fields = tuple(fields)
        self.seed = seed
        self.device = torch.device(device)
        self.dtype = dtype
        self.phases = phases
        L = cls_to_coloring(cls, self.fields, lmax)
        self._L = torch.as_tensor(L, dtype=dtype, device=self.device)

    def hashdict(self):
        return {'lmax': self.lmax, 'fields': ''.join(self.fields), 'seed': self.seed,
                **{k: clhash(v) for k, v in self.cls.items()}}

    def _sim(self, idx):
        xi = _phases(self, self.seed, idx, len(self.fields))          # (nf, nalm)
        L = self._L[ualm._dev_index(self.lmax, self.device, 'l')]    # (nalm, nf, nf)
        return torch.einsum('afg,ga->fa', L.to(xi.dtype), xi)

    def get_sim_alms(self, idx):
        """(nfields, nalm) alms of simulation idx."""
        return self._sim(int(idx))

    def get_sim_alms_batch(self, idxs):
        return torch.stack([self._sim(int(i)) for i in np.atleast_1d(idxs)])

    def _field_index(self, f):
        return self.fields.index(f)

    def get_sim_tlm(self, idx):
        return self.get_sim_alms(idx)[self._field_index('t')]

    def get_sim_elm(self, idx):
        return self.get_sim_alms(idx)[self._field_index('e')]

    def get_sim_blm(self, idx):
        return self.get_sim_alms(idx)[self._field_index('b')]

    def get_sim_plm(self, idx):
        return self.get_sim_alms(idx)[self._field_index('p')]

    def get_sim_olm(self, idx):
        """Curl deflection potential (field rotation) alm: drawn whenever 'o' is in
        `fields` and the cls carry 'oo' (reference: plancklens/sims/cmbs.py:79-81)."""
        return self.get_sim_alms(idx)[self._field_index('o')]

    def get_sim_alm(self, idx, field):
        """Generic per-field accessor (reference: plancklens/sims/cmbs.py:71-77)."""
        assert field in self.fields, (field, self.fields)
        return self.get_sim_alms(idx)[self._field_index(field)]


class CMBUnlLibFixedPhi(CMBUnlLib):
    """Unlensed CMB sims sharing ONE lensing potential across all indices (reference:
    plancklens/sims/cmbs.py:236-261 sims_cmb_unl_fixed_phi): the phi slot of every
    simulation returns the same plm (the base library's sim-`phi_idx` draw, or an explicit
    `plm`), the other fields keep their per-index draws (including the component that
    would correlate them with their own per-index phi, as in the reference). The fixed plm
    is a copy held on the library's device; each draw gets its own tensor."""

    def __init__(self, cls, lmax, fields=('t', 'e', 'b', 'p'), seed=0, plm=None,
                 phi_idx=0, *, device, dtype=torch.float64, phases=None):
        super().__init__(cls, lmax, fields=fields, seed=seed, device=device, dtype=dtype,
                         phases=phases)
        assert 'p' in self.fields, self.fields
        self._phi_idx = int(phi_idx)
        self._external_plm = plm is not None
        if plm is not None:
            plm = torch.as_tensor(np.asarray(plm) if not torch.is_tensor(plm) else plm)
            assert tuple(plm.shape) == (ualm.getsize(lmax),), (tuple(plm.shape), lmax)
            self._plm_fix = plm.to(device=self.device, dtype=_CDTYPE[dtype]).clone()
        else:
            self._plm_fix = super().get_sim_alms(self._phi_idx)[self._field_index('p')].clone()

    def hashdict(self):
        d = super().hashdict()
        d['fixed_phi'] = clhash(np.abs(self._plm_fix.cpu().numpy())) \
            if self._external_plm else ('sim', self._phi_idx)
        return d

    def get_sim_alms(self, idx):
        alms = super().get_sim_alms(idx).clone()
        alms[self._field_index('p')] = self._plm_fix
        return alms

    def get_sim_alms_batch(self, idxs):
        alms = super().get_sim_alms_batch(idxs).clone()
        alms[:, self._field_index('p')] = self._plm_fix[None]
        return alms


class MapsNlevLib:
    """Beam-convolved CMB + homogeneous white noise, in harmonic space: the observed sky
    is transf * alm + noise alm with N_l = (nlev * pi/180/60)^2, and
    obs = b_l cmb + noise holds exactly (reference: plancklens/sims/maps.py:177-275).

    Args:
        cmb_lib: CMBUnlLib-like with get_sim_alms
        transf: transfer function/beam b_l (array, lmax+1)
        nlev_t, nlev_p: white noise levels in uK-arcmin
        seed: noise seed (independent of the CMB seed)
        phases: optional callable idx -> numpy (3, nalm) unit noise phases
    """

    def __init__(self, cmb_lib, transf, nlev_t, nlev_p, seed=1000, phases=None):
        self.cmb_lib = cmb_lib
        self.lmax = cmb_lib.lmax
        self.device = cmb_lib.device
        self.dtype = cmb_lib.dtype
        self.transf = np.asarray(transf)[:self.lmax + 1]
        self.nlev_t = nlev_t
        self.nlev_p = nlev_p
        self.seed = seed
        self.phases = phases
        self._bl = torch.as_tensor(self.transf, dtype=self.dtype, device=self.device)

    def hashdict(self):
        return {'cmb': self.cmb_lib.hashdict(), 'transf': clhash(self.transf),
                'nlev_t': self.nlev_t, 'nlev_p': self.nlev_p}

    def _sig(self, i):
        return (self.nlev_t if i == 0 else self.nlev_p) / 60. / 180. * np.pi

    def _noise_phases(self, idx):
        return _phases(self, self.seed ^ 0x5eed, idx, 3)

    def _obs(self, idx):
        noise = self._noise_phases(idx)
        cmb = self.cmb_lib.get_sim_alms(idx)
        bl = self._bl[ualm._dev_index(self.lmax, self.device, 'l')]
        cl = self.cmb_lib
        return tuple(cmb[cl._field_index(f)] * bl + noise[i] * self._sig(i)
                     for i, f in enumerate('teb'))

    def get_sim_tlm(self, idx):
        return self._obs(int(idx))[0]

    def get_sim_elm(self, idx):
        return self._obs(int(idx))[1]

    def get_sim_blm(self, idx):
        return self._obs(int(idx))[2]

    def _noise(self, idx, i):
        """Noise-only alm of sim idx (0=t, 1=e, 2=b), the exact realisation entering the
        observed alm (reference: plancklens/sims/maps.py:246-275 get_sim_{t,e,b}noise)."""
        return self._noise_phases(int(idx))[i] * self._sig(i)

    def get_sim_tnoise(self, idx):
        return self._noise(idx, 0)

    def get_sim_enoise(self, idx):
        return self._noise(idx, 1)

    def get_sim_bnoise(self, idx):
        return self._noise(idx, 2)

    def get_sim_teblm_batch(self, idxs):
        """3-tuple of (nsims, nalm) observed alms."""
        obs = [self._obs(int(i)) for i in np.atleast_1d(idxs)]
        return tuple(torch.stack([o[f] for o in obs]) for f in range(3))


class ExternalAlmLib:
    """Simulation library backed by on-disk alm files, the role of the reference's
    NERSC FFP10 loaders (reference: plancklens/sims/planck2018_sims.py): idx >= 0 loads
    '<prefix>_<field>lm_%04d.<ext>', idx == -1 the data files '<prefix>_<field>lm_dat.<ext>'.

    ext='fits' reads healpy-format alm FITS files directly (utils.fitsio); ext='npy'
    reads raw triangular-layout arrays. Alms come back as complex128 tensors on `device`.
    """

    def __init__(self, tdir, prefix='sim', fields=('t', 'e', 'b'), ext='npy', *, device):
        assert ext in ('npy', 'fits'), ext
        self.tdir = tdir
        self.prefix = prefix
        self.fields = fields
        self.ext = ext
        self.device = torch.device(device)

    def hashdict(self):
        return {'tdir': self.tdir, 'prefix': self.prefix, 'fields': ''.join(self.fields)}

    def _fn(self, f, idx):
        tag = 'dat' if idx == -1 else '%04d' % idx
        return os.path.join(self.tdir, '%s_%slm_%s.%s' % (self.prefix, f, tag, self.ext))

    def _get(self, f, idx):
        if self.ext == 'fits':
            from ..utils.fitsio import read_alm
            a = read_alm(self._fn(f, idx))
        else:
            a = np.load(self._fn(f, idx))
        return torch.as_tensor(a).to(device=self.device, dtype=torch.complex128)

    def get_sim_tlm(self, idx):
        return self._get('t', idx)

    def get_sim_elm(self, idx):
        return self._get('e', idx)

    def get_sim_blm(self, idx):
        return self._get('b', idx)

    def get_sim_plm(self, idx):
        return self._get('p', idx)

    def get_sim_teblm_batch(self, idxs):
        """3-tuple of (nsims, nalm) alms."""
        idxs = [int(i) for i in np.atleast_1d(idxs)]
        return tuple(torch.stack([self._get(f, i) for i in idxs]) for f in 'teb')


class AlmNlevLib:
    """Beam-convolved observations from any harmonic sim library plus homogeneous white
    noise (role of reference plancklens/sims/planck2018_sims.py:122-158 ffp10cmb_widnoise:
    noise-free CMB alms, e.g. an ExternalAlmLib over FFP10 products, re-observed with a
    chosen white noise level). The noise of sim idx and field tag (0 t, 1 e, 2 b; idx -1
    the data) is drawn from the generator of (seed, idx, tag) on `device`, or taken from
    `noise`, a callable (idx, tag) -> numpy (nalm,) complex unit phases (the reference's
    jax.random draws differ from these, ROADMAP fault 3.3)."""

    def __init__(self, alm_lib, lmax, transf, nlev_t, nlev_p, seed=3000,
                 dtype=torch.float64, *, device, noise=None):
        self.alm_lib = alm_lib
        self.lmax = lmax
        self.transf = np.asarray(transf)[:lmax + 1]
        self.nlev_t = nlev_t
        self.nlev_p = nlev_p
        self.seed = seed
        self.device = torch.device(device)
        self.dtype = dtype
        self.noise = noise

    def hashdict(self):
        return {'alms': self.alm_lib.hashdict(), 'transf': clhash(self.transf),
                'nlev_t': self.nlev_t, 'nlev_p': self.nlev_p, 'seed': self.seed}

    def _unit(self, idx, tag):
        if self.noise is not None:
            n = torch.as_tensor(np.array(self.noise(int(idx), tag)))
            assert tuple(n.shape) == (ualm.getsize(self.lmax),), tuple(n.shape)
            return n.to(device=self.device, dtype=_CDTYPE[self.dtype])
        return unit_phases(sim_generator(self.seed, idx, self.device, tag), 1, self.lmax,
                           self.device, self.dtype)[0]

    def _obs(self, alm, idx, tag, nlev):
        alm = torch.as_tensor(alm).to(device=self.device, dtype=_CDTYPE[self.dtype])
        alm = ualm.alm_copy(alm, ualm.getlmax(alm.shape[-1]), self.lmax)
        noise = self._unit(idx, tag) * (nlev / 60. / 180. * np.pi)
        return ualm.almxfl(alm, self.lmax, self.transf) + noise

    def get_sim_tlm(self, idx):
        return self._obs(self.alm_lib.get_sim_tlm(idx), idx, 0, self.nlev_t)

    def get_sim_elm(self, idx):
        return self._obs(self.alm_lib.get_sim_elm(idx), idx, 1, self.nlev_p)

    def get_sim_blm(self, idx):
        return self._obs(self.alm_lib.get_sim_blm(idx), idx, 2, self.nlev_p)

    def get_sim_teblm_batch(self, idxs):
        """3-tuple of (nsims, nalm) observed alms."""
        idxs = [int(i) for i in np.atleast_1d(idxs)]
        return tuple(torch.stack([getattr(self, 'get_sim_%slm' % f)(i) for i in idxs])
                     for f in 'teb')


class SimLibShuffle:
    """Index-remapped view of a sim library (reference: plancklens/sims/utils.py:3-17)."""

    def __init__(self, sim_lib, idx_map):
        self.sim_lib = sim_lib
        self.idx_map = idx_map if callable(idx_map) \
            else (lambda i, d=dict(idx_map): d.get(i, i))

    def hashdict(self):
        return {'sim_lib': self.sim_lib.hashdict(), 'shuffled': True}

    def __getattr__(self, name):
        if name.startswith('get_sim_'):
            inner = getattr(self.sim_lib, name)
            return lambda idx, *a, **kw: inner(self.idx_map(idx), *a, **kw)
        return getattr(self.sim_lib, name)


class SimLibAdd:
    """Weighted sum of two sim libraries, applied to sim and/or data indices (reference:
    plancklens/sims/utils.py:20-91, used to add extra power to noise sims)."""

    def __init__(self, lib_a, lib_b, w_a=1., w_b=1., sims_only=False, dat_only=False):
        self.a = lib_a
        self.b = lib_b
        self.wa, self.wb = w_a, w_b
        self.sims_only = sims_only
        self.dat_only = dat_only

    def hashdict(self):
        return {'a': self.a.hashdict(), 'b': self.b.hashdict(), 'wa': self.wa,
                'wb': self.wb, 'sims_only': self.sims_only, 'dat_only': self.dat_only}

    def _active(self, idx):
        if self.sims_only:
            return idx >= 0
        if self.dat_only:
            return idx == -1
        return True

    def _add(self, ra, rb):
        """wa ra + wb rb elementwise, tuple returns (get_sim_pmap's (Q, U)) included."""
        if isinstance(ra, (tuple, list)):
            return type(ra)(self.wa * x + self.wb * y for x, y in zip(ra, rb))
        return self.wa * ra + self.wb * rb

    def __getattr__(self, name):
        if name.endswith('_batch') and name.startswith('get_sim_'):
            # batched accessors take an index array: the scalar gate is ambiguous there,
            # so a batch must be all active or all inactive
            fa = getattr(self.a, name)

            def get_batch(idxs, *args, **kw):
                idxs = np.atleast_1d(idxs)
                ra = fa(idxs, *args, **kw)
                if all(self._active(int(i)) for i in idxs):
                    return self._add(ra, getattr(self.b, name)(idxs, *args, **kw))
                if not any(self._active(int(i)) for i in idxs):
                    return ra
                raise ValueError('SimLibAdd batch mixing active and inactive indices '
                                 '(sims_only/dat_only): split the batch')
            return get_batch
        if name.startswith('get_sim_'):
            fa = getattr(self.a, name)

            def get(idx, *args, **kw):
                ra = fa(idx, *args, **kw)
                if self._active(idx):
                    return self._add(ra, getattr(self.b, name)(idx, *args, **kw))
                return ra
            return get
        return getattr(self.a, name)


class AlmMapLib:
    """Map-space view of an alm simulation library on a ring geometry: the 'observed sky'
    interface the masked (cinv) filters consume (reference: plancklens_tpu/models/sims.py
    AlmMapLib; role of plancklens/sims/maps.py cmb_maps). The maps are synthesised on the
    solver grid from the library's alms, in real dtype `dtype` on `device` (the alms must
    lie there too, as for SHT).

    Args:
        alm_lib: library with get_sim_tlm/elm/blm (e.g. MapsNlevLib)
        geom: RingGeometry of the maps
        lmax: band limit of the alms
    """

    def __init__(self, alm_lib, geom, lmax, dtype=torch.float64, *, device):
        from ..ops.sht import SHT
        self.alm_lib = alm_lib
        self.lmax = lmax
        self.sht = SHT(geom, lmax, dtype=dtype, device=device)

    def hashdict(self):
        return {'alm_lib': self.alm_lib.hashdict(), 'lmax': self.lmax,
                'geom': self.sht.geom.hashdict()}

    def get_sim_tmap(self, idx):
        """(nrings, nphi) temperature map of simulation idx."""
        return self.sht.alm2map(self.alm_lib.get_sim_tlm(idx))

    def get_sim_pmap(self, idx):
        """(Q, U) maps of simulation idx, from its E and B alms."""
        elm = self.alm_lib.get_sim_elm(idx)
        blm = self.alm_lib.get_sim_blm(idx)
        return self.sht.alm2map_spin((elm, blm), 2)


class HealpixMapLib:
    """HEALPix maps of an alm simulation library (role of plancklens/sims/maps.py
    cmb_maps): RING-ordered T and (Q, U) maps at `nside`, synthesised from the library's
    alms (band limit `lmax`) by HealpixSHT in real dtype `dtype` on `device`.

    Args:
        alm_lib: library with get_sim_tlm/elm/blm and get_sim_teblm_batch at `lmax`
        nside: HEALPix resolution of the maps
        lmax: band limit of the alms
    """

    def __init__(self, alm_lib, nside, lmax, dtype=torch.float64, *, device):
        from ..ops.sht.healpix import HealpixSHT
        self.alm_lib = alm_lib
        self.nside = int(nside)
        self.lmax = lmax
        self.sht = HealpixSHT(nside, lmax, dtype=dtype, use_ring_weights=False, device=device)

    def hashdict(self):
        return {'alm_lib': self.alm_lib.hashdict(), 'nside': self.nside, 'lmax': self.lmax}

    def get_sim_tmap(self, idx):
        """(npix,) temperature map of simulation idx."""
        return self.sht.alm2map(self.alm_lib.get_sim_tlm(idx))

    def get_sim_pmap(self, idx):
        """(Q, U) maps of simulation idx, from its E and B alms."""
        elm = self.alm_lib.get_sim_elm(idx)
        blm = self.alm_lib.get_sim_blm(idx)
        return self.sht.alm2map_spin((elm, blm), 2)

    def get_sim_tqumap_batch(self, idxs):
        """(T, Q, U), each (nsims, npix), of simulations idxs: one synthesis a field."""
        t, e, b = self.alm_lib.get_sim_teblm_batch([int(i) for i in np.atleast_1d(idxs)])
        q, u = self.sht.alm2map_spin((e, b), 2)
        return self.sht.alm2map(t), q, u


class HealpixAlmLib:
    """The alms of a HealpixMapLib's maps as healpy's map2alm gives them, iter 3 with no
    ring weights (the analysis of plancklens/filt/filt_simple.py:346-407,
    library_fullsky_sepTP): the sims of a map-based full-sky analysis as an alm library,
    for filt.IVFSepTP. A batch's uncached sims are analysed in one transform call a
    field; their alms stay on the device for the last 16 sims read, so that the ds and ss
    legs never analyse a map twice."""
    ITER = 3

    def __init__(self, map_lib):
        from ..utils.cachers import cacher_mem
        self.map_lib = map_lib
        self.sht = map_lib.sht
        self.cacher = cacher_mem(maxsize=3 * 16)

    def hashdict(self):
        return {'map_lib': self.map_lib.hashdict(), 'iter': self.ITER}

    @staticmethod
    def _fn(idx, f):
        return ('sim_%04d_%slm' % (idx, f)) if idx >= 0 else 'dat_%slm' % f

    def get_sim_teblm_batch(self, idxs):
        """(T, E, B) alms, each (nsims, nalm), of simulations idxs."""
        idxs = [int(i) for i in np.atleast_1d(idxs)]
        have = {i: tuple(self.cacher.load(self._fn(i, f)) for f in 'teb')
                for i in dict.fromkeys(idxs)
                if all(self.cacher.is_cached(self._fn(i, f)) for f in 'teb')}
        todo = [i for i in dict.fromkeys(idxs) if i not in have]
        if todo:
            t, q, u = self.map_lib.get_sim_tqumap_batch(todo)
            tlm = self.sht.map2alm(t, iter=self.ITER)
            del t
            elm, blm = self.sht.map2alm_spin((q, u), 2, iter=self.ITER)
            for j, i in enumerate(todo):
                have[i] = tuple(x[j].clone() for x in (tlm, elm, blm))
                for f, x in zip('teb', have[i]):
                    self.cacher.cache(self._fn(i, f), x)
        return tuple(torch.stack([have[i][j] for i in idxs]) for j in range(3))

    def get_sim_tlm(self, idx):
        return self.get_sim_teblm_batch([idx])[0][0]

    def get_sim_elm(self, idx):
        return self.get_sim_teblm_batch([idx])[1][0]

    def get_sim_blm(self, idx):
        return self.get_sim_teblm_batch([idx])[2][0]


class CMBLenLib:
    """Lensed CMB simulations: unlensed T/E/B + phi (and an optional curl potential) drawn
    from their joint spectra at lmax + dlmax, lensed by the deflection-remap operator
    (reference: plancklens_tpu/models/sims.py:196-284; plancklens/sims/cmbs.py:104-233).
    Maps are made on the given geometry; harmonic-space observations come from re-analysing
    the lensed maps (exact on the GL grid for the band-limited part).

    Args:
        cls_unl: dict of unlensed spectra incl. 'pp' (and 'oo' with 'o' in fields)
        lmax: band limit of the outputs
        geom: output RingGeometry
        fields, seed: as CMBUnlLib's, at lmax + dlmax
        dlmax: extra band-limit margin of the unlensed skies entering the remapping
        oversample, order: the interpolation's source grid and stencil (ops/lensing)
        dtype, device: precision and place of the sims, the lensing and the transforms
        phases: optional callable idx -> numpy (nfields, nalm) unit phases at lmax + dlmax
    """

    def __init__(self, cls_unl, lmax, geom, fields=('t', 'e', 'b', 'p'), seed=0,
                 dlmax=128, oversample=4.0, order=9, dtype=torch.float64, *, device,
                 phases=None):
        from ..ops.lensing import Lensing
        from ..ops.sht import SHT
        self.lmax = lmax
        self.lmax_unl = lmax + dlmax
        self.geom = geom
        self.dtype = dtype
        self.unl_lib = CMBUnlLib(cls_unl, self.lmax_unl, fields=fields, seed=seed,
                                 device=device, dtype=dtype, phases=phases)
        self.device = self.unl_lib.device
        self.lensing = Lensing(geom, self.lmax_unl, lmax_p=self.lmax_unl,
                               oversample=oversample, order=order, dtype=dtype,
                               device=device)
        self.sht = SHT(geom, lmax, dtype=dtype, device=device)

    def hashdict(self):
        return {'unl': self.unl_lib.hashdict(), 'lmax': self.lmax,
                'geom': self.geom.hashdict()}

    def get_sim_plm(self, idx):
        return ualm.alm_copy(self.unl_lib.get_sim_plm(idx), self.lmax_unl, self.lmax)

    def get_sim_olm(self, idx):
        """Curl potential alm of sim idx, band-limited to lmax. A drawn curl potential also
        deflects the maps (ops.lensing.deflection_field's curl term), as in the reference
        package (plancklens itself draws it but does not lens with it, cmbs.py:79-81, 196)."""
        return ualm.alm_copy(self.unl_lib.get_sim_olm(idx), self.lmax_unl, self.lmax)

    def get_sim_alm(self, idx, field):
        """Generic per-field accessor (reference: plancklens/sims/cmbs.py:169-182)."""
        return {'t': self.get_sim_tlm, 'e': self.get_sim_elm, 'b': self.get_sim_blm,
                'p': self.get_sim_plm, 'o': self.get_sim_olm}[field](idx)

    def _olm_unl(self, alms):
        """Curl potential entering the deflection (None when 'o' is not simulated)."""
        if 'o' not in self.unl_lib.fields:
            return None
        return alms[self.unl_lib._field_index('o')]

    def get_sim_tmap(self, idx):
        """Lensed temperature map on the geometry, (nrings, nphi)."""
        alms = self.unl_lib.get_sim_alms(idx)
        f = self.unl_lib._field_index
        return self.lensing.alm2lenmap(alms[f('t')], alms[f('p')], olm=self._olm_unl(alms))[0]

    def get_sim_pmap(self, idx):
        """Lensed (Q, U) maps on the geometry."""
        alms = self.unl_lib.get_sim_alms(idx)
        f = self.unl_lib._field_index
        q, u = self.lensing.alm2lenmap_spin((alms[f('e')], alms[f('b')]), alms[f('p')], 2,
                                            olm=self._olm_unl(alms))
        return q[0], u[0]

    def get_sim_tlm(self, idx):
        """Lensed tlm, band-limited to lmax (GL analysis of the lensed map)."""
        return self.sht.map2alm(self.get_sim_tmap(idx))

    def get_sim_eblm(self, idx):
        return self.sht.map2alm_spin(self.get_sim_pmap(idx), 2)

    def get_sim_elm(self, idx):
        return self.get_sim_eblm(idx)[0]

    def get_sim_blm(self, idx):
        return self.get_sim_eblm(idx)[1]


class CMBLenLibFixedPhi(CMBLenLib):
    """Lensed CMB sims with a common deflection field for every index (reference:
    plancklens/sims/cmbs.py:263-280 sims_cmb_len_fixed_phi): the unlensed library is a
    CMBUnlLibFixedPhi, so every sim is lensed by the same potential while the unlensed
    T/E/B vary. `plm`, if given, is at the internal band limit lmax + dlmax."""

    def __init__(self, cls_unl, lmax, geom, fields=('t', 'e', 'b', 'p'), seed=0,
                 dlmax=128, oversample=4.0, order=9, plm=None, phi_idx=0,
                 dtype=torch.float64, *, device, phases=None):
        super().__init__(cls_unl, lmax, geom, fields=fields, seed=seed, dlmax=dlmax,
                         oversample=oversample, order=order, dtype=dtype, device=device,
                         phases=phases)
        self.unl_lib = CMBUnlLibFixedPhi(cls_unl, self.lmax_unl, fields=fields, seed=seed,
                                         plm=plm, phi_idx=phi_idx, device=device,
                                         dtype=dtype, phases=phases)


class MapsLenNlevLib:
    """Beam-convolved lensed CMB maps + homogeneous white pixel noise on a ring geometry
    (reference: plancklens_tpu/models/sims.py:534-622; plancklens/sims/maps.py:101-173): the
    map-space observed sky the masked (cinv) filters consume.

    Pixel noise: sigma_pix = (nlev in uK arcmin, as rad) / sqrt(Omega_pix), with Omega_pix
    from the geometry's quadrature weights (the filters' per-steradian convention). It is
    drawn on the library's device from a generator per (seed, idx, tag), tag 0 for T and 1
    for the (Q, U) pair, or taken from `noise`, a callable (idx, tag) -> numpy unit-variance
    maps of shape (nrings, nphi) for tag 0 and (2, nrings, nphi) for tag 1.

    Args:
        len_lib: CMBLenLib-like with get_sim_tmap/get_sim_eblm and its `sht` on the geometry
        transf: beam b_l; applied in harmonic space before the final synthesis
        nlev_t, nlev_p: white noise levels in uK-arcmin
        seed: noise seed (independent of the CMB seed)
        noise: optional callable (idx, tag) -> numpy unit noise maps
    """

    def __init__(self, len_lib, transf, nlev_t, nlev_p, seed=2000, noise=None):
        self.len_lib = len_lib
        self.geom = len_lib.geom
        self.lmax = len_lib.lmax
        self.device = len_lib.device
        self.dtype = len_lib.sht.dtype
        self.transf = np.asarray(transf)[:self.lmax + 1]
        self.nlev_t = nlev_t
        self.nlev_p = nlev_p
        self.seed = seed
        self.noise = noise
        g = self.geom
        omega = np.outer(g.weight, np.full(g.nphi, 2. * np.pi / g.nphi))
        self._sig_t_np = (nlev_t / 60. / 180. * np.pi) / np.sqrt(omega)
        self._sig_p_np = (nlev_p / 60. / 180. * np.pi) / np.sqrt(omega)
        self._sig_t = torch.as_tensor(self._sig_t_np, dtype=self.dtype, device=self.device)
        self._sig_p = torch.as_tensor(self._sig_p_np, dtype=self.dtype, device=self.device)

    def hashdict(self):
        return {'len': self.len_lib.hashdict(), 'transf': clhash(self.transf),
                'nlev_t': self.nlev_t, 'nlev_p': self.nlev_p, 'seed': self.seed}

    def ninv_t(self):
        """Inverse pixel noise variance of T, host numpy (nrings, nphi)."""
        return 1. / self._sig_t_np ** 2

    def ninv_p(self):
        """Inverse pixel noise variance of Q and U, host numpy (nrings, nphi)."""
        return 1. / self._sig_p_np ** 2

    def _unit_noise(self, idx, tag):
        shape = ((2,) if tag == 1 else ()) + (self.geom.nrings, self.geom.nphi)
        if self.noise is not None:
            n = torch.as_tensor(np.array(self.noise(int(idx), tag)))
            assert tuple(n.shape) == shape, (tuple(n.shape), shape)
            return n.to(device=self.device, dtype=self.dtype)
        return torch.randn(shape, generator=sim_generator(self.seed, idx, self.device, tag),
                           device=self.device, dtype=self.dtype)

    def get_sim_tmap(self, idx):
        sht = self.len_lib.sht
        tlm = ualm.almxfl(sht.map2alm(self.len_lib.get_sim_tmap(idx)), self.lmax, self.transf)
        return sht.alm2map(tlm) + self.get_sim_tnoise(idx)

    def get_sim_pmap(self, idx):
        elm, blm = self.len_lib.get_sim_eblm(idx)
        elm = ualm.almxfl(elm, self.lmax, self.transf)
        blm = ualm.almxfl(blm, self.lmax, self.transf)
        q, u = self.len_lib.sht.alm2map_spin((elm, blm), 2)
        nq, nu = self._pnoise(idx)
        return q + nq, u + nu

    def get_sim_tnoise(self, idx):
        """Noise-only T map of sim idx: the realisation entering get_sim_tmap (reference:
        plancklens/sims/maps.py:136-148)."""
        return self._unit_noise(idx, 0) * self._sig_t

    def _pnoise(self, idx):
        n = self._unit_noise(idx, 1)
        return n[0] * self._sig_p, n[1] * self._sig_p

    def get_sim_qnoise(self, idx):
        """Noise-only Q map (reference: plancklens/sims/maps.py:150-160)."""
        return self._pnoise(idx)[0]

    def get_sim_unoise(self, idx):
        """Noise-only U map (reference: plancklens/sims/maps.py:162-172)."""
        return self._pnoise(idx)[1]
