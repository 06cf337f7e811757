r"""Simulation libraries: reproducible Gaussian CMB + noise skies in harmonic space.

Port of plancklens_tpu/models/sims.py:22-194, 343-389 and 508-532 (`unit_phases`,
`cls_to_coloring`, `CMBUnlLib`, `MapsNlevLib`, `ExternalAlmLib`, `AlmMapLib`). Determinism
comes from one `torch.Generator` per (library seed, simulation index), seeded through numpy's
SeedSequence; the streams differ from the reference's `jax.random` draws. For parity
tests each library also takes `phases=`, a callable idx -> numpy (nfields, nalm) complex
unit phases (e.g. the reference's own, through `compat.phases_from_numpy`), which
replaces the generator.

Correlated fields are coloured by a per-multipole eigen-decomposition of the N_f x N_f
spectral matrix, as in the reference (reference: plancklens/sims/cmbs.py:25-101).
"""
import os

import numpy as np
import torch

from ..utils import alm as ualm
from ..utils.hashing import clhash

_CDTYPE = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def sim_generator(seed, idx, device):
    """Generator of simulation idx of a library seeded `seed`; idx -1 is the 'data'
    convention (reference: plancklens/sims/planck2018_sims.py:47-49)."""
    state = np.random.SeedSequence([int(seed), int(idx) + 1]).generate_state(1, np.uint64)[0]
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

    def get_sim_alm(self, idx, field):
        """Generic per-field accessor (reference: plancklens/sims/cmbs.py:71-77)."""
        assert field in self.fields, (field, self.fields)
        return self.get_sim_alms(idx)[self._field_index(field)]


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
