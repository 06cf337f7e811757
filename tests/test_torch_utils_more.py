"""Port parity: the host leftovers of plancklens_tpu_torch.utils against the JAX package
on the same seed-made numpy inputs: `alm.alm_splice` and `maps.projectmap` (within 1e-15
of max), `maps.mask_hash` (equal tokens for every kind of spec), `stopwatch` and
`enumerate_progress` (equal strings on the same clock), and the sqlite stores `npdb` /
`fldb` (a database written by either package reads back in the other)."""
import os
import time

import numpy as np
import pytest
import torch

from plancklens_tpu import utils as rutils
from plancklens_tpu.utils import alm as ralm, maps as rmaps, sql as rsql
from plancklens_tpu.ops.sht import gl_geometry as r_gl_geometry
import plancklens_tpu_torch.utils as putils
from plancklens_tpu_torch.utils import alm as palm, maps as pmaps, sql as psql
from plancklens_tpu_torch.ops.sht import gl_geometry as p_gl_geometry

torch.set_num_threads(1)


def _alm(rng, shape, lmax):
    n = ralm.getsize(lmax)
    return rng.standard_normal(shape + (n,)) + 1j * rng.standard_normal(shape + (n,))


@pytest.mark.parametrize('lmax_lo,lmax_hi,lsplit,shape',
                         [(10, 20, 6, ()), (20, 20, 0, (3,)), (32, 16, 12, (2,)),
                          (8, 24, 8, (2, 2))])
def test_alm_splice_matches_reference(lmax_lo, lmax_hi, lsplit, shape):
    rng = np.random.RandomState(9 + lmax_lo)
    lo, hi = _alm(rng, shape, lmax_lo), _alm(rng, shape, lmax_hi)
    ref = np.asarray(ralm.alm_splice(lo, hi, lsplit))
    out = palm.alm_splice(torch.as_tensor(lo), torch.as_tensor(hi), lsplit)
    assert out.shape == ref.shape and out.dtype == torch.complex128
    assert np.abs(out.numpy() - ref).max() <= 1e-15 * np.abs(ref).max()
    ls = ralm._lm_indices(lmax_hi)[0]
    assert np.array_equal(out.numpy()[..., ls > lsplit], hi[..., ls > lsplit])


@pytest.mark.parametrize('as_tensor', [False, True])
@pytest.mark.parametrize('lon_lat,npts,lcell', [((0., -45.), 33, 30.), ((123., 20.), 16, 45.),
                                                ((359., 80.), 21, 60.)])
def test_projectmap_matches_reference(as_tensor, lon_lat, npts, lcell):
    rgeom, pgeom = r_gl_geometry(64), p_gl_geometry(64)
    rng = np.random.RandomState(int(lon_lat[0]) + npts)
    rmap = rng.standard_normal((rgeom.nrings, rgeom.nphi))
    ref = np.asarray(rmaps.projectmap(rmap, rgeom, lcell, npts, lon_lat=lon_lat))
    out = pmaps.projectmap(torch.as_tensor(rmap) if as_tensor else rmap, pgeom, lcell, npts,
                           lon_lat=lon_lat)
    assert isinstance(out, np.ndarray) and out.shape == (npts, npts)
    assert np.abs(out - ref).max() <= 1e-15 * np.abs(ref).max()


def _spec(kind):
    rng = np.random.RandomState(3)
    arr = (rng.standard_normal(64) > 0.).astype(float)
    return {'none': None, 'path': 'maps/mask.fits.gz', 'npy_path': '/a/b/c.npy',
            'callable': (lambda: 1), 'array': arr, 'float_array': rng.standard_normal(40),
            'list': [arr, 'x.y', None], 'tuple': ('p/q.npz', arr)}[kind]


@pytest.mark.parametrize('kind', ['none', 'path', 'npy_path', 'callable', 'array',
                                  'float_array', 'list', 'tuple'])
def test_mask_hash_tokens_equal(kind):
    spec = _spec(kind)
    for dtype in (bool, np.float16):
        ref = rmaps.mask_hash(spec, dtype=dtype)
        assert pmaps.mask_hash(spec, dtype=dtype) == ref
        if isinstance(spec, np.ndarray):   # a tensor spec hashes by value, as its array
            assert pmaps.mask_hash(torch.as_tensor(spec), dtype=dtype) == ref


class _Clock:
    def __init__(self, steps):
        self.t, self.steps = 1000., list(steps)

    def __call__(self):
        self.t += self.steps.pop(0) if self.steps else 0.
        return self.t


def test_stopwatch_strings_equal(monkeypatch):
    steps = [0., 3.5, 61.2, 3725.9, 0.4]
    outs = []
    for mod in (rutils, putils):
        monkeypatch.setattr(time, 'time', _Clock(steps))
        sw = mod.stopwatch()
        outs.append((sw.lap(), sw.lap(), sw.elapsed(), sw.lap()))
    assert outs[0] == outs[1]
    assert outs[1][2] == '1:03:10'


def test_enumerate_progress_strings_equal(monkeypatch, capsys):
    seq = ['a', 'b', 'c']
    outs = []
    for mod in (rutils, putils):
        monkeypatch.setattr(time, 'time', _Clock([0., 1.25, 70., 2.]))
        items = list(mod.enumerate_progress(seq, label='sims'))
        outs.append((items, capsys.readouterr().err))
    assert outs[0] == outs[1]
    assert outs[1][1] == '\rsims 1/3  [0:01]\rsims 2/3  [1:11]\rsims 3/3  [1:13]\n'


@pytest.mark.parametrize('writer', ['jax', 'torch'])
def test_npdb_fldb_read_across_packages(writer, tmp_path):
    w, r = (rsql, psql) if writer == 'jax' else (psql, rsql)
    rng = np.random.RandomState(5)
    arrs = {'x': rng.standard_normal(7), 'c': rng.standard_normal((2, 3)) + 1j,
            'i': np.arange(4, dtype=np.int32)}
    fn = str(tmp_path / 'sub' / 'a.db')
    db = w.npdb(fn)
    for k, v in arrs.items():
        db.add(k, torch.as_tensor(v) if writer == 'torch' and k == 'x' else v)
    db.add('x', np.zeros(2))                     # add-if-absent: the first write stays
    fl = w.fldb(str(tmp_path / 'f.db'))
    fl.add('a', 3.14)
    fl.add('a', 2.)
    db.con.close()
    fl.con.close()
    db2, fl2 = r.npdb(fn), r.fldb(str(tmp_path / 'f.db'))
    for k, v in arrs.items():
        got = db2.get(k)
        assert got.dtype == v.dtype and np.array_equal(got, v), k
    assert db2.is_cached('x') and not db2.is_cached('y')
    assert np.array_equal(db2.load('i'), arrs['i'])
    assert fl2.get('a') == 3.14 and fl2.get('b') is None
    db2.remove('x')
    assert db2.get('x') is None
