"""Cacher strategy objects (reference: plancklens/helpers/cachers.py:5-87).

The framework's products are pure functions of configuration + index, so caching is an
optimisation, not a correctness requirement (unlike the reference where the filesystem
cache is the data-exchange mechanism between MPI ranks).

A torch tensor handed to `cacher_mem` stays where it is, on its device; `cacher_npy` and
`cacher_pk` copy it to the host (trace.to_host) before they write."""
import os
import numpy as np
import torch

from . import trace


def _write(path, dump):
    """dump(file) into a temporary file beside `path`, then renamed onto it: a reader
    never sees a partial entry, even while another process writes the same one (the ranks
    of a --mesh run compute and cache the same products)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = '%s.%d.tmp' % (path, os.getpid())
    with open(tmp, 'wb') as f:
        dump(f)
    os.replace(tmp, path)


class cacher_none:
    def cache(self, fn, obj):
        pass

    def load(self, fn):
        assert 0, 'nothing cached here'

    def is_cached(self, fn):
        return False


class cacher_mem:
    """In-memory cacher; with `maxsize` it holds that many entries, dropping the least
    recently cached or loaded first."""

    def __init__(self, maxsize=None):
        self._cache = {}
        self.maxsize = maxsize

    def cache(self, fn, obj):
        self._cache.pop(fn, None)
        if self.maxsize is not None and len(self._cache) >= self.maxsize:
            self._cache.pop(next(iter(self._cache)))
        self._cache[fn] = obj if isinstance(obj, (tuple, torch.Tensor)) else np.asarray(obj)

    def load(self, fn):
        if self.maxsize is not None:
            self._cache[fn] = self._cache.pop(fn)
        return self._cache[fn]

    def is_cached(self, fn):
        return fn in self._cache


class cacher_npy:
    def __init__(self, lib_dir, verbose=False):
        self.lib_dir = lib_dir
        self.verbose = verbose
        os.makedirs(lib_dir, exist_ok=True)

    def _path(self, fn):
        return os.path.join(self.lib_dir, fn + '.npy')

    def cache(self, fn, obj):
        if isinstance(obj, torch.Tensor):
            obj = trace.to_host(obj, fn)
        _write(self._path(fn), lambda f: np.save(f, np.asarray(obj)))
        if self.verbose:
            print('cached ' + self._path(fn))

    def load(self, fn):
        return np.load(self._path(fn))

    def is_cached(self, fn):
        return os.path.exists(self._path(fn))


class cacher_pk:
    """Pickle-backed cacher for arbitrary python objects (tuples of arrays, dicts, stats
    instances; reference: plancklens/helpers/cachers.py cacher_pk)."""

    def __init__(self, lib_dir, verbose=False):
        self.lib_dir = lib_dir
        self.verbose = verbose
        os.makedirs(lib_dir, exist_ok=True)

    def _path(self, fn):
        return os.path.join(self.lib_dir, fn + '.pk')

    def cache(self, fn, obj):
        import pickle
        if isinstance(obj, torch.Tensor):
            obj = trace.to_host(obj, fn)
        _write(self._path(fn), lambda f: pickle.dump(obj, f))
        if self.verbose:
            print('cached ' + self._path(fn))

    def load(self, fn):
        import pickle
        with open(self._path(fn), 'rb') as f:
            return pickle.load(f)

    def is_cached(self, fn):
        return os.path.exists(self._path(fn))
