"""Polymorphic map loading (port of plancklens_tpu/utils/maps.py:14-31; role of reference
plancklens/qcinv/util.py:63-79 read_map).

A 'map spec' is any of:
  - an array (returned as float64 numpy)
  - a path ('.npy', '.npz' with a 'map' entry, or '.fits' via utils.fitsio)
  - a callable returning a map
  - a list/tuple of specs, resolved recursively and multiplied together (the reference's
    mask-product convention, e.g. [ninv_map, mask1_path, mask2_path])
"""
import numpy as np


def read_map(spec):
    if callable(spec):
        return np.asarray(spec(), dtype=float)
    if isinstance(spec, str):
        if spec.endswith('.npy'):
            return np.asarray(np.load(spec), dtype=float)
        if spec.endswith('.npz'):
            return np.asarray(np.load(spec)['map'], dtype=float)
        if spec.endswith('.fits') or spec.endswith('.fits.gz'):
            from .fitsio import read_map as _fits_read_map
            return np.asarray(_fits_read_map(spec), dtype=float)
        raise ValueError('unrecognised map file type: ' + spec)
    if isinstance(spec, (list, tuple)):
        out = read_map(spec[0])
        for s in spec[1:]:
            out = out * read_map(s)
        return out
    return np.asarray(spec, dtype=float)
