"""Polymorphic map loading (port of plancklens_tpu/utils/maps.py; role of reference
plancklens/qcinv/util.py:63-79 read_map), the flat quick-look projection `projectmap`
and the map-spec token `mask_hash` of cache keys.

A 'map spec' is any of:
  - an array (returned as float64 numpy)
  - a path ('.npy', '.npz' with a 'map' entry, or '.fits' via utils.fitsio)
  - a callable returning a map
  - a list/tuple of specs, resolved recursively and multiplied together (the reference's
    mask-product convention, e.g. [ninv_map, mask1_path, mask2_path])
"""
import numpy as np
import torch


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


def projectmap(rmap, geom, lcell_amin, npts, lon_lat=(0., -45.)):
    """Project a patch of a (nrings, nphi) ring map onto a flat square grid (port of
    plancklens_tpu/utils/maps.py:34-64; role of reference plancklens/utils.py:72-92
    projectmap, for quick-look plots). `rmap` is a torch tensor (any device) or a numpy
    array; the projection is host numpy and returns a (npts, npts) numpy array.

    A cartesian (flat-sky) grid of `npts` x `npts` pixels of side `lcell_amin` arcmin is
    centred on (lon, lat) degrees, and the map is sampled there by bilinear interpolation
    in (theta, phi).
    """
    lon, lat = lon_lat
    assert 0. <= lon <= 360. and -90. <= lat <= 90., (lon, lat)
    if isinstance(rmap, torch.Tensor):
        rmap = rmap.detach().cpu().numpy()
    rmap = np.asarray(rmap)
    nrings, nphi = rmap.shape
    half = lcell_amin / 60. / 180. * np.pi * npts / 2.
    x = np.linspace(-half, half, npts)  # azimuthal offset (radians at patch centre)
    y = np.linspace(-half, half, npts)  # latitude offset
    th0 = (90. - lat) / 180. * np.pi
    ph0 = lon / 180. * np.pi
    th = th0 - y[:, None] + 0. * x[None, :]
    ph = ph0 + x[None, :] / np.maximum(np.sin(th), 1e-6)
    th = np.clip(th, 0., np.pi)
    # bilinear in the ring/phi index spaces (rings are monotonic in theta)
    theta_rings = np.asarray(geom.theta)
    it = np.clip(np.searchsorted(theta_rings, th) - 1, 0, nrings - 2)
    wt = np.clip((th - theta_rings[it]) / np.maximum(
        theta_rings[it + 1] - theta_rings[it], 1e-30), 0., 1.)
    fp = (ph % (2. * np.pi)) / (2. * np.pi) * nphi
    ip = np.floor(fp).astype(int) % nphi
    wp = fp - np.floor(fp)
    out = ((1 - wt) * ((1 - wp) * rmap[it, ip] + wp * rmap[it, (ip + 1) % nphi])
           + wt * ((1 - wp) * rmap[it + 1, ip] + wp * rmap[it + 1, (ip + 1) % nphi]))
    return out[::-1]  # 'astro' flip, as the reference projector


def mask_hash(spec, dtype=bool):
    """Stable hash token for a map spec in cache keys (port of
    plancklens_tpu/utils/maps.py:67-80; role of reference plancklens/qcinv/util.py:81-95):
    path specs hash by sanitized name, arrays (numpy or torch) by value (clhash with the
    given cast), lists concatenate, None/'callable' literal. The tokens equal the JAX
    package's for every kind of spec."""
    from .hashing import clhash
    if spec is None:
        return 'none'
    if isinstance(spec, (list, tuple)):
        return ''.join(mask_hash(s, dtype=dtype) for s in spec)
    if isinstance(spec, str):
        return spec.replace('/', '_sl_').replace('.', '_')
    if callable(spec):
        return 'callable'
    if isinstance(spec, torch.Tensor):
        spec = spec.detach().cpu().numpy()
    return clhash(np.asarray(spec), dtype=dtype)
