"""Carry state across from the JAX reference package, as numpy only (no jax import).

With these, the tests run both packages on identical inputs:
  * `tables_from_numpy(tab, device)`: a reference recursion-table set (the `t['np']` dict
    of plancklens_tpu.ops.sht.core.recursion_tables, float64) as the port's device tables;
  * `phases_from_numpy(arr)`: reference unit phases as a `phases=` callable of the port's
    simulation libraries (models/sims.py);
  * `noise_from_numpy(maps)`: reference unit pixel-noise maps as the `noise=` callable of
    `sims.MapsLenNlevLib`.
"""
import numpy as np

from .ops.sht.core import tables_to_device


def tables_from_numpy(tab, device):
    """Reference table set (numpy dict with alpha, beta, gamma, l0, seed_v, seed_k, x) ->
    port table set on `device`. Only f64 sets (S = 256) carry over: the port runs the
    recursion in f64 for every data type."""
    if np.asarray(tab['seed_v']).dtype != np.float64:
        raise ValueError('the port runs the f64 recursion: pass a float64 table set')
    return tables_to_device(dict(tab, S=256), device)


def phases_from_numpy(arr):
    """Unit phases -> `phases=` callable idx -> (nfields, nalm) numpy array.

    arr: a dict {idx: (nfields, nalm)} or an array (nsims, nfields, nalm) indexed by sim
    index (0-based)."""
    if isinstance(arr, dict):
        table = {int(k): np.asarray(v) for k, v in arr.items()}
        return lambda idx: table[int(idx)]
    arr = np.asarray(arr)
    return lambda idx: arr[int(idx)]


def noise_from_numpy(maps):
    """Unit-variance pixel-noise maps -> `noise=` callable (idx, tag) -> numpy array.

    maps: a dict {(idx, tag): array}, tag 0 the (nrings, nphi) T noise and tag 1 the
    (2, nrings, nphi) Q/U noise of simulation idx (e.g. the reference's
    `jax.random.normal(MapsLenNlevLib._noise_key(idx, tag), shape)` draws)."""
    table = {(int(i), int(t)): np.asarray(v) for (i, t), v in maps.items()}
    return lambda idx, tag: table[int(idx), int(tag)]
