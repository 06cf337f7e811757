"""Native C++/OpenMP host kernels, opt-in behind PLK_NATIVE=1 (port of
plancklens_tpu/native/).

plkcore.cc (this package's copy) holds the Gauss-Legendre nodes and the Wigner small-d
synthesis/analysis of 1-D host operands. It is built at first use with g++ into
`plancklens_tpu_torch/_build/` (native/build.py) and bound with ctypes. `ops/gauleg.gauleg`
and `ops/wigner.wignerpos`/`wignercoeff` call it when PLK_NATIVE=1 is set (wigner: for a
1-D real host numpy operand, the reference's conditions). Departure from the JAX package:
there, a missing library quietly leaves the callers on their default paths; here, with
PLK_NATIVE=1 set, a build or load that fails raises. Without PLK_NATIVE nothing here runs.
"""
import ctypes
import os

import numpy as np

from . import build as _build

# calls served by the native library since import (tests read them)
calls = {'gauleg': 0, 'wignerpos': 0, 'wignercoeff': 0}

_lib = None


def enabled():
    """PLK_NATIVE=1: the callers dispatch here (and raise if the library cannot load)."""
    return os.environ.get('PLK_NATIVE', '0') == '1'


def _load():
    """The bound library, built first if needed; raises RuntimeError on failure."""
    global _lib
    if _lib is None:
        so = _build.build()
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            raise RuntimeError('native library %s does not load: %s' % (so, e)) from e
        d = ctypes.POINTER(ctypes.c_double)
        lib.plk_gauleg.argtypes = [ctypes.c_int, d, d]
        lib.plk_wignerpos.argtypes = [ctypes.c_int, ctypes.c_int, d, d,
                                      ctypes.c_int, ctypes.c_int, d]
        lib.plk_wignercoeff.argtypes = [ctypes.c_int, ctypes.c_int, d, d,
                                        ctypes.c_int, ctypes.c_int, d]
        lib.plk_version.restype = ctypes.c_int
        _lib = lib
    return _lib


def have_native():
    """True when the library is built (or builds now) and loads."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def gauleg(n):
    """Native n-point GL nodes/weights (ascending x)."""
    lib = _load()
    x = np.empty(n, dtype=np.float64)
    w = np.empty(n, dtype=np.float64)
    lib.plk_gauleg(n, _ptr(x), _ptr(w))
    calls['gauleg'] += 1
    return x, w


def wignerpos(cl, x, s1, s2):
    """Native xi(x) = sum_l cl_l (2l+1)/(4pi) d^l_{s1 s2}(x), host numpy f64."""
    lib = _load()
    cl = np.ascontiguousarray(cl, dtype=np.float64)
    x = np.ascontiguousarray(x, dtype=np.float64)
    xi = np.empty(len(x), dtype=np.float64)
    lib.plk_wignerpos(len(x), len(cl) - 1, _ptr(cl), _ptr(x), s1, s2, _ptr(xi))
    calls['wignerpos'] += 1
    return xi


def wignercoeff(xi, x, s1, s2, lmax):
    """Native cl_l = 2 pi sum_i xi_i d^l_{s1 s2}(x_i), host numpy f64."""
    lib = _load()
    xi = np.ascontiguousarray(xi, dtype=np.float64)
    x = np.ascontiguousarray(x, dtype=np.float64)
    cl = np.empty(lmax + 1, dtype=np.float64)
    lib.plk_wignercoeff(len(x), lmax, _ptr(xi), _ptr(x), s1, s2, _ptr(cl))
    calls['wignercoeff'] += 1
    return cl
