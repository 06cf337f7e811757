"""Gauss-Legendre quadrature nodes and weights (host numpy, float64).

Port of plancklens_tpu/ops/gauleg.py: scipy's `roots_legendre` up to 2048 nodes, and
above (or without scipy) a vectorised Newton iteration on P_N, the numpy twin of the native
kernel, whose edge weights stay accurate where scipy's drift; with PLK_NATIVE=1 the native
C++/OpenMP kernel (plancklens_tpu_torch.native, built at first use; a failed build raises).
"""
import numpy as np
from functools import lru_cache

try:
    from scipy.special import roots_legendre as _scipy_roots
except ImportError:  # pragma: no cover - scipy is expected in this environment
    _scipy_roots = None


def _gauleg_newton(n):
    """The n-point GL rule on (-1, 1), float64, by vectorised Newton iteration on P_N from
    the Tricomi initial guess: the numpy twin of the native kernel (native/plkcore.cc
    plk_gauleg), on the x >= 0 half and mirrored, the middle root of odd n exactly 0."""
    m = (n + 1) // 2
    x = np.cos(np.pi * (np.arange(m) + 0.75) / (n + 0.5))     # largest x first

    def pn(x):   # P_n and P_n' by upward recursion
        p0, p1 = np.ones_like(x), x.copy()
        for l in range(2, n + 1):
            p0, p1 = p1, (2. * l - 1.) / l * x * p1 - (l - 1.) / l * p0
        return p1, n * (x * p1 - p0) / (x * x - 1.)

    for _ in range(100):
        p, dp = pn(x)
        dx = p / dp
        x = x - dx
        if np.max(np.abs(dx)) < 1e-15:
            break
    _, dp = pn(x)
    if n % 2:
        x[-1] = 0.
    w = 2. / ((1. - x * x) * dp * dp)
    k = n % 2    # the middle node of odd n is not mirrored
    return np.concatenate([-x, x[::-1][k:]]), np.concatenate([w, w[::-1][k:]])


def gauleg(n):
    """n-point Gauss-Legendre nodes (ascending in x = cos(theta)) and weights, float64.

    PLK_NATIVE=1 serves them from the native kernel (role of reference
    plancklens/wigners/wigners.f90:132-184 `get_xgwg`; its edge weights are more accurate
    than scipy's, plancklens_tpu/ops/gauleg.py:48-53), else scipy up to NEWTON_ABOVE
    nodes and the numpy Newton iteration above. Results are cached per (n, route)."""
    assert n >= 1, n
    from .. import native
    return _gauleg_native(n) if native.enabled() else _gauleg_host(n)


@lru_cache(maxsize=64)
def _gauleg_native(n):
    from .. import native
    return native.gauleg(n)


# Above this many nodes the default route is the Newton iteration. scipy's edge weights
# drift from the rule's as n grows (against the native kernel: 2.5e-11 relative at 257
# nodes, 1.0e-9 at 513, 1.0e-8 at 1025, at most 2.0e-7 below 2049 (n = 2028), 8.8e-8 at
# 4097, 4.9e-6 at 8193), and the quadratures of the large band limits read that: the
# monopole of models/freq_weighting.w2wsq at lmax_out 4094 is off by 4.3e-7 with scipy's
# nodes and by 7.2e-11 with these. Up to it the port serves scipy's nodes, as the JAX
# package does, so that the two agree bitwise where the parity tests hold one to the other.
NEWTON_ABOVE = 2048


@lru_cache(maxsize=64)
def _gauleg_host(n):
    if _scipy_roots is not None and n <= NEWTON_ABOVE:
        x, w = _scipy_roots(n)
        return np.asarray(x, dtype=np.float64), np.asarray(w, dtype=np.float64)
    return _gauleg_newton(n)


def nquad_for(lmaxtot):
    """Number of GL nodes integrating polynomials of degree lmaxtot exactly
    (matches reference: plancklens/utils_spin.py:66)."""
    return (lmaxtot + 2 - lmaxtot % 2) // 2
