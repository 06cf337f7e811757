from . import alm, cls, hashing, cachers, sql, fitsio, maps
from .cls import camb_clfile, cli, clinv, joincls, extcl, cls_dot, cl_inverse
from .hashing import clhash, mchash, hash_check


def enumerate_progress(seq, label=''):
    """enumerate() with a lightweight stderr progress line (port of
    plancklens_tpu/utils/__init__.py:8-22; role of reference plancklens/utils.py:94-113
    for long batch loops). Prints the same strings as the JAX package."""
    import sys
    import time
    t0 = time.time()
    n = len(seq)
    for i, item in enumerate(seq):
        yield i, item
        dt = time.time() - t0
        sys.stderr.write('\r%s %d/%d  [%d:%02d]' % (label, i + 1, n, dt // 60, dt % 60))
        sys.stderr.flush()
    if n:
        sys.stderr.write('\n')


def _fmt_dt(seconds):
    s = int(seconds)
    return '%d:%02d:%02d' % (s // 3600, (s // 60) % 60, s % 60)


class stopwatch:
    """Wall-clock timer with total/lap readouts as h:mm:ss strings (port of
    plancklens_tpu/utils/__init__.py:29-48; role of reference plancklens/qcinv/util.py:21-36,
    used by CG monitors)."""

    def __init__(self):
        import time
        self._time = time.time
        self._t0 = self._time()
        self._tl = self._t0

    def lap(self):
        now = self._time()
        out = (_fmt_dt(now - self._t0), _fmt_dt(now - self._tl))
        self._tl = now
        return out

    def elapsed(self):
        now = self._time()
        self._tl = now
        return _fmt_dt(now - self._t0)
