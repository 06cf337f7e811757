"""Spans, counters and the device trace of a run.

The spans and counters are the benchmark's own, put around calls into the program from
outside: wrappers installed at run time on the program's public functions and methods (the
program's files are not touched). Every span is also a `torch.profiler.record_function`
range, so that in a traced run each device kernel is attributed, through the profiler's
correlation of a kernel to the host call that launched it, to the innermost span that was
open on the host when it was launched: by the call, never by the kernel's name.
"""
import bisect
import functools
import inspect
import json
import sys
import time
from collections import defaultdict

import torch

LEGENDRE = ('legendre_synth_pair', 'legendre_anal_pair', 'legendre_synth', 'legendre_anal')
PREFIX = 'portbench.'


class Recorder:
    """Host-clock spans (seconds, ended by a device synchronise when `sync`), counters,
    and the shapes of the Legendre calls."""

    def __init__(self, sync):
        self.sync = sync
        self.seconds = defaultdict(float)
        self.counts = defaultdict(float)
        self.calls = []           # Legendre calls: dict(shape..., parent)
        self.open_calls = []
        self._stack = []

    def span(self, name):
        return _Span(self, name)


class _Span:
    def __init__(self, rec, name):
        self.rec, self.name = rec, name

    def __enter__(self):
        if self.rec.sync:
            torch.cuda.synchronize()
        self._rf = torch.profiler.record_function(PREFIX + self.name)
        self._rf.__enter__()
        self.rec._stack.append(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.rec.sync:
            torch.cuda.synchronize()
        dt = time.perf_counter() - self._t0
        self.rec._stack.pop()
        self._rf.__exit__(*exc)
        if self.name not in self.rec._stack:      # outermost of its name
            self.rec.seconds[self.name] += dt
        return False


def _patch_everywhere(mod_prefix, original, wrapper):
    """Rebind every module-level name of the program that holds `original`."""
    for name, mod in list(sys.modules.items()):
        if mod is None or not name.split('.')[0] == mod_prefix:
            continue
        for attr, val in list(vars(mod).items()):
            if val is original:
                setattr(mod, attr, wrapper)


def wrap_legendre(rec, core, package):
    """Record every call of the four Legendre entry points of `core` with its shape, as a
    span 'legendre#<n>' (n indexes rec.calls)."""
    def make(fname, fn):
        sig = inspect.signature(fn)
        synth = 'synth' in fname

        @functools.wraps(fn)
        def wrapped(*args, **kw):
            a = sig.bind(*args, **kw)
            a.apply_defaults()
            a = a.arguments
            x = a['Cp'] if 'Cp' in a else a['Qp'] if 'Qp' in a else a['C'] if 'C' in a \
                else a['Q']
            second = a.get('Cm', a.get('Qm'))
            call = dict(kind='synth' if synth else 'anal', pair=fname.endswith('_pair'),
                        lmax=int(x.shape[-2] - 1 if synth else a['lmax']),
                        m0=int(a['m0']), M=int(x.shape[-1]),
                        spin=int(a['spin'] if 'spin' in a else a['n']),
                        two=second is not None, nrings=len(a['theta']), B=int(x.shape[0]),
                        f64=x.dtype in (torch.complex128, torch.float64),
                        parent=rec.open_calls[-1] if rec.open_calls else None)
            n = len(rec.calls)
            rec.calls.append(call)
            rec.open_calls.append(n)
            try:
                with torch.profiler.record_function('%slegendre#%d' % (PREFIX, n)):
                    return fn(*args, **kw)
            finally:
                rec.open_calls.pop()
        return wrapped

    for fname in LEGENDRE:
        orig = getattr(core, fname)
        _patch_everywhere(package, orig, make(fname, orig))


def wrap_method(rec, obj, name, span, count=None):
    """Span (and counter) around the method `name` of an instance or a class."""
    fn = getattr(obj, name)

    @functools.wraps(fn)
    def wrapped(*args, **kw):
        with rec.span(span):
            out = fn(*args, **kw)
        if count is not None:
            count(rec, out)
        return out
    setattr(obj, name, wrapped)


# ------------------------------------------------------------------ device trace
def _union(ivals, lo, hi):
    """Busy seconds of sorted (start, end) intervals clipped to [lo, hi], and the gaps."""
    busy, gaps = 0., []
    c0 = c1 = None
    for a, b in ivals:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if c1 is None or a > c1:
            if c1 is not None:
                busy += c1 - c0
                gaps.append((c1, a))
            c0, c1 = a, b
        else:
            c1 = max(c1, b)
    if c1 is not None:
        busy += c1 - c0
    return busy, gaps


def read_trace(path, rec):
    """Device activity of the chrome trace that torch.profiler wrote, inside the span
    'window': per Legendre call its device seconds (each kernel attributed, through its
    launch's correlation id, to the innermost Legendre call open at the launch), the
    union of device-busy intervals, the window's length, the ten operations with the most
    device time and the ten longest idle gaps, named by the innermost span open on the
    host when each began."""
    with open(path) as f:
        events = json.load(f)['traceEvents']
    launches, dev, calls, stages = {}, [], {}, []
    for e in events:
        if e.get('ph') != 'X':
            continue
        cat = e.get('cat', '')
        if cat in ('cuda_runtime', 'cuda_driver'):
            c = e.get('args', {}).get('correlation')
            if c is not None:
                launches[c] = e['ts']
        elif cat in ('kernel', 'gpu_memcpy', 'gpu_memset'):
            dev.append((e['ts'], e['ts'] + e['dur'], e.get('name', '?'),
                        e.get('args', {}).get('correlation')))
        elif cat == 'user_annotation' and e.get('name', '').startswith(PREFIX):
            name = e['name'][len(PREFIX):]
            if name.startswith('legendre#'):
                calls[int(name.split('#')[1])] = (e['ts'], e['ts'] + e['dur'])
            else:
                stages.append((e['ts'], e['ts'] + e['dur'], name))
    del events
    win = [s for s in stages if s[2] == 'window']
    if not win:
        raise RuntimeError('the trace holds no window span')
    w0, w1 = win[0][0], win[0][1]
    order = sorted(calls, key=lambda n: calls[n][0])
    starts = [calls[n][0] for n in order]

    def call_at(t):
        i = bisect.bisect_right(starts, t) - 1
        if i < 0:
            return None
        n = order[i]
        while n is not None and not (calls[n][0] <= t <= calls[n][1]):
            n = rec.calls[n]['parent'] if n < len(rec.calls) else None
            if n is not None and n not in calls:
                n = None
        return n

    per_call = defaultdict(float)
    by_name = defaultdict(float)
    for a, b, name, corr in dev:
        if b <= w0 or a >= w1:
            continue
        by_name[name] += (min(b, w1) - max(a, w0)) * 1e-6
        t = launches.get(corr)
        n = None if t is None else call_at(t)
        if n is not None:
            per_call[n] += (b - a) * 1e-6
    busy, gaps = _union(sorted((a, b) for a, b, _, _ in dev), w0, w1)
    gaps.sort(key=lambda g: g[0] - g[1])

    def stage_at(t):
        inner = None
        for s0, s1, name in stages:
            if s0 <= t <= s1 and name != 'window' and (inner is None or s0 >= inner[0]):
                inner = (s0, name)
        return inner[1] if inner else 'window'

    idle = [[stage_at(a), (b - a) * 1e-6] for a, b in gaps[:10]]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(per_call=per_call, busy_s=busy * 1e-6, window_s=(w1 - w0) * 1e-6,
                device_ops=[[k, v] for k, v in top], idle_gaps=idle)


def profiler():
    """A torch.profiler over host and device activity that keeps no stacks or shapes."""
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA],
        record_shapes=False, with_stack=False, profile_memory=False)
