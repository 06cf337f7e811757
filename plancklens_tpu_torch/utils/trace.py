"""Spans and counters of the port, on the clock of torch.profiler.

    from plancklens_tpu_torch.utils import trace
    trace.enable()
    with trace.span('stage.qe', sims=[0, 8]):
        ...
    trace.count('cg.iters', 12)
    print(trace.summary())
    trace.dump('run_trace.json')

A span is live while the tracer is on (`enable`) or a torch.profiler records; counters
count while spans are live. A live span

- opens a `torch.profiler.record_function` range under its own name while a profiler
  records, so that each device kernel, copy and idle gap of the profiler's trace falls in
  the innermost program span that launched it or was open when it began (the profiler's
  correlation ids tie a device operation to its launch); `join` pairs those ranges with
  the records;
- keeps a record in memory: `id`, `name`, the `parent` span's id, the `root` id (the
  outermost open span's: every span of a stage of examples/run_qlms_torch.py shares
  it), `t0` and `t1` (time.perf_counter_ns of the host) and `attrs`; `profiled` says
  whether it has a range.

Off, the default, with no profiler recording, `span` returns the shared no-op object NOOP
after two flag checks and `count` returns at once. Tracing never synchronises the device:
a device time (`time_device`) or value (`set_max`) is read back by `records`, `summary`
and `dump` once the device has passed it, and left out until then. The records are kept
for the process (one thread: the port's stages run on one); `reset` drops them.
"""
import functools
import itertools
import json
import time

import numpy as np
import torch

_profiling = torch.autograd._profiler_enabled
_on = False
_records = []
_counters = {}
_stack = []
_pending = []          # (record, attr, CUDA event, value()) read back once the event is done
_ids = itertools.count()


class _Noop:
    """The span of a tracer that is off: enters, exits and takes attrs, doing nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass

    def time_device(self, device):
        pass

    def set_max(self, key, x):
        pass


NOOP = _Noop()


class _Span:
    __slots__ = ('rec', '_rf', '_ev')

    def __init__(self, name, attrs):
        self.rec = {'id': None, 'name': name, 'parent': None, 'root': None, 't0': None,
                    't1': None, 'attrs': attrs, 'profiled': False}
        self._rf = self._ev = None

    def __enter__(self):
        rec = self.rec
        rec['id'] = next(_ids)
        if _stack:
            rec['parent'], rec['root'] = _stack[-1]['id'], _stack[-1]['root']
        else:
            rec['root'] = rec['id']
        if _profiling():
            rec['profiled'] = True
            self._rf = torch.profiler.record_function(rec['name'])
            self._rf.__enter__()
        _stack.append(rec)
        _records.append(rec)
        rec['t0'] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if self._ev is not None:
            self._ev[1].record(self._ev[2])
        rec['t1'] = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        if _stack and _stack[-1] is rec:
            _stack.pop()
        elif rec in _stack:
            _stack.remove(rec)
        return False

    def set(self, **attrs):
        """Add attrs known only inside the span (an iteration count, a size)."""
        self.rec['attrs'].update(attrs)

    def time_device(self, device):
        """attrs['device_s']: the device seconds from here to the span's end on the current
        stream of a CUDA `device`, by a pair of CUDA events (nothing on another device)."""
        if torch.device(device).type != 'cuda':
            return
        stream = torch.cuda.current_stream(device)
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True),
              stream)
        ev[0].record(stream)
        self._ev = ev
        _pending.append((self.rec, 'device_s', ev[1],
                         lambda: ev[0].elapsed_time(ev[1]) * 1e-3))

    def set_max(self, key, x):
        """attrs[key] = the largest entry of tensor `x`; from a CUDA tensor it is copied
        into pinned host memory without a synchronise and read once the copy is done."""
        m = x.detach().amax()
        if not m.is_cuda:
            self.rec['attrs'][key] = float(m)
            return
        h = torch.empty((), dtype=m.dtype, pin_memory=True)
        h.copy_(m, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(m.device))
        _pending.append((self.rec, key, ev, lambda: float(h)))


def live():
    """True while spans are recorded: the tracer is on or a torch.profiler records."""
    return _on or _profiling()


def span(name, **attrs):
    """Context manager of a span `name` with JSON-able `attrs` (NOOP when not live)."""
    if not (_on or _profiling()):
        return NOOP
    return _Span(name, attrs)


def within(*names):
    """True when a live span of one of `names` is open (the outermost span of a name
    is the one that counts a call once)."""
    return any(r['name'] in names for r in _stack)


def traced(name):
    """Decorator: every call of the function runs inside span(name)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kw):
            with span(name):
                return fn(*args, **kw)
        return wrapped
    return deco


def count(name, n=1):
    """Add n to the counter `name` (nothing when not live)."""
    if not (_on or _profiling()):
        return
    _counters[name] = _counters.get(name, 0) + n


def sims(idxs):
    """The `sims` attr of a span over sim indices: [first index, count]."""
    idxs = [int(i) for i in np.atleast_1d(idxs)]
    return [idxs[0] if idxs else None, len(idxs)]


def enabled():
    """True while the tracer is on (`enable`), whether or not a profiler records."""
    return _on


def enable():
    global _on
    _on = True


def disable():
    global _on
    _on = False


def reset():
    """Drop the records, counters and pending read-backs (open spans stay open)."""
    _records.clear()
    _counters.clear()
    _pending.clear()


def _resolve():
    keep = []
    for rec, key, ev, value in _pending:
        if ev.query():
            rec['attrs'][key] = value()
        else:
            keep.append((rec, key, ev, value))
    _pending[:] = keep


def records():
    """The records, in the order their spans were entered (ids ascending)."""
    _resolve()
    return list(_records)


def counters():
    return dict(_counters)


def summary():
    """{'spans': {name: {calls, host_s[, device_s]}}, 'counters': {...}}: the host seconds
    of the outermost closed span of each name (a span inside one of its own name is not
    counted twice), the device seconds of every span of the name that has them."""
    recs = records()
    by_id = {r['id']: r for r in recs}
    spans = {}
    for r in recs:
        s = spans.setdefault(r['name'], {'calls': 0, 'host_s': 0.})
        s['calls'] += 1
        if 'device_s' in r['attrs']:
            s['device_s'] = s.get('device_s', 0.) + r['attrs']['device_s']
        p = by_id.get(r['parent'])
        while p is not None and p['name'] != r['name']:
            p = by_id.get(p['parent'])
        if p is None and r['t1'] is not None:
            s['host_s'] += (r['t1'] - r['t0']) * 1e-9
    return {'spans': spans, 'counters': counters()}


def dump(path):
    """Write the records, counters and summary as JSON to `path`."""
    out = dict(summary(), records=records())
    with open(path, 'w') as f:
        json.dump(out, f, default=str)


def join(events):
    """{record id: event} of the records with a profiler range: the chrome-trace events
    (`traceEvents` of torch.profiler's export_chrome_trace) of category user_annotation
    that bear the records' names, taken in order of their start, outer range first, are
    the records' ranges in the order the spans were entered."""
    recs = [r for r in records() if r['profiled']]
    names = {r['name'] for r in recs}
    ranges = sorted((e for e in events if e.get('ph') == 'X' and e.get('name') in names
                     and e.get('cat') == 'user_annotation'),
                    key=lambda e: (e['ts'], -e['dur']))
    out, i = {}, 0
    for r in recs:
        if i < len(ranges) and ranges[i]['name'] == r['name']:
            out[r['id']] = ranges[i]
            i += 1
    return out


# ------------------------------------------------------------------ cacher copies
def to_host(x, what):
    """x.cpu().numpy() of a tensor written to a cacher; while live a span 'copy.to_host'
    (bytes, what; device_s on a card) and the counter 'copy.to_host_bytes'."""
    if not (_on or _profiling()):
        return x.cpu().numpy()
    n = x.numel() * x.element_size()
    with _Span('copy.to_host', {'bytes': n, 'what': what}) as s:
        s.time_device(x.device)
        out = x.cpu().numpy()
    count('copy.to_host_bytes', n)
    return out


def _is_on(t, device):
    """True when tensor t already lies on `device` (a bare 'cuda' is the current card)."""
    d = torch.device(device)
    if d.type == 'cuda' and d.index is None:
        d = torch.device('cuda', torch.cuda.current_device())
    return t.device == d


def to_device(a, device, what):
    """torch.as_tensor(a).to(device) of an array or tensor a cacher loaded; while live a
    span 'copy.to_device' (bytes, what; device_s on a card) and 'copy.to_device_bytes'. A
    tensor already on `device` comes back as it is, with no span and no bytes counted."""
    if isinstance(a, torch.Tensor) and _is_on(a, device):
        return a
    if not (_on or _profiling()):
        return torch.as_tensor(a).to(device)
    t = torch.as_tensor(a)
    n = t.numel() * t.element_size()
    with _Span('copy.to_device', {'bytes': n, 'what': what}) as s:
        s.time_device(device)
        out = t.to(device)
    count('copy.to_device_bytes', n)
    return out
