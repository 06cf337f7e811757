"""Readers of the per-layer metrics that read the program's own spans and counters
(plancklens_tpu_torch/utils/trace.py), shared by the metric files of each cell kind.

In a traced run a torch.profiler records the window, and while it records the program's
spans are live: its records and counters are then the window's own. The table cache keeps
the host interval of every table build, set-up's included. Each reader returns None where
the program has no tracer (a program older than it) or it finds nothing to read."""
COPIES = ('copy.to_host', 'copy.to_device')


def _tracer():
    try:
        from plancklens_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def cacher_copy_s_per_sim(ctx):
    """Device seconds of the window's copies between the card and the QE and filter
    libraries' host cachers (the program's copy.to_host / copy.to_device spans, each timed
    on the device by CUDA events around its copy) per sim."""
    trace = _tracer()
    if trace is None or not ctx['sims']:
        return None
    s = [r['attrs']['device_s'] for r in trace.records()
         if r['name'] in COPIES and 'device_s' in r['attrs']]
    return sum(s) / ctx['sims'] if s else None


def cacher_copy_gb_per_sim(ctx):
    """GB (1e9 bytes) the window's cacher copies moved, both ways (the program's counters
    copy.to_host_bytes + copy.to_device_bytes), per sim."""
    trace = _tracer()
    if trace is None or not ctx['sims']:
        return None
    c = trace.counters()
    n = c.get('copy.to_host_bytes', 0) + c.get('copy.to_device_bytes', 0)
    return 1e-9 * n / ctx['sims'] if n else None


def setup_tables_s(ctx):
    """Host seconds of the recursion-table builds (ops/sht/core.TABLES.builds, each also a
    span sht.recursion_tables while live) that ended before the window began: the first
    of the window's records marks its start."""
    trace = _tracer()
    if trace is None:
        return None
    from plancklens_tpu_torch.ops.sht import core
    builds = getattr(core.TABLES, 'builds', None)
    recs = trace.records()
    if builds is None or not recs:
        return None
    w0 = min(r['t0'] for r in recs)
    return 1e-9 * sum(t1 - t0 for t0, t1 in builds if t1 <= w0)
