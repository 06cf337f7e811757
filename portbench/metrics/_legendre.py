"""Share of the roofline of the window's Legendre calls of one kind: the sum of each
call's least time (portbench/harness/roofline.py, from the call's shape alone) over the
sum of the device time of every kernel launched inside the call (the profiler's
correlation of a kernel to its launch, the innermost call open at the launch). A call
that contains another one (a pair call on an asymmetric grid making two plain calls) is
counted through the calls it contains."""
from portbench.harness import roofline


def _bound(c):
    """(least seconds, 'operations' or 'bytes') of one recorded call."""
    if c['pair']:
        return roofline.pair_bound(c['lmax'], c['m0'], c['M'], c['spin'], c['two'],
                                   c['nrings'], c['B'], c['f64'])
    return roofline.plain_bound(c['lmax'], c['m0'], c['M'], c['spin'], c['nrings'], c['B'],
                                c['f64'])


def _leaves(ctx, kind):
    """(index, call) of the calls of a kind that contain no other call."""
    calls = ctx['rec'].calls
    parents = {c['parent'] for c in calls if c['parent'] is not None}
    return [(n, c) for n, c in enumerate(calls) if c['kind'] == kind and n not in parents]


def share(ctx, kind):
    t = ctx['layer']
    if not t:
        return None
    bound = dev = 0.
    for n, c in _leaves(ctx, kind):
        if t['per_call'].get(n, 0.) > 0.:
            bound += _bound(c)[0]
            dev += t['per_call'][n]
    return None if dev <= 0. else 100. * bound / dev


def shapes(ctx, kind):
    """{shape: [calls, device s, bound s, bound by]} of the window's calls of a kind."""
    t, out = ctx['layer'], {}
    for n, c in _leaves(ctx, kind):
        key = '%s lmax %d M %d m0 %d spin %d %s rings %d batch %d %s' % (
            'pair' if c['pair'] else 'plain', c['lmax'], c['M'], c['m0'], c['spin'],
            'two inputs' if c['two'] else 'one input', c['nrings'], c['B'],
            'f64' if c['f64'] else 'f32')
        b, by = _bound(c)
        row = out.setdefault(key, [0, 0., 0., by])
        row[0] += 1
        row[1] += t['per_call'].get(n, 0.)
        row[2] += b
    return out
