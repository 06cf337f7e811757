"""Readers of the per-layer metrics of the HEALPix map cell (ideal_maps_n2048): the device
seconds of the program's HEALPix transforms, the roofline shares of its plain Legendre
calls on the HEALPix rings, and those of the cell's other Legendre calls (the QEs'). Each
returns None where it finds nothing to read (a program without the transforms' spans, a
run with no such calls)."""
from portbench.metrics._legendre import _bound, _leaves

TRANSFORMS = ('healpix.alm2map', 'healpix.map2alm')


def healpix_s_per_sim(ctx):
    """Device seconds of the window's outermost healpix.alm2map / healpix.map2alm spans
    (CUDA events around each call; the syntheses of map2alm's Jacobi steps nest inside
    it and are not counted again) per sim."""
    try:
        from plancklens_tpu_torch.utils import trace
    except ImportError:
        return None
    if not ctx['sims']:
        return None
    recs = trace.records()
    by_id = {r['id']: r for r in recs}
    total, found = 0., False
    for r in recs:
        if r['name'] not in TRANSFORMS or 'device_s' not in r['attrs']:
            continue
        p = by_id.get(r['parent'])
        while p is not None and p['name'] not in TRANSFORMS:
            p = by_id.get(p['parent'])
        if p is None:
            total += r['attrs']['device_s']
            found = True
    return total / ctx['sims'] if found else None


def share(ctx, kind, healpix=True):
    """Roofline share of the window's plain Legendre calls of a kind on the 4 nside - 1
    HEALPix rings (K3 synthesis, K4 analysis), or with healpix=False of every other call
    of the kind (the QEs' K1/K2 on their GL grid): portbench/metrics/_legendre.py's share
    restricted to those calls, each call's least time from
    portbench/harness/roofline.py."""
    t, nside = ctx['layer'], ctx['cfg'].get('nside')
    if not t or not nside:
        return None
    bound = dev = 0.
    for n, c in _leaves(ctx, kind):
        on_rings = not c['pair'] and c['nrings'] == 4 * nside - 1
        if on_rings == healpix and t['per_call'].get(n, 0.) > 0.:
            bound += _bound(c)[0]
            dev += t['per_call'][n]
    return None if dev <= 0. else 100. * bound / dev
