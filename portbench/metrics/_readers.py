"""The readers of the per-layer metrics, shared by the metric files of each cell kind:
each takes the run's context (spans, counters, the parsed device trace) and returns
the metric, or None where it finds nothing to read."""
from portbench.metrics._legendre import share


def filter_s_per_sim(ctx):
    """Seconds of the filtering stage (the driver's stage_filt, a span ended by a device
    synchronise) per sim of the window."""
    s = ctx['rec'].seconds.get('filter')
    return None if not s or not ctx['sims'] else s / ctx['sims']


def qe_s_per_sim(ctx):
    """Seconds inside the outermost QELib.get_sim_qlm_batch / get_sim_qlm calls of the
    window (the dd leg from stage_qe, the ds and ss legs inside stage_qcl; spans ended by a
    device synchronise) per sim."""
    s = ctx['rec'].seconds.get('qe')
    return None if not s or not ctx['sims'] else s / ctx['sims']


def cg_iters_per_sim(ctx):
    """Conjugate-gradient iterations of the window's C^-1 solves (the n_iter that
    CinvT.solve_wf and CinvP.solve_wf return) per sim."""
    n = ctx['rec'].counts.get('cg_iters')
    return None if not n or not ctx['sims'] else n / ctx['sims']


def cg_iter_ms(ctx):
    """Milliseconds inside the window's C^-1 solves (solve_wf spans ended by a device
    synchronise) per iteration they returned."""
    rec = ctx['rec']
    n, s = rec.counts.get('cg_iters'), rec.seconds.get('cg')
    return None if not n or not s else 1e3 * s / n


def device_idle_pct(ctx):
    """Share of the traced window in which no kernel, copy or memset ran on the device:
    the union of the device intervals of the profiler's trace, not their sum."""
    t = ctx['layer']
    if not t or t['window_s'] <= 0 or t['busy_s'] <= 0:
        return None
    return 100. * (1. - t['busy_s'] / t['window_s'])


def legendre_synth_roofline(ctx):
    """Roofline share of the window's Legendre syntheses (K1 today), by the call."""
    return share(ctx, 'synth')


def legendre_anal_roofline(ctx):
    """Roofline share of the window's Legendre analyses (K2 today), by the call."""
    return share(ctx, 'anal')
