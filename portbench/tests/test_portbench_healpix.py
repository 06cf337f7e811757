"""The HEALPix map cell (ideal_maps_n2048.mc_chain) at a tiny size on the CPU: a sound run
through the harness's chain is correct and reports its metrics; a filter returning its
input and half the QE batch replaced come out not correct; and the readers of the cell's
per-layer metrics (portbench/metrics/_healpix.py) on records made here."""
import types

import numpy as np
import pytest
import torch

import portbench.run as R
from portbench.metrics import _healpix as H
from plancklens_tpu_torch.utils import trace
from test_portbench_chain import _half_batch

CELL = 'ideal_maps_n2048.mc_chain'
TINY = dict(nside=16, lmax_ivf=12, lmax_qlm=20, lmin_ivf=2)


def run_cpu(seed=2 ** 31 + 91, trace_on=0):
    args = types.SimpleNamespace(workload=CELL, seed=seed, seconds=0.01, trace=trace_on,
                                 control=None, override=TINY, traffic_override=None)
    return R.run(args, 'cpu')


@pytest.fixture(autouse=True)
def fresh_tracer():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def test_sound_run_is_correct():
    out = run_cpu()
    assert out['correct'], out['checks']
    assert out['attempted'] == 4 and out['failed'] == 0
    assert set(out['checks']) == {'ivf_rel', 'qlm_rel', 'mf_rel', 'qcl_rel'}
    assert set(out['metrics']) == {'setup_s', 'sims_per_hour.isotropic'}


def test_the_builder_runs_the_map_filter():
    from plancklens_tpu_torch.models.filt import IVFSepTP
    from plancklens_tpu_torch.models.sims import HealpixAlmLib, HealpixMapLib
    from portbench.builders import healpix_fullsky
    from portbench.inputs import Inputs
    _, cfg, traffic, _ = R.load_cell(CELL)
    cfg.update(TINY)
    inp = Inputs(cfg, 5, 'cpu', traffic)
    for control, dtype in ((None, torch.float64), ('f32', torch.float32)):
        par = healpix_fullsky.build(cfg, traffic, inp, 'cpu', None, control=control)
        assert isinstance(par.ivfs, IVFSepTP) and not hasattr(par, 'ivfs_raw')
        alms = par.ivfs.sim_lib
        assert isinstance(alms, HealpixAlmLib) and isinstance(alms.map_lib, HealpixMapLib)
        assert alms.ITER == 3 and not alms.sht.use_ring_weights
        assert alms.sht is alms.map_lib.sht and alms.sht.dtype == dtype
        assert par.qlms_dd.dtype == torch.float32


def _filter_returns_its_input(monkeypatch):
    """The filter hands on the maps' alms without f_l / b_l."""
    from plancklens_tpu_torch.models.filt import IVFSepTP
    monkeypatch.setattr(IVFSepTP, '_filt', lambda self, alm, f, b: alm)


def _half_qe_batch(monkeypatch):
    _half_batch(monkeypatch, CELL)


@pytest.mark.parametrize('fault', [_filter_returns_its_input, _half_qe_batch])
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    try:
        out = run_cpu()
    except Exception:           # a fault that crashes the run has failed too
        return
    assert not out['correct'], out['checks']


def test_traced_run_records_the_healpix_spans():
    out = run_cpu(trace_on=1)
    assert out['correct'], out['checks']
    names = [r['name'] for r in trace.records()]
    # a window of one step: the sims' T and Q/U syntheses, their analyses, no more
    top = [r for r in trace.records() if r['name'] in H.TRANSFORMS
           and not _inside(r, H.TRANSFORMS)]
    assert [(r['name'], r['attrs']['spin'], r['attrs']['batch']) for r in top] == [
        ('healpix.alm2map', 2, 4), ('healpix.alm2map', 0, 4),
        ('healpix.map2alm', 0, 4), ('healpix.map2alm', 2, 4)]
    assert names.count('filt.ivf') >= 1
    assert trace.counters()['healpix.jacobi_iters'] == 6
    assert {'filter_s_per_sim.isotropic', 'cacher_copy_gb_per_sim.isotropic'} \
        <= set(out['metrics'])


def _inside(r, names):
    by_id = {x['id']: x for x in trace.records()}
    p = by_id.get(r['parent'])
    while p is not None and p['name'] not in names:
        p = by_id.get(p['parent'])
    return p is not None


# ------------------------------------------------------------------ the readers
def _records(spans):
    """Records of spans [(name, device_s or None, [children])]."""
    trace.enable()

    def enter(name, dev, kids):
        with trace.span(name, spin=0) as s:
            if dev is not None:
                s.set(device_s=dev)
            for k in kids:
                enter(*k)
    with trace.span('stage.filt'):
        for sp in spans:
            enter(*sp)
    trace.disable()


def test_healpix_seconds_count_the_outermost_spans():
    _records([('healpix.alm2map', 0.5, []),
              ('healpix.map2alm', 2., [('healpix.alm2map', 0.25, []),
                                       ('healpix.rings_to_map', None, [])]),
              ('qe.eval', None, [('healpix.map2alm', 1., [])])])
    assert H.healpix_s_per_sim(dict(sims=4)) == pytest.approx(3.5 / 4)
    assert H.healpix_s_per_sim(dict(sims=0)) is None


def test_healpix_seconds_find_nothing():
    _records([('healpix.alm2map', None, [])])
    assert H.healpix_s_per_sim(dict(sims=4)) is None


def test_healpix_seconds_without_the_tracer(monkeypatch):
    import sys
    _records([('healpix.alm2map', 0.5, [])])
    monkeypatch.delattr(sys.modules['plancklens_tpu_torch.utils'], 'trace')
    monkeypatch.setitem(sys.modules, 'plancklens_tpu_torch.utils.trace', None)
    assert H.healpix_s_per_sim(dict(sims=4)) is None


def _call(kind, pair, nrings, parent=None, lmax=64, spin=0):
    return dict(kind=kind, pair=pair, lmax=lmax, m0=0, M=lmax + 1, spin=spin, two=False,
                nrings=nrings, B=4, f64=True, parent=parent)


def test_roofline_shares_read_the_healpix_rings_alone():
    from portbench.metrics._legendre import _bound
    nside = 16
    calls = [_call('synth', False, 4 * nside - 1), _call('anal', False, 4 * nside - 1, spin=2),
             _call('synth', True, 65), _call('anal', False, 65), _call('synth', False, 63)]
    rec = types.SimpleNamespace(calls=calls)
    per_call = {0: 2e-3, 1: 4e-3, 2: 1e-3, 3: 1e-3, 4: 0.}
    ctx = dict(rec=rec, layer=dict(per_call=per_call), cfg=dict(nside=nside))
    assert H.share(ctx, 'synth') == pytest.approx(100. * _bound(calls[0])[0] / 2e-3)
    assert H.share(ctx, 'anal') == pytest.approx(100. * _bound(calls[1])[0] / 4e-3)
    assert H.share(dict(ctx, cfg={}), 'synth') is None
    assert H.share(dict(ctx, layer=None), 'synth') is None
    assert H.share(dict(ctx, cfg=dict(nside=8)), 'anal') is None
    assert np.isfinite(H.share(ctx, 'synth'))


def test_qe_grid_roofline_shares_leave_the_healpix_rings_out():
    from portbench.metrics._legendre import _bound
    nside = 16
    calls = [_call('synth', False, 4 * nside - 1), _call('synth', True, 65),
             _call('anal', False, 65), _call('anal', False, 4 * nside - 1),
             _call('anal', True, 4 * nside - 1)]
    rec = types.SimpleNamespace(calls=calls)
    per_call = {0: 2e-3, 1: 1e-3, 2: 3e-3, 3: 1e-3, 4: 1e-3}
    ctx = dict(rec=rec, layer=dict(per_call=per_call), cfg=dict(nside=nside))
    assert H.share(ctx, 'synth', healpix=False) == pytest.approx(
        100. * _bound(calls[1])[0] / 1e-3)
    assert H.share(ctx, 'anal', healpix=False) == pytest.approx(
        100. * (_bound(calls[2])[0] + _bound(calls[4])[0]) / 4e-3)
    for kind in ('synth', 'anal'):
        mod = R.load_metric('legendre_%s_roofline.maps' % kind)
        assert mod.read(ctx) == H.share(ctx, kind, healpix=False)
    assert H.share(dict(ctx, cfg={}), 'synth', healpix=False) is None
