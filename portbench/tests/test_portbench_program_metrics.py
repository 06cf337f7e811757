"""The per-layer metrics that read the program's own spans and counters
(portbench/metrics/_program.py): on records and counters made here, on a traced run of each
cell at a tiny size on the CPU (the copy bytes against the count from the cell's shapes),
against a program without the tracer (every new reader returns None), and the existing
device-trace reader unchanged by the program's ranges in the trace."""
import json
import sys
import types

import numpy as np
import pytest

import portbench.run as R
from portbench.harness import trace as tr
from portbench.metrics import _program as P
from plancklens_tpu_torch.ops.sht import core
from plancklens_tpu_torch.utils import trace
from test_portbench_chain import TINY

NEW = ('cacher_copy_s_per_sim', 'cacher_copy_gb_per_sim', 'setup_tables_s')


@pytest.fixture(autouse=True)
def fresh_tracer():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _window(copies):
    """Records of a window: a stage holding copies [(name, bytes, device_s or None)]."""
    trace.enable()
    with trace.span('stage.qe'):
        for name, n, dev in copies:
            with trace.span(name, bytes=n) as s:
                if dev is not None:
                    s.set(device_s=dev)
            trace.count(name + '_bytes', n)
    trace.disable()


def test_copy_readers_on_records():
    _window([('copy.to_host', 3 * 10 ** 9, 0.5), ('copy.to_device', 10 ** 9, 0.25),
             ('copy.to_host', 10 ** 9, None)])
    ctx = dict(sims=4)
    assert P.cacher_copy_s_per_sim(ctx) == pytest.approx(0.75 / 4)
    assert P.cacher_copy_gb_per_sim(ctx) == pytest.approx(5. / 4)
    assert P.cacher_copy_s_per_sim(dict(sims=0)) is None


def test_copy_readers_find_nothing():
    _window([])
    assert P.cacher_copy_s_per_sim(dict(sims=4)) is None
    assert P.cacher_copy_gb_per_sim(dict(sims=4)) is None


def test_setup_tables_counts_the_builds_before_the_window(monkeypatch):
    monkeypatch.setattr(core.TABLES, 'builds', [(10, 3 * 10 ** 9 + 10)])
    _window([('copy.to_host', 8, None)])
    w0 = trace.records()[0]['t0']
    core.TABLES.builds += [(w0 - 2 * 10 ** 9, w0 - 10 ** 9), (w0 + 5, w0 + 10 ** 9)]
    assert P.setup_tables_s({}) == pytest.approx(4.)


@pytest.mark.parametrize('name', NEW)
def test_a_program_without_the_tracer_reads_none(name, monkeypatch):
    _window([('copy.to_host', 8, 1.)])
    monkeypatch.delattr(sys.modules['plancklens_tpu_torch.utils'], 'trace')
    monkeypatch.setitem(sys.modules, 'plancklens_tpu_torch.utils.trace', None)
    assert getattr(P, name)(dict(sims=4)) is None


def test_a_table_cache_without_builds_reads_none(monkeypatch):
    _window([('copy.to_host', 8, 1.)])
    monkeypatch.delattr(core.TABLES, 'builds')
    assert P.setup_tables_s({}) is None


def _x(name, cat, ts, dur, corr=None):
    e = {'ph': 'X', 'name': name, 'cat': cat, 'ts': ts, 'dur': dur}
    if corr is not None:
        e['args'] = {'correlation': corr}
    return e


def test_read_trace_ignores_the_program_ranges(tmp_path):
    """A trace of the program as it was, and the same trace with the program's spans as
    ranges: the benchmark's device-trace readings are the same."""
    rec = tr.Recorder(sync=False)
    rec.calls = [dict(parent=None), dict(parent=0)]
    base = [_x('portbench.window', 'user_annotation', 0, 1000),
            _x('portbench.cg', 'user_annotation', 10, 500),
            _x('portbench.legendre#0', 'user_annotation', 20, 100),
            _x('portbench.legendre#1', 'user_annotation', 30, 50),
            _x('cudaLaunchKernel', 'cuda_runtime', 35, 2, 1),
            _x('cudaLaunchKernel', 'cuda_runtime', 100, 2, 2),
            _x('cudaMemcpyAsync', 'cuda_runtime', 600, 2, 3),
            _x('synth_pair_kernel', 'kernel', 40, 100, 1),
            _x('anal_pair_mma_kernel', 'kernel', 150, 200, 2),
            _x('Memcpy DtoH (Device -> Pageable)', 'gpu_memcpy', 610, 300, 3)]
    prog = [_x('stage.filt', 'user_annotation', 5, 520), _x('cg.solve', 'user_annotation', 12, 490),
            _x('cg.iter', 'user_annotation', 15, 120), _x('sht.legendre', 'user_annotation', 21, 98),
            _x('cg.stop', 'user_annotation', 360, 20), _x('copy.to_host', 'user_annotation', 599, 312)]
    out = []
    for events in (base, base + prog):
        path = tmp_path / ('t%d.json' % len(events))
        path.write_text(json.dumps({'traceEvents': events}))
        out.append(tr.read_trace(str(path), rec))
    assert out[0] == out[1]
    assert out[0]['per_call'] == pytest.approx({0: 200e-6, 1: 100e-6})
    assert [g[0] for g in out[1]['idle_gaps']] == ['cg', 'cg']     # the benchmark's names


def _expected_gb(cell):
    """GB a sim the cell's QE and spectrum libraries copy, from its shapes: the QE
    libraries' memory cachers keep the qlms on the card, so each step copies only the
    spectra of every key on the dd, ds and ss legs to the host."""
    over, tover = TINY[cell]
    _, cfg, traffic, _ = R.load_cell(cell)
    cfg.update(over)
    traffic.update(tover)
    keys, lq = len(traffic['keys']), cfg['lmax_qlm']
    item = 8 if cfg.get('qe_dtype', 'float64') == 'float64' else 4
    return 1e-9 * 3 * keys * (lq + 1) * item


@pytest.mark.parametrize('cell', sorted(TINY))
def test_traced_tiny_run_reads_the_new_metrics(cell):
    over, tover = TINY[cell]
    args = types.SimpleNamespace(workload=cell, seed=2 ** 31 + 5, seconds=0.01, trace=1,
                                 control=None, override=over, traffic_override=tover)
    out = R.run(args, 'cpu')
    kind = 'masked' if cell.startswith('masked') else 'isotropic'
    m = {k: v['value'] for k, v in out['metrics'].items()}
    assert m['cacher_copy_gb_per_sim.' + kind] == pytest.approx(_expected_gb(cell), rel=1e-12)
    assert m['setup_tables_s'] > 0
    assert 'cacher_copy_s_per_sim.' + kind not in m    # no device on the CPU: not measured
    assert np.isfinite(m['qe_s_per_sim.' + kind])
