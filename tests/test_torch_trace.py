"""The port's tracer (plancklens_tpu_torch/utils/trace.py) on the CPU: off, it records
nothing and enters no profiler range; on, its parents, roots and counters; under a CPU
torch.profiler, every span is a range of the chrome trace joined exactly to its record;
and on tiny chains, the spans and counters the port's layers emit: CG iterations against
the n_iter the solvers return, cacher copy bytes against what the QE libraries' cachers
received and loaded (a memory cacher keeps the qlms on the device, a file cacher copies
them), the table cache's hits and misses, the Legendre calls' shapes against what the
benchmark's wrapper (portbench/harness/trace.py) records for the same calls, no kernel named
by a call on CPU tensors, and core.kernel_calls on hand-built records."""
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from plancklens_tpu_torch.ops import cg
from plancklens_tpu_torch.ops.sht import core, gl_geometry
from plancklens_tpu_torch.utils import trace
from plancklens_tpu_torch.utils.cachers import cacher_mem, cacher_npy

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEGENDRE = ('legendre_synth_pair', 'legendre_anal_pair', 'legendre_synth', 'legendre_anal')


@pytest.fixture(autouse=True)
def fresh_tracer():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _names(recs=None):
    return [r['name'] for r in (trace.records() if recs is None else recs)]


def _profile(fn, tmp_path):
    """Run fn under a CPU torch.profiler; the chrome trace's events."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = str(tmp_path / 'trace.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)['traceEvents']


def _spd_system(n=24, batch=3, seed=0):
    """fwd_op of a symmetric positive-definite matrix on (batch, n) complex vectors of
    m = 0 entries (dot weights 1), a Jacobi pre_op and a right-hand side."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    A = torch.as_tensor(a @ a.T / n + np.diag(np.linspace(0.5, 20., n)))
    d = torch.diagonal(A)
    b = torch.as_tensor(rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n)))

    def fwd(x):
        return torch.complex(x.real @ A.T, x.imag @ A.T)
    return fwd, (lambda r: r / d), b, np.zeros(n, dtype=int)


def _legendre_calls(lmax=12):
    """One call of each entry point, on a symmetric GL grid and on an asymmetric ring set
    (where a pair call makes a plain call for each of its halves)."""
    g = gl_geometry(lmax)
    asym = np.linspace(0.2, 2.6, 9)
    rng = np.random.default_rng(1)

    def c(B, M, dtype=torch.complex128):
        return torch.as_tensor(rng.standard_normal((B, lmax + 1, M))
                               + 1j * rng.standard_normal((B, lmax + 1, M))).to(dtype)

    def q(B, nr, M):
        return torch.as_tensor(rng.standard_normal((B, nr, M))
                               + 1j * rng.standard_normal((B, nr, M)))

    def run():
        core.legendre_synth_pair(c(2, lmax + 1), c(2, lmax + 1), 2, g.theta, 'tg')
        core.legendre_synth_pair(c(1, lmax + 1, torch.complex64), None, 0, g.theta, 'tg')
        core.legendre_anal_pair(q(3, len(g.theta), 8), q(3, len(g.theta), 8), 1, g.theta,
                                lmax, 'tg', m0=4)
        core.legendre_synth_pair(c(1, 6), c(1, 6), 2, asym, 'ta', m0=2)
        core.legendre_anal_pair(q(2, len(asym), 5), None, 1, asym, lmax, 'ta')
        core.legendre_synth(c(2, lmax + 1), -1, asym, 'ta')
        core.legendre_anal(q(1, len(g.theta), lmax + 1), 0, g.theta, lmax, 'tg')
    return run


# ------------------------------------------------------------------ off
def _off_cases():
    fwd, pre, b, ms = _spd_system()
    return {
        'span': lambda: trace.span('x').__enter__(),
        'span_attrs': lambda: trace.span('x', a=1).__exit__(None, None, None),
        'traced': lambda: trace.traced('x')(lambda: 1)(),
        'count': lambda: trace.count('c', 3),
        'to_host': lambda: trace.to_host(torch.ones(4), 'qlm'),
        'to_device': lambda: trace.to_device(np.ones(4), 'cpu', 'qlm'),
        'legendre': _legendre_calls(),
        'pcg': lambda: cg.pcg(fwd, pre, b, 0., 50, 1e-8, ms),
        'pcg_ir': lambda: cg.pcg_ir(fwd, pre, b, 0., 50, 1e-8, ms),
    }


@pytest.mark.parametrize('case', sorted(_off_cases()))
def test_off_records_nothing_and_enters_no_range(case, monkeypatch):
    def no_range(*a, **k):
        raise AssertionError('a profiler range was entered with the tracer off')
    monkeypatch.setattr(torch.profiler, 'record_function', no_range)
    assert trace.span('x') is trace.NOOP and trace.span('y', a=1) is trace.NOOP
    assert not trace.live()
    _off_cases()[case]()
    assert trace.records() == [] and trace.counters() == {}
    assert trace.summary() == {'spans': {}, 'counters': {}}


# ------------------------------------------------------------------ on
def test_on_parents_roots_counters_and_summary():
    trace.enable()
    assert trace.live()
    with trace.span('a', k=1) as a:
        with trace.span('b'):
            with trace.span('a'):       # inside one of its own name: not counted twice
                trace.count('n')
        with trace.span('c') as c:
            c.set(size=7)
            trace.count('n', 4)
    with trace.span('d'):
        trace.count('m', 2)
    recs = trace.records()
    assert _names(recs) == ['a', 'b', 'a', 'c', 'd']
    assert [r['id'] for r in recs] == sorted(r['id'] for r in recs)
    ids = [r['id'] for r in recs]
    assert [r['parent'] for r in recs] == [None, ids[0], ids[1], ids[0], None]
    assert [r['root'] for r in recs] == [ids[0]] * 4 + [ids[4]]
    assert recs[0]['attrs'] == {'k': 1} and recs[3]['attrs'] == {'size': 7}
    assert all(r['t0'] <= r['t1'] for r in recs) and not any(r['profiled'] for r in recs)
    assert recs[0]['t0'] <= recs[2]['t0'] <= recs[2]['t1'] <= recs[0]['t1']
    assert trace.counters() == {'n': 5, 'm': 2}
    s = trace.summary()
    assert {k: v['calls'] for k, v in s['spans'].items()} == {'a': 2, 'b': 1, 'c': 1, 'd': 1}
    assert s['spans']['a']['host_s'] == pytest.approx((recs[0]['t1'] - recs[0]['t0']) * 1e-9)
    a.set_max('rel', torch.tensor([1., 3., 2.]))
    assert recs[0]['attrs']['rel'] == 3.


def test_dump_writes_records_counters_and_summary(tmp_path):
    trace.enable()
    with trace.span('stage.qe', sims=trace.sims(np.arange(4, 8))):
        trace.to_device(trace.to_host(torch.zeros(3, dtype=torch.complex128), 'qlm'), 'cpu',
                        'qlm')
    path = str(tmp_path / 'run_trace.json')
    trace.dump(path)
    with open(path) as f:
        out = json.load(f)
    assert _names(out['records']) == ['stage.qe', 'copy.to_host', 'copy.to_device']
    assert out['records'][0]['attrs'] == {'sims': [4, 4]}
    assert out['records'][1]['attrs'] == {'bytes': 48, 'what': 'qlm'}
    assert out['counters'] == {'copy.to_host_bytes': 48, 'copy.to_device_bytes': 48}
    assert out['spans']['copy.to_host']['calls'] == 1


# ------------------------------------------------------------------ the profiler's clock
@pytest.mark.parametrize('enabled', [False, True])
def test_profiler_ranges_join_records_exactly(enabled, tmp_path):
    if enabled:
        trace.enable()

    def run():
        for i in range(3):
            with trace.span('stage.x', i=i):
                with trace.span('inner'):
                    with trace.span('inner'):
                        torch.ones(8).sum()
                with trace.span('leaf'):
                    pass
        _legendre_calls()()
    events = _profile(run, tmp_path)
    recs = trace.records()
    assert recs and all(r['profiled'] for r in recs)
    joined = trace.join(events)
    assert sorted(joined) == [r['id'] for r in recs]
    by_id = {r['id']: r for r in recs}
    for rid, e in joined.items():
        r = by_id[rid]
        assert e['name'] == r['name']
        if r['parent'] is not None:      # the parent's range holds the child's
            p = joined[r['parent']]
            assert p['ts'] <= e['ts'] and e['ts'] + e['dur'] <= p['ts'] + p['dur'] + 1e-3
    # the ranges keep the spans' names: readers find them by name
    names = {e['name'] for e in events if e.get('cat') == 'user_annotation'}
    assert {'stage.x', 'inner', 'leaf', 'sht.legendre'} <= names


def test_profiler_names_without_the_tracer(tmp_path):
    """The names examples/profile_*_torch.py read appear in a profiler trace of a run that
    does not turn the tracer on."""
    from plancklens_tpu_torch.ops.sht.healpix import HealpixSHT
    core.clear_cache()
    hp = HealpixSHT(4, 8, use_ring_weights=False, device='cpu')
    alm = torch.zeros((1, 45), dtype=torch.complex128)
    alm[0, 3] = 1.
    events = _profile(lambda: hp.map2alm(hp.alm2map(alm)), tmp_path)
    names = {e['name'] for e in events if e.get('cat') == 'user_annotation'}
    assert {'sht.recursion_tables', 'healpix.rings_to_map', 'healpix.map_to_rings'} <= names
    assert not trace.live()


# ------------------------------------------------------------------ the port's layers
@pytest.mark.parametrize('solver', ['pcg', 'pcg_ir'])
def test_cg_spans_and_counter_match_n_iter(solver):
    fwd, pre, b, ms = _spd_system()
    trace.enable()
    x, n_iter, rel = getattr(cg, solver)(fwd, pre, b, 0., 200, 1e-9, ms)
    assert n_iter > 3 and bool((rel <= 1e-9).all())
    names = _names()
    assert names.count('cg.iter') == n_iter == trace.counters()['cg.iters']
    solve = [r for r in trace.records() if r['name'] == 'cg.solve'][0]   # the outermost
    assert solve['parent'] is None
    assert solve['attrs']['iters'] == n_iter and solve['attrs']['batch'] == b.shape[0]
    assert solve['attrs']['rel_max'] == float(rel.max())
    if solver == 'pcg':     # a stop test before every iteration and the one that stops
        assert names.count('cg.stop') == n_iter + 1 and names.count('cg.solve') == 1
    by_id = {r['id']: r for r in trace.records()}
    assert all(by_id[r['parent']]['name'] == 'cg.solve' for r in trace.records()
               if r['name'] in ('cg.iter', 'cg.stop'))


def _nbytes(obj):
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    return np.asarray(obj).nbytes


class _Recording:
    """Cacher mixin that sums the bytes it receives and hands back."""
    cached = loaded = 0

    def cache(self, fn, obj):
        self.cached += _nbytes(obj)
        super().cache(fn, obj)

    def load(self, fn):
        out = super().load(fn)
        self.loaded += _nbytes(out)
        return out


class RecordingCacher(_Recording, cacher_mem):
    pass


class RecordingNpy(_Recording, cacher_npy):
    pass


@pytest.mark.parametrize('kind', ['mem', 'npy'])
def test_copy_counters_equal_the_cachers_bytes(kind, monkeypatch, tmp_path):
    """A memory cacher keeps the QE libraries' qlms as tensors on the library's device: only
    the spectra cross to the host, nothing comes back, and the qlms count as kept on the
    device. A file cacher copies the qlms to the host and back, and the copy counters equal
    the bytes it writes and reads."""
    for k, v in (('PLK_LMAX_IVF', 24), ('PLK_LMAX_QLM', 24), ('PLK_NSIMS', 8),
                 ('PLK_DEVICE', 'cpu')):
        monkeypatch.setenv(k, str(v))
    monkeypatch.delenv('PLK_CACHE_DIR', raising=False)
    spec = importlib.util.spec_from_file_location(
        'run_qlms_torch_trace', os.path.join(ROOT, 'examples', 'run_qlms_torch.py'))
    drv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(drv)
    par = drv.load_parfile(os.path.join(ROOT, 'params', 'idealized_example_torch.py'))
    qe_libs = [par.qlms_dd, par.qlms_ds, par.qlms_ss]
    qcl_libs = [par.qcls_dd, par.qcls_ds, par.qcls_ss]
    libs = qe_libs + qcl_libs
    for j, lib in enumerate(libs):
        lib.cacher = RecordingCacher() if kind == 'mem' \
            else RecordingNpy(str(tmp_path / ('lib%d' % j)))
    trace.enable()
    keys = ['ptt', 'p_p']
    drv.stage_filt(par, np.arange(8))
    drv.stage_qe(par, keys, np.arange(8))
    drv.stage_mf(par, keys)
    drv.stage_qcl(par, keys, np.arange(4, 8))
    c = trace.counters()
    qe_bytes = sum(lib.cacher.cached for lib in qe_libs)
    assert qe_bytes > 0 and sum(lib.cacher.loaded for lib in qe_libs) > 0
    if kind == 'mem':
        for lib in qe_libs:
            assert all(isinstance(v, torch.Tensor) and v.device == lib.device
                       for v in lib.cacher._cache.values())
        assert c['copy.to_host_bytes'] == sum(lib.cacher.cached for lib in qcl_libs) > 0
        assert c.get('copy.to_device_bytes', 0) == 0
        assert c['copy.kept_on_device_bytes'] == qe_bytes
        assert 'copy.to_device' not in _names()
    else:
        assert c['copy.to_host_bytes'] == sum(lib.cacher.cached for lib in libs)
        assert c['copy.to_device_bytes'] == sum(lib.cacher.loaded for lib in qe_libs)
        assert 'copy.kept_on_device_bytes' not in c
    recs = trace.records()
    assert sum(r['attrs']['bytes'] for r in recs if r['name'] == 'copy.to_host') \
        == c['copy.to_host_bytes']
    stages = [r for r in recs if r['name'].startswith('stage.')]
    assert _names(stages) == ['stage.filt', 'stage.qe', 'stage.mf', 'stage.qcl']
    assert stages[3]['attrs'] == {'sims': [4, 4]}
    roots = {r['id']: r['root'] for r in stages}
    assert all(r['root'] in roots for r in recs)      # every span sits in a stage
    assert {'filt.ivf', 'qe.eval', 'qe.leg', 'qe.out', 'sht.legendre'} <= set(_names(recs))


@pytest.mark.parametrize('spin,pair,sets', [(0, True, 1), (2, True, 2), (1, False, 1)])
def test_table_cache_hits_and_misses(spin, pair, sets):
    core.clear_cache()
    T = core.TABLES
    b0 = len(T.builds)
    trace.enable()
    g = gl_geometry(10)
    C = torch.zeros((1, 11, 11), dtype=torch.complex128)
    for _ in range(3):
        if pair:
            core.legendre_synth_pair(C, C if spin else None, spin, g.theta, 'tc')
        else:
            core.legendre_synth(C, spin, g.theta, 'tc')
    assert trace.counters() == {'sht.tables_miss': sets, 'sht.tables_hit': 2 * sets}
    builds = [r for r in trace.records() if r['name'] == 'sht.recursion_tables']
    assert len(builds) == sets == len(T.builds) - b0
    nr = len(g.theta) if not pair else (len(g.theta) + 1) // 2
    for r, (t0, t1) in zip(builds, T.builds[b0:]):
        assert r['attrs']['lmax'] == 10 and r['attrs']['nrings'] == nr
        assert r['attrs']['bytes'] > 0 and t0 <= r['t0'] <= r['t1'] <= t1
    core.legendre_synth(C, spin, g.theta, None)    # no grid token: built, never cached
    assert len(T.builds) - b0 == sets + 1 and trace.counters()['sht.tables_miss'] == sets + 1


@pytest.fixture
def legendre_wrapper():
    """The benchmark's Legendre wrapper installed on the package, removed afterwards."""
    sys.path.insert(0, ROOT)
    from portbench.harness import trace as btrace
    saved = [(mod, attr, val) for name, mod in list(sys.modules.items())
             if mod is not None and name.split('.')[0] == 'plancklens_tpu_torch'
             for attr, val in list(vars(mod).items())
             if any(val is getattr(core, f) for f in LEGENDRE)]
    rec = btrace.Recorder(sync=False)
    btrace.wrap_legendre(rec, core, 'plancklens_tpu_torch')
    yield rec
    for mod, attr, val in saved:
        setattr(mod, attr, val)
    sys.path.remove(ROOT)


def _entry_calls(lmax=12):
    """One CPU call of each entry point, and a pair call on an asymmetric ring set."""
    g = gl_geometry(lmax).theta
    asym = np.linspace(0.2, 2.6, 9)
    z = lambda *shape: torch.zeros(shape, dtype=torch.complex128)
    return {
        'synth_pair': lambda: core.legendre_synth_pair(z(2, 13, 13), z(2, 13, 13), 2, g),
        'anal_pair': lambda: core.legendre_anal_pair(z(1, len(g), 13), None, 1, g, lmax),
        'synth': lambda: core.legendre_synth(z(3, 13, 13), -1, asym),
        'anal': lambda: core.legendre_anal(z(1, len(asym), 13), 0, asym, lmax),
        'asymmetric_pair': lambda: core.legendre_synth_pair(z(1, 13, 13), None, 2, asym),
    }


@pytest.mark.parametrize('entry', sorted(_entry_calls()))
def test_plain_legendre_calls_name_no_kernel(entry):
    """On CPU tensors every entry point runs the plain engine: its span carries no `kernel`
    attr, and kernel_calls counts nothing."""
    trace.enable()
    _entry_calls()[entry]()
    recs = [r for r in trace.records() if r['name'] == 'sht.legendre']
    assert len(recs) == (2 if entry == 'asymmetric_pair' else 1)
    assert not any('kernel' in r['attrs'] for r in recs)
    assert core.kernel_calls(trace.records()) == {}


class _CardLike(torch.Tensor):
    """A CPU tensor that the entry points take for a card tensor (is_cuda True): they run
    their kernel branch, whose wrapper then checks and launches."""

    @property
    def is_cuda(self):
        return True


def _kernel_branch_calls(contiguous, lmax=12):
    """One call of each entry point on _CardLike inputs (contiguous, or transposed views),
    with the key kernel_calls gives it."""
    g = gl_geometry(lmax).theta

    def z(B, R, M):
        x = torch.zeros((B, R, M), dtype=torch.complex128)
        if not contiguous:
            x = torch.zeros((B, M, R), dtype=torch.complex128).transpose(1, 2)
        return x.as_subclass(_CardLike)
    return {
        'synth_pair': (lambda: core.legendre_synth_pair(z(2, 13, 13), z(2, 13, 13), 2, g),
                       ('K1', 1, 2, 'f64')),
        'anal_pair': (lambda: core.legendre_anal_pair(z(1, len(g), 13), None, 1, g, lmax),
                      ('K2', 2, 1, 'f64')),
        'synth': (lambda: core.legendre_synth(z(3, 13, 13), -1, g), ('K3', 3, 3, 'f64')),
        'anal': (lambda: core.legendre_anal(z(1, len(g), 13), 0, g, lmax),
                 ('K4', 3, 1, 'f64')),
    }


@pytest.mark.parametrize('entry', sorted(_kernel_branch_calls(True)))
def test_a_launched_kernel_is_named_after_its_wrapper_returns(entry, monkeypatch):
    """The kernel branch names its kernel once the wrapper has returned (the wrapper is
    replaced by one that returns at once): the record carries `kernel`, and counting
    counts the call under its mode, batch and type."""
    call, key = _kernel_branch_calls(True)[entry]
    monkeypatch.setattr(core.legendre_kernels, entry, lambda *a, **k: 'launched')
    with core.counting() as c:
        assert call() == 'launched'
    legendre = [r for r in c.records if r['name'] == 'sht.legendre']
    assert [r['attrs']['kernel'] for r in legendre] == [key[0]]
    assert c.calls == {key: 1}


@pytest.mark.parametrize('entry', sorted(_kernel_branch_calls(False)))
def test_a_call_its_wrapper_refuses_names_no_kernel(entry):
    """A kernel-branch call that its wrapper refuses (a non-contiguous input) leaves its
    sht.legendre record without `kernel`, and counting counts nothing."""
    call, _ = _kernel_branch_calls(False)[entry]
    with core.counting() as c, pytest.raises(ValueError, match='contiguous'):
        call()
    legendre = [r for r in c.records if r['name'] == 'sht.legendre']
    assert len(legendre) == 1 and 'kernel' not in legendre[0]['attrs']
    assert c.calls == {} and not trace.enabled()


@pytest.mark.parametrize('was_on', [False, True])
def test_counting_leaves_the_tracer_as_it_was_and_every_record(was_on):
    """counting turns the tracer on for its section only, keeps the records from before it
    and those of the section, and hands out the section's records and kernel calls."""
    if was_on:
        trace.enable()
    with trace.span('before'):
        pass
    n0 = len(trace.records())
    with core.counting() as c:
        assert trace.enabled()
        _entry_calls()['synth_pair']()
    assert trace.enabled() == was_on
    assert c.records == trace.records()[n0:] and 'sht.legendre' in _names(c.records)
    assert _names()[:n0] == (['before'] if was_on else [])
    assert c.calls == {}


def _legendre_record(kernel=None, pair=True, spin=0, two=False, B=1, f64=True):
    attrs = dict(kind='synth', pair=pair, lmax=8, m0=0, M=9, spin=spin, two=two, nrings=9,
                 B=B, f64=f64)
    if kernel is not None:
        attrs['kernel'] = kernel
    return {'id': None, 'name': 'sht.legendre', 'parent': None, 'root': None, 't0': 0,
            't1': 1, 'attrs': attrs, 'profiled': False}


def test_kernel_calls_by_kernel_mode_batch_and_type():
    """kernel_calls keys K1/K2 by the pair mode (0: spin 0 alone, 1: two inputs, 2: one
    input of nonzero spin), K3/K4 under mode 3, by batch and data type; records without a
    kernel and of other names count nothing, and a slice after a mark leaves out what came
    before it."""
    recs = [_legendre_record('K1', spin=0, B=8),                       # before the mark
            _legendre_record('K1', spin=0, B=8),
            _legendre_record('K1', spin=0, B=8),
            _legendre_record('K1', spin=2, two=True, B=4, f64=False),
            _legendre_record('K2', spin=1, B=4),
            _legendre_record('K2', spin=0, two=True, B=4),
            _legendre_record('K3', pair=False, spin=-2, B=4),
            _legendre_record('K4', pair=False, spin=2, B=2, f64=False),
            _legendre_record(None, spin=2, two=True, B=1),               # a plain-engine call
            dict(_legendre_record('K1'), name='sht.recursion_tables')]
    assert core.kernel_calls(recs[1:]) == {('K1', 0, 8, 'f64'): 2, ('K1', 1, 4, 'f32'): 1,
                                           ('K2', 2, 4, 'f64'): 1, ('K2', 1, 4, 'f64'): 1,
                                           ('K3', 3, 4, 'f64'): 1, ('K4', 3, 2, 'f32'): 1}
    assert core.kernel_calls(recs)['K1', 0, 8, 'f64'] == 3
    assert core.kernel_calls([]) == {}


def test_legendre_spans_match_the_benchmark_wrapper(legendre_wrapper):
    trace.enable()
    _legendre_calls()()
    calls = legendre_wrapper.calls
    recs = [r for r in trace.records() if r['name'] == 'sht.legendre']
    assert len(recs) == len(calls) == 10            # 7 entry calls, 3 from asymmetric pairs
    index = {r['id']: i for i, r in enumerate(recs)}
    for r, call in zip(recs, calls):
        want = dict(call)
        parent = want.pop('parent')
        assert r['attrs'] == want
        assert (None if r['parent'] is None else index[r['parent']]) == parent
    assert sum(c["parent"] is not None for c in calls) == 3
