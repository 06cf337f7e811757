"""BENCHMARK.json keeps to the contract's shape and names, and the harness finds every
configuration, traffic mix and per-layer metric by name, a new file without an edit."""
import json
import os
import re
import shutil

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
BENCH = json.load(open(os.path.join(ROOT, 'BENCHMARK.json')))
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
PATHCH = re.compile(r'^[A-Za-z0-9_./-]+$')


def test_top_level_keys():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs', 'workloads',
                          'end_to_end', 'per_layer'}
    assert 1 <= BENCH['run_seconds'] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_entries_have_the_contract_keys():
    for c in BENCH['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
    for w in BENCH['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'} and w['chips'] in (1, 4)
    for m in BENCH['end_to_end']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'bound', 'source'}
        assert 0.01 <= m['bound'] <= 0.25 and m['source'] in ('host_clock', 'device_trace')
    for m in BENCH['per_layer']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'source', 'layer', 'moves'}
        assert m['moves'] in {e['name'] for e in BENCH['end_to_end']}
    assert 'setup_s' in {m['name'] for m in BENCH['end_to_end']}


def test_names_and_units():
    names = [c['name'] for c in BENCH['configs']] + [w['name'] for w in BENCH['workloads']] \
        + [m['name'] for m in BENCH['end_to_end'] + BENCH['per_layer']] \
        + [w['config'] for w in BENCH['workloads']] + [w['traffic'] for w in BENCH['workloads']] \
        + [k for c in BENCH['configs'] for k in c['reduced']]
    assert all(NAME.match(n) for n in names), names
    for m in BENCH['end_to_end'] + BENCH['per_layer']:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
    for m in BENCH['per_layer']:
        if m['name'].endswith('_roofline'):
            assert m['unit'] == '%'
    for text in [c['why'] for c in BENCH['configs'] + BENCH['workloads']] \
            + [c['source'] for c in BENCH['configs']] + [m['layer'] for m in BENCH['per_layer']]:
        assert 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text
    for d, _, fs in os.walk(HERE):
        for f in fs:
            assert PATHCH.match(os.path.relpath(os.path.join(d, f), ROOT)), f


def test_every_name_is_found():
    import portbench.run as R
    for w in BENCH['workloads']:
        cell, cfg, traffic, _ = R.load_cell(w['name'])
        assert cfg['name'] == w['config']
        assert os.path.exists(os.path.join(HERE, 'builders', cfg['builder'] + '.py'))
        assert traffic['sims_per_step'] >= 1
        for trace in (0, 1):
            assert R.metric_names(BENCH, cell, trace)
    for m in BENCH['per_layer']:
        mod = R.load_metric(m['name'])
        assert callable(mod.read) and mod.UNIT == m['unit'] and mod.MOVES == m['moves']
        assert mod.LAYER == m['layer']


def test_a_new_file_is_found_without_an_edit(tmp_path, monkeypatch):
    import portbench.run as R
    pb = tmp_path / 'portbench'
    shutil.copytree(HERE, pb, ignore=shutil.ignore_patterns('_cache', '__pycache__', 'tests'))
    bench = json.loads(json.dumps(BENCH))
    shutil.copy(pb / 'traffic' / 'mc_chain8.json', pb / 'traffic' / 'mc_chain3.json')
    shutil.copy(pb / 'configs' / 'ideal_l2048.json', pb / 'configs' / 'ideal_l1024.json')
    shutil.copy(pb / 'metrics' / 'qe_s_per_sim.isotropic.py', pb / 'metrics' / 'qe_s_per_sim_new.py')
    bench['configs'].append(dict(bench['configs'][1], name='ideal_l1024',
                                 file='portbench/configs/ideal_l1024.json'))
    bench['workloads'].append(dict(name='ideal_l1024.x', config='ideal_l1024',
                                   traffic='mc_chain3', chips=1, why='w'))
    qe = next(m for m in bench['per_layer'] if m['name'] == 'qe_s_per_sim.isotropic')
    bench['per_layer'].append(dict(qe, name='qe_s_per_sim_new', workloads=['ideal_l1024.x']))
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(bench))
    monkeypatch.setattr(R, 'ROOT', str(tmp_path))
    monkeypatch.setattr(R, 'HERE', str(pb))
    cell, cfg, traffic, b = R.load_cell('ideal_l1024.x')
    assert cell['traffic'] == 'mc_chain3'
    assert [m['name'] for m in R.metric_names(b, cell, 1)] == ['qe_s_per_sim_new']
    assert R.load_metric('qe_s_per_sim_new').read(
        {'rec': type('r', (), {'seconds': {'qe': 2.}})(), 'sims': 4}) == 0.5


def test_run_seconds_fits_the_check():
    rs = BENCH['run_seconds']
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    four = sum(w['chips'] == 4 for w in BENCH['workloads'])
    assert four <= max(1, len(BENCH['workloads']) // 4)


@pytest.mark.parametrize('name', [c['name'] for c in BENCH['configs']])
def test_configs_state_their_cut(name):
    c = next(c for c in BENCH['configs'] if c['name'] == name)
    cfg = json.load(open(os.path.join(ROOT, c['file'])))
    assert sorted(cfg['reduced']) == sorted(c['reduced'])
    assert set(cfg['assumed']) >= set(cfg['reduced'])
    assert cfg['limits'] and cfg['source']
