"""The trace summaries of examples/profile_qlms_torch.py and profile_healpix_torch.py on
synthetic Chrome-trace events: overlapping device activities count once, activity outside
the window's range is clipped, the recursion-table ranges are summed, device activities
fall into the kernel groups by name and into host ranges by their launch's correlation id;
and the HEALPix path that chip_smoke.py drives, run on the CPU at a small size."""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                'examples'))
import profile_qlms_torch as prof  # noqa: E402

torch.set_num_threads(1)


def _x(name, cat, ts, dur):
    return {'ph': 'X', 'name': name, 'cat': cat, 'ts': ts, 'dur': dur}


@pytest.mark.parametrize('intervals,want', [
    ([], 0.),
    ([(0, 10), (20, 30)], 20e-6),
    ([(0, 10), (5, 30), (6, 7)], 30e-6),
    ([(20, 30), (0, 10), (10, 20)], 30e-6),
])
def test_union_seconds(intervals, want):
    assert prof.union_seconds(intervals) == pytest.approx(want, abs=1e-15)


def test_summarize_busy_idle_and_tables():
    events = [_x('main_path', 'user_annotation', 100, 1000),
              _x('synth_pair_kernel<float>', 'kernel', 150, 100),
              _x('anal_pair_kernel<float>', 'kernel', 200, 100),     # overlaps the first
              _x('Memcpy HtoD (Pageable -> Device)', 'gpu_memcpy', 900, 400),  # clipped
              _x('synth_pair_kernel<float>', 'kernel', 2000, 50),    # outside the window
              _x('sht.recursion_tables', 'user_annotation', 120, 30),
              _x('sht.recursion_tables', 'user_annotation', 400, 20),
              _x('aten::mul', 'cpu_op', 100, 900)]                   # host rows not counted
    out = prof.summarize(events)
    assert out['window_s'] == pytest.approx(1e-3)
    assert out['device_busy_s'] == pytest.approx(350e-6)
    assert out['idle_share'] == pytest.approx(0.65)
    assert out['device_sum_s'] == pytest.approx(650e-6)
    assert out['table_builds'] == 2 and out['table_builds_s'] == pytest.approx(50e-6)
    top = out['rows'][0]
    assert (top['name'], top['calls']) == ('Memcpy HtoD (Pageable -> Device)', 1)
    synth = [r for r in out['rows'] if r['name'].startswith('synth')][0]
    assert synth['calls'] == 2 and synth['s'] == pytest.approx(150e-6)


def test_summarize_needs_one_main_path_range():
    with pytest.raises(RuntimeError, match='main_path'):
        prof.summarize([_x('k', 'kernel', 0, 10)])


# ------------------------------------------------ examples/profile_healpix_torch.py
import profile_healpix_torch as hprof  # noqa: E402


def _k(name, cat, ts, dur, corr):
    return dict(_x(name, cat, ts, dur), args={'correlation': corr})


@pytest.mark.parametrize('name,cat,group', [
    ('void synth_pair_kernel<float, 4, 4, 1>(float2 const*)', 'kernel', 'K1 synth_pair'),
    ('void (anonymous namespace)::synth_pair_mma_kernel<4, 4, 1>(double2 const*)', 'kernel',
     'K1 synth_pair'),
    ('void (anonymous namespace)::synth_pair_mma_kernel<8, 2, 0>(double2 const*)', 'kernel',
     'K1 synth_pair'),
    ('void anal_pair_kernel<float, 4, 1, 2>(float2 const*)', 'kernel', 'K2 anal_pair'),
    ('void (anonymous namespace)::anal_pair_mma_kernel<double, 8, 4, 1>(double2 const*)',
     'kernel', 'K2 anal_pair'),
    ('void (anonymous namespace)::anal_pair_mma_kernel<float, 16, 8, 0>(float2 const*)',
     'kernel', 'K2 anal_pair'),
    ('void synth_pair_kernel<double, 4, 1, 3>(double2 const*)', 'kernel', 'K3 synth'),
    ('void anal_pair_kernel<double, 4, 1, 3>(double2 const*)', 'kernel', 'K4 anal'),
    ('void (anonymous namespace)::anal_pair_sum_kernel<float, 1>(float2*)', 'kernel',
     'K2 anal_pair'),
    ('void (anonymous namespace)::anal_pair_sum_kernel<double, 3>(double2*)', 'kernel',
     'K4 anal'),
    ('void regular_fft<256u, EPT<16u>, 32u>(kernel_arguments_t)', 'kernel', 'cufft'),
    ('void at::native::vectorized_elementwise_kernel<4>', 'kernel', 'other kernels'),
    ('Memcpy DtoH (Device -> Pageable)', 'gpu_memcpy', 'copies'),
])
def test_device_group(name, cat, group):
    assert hprof.device_group({'name': name, 'cat': cat}) == group


def test_second_pass_counts_with_its_kernel():
    """K4's split ring sum is two device rows, the analysis kernel and its second pass:
    both fall into K4's group, in the main-path summary and the HEALPix one, and the
    group's calls count the kernel's calls; K2's cluster kernel is one row a call."""
    k2 = 'void (anonymous namespace)::anal_pair_mma_kernel<float, 16, 8, 1>(float2 const*)'
    k4 = 'void (anonymous namespace)::anal_pair_kernel<double, 2, 2, 3>(double2 const*)'
    k4s = 'void (anonymous namespace)::anal_pair_sum_kernel<double, 3>(double2*)'
    rows = [_x(k2, 'kernel', 10, 100), _x(k2, 'kernel', 200, 105),
            _x(k4, 'kernel', 400, 300), _x(k4s, 'kernel', 700, 7)]
    for window, fn in (('main_path', prof.summarize), ('healpix_path', hprof.summarize_path)):
        out = fn([_x(window, 'user_annotation', 0, 1000)] + rows)
        assert out['groups']['K2 anal_pair'] == {'s': pytest.approx(205e-6), 'calls': 2}
        assert out['groups']['K4 anal'] == {'s': pytest.approx(307e-6), 'calls': 1}
        assert list(out['groups']) == ['K4 anal', 'K2 anal_pair']
    assert prof.is_second_pass({'name': k4s, 'cat': 'kernel'})
    assert not prof.is_second_pass({'name': k4, 'cat': 'kernel'})


def test_summarize_path_steps_groups_and_longitude():
    k3 = 'void synth_pair_kernel<double, 4, 1, 3>(double2 const*)'
    fft = 'void vector_fft<64u>(kernel_arguments_t)'
    events = [
        _x('healpix_path', 'user_annotation', 0, 1000),
        _x('healpix_path.alm2map', 'user_annotation', 0, 400),
        _x('healpix_path.fits_write', 'user_annotation', 400, 600),
        _x('healpix.rings_to_map', 'user_annotation', 200, 100),
        _k('cudaLaunchKernel', 'cuda_runtime', 50, 5, 1),      # K3, outside the longitude
        _k('cudaLaunchKernel', 'cuda_runtime', 210, 5, 2),     # FFT inside rings_to_map
        _k('cudaLaunchKernel', 'cuda_runtime', 250, 5, 3),     # copy inside rings_to_map
        _k(k3, 'kernel', 60, 200, 1),
        _k(fft, 'kernel', 300, 50, 2),
        _k('Memcpy DtoH (Device -> Pageable)', 'gpu_memcpy', 380, 40, 3),
        _x('sht.recursion_tables', 'user_annotation', 10, 30)]
    out = hprof.summarize_path(events)
    assert out['window_s'] == pytest.approx(1e-3)
    assert out['device_busy_s'] == pytest.approx(290e-6)
    a2m, fw = out['steps']['alm2map'], out['steps']['fits_write']
    assert a2m['device_busy_s'] == pytest.approx(270e-6)       # the copy clipped at 400
    assert fw['device_busy_s'] == pytest.approx(20e-6)
    assert fw['idle_share'] == pytest.approx(1. - 20. / 600.)
    assert out['groups']['K3 synth'] == {'s': pytest.approx(200e-6), 'calls': 1}
    assert out['groups']['cufft']['s'] == pytest.approx(50e-6)
    assert out['longitude']['host_s'] == pytest.approx(100e-6)
    assert out['longitude']['device_s'] == pytest.approx(90e-6)  # FFT + copy, not K3
    assert out['table_builds'] == 1


def test_attribute_innermost_range():
    events = [_x('outer', 'user_annotation', 0, 100), _x('inner', 'user_annotation', 10, 20),
              _k('cudaLaunchKernel', 'cuda_runtime', 15, 1, 7),
              _k('cudaLaunchKernel', 'cuda_runtime', 50, 1, 8),
              _k('k', 'kernel', 200, 30, 7), _k('k', 'kernel', 300, 40, 8),
              _k('k', 'kernel', 400, 50, 9)]                 # no launch: not attributed
    assert hprof.attribute(events, ('outer', 'inner')) == {
        'outer': pytest.approx(40e-6), 'inner': pytest.approx(30e-6)}


def test_healpix_path_on_cpu(monkeypatch, tmp_path):
    """The path chip_smoke.py drives, at nside 32 / lmax 32 on the CPU in f64: alm round
    trip <= 1e-6 relative rms and qlms within 1e-5 of the harmonic route's, chip_smoke's
    bounds (measured here at 4e-8 and 3e-8 at most for nside 32..256, lmax = nside)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for k, v in (('PLK_LMAX_IVF', 32), ('PLK_LMAX_QLM', 32), ('PLK_NSIMS', 2),
                 ('PLK_DEVICE', 'cpu')):
        monkeypatch.setenv(k, str(v))
    monkeypatch.delenv('PLK_CACHE_DIR', raising=False)
    import run_qlms_torch as drv
    par = drv.load_parfile(os.path.join(root, 'params', 'idealized_example_torch.py'))
    idxs, keys = [0, 1], ('ptt', 'p_p')
    obs = par.sims.get_sim_teblm_batch(idxs)
    maps, alms, qlms, secs = hprof.healpix_path(par, obs, idxs, keys, str(tmp_path), 32, 32,
                                                'cpu')
    assert set(secs) == set(hprof.STEPS)
    assert all(tuple(m.shape) == (2, 12 * 32 ** 2) for m in maps)
    assert len(os.listdir(tmp_path)) == 6

    def rel_rms(a, b):
        return ((a - b).abs().pow(2).sum() / b.abs().pow(2).sum()).sqrt().item()

    from plancklens_tpu_torch.utils import alm as ualm
    hi = torch.as_tensor(ualm._lm_indices(32)[0]) >= 2
    assert rel_rms(alms[0], obs[0]) <= 1e-6
    assert max(rel_rms(a[:, hi], o[:, hi]) for a, o in zip(alms[1:], obs[1:])) <= 1e-6
    for k in keys:
        assert rel_rms(qlms[k], par.qlms_dd.get_sim_qlm_batch(k, idxs)) <= 1e-5
