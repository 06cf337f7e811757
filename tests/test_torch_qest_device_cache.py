"""QELib hands its cacher the device tensors (plancklens_tpu_torch/models/qest.py): a memory
cacher keeps them where they were computed, a file cacher copies them to the host. On the
idealized parfile at lmax 24 on the CPU: the qlms, batches and mean fields through
cacher_mem are bitwise those through cacher_npy and cacher_pk; after one pipeline step
(stage_qe -> stage_mf -> stage_qcl) every cached entry is bitwise what it was when
written, so no consumer wrote into a tensor the cache shares; trace.to_device passes a
tensor already on the device through untouched; cacher_mem still turns array-likes into
numpy; the ring phases of the transforms, which scale their FFTs in place, keep their
bits."""
import importlib.util
import os

import numpy as np
import pytest
import torch

from plancklens_tpu_torch.models.qest import QELib
from plancklens_tpu_torch.utils import trace
from plancklens_tpu_torch.utils.cachers import cacher_mem, cacher_npy, cacher_pk

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def fresh_tracer():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


@pytest.fixture(scope='module')
def drv_par():
    """(examples/run_qlms_torch.py as a module, the idealized parfile at lmax 24, 8 sims, on
    the CPU)."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in (('PLK_LMAX_IVF', 24), ('PLK_LMAX_QLM', 24), ('PLK_NSIMS', 8),
                     ('PLK_DEVICE', 'cpu')):
            mp.setenv(k, str(v))
        mp.delenv('PLK_CACHE_DIR', raising=False)
        spec = importlib.util.spec_from_file_location(
            'run_qlms_torch_device_cache', os.path.join(ROOT, 'examples', 'run_qlms_torch.py'))
        drv = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(drv)
        par = drv.load_parfile(os.path.join(ROOT, 'params', 'idealized_example_torch.py'))
    return drv, par


def _lib(par, leg, cacher, dtype):
    """A fresh QELib on the ivfs of par's qlms_<leg>, with `cacher`."""
    q = getattr(par, 'qlms_' + leg)
    return QELib(q.ivfs1, q.ivfs2, par.cl_len, q.lmax_ivf, q.lmax_qlm, cacher=cacher,
                 dtype=dtype, device='cpu')


def _calls(lib):
    """Every QELib entry point that writes or reads its cacher, in one sequence."""
    return [lib.get_sim_qlm('ptt', 5), lib.get_sim_qlm('xtt', 5),
            lib.get_sim_qlm_batch('p_p', [0, 1, 2]), lib.get_sim_qlm('x_p', 1),
            lib.get_sim_qlm_batch('xtt', [3, 4]), lib.get_sim_qlm_batch('ptt', [3, 4]),
            lib.get_sim_qlm_mf('p_p', [0, 2]), lib.get_sim_qlm_mf('p_p', [0, 2]),
            lib.get_sim_qlm('p_tp', 6), lib.get_sim_qlm_batch('p_p', [0, 1, 2])]


@pytest.mark.parametrize('leg', ['dd', 'ds'])
@pytest.mark.parametrize('dtype', [None, torch.float32])
@pytest.mark.parametrize('kind', ['npy', 'pk'])
def test_memory_cacher_qlms_bitwise_equal_file_cachers(drv_par, kind, dtype, leg, tmp_path):
    _, par = drv_par
    mem = _lib(par, leg, cacher_mem(), dtype)
    disk = _lib(par, leg, (cacher_npy if kind == 'npy' else cacher_pk)(str(tmp_path)),
                dtype)
    got, want = _calls(mem), _calls(disk)
    for a, b in zip(got, want):
        assert a.device == b.device == torch.device('cpu') and a.dtype == b.dtype
        assert torch.equal(a, b)
    # the memory cacher holds tensors on the library's device; the file cacher host arrays
    # of the same bits under the same names
    assert mem.cacher._cache and all(isinstance(v, torch.Tensor) and v.device == mem.device
                                     for v in mem.cacher._cache.values())
    for fn, v in mem.cacher._cache.items():
        assert disk.cacher.is_cached(fn)
        h = disk.cacher.load(fn)
        assert isinstance(h, np.ndarray) and torch.equal(torch.as_tensor(h), v)


class SnapshotCacher(cacher_mem):
    """cacher_mem that keeps a private copy of every entry as it was written."""

    def __init__(self):
        super().__init__()
        self.written = {}

    def cache(self, fn, obj):
        self.written[fn] = obj.clone() if isinstance(obj, torch.Tensor) else np.copy(obj)
        super().cache(fn, obj)


def test_pipeline_step_leaves_cached_entries_untouched(drv_par):
    drv, par = drv_par
    keys = ['ptt', 'p_p']
    libs = [par.qlms_dd, par.qlms_ds, par.qlms_ss, par.qcls_dd, par.qcls_ds, par.qcls_ss]
    saved = [lib.cacher for lib in libs]
    try:
        for lib in libs:
            lib.cacher = SnapshotCacher()
        drv.stage_filt(par, np.arange(8))
        qe, _ = drv.stage_qe(par, keys, np.arange(4, 8))
        mf, _ = drv.stage_mf(par, keys)
        qcl, _ = drv.stage_qcl(par, keys, np.arange(4, 8))
        qcl2, _ = drv.stage_qcl(par, keys, np.arange(4, 8))    # served by the cachers
        for lib in libs[:3]:
            assert lib.cacher.written and lib.cacher.written.keys() == lib.cacher._cache.keys()
            for fn, v in lib.cacher._cache.items():
                assert isinstance(v, torch.Tensor), fn
                assert torch.equal(v, lib.cacher.written[fn]), fn
        for lib in libs[3:]:
            for fn, v in lib.cacher._cache.items():
                assert isinstance(v, np.ndarray) and np.array_equal(v, lib.cacher.written[fn])
        for k in keys:
            assert torch.equal(qe[k], par.qlms_dd.get_sim_qlm_batch(k, np.arange(4, 8)))
            for h, m in zip((par.mc_sims_mf_dd[0::2], par.mc_sims_mf_dd[1::2]), mf[k]):
                assert torch.equal(m, par.qlms_dd.get_sim_qlm_mf(k, h))
        assert all(np.array_equal(qcl[kl], qcl2[kl]) for kl in qcl)
    finally:
        for lib, c in zip(libs, saved):
            lib.cacher = c


@pytest.mark.parametrize('live', [False, True])
def test_to_device_passes_a_tensor_on_the_device_through(live):
    if live:
        trace.enable()
    t = torch.arange(6.).to(torch.complex64)
    assert trace.to_device(t, 'cpu', 'qlm') is t
    assert trace.to_device(t, torch.device('cpu'), 'qlm') is t
    assert trace.records() == [] and trace.counters() == {}
    a = np.arange(6.)          # a host array is still copied, and counted while live
    out = trace.to_device(a, 'cpu', 'qlm')
    assert isinstance(out, torch.Tensor) and np.array_equal(out.numpy(), a)
    assert trace.counters() == ({'copy.to_device_bytes': 48} if live else {})


def test_cacher_mem_keeps_tensors_and_turns_the_rest_into_numpy():
    c = cacher_mem()
    t = torch.ones(3, dtype=torch.complex128)
    pair = (np.ones(2), np.zeros(2))
    c.cache('t', t)
    c.cache('list', [1., 2.])
    c.cache('arr', np.ones(4))
    c.cache('pair', pair)
    assert c.load('t') is t
    assert isinstance(c.load('list'), np.ndarray) and c.load('list').tolist() == [1., 2.]
    assert isinstance(c.load('arr'), np.ndarray)
    assert c.load('pair') is pair


@pytest.mark.parametrize('kind', ['npy', 'pk'])
def test_file_cachers_copy_tensors_to_the_host(kind, tmp_path):
    c = (cacher_npy if kind == 'npy' else cacher_pk)(str(tmp_path))
    t = torch.arange(5.).to(torch.complex64)
    trace.enable()
    c.cache('qlm_ptt_0000', t)
    out = c.load('qlm_ptt_0000')
    assert isinstance(out, np.ndarray) and out.dtype == np.complex64
    assert np.array_equal(out, t.numpy())
    assert trace.counters() == {'copy.to_host_bytes': 40}
    assert [r['attrs'] for r in trace.records()] == [{'bytes': 40, 'what': 'qlm_ptt_0000'}]


def _same_bits(a, b):
    a, b = torch.view_as_real(a), torch.view_as_real(b)
    return a.shape == b.shape and bool((a == b).all()) and torch.equal(torch.signbit(a),
                                                                        torch.signbit(b))


@pytest.mark.parametrize('dtype', [torch.complex64, torch.complex128])
def test_ring_phases_keep_the_bits_of_the_scaled_ffts(dtype):
    """_to_rings and _from_rings scale their FFTs in place, to hold one map-sized buffer
    less; their outputs are bitwise those of the scaled FFTs, so the qlms keep their bits."""
    from plancklens_tpu_torch.ops.sht.transforms import _from_rings, _to_rings
    g = torch.Generator().manual_seed(3)
    nphi, mmax = 40, 12
    Fp = torch.randn((2, 5, mmax + 1), dtype=dtype, generator=g)
    Fm = torch.randn((2, 5, mmax + 1), dtype=dtype, generator=g)
    X = torch.zeros((2, 5, nphi), dtype=dtype)
    X[..., :mmax + 1] = Fp
    X[..., nphi - mmax:] += Fm[..., 1:].flip(-1)
    assert _same_bits(_to_rings(Fp, Fm, nphi, 0.), torch.fft.ifft(X, dim=-1) * nphi)
    maps = torch.randn((2, 5, nphi), dtype=dtype, generator=g)
    T = torch.fft.fft(maps, dim=-1) * (2. * np.pi / nphi)
    Gp, Gm = _from_rings(maps, mmax, 0.)
    assert _same_bits(Gp, T[..., :mmax + 1])
    assert _same_bits(Gm, torch.cat([T[..., :1], T[..., nphi - mmax:].flip(-1)], dim=-1))
