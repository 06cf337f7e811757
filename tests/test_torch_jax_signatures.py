"""The port called the JAX package's way, on the CPU: the signatures that
tests/test_torch_api_parity.py found missing (ROADMAP fault 3.14) and their values.

  * QELib.get_sim_qlm(k, idx, grad_only=True) and InputPlmLib.get_sim_qlm(k, idx,
    grad_only=True) against the JAX package's (<= 1e-10 of max at lmax 24; plain, composite
    and curl keys), the keyword a no-op in both;
  * ops/sht/core.clear_cache() empties the table cache;
  * parallel.mesh.shard_batch(mesh, arr=...) in a world-size-1 gloo group
    (tests/test_torch_parallel.py holds it over two ranks);
  * native.build.build(verbose) with the JAX package's positional verbose.
"""
import numpy as np
import pytest
import torch

from plancklens_tpu import DATAPATH
from plancklens_tpu.models import qest as rqest, qecl as rqecl
from plancklens_tpu.utils import camb_clfile, alm as ralm
from plancklens_tpu_torch.models import qest as pqest, qecl as pqecl
from plancklens_tpu_torch.ops.sht import core as pcore, gl_geometry

torch.set_num_threads(1)

LMAX = 24


def _err(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return np.abs(a - ref).max() / np.abs(ref).max()


class _Ivfs:
    """Harmonic filtering library over fixed alm batches (index = batch row), numpy for
    the JAX package, tensors for the port."""

    def __init__(self, alms, wrap):
        self.alms = {f: [wrap(x) for x in a] for f, a in alms.items()}

    def hashdict(self):
        return {'fixed': True}

    def get_sim_tlm(self, idx):
        return self.alms['t'][idx]

    def get_sim_elm(self, idx):
        return self.alms['e'][idx]

    def get_sim_blm(self, idx):
        return self.alms['b'][idx]


def _alms(seed, batch=2):
    rng = np.random.RandomState(seed)
    ls, ms = ralm._lm_indices(LMAX)
    out = {}
    for f in 'teb':
        a = rng.standard_normal((batch, len(ls))) + 1j * rng.standard_normal((batch, len(ls)))
        a[:, ms == 0] = a[:, ms == 0].real
        a[:, ls < 2] = 0.
        out[f] = a * 1e-3
    return out


@pytest.mark.parametrize('key', ['ptt', 'xtt', 'p_tp', 'p_eb'])
def test_qelib_get_sim_qlm_grad_only(key):
    cls = camb_clfile(DATAPATH + '/cls/FFP10_wdipole_lensedCls.dat', lmax=LMAX)
    alms = _alms(7)
    ivr, ivp = _Ivfs(alms, np.asarray), _Ivfs(alms, torch.from_numpy)
    qr = rqest.QELib(ivr, ivr, cls, LMAX, LMAX)
    qp = pqest.QELib(ivp, ivp, cls, LMAX, LMAX, device='cpu')
    for idx in (0, 1):
        got = qp.get_sim_qlm(key, idx, grad_only=True)
        assert _err(got, qr.get_sim_qlm(key, idx, grad_only=True)) <= 1e-10
        assert torch.equal(got, qp.get_sim_qlm(key, idx))


class _PlmSims:
    def __init__(self, wrap):
        rng = np.random.RandomState(3)
        n = ralm.getsize(LMAX + 6)
        self.plms = [wrap(rng.standard_normal(n) + 1j * rng.standard_normal(n))
                     for _ in range(2)]

    def hashdict(self):
        return {'plm': True}

    def get_sim_plm(self, idx):
        return self.plms[idx]


@pytest.mark.parametrize('key', ['ptt', 'xtt'])
def test_input_plm_lib_get_sim_qlm_grad_only(key):
    lr = rqecl.InputPlmLib(_PlmSims(np.asarray), LMAX)
    lp = pqecl.InputPlmLib(_PlmSims(torch.from_numpy), LMAX, device='cpu')
    for idx in (0, 1):
        got = lp.get_sim_qlm(key, idx, grad_only=True)
        ref = np.asarray(lr.get_sim_qlm(key, idx, grad_only=True))
        assert got.shape == ref.shape == (ralm.getsize(LMAX),)
        assert np.array_equal(got.numpy(), ref)


def test_core_clear_cache():
    geom = gl_geometry(8)
    c = torch.zeros((1, 9, 9), dtype=torch.complex128)
    pcore.legendre_synth_pair(c, None, 0, geom.theta, grid_token=geom.token())
    assert pcore.TABLES._d
    assert pcore.clear_cache() is None
    assert not pcore.TABLES._d


def test_shard_batch_arr():
    from plancklens_tpu_torch.parallel import distributed as pdist, mesh as pmesh
    try:
        mesh = pmesh.make_mesh(1, 1, device='cpu')
        assert mesh.mesh_dim_names == ('sims', 'm') and mesh.mesh.tolist() == [[0]]
        assert pmesh.shard_batch(mesh, arr=np.arange(4)).tolist() == [0, 1, 2, 3]
        with pytest.raises(ValueError, match=r'a \(2, 1\) mesh of 1 ranks'):
            pmesh.make_mesh(2, 1)
    finally:
        pdist.shutdown()


def test_native_build_verbose_positional():
    from plancklens_tpu_torch.native import build as nbuild
    so = nbuild.build(True)
    assert so.endswith('.so') and so == nbuild.build(False)
