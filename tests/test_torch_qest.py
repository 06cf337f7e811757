"""Port parity of the quadratic estimators: plancklens_tpu_torch.models.qest.eval_qe for
ptt, p_p, p and x against plancklens_tpu.models.qest.eval_qe at f64 on the same filtered
alms (<= 1e-10 of max), plain and symmetrised (two different legs); the copied key
grammar; and QELib's key resolution, cache names and the '_bh_' keys' need of a
response library (tests/test_torch_qresp_nhl.py holds a '_bh_' qlm to the reference)."""
import numpy as np
import pytest
import torch

from plancklens_tpu import DATAPATH
from plancklens_tpu.models import qest as rqest, qresp as rqresp
from plancklens_tpu.utils import camb_clfile, alm as ralm
from plancklens_tpu_torch.models import qest as pqest, qresp as pqresp, qecl as pqecl
from plancklens_tpu_torch.utils import alm as palm

torch.set_num_threads(1)

LMAX = 24


def _err(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return np.abs(a - ref).max() / np.abs(ref).max()


def _filtered_alms(seed, batch=2):
    rng = np.random.RandomState(seed)
    ls, ms = ralm._lm_indices(LMAX)
    out = {}
    for f in 'teb':
        a = rng.standard_normal((batch, len(ls))) + 1j * rng.standard_normal((batch, len(ls)))
        a[:, ms == 0] = a[:, ms == 0].real
        a[:, ls < 2] = 0.
        out[f] = a * 1e-3
    return out


@pytest.mark.parametrize('key', ['ptt', 'p_p', 'p', 'x'])
def test_eval_qe_matches_reference(key):
    cls = camb_clfile(DATAPATH + '/cls/FFP10_wdipole_lensedCls.dat', lmax=LMAX)
    a1, a2 = _filtered_alms(1), _filtered_alms(2)
    rg, rc = rqest.eval_qe(key, LMAX, cls, lambda f: a1[f], LMAX)
    pg, pc = pqest.eval_qe(key, LMAX, cls, lambda f: torch.from_numpy(a1[f]), LMAX,
                           device='cpu')
    assert pg.shape == (2, ralm.getsize(LMAX)) and pg.dtype == torch.complex128
    assert _err(pg, rg) <= 1e-10 and _err(pc, rc) <= 1e-10
    # symmetrised estimator of two different legs, output band limit below the legs'
    rg, rc = rqest.eval_qe(key, LMAX, cls, lambda f: a1[f], LMAX - 6,
                           get_alm2=lambda f: a2[f])
    pg, pc = pqest.eval_qe(key, LMAX, cls, lambda f: torch.from_numpy(a1[f]), LMAX - 6,
                           get_alm2=lambda f: torch.from_numpy(a2[f]), device='cpu')
    assert _err(pg, rg) <= 1e-10 and _err(pc, rc) <= 1e-10


@pytest.mark.parametrize('key', ['ptt', 'p_p', 'p', 'x', 'ftt', 'stt', 'p_eb', 'xte'])
def test_qe_weights_identical(key):
    cls = camb_clfile(DATAPATH + '/cls/FFP10_wdipole_lensedCls.dat', lmax=LMAX)
    r = rqresp.get_qes(key, LMAX, cls)
    p = pqresp.get_qes(key, LMAX, cls)
    assert len(r) == len(p)
    for qr, qp in zip(r, p):
        for lr, lp in ((qr.leg_a, qp.leg_a), (qr.leg_b, qp.leg_b)):
            assert lr == lp
        Ls = np.arange(LMAX + 1)
        assert np.array_equal(qr.cL(Ls), qp.cL(Ls))
    assert all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(pqresp.qe_spin_data(key), rqresp.qe_spin_data(key)))


class _Ivfs:
    """Minimal harmonic filtering library over fixed alm batches (index = batch row)."""

    def __init__(self, alms):
        self.alms = {f: torch.from_numpy(a) for f, a in alms.items()}

    def hashdict(self):
        return {'fixed': True}

    def get_sim_tlm(self, idx):
        return self.alms['t'][idx]

    def get_sim_elm(self, idx):
        return self.alms['e'][idx]

    def get_sim_blm(self, idx):
        return self.alms['b'][idx]

    def get_sim_teblm_batch(self, idxs):
        i = torch.as_tensor(np.atleast_1d(idxs))
        return tuple(self.alms[f][i] for f in 'teb')


def test_qelib_keys_cache_and_refusals():
    cls = camb_clfile(DATAPATH + '/cls/FFP10_wdipole_lensedCls.dat', lmax=LMAX)
    ivfs = _Ivfs(_filtered_alms(3, batch=3))
    lib = pqest.QELib(ivfs, ivfs, cls, LMAX, LMAX, device='cpu')
    b = lib.get_sim_qlm_batch('ptt', [0, 1, 2])
    # the batch writes through to the per-index entries of both gradient and curl
    assert torch.equal(lib.get_sim_qlm('ptt', 1), b[1])
    assert lib.cacher.is_cached('qlm_xtt_0002')
    x = lib.get_sim_qlm('xtt', 2)
    g, c = pqest.eval_qe('ptt', LMAX, cls, lambda f: ivfs.alms[f][2:3], LMAX,
                         device='cpu')
    assert _err(x, c[0]) <= 1e-12 and _err(b[2], g[0]) <= 1e-12
    ptp = lib.get_sim_qlm_batch('p_tp', [0, 1])
    assert _err(ptp, lib.get_sim_qlm_batch('ptt', [0, 1])
                + lib.get_sim_qlm_batch('p_p', [0, 1])) <= 1e-14
    mf = lib.get_sim_qlm_mf('ptt', [0, 2])
    assert _err(mf, (b[0] + b[2]) / 2) <= 1e-14
    assert lib.get_fundkeys(['p_tp', 'ptt_bh_s']) == ['ptt', 'p_p', 'stt']
    # '_bh_' keys need a response library, as in the reference (qest.py:313-316)
    with pytest.raises(AssertionError, match='resplib'):
        lib.get_sim_qlm('ptt_bh_s', 0)
    with pytest.raises(AssertionError, match='resplib'):
        lib.get_sim_qlm_batch('ptt_bh_s', [0])
    lib32 = pqest.QELib(ivfs, ivfs, cls, LMAX, LMAX, dtype=torch.float32, device='cpu')
    assert lib32._ctag == '_float32'
    assert lib32.get_sim_qlm('ptt', 0).dtype == torch.complex64
    assert lib32.cacher.is_cached('qlm_float32_ptt_0000')


def test_qecl_split_half_mf_and_guards():
    """QeClLib on a port QELib: split-half MF subtraction (even sims for leg A, odd for
    leg B), the MF-containment guard and its leave-one-out path, cached accessors."""
    cls = camb_clfile(DATAPATH + '/cls/FFP10_wdipole_lensedCls.dat', lmax=LMAX)
    ivfs = _Ivfs(_filtered_alms(4, batch=5))
    lib = pqest.QELib(ivfs, ivfs, cls, LMAX, LMAX, device='cpu')
    qcl = pqecl.QeClLib(lib, lib, [0, 1, 2], lmax_qlm=LMAX)
    q = lib.get_sim_qlm_batch('ptt', [0, 1, 2, 3, 4])
    mfA, mfB = (q[0] + q[2]) / 2, q[1]
    want = palm.alm2cl(q[3] - mfA, LMAX, alm2=q[3] - mfB).numpy()
    assert np.abs(qcl.get_sim_qcl('ptt', 3) - want).max() <= 1e-14 * np.abs(want).max()
    batch = qcl.get_sim_qcl_batch('ptt', [3, 4])
    assert np.array_equal(batch[0], qcl.get_sim_qcl('ptt', 3))
    with pytest.raises(ValueError, match='mean-field set'):
        qcl.get_sim_qcl('ptt', 2)
    with pytest.raises(ValueError, match='mean-field set'):
        qcl.get_sim_qcl_batch('ptt', [1, 3])
    loo = qcl.get_sim_qcl('ptt', 2, leave_out=True)     # sim 2 leaves leg A's half
    want = palm.alm2cl(q[2] - q[0], LMAX, alm2=q[2] - mfB).numpy()
    assert np.abs(loo - want).max() <= 1e-14 * np.abs(want).max()
    with pytest.raises(KeyError):
        qcl.load_sim_qcl('ptt', 4, k2='p_p')
    st = qcl.get_sim_stats_qcl('ptt', [3, 4])
    assert np.allclose(st.mean(), batch.mean(0), rtol=1e-14, atol=0)
    assert qcl.fsky12 == 1. and qcl.get_lmaxqcl('ptt', 'ptt') == LMAX
