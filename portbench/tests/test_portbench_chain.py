"""A whole run at a tiny size on the CPU, the harness's look for a card skipped: sound
runs come out correct; the control and each fault a cell can have, planted in the timed
path underneath, come out not correct."""
import types

import numpy as np
import pytest
import torch

import portbench.run as R

TINY = {
    'masked_l2048.mc_chain': (dict(lmax_ivf=24, lmax_qlm=24, grid_lmax=24, lmin_ivf=3,
                                   cinv_t=dict(marge_monopole=True, marge_dipole=True,
                                               lmax_dense=6, eps_min=1e-5, iter_max=300),
                                   cinv_p=dict(lmax_dense=6, eps_min=1e-5, iter_max=300)),
                              dict()),
    'ideal_l2048.mc_chain': (dict(lmax_ivf=24, lmax_qlm=40, lmin_ivf=2),
                             dict(sims_per_step=4, warm_sims=4)),
    'masked_jtp_l2048.gmv_chain': (dict(lmax_ivf=24, lmax_qlm=24, grid_lmax=24, lmin_ivf=3,
                                        cinv_tp=dict(marge_monopole=True, marge_dipole=True,
                                                     lmax_dense=6, eps_min=1e-5,
                                                     iter_max=400)),
                                   dict()),
}


def run_cpu(cell, seed=2 ** 31 + 77, control=None):
    over, tover = TINY[cell]
    args = types.SimpleNamespace(workload=cell, seed=seed, seconds=0.01, trace=0,
                                 control=control, override=over, traffic_override=tover)
    return R.run(args, 'cpu')


@pytest.mark.parametrize('cell', sorted(TINY))
def test_sound_run_is_correct(cell):
    out = run_cpu(cell)
    assert out['correct'], out['checks']
    assert out['attempted'] >= 1 and out['failed'] == 0
    assert list(out)[-1] == 'checks'
    kind = 'masked' if cell.startswith('masked') else 'isotropic'
    assert set(out['metrics']) == {'setup_s', 'sims_per_hour.' + kind}


@pytest.mark.parametrize('cell,control', [('masked_l2048.mc_chain', 'qe_f32'),
                                          ('ideal_l2048.mc_chain', 'tf32'),
                                          ('masked_jtp_l2048.gmv_chain', 'f32'),
                                          ('masked_jtp_l2048.gmv_chain', 'qe_f32')])
def test_control_is_not_correct(cell, control):
    assert not run_cpu(cell, control=control)['correct']


def _unchanged_state(monkeypatch, cell):
    if cell.startswith('masked'):       # CinvTP calls pcg, IVFCinv's batches pcg_frozen
        from plancklens_tpu_torch.ops import cg
        for name in ('pcg', 'pcg_frozen'):
            monkeypatch.setattr(cg, name, lambda f, p, b, x0, *a, **k:
                                (torch.zeros_like(b), 0, torch.zeros(b.shape[0])))
    else:
        from plancklens_tpu_torch.models.filt import IVFSepTP
        monkeypatch.setattr(IVFSepTP, '_filt', lambda self, alm, f, b: alm)


def _half_batch(monkeypatch, cell):
    from plancklens_tpu_torch.models import qest
    orig = qest.QELib._get_alm_batch_fn

    def half(self, ivfs, idxs):
        idxs = np.atleast_1d(idxs)
        keep = idxs[:max(1, len(idxs) // 2)]
        return orig(self, ivfs, np.resize(keep, len(idxs)))
    monkeypatch.setattr(qest.QELib, '_get_alm_batch_fn', half)


def _altered_answer(monkeypatch, cell):
    from plancklens_tpu_torch.models.qecl import QeClLib
    orig = QeClLib.get_sim_qcl_batch

    def altered(self, *a, **k):
        cl = orig(self, *a, **k).copy()
        cl[-1, -1] *= 1. + 1e-2
        return cl
    monkeypatch.setattr(QeClLib, 'get_sim_qcl_batch', altered)


@pytest.mark.parametrize('cell', sorted(TINY))
@pytest.mark.parametrize('fault', [_unchanged_state, _half_batch, _altered_answer])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch, cell)
    try:
        out = run_cpu(cell)
    except Exception:           # a fault that crashes the run has failed too
        return
    assert not out['correct'], out['checks']


@pytest.mark.cuda
@pytest.mark.parametrize('cell', sorted(TINY))
def test_tiny_run_on_the_card(cell, card):
    over, tover = TINY[cell]
    args = types.SimpleNamespace(workload=cell, seed=2 ** 31 + 78, seconds=0.01, trace=1,
                                 control=None, override=over, traffic_override=tover)
    out = R.run(args, str(card))
    assert out['correct'], out['checks']
    assert out['device']['busy_s'] > 0 and out['metrics']
