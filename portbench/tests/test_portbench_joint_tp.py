"""The configuration's own reference and check: the lookup by configuration leaves the
existing cells' checks bitwise as they were; the joint T/P reference's GMV estimator and
coupled residual at tiny sizes on the CPU (this test may import the program; the reference
may not)."""
import types

import numpy as np
import pytest
import torch

import portbench.run as R
from portbench.harness import check
from portbench.inputs import Grid, Inputs, camb_cls, nalm
from portbench.reference import chain, joint_tp
from portbench.reference.qe import QE
from portbench.reference.sht import SHT
from test_portbench_chain import TINY
from test_portbench_healpix import TINY as TINY_MAPS

CELLS = {'masked_l2048.mc_chain': TINY['masked_l2048.mc_chain'],
         'ideal_l2048.mc_chain': TINY['ideal_l2048.mc_chain'],
         'ideal_maps_n2048.mc_chain': (TINY_MAPS, None)}
RNG = np.random.default_rng(23)


def _run(cell, seed):
    over, tover = CELLS[cell]
    args = types.SimpleNamespace(workload=cell, seed=seed, seconds=0.01, trace=0,
                                 control=None, override=over, traffic_override=tover)
    return R.run(args, 'cpu')


def test_a_configuration_without_a_reference_gets_the_chains():
    for cell in CELLS:
        _, cfg, _, _ = R.load_cell(cell)
        assert 'reference' not in cfg
        assert R.load_reference(cfg) == (chain.Reference, check.compare)
    _, cfg, _, _ = R.load_cell('masked_jtp_l2048.gmv_chain')
    assert R.load_reference(cfg) == (joint_tp.Reference, joint_tp.compare)


@pytest.mark.parametrize('cell', sorted(CELLS))
def test_the_lookup_gives_the_direct_checks_bitwise(cell, monkeypatch):
    seed = 2 ** 31 + 311
    got = _run(cell, seed)
    monkeypatch.setattr(R, 'load_reference', lambda cfg: (chain.Reference, check.compare))
    want = _run(cell, seed)
    assert got['checks'] == want['checks']
    assert (got['correct'], got['failed']) == (want['correct'], want['failed'])


def _alms(b, lmax):
    a = RNG.standard_normal((b, nalm(lmax))) + 1j * RNG.standard_normal((b, nalm(lmax)))
    a[:, :lmax + 1] = a[:, :lmax + 1].real
    return torch.as_tensor(a)


def _qe(key, cls, lmax, lq, terms):
    g = Grid((2 * lmax + lq) // 2)
    return QE(key, cls, lmax, lq, lambda L: SHT(g.theta, g.weight, g.nphi, L, device='cpu'),
              'cpu', terms=terms)


def test_gmv_p_is_ptt_plus_p_p_without_te():
    lmax, lq = 20, 30
    cls = dict(camb_cls('FFP10_wdipole_lensedCls.dat', lmax))
    cls['te'] = np.zeros_like(cls['te'])
    teb1, teb2 = tuple(_alms(2, lmax) for _ in range(3)), tuple(_alms(2, lmax) for _ in range(3))
    p, ptt, pp = (_qe(k, cls, lmax, lq, joint_tp.gmv_terms) for k in ('p', 'ptt', 'p_p'))
    for cross in (None, teb2):
        g, c = p(teb1, cross)
        (g1, c1), (g2, c2) = ptt(teb1, cross), pp(teb1, cross)
        assert (g - g1 - g2).abs().max() <= 1e-12 * g.abs().max()
        assert (c - c1 - c2).abs().max() <= 1e-12 * c.abs().max()


def test_gmv_p_against_the_program_cpu_path():
    """With C^TE, the written-out 'p' is the program's GMV estimator."""
    from plancklens_tpu_torch.models.qest import eval_qe
    lmax, lq = 20, 30
    cls = camb_cls('FFP10_wdipole_lensedCls.dat', lmax)
    q = _qe('p', cls, lmax, lq, joint_tp.gmv_terms)
    t1, e1, b1, t2, e2, b2 = (_alms(2, lmax) for _ in range(6))
    d1, d2 = {'t': t1, 'e': e1, 'b': b1}, {'t': t2, 'e': e2, 'b': b2}
    for cross in (False, True):
        gp, cp = eval_qe('p', lmax, cls, lambda f: d1[f], lq, device='cpu',
                         get_alm2=(lambda f: d2[f]) if cross else None)
        gr, cr = q((t1, e1, b1), (t2, e2, b2) if cross else None)
        assert (gp - gr).abs().max() < 1e-11 * gp.abs().max()
        assert (cp - cr).abs().max() < 1e-11 * cp.abs().max()


def test_cg_resid_tp_of_the_programs_solution(tmp_path):
    """The program's joint solve of a tiny sky meets eps_min under the reference's coupled
    operator; with its bar-e zeroed the residual reads far above it."""
    from portbench.builders import masked_jtp
    cell = 'masked_jtp_l2048.gmv_chain'
    _, cfg, traffic, _ = R.load_cell(cell)
    cfg.update(TINY[cell][0])
    inp = Inputs(cfg, 2 ** 31 + 17, 'cpu', traffic)
    par = masked_jtp.build(cfg, traffic, inp, 'cpu', str(tmp_path))
    t, e, b = par.ivfs_raw.get_sim_teblm_batch([5])
    assert not par.end_step([5])['failed']
    ref = joint_tp.Reference(cfg, inp, 'cpu')
    maps = ref.maps([5])
    assert float(ref.residual_tp(*maps, t, e, b).max()) <= cfg['cinv_tp']['eps_min']
    assert float(ref.residual_tp(*maps, t, torch.zeros_like(e), b).min()) > 1e-3
