"""chip_smoke.py phase 8 rehearsed on the CPU, and the port's band-power demo:

  * examples/bandpowers_demo_torch.py's `n1_card_vs_cpu`, `n1_full` and `bandpower_chain`
    on params/anisofilt_example_torch.py at PLK_ANISO_LMAX=32, PLK_ANISO_NSIMS=10 on the
    CPU, with the shapes, keys and checks that the phase reads (the device is the CPU
    here, so the card-vs-CPU differences are exactly zero);
  * phase 8d's get_N0 check (`n0_card_vs_cpu`, `n0_limit`) at lmax 256 on the CPU: the
    floor is positive and small, and the per-L limit sees both N0 from f32-rounded spectra
    and N0 from d-matrices rounded to f32 (the Wigner products of a precision fault);
  * the demo run as a subprocess (`PLK_DEVICE=cpu python examples/bandpowers_demo_torch.py`,
    lmax 32, 5 sims), printing the reference demo's lines.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'examples'))

import bandpowers_demo_torch as bd                                # noqa: E402

torch.set_num_threads(1)
LMAX, NSIMS = 32, 10


@pytest.fixture(scope='module')
def par():
    saved = {k: os.environ.get(k) for k in ('PLK_ANISO_LMAX', 'PLK_ANISO_NSIMS', 'PLK_DEVICE')}
    p, setup_s = bd.load_aniso('cpu', LMAX, NSIMS)
    yield p, setup_s
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def test_phase8_rehearsed(par):
    p, setup_s = par
    assert p.lmax_qlm == LMAX and p.nsims == NSIMS and p.DEVICE.type == 'cpu'
    assert list(p.mc_sims_bias) == [0, 1] and list(p.mc_sims_var) == list(range(2, 10))
    # 8a
    a = bd.n1_card_vs_cpu('cpu', p, log=lambda s: None)
    assert set(a['small']) == {'ptt_ptt', 'pee_peb', 'xtt_xtt', 'jtp'}
    assert all(v == 0. for v in a['small'].values()) and a['full'] == 0.
    assert a['knots'] == [10, 16, 32] and np.all(np.isfinite(a['full_values']))
    # 8b: four fundamental curves, every one cached under the reference's names
    b = bd.n1_full(p, log=lambda s: None)
    assert sorted(b['curves_s']) == sorted([('pee', 'peb'), ('pee', 'pee'), ('peb', 'peb'),
                                            ('ptt', 'ptt')])
    assert b['finite'] and all(s >= 0. for s in b['curves_s'].values())
    assert all(fn.startswith('n1_p') for fn in p.n1_dd.cacher._cache)
    for k in ('ptt', 'p_p'):
        assert b['ratio'][k].shape == (2,) and np.all(np.isfinite(b['ratio'][k]))
    assert np.all(b['low_bins'])
    # 8c
    c = bd.bandpower_chain(p, setup_s=setup_s, log=lambda s: None)
    assert c['finite'] and c['bins'] == '4_16_32' and c['var'] == list(range(2, 10))
    assert sorted(c['seconds']) == sorted(['setup', 'filt', 'qe', 'qcl', 'responses', 'nhl',
                                           'n1', 'binner'])
    assert all(v >= 0. for v in c['seconds'].values())
    assert set(c['res']) == {'ptt', 'p_p'}
    for k, r in c['res'].items():
        for name in ('fid', 'dat', 'mcn0', 'rdn0', 'dat_nhl', 'n1', 'ps_corr', 'bmmc', 'ampl',
                     'bp', 'bp_bound', 'rdn0_ratio', 'nhl_ratio'):
            assert r[name].shape == (2,), (k, name)
        assert r['nhl_cov'].shape == r['mcn0_cov'].shape == (2, 2)
        assert len(r['ps_data']) == 6 and np.all(r['bp_bound'] > 0.)
        # the bound is the stated one: K sigma_b of get_mcn0_cov + F |fid|
        nsig, floor = bd.BP_BOUND
        assert np.allclose(r['bp_bound'], nsig * np.sqrt(np.diag(r['mcn0_cov']))
                           + floor * np.abs(r['fid']))
        # at lmax 32 the band-powers are noise-dominated, but the debiased data stay
        # within the bound the phase holds them to, and RDN0 is close to MCN0
        assert np.all(r['bp_dev'] <= r['bp_bound']), k
        assert np.all(np.abs(r['rdn0_ratio'] - 1.) < 0.5), k


def test_bandpowers_demo_runs_on_cpu():
    env = dict(os.environ, PLK_DEVICE='cpu')
    for k in ('PLK_ANISO_LMAX', 'PLK_ANISO_NSIMS', 'PLK_CACHE_DIR'):
        env.pop(k, None)
    out = subprocess.run([sys.executable, os.path.join(REPO, 'examples',
                                                       'bandpowers_demo_torch.py')],
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    for line in ('parfile loaded: lmax=32 nsims=5', 'device=cpu', 'binner ready, bins 4_16_32',
                 'data band-powers', 'MCN0', 'RDN0', 'N1', 'debiased band-powers',
                 'fiducial C_L^kk bins'):
        assert line in out.stdout, (line, out.stdout)


def test_n0_check_rehearsed():
    r = bd.n0_card_vs_cpu('cpu', lmax=256, draws=2, log=lambda s: None)
    assert set(r['n0_gap']) == {'%s %s' % (k, w) for k in ('ptt', 'p_p', 'p')
                                for w in ('grad', 'curl')}
    for k, (inv_gap, band_gap) in r['n0_gap'].items():
        assert inv_gap == 0. and band_gap == 0., k         # the device is the CPU here
        assert 0. < r['n0_floor'][k] < 1e-10, k
        assert r['n0_f32'][k] > bd.n0_limit(r['n0_floor'][k]), k
    assert bd.n0_limit(1e-15) == 1e-12 and bd.n0_limit(1e-11) == 1e-11 * bd.N0_FLOOR_X


def test_n0_limit_sees_f32_wigner(monkeypatch):
    from plancklens_tpu_torch.models import n0s
    from plancklens_tpu_torch.ops import wigner
    kw = dict(beam_fwhm=5., nlev_t=35., nlev_p=55., lmax_CMB=256, lmin_CMB=102,
              lmax_out=256, device='cpu')
    wigner.clear_cache()
    ref = n0s.get_N0(**kw)
    r = bd.n0_card_vs_cpu('cpu', lmax=256, draws=2, log=lambda s: None)
    f64_dmat = wigner._dmat_ab_np
    monkeypatch.setattr(wigner, '_dmat_ab_np', lambda *a: f64_dmat(*a).astype(np.float32)
                        .astype(np.float64))
    wigner.clear_cache()
    try:
        bad = n0s.get_N0(**kw)
    finally:
        wigner.clear_cache()
    for i, which in ((0, 'grad'), (1, 'curl')):
        for k in ref[i]:
            name = '%s %s' % (k, which)
            gap = bd.n0_gaps(bad[i][k], ref[i][k], 256)[1]
            assert gap > 100. * bd.n0_limit(r['n0_floor'][name]), (name, gap)
