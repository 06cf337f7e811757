"""The lensed masked chain's parameter file and chip_smoke.py phase 7 on the CPU:

  * params/anisofilt_example_torch.py at PLK_ANISO_LMAX=32, PLK_DEVICE=cpu through
    examples/run_qlms_torch.py's stages filt, qe, mf, xin and nhl, then qcl on mc_sims_var;
  * phase 7 (examples/lensed_chain_torch.py) rehearsed at small sizes: the three steps run
    end to end on the plain path with the shapes, keys and checks the phase reads; the
    step-by-step lensed sim equals the libraries' own; the cosmic-variance reckoning of the
    spectrum check (`binned_ratios`) holds for Gaussian skies drawn from a known spectrum,
    and an unlensed sky's zero BB fails it.
"""
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'examples'))

import lensed_chain_torch as lc                                  # noqa: E402

torch.set_num_threads(1)


def test_card_vs_cpu_and_lensed_sims_rehearsed():
    r = lc.card_vs_cpu('cpu', lmax=24, dlmax=8, log=lambda s: None)
    assert r['maps_err'] == 0. and r['alms_err'] == 0. and r['curl_moves'] > 1e-6
    b = lc.lensed_sims('cpu', lmax=32, dlmax=8, sims=(0, 1), log=lambda s: None)
    assert b['split_vs_library'] <= 1e-12
    steps = ('deflection', 'positions', 'ecp_t', 'ecp_qu', 'interp', 'map2alm', 'beam_noise')
    for secs in b['per_sim_s']:
        assert sorted(secs) == sorted(steps) and all(v >= 0. for v in secs.values())
    assert set(b['table_builds_s']) == {'deflection (spin 1, GL)', 'ECP spin 0', 'ECP spin 2',
                                        'GL spin 0', 'GL spin 2'}
    assert b['ecp'][0] == 4 * 41 and b['ecp'][1] % 2 == 0 and b['grid'][0] == 33
    assert 'kernels' not in b                 # the kernel rows time the card only


def test_binned_ratio_reckoning():
    """Four Gaussian full-sky sims of a known spectrum: every bin's ratio within 5 sigma_b
    (sigma_b from the reckoning itself), sigma_b as the mode count says; zero power fails."""
    lmax, nsims = 1600, 4
    ls = np.arange(lmax + 1)
    cl = np.zeros(lmax + 1)
    cl[2:] = 1. / ls[2:] ** 2
    rng = np.random.RandomState(3)
    # hat C_l of a Gaussian field: C_l chi^2_{2l+1} / (2l+1)
    sims = [cl * rng.chisquare(2 * ls + 1) / (2 * ls + 1) for _ in range(nsims)]
    ratio, sigma = lc.binned_ratios(sims, cl, lmax)
    assert len(ratio) == len(lc.BINS) == 14
    assert np.all(np.abs(ratio - 1.) <= 5. * sigma)
    lo = np.arange(100, 200)
    assert np.isclose(sigma[0], np.sqrt(2. * np.sum((2 * lo + 1.) * cl[lo] ** 2) / nsims)
                      / np.sum((2 * lo + 1.) * cl[lo]))
    nsig, floor = lc.SPECTRA_BOUND['bb']
    zero, _ = lc.binned_ratios([0. * cl] * nsims, cl, lmax)
    assert np.all(np.abs(zero - 1.) > nsig * sigma + floor)


def test_parfile_chain_rehearsed():
    out = lc.parfile_chain('cpu', lmax=32, nsims=2, log=lambda s: None)
    assert out['finite'] and out['nsims'] == 2 and 0.7 < out['fsky'] < 0.9
    assert set(out['ampl']) == {'ptt', 'p_p'}
    assert out['shapes']['qlm'] == {'ptt': (2, 561), 'p_p': (2, 561)}
    assert out['shapes']['qcl'] == {'ptt': (2, 33), 'p_p': (2, 33)}
    now, peak = out['dmat_cache_bytes']
    assert 0 < now <= peak
    for k in ('setup_s', 'filt_s', 'qe_s', 'qcl_s', 'resp_s', 'nhl_s', 'xin_s'):
        assert out[k] >= 0.


def test_anisofilt_parfile_runs_on_cpu(tmp_path):
    """The port's parfile through examples/run_qlms_torch.py at lmax 32 on the CPU: filt,
    qe, mf, xin and nhl on sims 0-3, then the spectra on mc_sims_var."""
    env = dict(os.environ, PLK_ANISO_LMAX='32', PLK_ANISO_NSIMS='5', PLK_DEVICE='cpu',
               PLK_CACHE_DIR=str(tmp_path))
    drv = os.path.join(REPO, 'examples', 'run_qlms_torch.py')
    par = os.path.join(REPO, 'params', 'anisofilt_example_torch.py')
    out = subprocess.run([sys.executable, drv, par, '--device', 'cpu', '-imin', '0',
                          '-imax', '3', '-k', 'ptt', 'p_p', '--stages', 'filt,qe,mf,xin,nhl'],
                         capture_output=True, text=True, env=env, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    for tag in ('[filt]', '[qe]', '[mf]', '[xin]', '[nhl]', 'done.'):
        assert tag in out.stdout, out.stdout
    out = subprocess.run([sys.executable, drv, par, '--device', 'cpu', '-imin', '1',
                          '-imax', '4', '-k', 'ptt', '--stages', 'qcl'],
                         capture_output=True, text=True, env=env, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert '[qcl]' in out.stdout and '(4, 33)' in out.stdout, out.stdout
