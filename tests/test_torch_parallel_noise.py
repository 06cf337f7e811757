"""chip_smoke.py phase 11 rehearsed on the CPU at small sizes (examples/
parallel_noise_torch.py): 11a's identities on the SMICA-like channels (uniform monopole
1e-10 relative, P's halving and E/B swap 1e-10 of max), 11b's bounds on patchy's N0s (the
schemes between the deepest and shallowest patch's homogeneous N0, mv-rew <= no-rew x
1.001, a uniform map's schemes within 1e-4 and |MC - 1| < 0.1) and its card-against-CPU
comparison run CPU against CPU (every gap within its fault-3.9 limit), 11c's world-size-1
ShardedIVFS -> QELib (bitwise), and 11d's two gloo ranks (each rank's gathered results,
1e-12 of max). The
card-only pieces (kernel rows, NCCL) run in chip_smoke.py."""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                'examples'))
import parallel_noise_torch as pn  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device('cpu')


def test_channel_weights_sum_to_one():
    for nl, sc in ((pn.NLEV_T, None), (pn.NLEV_P, (1.3, 1., 1.1, 0.8))):
        w = pn.channel_weights(pn.LMAX_W, nl, scale=sc)
        assert w.shape == (4, pn.LMAX_W + 1) and np.all(w > 0.)
        assert np.abs(w.sum(0) - 1.).max() <= 1e-14
    assert 2 * pn.LMAX_W == 4094


def test_w2wsq_monopole_at_full_width():
    """11a's quadrature at its full width: the monopole of w2wsq at lmax_out 4094 on the
    default GL nodes (4095 of them, from ops/gauleg's Newton iteration) is exact to 1e-10
    relative (7.2e-11 measured; scipy's nodes give 4.3e-7)."""
    w = pn.channel_weights(pn.LMAX_W, pn.NLEV_T)
    assert pn.w2wsq_monopole(w, 2 * pn.LMAX_W, CPU) <= 1e-10


def test_freq_weighting_rehearsal():
    r = pn.freq_weighting_full(CPU, nside=64, lmax_w=31, log=lambda s: None)
    assert r['finite_positive'] and r['lmax_out'] == 62 and r['shape'] == (65, 135)
    assert max(r['monopole'], r['halving'], r['swap']) <= 1e-10, r


def test_patchy_rehearsal():
    r = pn.patchy_full(CPU, lmax=512, lmax_qlm=512, log=lambda s: None)
    for key in ('ptt', 'p_p'):
        assert r['finite'][key]
        assert min(v[0] for v in r['between'][key].values()) >= 0.95
        assert max(v[1] for v in r['between'][key].values()) <= 1.05
        assert r['mv'][key] <= 1.001
        assert len(r['patches'][key][0]) == 4
    assert r['uniform_spread'] <= 1e-4 and r['uniform_mc'] < 0.1


def test_patchy_card_vs_cpu_rehearsal():
    gaps = pn.patchy_card_vs_cpu(CPU, lmax=64, log=lambda s: None)
    assert len(gaps) == 10
    for name, v in gaps.items():
        if isinstance(v, tuple):
            assert v[0] == 0. and v[1] == 0. and v[2] >= 1e-12 and v[3] < 1e-12, name
        else:
            assert v == 0., name


def test_sharded_world1_rehearsal():
    r = pn.sharded_world1(CPU, lmax=32, nsims=4, log=lambda s: None)
    assert r['backend'] == 'gloo' and r['equal'] and r['rel'] == 0.
    assert not torch.distributed.is_initialized()


def test_two_ranks_rehearsal():
    res = pn.two_ranks_one_card(CPU, lmax=32, nsims=4, batch=2, timeout=240,
                                log=lambda s: None)
    assert [r['rank'] for r in res] == [0, 1] and all(r['backend'] == 'gloo' for r in res)
    assert res[0]['m'] == [0, 10] and res[1]['m'] == [10, 33]
    for r in res:
        assert max(r['errs'].values()) <= 1e-12, r['errs']
