"""Port of the parallel layer (plancklens_tpu_torch.parallel) on torch.distributed, CPU:

  * the single-process fallback of `init_distributed` (no launcher: rank 0 of 1, nothing
    initialised; the reference's mpi.py:17 semantics, as tests/test_distributed.py checks
    for the JAX package);
  * the m-split's pieces in one process: `m_blocks` (even starts, balanced by the
    Legendre work), the recursion tables of an m range (equal to the whole set's
    columns), and the pair transforms on even-start m-blocks through the plain twins of
    K1/K2 against the unsplit call (1e-12 of max; an odd start raises);
  * two spawned gloo processes (PLK_COORD rendezvous), each waited on with a timeout and
    killed on expiry so the suite cannot hang: `init_distributed`, `barrier`,
    `local_jobs`, `host_array_to_global`; `shard_sht` with n_m = 2 at lmax 63, spins 0 and
    2, both directions, gathered and held to the single-process SHT (1e-12 of max); and
    `ShardedIVFS` on params/idealized_example_torch.py at lmax 32, 8 sims over the two
    ranks, against the unsharded qlm (1e-10), with the hasattr contract;
  * examples/run_qlms_torch.py --mesh under torchrun with two gloo ranks and a shared
    PLK_CACHE_DIR, its cached QEs and mean fields against the unsharded run's (the qe
    stage on sims 0-7, and on 4-7 so that the mf stage's QEs go through the sharded
    filter).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from plancklens_tpu_torch.ops.sht import core, gl_geometry
from plancklens_tpu_torch.parallel import distributed as pdist
from plancklens_tpu_torch.parallel.mesh import m_blocks, ring_blocks

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_single_process_fallback(monkeypatch):
    for v in ('PLK_COORD', 'RANK', 'WORLD_SIZE', 'SLURM_NTASKS', 'OMPI_COMM_WORLD_SIZE',
              'MASTER_ADDR', 'MASTER_PORT'):
        monkeypatch.delenv(v, raising=False)
    assert pdist.init_distributed(device='cpu') == (0, 1)
    assert not torch.distributed.is_initialized()
    assert (pdist.rank(), pdist.size()) == (0, 1)
    assert pdist.local_jobs(range(5)) == [0, 1, 2, 3, 4]
    pdist.barrier()   # no-op
    assert pdist.backend_for_cards([('h', 'cpu')]) == 'gloo'
    assert pdist.backend_for_cards([('h', 'u0'), ('h', 'u1')]) == 'nccl'


@pytest.mark.parametrize('lmax,mmax,n', [(2048, 2048, 2), (2048, 2048, 4), (63, 63, 2),
                                         (40, 20, 3), (6, 6, 2)])
def test_m_blocks_even_and_balanced(lmax, mmax, n):
    blocks = m_blocks(lmax, mmax, n)
    assert blocks[0][0] == 0 and blocks[-1][1] == mmax + 1 and len(blocks) == n
    assert all(a % 2 == 0 and b > a for a, b in blocks)
    assert all(b == c for (_, b), (c, _) in zip(blocks[:-1], blocks[1:]))
    work = np.array([sum(lmax + 1 - m for m in range(a, b)) for a, b in blocks], float)
    # every boundary is the even column nearest to its share: within two columns' work
    assert np.abs(work - work.sum() / n).max() <= 2 * (n - 1) * (lmax + 1)
    r = ring_blocks(lmax + 1, n)
    assert r[0][0] == 0 and r[-1][1] == lmax + 1


@pytest.mark.parametrize('n', [0, -2, 2, 3])
def test_tables_of_an_m_range(n):
    th = gl_geometry(40).theta[:21]
    full = core.recursion_tables(40, 40, n, th)
    for m0 in (6, 12):
        part = core.recursion_tables(40, 33, n, th, m0=m0)
        for k in ('alpha', 'beta', 'gamma', 'l0', 'seed_v', 'seed_k'):
            assert np.array_equal(part[k], full[k][..., m0:34]), (k, m0)
    core.TABLES.clear()
    tok = ('test_m_range',)
    a = core.TABLES.get(40, 33, n, th, tok, 'cpu', 6)
    assert core.TABLES.get(40, 33, n, th, tok, 'cpu', 6) is a
    assert core.TABLES.get(40, 33, n, th, tok, 'cpu', 8) is not a


@pytest.mark.parametrize('spin,two', [(0, False), (1, True), (2, True), (2, False)])
def test_even_start_m_blocks_through_twins(spin, two):
    """Pair synthesis/analysis on even-start m-blocks (the twins of K1/K2, which read the
    mirror sign's parity off the column index) against the unsplit call."""
    lmax, mmax = 47, 44
    geom = gl_geometry(lmax)
    rng = np.random.RandomState(11 + spin)
    cx = lambda *s: torch.as_tensor(rng.standard_normal(s) + 1j * rng.standard_normal(s))
    C = [cx(2, lmax + 1, mmax + 1) for _ in range(2)]
    Q = [cx(2, geom.nrings, mmax + 1) for _ in range(2)]
    Fp, Fm = core.legendre_synth_pair(C[0], C[1] if two else None, spin, geom.theta)
    A, Bc = core.legendre_anal_pair(Q[0], Q[1] if two else None, spin, geom.theta, lmax)
    for blocks in (m_blocks(lmax, mmax, 2), m_blocks(lmax, mmax, 3)):
        parts_s, parts_a = [], []
        for m0, m1 in blocks:
            sl = slice(m0, m1)
            parts_s.append(core.legendre_synth_pair(
                C[0][..., sl].contiguous(), C[1][..., sl].contiguous() if two else None,
                spin, geom.theta, m0=m0))
            parts_a.append(core.legendre_anal_pair(
                Q[0][..., sl].contiguous(), Q[1][..., sl].contiguous() if two else None,
                spin, geom.theta, lmax, m0=m0))
        for whole, parts in ((Fp, [p[0] for p in parts_s]), (A, [p[0] for p in parts_a])):
            assert _rel(torch.cat(parts, -1), whole) <= 1e-12
        if two:
            for whole, parts in ((Fm, [p[1] for p in parts_s]), (Bc, [p[1] for p in parts_a])):
                assert _rel(torch.cat(parts, -1), whole) <= 1e-12
    with pytest.raises(ValueError, match='even m'):
        core.legendre_synth_pair(C[0][..., 3:9].contiguous(), None, spin, geom.theta, m0=3)


_WORKER = r"""
import json, os, sys
sys.path.insert(0, os.environ['PLK_REPO'])
import numpy as np
import torch
torch.set_num_threads(1)
from plancklens_tpu_torch.parallel import distributed as pdist, mesh as pmesh
from plancklens_tpu_torch.ops.sht import SHT, gl_geometry
from plancklens_tpu_torch.utils import alm as ualm

res = {}
rank, size = pdist.init_distributed(device='cpu')
res['init'] = [rank, size, int(os.environ['PLK_PROCID']), pdist.rank(), pdist.size()]
pdist.barrier('test')
res['local_jobs'] = pdist.local_jobs(range(7))
mesh_s = pdist.global_mesh()                       # ('sims', 'm') = (2, 1)
res['global'] = pdist.host_array_to_global(torch.full((1, 4), rank + 1.), mesh_s).tolist()
gn = pdist.host_array_to_global(np.full((2, 3), 10. * rank), mesh_s)
res['global_np'] = [type(gn).__name__, list(gn.shape), gn[:, 0].tolist()]
res['shard_batch'] = pmesh.shard_batch(mesh_s, np.arange(6)).tolist()

# the m-split SHT over two ranks of the 'm' axis, against the single-process SHT
mesh_m = pmesh.make_mesh(n_sims=1, n_m=2)
lmax = 63
sht = SHT(gl_geometry(lmax), lmax, device='cpu')
ssht = pmesh.shard_sht(sht, mesh_m, log=lambda s: print(s, file=sys.stderr))
res['split'] = [ssht.m_split, ssht.ring_split]
rng = np.random.RandomState(0)                   # the same inputs on both ranks
nalm = ualm.getsize(lmax)
ms = ualm._lm_indices(lmax)[1]

def alm(B):
    a = rng.standard_normal((B, nalm)) + 1j * rng.standard_normal((B, nalm))
    a[:, ms == 0] = a[:, ms == 0].real
    return torch.as_tensor(a)

def gather_rings(x):
    # pad every rank's ring block to the widest, all-gather over 'm', trim, concatenate
    w = max(b - a for a, b in ssht.ring_split)
    pad = torch.nn.functional.pad(x, (0, 0, 0, w - x.shape[-2]))
    parts = pdist.all_gather_cat(pad[None], pmesh.axis_group(mesh_m, 'm')).unbind(0)
    return torch.cat([p[..., :b - a, :] for p, (a, b) in zip(parts, ssht.ring_split)], -2)

def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())

errs = {}
t = alm(2)
errs['alm2map_0'] = rel(gather_rings(ssht.alm2map(t)), sht.alm2map(t))
maps = torch.as_tensor(rng.standard_normal((2, sht.geom.nrings, sht.geom.nphi)))
errs['map2alm_0'] = rel(ssht.map2alm(maps[..., ssht.rings, :]), sht.map2alm(maps))
g, c = alm(2), alm(2)
g[:, :2] = 0.
c[:, :2] = 0.
re, im = ssht.alm2map_spin((g, c), 2)
rre, rim = sht.alm2map_spin((g, c), 2)
errs['alm2map_2'] = max(rel(gather_rings(re), rre), rel(gather_rings(im), rim))
q, u = (torch.as_tensor(rng.standard_normal((2, sht.geom.nrings, sht.geom.nphi)))
        for _ in range(2))
sg, sc = ssht.map2alm_spin((q[..., ssht.rings, :], u[..., ssht.rings, :]), 2)
rg, rc = sht.map2alm_spin((q, u), 2)
errs['map2alm_2'] = max(rel(sg, rg), rel(sc, rc))
res['sht'] = errs

# ShardedIVFS over the two ranks of the 'sims' axis, against the unsharded parfile
os.environ.update(PLK_LMAX_IVF='32', PLK_LMAX_QLM='32', PLK_NSIMS='8', PLK_DEVICE='cpu')
sys.path.insert(0, os.path.join(os.environ['PLK_REPO'], 'examples'))
from run_qlms_torch import load_parfile
par_ref = load_parfile(os.path.join(os.environ['PLK_REPO'], 'params',
                                    'idealized_example_torch.py'), 'cpu')
par = load_parfile(os.path.join(os.environ['PLK_REPO'], 'params',
                                'idealized_example_torch.py'), 'cpu')
sh = pmesh.ShardedIVFS(par.ivfs, mesh_s)
par.qlms_dd.ivfs1 = par.qlms_dd.ivfs2 = sh
idxs = np.arange(8)
q = par.qlms_dd.get_sim_qlm_batch('ptt', idxs)
qr = par_ref.qlms_dd.get_sim_qlm_batch('ptt', idxs)
ivfs = {'qlm': rel(q, qr), 'qlm_equal': bool(torch.equal(q, qr))}
teb = sh.get_sim_teblm_batch(idxs)
teb_r = par_ref.ivfs.get_sim_teblm_batch(idxs)
ivfs['teb'] = max(rel(a, b) for a, b in zip(teb, teb_r))
odd = sh.get_sim_teblm_batch(np.arange(3))           # does not divide: whole
ivfs['odd'] = max(rel(a, b) for a, b in zip(odd, par_ref.ivfs.get_sim_teblm_batch(np.arange(3))))

class NoBatch:
    ftl = 3.
    def hashdict(self):
        return {'k': 1}
    def get_sim_tlm(self, idx):
        return idx

nb = pmesh.ShardedIVFS(NoBatch(), mesh_s)
ivfs['hasattr'] = [hasattr(nb, 'get_sim_teblm_batch'), hasattr(sh, 'get_sim_teblm_batch'),
                   nb.ftl, nb.get_sim_tlm(4), nb.hashdict() == {'k': 1},
                   sh.hashdict() == par.ivfs.hashdict()]
res['ivfs'] = ivfs
pdist.barrier()
print('RESULT ' + json.dumps(res), flush=True)
pdist.shutdown()
"""


@pytest.fixture(scope='module')
def two_ranks():
    """Both ranks' results of _WORKER, run as two gloo processes on the CPU."""
    coord = '127.0.0.1:%d' % pdist.free_port()
    env_base = {k: v for k, v in os.environ.items()
                if k not in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT',
                             'SLURM_NTASKS', 'OMPI_COMM_WORLD_SIZE', 'PLK_NATIVE')}
    procs = [subprocess.Popen([sys.executable, '-c', _WORKER],
                              env=dict(env_base, PLK_COORD=coord, PLK_NPROC='2',
                                       PLK_PROCID=str(i), PLK_REPO=REPO,
                                       OMP_NUM_THREADS='1'),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            pytest.fail('a distributed worker timed out (both killed)')
        outs.append((p.returncode, out, err))
    res = []
    for rc, out, err in outs:
        assert rc == 0, (rc, out[-3000:], err[-3000:])
        line = [s for s in out.splitlines() if s.startswith('RESULT ')]
        assert line, (out[-3000:], err[-3000:])
        res.append(json.loads(line[-1][7:]))
    return res


def test_two_ranks_init_barrier_local_jobs(two_ranks):
    for r, res in enumerate(two_ranks):
        assert res['init'] == [r, 2, r, r, 2]
        assert res['local_jobs'] == list(range(7))[r::2]
        assert res['shard_batch'] == [3 * r, 3 * r + 1, 3 * r + 2]


def test_two_ranks_host_array_to_global(two_ranks):
    for res in two_ranks:
        assert res['global'] == [[1.] * 4, [2.] * 4]
        assert res['global_np'] == ['ndarray', [4, 3], [0., 0., 10., 10.]]


@pytest.mark.parametrize('which', ['alm2map_0', 'map2alm_0', 'alm2map_2', 'map2alm_2'])
def test_shard_sht_two_m_ranks(two_ranks, which):
    for res in two_ranks:
        assert res['split'] == [[[0, 18], [18, 64]], [[0, 32], [32, 64]]]
        assert res['sht'][which] <= 1e-12, res['sht']


def test_sharded_ivfs_qlm_matches_unsharded(two_ranks):
    for res in two_ranks:
        assert res['ivfs']['qlm'] <= 1e-10
        for k in ('teb', 'odd'):
            assert res['ivfs'][k] <= 1e-10, (k, res['ivfs'])


def test_sharded_ivfs_hasattr_contract(two_ranks):
    for res in two_ranks:
        assert res['ivfs']['hasattr'] == [False, True, 3., 4, True, True]


def _run(cmd, env, cwd, what):
    """Run cmd in a session of its own, killed with every process it started past 240 s;
    returns its standard output."""
    p = subprocess.Popen(cmd, env=env, cwd=cwd, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = p.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, 9)
        p.communicate()
        pytest.fail('%s timed out (killed)' % what)
    assert p.returncode == 0, (what, out[-3000:], err[-3000:])
    return out


def _driver_against_unsharded(tmp_path, imin):
    """examples/run_qlms_torch.py --mesh under torchrun, two gloo ranks on the CPU sharing
    one PLK_CACHE_DIR, stages filt, qe (sims imin..7) and mf (the mean-field sims 0-3):
    every stage runs on both ranks, and the cached QEs and mean fields equal those of the
    unsharded run (1e-10 of max)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT', 'PLK_COORD',
                        'LOCAL_WORLD_SIZE')}
    env.update(PLK_LMAX_IVF='32', PLK_LMAX_QLM='32', PLK_NSIMS='8', OMP_NUM_THREADS='1')
    driver = [os.path.join(REPO, 'examples', 'run_qlms_torch.py'),
              os.path.join(REPO, 'params', 'idealized_example_torch.py'), '--device', 'cpu',
              '-imin', str(imin), '-imax', '7', '-k', 'ptt', 'p_p', '--stages', 'filt,qe,mf']
    out = _run([sys.executable, '-m', 'torch.distributed.run', '--nproc_per_node', '2',
                '--master_port', str(pdist.free_port())] + driver + ['--mesh'],
               dict(env, PLK_CACHE_DIR=str(tmp_path / 'mesh')), str(tmp_path), 'torchrun')
    for r in range(2):
        assert '[rank %d/2] mesh (sims 2, m 1) on cpu, backend gloo' % r in out
        assert '[rank %d/2] [mf]   ptt,p_p: split-half mean fields in' % r in out
        assert '[rank %d/2] done.' % r in out
    _run([sys.executable] + driver, dict(env, PLK_CACHE_DIR=str(tmp_path / 'ref')),
         str(tmp_path), 'the unsharded run')

    def files(d):
        return sorted(os.path.relpath(os.path.join(r, f), d)
                      for r, _, fs in os.walk(d) for f in fs)

    ref = files(str(tmp_path / 'ref'))
    assert files(str(tmp_path / 'mesh')) == ref
    assert sum('_mf_' in f for f in ref) == 4, ref    # 2 keys x 2 halves
    assert len(ref) == 4 + 4 * 8, ref     # + ptt, p_p and their curls xtt, x_p of sims 0-7
    errs = {}
    for f in ref:
        a, b = (np.load(os.path.join(str(tmp_path / d), f)) for d in ('mesh', 'ref'))
        errs[f] = float(np.abs(a - b).max() / np.abs(b).max())
    assert max(errs.values()) <= 1e-10, errs
    return out


def test_driver_mesh_under_torchrun(tmp_path):
    """The qe stage on sims 0-7 on both ranks (with the mean-field sims among them, so the
    mf stage finds its QEs cached, as each rank's cache holds the same products)."""
    out = _driver_against_unsharded(tmp_path, 0)
    for r in range(2):
        assert '[rank %d/2] [qe]   ptt,p_p: 8 sims in' % r in out


def test_driver_mesh_mf_through_the_sharded_filter(tmp_path):
    """The qe stage on sims 4-7: the mf stage's QEs of sims 0-3 go through the sharded
    filter, on both ranks in the same calls."""
    out = _driver_against_unsharded(tmp_path, 4)
    for r in range(2):
        assert '[rank %d/2] [qe]   ptt,p_p: 4 sims in' % r in out
