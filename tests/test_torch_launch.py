"""The launcher resolution of plancklens_tpu_torch.parallel.distributed on the CPU:

  * `launch_env` over environment mappings of torchrun, srun (SLURM), mpirun (OpenMPI)
    and the explicit PLK_COORD launch: rank, size, local rank and size and the tcp://
    rendezvous. Under srun and mpirun (each node-list and uri form among them) the rank,
    size, local rank and rendezvous are held to what jax's SlurmCluster and OmpiCluster,
    which jax.distributed runs for the JAX package, read from the same environment, unless
    MASTER_ADDR/MASTER_PORT are set;
  * every rank of a node through `card_for` and `backend_for_cards`, with a patched card
    count and the uuids each rank sees: srun -n 4 on a four-card node (cuda:0-3, NCCL),
    one card bound to each task (cuda:0 each, NCCL), two tasks on one card (gloo);
  * the node-list and OpenMPI uri forms, `local_device_ids`, the raising cases,
    `init_distributed` called the JAX package's way, and an explicit backend;
  * a two-process gloo run on the CPU launched with a SLURM-shaped environment and no
    MASTER_ADDR/MASTER_PORT, waited on with a timeout and killed on expiry.
"""
import json
import os
import subprocess
import sys

import pytest
import torch
from jax._src.clusters import ClusterEnv, OmpiCluster, SlurmCluster

from plancklens_tpu_torch.parallel import distributed as pdist
from plancklens_tpu_torch.parallel.distributed import (
    LaunchEnv, backend_for_cards, card_for, launch_env, ompi_coordinator, slurm_first_host,
    slurm_tasks_per_node)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _slurm(procid, ntasks=4, per_node='4', **kw):
    env = dict(SLURM_JOB_ID='1234', SLURM_STEP_NODELIST='node[001-002],gpu7',
               SLURM_NTASKS=str(ntasks), SLURM_PROCID=str(procid),
               SLURM_LOCALID=str(procid % int(per_node) if per_node.isdigit() else 0),
               SLURM_STEP_TASKS_PER_NODE=per_node)
    env.update(kw)
    return env


def _torchrun(rank, size=2, **kw):
    env = dict(RANK=str(rank), WORLD_SIZE=str(size), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(size), MASTER_ADDR='10.0.0.1', MASTER_PORT='29500')
    env.update(kw)
    return env


def _ompi(rank, size=2, **kw):
    env = dict(OMPI_COMM_WORLD_RANK=str(rank), OMPI_COMM_WORLD_SIZE=str(size),
               OMPI_COMM_WORLD_LOCAL_RANK=str(rank), OMPI_COMM_WORLD_LOCAL_SIZE=str(size),
               OMPI_MCA_orte_hnp_uri='1531576320.0;tcp://10.96.0.1,10.148.0.1:34911')
    env.update(kw)
    return env


def _clear_launchers(monkeypatch):
    for v in list(os.environ):
        if v.startswith(('SLURM_', 'OMPI_', 'PLK_COORD')) or v in (
                'RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'LOCAL_WORLD_SIZE', 'MASTER_ADDR',
                'MASTER_PORT'):
            monkeypatch.delenv(v)


def _jax_view(monkeypatch, environ):
    """What jax.distributed derives from `environ` for the JAX package: the first of jax's
    OpenMPI and SLURM clusters present, in jax's own order, and its (name, process id,
    process count, local process id, coordinator as a tcp:// url, an IPv6 host
    bracketed)."""
    _clear_launchers(monkeypatch)
    for k, v in environ.items():
        monkeypatch.setenv(k, v)
    cluster = next(c for c in ClusterEnv._cluster_types
                   if c in (OmpiCluster, SlurmCluster) and c.is_env_present())
    host, port = cluster.get_coordinator_address(None, None).rsplit(':', 1)
    url = 'tcp://%s:%s' % ('[%s]' % host if ':' in host else host, port)
    return (cluster.name, cluster.get_process_id(), cluster.get_process_count(),
            cluster.get_local_process_id(), url)


# PLK_COORD and torchrun have no counterpart in jax, and a one-task srun is no launch: their
# whole expectation is written here
HAND = {
    'none': ({}, LaunchEnv(None, 0, 1, 0, 1, None)),
    'explicit': (dict(PLK_COORD='host9:1234', PLK_NPROC='3', PLK_PROCID='2'),
                 LaunchEnv('explicit', 2, 3, 2, 3, 'tcp://host9:1234')),
    'torchrun': (_torchrun(1), LaunchEnv('torchrun', 1, 2, 1, 2, 'tcp://10.0.0.1:29500')),
    'torchrun_two_nodes': (_torchrun(5, 8, LOCAL_RANK='1', LOCAL_WORLD_SIZE='4'),
                           LaunchEnv('torchrun', 5, 8, 1, 4, 'tcp://10.0.0.1:29500')),
    'slurm_one_task': (_slurm(0, 1, '1'), LaunchEnv(None, 0, 1, 0, 1, None)),
}
# srun and mpirun: the rank, size, local rank and rendezvous are held to jax's SlurmCluster
# and OmpiCluster on the same environment (_jax_view); written here is only what jax does not
# derive: the local size, and the rendezvous where MASTER_ADDR/MASTER_PORT override it
DERIVED = {
    'slurm': (_slurm(2), 4, None),
    'slurm_ntasks_per_node': (
        {k: v for k, v in _slurm(1, 2, '2', SLURM_NTASKS_PER_NODE='2').items()
         if k != 'SLURM_STEP_TASKS_PER_NODE'}, 2, None),
    # sbatch -N1 --ntasks-per-node=8, then srun -n 4: the step runs 4 tasks on the node
    'slurm_step_tasks_per_node_first': (_slurm(3, 4, '4', SLURM_NTASKS_PER_NODE='8'), 4, None),
    'slurm_uneven_nodes': (_slurm(6, 7, '2(x3),1', SLURM_NODEID='3'), 1, None),
    'slurm_master_override': (_slurm(3, MASTER_ADDR='10.1.1.1', MASTER_PORT='4242'), 4,
                              'tcp://10.1.1.1:4242'),
    'openmpi': (_ompi(1), 2, None),
    'openmpi_tcp6': (_ompi(0, OMPI_MCA_orte_hnp_uri='1314521088.0;tcp6://[fe80::b9b:ac5d:9cf0:'
                                                    'b858,2620:10d:c083:150e::3000:2]:43370'),
                     2, None),
    'openmpi_master_override': (_ompi(0, MASTER_ADDR='10.1.1.1', MASTER_PORT='4242'), 2,
                                'tcp://10.1.1.1:4242'),
    # mpirun inside a SLURM allocation: the allocation's SLURM_PROCID is 0 on every rank
    'openmpi_inside_slurm': (dict(_ompi(1), **_slurm(0)), 2, None),
}
KINDS = {'slurm': 'slurm', 'ompi': 'openmpi'}


@pytest.mark.parametrize('name', sorted(HAND) + sorted(DERIVED))
def test_launch_env(name, monkeypatch):
    if name in HAND:
        environ, expected = HAND[name]
    else:
        environ, local_size, master = DERIVED[name]
        kind, rank, size, local_rank, url = _jax_view(monkeypatch, environ)
        expected = LaunchEnv(KINDS[kind], rank, size, local_rank, local_size, master or url)
    assert launch_env(environ) == expected


@pytest.mark.parametrize('node_list,host', [
    ('node001', 'node001'), ('node001,host2', 'node001'), ('node[001-015],host2', 'node001'),
    ('node[001,007-015]', 'node001'), ('127.0.0.1', '127.0.0.1')])
def test_slurm_first_host(node_list, host, monkeypatch):
    environ = _slurm(1, SLURM_STEP_NODELIST=node_list)
    assert slurm_first_host(node_list) == host
    assert launch_env(environ).init_method == _jax_view(monkeypatch, environ)[-1]


@pytest.mark.parametrize('spec,node,n', [('4', 0, 4), ('2(x3),1', 0, 2), ('2(x3),1', 2, 2),
                                         ('2(x3),1', 3, 1), ('3,1(x2)', 2, 1)])
def test_slurm_tasks_per_node(spec, node, n):
    assert slurm_tasks_per_node(spec, node) == n


@pytest.mark.parametrize('uri,addr', [
    ('1531576320.0;tcp://10.96.0.1,10.148.0.1,10.108.0.1:34911',
     ('10.96.0.1', 1531576320 // 4096 % 4096 + 61440)),
    ('1314521088.0;tcp6://[fe80::b9b:ac5d:9cf0:b858,2620:10d:c083:150e::3000:2]:43370',
     ('fe80::b9b:ac5d:9cf0:b858', 1314521088 // 4096 % 4096 + 61440)),
    ('1531576320.0;tcp://10.96.0.1:34911', ('10.96.0.1', 1531576320 // 4096 % 4096 + 61440))])
def test_ompi_coordinator(uri, addr, monkeypatch):
    environ = _ompi(0, OMPI_MCA_orte_hnp_uri=uri)
    host, port = addr
    url = _jax_view(monkeypatch, environ)[-1]
    assert ompi_coordinator(uri) == addr
    assert url == 'tcp://%s:%d' % ('[%s]' % host if ':' in host else host, port)
    assert launch_env(environ).init_method == url


def _node(envs, n_cards, seen, local_device_ids=None):
    """(devices, backend) of every rank of one node: rank r's environment envs[r], with
    seen[r] the uuids of the cards its process sees (in visible order)."""
    devices, cards = [], []
    for environ, uuids in zip(envs, seen):
        le = launch_env(environ)
        d = card_for(le.local_rank, le.local_size, n_cards, local_device_ids)
        devices.append(d)
        cards.append(('node001', uuids[int(d.split(':')[1])]))
    return devices, backend_for_cards(cards)


FOUR = ['GPU-a', 'GPU-b', 'GPU-c', 'GPU-d']
NODES = {
    'torchrun, 2 ranks, 2 cards': ([_torchrun(r) for r in range(2)], 2, [FOUR[:2]] * 2,
                                   None, ['cuda:0', 'cuda:1'], 'nccl'),
    'srun -n 4, a four-card node': ([_slurm(r) for r in range(4)], 4, [FOUR] * 4, None,
                                    ['cuda:0', 'cuda:1', 'cuda:2', 'cuda:3'], 'nccl'),
    'srun -n 4, one card bound to each task': ([_slurm(r) for r in range(4)], 1,
                                               [[u] for u in FOUR], None, ['cuda:0'] * 4,
                                               'nccl'),
    'srun -n 2, two tasks on one card': ([_slurm(r, 2, '2') for r in range(2)], 1,
                                         [FOUR[:1]] * 2, None, ['cuda:0'] * 2, 'gloo'),
    'srun -n 2 on a two-card node, bound to one card': (
        [_slurm(r, 2, '2') for r in range(2)], 2, [FOUR[:2]] * 2, [1], ['cuda:1'] * 2, 'gloo'),
    'mpirun -np 2, local_device_ids': ([_ompi(r) for r in range(2)], 4, [FOUR] * 2, [3],
                                       ['cuda:3'] * 2, 'gloo'),
    'mpirun -np 2, 2 cards': ([_ompi(r) for r in range(2)], 2, [FOUR[:2]] * 2, None,
                              ['cuda:0', 'cuda:1'], 'nccl'),
}


@pytest.mark.parametrize('name', sorted(NODES))
def test_cards_and_backend_of_a_node(name):
    envs, n_cards, seen, ids, devices, backend = NODES[name]
    assert _node(envs, n_cards, seen, ids) == (devices, backend)


def test_backend_for_cards():
    assert backend_for_cards([('h1', 'GPU-a'), ('h2', 'GPU-a')]) == 'nccl'   # other hosts
    assert backend_for_cards([('h1', 'GPU-a'), ('h1', 'GPU-a')]) == 'gloo'
    assert backend_for_cards([('h1', 'GPU-a'), ('h1', 'cpu')]) == 'gloo'
    assert backend_for_cards([['h1', 'GPU-a']]) == 'nccl'                   # json lists


@pytest.mark.parametrize('call,match', [
    (lambda: card_for(2, 4, 2), 'local rank 2 of 4 ranks .* sees 2 card'),
    (lambda: card_for(0, 1, 0), 'sees 0 card'),
    (lambda: card_for(0, 2, 2, local_device_ids=[2]), r'local_device_ids=\[2\]'),
    (lambda: card_for(0, 2, 2, local_device_ids=[]), r'local_device_ids=\[\]'),
    (lambda: launch_env({k: v for k, v in _slurm(0).items() if k != 'SLURM_STEP_NODELIST'}),
     'SLURM_STEP_NODELIST'),
    (lambda: launch_env({k: v for k, v in _slurm(0).items()
                         if k != 'SLURM_STEP_TASKS_PER_NODE'}), 'TASKS_PER_NODE'),
    (lambda: launch_env({k: v for k, v in _slurm(0).items() if k != 'SLURM_LOCALID'}),
     'slurm launch needs SLURM_LOCALID'),
    (lambda: launch_env({k: v for k, v in _ompi(0).items() if k != 'OMPI_MCA_orte_hnp_uri'}),
     'MASTER_ADDR'),
    (lambda: ompi_coordinator('12.0;ud://x'), 'cannot parse'),
    (lambda: slurm_tasks_per_node('2(3)'), 'cannot parse'),
    (lambda: slurm_tasks_per_node('2(x3),1', 4), 'node 4 of')])
def test_raising_cases(call, match):
    with pytest.raises((RuntimeError, ValueError), match=match):
        call()


def test_init_distributed_the_jax_way(monkeypatch):
    """The JAX package's positional signature (coordinator_address, num_processes,
    process_id, local_device_ids) without a launcher: a no-op (0, 1) on the card it
    resolves; without a card it raises unless device='cpu'."""
    _clear_launchers(monkeypatch)
    try:
        monkeypatch.setattr(torch.cuda, 'device_count', lambda: 4)
        assert pdist.init_distributed(None, None, None, [2]) == (0, 1)
        assert pdist.device() == torch.device('cuda:2')
        assert not torch.distributed.is_initialized()
        pdist.shutdown()
        assert pdist.init_distributed() == (0, 1) and pdist.device() == torch.device('cuda:0')
        pdist.shutdown()
        monkeypatch.setattr(torch.cuda, 'device_count', lambda: 0)
        with pytest.raises(RuntimeError, match="no CUDA card .* device='cpu'"):
            pdist.init_distributed()
        with pytest.raises(RuntimeError, match="no CUDA card"):
            pdist.init_single()
        assert pdist.init_distributed(device='cpu') == (0, 1)
        assert pdist.device() == torch.device('cpu')
    finally:
        pdist.shutdown()
    assert pdist.device() is None


def test_an_explicit_backend_wins(monkeypatch):
    """backend= names the backend where the resolver would pick NCCL but NCCL cannot run
    (a torch built without it): the ranks' cards are not consulted. Without it the choice is
    backend_for_cards' over the exchanged (host, card) pairs."""
    _clear_launchers(monkeypatch)
    seen = []
    monkeypatch.setattr(pdist, 'backend_for_cards', lambda cards: seen.append(cards) or 'nccl')
    try:
        assert pdist.init_single(device='cpu', backend='gloo') == (0, 1)
        assert torch.distributed.get_backend() == 'gloo' and seen == []
    finally:
        pdist.shutdown()
    monkeypatch.setattr(pdist, 'backend_for_cards', lambda cards: seen.append(cards) or 'gloo')
    try:
        assert pdist.init_single(device='cpu') == (0, 1)
        assert torch.distributed.get_backend() == 'gloo'
        assert [[tuple(c) for c in cards] for cards in seen] == [[pdist.card_id('cpu')]]
    finally:
        pdist.shutdown()


def test_make_mesh_without_a_card_raises(monkeypatch):
    from plancklens_tpu_torch.parallel.mesh import make_mesh
    _clear_launchers(monkeypatch)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 0)
    with pytest.raises(RuntimeError, match='no CUDA card'):
        make_mesh()
    assert not torch.distributed.is_initialized()


_WORKER = r"""
import json, os, sys
sys.path.insert(0, os.environ['PLK_REPO'])
import torch
from plancklens_tpu_torch.parallel import distributed as pdist
le = pdist.launch_env()
rank, size = pdist.init_distributed(device='cpu')
parts = [torch.zeros(1) for _ in range(size)]
torch.distributed.all_gather(parts, torch.tensor([10. * rank + 1.]))
pdist.barrier()
print('RESULT ' + json.dumps({'launch': list(le), 'init': [rank, size],
                               'backend': torch.distributed.get_backend(),
                               'gathered': [float(p) for p in parts],
                               'device': str(pdist.device())}), flush=True)
pdist.shutdown()
"""


def test_two_processes_under_a_slurm_shaped_environment():
    """`srun -n 2` on one node, as its environment reaches the ranks: no MASTER_ADDR,
    MASTER_PORT or PLK_COORD; the rendezvous is 127.0.0.1 at the port derived from the job
    id (one whose port is free). Both ranks join, exchange and exit within 120 s."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(('SLURM_', 'OMPI_', 'PLK_COORD'))
           and k not in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'LOCAL_WORLD_SIZE',
                         'MASTER_ADDR', 'MASTER_PORT')}
    job = pdist.free_slurm_job_id('127.0.0.1')
    env.update(SLURM_JOB_ID=str(job), SLURM_STEP_NODELIST='127.0.0.1', SLURM_NTASKS='2',
               SLURM_STEP_TASKS_PER_NODE='2', PLK_REPO=REPO, OMP_NUM_THREADS='1')
    procs = [subprocess.Popen([sys.executable, '-c', _WORKER],
                              env=dict(env, SLURM_PROCID=str(i), SLURM_LOCALID=str(i)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=120))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            pytest.fail('a SLURM-shaped rank timed out (both killed)')
    for i, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (out[-3000:], err[-3000:])
        res = json.loads([s for s in out.splitlines() if s.startswith('RESULT ')][-1][7:])
        assert res['launch'] == ['slurm', i, 2, i, 2, 'tcp://127.0.0.1:%d' % (job + 61440)]
        assert res['init'] == [i, 2] and res['backend'] == 'gloo' and res['device'] == 'cpu'
        assert res['gathered'] == [1., 11.]
