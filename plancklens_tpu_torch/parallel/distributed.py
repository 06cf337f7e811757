"""Multi-process distribution entry on torch.distributed (port of
plancklens_tpu/parallel/distributed.py).

The reference's cross-host backend is mpi4py, auto-enabled under srun/mpirun with
filesystem rendezvous and no-op single-process fallbacks (reference:
plancklens/helpers/mpi.py:12-55). The JAX package joins a `jax.distributed` coordinator,
which derives the coordinator, the rank and the local devices from the launcher's
environment, and shards global arrays; PyTorch has no GSPMD, so the port runs the torch
idiom instead: one process per GPU, each holding its local shard, with explicit
collectives over torch.distributed process groups (`mesh.py` builds a ('sims', 'm')
DeviceMesh of them). Exactly like the reference shim, everything degrades to
single-process no-ops when no launcher environment is detected, so the identical code
path runs serially.

`launch_env` reads the launcher from the environment alone (first match wins):
  * explicit:  PLK_COORD=host:port  PLK_NPROC=<n>  PLK_PROCID=<i>  (one host assumed: the
               local rank and size are the rank and size)
  * torchrun:  RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT
  * OpenMPI (mpirun): OMPI_COMM_WORLD_RANK / _SIZE / _LOCAL_RANK / _LOCAL_SIZE; the
               rendezvous host from OMPI_MCA_orte_hnp_uri, its port from the uri's job id
  * SLURM (srun): SLURM_PROCID, SLURM_NTASKS, SLURM_LOCALID, the local size from
               SLURM_STEP_TASKS_PER_NODE, else SLURM_NTASKS_PER_NODE; the rendezvous at the
               first host of SLURM_STEP_NODELIST, port SLURM_JOB_ID % 4096 + 61440
  * none:      single-process fallback (rank 0 of 1), nothing initialised
The derived rendezvous are the ones jax.distributed computes for the JAX package
(jax/_src/clusters/ompi_cluster.py, slurm_cluster.py); MASTER_ADDR and MASTER_PORT, when
set, win over them. OpenMPI comes before SLURM because mpirun inside a SLURM allocation
leaves the allocation's SLURM_PROCID (the same on every rank) in the environment.

The card (`card_for`): `local_device_ids[0]` when the caller gives it; else cuda:<local
rank> when the process sees at least as many cards as the node has ranks; else cuda:0 when
it sees one card (a launcher that binds one card a task, or several ranks on one card);
anything else raises. There is no CPU fallback: a process without a card runs on the CPU
only when the caller passes device='cpu'.

The backend (`backend_for_cards`): before the process group is made, the ranks exchange
(host name, card uuid) through the rendezvous store; NCCL when every rank holds a card of
its own, gloo when two ranks of a host hold the same card (NCCL refuses them) or a rank is
on the CPU. Under gloo the collectives below stage CUDA tensors through host buffers,
because gloo runs no CUDA all_to_all/all_gather. An explicit `backend=` wins: 'gloo' where
the resolver would pick NCCL but NCCL cannot run (a torch built without it, a fabric it
does not reach).
"""
import json
import os
import random
import re
import socket
from collections import namedtuple

import numpy as np
import torch
import torch.distributed as dist

_state = {'initialized': False, 'rank': 0, 'size': 1, 'backend': None, 'device': None}

LaunchEnv = namedtuple('LaunchEnv', 'kind rank size local_rank local_size init_method')
LaunchEnv.__doc__ = ("A launcher's view of this process: `kind` ('explicit', 'torchrun', "
                     "'openmpi', 'slurm', or None without a launcher), the global and local "
                     "rank and size, and the tcp:// rendezvous (None without a launcher).")


def free_port():
    """A free TCP port on localhost (for a single-host rendezvous)."""
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def free_slurm_job_id(host='127.0.0.1'):
    """A SLURM_JOB_ID whose derived rendezvous port (job id % 4096 + 61440) is free on
    `host`, for a SLURM-shaped launch on one host (the tests, chip_smoke.py's phase 11d)."""
    start = random.randrange(4096)
    for k in range(4096):
        job = (start + k) % 4096
        with socket.socket() as s:
            try:
                s.bind((host, job + 61440))
            except OSError:
                continue
        return job
    raise RuntimeError('no free port in 61440..65535 on %s' % host)


def _tcp(host, port):
    """tcp:// url of host:port (an IPv6 host in brackets)."""
    return 'tcp://%s:%d' % ('[%s]' % host if ':' in host else host, int(port))


def _coordinator_url(address):
    """tcp:// url of a host:port coordinator address (passed through if it has a scheme)."""
    return address if '://' in address else 'tcp://' + address


def slurm_first_host(node_list):
    """The first host of a SLURM node list: 'node001', 'node001,host2', 'node[001-015],host2'
    and 'node[001,007-015]' give 'node001' (the rule of jax's slurm_cluster.py)."""
    m = re.match(r'([^,\[]*)(?:\[([^,\-\]]*))?', node_list)
    return m.group(1) + (m.group(2) or '')


def slurm_tasks_per_node(spec, node=0):
    """Tasks on node `node` of a SLURM tasks-per-node spec: '4', '2(x3),1' (nodes 0-2 run
    2 tasks, node 3 runs 1)."""
    counts = []
    for part in spec.split(','):
        m = re.fullmatch(r'\s*(\d+)(?:\(x(\d+)\))?\s*', part)
        if m is None:
            raise ValueError('cannot parse the SLURM tasks per node %r' % spec)
        counts += [int(m.group(1))] * int(m.group(2) or 1)
    if not 0 <= node < len(counts):
        raise ValueError('node %d of the SLURM tasks per node %r' % (node, spec))
    return counts[node]


def ompi_coordinator(uri):
    """(host, port) of the rendezvous derived from OMPI_MCA_orte_hnp_uri, e.g.
    '1531576320.0;tcp://10.96.0.1,10.148.0.1:34911' or
    '1314521088.0;tcp6://[fe80::b9b:ac5d:9cf0:b858,2620:10d:c083:150e::3000:2]:43370':
    the launcher's first address, and port job id / 4096 % 4096 + 61440 (the rule of jax's
    ompi_cluster.py)."""
    m = re.search(r'tcp://(.+?)[,:]|tcp6://\[(.+?)[,\]]', uri)
    if m is None:
        raise RuntimeError('cannot parse the launcher address of OMPI_MCA_orte_hnp_uri=%r'
                           % uri)
    job_id = int(uri.split('.', 1)[0]) // 4096
    return next(g for g in m.groups() if g is not None), job_id % 4096 + 61440


def launch_env(environ=os.environ):
    """The launcher's view of this process (module docstring), read from the environment
    mapping `environ` alone; a LaunchEnv."""
    def num(name, default=None):
        if name not in environ:
            if default is None:
                raise RuntimeError('the %s launch needs %s in the environment' % (kind, name))
            return default
        return int(environ[name])

    master = ('MASTER_ADDR' in environ and 'MASTER_PORT' in environ
              and _tcp(environ['MASTER_ADDR'], environ['MASTER_PORT']))
    kind = 'explicit'
    if 'PLK_COORD' in environ:
        rank, size = num('PLK_PROCID'), num('PLK_NPROC')
        return LaunchEnv(kind, rank, size, rank, size, _coordinator_url(environ['PLK_COORD']))
    kind = 'torchrun'
    if master and 'RANK' in environ and 'WORLD_SIZE' in environ:
        rank, size = num('RANK'), num('WORLD_SIZE')
        return LaunchEnv(kind, rank, size, num('LOCAL_RANK', rank),
                         num('LOCAL_WORLD_SIZE', size), master)
    kind = 'openmpi'
    if num('OMPI_COMM_WORLD_SIZE', 1) > 1:
        if not master:
            if 'OMPI_MCA_orte_hnp_uri' not in environ:
                raise RuntimeError('an OpenMPI launch without OMPI_MCA_orte_hnp_uri needs '
                                   'MASTER_ADDR and MASTER_PORT')
            master = _tcp(*ompi_coordinator(environ['OMPI_MCA_orte_hnp_uri']))
        return LaunchEnv(kind, num('OMPI_COMM_WORLD_RANK'), num('OMPI_COMM_WORLD_SIZE'),
                         num('OMPI_COMM_WORLD_LOCAL_RANK'), num('OMPI_COMM_WORLD_LOCAL_SIZE'),
                         master)
    kind = 'slurm'
    if num('SLURM_NTASKS', 1) > 1:
        # the step's own layout first: srun sets it, while SLURM_NTASKS_PER_NODE may be the
        # allocation's (sbatch --ntasks-per-node=8, then srun -n 4 runs 4 tasks a node)
        if 'SLURM_STEP_TASKS_PER_NODE' in environ:
            local_size = slurm_tasks_per_node(environ['SLURM_STEP_TASKS_PER_NODE'],
                                              num('SLURM_NODEID', 0))
        elif 'SLURM_NTASKS_PER_NODE' in environ:
            local_size = slurm_tasks_per_node(environ['SLURM_NTASKS_PER_NODE'])
        else:
            raise RuntimeError('a SLURM launch needs SLURM_STEP_TASKS_PER_NODE or '
                               'SLURM_NTASKS_PER_NODE in the environment')
        if not master:
            if 'SLURM_STEP_NODELIST' not in environ:
                raise RuntimeError('a SLURM launch without SLURM_STEP_NODELIST needs '
                                   'MASTER_ADDR and MASTER_PORT')
            master = _tcp(slurm_first_host(environ['SLURM_STEP_NODELIST']),
                          num('SLURM_JOB_ID') % 4096 + 61440)
        return LaunchEnv(kind, num('SLURM_PROCID'), num('SLURM_NTASKS'), num('SLURM_LOCALID'),
                         local_size, master)
    return LaunchEnv(None, 0, 1, 0, 1, None)


def card_for(local_rank, local_size, n_cards, local_device_ids=None):
    """'cuda:<i>', the card of local rank `local_rank` of `local_size` ranks on a host whose
    process sees `n_cards` cards (module docstring); raises where no rule applies."""
    if local_device_ids is not None:
        ids = list(local_device_ids)
        if not ids or not 0 <= int(ids[0]) < n_cards:
            raise RuntimeError('local_device_ids=%s, but this process sees %d card(s)'
                               % (ids, n_cards))
        return 'cuda:%d' % int(ids[0])
    if n_cards >= local_size and local_rank < n_cards:
        return 'cuda:%d' % local_rank
    if n_cards == 1:
        return 'cuda:0'
    raise RuntimeError('local rank %d of %d ranks on this host, and this process sees %d '
                       'card(s): pass local_device_ids or device=' % (local_rank, local_size,
                                                                      n_cards))


def card_id(device):
    """(host name, uuid of the card) of `device`; (host name, 'cpu') for the CPU."""
    device = torch.device(device)
    if device.type != 'cuda':
        return socket.gethostname(), 'cpu'
    index = torch.cuda.current_device() if device.index is None else device.index
    return socket.gethostname(), str(torch.cuda.get_device_properties(index).uuid)


def backend_for_cards(cards):
    """'nccl' when the ranks' (host, uuid) pairs `cards` are all distinct cards, 'gloo'
    when two ranks of a host share a card or a rank is on the CPU."""
    cards = [tuple(c) for c in cards]
    if any(uuid == 'cpu' for _, uuid in cards) or len(set(cards)) < len(cards):
        return 'gloo'
    return 'nccl'


def init_distributed(coordinator_address=None, num_processes=None, process_id=None,
                     local_device_ids=None, *, device=None, backend=None):
    """Join (or create) the process group of a multi-process run; returns (rank, size).

    With explicit arguments this connects to the tcp:// rendezvous at
    `coordinator_address` (host:port) as rank `process_id` of `num_processes` (one host:
    the local rank is `process_id`); otherwise it reads the launcher from the environment
    (`launch_env`), and without a launcher it is a single-process no-op returning (0, 1),
    the reference's `mpi.py:17` fallback. `device` defaults to this rank's card
    (`card_for`, with `local_device_ids` as the JAX package takes them); without a card and
    without device='cpu' it raises. The backend follows the ranks' cards
    (`backend_for_cards`) unless `backend` names one."""
    if _state['initialized']:
        return _state['rank'], _state['size']
    if coordinator_address is not None:
        rank, size = int(process_id), int(num_processes)
        env = LaunchEnv('explicit', rank, size, rank, size,
                        _coordinator_url(coordinator_address))
    else:
        env = launch_env()
    if device is None:
        n_cards = torch.cuda.device_count()
        if n_cards == 0:
            raise RuntimeError('no CUDA card is visible to this process: pass device=\'cpu\' '
                               'to run on the CPU')
        device = card_for(env.local_rank, env.local_size, n_cards, local_device_ids)
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    if env.kind is None:
        _state['device'] = device
        return 0, 1   # single process: nothing to initialise
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    store, rank, size = next(dist.rendezvous(env.init_method, env.rank, env.size))
    store.set('plancklens/card/%d' % rank, json.dumps(card_id(device)))
    cards = [json.loads(store.get('plancklens/card/%d' % r)) for r in range(size)]
    backend = backend or backend_for_cards(cards)
    dist.init_process_group(backend, store=store, rank=rank, world_size=size)
    _state.update(initialized=True, rank=dist.get_rank(), size=dist.get_world_size(),
                  backend=backend, device=device)
    return _state['rank'], _state['size']


def init_single(device=None, backend=None):
    """A process group of this process alone (world size 1) on `device` (default: the
    first card), so that the mesh code runs unchanged without a launcher; returns (0, 1)."""
    return init_distributed('127.0.0.1:%d' % free_port(), 1, 0, device=device,
                            backend=backend)


def shutdown():
    """Destroy the process group this module created, if any, and forget the device."""
    if _state['initialized']:
        dist.destroy_process_group()
    _state.update(initialized=False, rank=0, size=1, backend=None, device=None)


def device():
    """This process's device as `init_distributed` resolved it (None before it)."""
    return _state['device']


def rank():
    return _state['rank']


def size():
    return _state['size']


def barrier(name='plk_barrier'):
    """Cross-process synchronisation point (reference mpi.barrier role); no-op when
    single-process. `name` is kept for the JAX package's signature."""
    if not _state['initialized']:
        return
    if _state['backend'] == 'nccl':
        dist.barrier(device_ids=[_state['device'].index])
    else:
        dist.barrier()


def local_jobs(jobs):
    """This process's share of a job list: the reference's `jobs[rank::size]` striding
    (reference: examples/run_qlms.py:57) against the distributed rank."""
    return list(jobs)[_state['rank']::_state['size']]


def global_mesh(n_m=1):
    """('sims', 'm') DeviceMesh over every process of the run (n_sims = size / n_m)."""
    from .mesh import make_mesh
    return make_mesh(n_sims=_state['size'] // n_m, n_m=n_m)


def host_array_to_global(arr, mesh):
    """The full batch along the 'sims' axis, all-gathered from every rank's local block
    `arr` (a tensor, or a numpy array, returned as numpy): the in-memory replacement for
    the reference's per-rank FITS writes. Ranks along 'm' hold the same block."""
    from .mesh import axis_group
    if isinstance(arr, torch.Tensor):
        return all_gather_cat(arr, axis_group(mesh, 'sims'))
    dev = _state['device'] if _state['backend'] == 'nccl' else torch.device('cpu')
    t = torch.as_tensor(np.ascontiguousarray(arr), device=dev)
    return all_gather_cat(t, axis_group(mesh, 'sims')).cpu().numpy()


# ------------------------------------------------------------------ staged collectives
def _staged(t, group):
    """(the tensor the collective takes, the device to bring the result back to). gloo runs
    no CUDA collectives: under gloo a CUDA tensor goes through a host buffer, explicitly.
    NCCL takes CUDA tensors only, so a CPU tensor under NCCL raises."""
    backend = dist.get_backend(group)
    if t.is_cuda and backend == 'gloo':
        return t.cpu(), t.device
    if not t.is_cuda and backend == 'nccl':
        raise ValueError('a CPU tensor in an NCCL collective: pass tensors on the card')
    return t, None


def _as_real(t):
    return torch.view_as_real(t.contiguous()) if t.is_complex() else t.contiguous()


def all_gather_cat(x, group, dim=0):
    """Concatenation along `dim` of `x` from every rank of `group`, in rank order (every
    rank passes the same shape)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    xr, home = _staged(_as_real(x), group)
    parts = [torch.empty_like(xr) for _ in range(n)]
    dist.all_gather(parts, xr, group=group)
    out = torch.cat(parts, dim=dim)
    if home is not None:
        out = out.to(home)
    return torch.view_as_complex(out) if x.is_complex() else out


def all_to_all(send, recv_shapes, group):
    """Block exchange: `send[j]` goes to rank j of `group`; returns the blocks received
    from each rank i, shaped `recv_shapes[i]` (one all_to_all_single over flat buffers).
    All blocks share a dtype; complex blocks travel as their real views."""
    if dist.get_world_size(group) == 1:
        return [send[0].reshape(recv_shapes[0])]
    cplx = send[0].is_complex()
    flat = [_as_real(x).reshape(-1) for x in send]
    in_splits = [f.numel() for f in flat]
    out_splits = [int(np.prod(s)) * (2 if cplx else 1) for s in recv_shapes]
    x, home = _staged(torch.cat(flat), group)
    y = torch.empty(sum(out_splits), dtype=x.dtype, device=x.device)
    dist.all_to_all_single(y, x, out_splits, in_splits, group=group)
    if home is not None:
        y = y.to(home)
    out = []
    for c, s in zip(y.split(out_splits), recv_shapes):
        c = c.reshape(tuple(s) + ((2,) if cplx else ()))
        out.append(torch.view_as_complex(c) if cplx else c)
    return out
