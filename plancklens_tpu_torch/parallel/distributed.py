"""Multi-process distribution entry on torch.distributed (port of
plancklens_tpu/parallel/distributed.py).

The reference's cross-host backend is mpi4py, auto-enabled under srun/mpirun with
filesystem rendezvous and no-op single-process fallbacks (reference:
plancklens/helpers/mpi.py:12-55). The JAX package joins a `jax.distributed` coordinator and
shards global arrays; PyTorch has no GSPMD, so the port runs the torch idiom instead: one
process per GPU, each holding its local shard, with explicit collectives over
torch.distributed process groups (`mesh.py` builds a ('sims', 'm') DeviceMesh of them).
Exactly like the reference shim, everything degrades to single-process no-ops when no
launcher environment is detected, so the identical code path runs serially.

Launcher environments recognised (first match wins):
  * explicit:  PLK_COORD=host:port  PLK_NPROC=<n>  PLK_PROCID=<i>  (a tcp:// init)
  * torchrun:  RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT  (an env:// init)
  * SLURM / OpenMPI: SLURM_NTASKS / OMPI_COMM_WORLD_SIZE > 1, with the rank from
    SLURM_PROCID / OMPI_COMM_WORLD_RANK and MASTER_ADDR / MASTER_PORT set by the job
  * none: single-process fallback (rank 0 of 1), nothing initialised

The backend follows the device the caller names: 'nccl' for a CUDA device, 'gloo' for the
CPU. It is an argument, never switched silently: gloo on a CUDA device is allowed when
asked for (two ranks sharing one card, which NCCL refuses), and then the collectives below
stage CUDA tensors through host buffers, because gloo runs no CUDA all_to_all/all_gather.
"""
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

_state = {'initialized': False, 'rank': 0, 'size': 1, 'backend': None, 'device': None}


def backend_for(device):
    """'nccl' for a CUDA device, 'gloo' for the CPU."""
    return 'nccl' if torch.device(device).type == 'cuda' else 'gloo'


def free_port():
    """A free TCP port on localhost (for a single-host rendezvous)."""
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _env_int(*names):
    for v in names:
        if v in os.environ:
            try:
                return int(os.environ[v])
            except ValueError:
                pass
    return None


def init_distributed(device, coordinator_address=None, num_processes=None, process_id=None,
                     backend=None):
    """Join (or create) the process group of a multi-process run; returns (rank, size).

    `device` is this process's device ('cuda:<i>' or 'cpu'); it picks the backend unless
    `backend` names one. With explicit arguments or a PLK_COORD-style environment this
    connects to the tcp:// rendezvous at `coordinator_address` (host:port); under torchrun
    or a recognised cluster launcher it reads the launcher's environment; otherwise it is a
    single-process no-op returning (0, 1), the reference's `mpi.py:17` fallback."""
    device = torch.device(device)
    if _state['initialized']:
        return _state['rank'], _state['size']
    init_method = None
    if coordinator_address is None and 'PLK_COORD' in os.environ:
        coordinator_address = os.environ['PLK_COORD']
        num_processes = int(os.environ['PLK_NPROC'])
        process_id = int(os.environ['PLK_PROCID'])
    if coordinator_address is not None:
        init_method = coordinator_address if '://' in coordinator_address \
            else 'tcp://' + coordinator_address
        rank, size = int(process_id), int(num_processes)
    elif all(v in os.environ for v in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT')):
        init_method = 'env://'
        rank, size = int(os.environ['RANK']), int(os.environ['WORLD_SIZE'])
    elif (_env_int('SLURM_NTASKS', 'OMPI_COMM_WORLD_SIZE') or 1) > 1:
        if not all(v in os.environ for v in ('MASTER_ADDR', 'MASTER_PORT')):
            raise RuntimeError('a SLURM/OpenMPI run needs MASTER_ADDR and MASTER_PORT (or '
                               'PLK_COORD) for the torch.distributed rendezvous')
        init_method = 'env://'
        size = _env_int('SLURM_NTASKS', 'OMPI_COMM_WORLD_SIZE')
        rank = _env_int('SLURM_PROCID', 'OMPI_COMM_WORLD_RANK')
    else:
        return 0, 1   # single process: nothing to initialise
    backend = backend or backend_for(device)
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=size)
    _state.update(initialized=True, rank=dist.get_rank(), size=dist.get_world_size(),
                  backend=backend, device=device)
    return _state['rank'], _state['size']


def init_single(device, backend=None):
    """A process group of this process alone (world size 1) on `device`, so that the
    mesh code runs unchanged without a launcher; returns (0, 1)."""
    return init_distributed(device, '127.0.0.1:%d' % free_port(), 1, 0, backend=backend)


def shutdown():
    """Destroy the process group this module created (no-op otherwise)."""
    if _state['initialized']:
        dist.destroy_process_group()
        _state.update(initialized=False, rank=0, size=1, backend=None, device=None)


def device():
    """The device named to `init_distributed` (None before it)."""
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
