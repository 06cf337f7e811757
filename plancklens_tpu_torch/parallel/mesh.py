"""Device-mesh parallelism on torch.distributed (port of plancklens_tpu/parallel/mesh.py).

The reference's only distribution mechanism is MPI rank striding over simulation indices
with filesystem rendezvous (reference: plancklens/helpers/mpi.py, examples/run_qlms.py:57).
The JAX package shards global arrays over a jax Mesh. PyTorch has no GSPMD, so here every
process (one a GPU) holds its local shard and the collectives are explicit, over the
process groups of a ('sims', 'm') `torch.distributed.device_mesh.DeviceMesh`; no DTensor
touches the kernel paths, which take plain local tensors.

Axes:
  'sims' - data parallelism over simulation indices (the dominant axis, 300+ sims):
           `ShardedIVFS` filters a rank's block of a batch and all-gathers the batch;
  'm'    - intra-transform parallelism: `shard_sht` splits the Legendre phase of a
           transform over blocks of m columns and the ring FFTs over blocks of rings, with
           one all_to_all between the phases (the lmax >~ 4096 scaling axis).
The JAX package's `sims_sharding`/`maps_sharding` are GSPMD layout annotations with no
torch counterpart: a rank's block is `shard_batch` (sims) and `ShardedSHT.rings` (maps).
"""
import numpy as np
import torch

from . import distributed as _dist
from ..ops.sht.core import legendre_synth_pair, legendre_anal_pair
from ..ops.sht.transforms import _to_rings, _from_rings


def make_mesh(n_sims=None, n_m=1, *, device=None):
    """DeviceMesh over ('sims', 'm') of every rank of the process group (rank = i_sims *
    n_m + i_m). Defaults to all ranks on the sims axis. Without a process group (no
    launcher), a group of this process alone is created on `device` (default: the first
    card). The mesh's device type says where its backend runs collectives: the device's
    under NCCL, 'cpu' under gloo (whose CUDA tensors are staged through the host).
    Unlike the JAX package's make_mesh it takes no `devices`: torch.distributed orders
    the ranks of each axis group by rank, which the collectives here rely on."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        _dist.init_single(device)
    device = torch.device(_dist.device() if device is None else device)
    n = dist.get_world_size()
    if n_sims is None:
        n_sims = n // n_m
    if n_sims * n_m != n:
        raise ValueError('a (%d, %d) mesh of %d ranks' % (n_sims, n_m, n))
    mesh_type = device.type if dist.get_backend() == 'nccl' else 'cpu'
    return DeviceMesh(mesh_type, torch.arange(n).reshape(n_sims, n_m),
                      mesh_dim_names=('sims', 'm'))


def axis_size(mesh, name):
    return int(mesh.shape[mesh.mesh_dim_names.index(name)])


def axis_rank(mesh, name):
    return int(mesh.get_local_rank(name))


def axis_group(mesh, name):
    return mesh.get_group(name)


def shard_batch(mesh, arr):
    """This rank's block of the leading (sims) axis of `arr` (a tensor or numpy array);
    the axis must divide over the 'sims' ranks."""
    n, r = axis_size(mesh, 'sims'), axis_rank(mesh, 'sims')
    if len(arr) % n:
        raise ValueError('a batch of %d does not divide over %d sims ranks' % (len(arr), n))
    k = len(arr) // n
    return arr[r * k:(r + 1) * k]


def m_blocks(lmax, mmax, n):
    """[(m0, m1)] of n contiguous blocks of the columns 0..mmax, each starting at an even m
    (the pair kernels read the mirror sign's parity off the column index), balanced by the
    Legendre work sum_m (lmax - m + 1) of the block: equal blocks would give the first
    rank ~3/4 of the recursion at n = 2."""
    if mmax + 1 < 2 * n:
        raise ValueError('%d m columns cannot make %d blocks of even start' % (mmax + 1, n))
    cum = np.cumsum(lmax + 1. - np.arange(mmax + 1))
    bounds = [0]
    for k in range(1, n):
        target = cum[-1] * k / n
        b = int(np.searchsorted(cum, target)) + 1     # columns [0, b) first hold k/n
        # the even boundary nearest in work: columns [0, e) hold cum[e - 1]
        b = min((e for e in (b - b % 2, b + b % 2) if 0 < e <= mmax + 1),
                key=lambda e: abs(cum[e - 1] - target))
        top = mmax + 1 - 2 * (n - k)              # room for the blocks still to come
        bounds.append(min(max(b, bounds[-1] + 2), top - top % 2))
    bounds.append(mmax + 1)
    return list(zip(bounds[:-1], bounds[1:]))


def ring_blocks(nrings, n):
    """[(r0, r1)] of n contiguous blocks of rings, as equal as can be (the ring FFTs cost
    the same per ring)."""
    if nrings < n:
        raise ValueError('%d rings cannot make %d blocks' % (nrings, n))
    e = np.linspace(0, nrings, n + 1).round().astype(int)
    return list(zip(e[:-1].tolist(), e[1:].tolist()))


class ShardedSHT:
    """An SHT whose transforms run split over the 'm' axis of a mesh.

    Legendre phase: this rank runs the pair transforms (kernels K1/K2 on a CUDA device,
    their plain twins on the CPU) on its block of m columns, `m_blocks` of the geometry's
    band, with the recursion tables of those columns only. Longitude phase: this rank
    FFTs its block of rings, `ring_blocks`. One all_to_all over the 'm' group moves the
    (rings, m) grids from m-columns to ring blocks between the phases (synthesis), and the
    reverse (analysis). The caller passes and gets this rank's shards: alms whole (the
    rank's sims), maps as the rank's ring block (..., r1 - r0, nphi), `self.rings`. An
    analysis ends with an all_gather of the m-blocks, so its alms are whole on every rank.
    A split analysis may differ from the unsplit one by rounding (K2's ring-sum plan
    depends on the number of columns); a split synthesis computes every column as the
    unsplit call does."""

    def __init__(self, sht, mesh, log=print):
        self.sht, self.mesh = sht, mesh
        self.group = axis_group(mesh, 'm')
        n, r = axis_size(mesh, 'm'), axis_rank(mesh, 'm')
        self.m_split = m_blocks(sht.lmax, sht.mmax, n)
        self.ring_split = ring_blocks(sht.geom.nrings, n)
        self.m0, self.m1 = self.m_split[r]
        self.rings = slice(*self.ring_split[r])
        L = sht.lmax + 1
        work = [sum(L - m for m in range(a, b)) for a, b in self.m_split]
        if log is not None:
            log('shard_sht: lmax %d, %d rings, %d m-ranks; m-blocks %s (Legendre work %s); '
                'ring blocks %s; this rank m %d..%d, rings %d..%d'
                % (sht.lmax, sht.geom.nrings, n, self.m_split,
                   ['%.4f' % (w / sum(work)) for w in work], self.ring_split,
                   self.m0, self.m1 - 1, self.rings.start, self.rings.stop - 1))

    def __getattr__(self, name):
        if name.startswith('__') or name == 'sht':
            raise AttributeError(name)
        return getattr(self.sht, name)

    # ---------------------------------------------------------------- exchanges
    def _m_to_rings(self, F):
        """(B, nrings, this rank's m) -> (B, this rank's rings, mmax + 1)."""
        B = F.shape[0]
        nr = self.rings.stop - self.rings.start
        send = [F[:, r0:r1] for r0, r1 in self.ring_split]
        recv = _dist.all_to_all(send, [(B, nr, m1 - m0) for m0, m1 in self.m_split],
                                self.group)
        return torch.cat(recv, dim=-1)

    def _rings_to_m(self, G):
        """(B, this rank's rings, mmax + 1) -> (B, nrings, this rank's m)."""
        B = G.shape[0]
        send = [G[..., m0:m1] for m0, m1 in self.m_split]
        recv = _dist.all_to_all(send, [(B, r1 - r0, self.m1 - self.m0)
                                       for r0, r1 in self.ring_split], self.group)
        return torch.cat(recv, dim=1)

    def _gather_m(self, A):
        """(B, L, this rank's m) -> (B, L, mmax + 1), the m-blocks of every rank."""
        width = max(m1 - m0 for m0, m1 in self.m_split)
        pad = torch.nn.functional.pad(A, (0, width - A.shape[-1]))
        parts = _dist.all_gather_cat(pad[None], self.group).unbind(0)
        return torch.cat([p[..., :m1 - m0] for p, (m0, m1) in zip(parts, self.m_split)], -1)

    def _grid_block(self, alm):
        return self.sht._to_grid(alm)[..., self.m0:self.m1]

    def _weights(self):
        return self.sht._w[self.rings]

    # ---------------------------------------------------------------- spin 0
    def alm2map(self, tlm):
        """This rank's ring block of the real map of scalar alm (healpy convention)."""
        s = self.sht
        tlm = s._on_device(tlm)
        batch_shape = tlm.shape[:-1]
        A = (self._grid_block(tlm.reshape((-1, tlm.shape[-1]))) * s._fac).contiguous()
        Fp, _ = legendre_synth_pair(A, None, 0, s.geom.theta, grid_token=s._tok(), m0=self.m0)
        Fr = self._m_to_rings(Fp)
        f = _to_rings(Fr, torch.conj(Fr), s.geom.nphi, s.geom.phi0).real
        return f.reshape(batch_shape + f.shape[-2:])

    def map2alm(self, m):
        """Scalar alm (whole, on every rank) from this rank's ring block of real maps."""
        s = self.sht
        m = s._on_device(m)
        batch_shape = m.shape[:-2]
        mc = m.reshape((-1,) + m.shape[-2:]).to(s.cdtype)
        Gp, _ = _from_rings(mc, s.mmax, s.geom.phi0)
        Q = self._rings_to_m(Gp * self._weights()).contiguous()
        A, _ = legendre_anal_pair(Q, None, 0, s.geom.theta, s.lmax, grid_token=s._tok(),
                                  m0=self.m0)
        out = s._from_grid(self._gather_m(A * s._fac))
        return out.reshape(batch_shape + out.shape[-1:])

    # ---------------------------------------------------------------- spin s
    def alm2map_spin(self, gclm, spin):
        """(re, im) of this rank's ring block of _sf from (glm, clm); spin > 0."""
        assert spin > 0, spin
        s = self.sht
        glm, clm = gclm
        glm = s._on_device(glm)
        clm = s._on_device(clm).broadcast_to(glm.shape)
        batch_shape = glm.shape[:-1]
        G = self._grid_block(glm.reshape((-1, glm.shape[-1])))
        C = self._grid_block(clm.reshape((-1, clm.shape[-1])))
        Cp = (-(G + 1j * C) * s._fac).contiguous()
        Cm = (((-1.) ** spin) * torch.conj(-(G - 1j * C)) * s._fac).contiguous()
        Fp, Fm = legendre_synth_pair(Cp, Cm, spin, s.geom.theta, grid_token=s._tok(),
                                     m0=self.m0)
        Fp, Fm = self._m_to_rings(torch.cat([Fp, Fm])).chunk(2)
        f = _to_rings(Fp, Fm, s.geom.nphi, s.geom.phi0)
        f = f.reshape(batch_shape + f.shape[-2:])
        return f.real, f.imag

    def map2alm_spin(self, maps, spin):
        """(glm, clm), whole on every rank, from (re, im) of this rank's ring block of _sf;
        spin > 0."""
        assert spin > 0, spin
        s = self.sht
        m1, m2 = s._on_device(maps[0]), s._on_device(maps[1])
        batch_shape = m1.shape[:-2]
        mc = torch.complex(m1.to(s.dtype), m2.to(s.dtype)).reshape((-1,) + m1.shape[-2:])
        Gp, Gm = _from_rings(mc, s.mmax, s.geom.phi0)
        w = self._weights()
        Qp, Qm = self._rings_to_m(torch.cat([Gp * w, Gm * w])).chunk(2)
        A, Bc = legendre_anal_pair(Qp.contiguous(), Qm.contiguous(), spin, s.geom.theta,
                                   s.lmax, grid_token=s._tok(), m0=self.m0)
        AB = self._gather_m(torch.cat([A * s._fac, ((-1.) ** spin) * torch.conj(Bc) * s._fac]))
        A, B = AB.chunk(2)
        glm = s._from_grid(-0.5 * (A + B))
        clm = s._from_grid(0.5j * (A - B))
        return glm.reshape(batch_shape + glm.shape[-1:]), \
            clm.reshape(batch_shape + clm.shape[-1:])


def shard_sht(sht, mesh, log=print):
    """`sht` with its transforms split over the mesh's 'm' axis (ShardedSHT): the same
    alm2map/map2alm/alm2map_spin/map2alm_spin methods on this rank's shards. Prints the
    split through `log`."""
    return ShardedSHT(sht, mesh, log=log)


class ShardedIVFS:
    """ivfs adapter that splits a batch of filtered sims over the mesh's 'sims' ranks: its
    `get_sim_teblm_batch(idxs)` filters only this rank's block of `idxs` and all-gathers
    the batch, so it returns what the wrapped library returns (the driver's --mesh
    mechanism; role of the reference's `jobs[rank::size]` striding,
    examples/run_qlms.py:57). A batch that does not divide over the ranks is computed whole
    on each rank. Each batch call is a collective: every rank of the 'sims' group makes the
    same calls, with the same idxs, in the same order."""

    def __init__(self, ivfs, mesh):
        self._ivfs = ivfs
        self._mesh = mesh

    def __getattr__(self, name):
        # The batch accessor must only exist when the wrapped filter has one: drivers
        # probe `hasattr(ivfs, 'get_sim_teblm_batch')` to pick batch vs per-index paths
        # (examples/run_qlms_torch.py, models/qest.py), so a plain method here would
        # advertise a batch interface the inner library cannot serve (same contract as
        # IVFShuffle.__getattr__, models/filt.py).
        if name.startswith('__') or name in ('_ivfs', '_mesh'):
            raise AttributeError(name)
        if name == 'get_sim_teblm_batch':
            inner = getattr(self._ivfs, name)  # AttributeError propagates to hasattr
            return lambda idxs: self._sharded_batch(inner, idxs)
        return getattr(self._ivfs, name)

    def _sharded_batch(self, inner, idxs):
        idxs = np.atleast_1d(np.asarray(idxs))
        n, r = axis_size(self._mesh, 'sims'), axis_rank(self._mesh, 'sims')
        if len(idxs) % n:
            return inner(idxs)
        k = len(idxs) // n
        out = inner(idxs[r * k:(r + 1) * k])
        return tuple(_dist.all_gather_cat(x, axis_group(self._mesh, 'sims')) for x in out)

    def hashdict(self):
        return self._ivfs.hashdict()
