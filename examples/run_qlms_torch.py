#!/usr/bin/env python
r"""Staged batch pipeline driver of the PyTorch port (reference analogue:
examples/run_qlms.py, itself after plancklens' examples/run_qlms.py):

    python examples/run_qlms_torch.py params/idealized_example_torch.py --device cuda \
        -imin 0 -imax 7 -k ptt p_p --stages filt,qe,mf
    python examples/run_qlms_torch.py params/idealized_example_torch.py --device cuda \
        -imin 4 -imax 7 -k ptt p_p --stages qcl

Stages: filt (filtered alms), qe (batched QEs), mf (split-half mean fields of
mc_sims_mf_dd), xin (cross-spectra of the QEs with the input potentials, when the parfile
has qlms_x_in), qcl (MF-subtracted dd/ds/ss spectra), nhl (semi-analytic N0 of the first
sim, when the parfile has nhl_dd). Sims inside the mean-field set make the qcl stage raise
(the reference's MF-containment guard): run it on the parfile's mc_sims_var. Each stage's time is measured with CUDA events on a CUDA device and with
the host clock otherwise. The stage functions are importable (chip_smoke.py drives them).

Tracing: `--trace run_trace.json` turns on the port's tracer (plancklens_tpu_torch/
utils/trace.py) and writes its records, counters and summary there at exit. Each stage is
a span stage.<name> (sims: first index and count) holding the spans of its layers:
filt.ivf (a filtering), cg.solve / cg.iter / cg.stop (a C^-1 solve, an iteration, the
host's read of the stop flag), qe.eval / qe.leg / qe.out (a QE, its legs, its output
analysis), copy.to_host / copy.to_device (a cacher's copy, with its bytes and device
seconds), sht.legendre (a Legendre call, with its shape) and sht.recursion_tables (a
table build); the counters are cg.iters, cg.row_iters and cg.frozen_row_iters (a batch of
sims solved together, each frozen at its own convergence: the sims' own iterations summed,
and those computed for sims already frozen), copy.to_host_bytes, copy.to_device_bytes,
copy.kept_on_device_bytes (qlms a memory cacher kept on the device, with no copy),
sht.tables_hit and sht.tables_miss. The summary gives each span's calls and host seconds
(and device seconds of the copies): a run's stage, solve, QE and copy seconds. Tracing
does not synchronise the device; under torch.profiler the spans are ranges of its trace.

Several processes (--mesh, as examples/run_qlms.py's; one process a GPU):

    torchrun --nproc_per_node N examples/run_qlms_torch.py <parfile> --mesh ...

joins the ranks over torch.distributed and puts the filtered batches of par.ivfs and of the
QE libraries' ivfs1/ivfs2 behind parallel.mesh.ShardedIVFS: every rank runs every stage on
the same sims, and each batched filtering inside a stage is split over the ranks and
all-gathered. Those batch calls are collectives, and the QE libraries skip them for
products their cache already holds, so no stage runs on a rank's own share of the sims
(the ranks' caches would then differ, and one rank would wait in a call the other skips);
what follows the filter is computed on every rank. `srun -n N` and `mpirun -np N` start
the same ranks without torchrun and without MASTER_ADDR/MASTER_PORT: the rendezvous, the
rank and the card come from the launcher's environment (setup_mesh). The backend is NCCL
when each rank holds a card of its own, and gloo, with its collectives staged through the
host, on the CPU or when ranks share a card. Without a launcher --mesh runs one rank.
"""
import argparse
import importlib.util
import os
import sys
import time

# runnable from a source checkout without installation (parfiles import the packages)
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

import numpy as np
import torch

from plancklens_tpu_torch.utils import trace


def load_parfile(path, device=None, **inject):
    """Import a parameter file; `device` sets PLK_DEVICE for it first, and `inject` sets
    names in its namespace before it runs (e.g. the dense_cacher of
    params/anisofilt_example_torch.py)."""
    if device is not None:
        os.environ['PLK_DEVICE'] = str(device)
    spec = importlib.util.spec_from_file_location('parfile_torch', path)
    mod = importlib.util.module_from_spec(spec)
    mod.__dict__.update(inject)
    spec.loader.exec_module(mod)
    return mod


class StageTimer:
    """Seconds of a stage: CUDA events on a CUDA device (synchronised at the end), the
    host clock otherwise. A `name` makes the stage the tracer's span of that name (attr
    sims: the first of `idxs` and their count)."""

    def __init__(self, device, name=None, idxs=()):
        self.cuda = torch.device(device).type == 'cuda'
        self._span = trace.NOOP if name is None else trace.span(name, sims=trace.sims(idxs))

    def __enter__(self):
        self._span.__enter__()
        if self.cuda:
            self._e0 = torch.cuda.Event(enable_timing=True)
            self._e1 = torch.cuda.Event(enable_timing=True)
            self._e0.record()
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self._e1.record()
            self._e1.synchronize()
            self.seconds = self._e0.elapsed_time(self._e1) / 1e3
        else:
            self.seconds = time.perf_counter() - self._t0
        self._span.__exit__(*exc)
        return False


def stage_filt(par, idxs):
    """Filtered (t, e, b) alm batches of sims idxs, through the filter's batch accessor
    where it has one (the masked IVFCinv -> IVFFtl chain: one T and one P solve over the
    uncached sims, each frozen at its own convergence); a filter with only the per-index
    interface is called sim by sim."""
    with StageTimer(par.DEVICE, 'stage.filt', idxs) as t:
        if hasattr(par.ivfs, 'get_sim_teblm_batch'):
            out = par.ivfs.get_sim_teblm_batch(idxs)
        else:
            out = tuple(torch.stack([getattr(par.ivfs, 'get_sim_%slm' % f)(int(i))
                                     for i in idxs]) for f in 'teb')
    return out, t.seconds


def stage_qe(par, keys, idxs):
    """{key: (nsims, nalm) qlm batch} of qlms_dd."""
    out = {}
    with StageTimer(par.DEVICE, 'stage.qe', idxs) as t:
        for k in keys:
            out[k] = par.qlms_dd.get_sim_qlm_batch(k, idxs)
    return out, t.seconds


def stage_mf(par, keys):
    """{key: [mean field of each non-empty half of mc_sims_mf_dd]}."""
    out = {}
    halves = [h for h in (par.mc_sims_mf_dd[0::2], par.mc_sims_mf_dd[1::2]) if len(h)]
    with StageTimer(par.DEVICE, 'stage.mf', par.mc_sims_mf_dd) as t:
        for k in keys:
            out[k] = [par.qlms_dd.get_sim_qlm_mf(k, h) for h in halves]
    return out, t.seconds


def stage_qcl(par, keys, idxs):
    """{(key, 'dd'|'ds'|'ss'): (nsims, lmax_qlm+1) spectra}; raises for sims in the MF set."""
    out = {}
    with StageTimer(par.DEVICE, 'stage.qcl', idxs) as t:
        for k in keys:
            for lib, name in [(par.qcls_dd, 'dd'), (par.qcls_ds, 'ds'), (par.qcls_ss, 'ss')]:
                out[(k, name)] = lib.get_sim_qcl_batch(k, idxs)
    return out, t.seconds


def stage_xin(par, keys, idxs):
    """{key: (nsims, lmax_qlm+1) cross-spectra of qlms_dd with the input potentials}."""
    out = {}
    with StageTimer(par.DEVICE, 'stage.xin', idxs) as t:
        for k in keys:
            out[k] = np.stack([par.qlms_x_in.get_sim_qcl(k, int(i)) for i in idxs])
    return out, t.seconds


def stage_nhl(par, keys, idx):
    """{key: semi-analytic unnormalised N0 of sim idx}."""
    out = {}
    with StageTimer(par.DEVICE, 'stage.nhl', idx) as t:
        for k in keys:
            out[k] = par.nhl_dd.get_sim_nhl(int(idx), k, k)
    return out, t.seconds


def setup_mesh(device):
    """Join the ranks of a torch.distributed run (one rank without a launcher) on `device`.
    The launcher is read from the environment alone (torchrun, srun or mpirun; no
    MASTER_ADDR/MASTER_PORT needed): parallel.distributed.launch_env. A bare 'cuda' takes
    this rank's card (parallel.distributed.card_for: cuda:<local rank> when the process
    sees every card of its node, cuda:0 when it sees one), and the backend is NCCL when
    every rank holds a card of its own and gloo when ranks share a card (NCCL refuses
    them) or run on the CPU. Returns (device, a '[rank r/n] ' tag for its lines); the mesh
    is all ranks on 'sims'."""
    from plancklens_tpu_torch.parallel import distributed as pdist
    asked = None if device.type == 'cuda' and device.index is None else device
    rank, size = pdist.init_distributed(device=asked)
    if size == 1:
        pdist.init_single(asked)
    device, backend = pdist.device(), torch.distributed.get_backend()
    print('[rank %d/%d] mesh (sims %d, m 1) on %s, backend %s'
          % (rank, size, size, device, backend))
    return device, '[rank %d/%d] ' % (rank, size)


def wrap_mesh(par):
    """Put par.ivfs and the QE libraries' ivfs1/ivfs2 behind ShardedIVFS on a mesh of
    every rank on 'sims' (one wrapper per filter object, as examples/run_qlms.py:58-75)."""
    from plancklens_tpu_torch.parallel import make_mesh, ShardedIVFS
    mesh = make_mesh()
    wrapped = {}

    def _wrap(ivfs):
        if id(ivfs) not in wrapped:
            wrapped[id(ivfs)] = ShardedIVFS(ivfs, mesh)
        return wrapped[id(ivfs)]

    par.ivfs = _wrap(par.ivfs)
    for lib in (par.qlms_dd, getattr(par, 'qlms_ds', None), getattr(par, 'qlms_ss', None)):
        if lib is not None:
            lib.ivfs1 = _wrap(lib.ivfs1)
            lib.ivfs2 = _wrap(lib.ivfs2)
    return mesh


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('parfile', help='parameter file (python module path)')
    p.add_argument('-imin', type=int, default=0)
    p.add_argument('-imax', type=int, default=15)
    p.add_argument('-k', dest='keys', nargs='+', default=['ptt'], help='QE keys to compute')
    p.add_argument('--stages', default='filt,qe,mf',
                   help='comma list of: filt, qe, mf, xin, qcl, nhl')
    p.add_argument('--device', default='cuda',
                   help="torch device (default 'cuda'; 'cpu' runs the plain torch path)")
    p.add_argument('--mesh', action='store_true',
                   help='split the sims over the ranks of a torch.distributed run')
    p.add_argument('--trace', default=None, metavar='PATH',
                   help="turn the port's tracer on and write its spans, counters and "
                        "summary as JSON to PATH at exit")
    args = p.parse_args()
    if args.trace:
        trace.enable()
        try:
            run(p, args)
        finally:
            trace.dump(args.trace)
    else:
        run(p, args)


def run(p, args):
    """The stages `args` name, on the parfile's libraries."""
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        p.error("no CUDA device is available for --device %s; pass --device cpu to run "
                "on the CPU" % args.device)
    idxs = np.arange(args.imin, args.imax + 1)
    tag = ''
    if args.mesh:
        device, tag = setup_mesh(device)
    par = load_parfile(args.parfile, device)
    if args.mesh:
        wrap_mesh(par)
    stages = args.stages.split(',')
    if 'filt' in stages:
        _, s = stage_filt(par, idxs)
        print('%s[filt] %d sims filtered in %.3fs' % (tag, len(idxs), s))
    if 'qe' in stages:
        _, s = stage_qe(par, args.keys, idxs)
        print('%s[qe]   %s: %d sims in %.3fs' % (tag, ','.join(args.keys), len(idxs), s))
    if 'mf' in stages:
        _, s = stage_mf(par, args.keys)
        print('%s[mf]   %s: split-half mean fields in %.3fs' % (tag, ','.join(args.keys), s))
    if 'xin' in stages and hasattr(par, 'qlms_x_in'):
        _, s = stage_xin(par, args.keys, idxs)
        print('%s[xin]  %s: %d crosses with the input phi in %.3fs'
              % (tag, ','.join(args.keys), len(idxs), s))
    if 'qcl' in stages:
        out, s = stage_qcl(par, args.keys, idxs)
        print('%s[qcl]  %s: dd/ds/ss spectra %s in %.3fs'
              % (tag, ','.join(args.keys), next(iter(out.values())).shape, s))
    if 'nhl' in stages and hasattr(par, 'nhl_dd'):
        _, s = stage_nhl(par, args.keys, idxs[0])
        print('%s[nhl]  %s: semi-analytic N0 of sim %d in %.3fs'
              % (tag, ','.join(args.keys), idxs[0], s))
    if args.mesh:
        from plancklens_tpu_torch.parallel import distributed as pdist
        pdist.barrier()
        pdist.shutdown()
    print('%sdone.' % tag)


if __name__ == '__main__':
    main()
