#!/usr/bin/env python
r"""Staged batch pipeline driver of the PyTorch port (reference analogue:
examples/run_qlms.py, itself after plancklens' examples/run_qlms.py):

    python examples/run_qlms_torch.py params/idealized_example_torch.py --device cuda \
        -imin 0 -imax 7 -k ptt p_p --stages filt,qe,mf
    python examples/run_qlms_torch.py params/idealized_example_torch.py --device cuda \
        -imin 4 -imax 7 -k ptt p_p --stages qcl

Stages: filt (filtered alms), qe (batched QEs), mf (split-half mean fields of
mc_sims_mf_dd), qcl (MF-subtracted dd/ds/ss spectra). Sims inside the mean-field set
make the qcl stage raise (the reference's MF-containment guard): run it on the parfile's
mc_sims_var. Each stage's time is measured with CUDA events on a CUDA device and with
the host clock otherwise. The stage functions are importable (chip_smoke.py drives them).
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


def load_parfile(path, device=None):
    """Import a parameter file; `device` sets PLK_DEVICE for it first."""
    if device is not None:
        os.environ['PLK_DEVICE'] = str(device)
    spec = importlib.util.spec_from_file_location('parfile_torch', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class StageTimer:
    """Seconds of a stage: CUDA events on a CUDA device (synchronised at the end), the
    host clock otherwise."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == 'cuda'

    def __enter__(self):
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
        return False


def stage_filt(par, idxs):
    """Filtered (t, e, b) alm batches of sims idxs."""
    with StageTimer(par.DEVICE) as t:
        out = par.ivfs.get_sim_teblm_batch(idxs)
    return out, t.seconds


def stage_qe(par, keys, idxs):
    """{key: (nsims, nalm) qlm batch} of qlms_dd."""
    out = {}
    with StageTimer(par.DEVICE) as t:
        for k in keys:
            out[k] = par.qlms_dd.get_sim_qlm_batch(k, idxs)
    return out, t.seconds


def stage_mf(par, keys):
    """{key: [mean field of each non-empty half of mc_sims_mf_dd]}."""
    out = {}
    halves = [h for h in (par.mc_sims_mf_dd[0::2], par.mc_sims_mf_dd[1::2]) if len(h)]
    with StageTimer(par.DEVICE) as t:
        for k in keys:
            out[k] = [par.qlms_dd.get_sim_qlm_mf(k, h) for h in halves]
    return out, t.seconds


def stage_qcl(par, keys, idxs):
    """{(key, 'dd'|'ds'|'ss'): (nsims, lmax_qlm+1) spectra}; raises for sims in the MF set."""
    out = {}
    with StageTimer(par.DEVICE) as t:
        for k in keys:
            for lib, name in [(par.qcls_dd, 'dd'), (par.qcls_ds, 'ds'), (par.qcls_ss, 'ss')]:
                out[(k, name)] = lib.get_sim_qcl_batch(k, idxs)
    return out, t.seconds


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('parfile', help='parameter file (python module path)')
    p.add_argument('-imin', type=int, default=0)
    p.add_argument('-imax', type=int, default=15)
    p.add_argument('-k', dest='keys', nargs='+', default=['ptt'], help='QE keys to compute')
    p.add_argument('--stages', default='filt,qe,mf', help='comma list of: filt, qe, mf, qcl')
    p.add_argument('--device', default='cuda',
                   help="torch device (default 'cuda'; 'cpu' runs the plain torch path)")
    args = p.parse_args()
    if torch.device(args.device).type == 'cuda' and not torch.cuda.is_available():
        p.error("no CUDA device is available for --device %s; pass --device cpu to run "
                "on the CPU" % args.device)

    par = load_parfile(args.parfile, args.device)
    idxs = np.arange(args.imin, args.imax + 1)
    stages = args.stages.split(',')
    if 'filt' in stages:
        _, s = stage_filt(par, idxs)
        print('[filt] %d sims filtered in %.3fs' % (len(idxs), s))
    if 'qe' in stages:
        _, s = stage_qe(par, args.keys, idxs)
        print('[qe]   %s: %d sims in %.3fs' % (','.join(args.keys), len(idxs), s))
    if 'mf' in stages:
        _, s = stage_mf(par, args.keys)
        print('[mf]   %s: split-half mean fields in %.3fs' % (','.join(args.keys), s))
    if 'qcl' in stages:
        out, s = stage_qcl(par, args.keys, idxs)
        print('[qcl]  %s: dd/ds/ss spectra %s in %.3fs'
              % (','.join(args.keys), next(iter(out.values())).shape, s))
    print('done.')


if __name__ == '__main__':
    main()
