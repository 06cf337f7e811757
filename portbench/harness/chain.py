"""The Monte Carlo chain a cell drives: set-up, then whole steps of the user's driver stages
(examples/run_qlms_torch.py: stage_filt -> stage_qe (dd) -> stage_qcl (dd, ds, ss)) on
fresh sims until the window's seconds have passed.

One step takes `sims_per_step` fresh sim indices. The ds leg pairs every sim with the data
sim (index -1), filtered once in set-up; the ss leg pairs each sim with the one before it
(the first with the last set-up sim). The mean field comes from the `warm` set-up sims, as
split halves, built in set-up through the driver's qe and mf stages at the window's batch.
The loop is closed: a step starts when the previous step's spectra are on the host. The
program's QE products of a step live in `StepCacher`s handed to its QE libraries and are
dropped when the step ends, but for one step drawn from the seed (a reservoir sample over
the steps completed) that the check compares after the window.
"""
import importlib.util
import os
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def driver():
    """The user's batch driver, examples/run_qlms_torch.py, as a module."""
    path = os.path.join(ROOT, 'examples', 'run_qlms_torch.py')
    spec = importlib.util.spec_from_file_location('run_qlms_torch', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class StepCacher:
    """Cacher of a QE library (the program's cacher interface: cache, load, is_cached):
    mean fields ('_mf_' in the name) are kept for the run, everything else for one step."""

    def __init__(self):
        self.keep, self.step = {}, {}
        self.frozen = False

    def cache(self, fn, obj):
        if self.frozen:
            raise RuntimeError('the program computed %s after the window' % fn)
        (self.keep if '_mf_' in fn else self.step)[fn] = obj

    def load(self, fn):
        return self.keep[fn] if fn in self.keep else self.step[fn]

    def is_cached(self, fn):
        return fn in self.keep or fn in self.step

    def end_step(self):
        out, self.step = self.step, {}
        return out


class Chain:
    """Drives one cell's program (`par`, from the configuration's builder) through set-up
    and the window."""

    def __init__(self, par, traffic, seed, rec):
        self.par = par
        self.drv = driver()
        self.keys = list(traffic['keys'])
        self.B = int(traffic['sims_per_step'])
        self.warm = list(range(int(traffic['warm_sims'])))
        self.check_sims = int(traffic.get('check_sims', self.B))
        self.rec = rec
        self.rng = np.random.default_rng([int(seed), 7])
        self.sample = None
        self.steps = []

    def _batch_of(self, idxs):
        """idxs repeated to the window's batch: set-up runs the window's shapes."""
        return np.resize(np.asarray(idxs), self.B)

    def setup(self):
        d, par = self.drv, self.par
        d.stage_filt(par, np.array([-1]))
        d.stage_filt(par, np.asarray(self.warm))
        wb = self._batch_of(self.warm)
        d.stage_qe(par, self.keys, wb)
        d.stage_mf(par, self.keys)
        for k in self.keys:
            par.qcls_ds.get_sim_qcl_batch(k, wb)
            par.qcls_ss.get_sim_qcl_batch(k, wb)
        for c in par.cachers:
            c.end_step()
        par.end_step(np.asarray(self.warm))
        if par.DEVICE.type == 'cuda':
            torch.cuda.synchronize()

    def step(self, idxs):
        d, par, rec = self.drv, self.par, self.rec
        with rec.span('filter'):
            filt, _ = d.stage_filt(par, idxs)
        with rec.span('qe_stage'):
            d.stage_qe(par, self.keys, idxs)
        with rec.span('qcl_stage'):
            qcl, _ = d.stage_qcl(par, self.keys, idxs)
        return filt, qcl

    def window(self, seconds):
        """Whole steps until `seconds` have passed: (sims, seconds to the last step's end)."""
        nxt = len(self.warm)
        t0 = time.perf_counter()
        n = 0
        with torch.profiler.record_function('portbench.window'):
            while True:
                idxs = np.arange(nxt, nxt + self.B)
                filt, qcl = self.step(idxs)
                products = [c.end_step() for c in self.par.cachers]
                extra = self.par.end_step(idxs)
                bad = set(extra['failed'])
                for (k, leg), cl in qcl.items():
                    for j in np.nonzero(~np.all(np.isfinite(cl), axis=1))[0]:
                        bad.add(int(idxs[j]))
                self.steps.append(dict(idxs=idxs, bad=bad))
                if self.rng.random() * len(self.steps) < 1.:
                    self.sample = dict(idxs=idxs, filt=filt, qcl=qcl, products=products,
                                       extra=extra)
                n += self.B
                nxt += self.B
                t1 = time.perf_counter()
                if t1 - t0 >= seconds:
                    break
        return n, t1 - t0

    def restore_sample(self):
        """Put the sampled step's QE products back in the program's cachers, frozen, so
        that the program's own accessors read them after the window."""
        for c, prod in zip(self.par.cachers, self.sample['products']):
            c.step = prod
            c.frozen = True
