r"""Preconditioned conjugate-gradient solvers on torch tensors.

Port of plancklens_tpu/ops/cg.py:18-237, which replaces the reference's conjugate-directions
loop (plancklens/qcinv/cd_solve.py:35-107) by PCG with a composite preconditioner. The JAX
package runs each solve as one jitted `lax.while_loop`; here the loop is Python, and every
iteration reads its stop flag back to the host (one small device-to-host read against the
two SHTs of each forward op), so the iteration count and the iterates are the
reference's.

Vectors are (batch, n) complex tensors, a batch of right-hand sides (sims) on the leading
axis. :func:`pcg` runs the batch in lockstep (reference cg.py:6-9): the loop runs until
every row meets the criterion, and rows that converged early keep refining; no row is
masked. :func:`pcg_frozen` is for rows that are independent systems, each to be solved as
if alone (sims the reference filters one at a time): each row stops at its own
convergence. `ms` is the m of each entry (numpy or a tensor), turned into the dot weights
once a solve.
"""
import time

import numpy as np
import torch

from ..utils import trace


def _weights(ms, device):
    """f64 dot weights 1 (m = 0) / 2 (m > 0) on `device`."""
    ms = torch.as_tensor(np.asarray(ms) if not isinstance(ms, torch.Tensor) else ms,
                         device=device)
    return torch.where(ms == 0, 1., 2.).to(torch.float64)


def _dot(alm1, alm2, w):
    prod = (alm1 * torch.conj(alm2)).real
    return (w * prod.to(torch.float64)).sum(-1).to(prod.dtype)


def dot_alm(alm1, alm2, ms):
    """Scalar product sum_lm (2 - delta_m0) Re(a1 a2*) == sum_l (2l+1) cl_l(a1, a2) of the
    last axis (reference: plancklens/qcinv/opfilt_tt.py:43-51). ms: m of each entry.

    Always accumulated in f64 (the card has native FP64; the f32 CG is otherwise limited
    by round-off in these reductions near rel. resid ~1e-5), returned in the data's real
    dtype."""
    return _dot(alm1, alm2, _weights(ms, alm1.device))


def _posguard(x):
    """max(x, tiny) with the dtype's tiny: an all-zero RHS row (or a row converging to an
    exact-zero residual) would otherwise give 0/0 = NaN and poison that row of the batch."""
    return torch.clamp_min(x, torch.finfo(x.dtype).tiny)


def _start(b, x0):
    b = torch.atleast_2d(torch.as_tensor(b))
    x0 = torch.as_tensor(x0, device=b.device).to(b.dtype)
    return b, torch.atleast_2d(x0).expand(b.shape)


def _init(fwd_op, pre_op, b, x0, w):
    """PCG start from x0: (b, x, r, p, rz)."""
    b, x = _start(b, x0)
    r = b - fwd_op(x)
    p = pre_op(r)
    return b, x, r, p, _dot(r, p, w)


def _step(fwd_op, pre_op, b, x, r, p, rz, w, replace=False):
    """One PCG iteration: (x, r, p, rz) after it. With `replace` the residual is recomputed
    as b - A x (residual replacement) instead of recurred; the direction is kept."""
    rdt = b.real.dtype
    Ap = fwd_op(p)
    alpha = (rz / _posguard(_dot(p, Ap, w))).to(rdt)
    x = x + alpha[:, None] * p
    r = b - fwd_op(x) if replace else r - alpha[:, None] * Ap
    z = pre_op(r)
    rz_new = _dot(r, z, w)
    beta = (rz_new / _posguard(rz)).to(rdt)
    return x, r, z + beta[:, None] * p, rz_new


def _pcg_loop(fwd_op, pre_op, b, x0, iter_max, eps_min, w, roundoff):
    """PCG loop shared by :func:`pcg` and :func:`pcg_ir`, on dot weights `w`. Returns
    (x, n_iter, rel).

    Traced as a span cg.solve (batch, iters, rel_max), a span cg.iter for each iteration
    and a span cg.stop for the host's read of the stop flag alone (its reduction is
    launched before the span opens); counter cg.iters."""
    with trace.span('cg.solve') as s:
        b, x, r, p, rz = _init(fwd_op, pre_op, b, x0, w)
        b0 = _posguard(_dot(b, b, w))
        it = 0
        while it < iter_max:
            go = (torch.sqrt(_dot(r, r, w) / b0) > eps_min).any()
            with trace.span('cg.stop'):
                go = bool(go)
            if not go:
                break
            with trace.span('cg.iter'):
                # residual replacement only: the conjugate direction is kept (a full
                # restart destroys the Krylov history and measurably slows convergence)
                x, r, p, rz = _step(fwd_op, pre_op, b, x, r, p, rz, w,
                                    roundoff > 0 and (it + 1) % roundoff == 0)
            it += 1
        rel = torch.sqrt(_dot(r, r, w) / b0)
        trace.count('cg.iters', it)
        s.set(batch=int(b.shape[0]), iters=it)
        s.set_max('rel_max', rel)
    return x, it, rel


def pcg(fwd_op, pre_op, b, x0, iter_max, eps_min, ms, roundoff=25):
    """Solve fwd_op(x) = b by PCG. Returns (x, n_iter, rel_residual).

    fwd_op, pre_op: callables on (batch, n) complex tensors, returning their input's dtype.
    Convergence: sqrt(<r,r>/<b,b>) <= eps_min on every batch row.

    Every `roundoff` iterations the true residual r = b - A x is recomputed (residual
    replacement, the reference's round-off policy, cd_solve.py:82-86) so the recurred
    residual cannot drift from the true one; the conjugate direction is kept.
    """
    return _pcg_loop(fwd_op, pre_op, b, x0, iter_max, eps_min,
                     _weights(ms, torch.as_tensor(b).device), roundoff)


def pcg_frozen(fwd_op, pre_op, b, x0, iter_max, eps_min, ms, roundoff=25):
    """Solve fwd_op(x) = b by PCG with each row frozen at its own convergence: the rows are
    independent systems, and each follows the iterates of its own one-row :func:`pcg`.
    Returns (x, n_iter, rel_residual) as pcg does; n_iter is the loop's iteration count,
    the most any row took.

    A row whose sqrt(<r,r>/<b,b>) <= eps_min keeps its x, r, p and rz, and so its rel, from
    that iteration on; the loop ends when no row is active, or at `iter_max`. Frozen rows
    still go through fwd_op and pre_op with the batch, and a select drops their update, so
    a row is active only while the loop has run exactly its own iterations: residual
    replacement (every `roundoff` iterations, as in pcg) falls where it falls in the row's
    own solve. With every row active nothing is selected, so at batch 1 this is pcg,
    bitwise.

    Traced as pcg is (spans cg.solve, cg.iter, cg.stop; counter cg.iters the loop's
    iterations), the cg.solve span with attr row_iters (each row's iterations); counters
    cg.row_iters (their sum) and cg.frozen_row_iters (the row-iterations computed for rows
    already frozen: the loop's iterations times the batch, less cg.row_iters)."""
    w = _weights(ms, torch.as_tensor(b).device)
    with trace.span('cg.solve') as s:
        b, x, r, p, rz = _init(fwd_op, pre_op, b, x0, w)
        b0 = _posguard(_dot(b, b, w))
        active = torch.ones(b.shape[0], dtype=torch.bool, device=b.device)
        row_iters = [0] * b.shape[0]
        it = 0
        while it < iter_max:
            active = active & (torch.sqrt(_dot(r, r, w) / b0) > eps_min)
            with trace.span('cg.stop'):
                act = active.tolist()
            if not any(act):
                break
            with trace.span('cg.iter'):
                new = _step(fwd_op, pre_op, b, x, r, p, rz, w,
                            roundoff > 0 and (it + 1) % roundoff == 0)
                if not all(act):
                    new = tuple(torch.where(active.view((-1,) + (1,) * (v.ndim - 1)), v, v0)
                                for v, v0 in zip(new, (x, r, p, rz)))
                x, r, p, rz = new
            row_iters = [n + a for n, a in zip(row_iters, act)]
            it += 1
        rel = torch.sqrt(_dot(r, r, w) / b0)
        trace.count('cg.iters', it)
        trace.count('cg.row_iters', sum(row_iters))
        trace.count('cg.frozen_row_iters', it * len(row_iters) - sum(row_iters))
        s.set(batch=len(row_iters), iters=it, row_iters=row_iters)
        s.set_max('rel_max', rel)
    return x, it, rel


def pcg_ir(fwd_op, pre_op, b, x0, iter_max, eps_min, ms, inner_dec=3e-2, inner_cap=80):
    """PCG with iterative-refinement restarts, the single-precision solver.

    A single long f32 CG stalls far above its operator's round-off floor: the recurred
    search directions lose conjugacy to accumulated rounding. Each outer step here
    recomputes the true residual r = b - A x and solves the correction equation A e = r
    with a fresh Krylov space to a relative reduction `inner_dec` (at most `inner_cap`
    iterations, no residual replacement inside), so every inner solve runs where f32 CG
    is still healthy. Costs one extra forward apply per outer step, counted in the
    returned total. Returns (x, total_forward_applies, rel_residual).

    Traced as a span cg.solve (batch, iters, rel_max) around the inner solves' own, each
    outer step's residual a span cg.iter and its stop test a cg.stop, each counted in
    cg.iters as the total counts it.
    """
    with trace.span('cg.solve') as s:
        b, x = _start(b, x0)
        w = _weights(ms, b.device)
        b0 = _posguard(_dot(b, b, w))
        rel = torch.full((b.shape[0],), float('inf'), dtype=b.real.dtype, device=b.device)
        it_tot, done = 0, False
        while not done and it_tot < iter_max:
            with trace.span('cg.iter'):
                r = b - fwd_op(x)
                rel = torch.sqrt(_dot(r, r, w) / b0)
                done = (rel <= eps_min).all()
            with trace.span('cg.stop'):
                done = bool(done)
            trace.count('cg.iters')
            it_in = 0
            if not done:
                e, it_in, _ = _pcg_loop(fwd_op, pre_op, r, torch.zeros_like(r), inner_cap,
                                        inner_dec, w, 0)
                x = x + e
            it_tot += it_in + 1
        s.set(batch=int(b.shape[0]), iters=it_tot)
        s.set_max('rel_max', rel)
    return x, it_tot, rel


def solve(fwd_op, pre_op, b, x0, iter_max, eps_min, ms, force_ir=None):
    """Linear-system solve: plain PCG in double precision, IR-restarted PCG
    (:func:`pcg_ir`) when the working dtype is single."""
    b = torch.as_tensor(b)
    use_ir = force_ir if force_ir is not None else b.real.dtype == torch.float32
    if use_ir:
        return pcg_ir(fwd_op, pre_op, b, x0, iter_max, eps_min, ms)
    return pcg(fwd_op, pre_op, b, x0, iter_max, eps_min, ms)


class monitor_basic:
    """Convergence monitor for the monitored solver (role of reference
    plancklens/qcinv/cd_monitors.py monitor_basic): records per-iteration relative
    residuals, optionally printing and/or appending to a log file."""

    def __init__(self, eps_min, iter_max=1000, verbose=False, logfile=None):
        self.eps_min = eps_min
        self.iter_max = iter_max
        self.verbose = verbose
        self.logfile = logfile
        self.history = []
        self._t0 = None

    def __call__(self, it, rel):
        if self._t0 is None:
            self._t0 = time.time()
        rel = float(np.max(rel)) if np.ndim(rel) else float(rel)
        self.history.append(rel)
        line = '[%8.2fs] iter %4d  rel resid %.3e' % (time.time() - self._t0, it, rel)
        if self.verbose:
            print(line)
        if self.logfile is not None:
            with open(self.logfile, 'a') as f:
                f.write(line + '\n')
        return rel < self.eps_min or it >= self.iter_max


def pcg_monitored(fwd_op, pre_op, b, x0, ms, monitor):
    """PCG with a per-iteration monitor callback (the diagnostics path; no residual
    replacement). `monitor(it, rel_per_batch)` gets a host numpy array and returns True to
    stop. Returns (x, n_iter, rel_residual)."""
    w = _weights(ms, torch.as_tensor(b).device)
    b, x, r, p, rz = _init(fwd_op, pre_op, b, x0, w)
    b0 = _posguard(_dot(b, b, w))
    it = 0
    rel = torch.sqrt(_dot(r, r, w) / b0).cpu().numpy()
    while not monitor(it, rel):
        x, r, p, rz = _step(fwd_op, pre_op, b, x, r, p, rz, w)
        it += 1
        rel = torch.sqrt(_dot(r, r, w) / b0).cpu().numpy()
    return x, it, rel


def pcg_fixed(fwd_op, pre_op, b, x0, n_iter, ms):
    """Fixed-iteration PCG, for inner multigrid-stage solves whose iteration count is part
    of the chain descriptor (reference: plancklens/qcinv/multigrid.py:185-215). No host
    read at all. Returns x."""
    w = _weights(ms, torch.as_tensor(b).device)
    b, x, r, p, rz = _init(fwd_op, pre_op, b, x0, w)
    for _ in range(n_iter):
        x, r, p, rz = _step(fwd_op, pre_op, b, x, r, p, rz, w)
    return x
