r"""Generic conjugate-directions solver with pluggable truncation policies and
multi-preconditioner search panels, in torch.

Port of plancklens_tpu/ops/cd.py, the parity surface for the reference's flexible solver
(reference: plancklens/qcinv/cd_solve.py:35-107): several preconditioners may each
propose a search direction per iteration (a *panel*), the panel is A-orthogonalised
against a policy-controlled window of previous panels, and the step is taken jointly
through the panel Gram matrix. With a single preconditioner and the `tr_cg` policy this
is preconditioned CG, which is why the production solver of this package is the lockstep
PCG of :mod:`ops.cg` (batched right-hand sides). This host-driven loop is the diagnostic
surface: the policies are data-dependent Python, each vector operation runs where its
operands live (any array type the operators take; the panel scalars are host floats).

Truncation policies map the iteration counter to the first panel index kept for
orthogonalisation: ``tr_cg`` keeps only the previous panel (CG memory), ``tr_cd`` keeps
everything (full conjugate directions, immune to round-off loss of conjugacy), ``ptr``
is the reference's periodically-truncated-restart family.
"""
import numpy as np


def tr_cg(it):
    """CG memory: orthogonalise against the previous panel only."""
    return it - 1


def tr_cd(it):
    """Full memory: orthogonalise against every panel since the start."""
    return 0


def ptr(p, t, r):
    """Periodic truncation/restart (reference: plancklens/qcinv/cd_solve.py:7-8):
    keep at least `p` panels, growing the window up to `t` within each period `r`."""
    return lambda it: max(0, it - max(p, int(min(t, it % r))))


class cache_mem:
    """In-memory panel history with the reference's store/restore/trim contract
    (reference: plancklens/qcinv/cd_solve.py:15-32); subclass to spill panels to disk
    for very long tr_cd runs."""

    def __init__(self):
        self._d = {}

    def store(self, it, panel):
        self._d[it] = panel

    def restore(self, it):
        return self._d[it]

    def trim(self, keep):
        keep = set(keep)
        for k in [k for k in self._d if k not in keep]:
            del self._d[k]


def cd_solve(x, b, fwd_op, pre_ops, dot_op, criterion, tr=tr_cg, cache=None,
             roundoff=25):
    """Solve fwd_op(x) = b by conjugate directions over a preconditioner panel.

    Args:
        x: initial guess (any array-like the operators accept); NOT mutated.
        b: right-hand side.
        fwd_op: the (symmetric positive-definite w.r.t. dot_op) forward operator.
        pre_ops: list of preconditioners; each proposes one search direction per
            iteration (len > 1 = a multi-preconditioner panel, e.g. two dense blocks
            built at different band limits).
        dot_op: scalar product, (v, w) -> scalar.
        criterion: (iteration, x, residual) -> bool; True stops the loop.
        tr: truncation policy (tr_cg / tr_cd / ptr(p, t, r)).
        cache: panel history (defaults to a fresh in-memory cache).
        roundoff: recompute the true residual b - A x every `roundoff` iterations
            (0 disables; the recurrence is exact in exact arithmetic).

    Returns:
        (x, n_iterations).
    """
    cache = cache_mem() if cache is None else cache
    npanel = len(pre_ops)
    resid = b - fwd_op(x)
    dirs = [op(resid) for op in pre_ops]
    it = 0
    x_ok, rr_min = x, np.inf   # last iterate with a finite, non-diverged residual
    while not criterion(it, x, resid):
        fwds = [fwd_op(d) for d in dirs]
        # joint step through the panel Gram matrix (D^T A D) alpha = D^T r
        gram = np.empty((npanel, npanel))
        for i in range(npanel):
            gram[i, i] = float(dot_op(dirs[i], fwds[i]))
            for j in range(i):
                gram[i, j] = gram[j, i] = float(dot_op(dirs[i], fwds[j]))
        if not np.all(np.isfinite(gram)):
            x = x_ok   # breakdown: e.g. a panel member with no action on this residual
            break
        # pseudo-inverse: a degenerate panel (collinear proposals, or a member whose
        # proposal vanishes on this residual) steps in the non-degenerate subspace
        # instead of poisoning the iteration with an exploding inverse
        gram_inv = np.linalg.pinv(gram)
        alphas = gram_inv @ np.asarray([float(dot_op(d, resid)) for d in dirs])
        if not np.all(np.isfinite(alphas)):
            x = x_ok
            break
        for alpha, d in zip(alphas, dirs):
            x = x + float(alpha) * d
        cache.store(it, (gram_inv, dirs, fwds))

        it += 1
        if roundoff and it % roundoff == 0:
            resid = b - fwd_op(x)
        else:
            for alpha, f in zip(alphas, fwds):
                resid = resid - float(alpha) * f
        rr = float(dot_op(resid, resid))
        if not np.isfinite(rr) or rr > 1e16 * rr_min:
            x = x_ok   # diverged beyond any round-off-explicable growth
            break
        if rr <= rr_min:
            x_ok, rr_min = x, rr

        # new panel, A-orthogonalised against the policy window of previous panels
        dirs = [op(resid) for op in pre_ops]
        for past in range(max(tr(it), 0), it):
            p_inv, p_dirs, p_fwds = cache.restore(past)
            for i, d in enumerate(dirs):
                betas = p_inv @ np.asarray([float(dot_op(d, f)) for f in p_fwds])
                acc = d
                for beta, pd in zip(betas, p_dirs):
                    acc = acc - float(beta) * pd
                dirs[i] = acc
        cache.trim(range(max(tr(it + 1), 0), it))
    return x, it


def criterion_rel(eps, dot_op, b, iter_max=np.inf):
    """Stop when sqrt(<r,r>/<b,b>) < eps or at iter_max (the package PCG's criterion)."""
    b0 = float(dot_op(b, b))

    def crit(it, x, resid):
        return it >= iter_max or \
            float(np.sqrt(float(dot_op(resid, resid)) / max(b0, 1e-300))) < eps
    return crit
