"""What decides `correct`: the program's products of the sampled step (or of `check_sims`
of its sims, drawn from the seed), read back through its own accessors after the window,
against the plain reference (portbench/reference).

Numbers compared (each the largest over the step's sims, keys and legs):
  ivf_rel     isotropic filtered alms: max |program - reference| / max |reference|
  maps_rel    masked sims' T, Q, U maps on the grid, the same
  cg_resid_t  masked T solves: |b - A x| / |b| of the program's solution, the reference's
              operator (the configuration's criterion is eps_min on this residual)
  cg_resid_p  the same for the E/B solves
  qlm_rel     gradient and curl of every key on the dd, ds and ss legs
  mf_rel      the split-half mean fields
  qcl_rel     the dd (mean field subtracted), ds and ss spectra

This is the comparison of the configurations that name no `reference`; one that does
brings its own `compare` (portbench/reference/<reference>.py), built from the parts here.
"""
import numpy as np
import torch


def rel(a, b):
    """max |a - b| / max |b|, over everything (inf where a is not finite)."""
    a = torch.as_tensor(a).to(b.device)
    if not bool(torch.isfinite(torch.view_as_real(a) if a.is_complex() else a).all()):
        return float('inf')
    if a.ndim < 2:
        return float((a - b).abs().max() / b.abs().max())
    return float(max(float((x - y).abs().max()) for x, y in zip(a, b)) / b.abs().max())


def program_products(cfg, chain):
    """The sampled step's products, read through the program's accessors (its cachers
    hold the step again, frozen: a product it would compute anew raises)."""
    par, s = chain.par, chain.sample
    chain.restore_sample()
    rows = np.arange(len(s['idxs']))
    if chain.check_sims < len(rows):
        rows = np.sort(chain.rng.choice(rows, chain.check_sims, replace=False))
    idxs = [int(s['idxs'][j]) for j in rows]
    out = dict(idxs=idxs, warm=list(chain.warm), qlm={}, mf={},
               qcl={k: torch.as_tensor(v[rows]) for k, v in s['qcl'].items()})
    for k in cfg['qe_keys']:
        kx = 'x' + k[1:]
        for leg, lib in (('dd', par.qlms_dd), ('ds', par.qlms_ds), ('ss', par.qlms_ss)):
            out['qlm'][(k, leg)] = (
                torch.stack([lib.get_sim_qlm(k, i).cpu() for i in idxs]),
                torch.stack([lib.get_sim_qlm(kx, i).cpu() for i in idxs]))
        w = np.asarray(chain.warm, dtype=int)
        out['mf'][k] = (par.qlms_dd.get_sim_qlm_mf(k, w[0::2]).cpu(),
                        par.qlms_dd.get_sim_qlm_mf(k, w[1::2]).cpu())
    if hasattr(par, 'ivfs_raw'):
        raw = par.ivfs_raw
        need = sorted(set(idxs) | {i - 1 for i in idxs} | {-1} | set(chain.warm))
        out['raw'] = {i: (raw.get_sim_tlm(i), raw.get_sim_elm(i), raw.get_sim_blm(i))
                      for i in need}
        out['maps'] = s['extra']['maps']
    else:
        out['filt'] = tuple(x[torch.as_tensor(rows, device=x.device)] for x in s['filt'])
    return out


def compare(cfg, prog, ref):
    """{name: value} of the numbers compared, and {name: value} of finer readings."""
    idxs = prog['idxs']
    nums, detail = {}, {}
    if 'raw' in prog:
        t, q, u = maps_rel(prog, ref, nums)
        et, ee, eb = raw_teb(prog)(idxs)
        rt = ref.residual_t(t, et)
        rp = ref.residual_p(q, u, ee, eb)
        detail['cg_resid_t_by_sim'] = [float(x) for x in rt]
        detail['cg_resid_p_by_sim'] = [float(x) for x in rp]
        nums['cg_resid_t'] = fmax(rt)
        nums['cg_resid_p'] = fmax(rp)
        legs = raw_legs(prog, ref)
    else:
        cur = ref.filtered(idxs)
        nums['ivf_rel'] = max(rel(p, r) for p, r in zip(prog['filt'], cur))
        legs = (cur, ref.filtered([-1]), ref.filtered([i - 1 for i in idxs]),
                ref.filtered(prog['warm']))
    estimator_checks(prog, ref, legs, nums, detail)
    return nums, detail


def raw_teb(prog):
    """(t, e, b) stacks of the program's filtered alms (before the l >= lmin cut) of a
    list of sims."""
    raw = prog['raw']
    return lambda ii: tuple(torch.stack([raw[i][f] for i in ii]) for f in range(3))


def maps_rel(prog, ref, nums):
    """nums['maps_rel'] of the sampled sims' T, Q, U maps; returns the reference's maps."""
    idxs = prog['idxs']
    t, q, u = ref.maps(idxs)
    pm = prog['maps']
    nums['maps_rel'] = max(
        rel(torch.stack([pm[('t', i)] for i in idxs]), t),
        rel(torch.stack([pm[('p', i)][0] for i in idxs]), q),
        rel(torch.stack([pm[('p', i)][1] for i in idxs]), u))
    return t, q, u


def raw_legs(prog, ref):
    """The estimators' inputs of a masked chain: the program's filtered alms of the
    sampled sims, the data sim, the sims before them and the warm sims, cut at lmin."""
    teb, idxs = raw_teb(prog), prog['idxs']
    return (ref.cut(teb(idxs)), ref.cut(teb([-1])), ref.cut(teb([i - 1 for i in idxs])),
            ref.cut(teb(prog['warm'])))


def estimator_checks(prog, ref, legs, nums, detail):
    """qlm_rel, mf_rel and qcl_rel of the reference's estimators and spectra on `legs`
    (the sampled sims, the data sim, the sims before them, the warm sims)."""
    qlm, mf = ref.estimators(*legs)
    cls = ref.spectra(qlm, mf)
    for (k, leg), (g, c) in qlm.items():
        pg, pc = prog['qlm'][(k, leg)]
        detail['qlm_rel.%s.%s' % (k, leg)] = max(rel(pg, g), rel(pc, c))
        detail['qcl_rel.%s.%s' % (k, leg)] = rel(prog['qcl'][(k, leg)], cls[(k, leg)])
    for k, (a, b) in mf.items():
        detail['mf_rel.%s' % k] = max(rel(prog['mf'][k][0], a), rel(prog['mf'][k][1], b))
    for name in ('qlm_rel', 'mf_rel', 'qcl_rel'):
        nums[name] = max(v for kk, v in detail.items() if kk.startswith(name + '.'))


def fmax(x):
    x = x.detach().cpu().numpy()
    return float(np.max(x)) if np.all(np.isfinite(x)) else float('inf')
