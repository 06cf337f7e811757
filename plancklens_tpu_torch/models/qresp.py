r"""QE key grammar and symbolic QE weights.

QE keys (same grammar as the reference, cf. plancklens/qresp.py:1-31):
  sources: 'p' lensing gradient, 'x' lensing curl, 's' point sources, 'f' modulation,
  'a' polarisation rotation; maps: 'tt' (T only), '_p' (pol only), '' (MV/GMV), explicit
  pairs 'te', '_eb', ...; bias-hardening via '_bh_' infix ('ptt_bh_s').

Port of plancklens_tpu/models/qresp.py. The key grammar, `get_qes` and its helpers are host
numpy, copied. The analytic responses (`get_response`, `RespLib`, `get_dresponse_dlncl`,
`get_mf_resp`) assemble every Wigner-space contraction of a response into one spec list and
hand it to `ops.wigner.wignerc_stack`, whose matrix products run in f64 on `device`; the
(G/C) channel combination is then one vectorised host pass. The 4 response channels live as
a (2, 2, lmax+1) array R[i_out, i_in] (0 = gradient, 1 = curl); the public API returns the
reference-compatible (GG, CC, GC, CG) tuples as host numpy.
"""
import numpy as np
import torch

from ..utils.cls import joincls, cli, clinv
from ..ops.wigner import wignerc_stack
from . import spin as uspin
from .qe import qeleg, qe, qe_simplify, qe_proj

_SPINS3 = (0, -2, 2)


def _source_profile(qe_key, lmax, transf, profile):
    """Per-multipole profile u_l of a profiled spin-0 source estimator.

    'ntt' is the noise-variance estimator: white noise in the observed map appears on the
    beam-deconvolved sky with profile 1/b_l, hence inverse-beam legs (reference:
    plancklens/qresp.py:88-92).  'dtt' is the extended-("profiled")-source estimator
    (profile-hardening in the sense of Sailer-Schaan-Ferraro 2020): the reference lists
    dtt and its hardened combinations in its key grammar (plancklens/qest.py:109-114) but
    ships no builder or response for them; here the profile is explicit (`profile` arg),
    defaulting to the beam b_l (a source with the angular extent of the beam — distinct
    from the flat 'stt' and inverse-beam 'ntt' members of the same family)."""
    if qe_key == 'ntt':
        assert transf is not None, 'ntt needs the beam transfer function (transf)'
        return clinv(np.asarray(transf, dtype=float)[:lmax + 1])
    if profile is not None:
        return np.asarray(profile, dtype=float)[:lmax + 1]
    assert transf is not None, 'dtt needs a source profile (profile or transf)'
    return np.asarray(transf, dtype=float)[:lmax + 1]


# map selectors of the QE key grammar -> the signed spin set both legs run over
_SELECTOR_SPINS = {'tt': (0,), '_p': (-2, 2), '': (0, -2, 2)}


def _parse_key(qe_key):
    """Split a spin-source QE key into (source letter, leg spin set, block projections).

    Selectors: 'tt' = T-only legs, '_p' = polarisation-only legs, '' = MV (all of
    T/E/B on both legs), 'ab' with a,b in 'teb' = one ordered field block, '_ab' =
    the symmetrised ab + ba pair. The returned `blocks` is None (no restriction) or a
    list of (first-leg field, second-leg field) letters to project onto."""
    src, sel = qe_key[0], qe_key[1:]
    if sel in _SELECTOR_SPINS:
        return src, _SELECTOR_SPINS[sel], None
    if len(sel) == 2 and sel[0] in 'teb' and sel[1] in 'teb':
        return src, _SELECTOR_SPINS[''], [(sel[0], sel[1])]
    if len(sel) == 3 and sel[0] == '_' and sel[1] in 'teb' and sel[2] in 'teb':
        return src, _SELECTOR_SPINS[''], [(sel[1], sel[2]), (sel[2], sel[1])]
    raise ValueError('qe key %s not recognized' % qe_key)


def _conjugate_pair_weight(s):
    """Weight of one signed-spin component: the +|s| and -|s| parts of a real spin
    field each carry half of the signed-spin sum (a spin-0 field has only one)."""
    return 1. if s == 0 else .5


def get_qes(qe_key, lmax, cls_weight, lmax2=None, transf=None, profile=None):
    """Symbolic QE weights for a QE key, acting on inverse-variance filtered spin fields
    (reference behaviour: plancklens/qresp.py:50-101)."""
    if lmax2 is None:
        lmax2 = lmax
    if qe_key[0] in ['p', 'x', 'a', 'f', 's']:
        src, spins, blocks = _parse_key(qe_key)
        delta = np.ones(lmax + 1, dtype=float)
        terms = []
        # One term per ordered pair of signed leg spins (sa, sb): the first leg passes
        # the spin-sa filtered field through unweighted (a delta leg), the second
        # carries the (-r source-spin component of the) response of the spin-(-sa, sb)
        # covariance block to the source.
        # Real spin fields are summed over both signed components, so every non-zero
        # spin contributes with half weight (see _conjugate_pair_weight).
        for sa in spins:
            for sb in spins:
                s_src, _pr, cl_ab, cL = get_covresp(src, -sa, sb, cls_weight, lmax2,
                                                    transf=transf)
                if not np.any(cl_ab):
                    continue
                lega = qeleg(sa, sa, _conjugate_pair_weight(sa) * delta)
                legb = qeleg(sb, -sa + s_src, 2. * _conjugate_pair_weight(sb) * cl_ab)
                terms.append(qe(lega, legb, cL))
        if blocks is None:
            return qe_simplify(terms)
        return qe_simplify([t for a, b in blocks for t in qe_proj(terms, a, b)])
    elif qe_key in ['ntt', 'dtt']:
        # profiled spin-0 source estimators (see _source_profile)
        u = _source_profile(qe_key, lmax, transf, profile)
        lega = qeleg(0, 0, u.copy())
        legb = qeleg(0, 0, 0.5 * u)
        return qe_simplify([qe(lega, legb, lambda L: np.ones(len(L), dtype=float))])
    elif qe_key in ['ktt']:
        # 'kappa-tt' BFK-type estimator (reference: plancklens/qresp.py:93-99)
        ls = np.arange(1, lmax + 3)
        dlnDldlnl = ls[:-1] * np.diff(np.log(cls_weight['tt'][ls] * ls * (ls + 1)))
        lega = qeleg(0, 0, np.ones(lmax + 1, dtype=float))
        legb = qeleg(0, 0, 0.5 * cls_weight['tt'][:lmax + 1] * dlnDldlnl)
        return qe_simplify([qe(lega, legb, lambda L: -L * (L + 1.))])
    assert 0, qe_key + ' not implemented'


def get_resp_legs(source, lmax):
    r"""Per-spin harmonic response of a CMB map to an anisotropy source: 4-tuple
    (source spin r, response for +r, response for -r, G/C -> potential scaling)
    (math as reference plancklens/qresp.py:104-133)."""
    ones = np.ones(lmax + 1, dtype=float)
    unit_scale = lambda ell: np.ones(len(ell), dtype=float)
    if source in ['p', 'x']:
        # lensing: gradient of the covariance, one unit of source spin
        kappa_scale = lambda ell: uspin.get_spin_raise(0, np.max(ell))[ell]
        return {s: (1, -0.5 * uspin.get_spin_lower(s, lmax),
                    -0.5 * uspin.get_spin_raise(s, lmax), kappa_scale)
                for s in _SPINS3}
    if source == 'f':
        # modulation: spin-0 multiplicative source
        return {s: (0, 0.5 * ones, 0.5 * ones, unit_scale) for s in _SPINS3}
    if source in ['a', 'a_p']:
        # rotation: acts on polarisation only, with opposite phase on the +-2 components
        ret = {s: (0, -np.sign(s) * 1j * ones, -np.sign(s) * 1j * ones, unit_scale)
               for s in (-2, 2)}
        ret[0] = (0, np.zeros(lmax + 1), np.zeros(lmax + 1), unit_scale)
        return ret
    assert 0, source + ' response legs not implemented'


def get_covresp(source, s1, s2, cls, lmax, transf=None):
    r"""Response of the spin-(s1, s2) CMB covariance to the anisotropy source
    (math as reference plancklens/qresp.py:135-163)."""
    if source in ['p', 'x', 'f', 'a', 'a_p']:
        s_source, prR, mrR, cL_scal = get_resp_legs(source, lmax)[s1]
        coupl = uspin.spin_cls(s1, s2, cls)[:lmax + 1]
        return s_source, prR * coupl, mrR * coupl, cL_scal
    elif source in ['stt', 's']:
        # point sources: a white spin-0 covariance response on the TT block only
        unit = 0.25 * (s1 == 0 and s2 == 0) * np.ones(lmax + 1, dtype=float)
        return 0, unit, unit.copy(), lambda ell: np.ones(len(ell), dtype=float)
    assert 0, 'source ' + source + ' cov. response not implemented'


def qe_spin_data(qe_key):
    """(output spin, 'G'/'C', input spins, spin-1 source key) for a QE key
    (reference: plancklens/qresp.py:165-180)."""
    if qe_key in ['ntt', 'dtt']:
        return 0, 'G', [0], qe_key[0]
    qes = get_qes(qe_key, 10, {k: np.ones(15, dtype=float) for k in ['tt', 'te', 'ee', 'bb']})
    spins_out = [q.leg_a.spin_ou + q.leg_b.spin_ou for q in qes]
    spins_in = np.unique(np.abs([q.leg_a.spin_in for q in qes]
                                + [q.leg_b.spin_in for q in qes]))
    assert len(np.unique(spins_out)) == 1, spins_out
    assert spins_out[0] >= 0, spins_out[0]
    if spins_out[0] > 0:
        assert qe_key[0] in ['x', 'p'], 'non-zero spin QE ' + qe_key + ' not implemented?'
    return spins_out[0], 'C' if qe_key[0] == 'x' else 'G', spins_in, \
        'p' if qe_key[0] == 'x' else qe_key[0]


def _to_tuple(R):
    """(2, 2, L) channel array -> (GG, CC, GC, CG)."""
    return R[0, 0], R[1, 1], R[0, 1], R[1, 0]


def get_response(qe_key, lmax_ivf, source, cls_weight, cls_cmb, fal, fal_leg2=None,
                 lmax_ivf2=None, lmax_qlm=None, transf=None, profile=None, *, device):
    r"""Isotropic QE response 4-tuple (R^GG, R^CC, R^GC, R^CG)
    (reference behaviour: plancklens/qresp.py:269-312).

    `cls_weight` enters the QE weights, `cls_cmb` the CMB covariance response, `fal` the
    isotropic filtering spectra (1/(C+N/b^2)-style); `transf`/`profile` parameterise the
    profiled spin-0 sources 'n' and 'd' (see _source_profile). `device` runs the Wigner
    matrix products.
    """
    if lmax_ivf2 is None:
        lmax_ivf2 = lmax_ivf
    if lmax_qlm is None:
        lmax_qlm = lmax_ivf + lmax_ivf2
    kw = dict(fal_leg2=fal_leg2, lmax_ivf2=lmax_ivf2, lmax_qlm=lmax_qlm, transf=transf,
              profile=profile, device=device)
    if '_bh_' in qe_key:
        # bias-hardening as 2x2 channel algebra: R_bh = R_ks - R_kh D(R_hh)^-1 R_hs,
        # with D the diagonal (GG, CC) part (reference math: plancklens/qresp.py:290-306)
        k, hsrc = qe_key.split('_bh_')
        assert len(hsrc) == 1, hsrc
        h = hsrc[0] + k[1:]
        R_ks = _channels(get_response(k, lmax_ivf, source, cls_weight, cls_cmb, fal, **kw))
        R_hs = _channels(get_response(h, lmax_ivf, source, cls_weight, cls_cmb, fal, **kw))
        R_kh = _channels(get_response(k, lmax_ivf, hsrc[0], cls_weight, cls_cmb, fal, **kw))
        R_hh = _channels(get_response(h, lmax_ivf, hsrc[0], cls_weight, cls_cmb, fal, **kw))
        Dinv = np.zeros_like(R_hh)
        Dinv[0, 0] = cli(R_hh[0, 0])
        Dinv[1, 1] = cli(R_hh[1, 1])
        return _to_tuple(R_ks - np.einsum('abl,bcl,cdl->adl', R_kh, Dinv, R_hs))

    qes = get_qes(qe_key, lmax_ivf, cls_weight, lmax2=lmax_ivf2, transf=transf,
                  profile=profile)
    if 'tt' in qe_key and source in ['n', 'ntt', 'd', 'dtt']:
        skey = source[0] + 'tt'
        u = _source_profile(skey, max(lmax_ivf, lmax_ivf2), transf, profile)
        return _get_response_profiled(qes, fal, lmax_qlm, u, fal_leg2=fal_leg2,
                                      device=device)
    return _get_response(qes, source, cls_cmb, fal, lmax_qlm, fal_leg2=fal_leg2,
                         device=device)


def _channels(tup):
    """(GG, CC, GC, CG) -> (2, 2, L) channel array."""
    GG, CC, GC, CG = tup
    return np.array([[GG, GC], [CG, CC]])


def _insertion_pair(q, Fa, Fb, sF, tF, source, cls_cmb, sign_r):
    """The two contraction specs of one covariance-response insertion, +r (`sign_r`=+1) or
    -r (`sign_r`=-1): the source acting through leg b, and through leg a.

    Returns ([(spec, Lweight_fn), (spec, Lweight_fn)], r) with specs consumable by
    `wignerc_stack`.
    """
    sa_o, sb_o = q.leg_a.spin_ou, q.leg_b.spin_ou
    r_b, wp_b, wm_b, scale_b = get_covresp(source, -sF, tF, cls_cmb, len(Fb) - 1)
    r_a, wp_a, wm_a, scale_a = get_covresp(source, -tF, sF, cls_cmb, len(Fa) - 1)
    assert r_a == r_b and r_b >= 0, (r_a, r_b)
    w_b = wm_b if sign_r > 0 else wp_b
    w_a = wm_a if sign_r > 0 else wp_a
    via_b = ((joincls([q.leg_a.cl, Fa]), (sa_o, sF),
              joincls([q.leg_b.cl, Fb, np.conj(w_b)]), (sb_o, -sF + sign_r * r_b)), scale_b)
    via_a = ((joincls([q.leg_a.cl, Fa, np.conj(w_a)]), (sa_o, -tF + sign_r * r_a),
              joincls([q.leg_b.cl, Fb]), (sb_o, tF)), scale_a)
    return [via_b, via_a], r_b


def _get_response(qes, source, cls_cmb, fal_leg1, lmax_qlm, fal_leg2=None, *, device):
    """Batched assembly of the response channel array (math as reference
    plancklens/qresp.py:376-418; evaluation via one `wignerc_stack` call)."""
    fal2 = fal_leg1 if fal_leg2 is None else fal_leg2
    Ls = np.arange(lmax_qlm + 1, dtype=int)
    specs = []     # contraction specs, in blocks of 2 (pr) or 4 (pr + mr)
    spec_w = []    # per-spec L-dependent weight
    blocks = []    # (start_row, has_mr, parity, cL prefactor) per (q, sF, tF) block
    for q in qes:
        prefac = q.cL(Ls)
        for sF in _SPINS3:
            Fa = uspin.get_spin_matrix(q.leg_a.spin_in, sF, fal_leg1)
            if not np.any(Fa):
                continue
            for tF in _SPINS3:
                Fb = uspin.get_spin_matrix(q.leg_b.spin_in, tF, fal2)
                if not np.any(Fb):
                    continue
                start = len(specs)
                pr, r = _insertion_pair(q, Fa, Fb, sF, tF, source, cls_cmb, +1)
                for spec, scale in pr:
                    specs.append(spec)
                    spec_w.append(scale(Ls))
                if r > 0:
                    for spec, scale in _insertion_pair(q, Fa, Fb, sF, tF, source,
                                                       cls_cmb, -1)[0]:
                        specs.append(spec)
                        spec_w.append(scale(Ls))
                blocks.append((start, r > 0, (-1) ** r, prefac))

    R = np.zeros((2, 2, lmax_qlm + 1), dtype=float)
    if not specs:
        return _to_tuple(R)
    res = wignerc_stack(specs, lmax_qlm, device=device) * np.asarray(spec_w)
    for start, has_mr, parity, prefac in blocks:
        Rpr = res[start] + res[start + 1]
        Rmr = (res[start + 2] + res[start + 3]) if has_mr else Rpr
        R[0, 0] += prefac * (Rpr.real + parity * Rmr.real)
        R[1, 1] += prefac * (Rpr.real - parity * Rmr.real)
        R[0, 1] += prefac * (parity * Rmr.imag - Rpr.imag)
        R[1, 0] += prefac * (Rpr.imag + parity * Rmr.imag)
    return _to_tuple(R)


def _get_response_profiled(qes, fal_leg1, lmax_qlm, u, fal_leg2=None, *, device):
    """Response of TT-like QEs to a profiled spin-0 source with per-leg profile u_l
    ('ntt': u = 1/b_l; 'dtt': user profile), batched
    (math as reference plancklens/qresp.py:315-361)."""
    fal2 = fal_leg1 if fal_leg2 is None else fal_leg2
    Ls = np.arange(lmax_qlm + 1, dtype=int)
    bli = np.asarray(u, dtype=float)
    specs, blocks = [], []
    for q in qes:
        sa_i, sb_i = q.leg_a.spin_in, q.leg_b.spin_in
        sa_o, sb_o = q.leg_a.spin_ou, q.leg_b.spin_ou
        assert (sa_i, sb_i) == (0, 0)
        s_qe = abs(sa_o + sb_o)
        Fa = uspin.get_spin_matrix(sa_i, 0, fal_leg1)
        Fb = uspin.get_spin_matrix(sb_i, 0, fal2)
        if not (np.any(Fa) and np.any(Fb)):
            continue
        start = len(specs)
        specs.append((joincls([q.leg_a.cl, Fa, bli]), (sa_o, 0),
                      joincls([q.leg_b.cl, Fb, bli]), (sb_o, 0)))
        if s_qe > 0:
            Fa_m = uspin.get_spin_matrix(-sa_i, 0, fal_leg1)
            Fb_m = uspin.get_spin_matrix(-sb_i, 0, fal2)
            specs.append((joincls([np.conj(q.leg_a.cl), Fa_m, bli]), (-sa_o, 0),
                          joincls([np.conj(q.leg_b.cl), Fb_m, bli]), (-sb_o, 0)))
        parity_fac = (-1) ** (sa_o + sa_i + sb_o + sb_i) if s_qe > 0 else 1.
        blocks.append((start, s_qe > 0, s_qe, parity_fac, 0.5 * q.cL(Ls)))

    R = np.zeros((2, 2, lmax_qlm + 1), dtype=float)
    if specs:
        res = wignerc_stack(specs, lmax_qlm, device=device)
        for start, has_m, s_qe, pfac, prefac in blocks:
            Rp = np.atleast_1d(res[start])
            Rm = pfac * np.atleast_1d(res[start + 1]) if has_m else Rp
            sgn = (-1) ** s_qe
            R[0, 0] += prefac * (Rp.real + sgn * Rm.real)
            R[1, 1] += prefac * (Rp.real - sgn * Rm.real)
            R[0, 1] += prefac * (sgn * np.imag(Rm) - np.imag(Rp))
            R[1, 0] += prefac * (np.imag(Rp) + sgn * np.imag(Rm))
    return _to_tuple(R)


def get_dresponse_dlncl(qe_key, l, cl_key, lmax_ivf, source, cls_weight, cls_cmb, fal_leg1,
                        fal_leg2=None, lmax_ivf2=None, lmax_out=None, *, device):
    """dR_L / dln C_l (reference: plancklens/qresp.py:364-374)."""
    if lmax_ivf2 is None:
        lmax_ivf2 = lmax_ivf
    if lmax_out is None:
        lmax_out = lmax_ivf2 + lmax_ivf
    dcls_cmb = {k: np.zeros_like(cls_cmb[k]) for k in cls_cmb.keys()}
    dcls_cmb[cl_key][l] = cls_cmb[cl_key][l]
    qes = get_qes(qe_key, lmax_ivf, cls_weight, lmax2=lmax_ivf2)
    return _get_response(qes, source, dcls_cmb, fal_leg1, lmax_out, fal_leg2=fal_leg2,
                         device=device)


class RespLib:
    """Cached QE response library (reference: plancklens/qresp.py:183-266).

    get_response(k, ksource) returns the G (or C for curl keys) response array, host numpy;
    the Wigner matrix products run on `device`.
    """

    def __init__(self, lmax_ivf, cls_weight, cls_cmb, fal, lmax_qlm, transf=None,
                 cacher=None, profile=None, *, device):
        from ..utils.cachers import cacher_mem
        self.lmax_qe = lmax_ivf
        self.lmax_qlm = lmax_qlm
        self.cls_weight = cls_weight
        self.cls_cmb = cls_cmb
        self.fal = fal
        self.transf = transf
        self.profile = profile  # 'd'-source profile (see _source_profile)
        self.cacher = cacher if cacher is not None else cacher_mem()
        self.device = torch.device(device)

    def hashdict(self):
        from ..utils.hashing import clhash
        ret = {'lmaxqe': self.lmax_qe, 'lmax_qlm': self.lmax_qlm}
        for k in self.cls_weight.keys():
            ret['clsweight ' + k] = clhash(self.cls_weight[k])
        for k in self.cls_cmb.keys():
            ret['clscmb ' + k] = clhash(self.cls_cmb[k])
        for k in self.fal.keys():
            ret['fal' + k] = clhash(self.fal[k])
        if self.transf is not None:
            ret['transf'] = clhash(self.transf)
        if self.profile is not None:
            ret['profile'] = clhash(self.profile)
        return ret

    def get_response(self, k, ksource):
        if '_bh_' in k:  # bias-hardened estimator (reference: qresp.py:238-245)
            kQE, bhksource = k.split('_bh_')
            assert len(bhksource) == 1, (kQE, ksource)
            wL = self.get_response(kQE, bhksource)
            wL = wL * cli(self.get_response(bhksource + kQE[1:], bhksource))
            ret = self.get_response(kQE, ksource)
            return ret - wL * self.get_response(bhksource + kQE[1:], ksource)
        if k in ['xmtt', 'pmtt']:
            return self.get_response(k[0], ksource) - self.get_response(k[0] + 'tt', ksource)
        s, GorC, sins, ksp = qe_spin_data(k)
        fn = 'qe_' + ksp + k[1:] + '_source_%s_' % ksource + GorC + GorC
        if not self.cacher.is_cached(fn):
            GG, CC, GC, CG = get_response(k, self.lmax_qe, ksource, self.cls_weight,
                                          self.cls_cmb, self.fal, lmax_qlm=self.lmax_qlm,
                                          transf=self.transf, profile=self.profile,
                                          device=self.device)
            self.cacher.cache('qe_' + ksp + k[1:] + '_source_%s_' % ksource + 'GG', GG)
            if s > 0:
                self.cacher.cache('qe_' + ksp + k[1:] + '_source_%s_' % ksource + 'CC', CC)
        return np.asarray(self.cacher.load(fn))


def get_mf_resp(qe_key, cls_cmb, cls_ivfs, lmax_qe, lmax_out, retterms=False, *, device):
    r"""Deflection-induced mean-field response (Carron & Lewis 2019; math as reference
    plancklens/qresp.py:421-501), evaluated as one batched contraction stack.

    Two families of Wick terms enter: "connected" ones where the two deflection insertions
    share a covariance line (xi K xi - xi type), and "disconnected" squares of single
    insertions ((xi K)(xi K) type, a Fisher-like piece). Both are enumerated below into a
    single spec list; each term carries its (grad_weight, curl_weight) combination signs.
    """
    assert qe_key in ['p_p', 'ptt'], qe_key
    spins = [0] if qe_key == 'ptt' else [-2, 2]
    diag = ['tt'] if qe_key == 'ptt' else ['ee', 'bb']
    lmax_cmb = min(len(cls_cmb[k]) - 1 for k in diag)
    assert lmax_qe <= lmax_cmb
    # filtered-covariance building blocks, per diagonal spectrum
    cl_KxiK = {k: cls_cmb[k][:lmax_qe + 1] ** 2 * cls_ivfs[k][:lmax_qe + 1] for k in diag}
    cl_K = {k: cls_cmb[k][:lmax_qe + 1] * cls_ivfs[k][:lmax_qe + 1] for k in diag}

    specs = []
    combo = []  # (grad sign, curl sign, fisher?) per spec
    for s1 in spins:
        for s2 in spins:
            half = 0.5 ** (s1 != 0) * 0.5 ** (s2 != 0)
            # connected family: ivf covariance x (cmb - cmb K cmb) covariance, two
            # deflection spins a (on the cmb side) x b (fixed +1 by symmetry)
            cl_i = uspin.spin_cls(s1, s2, cls_ivfs)[:lmax_qe + 1] * half
            cl_c = np.array(uspin.spin_cls(s2, s1, cls_cmb)[:lmax_cmb + 1])
            cl_c[:lmax_qe + 1] -= uspin.spin_cls(s2, s1, cl_KxiK)[:lmax_qe + 1]
            if np.any(cl_i) and np.any(cl_c):
                for a in (-1, 1):
                    da = uspin.get_spin_lower(s2, lmax_cmb) if a == -1 \
                        else uspin.get_spin_raise(s2, lmax_cmb)
                    db = uspin.get_spin_lower(-s1, lmax_cmb)  # b = +1 branch only (symmetry)
                    pref = 2. * (-1) ** (s1 + s2)
                    specs.append((pref * cl_i, (s2, s1), cl_c * da * db, (-s2 - a, -s1 - 1)))
                    combo.append((-a, -1., False))
            # disconnected (Fisher) family: two single-K insertions
            cl_u = uspin.spin_cls(s2, s1, cl_K)[:lmax_qe + 1] * 0.5 ** (s1 != 0)
            cl_v = uspin.spin_cls(s1, s2, cl_K)[:lmax_qe + 1] * 0.5 ** (s2 != 0)
            if np.any(cl_u) and np.any(cl_v):
                for a in (-1, 1):
                    da = uspin.get_spin_lower(s2, lmax_qe) if a == -1 \
                        else uspin.get_spin_raise(s2, lmax_qe)
                    db = uspin.get_spin_lower(s1, lmax_qe)
                    pref = 2. * (-1) ** (s1 + s2)
                    specs.append((pref * cl_u * da, (-s2 - a, -s1), cl_v * db, (s2, s1 - 1)))
                    combo.append((-a, -1., True))

    GL = np.zeros(lmax_out + 1, dtype=float)
    CL = np.zeros(lmax_out + 1, dtype=float)
    fishG = np.zeros(lmax_out + 1, dtype=float)
    fishC = np.zeros(lmax_out + 1, dtype=float)
    res = wignerc_stack(specs, lmax_out, device=device).real
    for row, (gw, cw, fisher) in zip(res, combo):
        if fisher:
            fishG += gw * row
            fishC += cw * row
        else:
            GL += gw * row
            CL += cw * row
    terms = {'GK': GL.copy(), 'GxiK': -fishG.copy()}
    GL -= fishG
    CL -= fishC
    terms['Gcons'] = -np.ones_like(GL) * CL[1]
    GL -= CL[1]   # constant-deflection gauge term
    CL -= CL[1]
    kfac = 0.25 * np.arange(lmax_out + 1) * np.arange(1, lmax_out + 2)
    GL *= kfac
    CL *= kfac
    for t in terms.values():
        t *= kfac
    return (GL, CL) if not retterms else (GL, CL, terms)
