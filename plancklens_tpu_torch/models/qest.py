r"""Quadratic estimator evaluation and QE libraries, in torch.

Port of plancklens_tpu/models/qest.py: the key's symbolic weights (qresp.get_qes) are
compressed to a minimal set of spin transforms; legs are synthesised as spin-weighted
position-space fields on a Gauss-Legendre grid exact for the triple product, multiplied
pointwise and analysed at the output spin (reference: plancklens/utils_qe.py:34-132 and
plancklens/qest.py:19-39). Every evaluation is batched over a leading sims axis and runs
on the device of the QE library; on a CUDA device each transform's Legendre phase runs
the Hopper kernels.
"""
import numpy as np
import torch

from ..utils import alm as ualm
from ..utils.hashing import clhash, mchash
from ..utils.cachers import cacher_mem
from ..utils import trace
from ..utils.cls import cli
from ..ops.sht import SHT, gl_geometry
from . import qresp
from .qe import qe_compress


def _almxfl(alm, cl):
    lmax = ualm.getlmax(alm.shape[-1])
    fl = np.zeros(lmax + 1, dtype=np.asarray(cl).dtype)
    n = min(lmax + 1, len(cl))
    fl[:n] = cl[:n]
    return ualm.almxfl(alm, lmax, fl)


def _eval_leg(leg, get_alm, sht):
    """Complex spin-weighted position-space field of a (multi-)leg acting on filtered alms
    (reference math: plancklens/utils_qe.py:50-73). Returns (batch, nrings, nphi) complex.
    Traced as a span qe.leg."""
    with trace.span('qe.leg', spin=int(leg.spin_ou)):
        return _leg_field(leg, get_alm, sht)


def _leg_field(leg, get_alm, sht):
    lmax = sht.lmax
    glm = None
    clm = None

    def acc(tot, x):
        return x if tot is None else tot + x

    for si, cl in zip(leg.spins_in, leg.cls):
        assert si in [0, -2, 2], str(si) + ' input spin not implemented'
        if abs(si) == 2:
            g_in, c_in = get_alm('e'), get_alm('b')
        else:
            g_in, c_in = -get_alm('t'), None
        sgn_g = -(-1.) ** si if si < 0 else -1.
        sgn_c = (-1.) ** si if si < 0 else -1.
        lmax_in = ualm.getlmax(g_in.shape[-1])
        g_in = ualm.alm_copy(g_in, lmax_in, lmax)
        glm = acc(glm, _almxfl(g_in, sgn_g * np.asarray(cl)))
        if c_in is not None:
            c_in = ualm.alm_copy(c_in, lmax_in, lmax)
            clm = acc(clm, _almxfl(c_in, sgn_c * np.asarray(cl)))
    glm = -glm
    if clm is None:
        clm = torch.zeros_like(glm)
    elif leg.spin_ou > 0:
        clm = -clm
    so = leg.spin_ou
    if so == 0:
        # healpy scalar convention: map = alm2map(-glm)  (utils_spin.alm2map_spin, spin 0)
        return sht.alm2map(-glm).to(sht.cdtype)
    re, im = sht.alm2map_spin((glm, clm), abs(so))
    if so < 0 and so % 2 == 1:
        re = -re
    if so < 0 and so % 2 == 0:
        im = -im
    return torch.complex(re, im)


def eval_qe(qe_key, lmax_ivf, cls_weight, get_alm, lmax_qlm, geom=None, get_alm2=None,
            transf=None, profile=None, verbose=False, dtype=None, *, device):
    """Evaluate a QE's gradient and curl alms from filtered-alm providers.

    Args:
        qe_key: estimator key (qresp grammar)
        lmax_ivf: max CMB multipole entering the QE
        cls_weight: spectra entering the QE weights
        get_alm: callable 't'|'e'|'b' -> batched filtered alm tensors (bar X)
        lmax_qlm: output band limit
        geom: optional RingGeometry; defaults to a GL grid exact for the triple product
        get_alm2: second-leg provider (estimator symmetrised when provided)
        dtype: SHT real dtype (default torch.float64; torch.float32 in production)
        device: device of the transforms; the filtered alms must lie on it

    Returns:
        (glm, clm) batched triangular alms.

    Traced as a span qe.eval (key, lmax_qlm, dtype, batch) around the legs' and the output
    analysis' spans.
    """
    with trace.span('qe.eval', key=qe_key, lmax_qlm=int(lmax_qlm), dtype=str(dtype)) as s:
        qe_list = qresp.get_qes(qe_key, lmax_ivf, cls_weight, transf=transf,
                                profile=profile)
        glm, clm = qe_eval(qe_list, get_alm, lmax_qlm, geom=geom, get_alm2=get_alm2,
                           verbose=verbose, dtype=dtype, device=device)
        s.set(batch=int(glm.shape[0]) if glm.ndim > 1 else 1)
    return glm, clm


def qe_eval(qe_list, get_alm, lmax_qlm, geom=None, get_alm2=None, verbose=False,
            dtype=None, *, device):
    """Generic position-space QE evaluation (reference: plancklens/utils_qe.py:92-132)."""
    if get_alm2 is None:
        get_alm2 = get_alm
    symmetrize = get_alm2 is not get_alm
    qes = qe_compress(qe_list, verbose=verbose)
    qe_spin = qes[0][0].spin_ou + qes[0][1].spin_ou
    Ls = np.arange(lmax_qlm + 1)
    cL_out = qes[0][-1](Ls)
    assert qe_spin >= 0, qe_spin
    # all compressed terms are co-added and normalised once: they must share the output
    # spin and cL scaling (the reference asserts the same, plancklens/utils_qe.py:103-108)
    for q in qes[1:]:
        assert q[0].spin_ou + q[1].spin_ou == qe_spin, \
            (q[0].spin_ou + q[1].spin_ou, qe_spin)
        assert np.allclose(q[-1](Ls), cL_out), 'qe terms with mixed cL scalings'
    lmax_leg = max(max(q[0].get_lmax(), q[1].get_lmax()) for q in qes)
    if geom is None:
        geom = gl_geometry((2 * lmax_leg + lmax_qlm) // 2, nphi=None)
    dtype = torch.float64 if dtype is None else dtype
    sht_leg = SHT(geom, lmax_leg, dtype=dtype, device=device)
    sht_out = SHT(geom, lmax_qlm, dtype=dtype, device=device)
    d = None
    for q in qes:
        term = _eval_leg(q[0], get_alm, sht_leg) * _eval_leg(q[1], get_alm2, sht_leg)
        if symmetrize:
            term = term + _eval_leg(q[0], get_alm2, sht_leg) * _eval_leg(q[1], get_alm, sht_leg)
        d = term if d is None else d + term
    with trace.span('qe.out', spin=int(qe_spin)):
        if qe_spin > 0:
            glm, clm = sht_out.map2alm_spin((d.real, d.imag), qe_spin)
        else:
            glm = -sht_out.map2alm(d.real)
            clm = torch.zeros_like(glm)
    if symmetrize:
        glm = glm * 0.5
        clm = clm * 0.5
    return _almxfl(glm, cL_out), _almxfl(clm, cL_out)


class QELib:
    r"""QE evaluation library bound to filtering libraries (reference:
    plancklens/qest.py:51-246).

    Args:
        ivfs1, ivfs2: filtering libraries for the two legs
        cls_weight: spectra entering the QE weights (e.g. lensed cls)
        lmax_ivf: max CMB multipole used
        lmax_qlm: output band limit
        cacher: optional cacher for computed qlms, handed the device tensors (a memory
            cacher keeps them on the device, a file cacher copies them to the host)
        resplib: qresp.RespLib, needed by the bias-hardened '_bh_' keys
        transf, profile: beam / source profile for the 'ntt' / 'dtt' keys
        dtype: SHT real dtype (None = float64; torch.float32 in production)
        device: device the QEs are evaluated on
    """

    def __init__(self, ivfs1, ivfs2, cls_weight, lmax_ivf, lmax_qlm, cacher=None,
                 resplib=None, transf=None, profile=None, dtype=None, *, device):
        self.ivfs1 = ivfs1
        self.ivfs2 = ivfs2
        self.cls_weight = cls_weight
        self.lmax_ivf = lmax_ivf
        self.lmax_qlm = lmax_qlm
        self.cacher = cacher if cacher is not None else cacher_mem(maxsize=64)
        self.resplib = resplib
        self.transf = transf
        self.profile = profile
        self.dtype = dtype
        self.device = torch.device(device)
        # every knob shaping a cached qlm enters its name, as in the reference: f32 and
        # f64 products sharing a cacher never serve each other
        self._ctag = '' if dtype is None else '_' + str(dtype).split('.')[-1]
        if transf is not None:
            self._ctag += '_tf%s' % str(clhash(np.asarray(transf, dtype=float)))[:8]
        if profile is not None:
            self._ctag += '_pr%s' % str(clhash(np.asarray(profile, dtype=float)))[:8]

    def _load(self, fn):
        """The cached qlm on self.device: the cached tensor itself when it is there, a copy
        when the cacher gave a host array or a tensor on another device."""
        return trace.to_device(self.cacher.load(fn), self.device, 'qlm')

    def _cache(self, fn, qlm):
        """Hand the device tensor qlm to the cacher. While the tracer is live, an entry the
        cacher took without a copy to the host counts as copy.kept_on_device_bytes."""
        if not trace.live():
            self.cacher.cache(fn, qlm)
            return
        copied = trace.counters().get('copy.to_host_bytes', 0)
        self.cacher.cache(fn, qlm)
        if trace.counters().get('copy.to_host_bytes', 0) == copied:
            trace.count('copy.kept_on_device_bytes', qlm.numel() * qlm.element_size())

    def hashdict(self):
        h = {'ivfs1': self.ivfs1.hashdict(), 'ivfs2': self.ivfs2.hashdict(),
             'lmax_ivf': self.lmax_ivf, 'lmax_qlm': self.lmax_qlm,
             'dtype': self._ctag,
             **{'clw ' + k: clhash(v) for k, v in self.cls_weight.items()}}
        if self.transf is not None:
            h['transf'] = clhash(self.transf)
        if self.profile is not None:
            h['profile'] = clhash(self.profile)
        return h

    # The reference's 30 fundamental keys (reference: plancklens/qest.py:109-114)
    keys_fund = ['ptt', 'xtt', 'p_p', 'x_p', 'p', 'x', 'stt', 's', 'ftt', 'f_p', 'f',
                 'dtt', 'ntt', 'a_p',
                 'pte', 'pet', 'ptb', 'pbt', 'pee', 'peb', 'pbe', 'pbb',
                 'xte', 'xet', 'xtb', 'xbt', 'xee', 'xeb', 'xbe', 'xbb']

    def get_fundkeys(self, k_list):
        """Fundamental estimator keys entering one or several (possibly composite /
        bias-hardened) keys, order-preserving and de-duplicated (reference:
        plancklens/qest.py:122-141)."""
        ks = k_list if isinstance(k_list, list) else [k_list]
        ret = []
        for k in ks:
            if k in self.keys_fund:
                ret.append(k)
            elif '_tp' in k:
                ret += [k[0] + 'tt', k[0] + '_p']
            elif '_bh_' in k:
                kQE, ksource = k.split('_bh_')
                ret += [kQE, ksource + kQE[1:]]
            elif k in ['p_te', 'p_tb', 'p_eb', 'x_te', 'x_tb', 'x_eb']:
                ret += [k[0] + k[2] + k[3], k[0] + k[3] + k[2]]
            else:
                raise ValueError('unknown estimator key: %s' % k)
        return list(dict.fromkeys(ret))

    def get_lmax_qlm(self, k):
        """Output band limit of estimator k (one band limit serves every key)."""
        return self.lmax_qlm

    def get_dat_qlm(self, k, **kwargs):
        """QE on the data map (index -1 convention; reference: plancklens/qest.py:203)."""
        return self.get_sim_qlm(k, -1, **kwargs)

    def get_mask(self, leg):
        """Sky mask of leg 1 or 2 (full-sky scalar 1. when the filtering library carries
        no mask; reference: plancklens/qest.py:151-153)."""
        assert leg in (1, 2), leg
        from .filt import base_ivfs
        base = base_ivfs(self.ivfs1 if leg == 1 else self.ivfs2)
        return np.asarray(base.get_fmask()) if hasattr(base, 'get_fmask') else 1.

    def get_fsky(self, id):
        """Mask-product sky fractions <m_i m_j> for id in {11, 22, 12} (reference:
        plancklens/qest.py:86-105, 143-145). Ring-grid masks are quadrature-weighted."""
        assert id in (11, 22, 12), id
        if not hasattr(self, '_fskies'):
            from .filt import mask_geom, fsky_mean
            ms, mean = fsky_mean([mask_geom(i) for i in (self.ivfs1, self.ivfs2)])
            if ms is None:  # maskless, or legs on different grids: degrade to 1
                self._fskies = {11: 1., 22: 1., 12: 1.}
            else:
                self._fskies = {11: mean(ms[0] * ms[0]), 22: mean(ms[1] * ms[1]),
                                12: mean(ms[0] * ms[1])}
        return self._fskies[id]

    def _get_alm_fn(self, ivfs, idx):
        def get_alm(f):
            return {'t': ivfs.get_sim_tlm, 'e': ivfs.get_sim_elm,
                    'b': ivfs.get_sim_blm}[f](idx)
        return get_alm

    def _get_alm_batch_fn(self, ivfs, idxs):
        if hasattr(ivfs, 'get_sim_teblm_batch'):
            t, e, b = ivfs.get_sim_teblm_batch(idxs)
        else:  # filters exposing only the per-index interface
            idxs = np.atleast_1d(idxs)
            t = torch.stack([ivfs.get_sim_tlm(int(i)) for i in idxs])
            e = torch.stack([ivfs.get_sim_elm(int(i)) for i in idxs])
            b = torch.stack([ivfs.get_sim_blm(int(i)) for i in idxs])

        def get_alm(f):
            return {'t': t, 'e': e, 'b': b}[f]
        return get_alm

    def _bh_qlm(self, k, get_qlm):
        """Bias-hardened qlm^{bh} = qlm^{QE} - w_L qlm^{src-est}, with
        w_L = R^{QE,src} / R^{src-est,src} (reference: plancklens/qest.py:173-181)."""
        assert self.resplib is not None, \
            "'_bh_' keys need the resplib argument (a qresp.RespLib)"
        kQE, ksource = k.split('_bh_')
        assert len(ksource) == 1, (kQE, ksource)
        wL = np.asarray(self.resplib.get_response(kQE, ksource)) \
            * cli(np.asarray(self.resplib.get_response(ksource + kQE[1:], ksource)))
        return get_qlm(kQE) - _almxfl(get_qlm(ksource + kQE[1:]), wL)

    def get_sim_qlm(self, k, idx, grad_only=False):
        """Gradient (or curl) QE alm tensor for simulation idx; composite and '_bh_' keys
        resolve recursively as in the reference (reference: plancklens/qest.py:155-201).
        `grad_only` is the JAX package's keyword, passed through the recursion and unused
        there too: the gradient and curl come from one product either way."""
        assert k[0] in ['p', 'x', 's', 'f', 'a', 'n', 'd'], k
        if k in ['p_tp', 'x_tp', 'f_tp', 's_tp']:
            return (self.get_sim_qlm('%stt' % k[0], idx, grad_only=grad_only)
                    + self.get_sim_qlm('%s_p' % k[0], idx, grad_only=grad_only))
        if k in ['p_te', 'p_tb', 'p_eb', 'x_te', 'x_tb', 'x_eb']:
            return (self.get_sim_qlm(k[0] + k[2] + k[3], idx, grad_only=grad_only)
                    + self.get_sim_qlm(k[0] + k[3] + k[2], idx, grad_only=grad_only))
        if '_bh_' in k:
            return self._bh_qlm(k, lambda kk: self.get_sim_qlm(kk, idx, grad_only=grad_only))
        fn = 'qlm%s_%s_%04d' % (self._ctag, k, idx)
        fnx = 'qlm%s_%s_%04d' % (self._ctag, 'x' + k[1:], idx)
        if not self.cacher.is_cached(fn):
            glm, clm = self._eval_key(k, self._get_alm_fn(self.ivfs1, idx),
                                      self._get_alm_fn(self.ivfs2, idx)
                                      if self.ivfs2 is not self.ivfs1 else None)
            glm = glm[0] if glm.ndim > 1 else glm
            self._cache(fn, glm)
            if k[0] in ['p', 'x']:
                clm = clm[0] if clm.ndim > 1 else clm
                self._cache(fnx, clm)
        return self._load(fnx if k[0] == 'x' else fn)

    def _eval_key(self, k, get_alm, get_alm2):
        kk = 'p' + k[1:] if k[0] == 'x' else k  # grad and curl come from the same product
        return eval_qe(kk, self.lmax_ivf, self.cls_weight, get_alm, self.lmax_qlm,
                       get_alm2=get_alm2, transf=self.transf, profile=self.profile,
                       dtype=self.dtype, device=self.device)

    def get_sim_qlm_batch(self, k, idxs):
        """Batched evaluation over simulation indices (one pipeline, sims axis), written
        through to the per-index cache entries get_sim_qlm uses."""
        if k in ['p_tp', 'x_tp', 'f_tp', 's_tp']:
            return (self.get_sim_qlm_batch('%stt' % k[0], idxs)
                    + self.get_sim_qlm_batch('%s_p' % k[0], idxs))
        if k in ['p_te', 'p_tb', 'p_eb', 'x_te', 'x_tb', 'x_eb']:
            return (self.get_sim_qlm_batch(k[0] + k[2] + k[3], idxs)
                    + self.get_sim_qlm_batch(k[0] + k[3] + k[2], idxs))
        if '_bh_' in k:
            return self._bh_qlm(k, lambda kk: self.get_sim_qlm_batch(kk, idxs))
        idxs = np.atleast_1d(np.asarray(idxs, dtype=int))
        fns = ['qlm%s_%s_%04d' % (self._ctag, k, i) for i in idxs]
        if all(self.cacher.is_cached(fn) for fn in fns):
            return torch.stack([self._load(fn) for fn in fns])
        get_alm = self._get_alm_batch_fn(self.ivfs1, idxs)
        get_alm2 = None
        if self.ivfs2 is not self.ivfs1:
            get_alm2 = self._get_alm_batch_fn(self.ivfs2, idxs)
        glm, clm = self._eval_key(k, get_alm, get_alm2)
        kq = 'p' + k[1:] if k[0] == 'x' else k   # grad product's own key name
        for j, i in enumerate(idxs):
            self._cache('qlm%s_%s_%04d' % (self._ctag, kq, i), glm[j])
            if k[0] in ('p', 'x'):
                self._cache('qlm%s_%s_%04d' % (self._ctag, 'x' + k[1:], i), clm[j])
        return clm if k[0] == 'x' else glm

    def get_sim_qlm_mf(self, k, mc_sims):
        """Mean-field estimate: QE average over simulations
        (reference: plancklens/qest.py:206-246)."""
        fn = 'qlm%s_mf_%s_%s' % (self._ctag, k, mchash(mc_sims))
        if not self.cacher.is_cached(fn):
            qlms = self.get_sim_qlm_batch(k, np.asarray(mc_sims))
            self._cache(fn, qlms.mean(0))
        return self._load(fn)
