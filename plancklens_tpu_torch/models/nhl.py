r"""Semi-analytic Gaussian noise biases (unnormalised N0), in torch.

Port of plancklens_tpu/models/nhl.py. N0 for the cross-spectrum of two QEs from
Wigner-space contractions of the QE weights with the inverse-variance-filtered CMB spectra
(math: plancklens/nhl.py:15-97 and arXiv:1807.06210 App. A). Each QE-term pair contributes
four Wick pairings (direct, crossed, and their spin-reflected mirrors); all pairings of all
term pairs are assembled into one spec list and evaluated by a single `wignerc_stack` call:
a few stacked matrix products against cached Wigner-d matrices (f64, on `device`).
`NhlLib` takes the empirical spectra of the filtered sims from the ivfs library's alm
tensors (`utils.alm.alm2cl` on their device).
"""
import numpy as np
import torch

from ..utils import alm as ualm
from ..utils.cls import joincls
from ..ops.wigner import wignerc_stack
from . import spin as uspin
from . import qresp


def get_nhl(qe_key1, qe_key2, cls_weights, cls_ivfs, lmax_ivf1, lmax_ivf2,
            lmax_out=None, lmax_ivf12=None, lmax_ivf22=None, cls_weights2=None,
            cls_ivfs_bb=None, cls_ivfs_ab=None, cls_ivfs_ba=None, transf=None,
            profile=None, *, device):
    """4-tuple (GG, CC, GC, CG) of Gaussian noise covariances for two QE keys
    (reference: plancklens/nhl.py:15-43).  `transf`/`profile` parameterise the profiled
    spin-0 source keys 'ntt'/'dtt' (qresp._source_profile); `device` runs the Wigner
    matrix products."""
    if lmax_ivf12 is None:
        lmax_ivf12 = lmax_ivf1
    if lmax_ivf22 is None:
        lmax_ivf22 = lmax_ivf2
    if cls_weights2 is None:
        cls_weights2 = cls_weights
    qes1 = qresp.get_qes(qe_key1, lmax_ivf1, cls_weights, lmax2=lmax_ivf12, transf=transf,
                         profile=profile)
    qes2 = qresp.get_qes(qe_key2, lmax_ivf2, cls_weights2, lmax2=lmax_ivf22, transf=transf,
                         profile=profile)
    if lmax_out is None:
        lmax_out = max(lmax_ivf1, lmax_ivf12) + max(lmax_ivf2, lmax_ivf22)
    return _get_nhl(qes1, qes2, cls_ivfs, lmax_out, cls_ivfs_bb=cls_ivfs_bb,
                    cls_ivfs_ab=cls_ivfs_ab, cls_ivfs_ba=cls_ivfs_ba, device=device)


def _wick_line(leg1, leg2, cls, mirror=False):
    """One Wick line joining a leg of QE A with a (conjugated) leg of QE B: the joint
    spectrum and the two position-space spins of the contraction. With `mirror`, leg 1 is
    reflected onto its (-s) spin component (parity sign included in the spectrum)."""
    if mirror:
        sgn = (-1) ** (leg1.spin_in + leg1.spin_ou)
        cl = sgn * joincls([np.conj(leg1.cl), np.conj(leg2.cl),
                            uspin.spin_cls(-leg1.spin_in, leg2.spin_in, cls)])
        return cl, -leg1.spin_ou, leg2.spin_ou
    cl = joincls([leg1.cl, np.conj(leg2.cl),
                  uspin.spin_cls(leg1.spin_in, leg2.spin_in, cls)])
    return cl, leg1.spin_ou, leg2.spin_ou


def _get_nhl(qes1, qes2, cls_ivfs, lmax_out, cls_ivfs_bb=None, cls_ivfs_ab=None,
             cls_ivfs_ba=None, ret_terms=False, *, device):
    """Wick contractions of the QE 4-point function, batched
    (math as reference plancklens/nhl.py:45-97)."""
    cls_aa = cls_ivfs
    cls_bb = cls_ivfs if cls_ivfs_bb is None else cls_ivfs_bb
    cls_ab = cls_ivfs if cls_ivfs_ab is None else cls_ivfs_ab
    cls_ba = cls_ivfs if cls_ivfs_ba is None else cls_ivfs_ba
    Ls = np.arange(lmax_out + 1)

    specs, pair_meta = [], []
    for q1 in qes1:
        for q2 in qes2:
            assert q1.leg_a.spin_ou + q1.leg_b.spin_ou >= 0
            assert q2.leg_a.spin_ou + q2.leg_b.spin_ou >= 0
            for mirror in (False, True):
                for lx, ly, cls_x, cls_y in [
                        (q2.leg_a, q2.leg_b, cls_aa, cls_bb),   # direct pairing
                        (q2.leg_b, q2.leg_a, cls_ab, cls_ba)]:  # crossed pairing
                    cl_1, sp1, s1 = _wick_line(q1.leg_a, lx, cls_x, mirror=mirror)
                    cl_2, sp2, s2 = _wick_line(q1.leg_b, ly, cls_y, mirror=mirror)
                    specs.append((cl_1, (sp1, s1), cl_2, (sp2, s2)))
            pair_meta.append(((-1) ** (q1.leg_a.spin_ou + q1.leg_b.spin_ou),
                              q1.cL(Ls) * q2.cL(Ls)))

    GG = np.zeros(lmax_out + 1, dtype=float)
    CC = np.zeros(lmax_out + 1, dtype=float)
    GC = np.zeros(lmax_out + 1, dtype=float)
    CG = np.zeros(lmax_out + 1, dtype=float)
    terms = []
    res = wignerc_stack(specs, lmax_out, device=device)
    for i, (sgn, cLw) in enumerate(pair_meta):
        direct = (res[4 * i] + res[4 * i + 1]) * cLw
        mirrored = (res[4 * i + 2] + res[4 * i + 3]) * cLw
        GG += 0.5 * direct.real + 0.5 * sgn * mirrored.real
        CC += 0.5 * direct.real - 0.5 * sgn * mirrored.real
        GC -= 0.5 * np.imag(direct) + 0.5 * sgn * np.imag(mirrored)
        CG += 0.5 * np.imag(direct) - 0.5 * sgn * np.imag(mirrored)
        if ret_terms:
            terms += [0.5 * direct, 0.5 * sgn * mirrored]
    return (GG, CC, GC, CG) if not ret_terms else (GG, CC, GC, CG, terms)


class NhlLib:
    """Per-simulation semi-analytic N0 library using empirical filtered-map spectra
    (reference: plancklens/nhl.py:99-189). Spectra and N0 curves are host numpy; the
    Wigner matrix products run on `device`."""

    def __init__(self, ivfs, cls_weight, lmax_qlm, resplib=None, fsky=1., cacher=None, *,
                 device):
        from ..utils.cachers import cacher_mem
        self.ivfs = ivfs
        self.device = torch.device(device)
        self.cls_weight = cls_weight
        self.lmax_qlm = lmax_qlm
        self.resplib = resplib
        self.fsky = fsky
        # fsky scales every cached product: it enters the cache names below (and the
        # hashdict), so two libraries sharing one persistent cacher cannot serve each
        # other's spectra (cache-key discipline)
        self._ftag = '' if fsky == 1. else '_fs%.5f' % float(fsky)
        self.cacher = cacher if cacher is not None else cacher_mem()

    def hashdict(self):
        from ..utils.hashing import clhash
        ret = {k: clhash(v) for k, v in self.cls_weight.items()}
        ret['ivfs'] = self.ivfs.hashdict()
        ret['lmax_qlm'] = self.lmax_qlm
        ret['fsky'] = float(self.fsky)   # scales every cached 'anhl_*' product
        return ret

    def _get_qe_derived(self, k):
        if '_bh_' in k:
            from ..utils.cls import cli
            kQE, ksource = k.split('_bh_')
            wL = self.resplib.get_response(kQE, ksource) \
                * cli(self.resplib.get_response(ksource + kQE[1:], ksource))
            return [(kQE, 1.), (ksource + kQE[1:], -wL)]
        return [(k, 1.)]

    def _get_cls(self, idx, spins):
        def cl(a, lmax, alm2=None):
            return ualm.alm2cl(a, lmax, alm2=alm2).cpu().numpy() / self.fsky
        ret = {}
        if 0 in spins:
            t = self.ivfs.get_sim_tlm(idx)
            lmax = ualm.getlmax(t.shape[-1])
            ret['tt'] = cl(t, lmax)
        if 2 in spins:
            e = self.ivfs.get_sim_elm(idx)
            b = self.ivfs.get_sim_blm(idx)
            lmax = ualm.getlmax(e.shape[-1])
            ret['ee'] = cl(e, lmax)
            ret['bb'] = cl(b, lmax)
            ret['eb'] = cl(e, lmax, alm2=b)
        if 0 in spins and 2 in spins:
            ret['te'] = cl(t, lmax, alm2=e)
            ret['tb'] = cl(t, lmax, alm2=b)
        lmaxs = [len(cl) for cl in ret.values()]
        assert len(np.unique(lmaxs)) == 1, lmaxs
        return ret, lmaxs[0] - 1

    def get_sim_nhl(self, idx, k1, k2):
        """Semi-analytic unnormalised N0 of (k1, k2) for simulation idx (idx -1 = data)."""
        assert idx == -1 or idx >= 0, idx
        ret = np.zeros(self.lmax_qlm + 1)
        for k1_, w1 in self._get_qe_derived(k1):
            for k2_, w2 in self._get_qe_derived(k2):
                s1, GC1, s1ins, ksp1 = qresp.qe_spin_data(k1_)
                s2, GC2, s2ins, ksp2 = qresp.qe_spin_data(k2_)
                fn = 'anhl%s_%s_%s_%s%s_%05d' % (self._ftag, ksp1 + k1_[1:],
                                                 ksp2 + k2_[1:], GC1, GC2, idx)
                if not self.cacher.is_cached(fn):
                    cls_ivfs, lmax_ivf = self._get_cls(idx, np.unique(np.concatenate([s1ins, s2ins])))
                    GG, CC, GC, CG = get_nhl(k1_, k2_, self.cls_weight, cls_ivfs,
                                             lmax_ivf, lmax_ivf, lmax_out=self.lmax_qlm,
                                             device=self.device)
                    for gc1, gc2, N0 in [('G', 'G', GG), ('C', 'G', CG), ('G', 'C', GC),
                                         ('C', 'C', CC)]:
                        self.cacher.cache('anhl%s_%s_%s_%s%s_%05d'
                                          % (self._ftag, ksp1 + k1_[1:],
                                             ksp2 + k2_[1:], gc1, gc2, idx), N0)
                ret = ret + w1 * w2 * np.asarray(self.cacher.load(fn))
        return ret
