r"""Forecast layer: analytic reconstruction-noise curves for the standard estimators, in
torch (port of plancklens_tpu/models/n0s.py).

Capability parity with the reference forecast API (reference: plancklens/n0s.py — get_N0,
get_N0_iter), re-derived around this package's own abstractions:

* :class:`SpectralFilter` — one filtering configuration in the isotropic (spectral)
  approximation: the per-multipole weighting applied to each QE leg plus the covariance
  of the weighted data.  Diagonal (separate-TP), joint (3x3 TEB) and split-leg
  (Wiener-leg T-multipole cut) filtering are all instances of the same container, so the
  N0 assembly below is written once.
* :func:`get_N0` — instrument model -> SpectralFilter(s) -> normalised N0 curves.
* :class:`DelensingForecast` / :func:`get_N0_iter` — the iterated-estimator (MAP) noise
  forecast as a state-carrying fixed-point loop: state = previous unbiased N0 (plus,
  with imperfect-E delensing, the previous partially-lensed sky); each step computes the
  unresolved-lensing fraction, partially-delensed spectra through the built-in
  correlation-function lensing operator (ops/lensed_cls — where the reference leans on
  CAMB), and a single N0 evaluation.

The spectra are host numpy; every response, N0, lensed-spectra and N1 evaluation runs its
products on the required `device` (f64).
"""
import os
import numpy as np
import torch

from .. import DATAPATH
from ..utils.cls import (camb_clfile, cli, cls_dot, cl_inverse, clpp_to_cldd,
                         cldd_to_clpp)
from ..ops.lensed_cls import lensed_cls
from . import nhl, qresp

_ARCMIN = np.pi / 180. / 60.


def gauss_beam(fwhm_amin, lmax):
    """Gaussian beam transfer function for a FWHM given in arcminutes
    (reference: plancklens_tpu/models/n0s.py:31-35)."""
    ls = np.arange(lmax + 1)
    sigma2 = (fwhm_amin * _ARCMIN / np.sqrt(8. * np.log(2.))) ** 2
    return np.exp(-0.5 * ls * (ls + 1) * sigma2)


def _default_cls(lmax=None):
    return camb_clfile(os.path.join(DATAPATH, 'cls',
                                    'FFP10_wdipole_lensedCls.dat'), lmax=lmax)


def _per_field(value, floor=None):
    """Broadcast a scalar (or pass through a dict) to a per-field {'t','e','b'} map."""
    if isinstance(value, dict):
        return dict(value)
    v = int(value) if floor is None else max(int(value), floor)
    return {f: v for f in 'teb'}


def _pol_nlevs(nlev_p):
    """Split a polarisation noise level into (E, B) components; a (2, ...) array —
    including a plain (E, B) scalar pair — gives them separately, anything else is
    shared."""
    arr = np.atleast_1d(np.asarray(nlev_p, dtype=float))
    if arr.shape[0] == 2 and arr.ndim <= 2:
        # a length-2 first axis is an (E, B) split: a 2-entry *L-array* of noise
        # levels has no sensible meaning, so the pair reading is unambiguous
        return arr[0], arr[1]
    return arr.squeeze(), arr.squeeze()


def _bandpass(cls, lmins, lmaxs):
    """Zero every spectrum outside its per-field multipole band (in place)."""
    for k, cl in cls.items():
        cl[:max(lmins[k[0]], lmins[k[1]])] = 0.
        cl[min(lmaxs[k[0]], lmaxs[k[1]]) + 1:] = 0.
    return cls


class SpectralFilter:
    """One filtering configuration in the isotropic approximation.

    Attributes:
        wgrad: per-multipole weighting applied to the gradient QE leg (a diagonal dict
            for separate-TP filtering, 3x3 TEB-inverse entries for joint filtering)
        wwf: weighting applied to the Wiener leg; identical to ``wgrad`` unless a
            Wiener-leg T-multipole cut is in force
        cov: filtered-data covariances for each ordered leg pairing, keyed
            'gg', 'gw', 'wg', 'ww' (g = gradient leg, w = Wiener leg)
    """

    def __init__(self, wgrad, wwf, cov):
        self.wgrad = wgrad
        self.wwf = wwf
        self.cov = cov

    @staticmethod
    def _covs(wa, wb, cls_dat):
        if wb is wa:
            c = cls_dot([wa, cls_dat, wa], ret_dict=True)
            return {'gg': c, 'gw': c, 'wg': c, 'ww': c}
        return {'gg': cls_dot([wa, cls_dat, wa], ret_dict=True),
                'gw': cls_dot([wa, cls_dat, wb], ret_dict=True),
                'wg': cls_dot([wb, cls_dat, wa], ret_dict=True),
                'ww': cls_dot([wb, cls_dat, wb], ret_dict=True)}

    @classmethod
    def separate(cls, cls_filt, cls_dat, wf_tcut=None):
        """Independent T/E/B filtering (diagonal pseudo-inverse weights)."""
        w = {k: cli(cls_filt[k]) for k in ('tt', 'ee', 'bb')}
        wb = w
        if wf_tcut is not None:
            wb = {k: v.copy() for k, v in w.items()}
            wb['tt'][wf_tcut + 1:] = 0.
        return cls(w, wb, cls._covs(w, wb, cls_dat))

    @classmethod
    def joint(cls, cls_filt, cls_dat, wf_tcut=None):
        """Joint TEB filtering (per-multipole 3x3 pseudo-inverse weights)."""
        w = cl_inverse(cls_filt)
        wb = w
        if wf_tcut is not None:
            capped = {k: np.copy(v) for k, v in cls_dat.items()}
            for k in capped:
                if 't' in k:
                    capped[k][wf_tcut + 1:] = 0.
            wb = cl_inverse(capped)
        return cls(w, wb, cls._covs(w, wb, cls_dat))


def normalised_n0(qe_key, filt, ksource, cls_weight, cls_cmb, lmax_ivf, lmax_qlm, *,
                  device):
    """(gradient, curl) response-normalised N0 for one QE key under one filtering
    configuration."""
    ngg, ncc = nhl.get_nhl(qe_key, qe_key, cls_weight, filt.cov['gg'], lmax_ivf,
                           lmax_ivf, lmax_out=lmax_qlm, cls_ivfs_ab=filt.cov['gw'],
                           cls_ivfs_ba=filt.cov['wg'], cls_ivfs_bb=filt.cov['ww'],
                           device=device)[:2]
    rgg, rcc = qresp.get_response(qe_key, lmax_ivf, ksource, cls_weight, cls_cmb,
                                  filt.wgrad, lmax_qlm=lmax_qlm, fal_leg2=filt.wwf,
                                  device=device)[:2]
    return ngg * cli(rgg ** 2), ncc * cli(rcc ** 2)


def get_N0(beam_fwhm=1.4, nlev_t=5., nlev_p=None, lmax_CMB=3000, lmin_CMB=100,
           lmax_out=None, cls_filt=None, cls_len=None, cls_weight=None, cls_sky=None,
           joint_TP=True, ksource='p', wfleg_Tcut=None, *, device):
    """Normalised N0 curves (gradient and curl) for [ksource+'tt', ksource+'_p'] and the
    MV/GMV ksource key.  Returns (N0s, N0_curls) dicts keyed by QE key.

    lmax_CMB / lmin_CMB may be scalars or {'t','e','b'} dicts for per-field cuts;
    wfleg_Tcut restricts T multipoles on the Wiener leg only (gradient cleaning); the
    responses and N0s run on `device`."""
    if nlev_p is None:
        nlev_p = nlev_t * np.sqrt(2.)
    nlev_e, nlev_b = _pol_nlevs(nlev_p)
    lmaxs = _per_field(lmax_CMB)
    lmins = _per_field(lmin_CMB, floor=1)
    lmax_ivf = max(lmaxs.values())
    lmax_qlm = lmax_out or lmax_ivf

    cls_len = cls_len or _default_cls()
    cls_weight = cls_weight or _default_cls()

    transf = gauss_beam(beam_fwhm, lmax_ivf)
    noise = {'tt': (np.asarray(nlev_t) * _ARCMIN) ** 2 / transf ** 2,
             'ee': (np.asarray(nlev_e) * _ARCMIN) ** 2 / transf ** 2,
             'bb': (np.asarray(nlev_b) * _ARCMIN) ** 2 / transf ** 2}

    def observed(sky):
        obs = {k: sky[k][:lmax_ivf + 1] + noise[k] for k in noise}
        obs['te'] = np.copy(sky['te'][:lmax_ivf + 1])
        return _bandpass(obs, lmins, lmaxs)

    obs_model = observed(cls_filt or _default_cls())
    obs_data = observed(cls_sky or _default_cls())
    tcut = wfleg_Tcut if (wfleg_Tcut is not None and wfleg_Tcut < lmaxs['t']) else None
    filt_diag = SpectralFilter.separate(obs_model, obs_data, wf_tcut=tcut)
    filt_mv = SpectralFilter.joint(obs_model, obs_data, wf_tcut=tcut) if joint_TP \
        else filt_diag

    N0s, N0_curls = {}, {}
    for qe_key, filt in ((ksource + 'tt', filt_diag), (ksource + '_p', filt_diag),
                         (ksource, filt_mv)):
        N0s[qe_key], N0_curls[qe_key] = normalised_n0(
            qe_key, filt, ksource, cls_weight, cls_len, lmax_ivf, lmax_qlm, device=device)
    return N0s, N0_curls


class DelensingForecast:
    r"""Iterated-QE lensing-noise forecast (reference capability: plancklens/n0s.py
    get_N0_iter), as a state-carrying fixed-point loop.

    Each :meth:`step` call advances one iteration:

        N0  ->  unresolved-lensing fraction  ->  partially-delensed spectra  ->  N0'

    The loop state is the previous unbiased gradient N0 and — in the imperfect-E
    (``filter_E``) linear-delensing mode — the previous partially-lensed true sky, which
    sets the Wiener filter of the E modes sourcing the removable B template.
    """

    def __init__(self, qe_key, nlev_t, nlev_p, beam_fwhm, cls_unl_fid, lmin_ivf,
                 lmax_ivf, cls_unl_dat=None, lmax_qlm=None, datnoise_cls=None,
                 unlQE=False, rho_sqd_ext=0., filter_E=False, include_n1=False,
                 n1_lmax=None, n1_kwargs=None, *, device):
        """include_n1: fold the N1 bias into the iteration — the reconstruction noise
        degrading the delensing efficiency becomes N0 + N1, with N1 evaluated each
        iteration by the in-house flat-sky integrator (models/n1.N1Lib) against the
        current residual-lensing spectrum. The reference only offers this through the
        external `lensitbiases` package (reference: plancklens/nhl.py:296,310-381 —
        rho^2 uses N0_unbiased + N1_unbiased); here it is self-contained.
        n1_lmax caps the (splined) N1 evaluation; n1_kwargs feed N1Lib (dL, lps, ...).
        device: where the lensed spectra, responses, N0s and N1s are evaluated."""
        self.device = torch.device(device)
        assert qe_key in ('p_p', 'p', 'ptt'), qe_key
        self.key = qe_key
        self.lmaxs = _per_field(lmax_ivf)
        self.lmins = _per_field(lmin_ivf, floor=1)
        self.lmax_cmb = max(self.lmaxs.values())
        self.unl_fid = cls_unl_fid
        self.unl_true = cls_unl_fid if cls_unl_dat is None else cls_unl_dat
        self.fid_is_true = cls_unl_dat is None
        self.unl_weights = unlQE
        self.wiener_E = filter_E
        if filter_E:
            assert qe_key == 'p_p', 'filter_E is a polarisation-delensing option'

        dd_fid = clpp_to_cldd(cls_unl_fid['pp'])
        lq = lmax_qlm if lmax_qlm is not None else 2 * self.lmax_cmb
        self.lmax_rec = min(lq, 2 * self.lmax_cmb, len(dd_fid) - 1)

        inv_beam2 = cli(gauss_beam(beam_fwhm, self.lmax_cmb)) ** 2
        nlev_e, nlev_b = _pol_nlevs(nlev_p)
        self.noise_filt = {}
        if qe_key in ('ptt', 'p'):
            self.noise_filt['tt'] = (nlev_t * _ARCMIN) ** 2 * inv_beam2
        if qe_key in ('p_p', 'p'):
            self.noise_filt['ee'] = (nlev_e * _ARCMIN) ** 2 * inv_beam2
            self.noise_filt['bb'] = (nlev_b * _ARCMIN) ** 2 * inv_beam2
        self.noise_dat = dict(self.noise_filt) if datnoise_cls is None else datnoise_cls
        self.rho2_ext = rho_sqd_ext if np.isscalar(rho_sqd_ext) \
            else np.asarray(rho_sqd_ext)[:self.lmax_rec + 1]

        # deflection-band conversion factor: C_L^pp-convention N0 -> 'D' deflection noise
        ls = np.arange(self.lmax_rec + 1, dtype=float)
        self._n0_to_dd = (ls * (ls + 1.)) ** 2 / (2. * np.pi)

        # fully-lensed skies: the baseline the imperfect-E delensing delta is subtracted
        # from, and the iteration-0 previous-sky state
        self._len_fid = self._lens(cls_unl_fid, dd_fid)
        self._len_true = self._len_fid if self.fid_is_true else \
            self._lens(self.unl_true, clpp_to_cldd(self.unl_true['pp']))
        self._sky_true = self._len_true   # previous partially-lensed true sky (state)
        self._n0_grad = None              # previous unbiased gradient N0 (state)
        self.include_n1 = include_n1
        if include_n1:
            assert not filter_E, 'include_n1 with filter_E is not supported'
        self._n1_lmax = min(n1_lmax if n1_lmax is not None else self.lmax_rec,
                            self.lmax_rec)
        self._n1_kwargs = dict(n1_kwargs or {})
        self._n1_grad = None              # previous unbiased gradient N1 (state)
        self.last_n1 = None               # (N1_biased, N1_unbiased) of the last step

    # ---- building blocks -------------------------------------------------------------

    def _lens(self, unl, cldd, delta=False):
        return lensed_cls(unl, cldd_to_clpp(cldd), delta_cls=delta,
                          lmax_out=min(len(unl['tt']) - 1, self.lmax_cmb + 500),
                          device=self.device)

    def _residual_fraction(self):
        """Fraction of the deflection power the combined (internal QE + external tracer)
        lensing estimate leaves unresolved, per L.  Before the first N0 exists only the
        external tracer delenses."""
        if self._n0_grad is None:
            r2 = np.atleast_1d(np.asarray(self.rho2_ext, dtype=float))
            if r2.size == 1:
                return 1. - float(r2[0])
            # array rho2_ext: return the FULL-clpp-length residual (ones beyond the
            # reconstruction band), matching the later-iteration convention — a bare
            # (lmax_rec+1)-length return broke the dd_fid * resid broadcast at step 0
            resid = np.ones(len(self.unl_true['pp']))
            n = min(len(resid), self.lmax_rec + 1, r2.size)
            resid[:n] = 1. - r2[:n]
            return resid
        dd_true = clpp_to_cldd(self.unl_true['pp'])
        noise = np.copy(self._n0_grad[:self.lmax_rec + 1])
        if self._n1_grad is not None:   # include_n1: noise degrading the delensing
            noise += self._n1_grad[:self.lmax_rec + 1]
        dd_noise = self._n0_to_dd * noise
        keep = (1. - self.rho2_ext) * dd_noise
        den = (1. - self.rho2_ext) * dd_true[:self.lmax_rec + 1] + dd_noise
        resid = np.ones(len(dd_true))
        resid[:self.lmax_rec + 1] = np.where(den > 0, keep * cli(den), 1.)
        return resid

    def _delensed_skies(self, resid):
        """Partially-delensed fiducial and true spectra plus the deflection spectra to
        report alongside them, given the unresolved-lensing fraction ``resid``.

        In the standard mode the reported deflection is the residual; in the imperfect-E
        mode it is the *resolved* spectrum (the reference's filter_E convention,
        reference n0s.py:373-374)."""
        dd_fid = clpp_to_cldd(self.unl_fid['pp'])
        dd_true = clpp_to_cldd(self.unl_true['pp'])
        if not self.wiener_E:
            dd_fid = dd_fid * resid
            dd_true = dd_true * resid
            sky_fid = self._lens(self.unl_fid, dd_fid)
            sky_true = {k: np.copy(v) for k, v in sky_fid.items()} if self.fid_is_true \
                else self._lens(self.unl_true, dd_true)
            return sky_fid, sky_true, dd_fid, dd_true
        # imperfect-E linear delensing: the removable BB is sourced only by the
        # Wiener-filtered part of E (filter set by the *previous* partially-lensed true
        # sky) and the resolved part of the deflection; that delta is subtracted from the
        # fully-lensed baseline
        band = slice(self.lmins['e'], self.lmaxs['e'] + 1)
        rho2_E = np.zeros(len(self.unl_true['ee']))
        rho2_E[band] = self.unl_true['ee'][band] * cli(
            self._sky_true['ee'][band] + self.noise_dat['ee'][band])
        wf_fid = dict(self.unl_fid)
        wf_fid['ee'] = self.unl_fid['ee'] * rho2_E[:len(self.unl_fid['ee'])]
        wf_true = dict(self.unl_true)
        wf_true['ee'] = self.unl_true['ee'] * rho2_E[:len(self.unl_true['ee'])]
        dd_fid = dd_fid * (1. - resid)
        dd_true = dd_true * (1. - resid)
        d_fid = self._lens(wf_fid, dd_fid, delta=True)
        d_true = self._lens(wf_true, dd_true, delta=True)
        sky_fid = {k: self._len_fid[k] - d_fid[k] for k in d_fid}
        sky_true = {k: self._len_true[k] - d_true[k] for k in d_true}
        return sky_fid, sky_true, dd_fid, dd_true

    def _qe_noise(self, sky_fid, sky_true):
        """One N0 evaluation against the current partially-delensed skies: the raw
        Gaussian noise plus the fiducial and true responses (gradient, curl)."""
        weights = self.unl_fid if self.unl_weights else sky_fid
        lmax = self.lmax_cmb
        model, obs = {}, {}
        if self.key in ('ptt', 'p'):
            model['tt'] = weights['tt'][:lmax + 1] + self.noise_filt['tt']
            obs['tt'] = sky_true['tt'][:lmax + 1] + self.noise_dat['tt']
        if self.key in ('p_p', 'p'):
            model['ee'] = weights['ee'][:lmax + 1] + self.noise_filt['ee']
            model['bb'] = weights['bb'][:lmax + 1] + self.noise_filt['bb']
            obs['ee'] = sky_true['ee'][:lmax + 1] + self.noise_dat['ee']
            obs['bb'] = sky_true['bb'][:lmax + 1] + self.noise_dat['bb']
        if self.key == 'p':
            model['te'] = np.copy(weights['te'][:lmax + 1])
            obs['te'] = np.copy(sky_true['te'][:lmax + 1])
        for d in (model, obs):
            for k, cl in d.items():
                cl[min(self.lmaxs[k[0]], self.lmaxs[k[1]]) + 1:] = 0.
        wmat = cl_inverse(model)
        for d in (wmat, obs):
            for k, cl in d.items():
                cl[:max(self.lmins[k[0]], self.lmins[k[1]])] = 0.
        fcov = cls_dot([wmat, obs, wmat], ret_dict=True)

        ngg, ncc = nhl.get_nhl(self.key, self.key, weights, fcov, lmax, lmax,
                               lmax_out=self.lmax_rec, device=self.device)[:2]
        rg_true, rc_true = qresp.get_response(self.key, lmax, 'p', weights, sky_true,
                                              wmat, lmax_qlm=self.lmax_rec,
                                              device=self.device)[:2]
        if self.fid_is_true and not self.unl_weights:
            rg_fid, rc_fid = rg_true, rc_true   # delensed true sky == weight spectra
        else:
            rg_fid, rc_fid = qresp.get_response(self.key, lmax, 'p', weights, weights,
                                                wmat, lmax_qlm=self.lmax_rec,
                                                device=self.device)[:2]
        return (ngg, ncc), (rg_fid, rc_fid), (rg_true, rc_true), (weights, wmat)

    def _n1_raw(self, weights, wmat, pp_resid_true):
        """Unnormalised N1 of the key against the current residual-lensing spectrum,
        evaluated by the in-house flat-sky integrator on its sparse L grid and splined
        (models/n1.py; reference capability: plancklens/nhl.py:369-379 via external
        lensitbiases). Normalisation by the response^2 happens in step()."""
        from .n1 import N1Lib
        lmax = self.lmax_cmb
        zero = np.zeros(lmax + 1)
        kwargs = dict(self._n1_kwargs)
        kwargs.setdefault('lmaxphi', min(2 * self.lmax_cmb, 2500))
        lib = N1Lib(weights.get('tt', zero)[:lmax + 1],
                    weights.get('te', zero)[:lmax + 1],
                    weights.get('ee', zero)[:lmax + 1], device=self.device, **kwargs)
        Lmax = self._n1_lmax
        if self.key == 'p':   # joint 3x3 filtering: matrix-weighted kernel sum
            n1 = lib.get_n1_jtp('p', 'p', pp_resid_true, wmat, Lmax)
        else:
            ftl = wmat.get('tt', zero)[:lmax + 1]
            fel = wmat.get('ee', zero)[:lmax + 1]
            fbl = wmat.get('bb', zero)[:lmax + 1]
            n1 = lib.get_n1(self.key, 'p', pp_resid_true, ftl, fel, fbl, Lmax)
        out = np.zeros(self.lmax_rec + 1)
        out[:Lmax + 1] = n1[:Lmax + 1]
        return out

    # ---- the iteration ---------------------------------------------------------------

    def step(self):
        """Advance one iteration.  Returns (N0_grad_biased, N0_grad_unbiased,
        N0_curl_biased, N0_curl_unbiased, delensed_fid_cls, delensed_true_cls); the
        delensed dicts include the reported 'pp' spectrum."""
        resid = self._residual_fraction()
        sky_fid, sky_true, dd_fid, dd_true = self._delensed_skies(resid)
        (ngg, ncc), (rg_fid, rc_fid), (rg_true, rc_true), (weights, wmat) = \
            self._qe_noise(sky_fid, sky_true)
        self._n0_grad = ngg * cli(rg_true ** 2)
        self._sky_true = sky_true
        sky_fid['pp'] = cldd_to_clpp(dd_fid)
        sky_true['pp'] = cldd_to_clpp(dd_true)
        if self.include_n1:
            n1_raw = self._n1_raw(weights, wmat, np.copy(sky_true['pp']))
            self._n1_grad = n1_raw * cli(rg_true ** 2)
            self.last_n1 = (n1_raw * cli(rg_fid ** 2), self._n1_grad)
        return (ngg * cli(rg_fid ** 2), self._n0_grad,
                ncc * cli(rc_fid ** 2), ncc * cli(rc_true ** 2), sky_fid, sky_true)


def get_N0_iter(qe_key, nlev_t, nlev_p, beam_fwhm, cls_unl_fid, lmin_ivf, lmax_ivf,
                itermax, cls_unl_dat=None, lmax_qlm=None, ret_delcls=False,
                datnoise_cls=None, unlQE=False, rho_sqd_ext=0., filter_E=False,
                ret_curl=False, include_n1=False, n1_lmax=None, n1_kwargs=None, *,
                device):
    """Iterative (MAP-estimator forecast) lensing N0 (reference capability:
    plancklens/n0s.py get_N0_iter); see :class:`DelensingForecast` for the loop design.

    Args beyond the obvious:
        lmin_ivf / lmax_ivf: scalars, or {'t','e','b'} dicts for per-field cuts
        cls_unl_dat: true sky spectra when different from the fiducial
        datnoise_cls: custom data noise spectra (the nlevs then only enter the filter)
        unlQE: weight/filter with unlensed instead of (partially) lensed spectra
        rho_sqd_ext: squared cross-correlation of an external delensing tracer (scalar
            or array over L); rho -> 1 removes all lensing not already removed internally
        filter_E: linear delensing with the B template from Wiener-filtered *lensed* E
            (imperfect E knowledge) instead of assuming E known perfectly.  In this mode
            the returned 'pp' follows the reference convention and holds the *resolved*
            deflection spectrum, not the residual.
        ret_curl: also return the curl-mode N0s
        include_n1: fold N1 into the iterations (self-contained, via models/n1.N1Lib —
            the reference needs the external lensitbiases package for this); the
            iterated N1 curves are then appended to the return value
        device: where the lensed spectra, responses, N0s and N1s are evaluated

    Returns (N0s_biased, N0s_unbiased[, N0s_unbiased_curl, N0s_biased_curl]
    [, delcls_fid, delcls_true][, N1s_biased, N1s_unbiased]); N0/N1 arrays have shape
    (itermax+1, lmax_qlm+1).
    """
    fc = DelensingForecast(qe_key, nlev_t, nlev_p, beam_fwhm, cls_unl_fid, lmin_ivf,
                           lmax_ivf, cls_unl_dat=cls_unl_dat, lmax_qlm=lmax_qlm,
                           datnoise_cls=datnoise_cls, unlQE=unlQE,
                           rho_sqd_ext=rho_sqd_ext, filter_E=filter_E,
                           include_n1=include_n1, n1_lmax=n1_lmax, n1_kwargs=n1_kwargs,
                           device=device)
    rows = []
    n1_rows = []
    for _ in range(itermax + 1):
        rows.append(fc.step())
        if include_n1:
            n1_rows.append(fc.last_n1)
    biased, unbiased, biased_cc, unbiased_cc, del_fid, del_true = map(list, zip(*rows))
    ret = (np.array(biased), np.array(unbiased))
    if ret_curl:
        ret = ret + (np.array(unbiased_cc), np.array(biased_cc))
    if ret_delcls:
        ret = ret + (del_fid, del_true)
    if include_n1:
        n1_biased, n1_unbiased = map(list, zip(*n1_rows))
        ret = ret + (np.array(n1_biased), np.array(n1_unbiased))
    return ret
