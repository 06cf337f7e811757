r"""Analytic N0 / Monte-Carlo-correction predictions for inhomogeneous noise (port of
plancklens_tpu/models/patchy.py).

The variance map is split into (approximately) equal-area patches; per-patch responses and
N0s are combined under four filtering/weighting schemes (homogeneous vs inhomogeneous
filtering, with and without inverse-variance spectrum re-weighting)
(reference: plancklens/patchy/patchy.py:13-172). The patches (percentiles over a pixel map)
and the spectra algebra are host numpy, as in the JAX package; the responses and N0s run
on the port's `qresp.get_response` and `nhl.get_nhl`, whose Wigner products run on the
required `device`. Pixel maps may be numpy arrays or tensors. One departure from the JAX
package: `mk_patches`' fiducial level (see there).
"""
import numpy as np

import torch

from ..utils.cls import cli, cl_inverse, cls_dot
from . import nhl as nhl_mod
from . import qresp


def _host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def mk_patches(Np, pix_ivmap, omega_pix, rvmap_uKamin_data=None, method='percentiles',
               ret_masks=False, verbose=False):
    """Split an inverse pixel-variance map into Np noise-level regions.

    Args:
        pix_ivmap: flat array of inverse pixel variances (0 = masked)
        omega_pix: flat array (or scalar) of pixel solid angles [sr]
        method: 'percentiles' (equal sky areas) or 'linear' (equally spaced noise levels)

    Returns:
        (nlevs_filt, nlevs_data, nlev_fid, fskies[, masks])
        (reference: plancklens/patchy/patchy.py:112-172).
    """
    pix_ivmap = _host(pix_ivmap).ravel()
    omega = np.broadcast_to(_host(omega_pix).ravel(), pix_ivmap.shape)
    mask = pix_ivmap > 0
    nlev_map = cli(np.sqrt(pix_ivmap)) * np.sqrt(omega) / np.pi * 60. * 180.
    nlev_map_mask = nlev_map
    if rvmap_uKamin_data is not None:
        rv_dat = _host(rvmap_uKamin_data).ravel()
    if np.unique(nlev_map_mask[mask]).size <= 1:
        assert rvmap_uKamin_data is not None, 'uniform map: provide rvmap_uKamin_data'
        nlev_map_mask = rv_dat
    if method == 'percentiles':
        edges = np.percentile(nlev_map_mask[mask], np.linspace(0, 100, Np + 1))
    elif method == 'linear':
        edges = np.linspace(nlev_map_mask[mask].min(), nlev_map_mask[mask].max(), Np + 1)
    else:
        assert 0, method
    edges[0] = -1.
    edges[-1] = 1e4
    nlevs, nlevs_data, fskies, masks = [], [], [], []
    w = omega / (4. * np.pi)
    for i in range(1, Np + 1):
        this = (nlev_map_mask > edges[i - 1]) & (nlev_map_mask <= edges[i]) & mask
        fsky = np.sum(w * this)
        if fsky > 0:
            nlevs.append(np.sum(w * this * nlev_map) / fsky)
            fskies.append(fsky)
            if rvmap_uKamin_data is not None:
                nlevs_data.append(np.sum(w * this * rv_dat) / fsky)
            if ret_masks:
                masks.append(this)
    if rvmap_uKamin_data is None:
        nlevs_data = list(nlevs)
    # the level of the map's total inverse variance: sum(Omega) / sum(1 / sigma_pix^2) over
    # the unmasked pixels, sigma_pix^2 = nlev^2 / Omega (reference: plancklens/patchy/
    # patchy.py:170, there for equal pixel areas). Departure from the JAX package, whose
    # denominator sum(omega * pix_ivmap) carries an extra pixel area and returns the level
    # over sqrt(mean Omega): 374 uK-arcmin for a uniform 30 uK-arcmin map on gl_geometry(32)
    nlev_fid = np.sqrt(np.sum(omega * mask) / np.sum(pix_ivmap[mask])) * 180. * 60. / np.pi
    if verbose:
        for nf, nd in zip(nlevs, nlevs_data):
            print('%.2f (filt)  %.2f (dat) uK-amin' % (nf, nd))
        print('%.2f (fid)' % nlev_fid)
    out = (nlevs, nlevs_data, nlev_fid, fskies)
    return out + (masks,) if ret_masks else out


def get_fal(a, cl_len, nlev, transf, lmin, lmax):
    """Isotropic 1/(C + N/b^2) filter (reference: patchy.py:178-184)."""
    fal = cli(cl_len.get(a + a)[:lmax + 1]
              + (nlev / 60. / 180. * np.pi) ** 2 / np.asarray(transf)[:lmax + 1] ** 2)
    fal[:lmin] *= 0.
    return fal


def get_ivf_cls(cls_cmb_dat, cls_cmb_filt, lmin, lmax, nlevt_f, nlevp_f, nlevt_m, nlevp_m,
                transf, jt_tp=False):
    """Filtered-map spectra and filtering matrices for given filter/data noise levels
    (reference: patchy.py:187-238)."""
    if not jt_tp:
        ivf_cls, filt_cls_i = {}, {}
        for a, nf, nm in [('t', nlevt_f, nlevt_m)]:
            ivf_cls[a + a] = get_fal(a, cls_cmb_filt, nf, transf, lmin, lmax) ** 2 \
                * cli(get_fal(a, cls_cmb_dat, nm, transf, 0, lmax))
            filt_cls_i[a + a] = get_fal(a, cls_cmb_filt, nf, transf, lmin, lmax)
        for a in ['e', 'b']:
            ivf_cls[a + a] = get_fal(a, cls_cmb_filt, nlevp_f, transf, lmin, lmax) ** 2 \
                * cli(get_fal(a, cls_cmb_dat, nlevp_m, transf, 0, lmax))
            filt_cls_i[a + a] = get_fal(a, cls_cmb_filt, nlevp_f, transf, lmin, lmax)
        ivf_cls['te'] = cls_cmb_dat['te'][:lmax + 1] \
            * get_fal('e', cls_cmb_filt, nlevp_f, transf, lmin, lmax) \
            * get_fal('t', cls_cmb_filt, nlevt_f, transf, lmin, lmax)
        return ivf_cls, filt_cls_i
    # joint TP filtering
    tt = cli(get_fal('t', cls_cmb_filt, nlevt_f, transf, lmin, lmax))
    ee = cli(get_fal('e', cls_cmb_filt, nlevp_f, transf, lmin, lmax))
    bb = cli(get_fal('b', cls_cmb_filt, nlevp_f, transf, lmin, lmax))
    te = np.zeros(lmax + 1)
    te[lmin:] = cls_cmb_filt['te'][lmin:lmax + 1]
    fali = cl_inverse({'tt': tt, 'ee': ee, 'bb': bb, 'te': te})
    dtt = cli(get_fal('t', cls_cmb_dat, nlevt_m, transf, lmin, lmax))
    dee = cli(get_fal('e', cls_cmb_dat, nlevp_m, transf, lmin, lmax))
    dbb = cli(get_fal('b', cls_cmb_dat, nlevp_m, transf, lmin, lmax))
    dte = np.zeros(lmax + 1)
    dte[lmin:] = cls_cmb_dat['te'][lmin:lmax + 1]
    dat = {'tt': dtt, 'ee': dee, 'bb': dbb, 'te': dte}
    ivf = cls_dot([fali, dat, fali], ret_dict=True)
    for cl in ivf.values():
        cl[:lmin] *= 0.
    return ivf, fali


def get_responses(qe_key, cls_cmb_dat, cls_cmb_filt, cls_weight, lmin, lmax, lmax_qlm,
                  transf, nlevts_filt, nlevps_filt, joint_TP=False, cacher=None,
                  source='p', *, device):
    """Responses for a list of filtering noise levels (reference: patchy.py:241-281)."""
    resps = []
    for nt, npp in zip(nlevts_filt, nlevps_filt):
        _, fal = get_ivf_cls(cls_cmb_dat, cls_cmb_filt, lmin, lmax, nt, npp, nt, npp,
                             transf, jt_tp=joint_TP)
        r = qresp.get_response(qe_key, lmax, source, cls_weight, cls_cmb_dat, fal,
                               lmax_qlm=lmax_qlm, device=device)
        resps.append((r[0], r[1]))
    return resps


def get_nhls(qe_key1, qe_key2, cls_cmb_dat, cls_cmb_filt, cls_weight, lmin, lmax,
             lmax_qlm, transf, nlevts_filt, nlevts_map, nlevps_filt, nlevps_map,
             joint_TP=False, cacher=None, *, device):
    """Unnormalised N0s for lists of filtering and data noise levels
    (reference: patchy.py:284-325)."""
    nhls = []
    for ntf, ntm, npf, npm in zip(nlevts_filt, nlevts_map, nlevps_filt, nlevps_map):
        ivf_cls, _ = get_ivf_cls(cls_cmb_dat, cls_cmb_filt, lmin, lmax, ntf, npf,
                                 ntm, npm, transf, jt_tp=joint_TP)
        n = nhl_mod.get_nhl(qe_key1, qe_key2, cls_weight, ivf_cls, lmax, lmax,
                            lmax_out=lmax_qlm, device=device)
        nhls.append((n[0], n[1]))
    return nhls


def get_patchy_N0s(qekey_in, npatches, pixivmap_t, pixivmap_p, omega_pix, cls_unl,
                   cls_cmb_dat, cls_cmb_filt, cls_weight, lmin_ivf, lmax_ivf, lmax_qlm,
                   transf, rvmap_uKamin_t_data=None, rvmap_uKamin_p_data=None,
                   joint_TP=False, nlevt_fid=None, nlevp_fid=None, source='p',
                   patch_method='percentiles', verbose=False, *, device):
    """Effective reconstruction noise under four filtering/weighting schemes, plus the
    multiplicative MC correction predictions (reference: patchy.py:13-111).

    Returns (N0s dict, MCcorr, cMCcorr)."""
    assert qekey_in[0] in ['p', 'x'], 'fix curl fiducial and MC correction'
    qe_key = 'p' + qekey_in[1:]
    if (not joint_TP) and qe_key == 'ptt':
        nt_f, nt_d, _ntfid, fsk = mk_patches(npatches, pixivmap_t, omega_pix,
                                             rvmap_uKamin_data=rvmap_uKamin_t_data,
                                             method=patch_method, verbose=verbose)
        np_f, np_d, _npfid, _ = ([1e30] * len(nt_f), [1e30] * len(nt_d), 1e30, fsk)
    elif (not joint_TP) and qe_key == 'p_p':
        np_f, np_d, _npfid, fsk = mk_patches(npatches, pixivmap_p, omega_pix,
                                             rvmap_uKamin_data=rvmap_uKamin_p_data,
                                             method=patch_method, verbose=verbose)
        nt_f, nt_d, _ntfid, _ = ([1e30] * len(np_f), [1e30] * len(np_d), 1e30, fsk)
    else:
        nt_f, nt_d, _ntfid, fsk = mk_patches(npatches, pixivmap_t, omega_pix,
                                             rvmap_uKamin_data=rvmap_uKamin_t_data,
                                             method=patch_method, verbose=verbose)
        np_f, np_d, _npfid, fsk2 = mk_patches(npatches, pixivmap_p, omega_pix,
                                              rvmap_uKamin_data=rvmap_uKamin_p_data,
                                              method=patch_method, verbose=verbose)
        assert np.allclose(fsk, fsk2, atol=1e-6)
    if nlevt_fid is None:
        nlevt_fid = _ntfid
    if nlevp_fid is None:
        nlevp_fid = _npfid

    cpp = np.copy(cls_unl['pp'][:lmax_qlm + 1])
    rid = 0 if qekey_in[0] == 'p' else 1
    if qekey_in[0] == 'x':
        cpp *= 0.
    rfid = get_responses(qe_key, cls_cmb_dat, cls_cmb_filt, cls_weight, lmin_ivf,
                         lmax_ivf, lmax_qlm, transf, [nlevt_fid], [nlevp_fid],
                         joint_TP=joint_TP, source=source, device=device)[0]
    resps = get_responses(qe_key, cls_cmb_dat, cls_cmb_filt, cls_weight, lmin_ivf,
                          lmax_ivf, lmax_qlm, transf, nt_f, np_f,
                          joint_TP=joint_TP, source=source, device=device)
    nhls_pd = get_nhls(qe_key, qe_key, cls_cmb_dat, cls_cmb_filt, cls_weight, lmin_ivf,
                       lmax_ivf, lmax_qlm, transf, nt_f, nt_d, np_f, np_d,
                       joint_TP=joint_TP, device=device)
    nhls_fd = get_nhls(qe_key, qe_key, cls_cmb_dat, cls_cmb_filt, cls_weight, lmin_ivf,
                       lmax_ivf, lmax_qlm, transf, [nlevt_fid] * len(nt_f), nt_d,
                       [nlevp_fid] * len(np_f), np_d, joint_TP=joint_TP, device=device)
    labels = ['hom-filt, no-rew', 'hom-filt, mv-rew', 'inhom-filt, no-rew',
              'inhom-filt, mv-rew']
    N0s = {q: np.zeros(lmax_qlm + 1, dtype=float) for q in labels}
    MCcorr = np.zeros(lmax_qlm + 1)
    cMCcorr = np.zeros(lmax_qlm + 1)
    fsky_tot = np.sum(fsk)
    rfidi = cli(rfid[rid])
    for fsky, resp, n_pd, n_fd in zip(fsk, resps, nhls_pd, nhls_fd):
        fp = fsky / fsky_tot
        Rp_Rf = resp[rid] * rfidi
        N0s['hom-filt, no-rew'] += fp * (cpp + n_fd[rid] * rfidi ** 2) ** 2
        N0s['inhom-filt, no-rew'] += fp * (Rp_Rf ** 2 * cpp + n_pd[rid] * rfidi ** 2) ** 2
        N0s['hom-filt, mv-rew'] += fp * cli((cpp + n_fd[rid] * rfidi ** 2) ** 2)
        N0s['inhom-filt, mv-rew'] += fp * cli(
            (cpp + n_pd[rid] * rfidi ** 2 * cli(Rp_Rf ** 2)) ** 2)
        MCcorr += fp * Rp_Rf ** 2
        cMCcorr += fp * Rp_Rf
    N0s['hom-filt, mv-rew'] = cli(N0s['hom-filt, mv-rew'])
    N0s['inhom-filt, mv-rew'] = cli(N0s['inhom-filt, mv-rew'])
    N0s['inhom-filt, no-rew'] *= cli(MCcorr ** 2)
    for spec in N0s.values():
        spec[:] = np.sqrt(spec) - cpp
    return N0s, MCcorr, cMCcorr
