r"""Band-power construction (port of plancklens_tpu/models/bandpowers.py; capability
surface of reference plancklens/bandpowers.py).

ffp10-style binner: fiducial-C_L^kk-weighted bins, data band-powers, MCN0 (2<ss>), RDN0
(4<ds> - 2<ss>), semi-analytic N0, analytic N1, point-source correction, additive and
multiplicative MC corrections, covariance matrices, and cross-to-input amplitude.

Design: the entire binning operation is precomputed once as a dense (nbins, lmaxphi+1)
weight matrix `_bmat` (inverse-variance weights along the fiducial C_L^kk shape within each
bin), so every band-power evaluation downstream is a single matrix-vector product. Debiased
band-powers all flow through one `_normed_bp` helper (response-normalise, then bin).

Host numpy over the port's spectra; the one tensor call, the stt response of
`get_ps_data` (nhl.get_nhl), runs on the device of the parfile's `qresp_dd`.

The `parfile` argument is any namespace carrying the pipeline libraries (the reference uses
an imported parameter-file module; a types.SimpleNamespace or dataclass works here):
  qcls_dd, qcls_ds, qcls_ss  -- QeClLib instances (data x data, data x sim, sim x sim legs)
  qresp_dd                   -- RespLib
  nhl_dd                     -- NhlLib (semi-analytic covariance); optional
  n1_dd                      -- N1Lib; optional
  ivfs                       -- filtering library (for N1/PS filter arrays)
  mc_sims_var, mc_sims_bias  -- sim index arrays
  qlms_x_in                  -- cross-to-input spectra library; optional
"""
import os
import numpy as np

from .. import DATAPATH
from ..utils.cls import camb_clfile, cli
from .qecl import stats
from . import nhl as nhl_mod

# Planck 2018 bin-edge tables (reference: plancklens/bandpowers.py:14-40)
_BIN_EDGES = {
    'consext8': ([8, 41, 85, 130, 175, 220, 265, 310, 355],
                 [40, 84, 129, 174, 219, 264, 309, 354, 400]),
    'agr2': ([8, 21, 40, 66, 101, 145, 199, 264, 339, 426, 526, 638, 763, 902],
             [20, 39, 65, 100, 144, 198, 263, 338, 425, 525, 637, 762, 901, 2048]),
    'xdip': ([8, 264, 902], [263, 901, 2048]),
    'pdip': ([8, 101, 426], [100, 425, 2048]),
    'lowl': ([2, 7], [8, 40]),
}


def get_blbubc(bin_type):
    """(lower edges, upper edges, centers) for a named or 'e0_e1_..._en' bin layout."""
    if bin_type in _BIN_EDGES:
        bins_l, bins_u = (np.array(v) for v in _BIN_EDGES[bin_type])
    elif bin_type == '1_10_unb':
        bins_l = np.arange(1, 11)
        bins_u = bins_l
    elif '_' in bin_type:
        edges = np.array(bin_type.split('_'), dtype=int)
        bins_l, bins_u = edges[:-1], edges[1:] - 1
        bins_u[-1] += 1
    else:
        assert 0, bin_type + ' not implemented'
    return bins_l, bins_u, 0.5 * (bins_l + bins_u)


def _load_fid_clpp(lmax=None):
    path = os.path.join(DATAPATH, 'cls', 'FFP10_wdipole_lenspotentialCls.dat')
    clpp = camb_clfile(path)['pp']
    return clpp if lmax is None else clpp[:lmax + 1]


class Binner:
    """FFP10-cosmology band-power builder (reference behaviour:
    plancklens/bandpowers.py:43-360)."""

    def __init__(self, k1, k2, parfile, btype, ksource='p', lmaxphi=2048):
        Ls = np.arange(lmaxphi + 1, dtype=float)
        if ksource == 'p':
            # potential -> convergence-band conversion 1e7 L^2(L+1)^2 / 2pi
            kswitch = (Ls * (Ls + 1.)) ** 2 * (1e7 / (2. * np.pi))
            if k1[0] == 'p' and k2[0] == 'p':
                clpp_fid = _load_fid_clpp(lmaxphi)
            elif k1[0] == 'x' and k2[0] == 'x':
                clpp_fid = np.ones(lmaxphi + 1, dtype=float)
            else:
                assert 0, 'not implemented'
        else:
            kswitch = np.ones(lmaxphi + 1, dtype=float)
            clpp_fid = np.ones(lmaxphi + 1, dtype=float)
        clkk_fid = clpp_fid * kswitch

        qc_resp = (parfile.qresp_dd.get_response(k1, ksource)[:lmaxphi + 1]
                   * parfile.qresp_dd.get_response(k2, ksource)[:lmaxphi + 1])
        # per-L inverse variance of the normalised kk spectrum estimate
        ivar = qc_resp * (2. * np.arange(lmaxphi + 1) + 1.) * cli(kswitch) ** 2 \
            * (0.5 * getattr(parfile.qcls_dd, 'fsky1234', 1.))

        bin_lmins, bin_lmaxs, _ = get_blbubc(btype)
        nbins = len(bin_lmins)
        # bin membership masks, then the raw (un-normalised) weight rows w_i(L)
        in_bin = (np.arange(lmaxphi + 1)[None, :] >= bin_lmins[:, None]) \
            & (np.arange(lmaxphi + 1)[None, :] <= bin_lmaxs[:, None])
        w_raw = in_bin * (ivar * clkk_fid * kswitch)[None, :]
        denom = np.array([np.sum((clkk_fid ** 2 * ivar)[m]) for m in in_bin])

        # multipole assigned to each bin: weight-averaged L with an extra 1/(L(L+1))^2
        # flattening (kk-spectrum shape) inside the average
        flat = cli(Ls * (Ls + 1.)) ** 2
        lav = np.array([np.sum(Ls[m] * (flat * w_raw[i])[m]) / np.sum((flat * w_raw[i])[m])
                        for i, m in enumerate(in_bin)])
        fid_bp = np.interp(lav, Ls, clkk_fid)

        self.k1, self.k2, self.ksource, self.parfile = k1, k2, ksource, parfile
        self.nbins = nbins
        self.bin_lmins, self.bin_lmaxs, self.bin_lavs = bin_lmins, bin_lmaxs, lav
        self.fid_bandpowers = fid_bp
        self.clkk_fid, self.kswitch = clkk_fid, kswitch
        self.lmaxphi = lmaxphi
        # final binning matrix: band-powers = _bmat @ cl_pp (cl in potential convention)
        self._bmat = (fid_bp / denom)[:, None] * w_raw

    def _get_bil(self, i, L):
        """Row i of the binning matrix at multipoles L (kept for parity with the
        reference's per-L accessor)."""
        L = np.asarray(L, dtype=int)
        return self._bmat[i, L]

    def _get_binnedcl(self, cl):
        assert len(cl) > self.bin_lmaxs[-1], (len(cl), self.bin_lmaxs[-1])
        return self._bmat @ np.asarray(cl)[:self.lmaxphi + 1]

    def _qc_resp(self, k1=None, k2=None):
        k1 = self.k1 if k1 is None else k1
        k2 = self.k2 if k2 is None else k2
        return (self.parfile.qresp_dd.get_response(k1, self.ksource)
                * self.parfile.qresp_dd.get_response(k2, self.ksource))

    def _normed_bp(self, cl_unnormed):
        """Bin a response-unnormalised qlm spectrum."""
        return self._get_binnedcl(cli(self._qc_resp()) * cl_unnormed)

    def _stats_mean(self, qcls, sims=None):
        sims = self.parfile.mc_sims_var if sims is None else sims
        return qcls.get_sim_stats_qcl(self.k1, sims, k2=self.k2).mean()

    def get_fid_bandpowers(self):
        return np.copy(self.fid_bandpowers)

    def get_dat_bandpowers(self):
        """Raw data band-powers, before bias subtraction."""
        return self._normed_bp(self.parfile.qcls_dd.get_sim_qcl(self.k1, -1, k2=self.k2))

    def get_mcn0(self):
        """Monte-Carlo N0: 2 <ss>."""
        return self._normed_bp(2. * self._stats_mean(self.parfile.qcls_ss))

    def get_rdn0(self):
        """Realisation-dependent N0: 4 <ds> - 2 <ss>."""
        return self._normed_bp(4. * self._stats_mean(self.parfile.qcls_ds)
                               - 2. * self._stats_mean(self.parfile.qcls_ss))

    def get_dat_nhl(self):
        """Semi-analytic N0 of the data realisation."""
        return self._normed_bp(self.parfile.nhl_dd.get_sim_nhl(-1, self.k1, self.k2))

    def get_n1(self, k1=None, k2=None, unnormed=False):
        """Analytic N1 bias."""
        k1 = self.k1 if k1 is None else k1
        k2 = self.k2 if k2 is None else k2
        assert k1 == k2, 'check signs for QEs of different spins'
        assert self.ksource[0] == 'p', 'check aniso source spectrum'
        ivfs = self.parfile.ivfs
        qc_resp = self._qc_resp(k1, k2)
        n1pp = self.parfile.n1_dd.get_n1(k1, self.ksource, _load_fid_clpp(),
                                         ivfs.get_ftl(), ivfs.get_fel(), ivfs.get_fbl(),
                                         len(qc_resp) - 1, kB=k2)
        return self._get_binnedcl(cli(qc_resp) * n1pp) if not unnormed else n1pp

    def get_ps_data(self, lmin_ss_s4=100, lmax_ss_s4=2048, mc_sims_ss=None, mc_sims_ds=None):
        """Point-source 4-point amplitude pieces (math as reference
        plancklens/bandpowers.py:212-269).

        The stt trispectrum amplitude is fit over [lmin_ss_s4, lmax_ss_s4] with
        (2L+1)-weighting against the squared stt response; returns
        (band_dat, band_check, band_syst, sim_stats, Cs2s2, pp_cl_ps).
        """
        ks4 = 'stt'
        pf = self.parfile
        sl = slice(lmin_ss_s4, lmax_ss_s4 + 1)
        twolpo = 2. * np.arange(lmax_ss_s4 + 1) + 1.

        def _s4mean(qcls, sims):
            return qcls.get_sim_stats_qcl(ks4, sims).mean()[:lmax_ss_s4 + 1]

        dd = _s4mean(pf.qcls_dd, pf.mc_sims_var)
        ds = _s4mean(pf.qcls_ds, pf.mc_sims_bias if mc_sims_ds is None else mc_sims_ds)
        ss = _s4mean(pf.qcls_ss, pf.mc_sims_bias if mc_sims_ss is None else mc_sims_ss)
        dat = pf.qcls_dd.get_sim_qcl(ks4, -1)[:lmax_ss_s4 + 1]

        ftl = pf.ivfs.get_ftl()
        resp_s4 = nhl_mod.get_nhl(ks4, ks4, {}, {'tt': ftl}, len(ftl) - 1, len(ftl) - 1,
                                  lmax_out=lmax_ss_s4, device=pf.qresp_dd.device)[0] ** 2
        norm = 4.0 / np.sum(4.0 * (twolpo * resp_s4)[sl])

        s4_dat = norm * twolpo * (dat - 4. * ds + 2. * ss)      # RDN0-debiased data
        s4_check = norm * twolpo * (dd - 2. * ss)               # MCN0-debiased sims
        s4_syst = norm * twolpo * 4. * (ds - ss)                # ds/ss consistency
        s4_n1 = norm * twolpo * self.get_n1(k1=ks4, k2=ks4, unnormed=True)[:lmax_ss_s4 + 1]
        s4_prim = norm * twolpo * (pf.qresp_dd.get_response(ks4, self.ksource)[
            :lmax_ss_s4 + 1] ** 2 * _load_fid_clpp(lmax_ss_s4))

        band_dat = np.sum((s4_dat - s4_prim - s4_n1)[sl])
        band_check = np.sum((s4_check - s4_prim - s4_n1)[sl])
        band_syst = np.abs(np.sum(s4_syst[sl]))
        Cs2s2 = (s4_dat - s4_prim - s4_n1) * cli(twolpo) / norm * cli(resp_s4)
        sim_stats = [
            np.sum((norm * twolpo * (pf.qcls_dd.get_sim_qcl(ks4, int(idx))[:lmax_ss_s4 + 1]
                                     - 2. * ss) - s4_prim - s4_n1)[sl])
            for idx in pf.mc_sims_var]
        qlss = (pf.qresp_dd.get_response(ks4, self.k1[0])
                * pf.qresp_dd.get_response(ks4, self.k2[0]))
        pp_cl_ps = band_dat * cli(self._qc_resp()) * qlss
        return band_dat, band_check, band_syst, sim_stats, Cs2s2, pp_cl_ps

    def get_ps_corr(self, lmin_ss_s4=100, lmax_ss_s4=2048):
        """Binned point-source correction."""
        return self._get_binnedcl(self.get_ps_data(lmin_ss_s4=lmin_ss_s4,
                                                   lmax_ss_s4=lmax_ss_s4)[-1])

    def get_bamc(self, wn1=True):
        """Additive MC correction with approximate errors (math as reference
        plancklens/bandpowers.py:277-301): per-sim MCN0-debiased band-powers minus the
        prediction, averaged; errors inflated for the shared mean-field sims."""
        assert self.k1[0] == 'p' and self.k2[0] == 'p' and self.ksource == 'p'
        pf = self.parfile
        ss2 = 2. * self._stats_mean(pf.qcls_ss)
        cl_pred = _load_fid_clpp(len(ss2) - 1)
        bp_n1 = self.get_n1() if wn1 else np.zeros(self.nbins)
        qc_norm = cli(self._qc_resp())
        bp_stats = stats(self.nbins)
        for idx in pf.mc_sims_var:
            dd = pf.qcls_dd.get_sim_qcl(self.k1, int(idx), k2=self.k2)
            bp_stats.add(self._get_binnedcl(qc_norm * (dd - ss2) - cl_pred) - bp_n1)
        n_mf = len(pf.qcls_dd.mc_sims_mf) or np.inf
        n_b = len(pf.mc_sims_var)
        err_infl = np.sqrt(2. + 2. / n_mf + 2. * n_b / float(n_mf * n_mf))
        return bp_stats.mean(), bp_stats.sigmas_on_mean() * err_infl

    def get_bmmc(self, mc_sims_dd=None, mc_sims_ss=None, wN1=True):
        """Multiplicative MC correction."""
        assert self.k1[0] == 'p' and self.k2[0] == 'p' and self.ksource == 'p'
        pf = self.parfile
        dd = self._stats_mean(pf.qcls_dd, sims=mc_sims_dd)
        ss = self._stats_mean(pf.qcls_ss, sims=mc_sims_ss)
        bps = self._normed_bp(dd - 2. * ss) - self._get_binnedcl(_load_fid_clpp(len(dd) - 1))
        if wN1:
            bps = bps - self.get_n1()
        return 1. / (1. + bps / self.fid_bandpowers)

    def _percl_cov(self, debias, mc_sims):
        """Covariance of per-sim debiased band-powers; `debias(idx)` returns the spectrum
        to subtract from the sim's raw qcl."""
        mc_sims = self.parfile.mc_sims_var if mc_sims is None else mc_sims
        cov_stats = stats(self.nbins)
        for idx in mc_sims:
            dd = self.parfile.qcls_dd.get_sim_qcl(self.k1, int(idx), k2=self.k2)
            cov_stats.add(self._normed_bp(dd - debias(int(idx))))
        return cov_stats.cov()

    def get_nhl_cov(self, mc_sims_dd=None):
        """Covariance from the semi-analytic (realisation-dependent) N0 debiaser."""
        return self._percl_cov(
            lambda idx: self.parfile.nhl_dd.get_sim_nhl(idx, self.k1, self.k2), mc_sims_dd)

    def get_mcn0_cov(self, mc_sims_dd=None):
        """Covariance from the realisation-independent debiaser."""
        return self._percl_cov(lambda idx: 0., mc_sims_dd)

    def get_ampl_x_input(self, mc_sims=None):
        """Cross-correlation amplitude to the input lensing maps.

        Uses the parfile's qlms_x_in cross-spectra library (QE leg x input-phi leg,
        e.g. QeClLib(qlms_dd, qecl.InputPlmLib(...), []); reference:
        plancklens/bandpowers.py:347-360); the cross fsky (QE-mask product x full
        sky) normalises the masked attenuation."""
        qlmi = self.parfile.qlms_x_in
        if mc_sims is None:
            mc_sims = np.unique(np.concatenate([self.parfile.mc_sims_var,
                                                self.parfile.mc_sims_bias]))
        xin = stats(self.nbins)
        fsky = getattr(qlmi, 'fsky12', 1.)
        qnorm = cli(self.parfile.qresp_dd.get_response(self.k1, self.ksource)) / fsky
        for idx in mc_sims:
            xin.add(self._get_binnedcl(
                qnorm * np.asarray(qlmi.get_sim_qcl(self.k1, int(idx))))
                / self.fid_bandpowers)
        return xin
