r"""Planck 2018 SMICA DX12 lensing-reconstruction parameter file for the PyTorch port.

The port's twin of params/smica_dx12_planck2018.py (reference:
params/smicadx12_planck2018.py:1-116): masked conjugate-gradient inverse-variance
filtering of the SMICA CMB map and FFP10 simulations, isotropic post-filter rescaling,
the data/sim (ds) and sim/sim (ss) shuffled QE pairs for the MC-N0 debiaser, and the
response / semi-analytic-N0 / N1 libraries, on plancklens_tpu_torch and driven by
examples/run_qlms_torch.py:
  * no filesystem rendezvous: libraries recompute or use in-memory/npy cachers;
  * the cinv filters run the lockstep PCG on a ring grid (the Planck mask and variance
    maps are resampled onto it with ops.sht.healpix.resample_to_rings), their transforms
    on the Hopper Legendre kernels;
  * batched evaluation: QE maps for many sims are one batched call
    (QELib.get_sim_qlm_batch), replacing the reference's per-index MPI loop.
The same PLK_SMICA_* knobs as the reference file, and PLK_DEVICE (default 'cuda'; without
a card the file raises, and PLK_DEVICE=cpu runs the plain torch path on the CPU). A loader
may set `dense_cacher` in the module's namespace before running it
(run_qlms_torch.load_parfile(..., dense_cacher=c)) for the CinvT/CinvP dense blocks.

External inputs (the Planck data products) are looked up under $PLK_PLANCK_DATA:
    smica_dx12/sim_{t,e,b}lm_{0000..0299,dat}.fits   (healpy alm files, utils.fitsio)
    lensing_mask.fits                                 (RING healpix map)
Import works without them; touching the data-dependent libraries without the files
raises with the expected path in the message.
"""
import os
import numpy as np
import torch

import plancklens_tpu_torch
from plancklens_tpu_torch.utils import camb_clfile
from plancklens_tpu_torch.utils.fitsio import read_map
from plancklens_tpu_torch.models.n0s import gauss_beam
from plancklens_tpu_torch.ops.sht import gl_geometry
from plancklens_tpu_torch.ops.sht.healpix import pixwin, resample_to_rings
from plancklens_tpu_torch.models import qresp, nhl
from plancklens_tpu_torch.models.sims import ExternalAlmLib, AlmMapLib
from plancklens_tpu_torch.models.cinv import CinvT, CinvP, IVFCinv
from plancklens_tpu_torch.models.filt import IVFFtl, IVFShuffle
from plancklens_tpu_torch.models.qest import QELib
from plancklens_tpu_torch.models.qecl import QeClLib, InputPlmLib
from plancklens_tpu_torch.models.n1 import N1Lib

# ---------------------------------------------------------------- analysis constants
# Defaults are the production Planck 2018 sizes (reference:
# params/smicadx12_planck2018.py:22-35); PLK_SMICA_* shrink the identical code path
# for the synthetic-FITS end-to-end test (tests/test_smica_end2end.py), exactly as
# PLK_ANISO_* does for anisofilt_example.py.
lmax_ivf = int(os.environ.get('PLK_SMICA_LMAX', 2048))
lmin_ivf = int(os.environ.get('PLK_SMICA_LMIN',
                              100 if lmax_ivf >= 2048 else max(2, lmax_ivf // 20)))
lmax_qlm = int(os.environ.get('PLK_SMICA_LMAX_QLM', 2 * lmax_ivf))
nside = int(os.environ.get('PLK_SMICA_NSIDE', 2048))
nlev_t = float(os.environ.get('PLK_SMICA_NLEV_T', 35.))   # uK amin
nlev_p = float(os.environ.get('PLK_SMICA_NLEV_P', 55.))
nsims = int(os.environ.get('PLK_SMICA_NSIMS', 300))

DATA = os.environ.get('PLK_PLANCK_DATA', '/data/planck2018')
DEVICE = torch.device(os.environ.get('PLK_DEVICE', 'cuda'))
if DEVICE.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError("PLK_DEVICE is '%s' but no CUDA device is available; set "
                       "PLK_DEVICE=cpu to run on the CPU" % DEVICE)
cls_path = os.path.join(plancklens_tpu_torch.DATAPATH, 'cls')

cl_unl = camb_clfile(os.path.join(cls_path, 'FFP10_wdipole_lenspotentialCls.dat'))
cl_len = camb_clfile(os.path.join(cls_path, 'FFP10_wdipole_lensedCls.dat'))
cl_weight = camb_clfile(os.path.join(cls_path, 'FFP10_wdipole_lensedCls.dat'))
cl_weight['bb'] *= 0.

# 5' beam x pixel window (reference: params/smicadx12_planck2018.py:37;
# gauss_beam takes the FWHM in arcminutes)
transf = gauss_beam(5., lmax=lmax_ivf) * pixwin(nside, lmax_ivf, device=DEVICE)

# ------------------------------------------------------------------- sims (FFP10)
# observed alms (hp.map2alm of the SMICA map / FFP10 sims, exported as healpy FITS);
# AlmMapLib synthesises the observed sky on the solver grid for the masked filters
sims_alm = ExternalAlmLib(os.path.join(DATA, 'smica_dx12'), prefix='sim', ext='fits',
                          device=DEVICE)

# ------------------------------------------------------------- masked cinv filtering
# ring grid carrying the masked solve; the margin over lmax_ivf (512 at production)
# resolves the nside=2048 mask
geom = gl_geometry(lmax_ivf + max(16, lmax_ivf // 4))


def _ninv(nlev):
    """Per-pixel inverse noise variance times the lensing mask on the ring grid.

    CinvT/CinvP take inverse variance per *pixel* (models/cinv.py NinvFilterT); the
    white-noise level nlev [uK-arcmin] gives 1/sigma_sterad^2 per steradian, times the
    quadrature area of each ring-grid pixel.
    """
    omega = np.outer(geom.weight, np.full(geom.nphi, 2. * np.pi / geom.nphi))
    vmap = omega / (nlev / 60. / 180. * np.pi) ** 2
    fn = os.path.join(DATA, 'lensing_mask.fits')
    if not os.path.exists(fn):
        raise FileNotFoundError('Planck lensing mask expected at %s '
                                '(set $PLK_PLANCK_DATA)' % fn)
    mask = read_map(fn)
    return vmap * resample_to_rings(mask, nside, geom)


class _Lazy:
    """Defer data-dependent construction to first use (import must not touch $DATA)."""

    def __init__(self, build):
        self._build = build
        self._obj = None

    def __getattr__(self, name):
        if self._obj is None:
            self._obj = self._build()
        return getattr(self._obj, name)


# PLK_CACHE_DIR makes filtered alms + CG solutions restartable (warm starts on re-runs).
# The cache root carries a configuration token so DIFFERENT configurations sharing one
# PLK_CACHE_DIR can never load each other's products — the role of the reference's
# hash_check guard (plancklens/utils.py:144-180).
_CACHE_DIR = os.environ.get('PLK_CACHE_DIR')
_CFG = 'smica_torch_l%d_lq%d_lm%d_ns%d_n%d_t%g_p%g_%s' % (
    lmax_ivf, lmax_qlm, lmin_ivf, nside, nsims, nlev_t, nlev_p,
    __import__('hashlib').md5(DATA.encode()).hexdigest()[:8])  # data root in the key


def _cacher(sub):
    if _CACHE_DIR:
        from plancklens_tpu_torch.utils.cachers import cacher_npy
        return cacher_npy(os.path.join(_CACHE_DIR, _CFG, sub))
    return None


dense_cacher = globals().get('dense_cacher') or _cacher('dense')
cinv_t = _Lazy(lambda: CinvT(lmax_ivf, geom, cl_len, transf, _ninv(nlev_t),
                             marge_monopole=True, marge_dipole=True, eps_min=1e-5,
                             dense_cacher=dense_cacher, device=DEVICE))
cinv_p = _Lazy(lambda: CinvP(lmax_ivf, geom, cl_len, transf, _ninv(nlev_p),
                             eps_min=1e-5, dense_cacher=dense_cacher, device=DEVICE))
sims = _Lazy(lambda: AlmMapLib(sims_alm, geom, lmax_ivf, device=DEVICE))
ivfs_raw = _Lazy(lambda: IVFCinv(cinv_t, cinv_p, sims, cl_len, cacher=_cacher('ivfs'),
                                 soltn_cacher=_cacher('cg_soltns')))

# isotropic rescaling of the filtered alms (reference: lines 70-74 load the empirical
# ftl/fel/fbl; without the Planck auxiliary files the fiducial ones are used)
ls = np.arange(lmax_ivf + 1)
ftl_rs = (ls >= lmin_ivf) * 1.
fel_rs = (ls >= lmin_ivf) * 1.
fbl_rs = (ls >= lmin_ivf) * 1.
ivfs = _Lazy(lambda: IVFFtl(ivfs_raw, ftl_rs, fel_rs, fbl_rs))

# ------------------------------------------------------ shuffled pairs for MC-N0 (RDN0)
# ss: idx -> idx+1 in blocks of 60 (degenerating to one block when nsims < 60, where
# the reference recipe would make ss == dd); ds: every sim index -> the data map
# (reference: params/smicadx12_planck2018.py:77-84)
_blk = 60 if nsims % 60 == 0 else nsims
ss_dict = {k: v for i in range(nsims // _blk)
           for k, v in zip(range(i * _blk, (i + 1) * _blk),
                           np.roll(np.arange(i * _blk, (i + 1) * _blk), -1))}
ds_dict = {k: -1 for k in range(nsims)}

ivfs_d = _Lazy(lambda: IVFShuffle(ivfs, ds_dict))
ivfs_s = _Lazy(lambda: IVFShuffle(ivfs, ss_dict))


# --------------------------------------------------------------------- QE libraries
qlms_dd = _Lazy(lambda: QELib(ivfs, ivfs, cl_weight, lmax_ivf, lmax_qlm,
                              cacher=_cacher('qlms_dd'), device=DEVICE))
qlms_ds = _Lazy(lambda: QELib(ivfs, ivfs_d, cl_weight, lmax_ivf, lmax_qlm,
                              cacher=_cacher('qlms_ds'), device=DEVICE))
qlms_ss = _Lazy(lambda: QELib(ivfs, ivfs_s, cl_weight, lmax_ivf, lmax_qlm,
                              cacher=_cacher('qlms_ss'), device=DEVICE))

mc_sims_bias = np.arange(nsims // 5, dtype=int)
mc_sims_var = np.arange(nsims // 5, nsims, dtype=int)
mc_sims_mf_dd = mc_sims_bias
mc_sims_mf_ds = np.array([])
mc_sims_mf_ss = np.array([])

qcls_dd = _Lazy(lambda: QeClLib(qlms_dd, qlms_dd, mc_sims_mf_dd))
qcls_ds = _Lazy(lambda: QeClLib(qlms_ds, qlms_ds, mc_sims_mf_ds))
qcls_ss = _Lazy(lambda: QeClLib(qlms_ss, qlms_ss, mc_sims_mf_ss))

# cross-spectra with the FFP10 input phi (sim_plm_*.fits products), the optional
# qlms_x_in hook of bandpowers.get_ampl_x_input
qlms_x_in = _Lazy(lambda: QeClLib(qlms_dd, InputPlmLib(sims_alm, lmax_qlm, device=DEVICE),
                                  np.array([])))

# ---------------------------------- response / N1 (data-independent), N0 (per-sim)
fal = {'tt': np.nan_to_num(ftl_rs / (cl_len['tt'][:lmax_ivf + 1]
                                     + (nlev_t / 60. / 180. * np.pi) ** 2
                                     / transf ** 2)),
       'ee': np.nan_to_num(fel_rs / (cl_len['ee'][:lmax_ivf + 1]
                                     + (nlev_p / 60. / 180. * np.pi) ** 2
                                     / transf ** 2)),
       'bb': np.nan_to_num(fbl_rs / (cl_len['bb'][:lmax_ivf + 1]
                                     + (nlev_p / 60. / 180. * np.pi) ** 2
                                     / transf ** 2))}

qresp_dd = qresp.RespLib(lmax_ivf, cl_weight, cl_len, fal, lmax_qlm, device=DEVICE)
nhl_dd = _Lazy(lambda: nhl.NhlLib(ivfs, cl_weight, lmax_qlm, resplib=qresp_dd,
                                   device=DEVICE))
n1_dd = N1Lib(cl_len['tt'], cl_len['te'], cl_len['ee'],
              lmaxphi=min(2500, 2 * lmax_ivf), dL=10, lps=None, device=DEVICE)
