r"""Masked curved-sky reconstruction parameter file for the PyTorch port.

The port's twin of params/anisofilt_example.py: the same chain and knobs on
plancklens_tpu_torch, driven by examples/run_qlms_torch.py:
  * lensed CMB skies from the deflection-remap operator (sims.CMBLenLib), seed 0;
  * beam + homogeneous white pixel noise on the GL grid (sims.MapsLenNlevLib), seed 2000;
  * the synthetic galactic band + holes mask;
  * masked CG inverse-variance filtering (cinv), then the QE / QE-spectra / input-cross /
    response / semi-analytic N0 libraries: ivfs, qlms_{dd,ds,ss}, qcls_{dd,ds,ss},
    qlms_x_in, qresp_dd, nhl_dd and the N1 library n1_dd (its quadrature on PLK_DEVICE).

Environment: PLK_ANISO_LMAX (default 2048), PLK_ANISO_NLEV_T / _P (35 / 55 uK-arcmin),
PLK_ANISO_NSIMS (300) and PLK_CACHE_DIR as in the reference file, and PLK_DEVICE (default
'cuda'; without a card the file raises, and PLK_DEVICE=cpu runs the plain torch path on the
CPU). Sims, filtering and the QEs run in float64. A loader may set `dense_cacher` in the
module's namespace before running it (run_qlms_torch.load_parfile(..., dense_cacher=c)):
the CinvT/CinvP dense preconditioners then load from and store to that cacher.
"""
import os
import numpy as np
import torch

import plancklens_tpu_torch
from plancklens_tpu_torch.utils import camb_clfile
from plancklens_tpu_torch.models.n0s import gauss_beam
from plancklens_tpu_torch.ops.sht import gl_geometry
from plancklens_tpu_torch.models import qresp, nhl
from plancklens_tpu_torch.models.sims import CMBLenLib, MapsLenNlevLib
from plancklens_tpu_torch.models.cinv import CinvT, CinvP, IVFCinv
from plancklens_tpu_torch.models.filt import IVFFtl, IVFShuffle
from plancklens_tpu_torch.models.qest import QELib
from plancklens_tpu_torch.models.qecl import QeClLib, InputPlmLib
from plancklens_tpu_torch.models.n1 import N1Lib

# --------------------------------------------------------------- analysis constants
lmax_ivf = int(os.environ.get('PLK_ANISO_LMAX', 2048))
lmin_ivf = max(2, lmax_ivf // 20)
lmax_qlm = lmax_ivf
nlev_t = float(os.environ.get('PLK_ANISO_NLEV_T', 35.))
nlev_p = float(os.environ.get('PLK_ANISO_NLEV_P', 55.))
nsims = int(os.environ.get('PLK_ANISO_NSIMS', 300))
DEVICE = torch.device(os.environ.get('PLK_DEVICE', 'cuda'))
if DEVICE.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError("PLK_DEVICE is '%s' but no CUDA device is available; set "
                       "PLK_DEVICE=cpu to run on the CPU" % DEVICE)

cls_path = os.path.join(plancklens_tpu_torch.DATAPATH, 'cls')
cl_unl = camb_clfile(os.path.join(cls_path, 'FFP10_wdipole_lenspotentialCls.dat'))
cl_len = camb_clfile(os.path.join(cls_path, 'FFP10_wdipole_lensedCls.dat'))
cl_weight = camb_clfile(os.path.join(cls_path, 'FFP10_wdipole_lensedCls.dat'))
cl_weight['bb'] *= 0.

# 5-arcmin beam (gauss_beam takes the FWHM in arcminutes)
transf = gauss_beam(5., lmax=lmax_ivf)

# ------------------------------------------------------------------ sims on the grid
geom = gl_geometry(lmax_ivf)
cmb_len = CMBLenLib(cl_unl, lmax_ivf, geom, seed=0,
                    dlmax=min(128, max(16, lmax_ivf // 4)), device=DEVICE)
sims = MapsLenNlevLib(cmb_len, transf, nlev_t, nlev_p, seed=2000)

# ------------------------------------------------- synthetic mask + masked filtering
# galactic band cut plus a few circular 'point source' holes (as params/anisofilt_example.py)
z = np.cos(geom.theta)[:, None]
phi = (2. * np.pi * np.arange(geom.nphi) / geom.nphi)[None, :]
mask = (np.abs(z) > 0.15).astype(float) * np.ones((geom.nrings, geom.nphi))
for zc, pc, r in ((0.6, 1.0, 0.05), (-0.5, 4.0, 0.04), (0.3, 2.5, 0.03)):
    mask *= ((z - zc) ** 2 + (np.cos(phi) - np.cos(pc)) ** 2 * (1 - z ** 2)
             + (np.sin(phi) - np.sin(pc)) ** 2 * (1 - z ** 2) > r ** 2)

ninv_t = sims.ninv_t() * mask
ninv_p = sims.ninv_p() * mask

# PLK_CACHE_DIR makes filtered alms + CG solutions restartable; the cache root carries a
# configuration token so different configurations sharing one directory never load each
# other's products
_CACHE_DIR = os.environ.get('PLK_CACHE_DIR')
_CFG = 'aniso_torch_l%d_n%d_t%g_p%g' % (lmax_ivf, nsims, nlev_t, nlev_p)


def _cacher(sub):
    if _CACHE_DIR:
        from plancklens_tpu_torch.utils.cachers import cacher_npy
        return cacher_npy(os.path.join(_CACHE_DIR, _CFG, sub))
    return None


dense_cacher = globals().get('dense_cacher') or _cacher('dense')
cinv_t = CinvT(lmax_ivf, geom, cl_len, transf, ninv_t,
               marge_monopole=True, marge_dipole=True, eps_min=1e-5,
               dense_cacher=dense_cacher, device=DEVICE)
cinv_p = CinvP(lmax_ivf, geom, cl_len, transf, ninv_p, eps_min=1e-5,
               lmax_dense=32, dense_cacher=dense_cacher, device=DEVICE)
ivfs_raw = IVFCinv(cinv_t, cinv_p, sims, cl_len, cacher=_cacher('ivfs'),
                   soltn_cacher=_cacher('cg_soltns'))

ls = np.arange(lmax_ivf + 1)
ftl = (ls >= lmin_ivf) * 1.
fel = (ls >= lmin_ivf) * 1.
fbl = (ls >= lmin_ivf) * 1.
ivfs = IVFFtl(ivfs_raw, ftl, fel, fbl)

# ------------------------------------------------------ shuffled pairs (MCN0 / RDN0)
ss_dict = {i: (i + 1) % nsims for i in range(nsims)}
ds_dict = {k: -1 for k in range(nsims)}
ivfs_d = IVFShuffle(ivfs, ds_dict)
ivfs_s = IVFShuffle(ivfs, ss_dict)

# --------------------------------------------------------------------- QE libraries
qlms_dd = QELib(ivfs, ivfs, cl_weight, lmax_ivf, lmax_qlm, cacher=_cacher('qlms_dd'),
                device=DEVICE)
qlms_ds = QELib(ivfs, ivfs_d, cl_weight, lmax_ivf, lmax_qlm, cacher=_cacher('qlms_ds'),
                device=DEVICE)
qlms_ss = QELib(ivfs, ivfs_s, cl_weight, lmax_ivf, lmax_qlm, cacher=_cacher('qlms_ss'),
                device=DEVICE)

mc_sims_bias = np.arange(nsims // 5, dtype=int)
mc_sims_var = np.arange(nsims // 5, nsims, dtype=int)
mc_sims_mf_dd = mc_sims_bias    # parfile contract: run_qlms_torch.py's mf stage reads this

qcls_dd = QeClLib(qlms_dd, qlms_dd, mc_sims_bias)
qcls_ds = QeClLib(qlms_ds, qlms_ds, np.array([]))
qcls_ss = QeClLib(qlms_ss, qlms_ss, np.array([]))

# cross-spectra of the reconstructions with the known input phi of each lensed sim
qlms_x_in = QeClLib(qlms_dd, InputPlmLib(cmb_len, lmax_qlm, device=DEVICE), np.array([]))

# -------------------------------------------------------- response / N0 / N1
fal = {'tt': np.nan_to_num(ftl / (cl_len['tt'][:lmax_ivf + 1]
                                  + (nlev_t / 60. / 180. * np.pi) ** 2 / transf ** 2)),
       'ee': np.nan_to_num(fel / (cl_len['ee'][:lmax_ivf + 1]
                                  + (nlev_p / 60. / 180. * np.pi) ** 2 / transf ** 2)),
       'bb': np.nan_to_num(fbl / (cl_len['bb'][:lmax_ivf + 1]
                                  + (nlev_p / 60. / 180. * np.pi) ** 2 / transf ** 2))}

qresp_dd = qresp.RespLib(lmax_ivf, cl_weight, cl_len, fal, lmax_qlm, device=DEVICE)
nhl_dd = nhl.NhlLib(ivfs, cl_weight, lmax_qlm, resplib=qresp_dd, device=DEVICE)
n1_dd = N1Lib(cl_len['tt'], cl_len['te'], cl_len['ee'],
              lmaxphi=min(2500, 2 * lmax_ivf), dL=10, lps=None, device=DEVICE)
