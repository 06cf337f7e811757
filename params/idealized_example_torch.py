"""Idealized full-sky parameter file for the PyTorch port (plancklens_tpu_torch).

Same pipeline as params/idealized_example.py: FFP10-like spectra, 35 uK-arcmin T noise
(x sqrt(2) pol), isotropic filtering, the ptt/p_p/MV QEs with their dd/ds/ss spectra, and
the analytic layers (qresp_dd, nhl_dd, n1_dd; their products run on the device). Module-level
globals follow the reference's parameter-file contract; drive the file with
examples/run_qlms_torch.py.

Environment: PLK_LMAX_IVF, PLK_LMAX_QLM, PLK_NSIMS as in the reference parfile, and
PLK_DEVICE (default 'cuda'; without a card the file raises, and PLK_DEVICE=cpu runs the
plain torch path on the CPU). Simulations and filtering run in float64 on that device;
the QEs run in float32 on a CUDA device (the production precision, Hopper kernels) and
in float64 on the CPU.
"""
import os
import numpy as np
import torch

import plancklens_tpu_torch
from plancklens_tpu_torch.utils import camb_clfile, cli
from plancklens_tpu_torch.models.sims import CMBUnlLib, MapsNlevLib
from plancklens_tpu_torch.models.filt import IVFSepTP, IVFShuffle
from plancklens_tpu_torch.models.qest import QELib
from plancklens_tpu_torch.models.qecl import QeClLib
from plancklens_tpu_torch.models.qresp import RespLib
from plancklens_tpu_torch.models.nhl import NhlLib
from plancklens_tpu_torch.models.n1 import N1Lib

LMAX_IVF = int(os.environ.get('PLK_LMAX_IVF', 512))
LMAX_QLM = int(os.environ.get('PLK_LMAX_QLM', 512))
LMIN_IVF = 10
NLEV_T = 35.
NLEV_P = 35. * np.sqrt(2.)
NSIMS = int(os.environ.get('PLK_NSIMS', 64))
DEVICE = torch.device(os.environ.get('PLK_DEVICE', 'cuda'))
if DEVICE.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError("PLK_DEVICE is '%s' but no CUDA device is available; set "
                       "PLK_DEVICE=cpu to run on the CPU" % DEVICE)
QE_DTYPE = torch.float32 if DEVICE.type == 'cuda' else None

# optional persistent product store (PLK_CACHE_DIR), namespaced by configuration so that
# different configurations sharing one directory never load each other's products
_CACHE_DIR = os.environ.get('PLK_CACHE_DIR')
_CFG = 'ideal_torch_l%d_lq%d_n%d_%s' % (LMAX_IVF, LMAX_QLM, NSIMS, DEVICE.type)


def _cacher(sub):
    if _CACHE_DIR:
        from plancklens_tpu_torch.utils.cachers import cacher_npy
        return cacher_npy(os.path.join(_CACHE_DIR, _CFG, sub))
    return None


cls_path = os.path.join(plancklens_tpu_torch.DATAPATH, 'cls')
cl_len = camb_clfile(os.path.join(cls_path, 'FFP10_wdipole_lensedCls.dat'), lmax=LMAX_IVF)

transf = np.ones(LMAX_IVF + 1)  # idealized: unit beam, harmonic-space sims
nt2 = (NLEV_T / 60. / 180. * np.pi) ** 2
np2 = (NLEV_P / 60. / 180. * np.pi) ** 2
ftl = cli(cl_len['tt'] + nt2)
fel = cli(cl_len['ee'] + np2)
fbl = cli(cl_len['bb'] + np2)
for fl in (ftl, fel, fbl):
    fl[:LMIN_IVF] = 0.

# --- simulations (Gaussian skies with lensed spectra)
cmbs = CMBUnlLib(cl_len, LMAX_IVF, fields=('t', 'e', 'b'), seed=83, device=DEVICE)
sims = MapsNlevLib(cmbs, transf, NLEV_T, NLEV_P, seed=84)

# --- filtering
ivfs = IVFSepTP(sims, transf, cl_len, ftl, fel, fbl)
ds_dict = {i: -1 for i in range(NSIMS)}             # all sims paired with the data leg
ss_dict = {i: (i + 1) % NSIMS for i in range(NSIMS)}  # sims paired with the next sim
ivfs_d = IVFShuffle(ivfs, ds_dict)
ivfs_s = IVFShuffle(ivfs, ss_dict)

# --- QEs and their spectra
qlms_dd = QELib(ivfs, ivfs, cl_len, LMAX_IVF, LMAX_QLM, cacher=_cacher('qlms_dd'),
                dtype=QE_DTYPE, device=DEVICE)
qlms_ds = QELib(ivfs, ivfs_d, cl_len, LMAX_IVF, LMAX_QLM, cacher=_cacher('qlms_ds'),
                dtype=QE_DTYPE, device=DEVICE)
qlms_ss = QELib(ivfs, ivfs_s, cl_len, LMAX_IVF, LMAX_QLM, cacher=_cacher('qlms_ss'),
                dtype=QE_DTYPE, device=DEVICE)

mc_sims_bias = np.arange(NSIMS // 2)
mc_sims_var = np.arange(NSIMS // 2, NSIMS)
mc_sims_mf_dd = mc_sims_bias
mc_sims_mf_ds = np.array([], dtype=int)
mc_sims_mf_ss = np.array([], dtype=int)

qcls_dd = QeClLib(qlms_dd, qlms_dd, mc_sims_mf_dd, lmax_qlm=LMAX_QLM,
                  cacher=_cacher('qcls_dd'))
qcls_ds = QeClLib(qlms_ds, qlms_ds, mc_sims_mf_ds, lmax_qlm=LMAX_QLM,
                  cacher=_cacher('qcls_ds'))
qcls_ss = QeClLib(qlms_ss, qlms_ss, mc_sims_mf_ss, lmax_qlm=LMAX_QLM,
                  cacher=_cacher('qcls_ss'))

# --- analytic layers
fal = {'tt': ftl, 'ee': fel, 'bb': fbl}
qresp_dd = RespLib(LMAX_IVF, cl_len, cl_len, fal, LMAX_QLM, cacher=_cacher('qresp'),
                   device=DEVICE)
nhl_dd = NhlLib(ivfs, cl_len, LMAX_QLM, cacher=_cacher('nhl'), device=DEVICE)
n1_dd = N1Lib(cl_len['tt'], cl_len['te'], cl_len['ee'], lmaxphi=2048, device=DEVICE)
