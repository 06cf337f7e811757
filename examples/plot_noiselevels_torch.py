#!/usr/bin/env python
"""Gaussian reconstruction-noise levels per estimator key, from the low-level API, on a
torch device (the twin of examples/plot_noiselevels.py).

N0 = N / R^2 for a chosen anisotropy source, assembled from the Gaussian QE noise
(models/nhl.get_nhl) and the isotropic response (models/qresp.get_response), whose Wigner
products run on the device: the TT / pol-only / MV keys under separate-TP filtering, and
the GMV key under joint-TP filtering (each multipole's 3x3 TEB inverse,
`utils.cl_inverse`). Prints the lines of examples/plot_noiselevels.py in the same format:

    python examples/plot_noiselevels_torch.py                   # table on stdout, the card
    python examples/plot_noiselevels_torch.py --source f        # point-source amplitude
    python examples/plot_noiselevels_torch.py --plot out.png    # save a figure
    python examples/plot_noiselevels_torch.py --device cpu --lmax 256 --source a

`--device` defaults to cuda and raises without a card. `main(argv)` returns the curves it
prints: [(label, gradient N0, curl N0 or None)], N0 over L = 0..lmax; `noise_curves`
computes them for given arguments and spectra.
"""
# runnable from a bare source checkout
import os as _os, sys as _sys
_REPO = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
if _REPO not in _sys.path:
    _sys.path.insert(0, _REPO)

import argparse
import os

import numpy as np
import torch

import plancklens_tpu_torch
from plancklens_tpu_torch.utils import camb_clfile, cli, cl_inverse
from plancklens_tpu_torch.models import nhl, qresp
from plancklens_tpu_torch.models.n0s import gauss_beam


def device_of(name):
    """torch.device `name`; a CUDA device without a card raises (no CPU fallback)."""
    dev = torch.device(name)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available for --device %s; pass --device cpu "
                           "to run on the CPU" % name)
    return dev


def noise_curves(source='p', lmax=2048, lmin=100, beam=6., nlev_t=35., *, device,
                 cls_len=None):
    """[(label, gradient N0, curl N0 or None)] of `main` for these arguments, on `device`;
    `cls_len` replaces the FFP10 lensed spectra (weights, CMB and filters alike)."""
    ksource, lmax_ivf, lmin_ivf = source, lmax, lmin
    lmax_qlm = lmax_ivf
    nlev_p = nlev_t * np.sqrt(2.)

    if ksource in ('p', 'f', 'a'):
        qe_keys = [ksource + 'tt', ksource + '_p', ksource]
        key_labels = ['TT', 'P-only', 'MV']
    else:
        qe_keys, key_labels = [ksource], [ksource]

    if cls_len is None:
        cls_len = camb_clfile(os.path.join(plancklens_tpu_torch.DATAPATH, 'cls',
                                           'FFP10_wdipole_lensedCls.dat'))
    cls_weight = cls_len
    transf = gauss_beam(beam, lmax_ivf)
    nt2 = (nlev_t / 60. / 180. * np.pi) ** 2 / transf ** 2
    np2 = (nlev_p / 60. / 180. * np.pi) ** 2 / transf ** 2

    # separate-TP filtering: diagonal isotropic filters, TE handled at the QE level
    fal_sep = {'tt': cli(cls_len['tt'][:lmax_ivf + 1] + nt2),
               'ee': cli(cls_len['ee'][:lmax_ivf + 1] + np2),
               'bb': cli(cls_len['bb'][:lmax_ivf + 1] + np2)}
    ivfs_sep = dict(fal_sep,
                    te=cls_len['te'][:lmax_ivf + 1] * fal_sep['tt'] * fal_sep['ee'])

    # joint-TP filtering: full 3x3 TEB inverse covariance (the GMV weighting)
    cls_dat = {'tt': cls_len['tt'][:lmax_ivf + 1] + nt2,
               'ee': cls_len['ee'][:lmax_ivf + 1] + np2,
               'bb': cls_len['bb'][:lmax_ivf + 1] + np2,
               'te': np.copy(cls_len['te'][:lmax_ivf + 1])}
    fal_jt = cl_inverse(cls_dat)
    ivfs_jt = cl_inverse(cls_dat)

    for cls in (fal_sep, ivfs_sep, fal_jt, ivfs_jt):
        for cl in cls.values():
            cl[:max(1, lmin_ivf)] *= 0.

    curves = []   # (label, grad N0, curl N0 or None)
    for qe_key, lab in zip(qe_keys, key_labels):
        NG, NC, _, _ = nhl.get_nhl(qe_key, qe_key, cls_weight, ivfs_sep,
                                   lmax_ivf, lmax_ivf, lmax_out=lmax_qlm, device=device)
        RG, RC, _, _ = qresp.get_response(qe_key, lmax_ivf, ksource, cls_weight,
                                          cls_len, fal_sep, lmax_qlm=lmax_qlm, device=device)
        curl = cli(RC ** 2) * NC if qe_key[0] in ('p', 'x', 'f') else None
        curves.append((lab + ' (sep TP)', cli(RG ** 2) * NG, curl))
    if len(qe_keys) > 1:
        NG, NC, _, _ = nhl.get_nhl(ksource, ksource, cls_weight, ivfs_jt,
                                   lmax_ivf, lmax_ivf, lmax_out=lmax_qlm, device=device)
        RG, RC, _, _ = qresp.get_response(ksource, lmax_ivf, ksource, cls_weight,
                                          cls_len, fal_jt, lmax_qlm=lmax_qlm, device=device)
        curves.append(('GMV (joint TP)', cli(RG ** 2) * NG, cli(RC ** 2) * NC))
    return curves


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--source', type=str, default='p', choices=['p', 'f', 'a', 'stt'],
                    help='anisotropy source (lensing gradient / modulation / '
                         'rotation / point sources)')
    ap.add_argument('--lmax', type=int, default=2048)
    ap.add_argument('--lmin', type=int, default=100)
    ap.add_argument('--beam', type=float, default=6., help='beam FWHM [arcmin]')
    ap.add_argument('--nlev-t', type=float, default=35., help='T noise [uK-arcmin]')
    ap.add_argument('--plot', type=str, default=None, metavar='FILE')
    ap.add_argument('--device', default='cuda',
                    help="torch device (default 'cuda'; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    curves = noise_curves(args.source, args.lmax, args.lmin, args.beam, args.nlev_t,
                          device=device_of(args.device))
    ksource, lmax_qlm = args.source, args.lmax
    if ksource == 'p':
        w = lambda L: L ** 2 * (L + 1.) ** 2 * 1e7 / (2. * np.pi)
    else:
        w = lambda L: np.ones_like(np.asarray(L, dtype=float))

    Ls = np.array([L for L in (10, 30, 100, 300, 1000, 2000) if L <= lmax_qlm])
    print('# weighted N0(grad) for source %r  [w = L^2(L+1)^2 1e7/2pi for p, 1 else]'
          % ksource)
    print('# L     ' + ''.join('%16s' % lab for lab, _, _ in curves))
    for L in Ls:
        print('%-6d%s' % (L, ''.join('%16.4g' % (w(L) * n0[L]) for _, n0, _ in curves)))

    if args.plot:
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as pl
        ls = np.arange(2, lmax_qlm + 1)
        for lab, n0, curl in curves:
            ln = pl.loglog(ls, w(ls) * n0[ls], label=lab)
            if curl is not None:
                pl.loglog(ls, w(ls) * curl[ls], ls='--', c=ln[0].get_color())
        pl.xlabel(r'$L$')
        pl.ylabel(r'weighted $N_L^{(0)}$ (dashed: curl)')
        pl.legend()
        pl.savefig(args.plot, dpi=150, bbox_inches='tight')
        print('\nwrote %s' % args.plot)
    return curves


if __name__ == '__main__':
    main()
