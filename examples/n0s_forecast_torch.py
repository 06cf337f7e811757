#!/usr/bin/env python
"""Default N0 curves for the standard estimators, plus the iterated (MAP) forecast, on a
torch device (the twin of examples/n0s_forecast.py).

The analytic reconstruction-noise forecast (models/n0s.get_N0) for the TT, pol-only and
MV estimators against the fiducial lensing spectrum, and with --iter N the iterated
forecast (get_N0_iter, whose lensed spectra, responses and N0s run on the device). Prints
the lines of examples/n0s_forecast.py in the same format:

    python examples/n0s_forecast_torch.py                    # table on stdout, on the card
    python examples/n0s_forecast_torch.py --iter 3           # + 3 MAP iterations for p_p
    python examples/n0s_forecast_torch.py --plot out.png     # + a figure (needs matplotlib)
    python examples/n0s_forecast_torch.py --device cpu --lmax 300 --iter 1

`--device` defaults to cuda and raises without a card. `main(argv)` returns the curves it
prints: {'N0s', 'N0_curls': {qe key: array}, 'unbiased': (iter + 1, L) or None, 'Ls'}.
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
from plancklens_tpu_torch.utils import camb_clfile
from plancklens_tpu_torch.models import n0s


def device_of(name):
    """torch.device `name`; a CUDA device without a card raises (no CPU fallback)."""
    dev = torch.device(name)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available for --device %s; pass --device cpu "
                           "to run on the CPU" % name)
    return dev


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--lmax', type=int, default=3000, help='CMB multipole cut')
    ap.add_argument('--lmin', type=int, default=100)
    ap.add_argument('--beam', type=float, default=1.4, help='beam FWHM [arcmin]')
    ap.add_argument('--nlev-t', type=float, default=5., help='T noise [uK-arcmin]')
    ap.add_argument('--iter', type=int, default=0, metavar='N',
                    help='also run N MAP iterations of the pol-only forecast')
    ap.add_argument('--plot', type=str, default=None, metavar='FILE',
                    help='save a figure (requires matplotlib)')
    ap.add_argument('--device', default='cuda',
                    help="torch device (default 'cuda'; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    dev = device_of(args.device)

    cls_unl = camb_clfile(os.path.join(plancklens_tpu_torch.DATAPATH, 'cls',
                                       'FFP10_wdipole_lenspotentialCls.dat'))
    N0s, N0_curls = n0s.get_N0(beam_fwhm=args.beam, nlev_t=args.nlev_t,
                               lmax_CMB=args.lmax, lmin_CMB=args.lmin, device=dev)
    labels = {'tt': 'TT', '_p': 'PP', '': 'MV'}

    lmax_qlm = min(len(v) for v in N0s.values()) - 1
    Ls = np.array([L for L in (10, 30, 100, 300, 1000, 2000) if L <= lmax_qlm])
    w = (Ls * (Ls + 1.)) ** 2 / (2. * np.pi) * 1e7
    print('# 1e7 L^2(L+1)^2 N_L^(0) / 2pi  (grad)   [fid C_L^pp in last column]')
    print('# L     ' + ''.join('%10s' % labels[k[1:]] for k in N0s) + '%10s' % 'fid')
    for i, L in enumerate(Ls):
        row = ''.join('%10.3f' % (w[i] * N0s[k][L]) for k in N0s)
        print('%-6d%s%10.3f' % (L, row, w[i] * cls_unl['pp'][L]))

    it_rows = None
    if args.iter > 0:
        _, unbiased = n0s.get_N0_iter('p_p', args.nlev_t, args.nlev_t * np.sqrt(2.),
                                      args.beam, cls_unl, args.lmin, args.lmax, args.iter,
                                      device=dev)
        it_rows = unbiased
        print('\n# iterated p_p N0 (unbiased), same weighting:')
        print('# L     ' + ''.join('%10s' % ('iter %d' % it) for it in range(args.iter + 1)))
        for i, L in enumerate(Ls):
            Lc = min(L, unbiased.shape[1] - 1)
            print('%-6d%s' % (L, ''.join('%10.3f' % (w[i] * unbiased[it][Lc])
                                         for it in range(args.iter + 1))))

    if args.plot:
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as pl
        ls = np.arange(2, args.lmax + 1)
        wls = ls ** 2 * (ls + 1.) ** 2 * 1e7 / (2. * np.pi)
        for k in N0s:
            ln = pl.loglog(ls, wls * N0s[k][ls], label=labels[k[1:]])
            pl.loglog(ls, wls * N0_curls[k][ls], ls='--', c=ln[0].get_color())
        if it_rows is not None:
            lsq = np.arange(2, it_rows.shape[1])
            wq = lsq ** 2 * (lsq + 1.) ** 2 * 1e7 / (2. * np.pi)
            pl.loglog(lsq, wq * it_rows[-1][lsq], c='grey',
                      label='PP iter %d' % args.iter)
        pl.plot(ls, wls * cls_unl['pp'][ls], c='k', label=r'$C_L^{\phi\phi}$ fid')
        pl.xlabel(r'$L$')
        pl.ylabel(r'$10^7\, L^2(L+1)^2 N_L^{(0)} / 2\pi$')
        pl.legend(ncol=2)
        pl.savefig(args.plot, dpi=150, bbox_inches='tight')
        print('\nwrote %s' % args.plot)
    return {'N0s': N0s, 'N0_curls': N0_curls, 'unbiased': it_rows, 'Ls': Ls}


if __name__ == '__main__':
    main()
