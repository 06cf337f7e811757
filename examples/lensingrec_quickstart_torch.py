#!/usr/bin/env python
r"""Lensing reconstruction quickstart on a torch device (the twin of
examples/lensingrec_quickstart.py, whose numpy draws it repeats, so both start from the
same alms).

Generates lensed skies (`Lensing.alm2lenmap`: the Legendre synthesis kernel on the ECP
grid, then the deflection and interpolation), analyses them (`SHT.map2alm`: the analysis
kernel), filters them, reconstructs phi with the ptt QE (`eval_qe`: spin-0 and spin-1
syntheses, one spin-1 analysis), and checks the normalised reconstruction against the
input: the cross-spectrum over the response should track C_L^pp, and the auto-spectrum
should sit at C_L^pp + N0. The response and the Gaussian noise (`qresp.get_response`,
`nhl.get_nhl`) run their Wigner products on the device. Prints the lines of
examples/lensingrec_quickstart.py in the same format:

    python examples/lensingrec_quickstart_torch.py                  # lmax 128, on the card
    python examples/lensingrec_quickstart_torch.py --device cpu     # the same on the CPU

`main(lmax, nsims, nlev_t, *, device)` returns (cross, auto, N0) as the JAX script's
`main`; `reconstruct` returns every curve and number behind them, and `report` prints
them. A CUDA device without a card raises (no CPU fallback).
"""
# runnable from a source checkout without installation
import os as _os, sys as _sys
_REPO = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
if _REPO not in _sys.path:
    _sys.path.insert(0, _REPO)
import argparse
import os

import numpy as np
import torch


def device_of(name):
    """torch.device `name`; a CUDA device without a card raises (no CPU fallback)."""
    dev = torch.device(name)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available for device %s; pass device 'cpu' "
                           "to run on the CPU" % name)
    return dev


def reconstruct(lmax=128, nsims=4, nlev_t=5., *, device, log=print):
    """The quickstart's sims, lensing, filtering and ptt reconstruction on `device`:
    {'cross', 'auto', 'cpp_in', 'N0', 'RG', 'NG', 'unl_pp', 'sel', 'sig', 'qlm'} (numpy;
    the spectra averaged over the sims)."""
    dev = device_of(device)
    import plancklens_tpu_torch
    from plancklens_tpu_torch.utils import camb_clfile, cli, alm as ualm
    from plancklens_tpu_torch.ops.sht import SHT, gl_geometry
    from plancklens_tpu_torch.ops.lensing import Lensing
    from plancklens_tpu_torch.models import qresp, nhl
    from plancklens_tpu_torch.models.qest import eval_qe

    cls_path = os.path.join(plancklens_tpu_torch.DATAPATH, 'cls')
    cls_len = camb_clfile(os.path.join(cls_path, 'FFP10_wdipole_lensedCls.dat'), lmax=lmax)
    unl = camb_clfile(os.path.join(cls_path, 'FFP10_wdipole_lenspotentialCls.dat'),
                      lmax=lmax)
    geom = gl_geometry(lmax + 32)
    lens = Lensing(geom, lmax, lmax_p=lmax, device=dev)
    sht = SHT(geom, lmax, device=dev)
    nt2 = (nlev_t / 60. / 180. * np.pi) ** 2
    ftl = cli(cls_len['tt'] + nt2)
    ftl[:8] = 0.
    ls, ms = ualm._lm_indices(lmax)

    def ralm(cl, seed):
        rng = np.random.RandomState(seed)
        a = (rng.standard_normal(len(ls)) + 1j * rng.standard_normal(len(ls))) / np.sqrt(2.)
        a[ms == 0] = a[ms == 0].real * np.sqrt(2.)
        return a * np.sqrt(cl[ls])

    log('generating + lensing %d sims at lmax=%d ...' % (nsims, lmax))
    tunl = np.stack([ralm(unl['tt'], 3 * i) for i in range(nsims)])
    plms = torch.as_tensor(np.stack([ralm(unl['pp'], 3 * i + 1) for i in range(nsims)]),
                           device=dev)
    tmaps = lens.alm2lenmap(tunl, plms)
    tobs = sht.map2alm(tmaps)
    tobs = tobs + torch.as_tensor(np.stack([ralm(np.full(lmax + 1, nt2), 3 * i + 2)
                                            for i in range(nsims)]), device=dev)

    log('filtering + reconstructing (ptt QE) ...')
    bart = ualm.almxfl(tobs, lmax, ftl)
    Z = torch.zeros_like(bart)
    qlm, _ = eval_qe('ptt', lmax, cls_len,
                     lambda f, b=bart, z=Z: {'t': b, 'e': z, 'b': z}[f], lmax, device=dev)

    RG = qresp.get_response('ptt', lmax, 'p', cls_len, cls_len,
                            {'tt': ftl, 'ee': 0 * ftl, 'bb': 0 * ftl}, lmax_qlm=lmax,
                            device=dev)[0]
    NG = nhl.get_nhl('ptt', 'ptt', cls_len, {'tt': ftl * (cls_len['tt'] + nt2) * ftl},
                     lmax, lmax, lmax_out=lmax, device=dev)[0]
    N0 = NG * cli(RG ** 2)

    phat = ualm.almxfl(qlm, lmax, cli(RG))      # normalised reconstruction
    spectrum = lambda a, b=None: ualm.alm2cl(a, lmax, alm2=b).mean(0).cpu().numpy()
    cross, auto, cpp_in = spectrum(phat, plms), spectrum(phat), spectrum(plms)

    sel = slice(10, lmax - 20)
    # expected scatter of the band-averaged cross ratio: per-mode noise is ~N0/Cpp
    nmodes = nsims * np.sum(2 * np.arange(sel.start, sel.stop) + 1.)
    sig = np.sqrt(np.mean(N0[sel] / unl['pp'][sel.start:sel.stop]) / nmodes)
    return {'cross': cross, 'auto': auto, 'cpp_in': cpp_in, 'N0': N0, 'RG': RG, 'NG': NG,
            'unl_pp': unl['pp'], 'sel': sel, 'sig': sig, 'qlm': qlm}


def band_averages(r):
    """The three printed numbers: <phihat x phi_in> / <phi_in^2>, <phihat^2> / (C_pp + N0)
    over the band `r['sel']`, and N0 / C_pp at L = 40."""
    sel, pp = r['sel'], r['unl_pp']
    return (float(np.mean(r['cross'][sel] / r['cpp_in'][sel])),
            float(np.mean(r['auto'][sel] / (pp[sel.start:sel.stop] + r['N0'][sel]))),
            float(r['N0'][40] / pp[40]))


def report(r):
    """Print the JAX script's lines for the result of `reconstruct`."""
    sel = r['sel']
    x, a, n = band_averages(r)
    print('\n  L-band averages over L in [%d, %d):' % (sel.start, sel.stop))
    print('  <phihat x phi_in> / <phi_in^2>          = %.3f  (expect 1 +- %.2f at this '
          'lmax/nsims)' % (x, r['sig']))
    print('  <phihat^2> / (C_pp + N0)                = %.3f  (expect ~1)' % a)
    print('  N0 / C_pp at L=40                       = %.2f' % n)


def main(lmax=128, nsims=4, nlev_t=5., *, device):
    r = reconstruct(lmax, nsims, nlev_t, device=device)
    report(r)
    return r['cross'], r['auto'], r['N0']


if __name__ == '__main__':
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--device', default='cuda',
                    help="torch device (default 'cuda'; 'cpu' runs on the CPU)")
    main(device=ap.parse_args().device)
