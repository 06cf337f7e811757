#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: `python3 chip_smoke.py`.

Builds the hand-written Hopper Legendre kernels from this checkout, holds each against its
plain torch version, and drives the port's paths, counting kernel launches on the way:
the main path — the idealized full-sky parameter file through the staged driver's
functions (filtering, batched ptt and p_p QEs, split-half mean fields, dd/ds/ss spectra)
at LMAX_IVF = LMAX_QLM = 2048 with 8 simulations, float32 QEs on cuda:0 —, the HEALPix
entry path at Planck's nside 2048, masked filtering, and the lensed masked chain of the
anisotropic parameter file at lmax 2048 through N1, the band-powers and the N0 forecasts.
Phases:

  0 device      CUDA present (no CPU path), card name and power limit, TF32 off
  1 build       nvcc build of csrc/legendre_pair.cu, all four kernels (timed; registers)
  2 kernels     K1/K2 vs plain version: spins 0-3, odd/even rings, lmax 256, f32
                (<= 1e-5 of max) and f64 (<= 1e-12 of max), the analysis with its ring sum
                split into segments (NS > 1, as the planner has it there) and forced into
                one (NS = 1), K1 also at batch 5 (not a multiple of a batch tile) and with
                mmax 128 (M not a multiple of 32); lmax 2048 on the 3073-ring QE grid,
                spin 1, f32, batch 4 and 8 (<= 1e-5 of max), times with K1's block shape
                and K2's NS, blocks and workspace, the batch-4 to batch-8 time ratios of
                K1 and K2, and both bitwise equal from run to run
  2b plain      K3/K4 vs plain version at lmax 256 on 201 and 202 random rings (one within
                1e-3 of each pole) and the 255 rings of HEALPix nside 64, n = -3..3,
                mmax = lmax and mmax < lmax, f32 (<= 1e-5) and f64 (<= 1e-12 of max), K4
                with NS > 1 and NS = 1; lmax 2048 on the 2047 north-cap rings of nside
                2048, n = -2, f32, batch 4 and 8 (<= 1e-5 of max), K3/K4 bitwise equal
                from run to run; times on all 8191 rings at batch 4 with K3's block shape,
                K3/K4 bitwise equal from run to run there too
  3 sht         SHT round trips at lmax 2048, spin 0 and 2, f32 (<= 1e-4 of max)
  4 main path   the slice at lmax 2048: finite outputs of the expected shapes, K1/K2
                launched, f32 vs f64 qlm of sim 4 (ptt, relative rms <= 1e-3), and the
                CUDA path against the CPU plain path on a small input (<= 1e-10)
  5a pixwin     exact pixel window of nside 128 (T and pol, f64, 256 x 3 K4 calls) against
                the shipped tables (<= 1e-10 of max)
  5b healpix    HEALPix entry path, nside 2048, lmax 2048, f64 transforms: sims 0-3 ->
                alm2map(_spin) (K3) -> map2alm(_spin) iter 3 (K4, K3) -> FITS alms ->
                ExternalAlmLib -> IVFSepTP -> QELib ptt/p_p in f32; K3/K4 launched, alm
                round trip (relative rms <= 1e-6) and qlm against phase 4's (<= 1e-5);
                the nside-2048 ring weights timed. examples/profile_healpix_torch.py
                traces the same path and splits its time
  6 cinv        masked inverse-variance filtering at params/anisofilt_example.py's
                configuration (examples/masked_filter_torch.py): (6a) CinvT (35 and 3000
                uK-arcmin) and CinvP at lmax 64, lmax_dense 32, f64, batch 2, the CG loop on
                the kernels against the CG loop on the CPU plain path: the same iteration
                count (> 5), the right-hand side and the forward op (the kernels' part of
                the loop) within 1e-12 of max, the card's solution below 1e-5 in the CPU
                system, the solutions within 1e-10 (T at 35 uK-arcmin: within 10x the CPU
                path's own change under a 1e-15 change of its maps and inverted dense
                block, as that system amplifies rounding by its condition), and a traced
                warm solve on the card with no host-to-device copy; (6b) CinvT at lmax 2048,
                f64, batch 8 (host dense block to l 64): every row below 1e-5 (recurred and
                recomputed residual), iterations, seconds, seconds an iteration, K1/K2
                launches by (mode, batch, type), peak < 40 GiB, 10 warm iterations traced
                (device time by kernel group); the f32 solve, not checked;
                (6c) CinvP, f64, batch 4, the E/B block to l 32 probed on the card (chunk,
                seconds, K2 workspace <= its cap); (6d) AlmMapLib -> IVFCinv -> IVFFtl(l >=
                102) -> QELib ptt/p_p on 2 sims, finite, against phase 4's qlm (printed);
                then K1/K2 at 6b's shape timed against their plain versions (<= 1e-12)
  7 lensed      the lensed masked chain of params/anisofilt_example_torch.py
                (examples/lensed_chain_torch.py): (7a) Lensing.alm2lenmap(_spin) on 2 sims,
                one also deflected by a curl potential, and CMBLenLib.get_sim_tlm/eblm at
                lmax 64 (dlmax 16), f64, on the card against the CPU plain path (<= 1e-10 of
                max), K1 launches by (mode, batch, type); (7b) lensed sims 0-3 at lmax 2048
                (dlmax 128, oversample 4, order 9, f64): cold host table builds of the ECP
                and GL grids, each sim's time split by step (CUDA events), K1/K2 launches by
                step, peak < 40 GiB, the step-by-step sim against the libraries (<= 1e-10),
                binned lensed TT/EE/BB (100 <= l < 1500, bins of 100) against
                FFP10_wdipole_lensedCls.dat within K sigma of 4 full-sky sims' cosmic
                variance plus a floor (lensed_chain_torch.SPECTRA_BOUND), and K1 at the ECP
                T / Q-U and deflection shapes and K2 at the lensed E/B map2alm against their
                plain versions (<= 1e-12), timed with their bounds; (7c) the parfile at
                lmax 2048 on sims 0-3 (filt through IVFCinv with phase 6's dense blocks, qe
                ptt/p_p, qcl dd, responses, nhl of sim 0, the cross with the input phi),
                each stage timed, all finite, and <q x phi_in> / (R_L C_L^pp fsky) over
                30 <= L <= 1000 within [0.7, 1.3] for ptt and p_p
  8 band-powers the end of the masked chain, N1 and the band-powers
                (examples/bandpowers_demo_torch.py), on the parfile at lmax 2048 with 10
                sims (data -1, mc_sims_bias 0-1, mc_sims_var 2-9) and phase 6's dense blocks:
                (8a) the N1 quadrature (ops/n1kern, plain torch f64) on the card against the
                CPU: n1L_batch of (ptt, ptt), (pee, peb), (xtt, xtt) and n1L_jtp_batch on
                three combinations (one with a shorter leg) at lmax 120, dL 20 (<= 1e-12 of
                max), and (ptt, ptt) at L = 10, 500, 2000 at the parfile configuration
                (<= 1e-10 of max); (8b) Binner.get_n1 of ptt and p_p at lmax 2048 (dL 10,
                38 source knots to 2500): seconds per fundamental curve (CUDA events), peak
                < 40 GiB, all finite, binned |N1| below the fiducial band-power in the agr2
                bins with L <= 900; (8c) the band-power chain: filt, qe (ptt, p_p, stt on the
                dd/ds/ss legs), qcl, responses, nhl, n1, every Binner output (agr2 bins),
                each stage timed, all finite, K1/K2 launched, dat - rdn0 - n1 within 5
                sigma_b (get_mcn0_cov) + 0.3 |fid| of fid, RDN0/MCN0 and the data's
                semi-analytic N0/MCN0 in stated bands per bin, and get_ampl_x_input's mean
                in [0.7, 1.3] in the bins with L <= 900 (bounds: bandpowers_demo_torch.py);
                (8d) ops/lensed_cls of FFP10 (input to l 4000, output to 1600) and
                models/n0s.get_N0 at 35 / 55 uK-arcmin, 5', l 102-2048 on the card against
                the CPU (lensed spectra <= 1e-12 of their max, BB of EE's; 1/N0 <= 1e-12 of
                its max, and N0 per L over 10-2048 within 10x the largest of four changes of
                the CPU path under a 1e-15 change of its spectra, at least 1e-12: N0 =
                N / R^2 amplifies rounding as 1/L^2 at low L; N0 from f32-rounded spectra
                must exceed that limit), and the card's lensed spectra against
                FFP10_wdipole_lensedCls.dat (tests/test_lensed_cls.py's bounds)
  9 joint T/P   joint T/P filtering and the GMV estimator (examples/gmv_jtp_torch.py):
                (9a) cinv.CinvTP at lmax 64 (the anisofilt mask, 35 / 55 uK-arcmin, batch 2,
                monopole and dipole marginalised, dense block to l 16), f64, on the card
                against the CPU plain path: the same iteration count (> 5), the right-hand
                side and forward op within 1e-12 of max, the card's solution below 1e-5 in
                the CPU system and within 10x the CPU solution's change under a 1e-15 change
                of its maps and inverted dense block, the dense block probed on the card
                within 1e-12 of the CPU's probe, get_fal within 1e-12; IVFJTP's alms and
                Wiener legs and the GMV 'p' qlm on them within 1e-12 of max; smooth_map,
                apodize_mask, IVFApoSepTP, IVFFml, AlmNlevLib, CMBUnlLibFixedPhi,
                CMBLenLibFixedPhi, CinvKK and template_uptolmin at lmax 32 on the card
                against the CPU (gmv_jtp_torch.STAGE_B_LIMITS: 1e-12 of max, the lensed
                maps 1e-10, CinvKK the same iterations and 10x the CPU solution's change
                under a 1e-15 change of its map); (9b) CinvTP at
                lmax 2048 on the parfile's lensed masked sims 0-3 in one lockstep batch
                (dense T/E/B block to l 32 probed on the card at band limit 32): every row
                below 1e-5 (recurred and recomputed) in < 400 iterations, iterations,
                seconds, seconds an iteration, setup seconds, K1/K2 launches by (mode, batch,
                type), peak < 40 GiB (probe and solve), and K1/K2 at the joint operator's
                shapes (spin 0 and the spin-2 pair, f64, batch 4, 2049 rings) against their
                plain versions (<= 1e-12 of max, bitwise equal on a second run), timed; (9c)
                the bar alms through an IVFCinvJTP cacher under the reference's names ->
                IVFFtl -> QELib 'p', <q x phi_in> / (R_L^GMV C_L^pp fsky) over 30 <= L <=
                1000 in [0.7, 1.3] with R from RespLib on CinvTP.get_fal(), and the
                semi-analytic N0 of the GMV 'p' below that of the separately filtered 'p'
                at every 10 <= L <= 2000 (ratio <= 1 + 1e-6); (9d) IVFJTP on 4 Gaussian sims
                of the lensed spectra at lmax 2048 (35 / 35 sqrt 2 uK-arcmin): the mean GMV
                spectrum over its N0 over 30 <= L <= 1500 within gmv_jtp_torch.SPEC_BOUND
                of 1
  10 smica      params/smica_dx12_planck2018_torch.py through its own code at the
                production lmax 2048 / nside 2048 (lmax_qlm 4096) on synthetic products
                written by the phase in the reference's formats (examples/
                smica_synth_torch.py: healpy alm FITS of lensed sims 0-1 and dat with their
                input phi, a RING lensing mask of nside 2048): the filters (the mask
                resampled onto the 2561-ring grid, CinvT's host dense block), the masked
                filtering of sims 0-1 (IVFCinv), QE ptt and p_p, the responses and the cross
                with the input phi read back from FITS, each timed: all finite, the l-cut
                kept, K1/K2 launched, peak < 40 GiB, and a finite positive <q x phi_in> /
                (R_L C_L^pp fsky) over 30 <= L <= 1000

Phases 4, 5b, 6 and 7b each start with an empty recursion-table cache, so each path's times and
peak memory are its own, cold.

Any failure raises (non-zero exit). The line before the last is a JSON object with one
entry per kernel; the last line is {"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
import sys
import time
from collections import Counter

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
LMAX = 2048
NSIMS = 8
KEYS = ('ptt', 'p_p')
SRC = 'plancklens_tpu_torch/ops/sht/csrc/legendre_pair.cu'
REPLACES = {'synth_pair': 'plancklens_tpu/ops/sht/pallas_kernel.py:497',
            'anal_pair': 'plancklens_tpu/ops/sht/pallas_kernel.py:641',
            'synth': 'plancklens_tpu/ops/sht/pallas_kernel.py:131',
            'anal': 'plancklens_tpu/ops/sht/pallas_kernel.py:267'}
NSIDE = 2048
HP_SIMS = [0, 1, 2, 3]
NSIMS8 = 10


def check(cond, msg):
    if not cond:
        raise RuntimeError('chip_smoke: ' + msg)


def phase(n, msg):
    print('[phase %d] %s' % (n, msg), flush=True)


def rel_max(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def rel_rms(a, b):
    return ((a - b).abs().pow(2).sum() / b.abs().pow(2).sum()).sqrt().item()


def cuda_ms(fn, reps):
    """Milliseconds a call of fn over reps calls (CUDA events), and the last output. With
    reps > 1 a first untimed call caches the output's memory blocks and each output is
    freed before the next call, so no cudaMalloc stall lands between the events (without
    this, K3 f64 on all 8191 rings read 36.7, 87.5 and 232.5 ms in three runs of one tree
    on an NVIDIA H100 80GB HBM3 at 700 W, and K1 at the CG shape 18.0 and 51.6 ms)."""
    import torch
    out = fn() if reps > 1 else None
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        out = None
        out = fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps, out


T_START = time.perf_counter()


def phase8(dev, dense_blocks=None):
    """Phase 8 (module docstring): N1 and the band-powers of the masked chain at lmax 2048;
    `dense_blocks` is phase 6's dense-block cacher (None: the parfile builds its own)."""
    import torch
    from plancklens_tpu_torch.ops.sht import legendre_kernels as lk
    import bandpowers_demo_torch as bpd
    log8 = lambda s: phase(8, s)
    t8 = time.perf_counter()
    par8, setup8 = bpd.load_aniso(dev, LMAX, NSIMS8, dense_cacher=dense_blocks)
    r8a = bpd.n1_card_vs_cpu(dev, par8, log=log8)
    for name, err in r8a['small'].items():
        check(err <= 1e-12, 'N1 %s on the card vs the CPU: %.2e > 1e-12' % (name, err))
    check(r8a['full'] <= 1e-10 and bool(np.all(np.isfinite(r8a['full_values']))),
          'N1 (ptt, ptt) at L = %s on the card vs the CPU: %.2e > 1e-10'
          % (r8a['knots'], r8a['full']))
    r8b = bpd.n1_full(par8, keys=KEYS, log=log8)
    check(r8b['finite'], 'N1 curves at lmax %d are not finite' % LMAX)
    check(r8b['peak_gib'] < 40., 'N1 peak memory %.2f GiB' % r8b['peak_gib'])
    for k, ratio in r8b['ratio'].items():
        low = r8b['low_bins']
        check(bool(np.all(ratio[low] < 1.)), 'binned |N1| / fid of %s at L <= %d: %s'
              % (k, bpd.AMPL_LMAX, ratio[low]))
    lk.reset_launches()
    r8c = bpd.bandpower_chain(par8, keys=KEYS, setup_s=setup8, log=log8)
    bp_launches = dict(lk.launches)
    check(bp_launches['synth_pair'] > 0 and bp_launches['anal_pair'] > 0,
          'the band-power chain did not launch K1 and K2: %s' % bp_launches)
    check(r8c['finite'], 'the band-power chain gave non-finite outputs')
    check(r8c['peak_gib'] < 40., 'band-power chain peak memory %.2f GiB' % r8c['peak_gib'])
    for k, r in r8c['res'].items():
        check(bool(np.all(r['bp_dev'] <= r['bp_bound'])),
              '%s: |dat - rdn0 - n1 - fid| %s beyond %s' % (k, r['bp_dev'], r['bp_bound']))
        for name, (lo, hi) in (('rdn0_ratio', bpd.RDN0_BAND), ('nhl_ratio', bpd.NHL_BAND)):
            check(bool(np.all((r[name] >= lo) & (r[name] <= hi))),
                  '%s: %s %s outside [%g, %g]' % (k, name, r[name], lo, hi))
        lo, hi = bpd.AMPL_BAND
        a = r['ampl'][r['low']]
        check(bool(np.all((a >= lo) & (a <= hi))), '%s: <q x phi_in> amplitude %s outside '
              '[%g, %g] at L <= %d' % (k, a, lo, hi, bpd.AMPL_LMAX))
    phase(8, '(8c) K1/K2 launches of the band-power chain: %s' % bp_launches)
    del par8
    torch.cuda.empty_cache()
    r8d = bpd.forecasts(dev, log=log8)
    for k, gap in r8d['lens_gap'].items():
        check(gap <= 1e-12, 'lensed %s on the card vs the CPU: %.2e > 1e-12' % (k, gap))
    for k, lo, hi, gap, bound in r8d['vs_ffp10']:
        check(gap < bound, 'lensed %s over %d-%d vs FFP10: %.2e >= %g' % (k, lo, hi, gap, bound))
    for k, (inv_gap, band_gap) in r8d['n0_gap'].items():
        limit = bpd.n0_limit(r8d['n0_floor'][k])
        check(inv_gap <= 1e-12 and band_gap <= limit, 'get_N0 %s on the card vs the CPU: '
              '1/N0 %.2e of max (limit 1e-12), N0 %.2e over 10 <= L <= 2048 (limit %.2e)'
              % (k, inv_gap, band_gap, limit))
        # the per-L limit must see a precision fault: N0 from f32-rounded spectra
        check(r8d['n0_f32'][k] > limit, 'get_N0 %s from f32-rounded spectra reads %.2e per '
              'L, within the limit %.2e' % (k, r8d['n0_f32'][k], limit))
    phase(8, 'phase 8 wall %.1fs; the whole run so far %.1fs'
          % (time.perf_counter() - t8, time.perf_counter() - T_START))


def phase9(dev, dense_blocks=None):
    """Phase 9 (module docstring): joint T/P filtering and the GMV estimator. Returns 9b's
    numbers and the kernel rows at the joint operator's shapes."""
    import torch
    from plancklens_tpu_torch.ops.sht import core
    import gmv_jtp_torch as gj
    log9 = lambda s: phase(9, s)
    t9 = time.perf_counter()
    r = gj.card_vs_cpu(dev, log=log9)
    it_d, it_c, it_n = r['it']
    check(it_d == it_c == it_n and it_d > 5 and bool(np.all(r['rel'] < 1e-5))
          and bool(np.all(r['res'] < 1e-5)),
          'CinvTP at lmax 64: iterations %s, card solution residual %s' % (r['it'], r['res']))
    check(r['err'] <= 10. * r['floor'], 'CinvTP card vs CPU: %.2e > 10 x %.2e'
          % (r['err'], r['floor']))
    check(max(r['ops'], r['probe_err'], r['fal_err'], r['ivfjtp_err'], r['qlm_err']) <= 1e-12,
          'CinvTP / IVFJTP card vs CPU: ops %.2e, probe %.2e, fal %.2e, IVFJTP %.2e, qlm %.2e'
          % (r['ops'], r['probe_err'], r['fal_err'], r['ivfjtp_err'], r['qlm_err']))
    check(r['launches']['synth_pair'] > 0 and r['launches']['anal_pair'] > 0,
          'CinvTP at lmax 64 did not launch K1/K2: %s' % r['launches'])
    rb = gj.stage_b_card_vs_cpu(dev, log=log9)
    for name in gj.STAGE_B_LIMITS:
        limit = gj.stage_b_limit(name, rb)
        check(rb[name] <= limit, '%s card vs CPU: %.2e > %.2e' % (name, rb[name], limit))
    check(len(set(rb['CinvKK_it'])) == 1, 'CinvKK iterations card / CPU / CPU perturbed: %s'
          % (rb['CinvKK_it'],))
    core.TABLES.clear()
    torch.cuda.empty_cache()
    r9b = gj.masked_gmv(dev, LMAX, nsims=len(HP_SIMS), dense_cacher=dense_blocks, log=log9)
    rels = np.concatenate([r9b['rel'], r9b['true_rel']])
    check(r9b['it'] < 400 and bool((rels < 1e-5).all()),
          'CinvTP at lmax %d: %d iterations, residuals %s' % (LMAX, r9b['it'], rels))
    check(max(r9b['peak_gib'], r9b['probe_peak_gib']) < 40., 'CinvTP peak memory %.2f / %.2f '
          'GiB' % (r9b['probe_peak_gib'], r9b['peak_gib']))
    batch = len(HP_SIMS)
    for mode in (0, 1):
        check(r9b['k1'].get((mode, batch, 'f64'), 0) > 0
              and r9b['k2'].get((mode, batch, 'f64'), 0) > 0,
              'CinvTP did not run K1/K2 mode %d at batch %d: %s %s'
              % (mode, batch, r9b['k1'], r9b['k2']))
    check(r9b['finite'] and 0.7 <= r9b['ampl'] <= 1.3, 'GMV <q x phi_in> / (R C^pp fsky) '
          '%.4f outside [0.7, 1.3] (finite: %s)' % (r9b['ampl'], r9b['finite']))
    torch.cuda.empty_cache()
    rows = gj.kernel_rows(dev, LMAX, batch=batch, log=log9)
    for name, row in rows.items():
        check(row['rel_err'] <= 1e-12 and row['equal'], '%s vs plain: %.2e, bitwise equal on '
              'a second run: %s' % (name, row['rel_err'], row['equal']))
    r9n = gj.n0_ratio(dev, LMAX, log=log9)
    check(bool(np.all(r9n['ratio'] <= 1. + 1e-6)), 'N0 GMV / N0 SQE above 1 + 1e-6: max %.8f'
          % r9n['ratio'].max())
    core.TABLES.clear()
    torch.cuda.empty_cache()
    r9d = gj.ivfjtp_full(dev, LMAX, nsims=4, log=log9)
    check(r9d['finite'] and abs(r9d['ratio'] - 1.) <= gj.SPEC_BOUND,
          'IVFJTP GMV spectrum / N0: mean %.4f, bound %g' % (r9d['ratio'], gj.SPEC_BOUND))
    phase(9, 'phase 9 wall %.1fs; the whole run so far %.1fs'
          % (time.perf_counter() - t9, time.perf_counter() - T_START))
    core.TABLES.clear()
    torch.cuda.empty_cache()
    return r9b, rows


def phase10(dev):
    """Phase 10 (module docstring): the Planck 2018 parameter file on synthetic products."""
    import torch
    from plancklens_tpu_torch.ops.sht import core
    import smica_synth_torch as ss
    t10 = time.perf_counter()
    r = ss.smica_chain(dev, LMAX, NSIDE, nsims=2, log=lambda s: phase(10, s))
    check(r['finite'] and r['lcut_ok'], 'the smica chain: finite %s, l-cut kept %s'
          % (r['finite'], r['lcut_ok']))
    check(r['launches']['synth_pair'] > 0 and r['launches']['anal_pair'] > 0,
          'the smica chain did not launch K1 and K2: %s' % r['launches'])
    check(r['peak_gib'] < 40., 'the smica chain peak memory %.2f GiB' % r['peak_gib'])
    check(all(np.isfinite(a) and a > 0. for a in r['ampl'].values()),
          'the smica chain <q x phi_in> amplitude %s' % r['ampl'])
    phase(10, 'phase 10 wall %.1fs; the whole run so far %.1fs'
          % (time.perf_counter() - t10, time.perf_counter() - T_START))
    core.TABLES.clear()
    torch.cuda.empty_cache()


def main():
    # one card: only the first visible card is exposed, so the device count reported on
    # the last line is the number of cards the run used
    visible = os.environ.get('CUDA_VISIBLE_DEVICES')
    card = '0' if visible is None else visible.split(',')[0]
    os.environ['CUDA_VISIBLE_DEVICES'] = card
    import torch
    check(torch.cuda.is_available(), 'no CUDA device: this script measures the GPU port')
    check(torch.cuda.device_count() == 1, 'the run must see exactly one card')
    sys.path.insert(0, HERE)
    import plancklens_tpu_torch
    check(os.path.dirname(os.path.abspath(plancklens_tpu_torch.__file__))
          == os.path.join(HERE, 'plancklens_tpu_torch'),
          'plancklens_tpu_torch must come from this checkout')
    from plancklens_tpu_torch.ops.sht import core, legendre_kernels as lk, SHT
    from plancklens_tpu_torch.ops.sht import HealpixGeometry
    from plancklens_tpu_torch.ops.sht.roofline import pair_bound, plain_bound
    from plancklens_tpu_torch.ops.sht.geometry import gl_geometry
    from plancklens_tpu_torch.ops.sht.pixwin import pixwin_exact, _ring_Gm
    from plancklens_tpu_torch.utils import alm as ualm
    from plancklens_tpu_torch import DATAPATH
    check('jax' not in sys.modules, 'the port must not import jax')

    # ---------------------------------------------------------------- 0 device
    dev = torch.device('cuda:0')
    smi = subprocess.run(['nvidia-smi', '-i', card, '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase(0, '%s | torch %s, CUDA %s, %d device(s)' % (
        torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda,
        torch.cuda.device_count()))
    print(smi, flush=True)

    # ---------------------------------------------------------------- 1 build
    t0 = time.perf_counter()
    so = lk.build()
    lk._load()
    phase(1, 'kernels built in %.1fs: %s' % (time.perf_counter() - t0, os.path.relpath(so, HERE)))
    for k in lk.build_report():
        print('    %s<%s>: %d registers, %d/%d bytes spill stores/loads'
              % (k['kernel'], ', '.join(map(str, k['args'])), k['registers'],
                 k['spill_stores'], k['spill_loads']))

    # ---------------------------------------------------------------- 2 kernels
    gen = torch.Generator(device=dev).manual_seed(2048)

    def crandn(shape, cdt):
        return torch.randn(shape, generator=gen, device=dev, dtype=cdt)

    def split(kind):
        """The last call's ring split, for the phase lines."""
        pl = lk.last_plan[kind]
        return 'NS %d, %d blocks, workspace %.0f MiB' % (pl.nseg, pl.blocks,
                                                          pl.workspace_bytes / 2 ** 20)

    def shape(kind, B, dt='f32'):
        """The synthesis block shape a call of batch B runs, for the phase lines."""
        bt, rpt, nws, minb = lk.synth_shape(kind, dt, B)
        return '%d maps x %d rings x %d warps, %d block(s) an SM' % (bt, rpt, nws, minb)

    worst = {'synth_pair': 0., 'anal_pair': 0.}
    nsegs = set()
    for lmax, nrings in ((256, 257), (256, 258)):
        theta = gl_geometry(nrings - 1).theta
        for cdt, tol in ((torch.complex64, 1e-5), (torch.complex128, 1e-12)):
            for spin in (0, 1, 2, 3):
                t_m, t_p = core.pair_tables(lmax, lmax, spin, theta, None, dev)
                B = 3
                C = crandn((B, lmax + 1, lmax + 1), cdt)
                Cm = crandn((B, lmax + 1, lmax + 1), cdt)    # spin 0: pair on one recursion
                Q = crandn((B, nrings, lmax + 1), cdt)
                Qm = crandn((B, nrings, lmax + 1), cdt)
                for cm, qm in ((Cm, Qm), (None, None)):
                    ks = lk.synth_pair(C, cm, spin, nrings, t_m, t_p)
                    ps = core.legendre_synth_pair_plain(C, cm, spin, nrings, t_m, t_p)
                    # K1's ragged shapes: batch 5 (no multiple of a batch tile) and mmax
                    # 128 (M = 129, no multiple of 32); lmax 256 is no multiple of LCS
                    C5 = crandn((5, lmax + 1, lmax + 1), cdt)
                    C5m = None if cm is None else crandn((5, lmax + 1, lmax + 1), cdt)
                    h_m, h_p = core.pair_tables(lmax, 128, spin, theta, None, dev)
                    Ch = C[:, :, :129].contiguous()
                    Chm = None if cm is None else cm[:, :, :129].contiguous()
                    er = max(rel_max(a, b) for k_, p_ in (
                        (lk.synth_pair(C5, C5m, spin, nrings, t_m, t_p),
                         core.legendre_synth_pair_plain(C5, C5m, spin, nrings, t_m, t_p)),
                        (lk.synth_pair(Ch, Chm, spin, nrings, h_m, h_p),
                         core.legendre_synth_pair_plain(Ch, Chm, spin, nrings, h_m, h_p)))
                        for a, b in zip(k_, p_) if b is not None)
                    pa = core.legendre_anal_pair_plain(Q, qm, spin, lmax, t_m, t_p)
                    ea = 0.
                    for nseg in (None, 1):     # the planner's segments (6 there), and one
                        ka = lk.anal_pair(Q, qm, spin, lmax, t_m, t_p, nseg=nseg)
                        check((lk.last_plan['anal_pair'].nseg == 1) == (nseg == 1),
                              'K2 segments at %d rings: %s' % (nrings, split('anal_pair')))
                        nsegs.add(lk.last_plan['anal_pair'].nseg)
                        ea = max([ea] + [rel_max(a, b) for a, b in zip(ka, pa)
                                         if b is not None])
                    torch.cuda.synchronize()
                    es = max([er] + [rel_max(a, b) for a, b in zip(ks, ps) if b is not None])
                    check(es <= tol and ea <= tol, 'kernel vs plain at lmax %d, %d rings, '
                          '%s, spin %d: synth %.2e (batch 5 and mmax 128: %.2e) anal %.2e '
                          '> %.0e' % (lmax, nrings, cdt, spin, es, er, ea, tol))
                    worst['synth_pair'] = max(worst['synth_pair'], es)
                    worst['anal_pair'] = max(worst['anal_pair'], ea)
    phase(2, 'kernel vs plain at lmax 256, spins 0-3, 257/258 rings, f32 and f64, K1 at batch '
             '3 and 5 and mmax 256 and 128, K2 in %s ring segments: worst synth %.2e, anal '
             '%.2e of max'
          % ('/'.join(map(str, sorted(nsegs))), worst['synth_pair'], worst['anal_pair']))

    geom = gl_geometry(3 * LMAX // 2)          # the QE grid of lmax 2048: 3073 x 6250
    nr = geom.nrings
    t_m, t_p = core.pair_tables(LMAX, LMAX, 1, geom.theta, None, dev)
    stats = {}
    for B in (4, 8):
        C = crandn((B, LMAX + 1, LMAX + 1), torch.complex64)
        Cm = crandn((B, LMAX + 1, LMAX + 1), torch.complex64)
        F0 = lk.synth_pair(C, Cm, 1, nr, t_m, t_p)                           # warm-up
        ms_s, (Fp, Fm) = cuda_ms(lambda: lk.synth_pair(C, Cm, 1, nr, t_m, t_p), 3)
        check(torch.equal(F0[0], Fp) and torch.equal(F0[1], Fm),
              'synth_pair is not deterministic')
        del F0
        w = torch.as_tensor(geom.weight, dtype=torch.float32, device=dev)[:, None]
        Qp, Qm = (Fp * w).contiguous(), (Fm * w).contiguous()
        A0, B0 = lk.anal_pair(Qp, Qm, 1, LMAX, t_m, t_p)
        ms_a, (A, Bc) = cuda_ms(lambda: lk.anal_pair(Qp, Qm, 1, LMAX, t_m, t_p), 3)
        check(torch.equal(A0, A) and torch.equal(B0, Bc), 'anal_pair is not deterministic')
        pms_s, (Pp, Pm) = cuda_ms(
            lambda: core.legendre_synth_pair_plain(C, Cm, 1, nr, t_m, t_p), 1)
        pms_a, (PA, PB) = cuda_ms(
            lambda: core.legendre_anal_pair_plain(Qp, Qm, 1, LMAX, t_m, t_p), 1)
        es = max(rel_max(Fp, Pp), rel_max(Fm, Pm))
        ea = max(rel_max(A, PA), rel_max(Bc, PB))
        abs_s = max((Fp - Pp).abs().max().item(), (Fm - Pm).abs().max().item())
        abs_a = max((A - PA).abs().max().item(), (Bc - PB).abs().max().item())
        check(es <= 1e-5 and ea <= 1e-5, 'kernel vs plain at lmax 2048, batch %d: synth '
              '%.2e anal %.2e of max > 1e-5' % (B, es, ea))
        stats[B] = dict(synth=(ms_s, pms_s, abs_s, es), anal=(ms_a, pms_a, abs_a, ea))
        phase(2, 'lmax 2048, %d x %d grid, spin 1, f32, batch %d: synth %.3f ms (block shape '
              '%s; plain %.1f ms, %.2e of max), anal %.3f ms (%s; plain %.1f ms, %.2e of '
              'max), both bitwise equal on a second run'
              % (nr, geom.nphi, B, ms_s, shape('pair', B), pms_s, es, ms_a, split('anal_pair'),
                 pms_a, ea))
        del C, Cm, Fp, Fm, Qp, Qm, A, Bc, A0, B0, Pp, Pm, PA, PB
    torch.cuda.empty_cache()
    phase(2, 'batch 4 / batch 8 time ratio: K1 synth_pair %.4f, K2 anal_pair %.4f'
          % (stats[4]['synth'][0] / stats[8]['synth'][0],
             stats[4]['anal'][0] / stats[8]['anal'][0]))
    # bounds at the batch-8 and batch-4 shapes timed above (mode 1: both recursions on the
    # 1537 northern rings, two sums an input, roofline.PAIR_WORK)
    stats[8]['synth'] += pair_bound((t_m, t_p), 1, 8, nr, False)
    stats[8]['anal'] += pair_bound((t_m, t_p), 1, 8, nr, False)
    b4 = pair_bound((t_m, t_p), 1, 4, nr, False)
    phase(2, 'bounds of K1/K2 at lmax 2048, spin-1 pair, f32: batch 8 %.3f ms (%s), batch 4 '
             '%.3f ms (%s)' % (stats[8]['synth'][-2], stats[8]['synth'][-1], b4[0], b4[1]))
    del t_m, t_p

    # ---------------------------------------------------------------- 2b plain kernels
    rng = np.random.RandomState(256)
    grids = []
    for nrand in (201, 202):
        th = np.sort(rng.uniform(0., np.pi, nrand))
        th[0], th[-1] = 4e-4, np.pi - 7e-4          # within 1e-3 of each pole
        grids.append(('%d random' % nrand, th))
    grids.append(('HEALPix nside 64', HealpixGeometry(64).theta))
    worst_p = {'synth': 0., 'anal': 0.}
    nsegs = set()
    lp = 256
    for label, th in grids:
        R = len(th)
        for cdt, tol in ((torch.complex64, 1e-5), (torch.complex128, 1e-12)):
            for n in range(-3, 4):
                for M in (lp + 1, lp // 2 + 1):
                    t = core.full_tables(lp, M - 1, n, th, None, dev)
                    C = crandn((3, lp + 1, M), cdt)
                    Q = crandn((3, R, M), cdt)
                    es = rel_max(lk.synth(C, R, t), core.legendre_synth_plain(C, t))
                    pa = core.legendre_anal_plain(Q, lp, t)
                    ea = 0.
                    for nseg in (None, 1):     # the planner's segments (4), and one
                        ea = max(ea, rel_max(lk.anal(Q, lp, t, nseg=nseg), pa))
                        check((lk.last_plan['anal'].nseg == 1) == (nseg == 1),
                              'K4 segments on %s rings: %s' % (label, split('anal')))
                        nsegs.add(lk.last_plan['anal'].nseg)
                    check(es <= tol and ea <= tol, 'K3/K4 vs plain at lmax %d, %s rings, %s, '
                          'n %d, mmax %d: synth %.2e anal %.2e > %.0e'
                          % (lp, label, cdt, n, M - 1, es, ea, tol))
                    worst_p['synth'] = max(worst_p['synth'], es)
                    worst_p['anal'] = max(worst_p['anal'], ea)
    phase(2, '(2b) K3/K4 vs plain at lmax 256 on 201/202 random rings and HEALPix nside 64, '
             'n -3..3, mmax 256/128, f32 and f64, K4 in %s ring segments: worst synth %.2e, '
             'anal %.2e of max'
          % ('/'.join(map(str, sorted(nsegs))), worst_p['synth'], worst_p['anal']))

    hgeom = HealpixGeometry(NSIDE)
    ncap = NSIDE - 1                           # the north cap's rings: 2047 at nside 2048
    th_cap = hgeom.theta[:ncap]
    t = core.full_tables(LMAX, LMAX, -2, th_cap, None, dev)
    for B in (4, 8):
        C = crandn((B, LMAX + 1, LMAX + 1), torch.complex64)
        G0 = lk.synth(C, ncap, t)                                            # warm-up
        ms_s, G = cuda_ms(lambda: lk.synth(C, ncap, t), 3)
        check(torch.equal(G0, G), 'K3 synth is not deterministic')
        del G0
        A0 = lk.anal(G, LMAX, t)
        ms_a, A = cuda_ms(lambda: lk.anal(G, LMAX, t), 3)
        check(torch.equal(A0, A), 'K4 anal is not deterministic')
        pms_s, PG = cuda_ms(lambda: core.legendre_synth_plain(C, t), 1)
        pms_a, PA = cuda_ms(lambda: core.legendre_anal_plain(G, LMAX, t), 1)
        es, ea = rel_max(G, PG), rel_max(A, PA)
        check(es <= 1e-5 and ea <= 1e-5, 'K3/K4 vs plain at lmax 2048 on %d cap rings, batch '
              '%d: synth %.2e anal %.2e of max > 1e-5' % (ncap, B, es, ea))
        phase(2, '(2b) lmax 2048, %d north-cap rings of nside %d, n -2, f32, batch %d: synth '
                 '%.3f ms (block shape %s; plain %.1f ms, %.2e of max), anal %.3f ms (%s; '
                 'plain %.1f ms, %.2e of max), both bitwise equal on a second run'
              % (ncap, NSIDE, B, ms_s, shape('plain', B), pms_s, es, ms_a, split('anal'), pms_a,
                 ea))
        del C, G, A0, A, PG, PA
    del t
    # all 8191 rings, batch 4, n = -2: phase 5b's shape (uncached, as phase 5b builds its own)
    R, B, L = hgeom.nrings, 4, LMAX + 1
    t = core.full_tables(LMAX, LMAX, -2, hgeom.theta, None, dev)
    full = {}
    for cdt in (torch.complex64, torch.complex128):
        C = crandn((B, L, L), cdt)
        G0 = lk.synth(C, R, t)
        ms_s, G = cuda_ms(lambda: lk.synth(C, R, t), 2)
        check(torch.equal(G0, G), 'K3 synth on all %d rings is not deterministic' % R)
        del G0
        A0 = lk.anal(G, LMAX, t)
        ms_a, A = cuda_ms(lambda: lk.anal(G, LMAX, t), 2)
        check(torch.equal(A0, A), 'K4 anal on all %d rings is not deterministic' % R)
        del A0
        full[cdt] = (ms_s, ms_a)
        phase(2, '(2b) lmax 2048, all %d rings of nside %d, n -2, %s, batch %d: synth %.3f ms '
                 '(block shape %s), anal %.3f ms (%s), both bitwise equal on a second run'
              % (R, NSIDE, cdt, B, ms_s, shape('plain', B, 'f32' if cdt == torch.complex64
                                               else 'f64'), ms_a, split('anal')))
    # phase 5b's shape (f64): the kernels against their plain versions, timed
    pms_s, PG = cuda_ms(lambda: core.legendre_synth_plain(C, t), 1)
    pms_a, PA = cuda_ms(lambda: core.legendre_anal_plain(G, LMAX, t), 1)
    check(rel_max(G, PG) <= 1e-12 and rel_max(A, PA) <= 1e-12,
          'K3/K4 vs plain on all %d rings, f64: %.2e / %.2e' % (R, rel_max(G, PG), rel_max(A, PA)))
    stats_p = {'synth': (full[torch.complex128][0], pms_s, (G - PG).abs().max().item())
                        + plain_bound(t, B, R, True),
               'anal': (full[torch.complex128][1], pms_a, (A - PA).abs().max().item())
                       + plain_bound(t, B, R, True)}
    phase(2, '(2b) the same in f64: plain synth %.1f ms, plain anal %.1f ms, %.2e / %.2e of max'
          % (pms_s, pms_a, rel_max(G, PG), rel_max(A, PA)))
    del C, G, A, PG, PA, t
    # the exact pixel window's shape: 48 node rings, 64 pixel shapes, lmax 512 (nside 128)
    Gm, th_pw, _ = _ring_Gm(128, 128, 512)
    Gm = torch.as_tensor(Gm, device=dev)
    t = core.full_tables(512, 512, 2, th_pw, None, dev)
    lk.anal(Gm, 512, t)
    ms_pw, _ = cuda_ms(lambda: lk.anal(Gm, 512, t), 5)
    phase(2, '(2b) pixel-window shape, %d node rings x %d shapes, lmax 512, f64: anal %.3f ms '
             '(%s)' % (len(th_pw), Gm.shape[0], ms_pw, split('anal')))
    del Gm, t
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 3 sht
    sht = SHT(gl_geometry(LMAX), LMAX, dtype=torch.float32, device=dev)
    ls, ms = ualm._lm_indices(LMAX)
    ls, ms = torch.as_tensor(ls, device=dev), torch.as_tensor(ms, device=dev)

    def rand_alm(spin):
        a = crandn((1, len(ls)), torch.complex64)
        a = torch.where(ms == 0, a.real.to(a.dtype), a)
        return torch.where(ls < spin, torch.zeros_like(a), a)

    tlm = rand_alm(0)
    e0 = rel_max(sht.map2alm(sht.alm2map(tlm)), tlm)
    glm, clm = rand_alm(2), rand_alm(2)
    g2, c2 = sht.map2alm_spin(sht.alm2map_spin((glm, clm), 2), 2)
    e2 = max(rel_max(g2, glm), rel_max(c2, clm))
    check(e0 <= 1e-4 and e2 <= 1e-4, 'SHT round trip errors %.2e / %.2e > 1e-4' % (e0, e2))
    phase(3, 'SHT round trip at lmax 2048, f32, kernel path: spin 0 %.2e, spin 2 %.2e of max'
          % (e0, e2))
    del sht, tlm, glm, clm, g2, c2

    # ---------------------------------------------------------------- 4 main path
    os.environ.update(PLK_LMAX_IVF=str(LMAX), PLK_LMAX_QLM=str(LMAX),
                      PLK_NSIMS=str(NSIMS))
    os.environ.pop('PLK_CACHE_DIR', None)
    sys.path.insert(0, os.path.join(HERE, 'examples'))
    import run_qlms_torch as drv
    from profile_healpix_torch import healpix_path
    par = drv.load_parfile(os.path.join(HERE, 'params', 'idealized_example_torch.py'), dev)
    check(par.QE_DTYPE == torch.float32, 'production QEs run in float32 on the card')
    idxs = list(range(NSIMS))
    core.TABLES.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    lk.reset_launches()
    t_main = time.perf_counter()
    teb, s_filt = drv.stage_filt(par, idxs)
    qlms, s_qe = drv.stage_qe(par, KEYS, idxs)
    mfs, s_mf = drv.stage_mf(par, KEYS)
    qcls, s_qcl = drv.stage_qcl(par, KEYS, par.mc_sims_var)
    torch.cuda.synchronize()
    t_main = time.perf_counter() - t_main
    launches = dict(lk.launches)
    k1_shapes = dict(lk.synth_pair_shapes)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    phase(4, 'stages at lmax %d, %d sims, keys %s: filt %.3fs, qe %.3fs, mf %.3fs, '
          'qcl(sims %s) %.3fs; %.1fs wall; peak memory %.2f GiB; launches %s'
          % (LMAX, NSIMS, '/'.join(KEYS), s_filt, s_qe, s_mf,
             ','.join(map(str, par.mc_sims_var)), s_qcl, t_main, peak, launches))
    phase(4, 'K1 synth_pair launches by (mode, batch, data type): %s'
          % ', '.join('%s x %d' % kv for kv in sorted(k1_shapes.items())))
    check(sum(k1_shapes.values()) == launches['synth_pair'], 'K1 launches by shape')
    for name in ('synth_pair', 'anal_pair'):
        check(launches[name] > 0, 'kernel %s was not launched by the main path' % name)
    nalm = ualm.getsize(LMAX)
    for x in teb:
        check(tuple(x.shape) == (NSIMS, nalm) and bool(torch.isfinite(x).all()), 'filt output')
    for k in KEYS:
        check(tuple(qlms[k].shape) == (NSIMS, nalm) and qlms[k].dtype == torch.complex64
              and bool(torch.isfinite(qlms[k]).all()), 'qe output %s' % k)
        check(len(mfs[k]) == 2 and all(bool(torch.isfinite(m).all()) for m in mfs[k]),
              'mf output %s' % k)
    for key, cl in qcls.items():
        check(cl.shape == (len(par.mc_sims_var), LMAX + 1) and bool(np.isfinite(cl).all()),
              'qcl output %s' % (key,))
    try:
        par.qcls_dd.get_sim_qcl_batch('ptt', [0])
        raise RuntimeError('chip_smoke: the MF-containment guard did not raise')
    except ValueError:
        pass

    from plancklens_tpu_torch.models.qest import QELib, eval_qe
    q64 = QELib(par.ivfs, par.ivfs, par.cl_len, LMAX, LMAX, dtype=torch.float64, device=dev)
    a64 = q64.get_sim_qlm('ptt', 4)
    a32 = par.qlms_dd.get_sim_qlm('ptt', 4).to(torch.complex128)
    gap = ((a32 - a64).abs().pow(2).sum().sqrt() / a64.abs().pow(2).sum().sqrt()).item()
    gap_max = rel_max(a32, a64)
    check(gap <= 1e-3, 'f32 vs f64 qlm relative rms %.3e > 1e-3' % gap)
    phase(4, 'sim 4 ptt qlm, f32 vs f64 kernels: relative rms %.3e, max %.3e of max'
          % (gap, gap_max))

    # small input: the CUDA path against the CPU plain path
    lsmall = 64
    gen_cpu = torch.Generator().manual_seed(64)
    alms = {f: torch.randn((2, ualm.getsize(lsmall)), generator=gen_cpu,
                           dtype=torch.complex128) for f in 'teb'}
    cls_w = {k: v[:lsmall + 1] for k, v in par.cl_len.items()}
    small = []
    for k in KEYS:
        g_cpu = eval_qe(k, lsmall, cls_w, lambda f: alms[f], lsmall, device='cpu')[0]
        g_gpu = eval_qe(k, lsmall, cls_w, lambda f: alms[f].to(dev), lsmall, device=dev)[0]
        small.append(rel_max(g_gpu.cpu(), g_cpu))
    check(max(small) <= 1e-10, 'QE on the card vs CPU plain path at lmax 64: %s' % small)
    phase(4, 'QE ptt/p_p at lmax 64, f64: CUDA kernel path vs CPU plain path %.2e of max'
          % max(small))

    del q64, a64, a32
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 5a pixwin
    torch.cuda.synchronize()
    n0 = lk.launches['anal']
    t0 = time.perf_counter()
    wt, wp = pixwin_exact(128, pol=True, device=dev)
    s_pw = time.perf_counter() - t0
    shipped = np.load(os.path.join(DATAPATH, 'pixwin', 'pixwin_n0128_pol.npy'))
    e_pw = max(np.abs(wt - shipped[0]).max() / np.abs(shipped[0]).max(),
               np.abs(wp - shipped[1]).max() / np.abs(shipped[1]).max())
    check(e_pw <= 1e-10, 'exact pixel window of nside 128 vs shipped table: %.2e' % e_pw)
    phase(5, '(5a) pixwin_exact(128, pol=True), f64: %.2fs, %d K4 calls, %.2e of max from '
             'the shipped tables' % (s_pw, lk.launches['anal'] - n0, e_pw))

    # ---------------------------------------------------------------- 5b healpix path
    import tempfile
    obs = par.sims.get_sim_teblm_batch(HP_SIMS)                 # (4, nalm) complex128 each
    ref_q = {k: par.qlms_dd.get_sim_qlm_batch(k, HP_SIMS) for k in KEYS}   # phase 4's
    core.TABLES.clear()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lk.reset_launches()
    t_hp = time.perf_counter()
    with tempfile.TemporaryDirectory() as tdir:
        (tmap, qmap, umap), (tlm, elm, blm), hq, secs = healpix_path(
            par, obs, HP_SIMS, KEYS, tdir, NSIDE, LMAX, dev)
    torch.cuda.synchronize()
    t_hp = time.perf_counter() - t_hp
    hp_launches = dict(lk.launches)
    peak_hp = torch.cuda.max_memory_allocated() / 2 ** 30
    phase(5, '(5b) HEALPix path, nside %d, lmax %d, sims %s, f64 transforms, cold: %s; %.1fs '
             'wall; peak memory %.2f GiB; launches %s'
          % (NSIDE, LMAX, HP_SIMS, ', '.join('%s %.3fs' % kv for kv in secs.items()), t_hp,
             peak_hp, hp_launches))
    for name in ('synth', 'anal'):
        check(hp_launches[name] > 0, 'kernel %s was not launched by the HEALPix path' % name)
    npix = 12 * NSIDE ** 2
    for x in (tmap, qmap, umap):
        check(tuple(x.shape) == (len(HP_SIMS), npix) and bool(torch.isfinite(x).all()),
              'HEALPix maps')
    for x in (tlm, elm, blm):
        check(tuple(x.shape) == (len(HP_SIMS), nalm) and bool(torch.isfinite(x).all()),
              'HEALPix alms')
    # the round trip, T at all l and E/B at l >= 2 (a spin-2 map carries no l < 2 modes)
    hi = ualm._dev_index(LMAX, dev, 'l') >= 2
    rt = [rel_rms(tlm, obs[0]), rel_rms(elm[:, hi], obs[1][:, hi]),
          rel_rms(blm[:, hi], obs[2][:, hi])]
    gaps = {k: rel_rms(hq[k].to(torch.complex128), ref_q[k].to(torch.complex128)) for k in KEYS}
    phase(5, '(5b) alm round trip (relative rms, T / E / B): %.3e / %.3e / %.3e; qlm vs the '
             'harmonic route of phase 4: %s'
          % (*rt, ', '.join('%s %.3e' % kv for kv in gaps.items())))
    check(max(rt) <= 1e-6, 'HEALPix alm round trip %s > 1e-6' % rt)
    for k in KEYS:
        check(tuple(hq[k].shape) == (len(HP_SIMS), nalm) and bool(torch.isfinite(hq[k]).all()),
              'HEALPix qlm %s' % k)
        check(gaps[k] <= 1e-5, 'HEALPix qlm %s vs harmonic route: %.3e > 1e-5' % (k, gaps[k]))
    del obs, tmap, qmap, umap, tlm, elm, blm, hq
    # the default analysis weights: a (3 nside + 1) x (4 nside - 1) least-norm solve,
    # QR on the card
    t0 = time.perf_counter()
    w = hgeom.ring_weights(device=dev)
    s_w = time.perf_counter() - t0
    check(bool(np.isfinite(w).all()) and abs(np.dot(w, hgeom.nphi) / (4. * np.pi) - 1.) < 1e-10,
          'HEALPix ring weights')
    phase(5, '(5b) ring weights of nside %d (QR of %d x %d on the card): %.2fs'
          % (NSIDE, 3 * NSIDE + 1, hgeom.nrings, s_w))
    del hgeom, w
    core.TABLES.clear()
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 6 masked filtering
    from masked_filter_torch import aniso_inputs, masked_path, true_rel
    from plancklens_tpu_torch.models import cinv as pcinv
    from plancklens_tpu_torch.utils import camb_clfile
    from torch.profiler import profile, ProfilerActivity
    cpu = torch.device('cpu')
    # 6a: the CG loop on the kernels against the CG loop on the twins, lmax 64, batch 2
    from plancklens_tpu_torch.utils.cachers import cacher_mem
    g64, tf64, ninv64 = aniso_inputs(lsmall)
    cls64 = camb_clfile(os.path.join(DATAPATH, 'cls', 'FFP10_wdipole_lensedCls.dat'),
                        lmax=lsmall)
    sht64 = SHT(g64, lsmall, device=cpu)
    rng = np.random.RandomState(64)
    ls64, ms64 = ualm._lm_indices(lsmall)

    def sky(cl, nlev):
        a = rng.standard_normal((2, len(ls64))) + 1j * rng.standard_normal((2, len(ls64)))
        a[:, ms64 == 0] = a[:, ms64 == 0].real * np.sqrt(2.)
        return torch.as_tensor(a / np.sqrt(2.) * np.sqrt(cl[ls64]) * tf64[ls64]), \
            rng.standard_normal((2, g64.nrings, g64.nphi)) * nlev / 60. / 180. * np.pi \
            / np.sqrt(np.outer(g64.weight, np.full(g64.nphi, 2. * np.pi / g64.nphi)))

    def perturbed(a):
        return a * (1. + 1e-15 * rng.standard_normal(a.shape))

    # (field, noise level in uK-arcmin, lmax_dense, limit of the card's solution against the
    # CPU path's: None = 10x the CPU path's own change under a 1e-15 change of its maps and
    # of its inverted dense block). The anisofilt T system at 35 uK-arcmin amplifies rounding
    # by its condition (106 iterations; such a change moves its solution by ~5e-8 of max, and
    # the card's is ~2x that from the CPU's). At 3000 uK-arcmin (14 iterations, ~5e-13 for
    # such a change) and in the P system (~1e-15) the two are held to 1e-10 (PERF.md)
    cases = (('t', 35., lsmall // 2, None), ('t', 3000., lsmall // 2, 1e-10),
             ('p', 55., lsmall // 2, 1e-10))
    for field, nlev, ld, tol in cases:
        if field == 't':
            s_t, n_t = sky(cls64['tt'], nlev)
            maps = (sht64.alm2map(s_t).numpy() + n_t,)
            ninv = ninv64['t'] * (35. / nlev) ** 2
        else:
            (s_e, n_q), (s_b, n_u) = sky(cls64['ee'], nlev), sky(cls64['bb'], nlev)
            q64, u64 = sht64.alm2map_spin((s_e, s_b), 2)
            maps = (q64.numpy() + n_q, u64.numpy() + n_u)
            ninv = ninv64['p']

        def filt(d, cacher=None):
            cls_ = pcinv.CinvT if field == 't' else pcinv.CinvP
            return cls_(lsmall, g64, cls64, tf64, ninv, lmax_dense=ld, dense_cacher=cacher,
                        device=d)
        held = cacher_mem()
        f_gpu, f_cpu = filt(dev), filt(cpu, held)
        (key, minv), = held._cache.items()
        minv_n = cacher_mem()
        minv_n.cache(key, 0.5 * (perturbed(minv) + perturbed(minv).T))
        f_n = filt(cpu, minv_n)
        x_g, it_g, rel_g = f_gpu.solve_wf(*maps)
        x_c, it_c, rel_c = f_cpu.solve_wf(*maps)
        x_n, it_n, _ = f_n.solve_wf(*[perturbed(m) for m in maps])
        err, floor = rel_max(x_g.cpu(), x_c), rel_max(x_n, x_c)
        limit = 10. * floor if tol is None else tol
        # the loop's operators on the same vectors, card against CPU: the right-hand side
        # and the forward op (the kernels' part), and the preconditioner, whose dense f64
        # product differs with its summation order as far as its condition lets it
        b_c = f_cpu.calc_prep(*maps)
        ops = max(rel_max(f_gpu.calc_prep(*maps).cpu(), b_c),
                  rel_max(f_gpu.fwd_op(b_c.to(dev)).cpu(), f_cpu.fwd_op(b_c)))
        pre = rel_max(f_gpu.pre_op(b_c.to(dev)).cpu(), f_cpu.pre_op(b_c))
        # the card's solution in the CPU path's system
        res = true_rel(f_cpu, b_c, x_g.cpu(), f_cpu._ms if field == 't' else f_cpu._ms2)
        # a warm solve on the card, traced: no host-to-device copy in the loop
        maps_d = [torch.as_tensor(m, device=dev) for m in maps]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, it_w, _ = f_gpu.solve_wf(*maps_d)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()]
        h2d, d2h = sum('HtoD' in n for n in names), sum('DtoH' in n for n in names)
        k1 = sum('synth_pair_kernel' in n for n in names)
        phase(6, '(6a) Cinv%s at lmax %d (lmax_dense %d), f64, batch 2, the anisofilt mask, '
                 '%g uK-arcmin: %d iterations on the card, %d on the CPU; right-hand side and '
                 'forward op %.2e of max from the CPU path\'s, preconditioner %.2e; the card\'s '
                 'solution has a residual of %s in the CPU system and is %.2e of max from the '
                 'CPU solution (limit %.2e; the CPU solution moves by %.2e under a 1e-15 '
                 'change of its maps and inverted dense block); a warm solve on the card '
                 'traced: %d K1 launches, %d host-to-device and %d device-to-host copies over '
                 '%d iterations'
              % (field.upper(), lsmall, ld, nlev, it_g, it_c, ops, pre,
                 np.array2string(res.numpy(), precision=3), err, limit, floor, k1, h2d, d2h,
                 it_w))
        check(it_g == it_c == it_n and it_g > 5 and bool((rel_g < 1e-5).all())
              and bool((res < 1e-5).all()),
              'Cinv%s at lmax %d: iterations %d (card) / %d (CPU) / %d (perturbed), card '
              'solution residual %s' % (field.upper(), lsmall, it_g, it_c, it_n, res))
        check(ops <= 1e-12, 'Cinv%s right-hand side / forward op on the card vs CPU: %.2e'
              % (field.upper(), ops))
        check(err <= limit, 'Cinv%s at %g uK-arcmin, card vs CPU: %.2e > %.2e'
              % (field.upper(), nlev, err, limit))
        check(k1 > 0 and h2d == 0 and d2h <= it_w + 2, 'Cinv%s solve trace: %d K1 launches, '
              '%d host-to-device, %d device-to-host copies' % (field.upper(), k1, h2d, d2h))
        del f_gpu, f_cpu, f_n, prof
    # 6b-6d: lmax 2048, the anisofilt configuration on the idealized parfile's sims; the
    # dense blocks stay in `dense_blocks` for phase 7c's filters (the same keys)
    core.TABLES.clear()
    torch.cuda.empty_cache()
    nalm = ualm.getsize(LMAX)
    dense_blocks = cacher_mem()
    m6 = masked_path(par, dev, LMAX, f32=True, dense_cacher=dense_blocks,
                     log=lambda s: phase(6, s))
    for step, batch in (('t', 8), ('p', 4)):
        st = m6[step]
        rels = np.concatenate([st['rel'], st.get('true_rel', [])])
        check(st['it'] < 300 and bool((rels < 1e-5).all()),
              'Cinv%s at lmax %d did not converge below 1e-5: %d iterations, %s'
              % (step.upper(), LMAX, st['it'], rels))
        mode = 0 if step == 't' else 1
        check(st['k1'].get((mode, batch, 'f64'), 0) > 0
              and st['k2'].get((mode, batch, 'f64'), 0) > 0,
              'Cinv%s did not run K1/K2 mode %d at batch %d: %s %s'
              % (step.upper(), mode, batch, st['k1'], st['k2']))
        check(st['peak_gib'] < 40., 'Cinv%s peak memory %.2f GiB' % (step.upper(), st['peak_gib']))
    pr = m6['p_probe']
    check(pr['peak_gib'] < 40. and pr['workspace_bytes'] <= lk.WORKSPACE_CAP
          and pr['launches']['synth_pair'] > 0 and pr['launches']['anal_pair'] > 0,
          'CinvP probe: peak %.2f GiB, workspace %s, launches %s'
          % (pr['peak_gib'], pr['workspace_bytes'], pr['launches']))
    ro = m6['route']
    check(ro['launches']['synth_pair'] > 0 and ro['launches']['anal_pair'] > 0,
          'the masked route launched %s' % ro['launches'])
    gaps6 = {}
    for k, q in m6['route_qlms'].items():
        check(tuple(q.shape) == (len(ro['sims']), nalm) and bool(torch.isfinite(q).all()),
              'masked route qlm %s' % k)
        gaps6[k] = rel_rms(q.to(torch.complex128), qlms[k][ro['sims']].to(torch.complex128))
    phase(6, '(6d) masked-route qlm against the full-sky qlm of phase 4, same sims (relative '
             'rms, not checked): %s' % ', '.join('%s %.3e' % kv for kv in gaps6.items()))
    cg_launches = (m6['t']['k1'][0, 8, 'f64'], m6['t']['k2'][0, 8, 'f64'])
    del m6
    torch.cuda.empty_cache()
    # K1/K2 at the CG shape of 6b (spin 0, one input, f64, batch 8, 2049 rings) against
    # their plain versions, for the kernels' line
    g6 = gl_geometry(LMAX)
    nr6, B, L = g6.nrings, 8, LMAX + 1
    t_0, _ = core.pair_tables(LMAX, LMAX, 0, g6.theta, None, dev)
    C = crandn((B, L, L), torch.complex128)
    F0, _ = lk.synth_pair(C, None, 0, nr6, t_0, t_0)
    ms_s, (F, _) = cuda_ms(lambda: lk.synth_pair(C, None, 0, nr6, t_0, t_0), 3)
    check(torch.equal(F0, F), 'synth_pair at the CG shape is not deterministic')
    Q6 = (F * torch.as_tensor(g6.weight, device=dev)[:, None]).contiguous()
    A0, _ = lk.anal_pair(Q6, None, 0, LMAX, t_0, t_0)
    ms_a, (A, _) = cuda_ms(lambda: lk.anal_pair(Q6, None, 0, LMAX, t_0, t_0), 3)
    check(torch.equal(A0, A), 'anal_pair at the CG shape is not deterministic')
    pms_s, (PF, _) = cuda_ms(lambda: core.legendre_synth_pair_plain(C, None, 0, nr6, t_0, t_0), 1)
    pms_a, (PA, _) = cuda_ms(lambda: core.legendre_anal_pair_plain(Q6, None, 0, LMAX, t_0, t_0),
                             1)
    check(rel_max(F, PF) <= 1e-12 and rel_max(A, PA) <= 1e-12, 'K1/K2 vs plain at the CG '
          'shape: %.2e / %.2e' % (rel_max(F, PF), rel_max(A, PA)))
    # mode 0: one recursion on the 1025 northern rings, one sum a map (roofline.PAIR_WORK)
    b6 = pair_bound((t_0,), 0, B, nr6, True)
    stats_cg = {'synth': (ms_s, pms_s, (F - PF).abs().max().item()) + b6,
                'anal': (ms_a, pms_a, (A - PA).abs().max().item()) + b6}
    phase(6, 'K1/K2 at the CG shape (spin 0, one input, f64, batch 8, %d rings): synth %.3f ms '
             '(plain %.1f ms, %.2e of max), anal %.3f ms (%s; plain %.1f ms, %.2e of max), '
             'bound %.3f ms (%s), both bitwise equal on a second run'
          % (nr6, ms_s, pms_s, rel_max(F, PF), ms_a, split('anal_pair'), pms_a, rel_max(A, PA),
             b6[0], b6[1]))
    del C, F0, F, Q6, A0, A, PF, PA, t_0
    del par
    core.TABLES.clear()
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 7 lensed masked chain
    from lensed_chain_torch import card_vs_cpu, lensed_sims, parfile_chain
    log7 = lambda s: phase(7, s)
    t7 = time.perf_counter()
    r7a = card_vs_cpu(dev, log=log7)
    check(r7a['maps_err'] <= 1e-10 and r7a['alms_err'] <= 1e-10,
          'lensing on the card vs the CPU plain path: maps %.2e, alms %.2e > 1e-10'
          % (r7a['maps_err'], r7a['alms_err']))
    check(r7a['launches']['synth_pair'] > 0 and r7a['launches']['anal_pair'] > 0
          and r7a['curl_moves'] > 1e-6, '7a: launches %s, the curl moves T by %.2e'
          % (r7a['launches'], r7a['curl_moves']))
    r7b = lensed_sims(dev, LMAX, sims=HP_SIMS, log=log7)
    path7 = Counter()
    for v in r7b['launches'].values():
        path7.update(v)
    check(sum(v for k, v in path7.items() if k[0] == 'synth_pair') > 0
          and sum(v for k, v in path7.items() if k[0] == 'anal_pair') > 0,
          'the lensed sims did not launch K1 and K2: %s' % dict(path7))
    check(r7b['peak_gib'] < 40., 'lensed sims peak memory %.2f GiB' % r7b['peak_gib'])
    check(r7b['split_vs_library'] <= 1e-10, 'step-by-step lensed sim vs the libraries: %.2e'
          % r7b['split_vs_library'])
    for k, sp in r7b['spectra'].items():
        dev_k = np.abs(sp['ratio'] - 1.)
        check(bool(np.all(dev_k <= sp['bound'])), 'lensed %s / FFP10 lensed: %s beyond %s'
              % (k.upper(), sp['ratio'], sp['bound']))
    for name, row in r7b['kernels'].items():
        check(row['rel_err'] <= 1e-12, '%s vs plain: %.2e' % (name, row['rel_err']))
    r7c = parfile_chain(dev, LMAX, nsims=len(HP_SIMS), dense_cacher=dense_blocks, log=log7)
    check(r7c['finite'], 'the lensed chain gave non-finite outputs')
    for k, a in r7c['ampl'].items():
        check(0.7 <= a <= 1.3, '<q x phi_in> / (R C^pp fsky) of %s: %.4f outside [0.7, 1.3]'
              % (k, a))
    phase(7, 'phase 7 wall %.1fs; the whole run so far %.1fs'
          % (time.perf_counter() - t7, time.perf_counter() - T_START))
    del r7c
    core.TABLES.clear()
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 8 N1 and band-powers
    phase8(dev, dense_blocks)

    # ---------------------------------------------------------------- 9 joint T/P, GMV
    r9b, rows9 = phase9(dev, dense_blocks)
    del dense_blocks

    # ---------------------------------------------------------------- 10 Planck 2018 file
    phase10(dev)

    # launches of the 4 sims' steps, at each new row's shape
    lens_launches = {'synth_pair_ecp_t': ('ecp_t', ('synth_pair', 0, 1, 'f64')),
                     'synth_pair_ecp_qu': ('ecp_qu', ('synth_pair', 1, 1, 'f64')),
                     'synth_pair_deflection': ('deflection', ('synth_pair', 1, 1, 'f64')),
                     'anal_pair_lensed_eb': ('map2alm', ('anal_pair', 1, 1, 'f64'))}

    kernels = []
    for name, st, n in (('synth_pair', stats[8]['synth'], launches['synth_pair']),
                        ('anal_pair', stats[8]['anal'], launches['anal_pair']),
                        ('synth', stats_p['synth'], hp_launches['synth']),
                        ('anal', stats_p['anal'], hp_launches['anal']),
                        ('synth_pair_cg', stats_cg['synth'], cg_launches[0]),
                        ('anal_pair_cg', stats_cg['anal'], cg_launches[1])):
        ms_k, ms_p, err_abs = st[:3]
        bound_ms, bound_by = st[-2:]
        kernels.append({'name': name, 'route': 'cuda', 'source': SRC,
                        'replaces': REPLACES[name.replace('_cg', '')], 'launches': n,
                        'max_abs_err': err_abs, 'ms': ms_k, 'plain_ms': ms_p,
                        'bound_ms': bound_ms, 'bound_by': bound_by, 'library_ms': None})
    for name, row in r7b['kernels'].items():
        step, shape_key = lens_launches[name]
        kernels.append({'name': name, 'route': 'cuda', 'source': SRC,
                        'replaces': REPLACES[shape_key[0]],
                        'launches': r7b['launches'].get(step, {}).get(shape_key, 0),
                        'max_abs_err': row['max_abs_err'], 'ms': row['ms'],
                        'plain_ms': row['plain_ms'], 'bound_ms': row['bound_ms'],
                        'bound_by': row['bound_by'], 'library_ms': None})
    # launches of 9b's lockstep solve at each joint-operator shape
    for name, row in rows9.items():
        shapes = r9b['k1'] if name.startswith('synth') else r9b['k2']
        kernels.append({'name': name, 'route': 'cuda', 'source': SRC,
                        'replaces': REPLACES[name.split('_tp')[0]],
                        'launches': shapes.get((row['mode'], row['batch'], 'f64'), 0),
                        'max_abs_err': row['max_abs_err'], 'ms': row['ms'],
                        'plain_ms': row['plain_ms'], 'bound_ms': row['bound_ms'],
                        'bound_by': row['bound_by'], 'library_ms': None})
    print(smi)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
