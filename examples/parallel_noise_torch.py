#!/usr/bin/env python
r"""The noise-model tools and the parallel layer of the PyTorch port at full width
(chip_smoke.py phase 11; each function runs alone too, on a card or, at small sizes, on the
CPU):

  11a `freq_weighting_full`: models/freq_weighting at the SMICA-like configuration: four
      channels standing for the 100/143/217/353 GHz inputs, synthetic l-dependent weights
      (inverse-noise weights of synthetic beams and white levels, summing to 1 at each l,
      l = 0..2047; Planck's SMICA weights are not in the repository), synthetic scan-pattern
      variance maps on gl_geometry(4096), so lmax_out = 4094 holds the squared weights'
      whole band: vmaps2vmap_I, then vmaps2vmap_P with E/B weights, on the default GL
      nodes (above 2048 nodes the Newton iteration of ops/gauleg, whose edge weights hold
      where scipy's drift). Checks: uniform maps s_i^2 give sum_i s_i^2 mean(Omega) sum_l
      (2l+1) w_il^2 / (4 pi) everywhere (exact for a monopole; 1e-10 relative), P's
      halving identity and E/B swap symmetry (1e-10), and the card against the CPU at lmax
      256 (1e-12 of max). `fw_kernel_rows` times K1 (mode 0, batch 1) and K2 (mode 0,
      batch 4) at its f64 shape against their twins.
  11b `patchy_full`: models/patchy.get_patchy_N0s for ptt and p_p at lmax_ivf = lmax_qlm =
      2048 with 4 'percentiles' patches of an inverse-variance map made of the anisofilt
      mask (params/anisofilt_example_torch.py) times a scan pattern, 35 / 55 uK-arcmin on
      average, 5' beam, lmin 100. Checks: a uniform map gives the four schemes equal to
      1e-4 and |MC - 1| < 0.1 over 20 <= L <= 1500; every scheme lies between the
      deepest and the shallowest patch's homogeneous N0 (x 0.95 / 1.05); mv-rew <= no-rew
      x 1.001; and `patchy_card_vs_cpu`: the card against the CPU at lmax 256, N0 by
      ROADMAP fault 3.9's rule (bandpowers_demo_torch.n0_limit of the largest change of
      the CPU path under four 1e-15 changes of its spectra), MC / cMC within 1e-10.
  11c `sharded_world1`: a world-size-1 NCCL group on the card: the idealized parfile at
      lmax 2048 on 8 sims through parallel.mesh.ShardedIVFS -> QELib ptt against the
      unsharded run in the same process (1e-10 relative; bitwise expected), and
      `m_block_rows`: K1/K2 on the two balanced even-start m-blocks of lmax 2048 (spin 0,
      and the spin-2 pair; f64, batch 4) against the unsplit call (1e-12 of max) and their
      twins, each block timed.
  11d `two_ranks_one_card`: two processes on the one card, launched with the environment
      `srun -n 2` gives them on one node (no MASTER_ADDR/MASTER_PORT, no PLK_COORD): each
      resolves its rendezvous, card and backend itself and reports them, cuda:0 and gloo
      expected (NCCL refuses two ranks on one card; gloo's collectives stage CUDA tensors
      through the host). Each runs `shard_sht` with n_m = 2 at lmax 2048 (alm2map /
      map2alm, spins 0 and 2, f64, batch 4) and a sims-sharded isotropic filtering of 4
      sims through ShardedIVFS; each rank gathers both and holds them to the
      single-process result (1e-12 of max). Each rank prints its m-split and its seconds;
      each is waited on with a timeout and killed on expiry, and a failure of either fails
      the run.

    python examples/parallel_noise_torch.py [--device cuda] [--parts a,b,c,d]
"""
import argparse
import json
import os
import subprocess
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_HERE)
for _p in (_REPO, _HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np
import torch

from plancklens_tpu_torch import DATAPATH
from plancklens_tpu_torch.utils import camb_clfile
from lensed_chain_torch import _kernel_row

FREQS = (100, 143, 217, 353)
# synthetic per-channel beams (FWHM, arcmin) and white levels (T, P; uK-arcmin), of the
# order of the HFI channels': they make l-dependent inverse-noise weights
FWHM = (9.7, 7.3, 5.0, 4.9)
NLEV_T = (77., 33., 47., 154.)
NLEV_P = (118., 70., 105., 439.)
LMAX_W = 2047          # weights l = 0..2047: lmax_out = 4094 on gl_geometry(4096)
NSIDE_FW = 4096        # the GL grid of 11a
NLEV_PATCHY = (35., 55.)
LMIN_PATCHY = 100
SEL = slice(20, 1501)  # 20 <= L <= 1500


def _sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def _rel(a, b):
    a = torch.as_tensor(a)
    b = torch.as_tensor(b).to(a.device)
    return float((a - b).abs().max() / b.abs().max())


def _cls(name, lmax):
    return camb_clfile(os.path.join(DATAPATH, 'cls', 'FFP10_wdipole_%s.dat' % name), lmax=lmax)


# ------------------------------------------------------------------ 11a freq_weighting
def channel_weights(lmax, nlevs, scale=None):
    """(4, lmax + 1) inverse-noise weights of the channels' beams and levels, summing to 1
    at each l (a SMICA-like combination without foregrounds)."""
    ls = np.arange(lmax + 1)
    inv = []
    for i, (fwhm, nl) in enumerate(zip(FWHM, nlevs)):
        s2 = (fwhm / 60. / 180. * np.pi) ** 2 / (8. * np.log(2.))
        f = 1. if scale is None else scale[i]
        inv.append(1. / ((f * nl) ** 2 * np.exp(ls * (ls + 1.) * s2)))
    inv = np.array(inv)
    return inv / inv.sum(0)


def scan_vmaps(geom, nlevs, device):
    """Per-channel pixel-variance maps, (nrings, nphi) f64 on `device`: white level over
    the mean pixel area, shaped by a scan pattern (deep at the ecliptic poles, a
    per-channel tilt of the poles and a ring modulation in longitude)."""
    th = torch.as_tensor(geom.theta, device=device)[:, None]
    ph = torch.as_tensor(2. * np.pi * np.arange(geom.nphi) / geom.nphi + geom.phi0,
                         device=device)[None, :]
    omega = float(np.mean(geom.weight)) * 2. * np.pi / geom.nphi
    out = []
    for i, nl in enumerate(nlevs):
        tilt, lon = np.radians(60. + 5. * i), 0.7 * i
        cosang = torch.cos(th) * np.cos(tilt) + torch.sin(th) * np.sin(tilt) * torch.cos(ph - lon)
        hits = 1. + 3. * torch.exp(-(1. - cosang.abs()) / 0.03) + 0.2 * torch.cos(2. * ph) ** 2
        out.append((nl / 60. / 180. * np.pi) ** 2 / omega * hits.mean() / hits)
    return out


def w2wsq_monopole(weights, lmax_out, device):
    """max over channels of |w2wsq(w)[0] / (sum_l (2l+1) w_l^2 / 4 pi) - 1|: the GL
    quadrature's error on the squared correlation function's monopole (exact in exact
    arithmetic with the (2 lmax + lmax_out) / 2 + 1 nodes of w2wsq)."""
    from plancklens_tpu_torch.models import freq_weighting as fw
    ls = np.arange(weights.shape[1])
    return max(abs(float(fw.w2wsq(w, 0, 0, lmax_out, device=device)[0])
                   / (np.sum((2 * ls + 1.) * w ** 2) / (4. * np.pi)) - 1.) for w in weights)


def freq_weighting_full(device, nside=NSIDE_FW, lmax_w=LMAX_W, log=print):
    """11a (module docstring): the full-width run and its identities. Returns a dict of
    seconds, checks, kernel calls (of the two full-width runs) and peak memory."""
    from plancklens_tpu_torch.models import freq_weighting as fw
    from plancklens_tpu_torch.ops.sht import core, gl_geometry
    device = torch.device(device)
    cuda = device.type == 'cuda'
    geom = gl_geometry(nside)
    wT = channel_weights(lmax_w, NLEV_T)
    wE = channel_weights(lmax_w, NLEV_P)
    wB = channel_weights(lmax_w, NLEV_P, scale=(1.3, 1., 1.1, 0.8))
    vT, vP = scan_vmaps(geom, NLEV_T, device), scan_vmaps(geom, NLEV_P, device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    res = {'lmax_out': min(2 * lmax_w, (geom.nphi - 1) // 2, geom.nrings - 1),
           'grid': (geom.nrings, geom.nphi)}
    with core.counting() as c:
        t0 = time.perf_counter()
        vI = fw.vmaps2vmap_I(vT, wT, geom, device=device)
        _sync(device)
        t1 = time.perf_counter()
        vPP = fw.vmaps2vmap_P(vP, wE, wB, geom, device=device)
        _sync(device)
        t2 = time.perf_counter()
    res['calls'] = c.calls
    res['seconds'] = {'I': t1 - t0, 'P': t2 - t1}
    res['finite_positive'] = bool(torch.isfinite(vI).all() and (vI > 0).all()
                                  and torch.isfinite(vPP).all() and (vPP > 0).all())
    res['shape'] = tuple(vI.shape)
    # the mean variance against the channels' combined white level (a diagnostic)
    res['mean_I'], res['mean_P'] = float(vI.mean()), float(vPP.mean())
    del vI, vPP
    # identities at full width: the uniform monopole, P's halving and E/B swap
    t3 = time.perf_counter()
    s2 = [1.5, 0.7, 2.2, 0.4]
    uni = [torch.full((geom.nrings, geom.nphi), s, dtype=torch.float64, device=device)
           for s in s2]
    out = fw.vmaps2vmap_I(uni, wT, geom, device=device)
    ls = np.arange(lmax_w + 1)
    omega = float(np.mean(geom.weight)) * 2. * np.pi / geom.nphi
    expect = sum(s * omega * np.sum((2 * ls + 1.) * w ** 2) / (4. * np.pi)
                 for s, w in zip(s2, wT))
    res['monopole'] = float((out / expect - 1.).abs().max())
    del uni, out
    v1 = fw.vmaps2vmap_P(vP[:1], wE[:1], wB[:1], geom, device=device)
    v2 = fw.vmaps2vmap_P([vP[0], vP[0]], np.stack([wE[0] * .5] * 2),
                         np.stack([wB[0] * .5] * 2), geom, device=device)
    res['halving'] = _rel(v2, 0.5 * v1)
    del v2
    vs = fw.vmaps2vmap_P(vP[:1], wB[:1], wE[:1], geom, device=device)
    res['swap'] = _rel(vs, v1)
    del v1, vs
    _sync(device)
    res['seconds']['identities'] = time.perf_counter() - t3
    if cuda:
        res['peak_gib'] = torch.cuda.max_memory_allocated(device) / 2. ** 30
    log('(11a) freq_weighting, %d channels (%s GHz), weights l <= %d, '
        'gl_geometry(%d) %d x %d, lmax_out %d, f64: vmaps2vmap_I %.2fs, vmaps2vmap_P %.2fs, '
        'peak %.2f GiB; kernel calls %s'
        % (len(FREQS), '/'.join(map(str, FREQS)), lmax_w, nside, geom.nrings, geom.nphi,
           res['lmax_out'], res['seconds']['I'], res['seconds']['P'], res.get('peak_gib', 0.),
           dict(sorted(res['calls'].items()))))
    log('(11a) identities at full width (%.2fs): uniform monopole %.2e relative, P halving '
        '%.2e, E/B swap %.2e of max; the maps finite and positive: %s'
        % (res['seconds']['identities'], res['monopole'], res['halving'], res['swap'],
           res['finite_positive']))
    return res


def freq_weighting_card_vs_cpu(device, nside=256, lmax_w=127, log=print):
    """11a's card-against-CPU check at lmax 256: vmaps2vmap_I and _P on `device` and on the
    CPU, the same inputs (the default GL nodes); max relative difference of each."""
    from plancklens_tpu_torch.models import freq_weighting as fw
    from plancklens_tpu_torch.ops.sht import gl_geometry
    geom = gl_geometry(nside)
    cpu = torch.device('cpu')
    wT, wE = channel_weights(lmax_w, NLEV_T), channel_weights(lmax_w, NLEV_P)
    wB = channel_weights(lmax_w, NLEV_P, scale=(1.3, 1., 1.1, 0.8))
    vT = [v.cpu() for v in scan_vmaps(geom, NLEV_T, cpu)]
    vP = [v.cpu() for v in scan_vmaps(geom, NLEV_P, cpu)]
    dev = lambda vs: [v.to(device) for v in vs]
    errs = {'I': _rel(fw.vmaps2vmap_I(dev(vT), wT, geom, device=device).cpu(),
                      fw.vmaps2vmap_I(vT, wT, geom, device=cpu)),
            'P': _rel(fw.vmaps2vmap_P(dev(vP), wE, wB, geom, device=device).cpu(),
                      fw.vmaps2vmap_P(vP, wE, wB, geom, device=cpu))}
    log('(11a) card vs CPU at gl_geometry(%d), weights l <= %d: I %.2e, P %.2e of max'
        % (nside, lmax_w, errs['I'], errs['P']))
    return errs


def fw_kernel_rows(device, nside=NSIDE_FW, lmax_out=2 * LMAX_W, log=print):
    """K1 and K2 at 11a's shapes (mode 0, f64, 4097 rings, lmax 4094): K1 at batch 1 (the
    alm2map of the summed alm), K2 at batch 4 (the four channels' map2alm)."""
    from plancklens_tpu_torch.ops.sht import gl_geometry
    geom = gl_geometry(nside)
    rows = {}
    for name, kind, batch in (('synth_pair_fw', 'synth', 1), ('anal_pair_fw', 'anal', 4)):
        r = rows[name] = _kernel_row(kind, 0, 0, lmax_out, geom, device, batch=batch)
        log('(11a) %s at freq_weighting\'s shape (spin 0, one input, f64, batch %d, %d rings, '
            'lmax %d): %.3f ms (plain %.1f ms, %.2e of max, bitwise equal on a second run: '
            '%s), bound %.3f ms (%s, %.1f%%)'
            % ('K1' if kind == 'synth' else 'K2', batch, geom.nrings, lmax_out, r['ms'],
               r['plain_ms'], r['rel_err'], r['equal'], r['bound_ms'], r['bound_by'],
               100. * r['bound_ms'] / r['ms']))
    return rows


# ------------------------------------------------------------------ 11b patchy
def anisofilt_mask(geom):
    """params/anisofilt_example_torch.py's mask on `geom`: a galactic band cut plus three
    circular holes."""
    z = np.cos(geom.theta)[:, None]
    phi = (2. * np.pi * np.arange(geom.nphi) / geom.nphi)[None, :]
    mask = (np.abs(z) > 0.15).astype(float) * np.ones((geom.nrings, geom.nphi))
    for zc, pc, r in ((0.6, 1.0, 0.05), (-0.5, 4.0, 0.04), (0.3, 2.5, 0.03)):
        mask *= ((z - zc) ** 2 + (np.cos(phi) - np.cos(pc)) ** 2 * (1 - z ** 2)
                 + (np.sin(phi) - np.sin(pc)) ** 2 * (1 - z ** 2) > r ** 2)
    return mask


def patchy_maps(geom, nlevs=NLEV_PATCHY, uniform=False):
    """(ivmap_t, ivmap_p, omega, nlev_map_t, nlev_map_p), host numpy flat pixel arrays: the
    anisofilt mask times a scan pattern of noise, scaled to the mean levels `nlevs`
    (uK-arcmin, area-weighted over the unmasked sky); `uniform` drops the pattern."""
    omega = np.outer(geom.weight, np.full(geom.nphi, 2. * np.pi / geom.nphi))
    mask = anisofilt_mask(geom)
    th = geom.theta[:, None]
    ph = (2. * np.pi * np.arange(geom.nphi) / geom.nphi)[None, :]
    cosang = np.cos(th) * np.cos(np.radians(60.)) + np.sin(th) * np.sin(np.radians(60.)) * np.cos(ph)
    hits = 1. + 3. * np.exp(-(1. - np.abs(cosang)) / 0.03) + 0.2 * np.cos(2. * ph) ** 2
    shape = np.ones_like(omega) if uniform else 1. / np.sqrt(hits)
    shape = shape / (np.sum(omega * mask * shape) / np.sum(omega * mask))
    out = []
    for nl in nlevs:
        nlev_map = nl * shape
        out.append((mask * omega / (nlev_map / 60. / 180. * np.pi) ** 2).ravel())
    return out[0], out[1], omega.ravel(), (nlevs[0] * shape).ravel(), (nlevs[1] * shape).ravel()


def _hom_n0(key, nlev, cls_len, lmin, lmax, lmax_qlm, transf, device):
    """The homogeneous N0 of `key` at `nlev` through patchy's response and nhl calls."""
    from plancklens_tpu_torch.models import patchy
    from plancklens_tpu_torch.utils import cli
    nt, npp = ([nlev], [1e30]) if key == 'ptt' else ([1e30], [nlev])
    r = patchy.get_responses(key, cls_len, cls_len, cls_len, lmin, lmax, lmax_qlm, transf,
                             nt, npp, device=device)[0][0]
    n = patchy.get_nhls(key, key, cls_len, cls_len, cls_len, lmin, lmax, lmax_qlm, transf,
                        nt, nt, npp, npp, device=device)[0][0]
    return np.asarray(n) * cli(np.asarray(r)) ** 2


def patchy_full(device, lmax=2048, lmax_qlm=2048, npatch=4, log=print):
    """11b (module docstring): get_patchy_N0s for ptt and p_p at full width, with the
    homogeneous limit and the bounds. Returns a dict of seconds and checks."""
    from plancklens_tpu_torch.models import patchy
    from plancklens_tpu_torch.models.n0s import gauss_beam
    from plancklens_tpu_torch.ops.sht import gl_geometry
    device = torch.device(device)
    geom = gl_geometry(lmax)
    cls_len, cls_unl = _cls('lensedCls', max(lmax, lmax_qlm)), _cls('lenspotentialCls', lmax_qlm)
    transf = gauss_beam(5., lmax)
    ivt, ivp, omega, nlt, nlp = patchy_maps(geom)
    res = {'seconds': {}, 'between': {}, 'mv': {}, 'patches': {}}
    sel = SEL
    for key, iv, nl in (('ptt', ivt, nlt), ('p_p', ivp, nlp)):
        nf, _, nfid, fsk = patchy.mk_patches(npatch, iv, omega)
        res['patches'][key] = (list(map(float, nf)), list(map(float, fsk)), float(nfid))
        t0 = time.perf_counter()
        N0s, MC, cMC = patchy.get_patchy_N0s(key, npatch, ivt, ivp, omega, cls_unl, cls_len,
                                             cls_len, cls_len, LMIN_PATCHY, lmax, lmax_qlm,
                                             transf, device=device)
        _sync(device)
        res['seconds'][key] = time.perf_counter() - t0
        deep = _hom_n0(key, min(nf), cls_len, LMIN_PATCHY, lmax, lmax_qlm, transf, device)[sel]
        shallow = _hom_n0(key, max(nf), cls_len, LMIN_PATCHY, lmax, lmax_qlm, transf,
                          device)[sel]
        ratios = {k: (float(np.min(np.asarray(v)[sel] / deep)),
                      float(np.max(np.asarray(v)[sel] / shallow))) for k, v in N0s.items()}
        res['between'][key] = ratios
        res['mv'][key] = max(float(np.max(np.asarray(N0s[f + ', mv-rew'])[sel]
                                          / np.asarray(N0s[f + ', no-rew'])[sel]))
                             for f in ('hom-filt', 'inhom-filt'))
        res.setdefault('MC', {})[key] = (float(np.min(MC[sel])), float(np.max(MC[sel])))
        res.setdefault('finite', {})[key] = bool(all(np.all(np.isfinite(np.asarray(v)[sel]))
                                                     for v in N0s.values())
                                                 and np.all(np.isfinite(cMC[sel])))
        log('(11b) %s: %d patches of %s uK-arcmin (fsky %s; fid %.2f), lmax_ivf %d, lmax_qlm '
            '%d, lmin %d: %.2fs; N0 / deepest patch\'s homogeneous N0 >= %.4f, / shallowest\'s '
            '<= %.4f over 20-1500; mv-rew / no-rew <= %.6f; MC %.4f-%.4f'
            % (key, len(nf), '/'.join('%.2f' % x for x in nf),
               '/'.join('%.4f' % x for x in fsk), nfid, lmax, lmax_qlm, LMIN_PATCHY,
               res['seconds'][key], min(r[0] for r in ratios.values()),
               max(r[1] for r in ratios.values()), res['mv'][key], *res['MC'][key]))
    # the homogeneous limit: a uniform map (with its data-rms map) on the same mask
    ivu, _, _, nlu, _ = patchy_maps(geom, uniform=True)
    t0 = time.perf_counter()
    N0s, MC, cMC = patchy.get_patchy_N0s('ptt', npatch, ivu, ivu, omega, cls_unl, cls_len,
                                         cls_len, cls_len, LMIN_PATCHY, lmax, lmax_qlm,
                                         transf, rvmap_uKamin_t_data=nlu,
                                         rvmap_uKamin_p_data=nlu, device=device)
    _sync(device)
    res['seconds']['uniform'] = time.perf_counter() - t0
    vals = [np.asarray(v)[sel] for v in N0s.values()]
    res['uniform_spread'] = max(float(np.max(np.abs(v / vals[0] - 1.))) for v in vals)
    res['uniform_mc'] = max(float(np.max(np.abs(np.asarray(x)[sel] - 1.))) for x in (MC, cMC))
    log('(11b) uniform map (ptt, %.2fs): the four schemes within %.2e of each other, |MC - 1|, '
        '|cMC - 1| <= %.4f over 20-1500'
        % (res['seconds']['uniform'], res['uniform_spread'], res['uniform_mc']))
    return res


def patchy_card_vs_cpu(device, lmax=256, draws=4, log=print):
    """11b's card-against-CPU check at lmax 256 (module docstring): for ptt and p_p, the
    per-scheme N0 gaps (bandpowers_demo_torch.n0_gaps) against n0_limit of the largest gap
    of `draws` CPU runs on spectra changed by 1e-15, and MC / cMC relative."""
    from plancklens_tpu_torch.models import patchy
    from plancklens_tpu_torch.ops.sht import gl_geometry
    from bandpowers_demo_torch import n0_gaps, n0_limit
    cpu = torch.device('cpu')
    geom = gl_geometry(64)
    ivt, ivp, omega, _, _ = patchy_maps(geom)
    cls_len, cls_unl = _cls('lensedCls', lmax), _cls('lenspotentialCls', lmax)
    transf = np.ones(lmax + 1)
    rng = np.random.RandomState(21)
    pert = lambda cls: {k: v * (1. + 1e-15 * rng.standard_normal(v.shape)) for k, v in cls.items()}
    out = {}
    for key in ('ptt', 'p_p'):
        def run(d, cl_len=cls_len):
            return patchy.get_patchy_N0s(key, 4, ivt, ivp, omega, cls_unl, cl_len, cl_len, cl_len,
                                         30, lmax, lmax, transf, device=d)
        card, ref = run(device), run(cpu)
        pruns = [run(cpu, pert(cls_len)) for _ in range(draws)]
        for k in ref[0]:
            gap = n0_gaps(card[0][k], ref[0][k], lmax)
            floor = max(n0_gaps(p[0][k], ref[0][k], lmax)[1] for p in pruns)
            out['%s %s' % (key, k)] = (gap[0], gap[1], n0_limit(floor), floor)
        out['%s MC' % key] = max(_rel(card[i], ref[i]) for i in (1, 2))
    worst = max((v for v in out.values() if isinstance(v, tuple)), key=lambda v: v[1] / v[2])
    log('(11b) card vs CPU at lmax %d: 1/N0 <= %.2e of max; N0 per L, worst scheme %.2e '
        'against its limit %.2e (floor %.2e, %d CPU draws of 1e-15); MC / cMC <= %.2e'
        % (lmax, max(v[0] for v in out.values() if isinstance(v, tuple)), worst[1], worst[2],
           worst[3], draws, max(v for v in out.values() if not isinstance(v, tuple))))
    return out


# ------------------------------------------------------------------ 11c world size 1
def _load_ideal(device, lmax, nsims):
    from run_qlms_torch import load_parfile
    os.environ.update(PLK_LMAX_IVF=str(lmax), PLK_LMAX_QLM=str(lmax), PLK_NSIMS=str(nsims))
    return load_parfile(os.path.join(_REPO, 'params', 'idealized_example_torch.py'), device)


def sharded_world1(device, lmax=2048, nsims=8, log=print):
    """11c's first half: a world-size-1 group (NCCL on a card, gloo on the CPU), the
    idealized parfile's ptt QEs of `nsims` sims through ShardedIVFS against the unsharded
    run. Leaves no process group behind."""
    from plancklens_tpu_torch.parallel import distributed as pdist, mesh as pmesh
    from run_qlms_torch import StageTimer
    device = torch.device(device)
    pdist.init_single(device)
    try:
        mesh = pmesh.make_mesh()
        backend = torch.distributed.get_backend()
        par_ref = _load_ideal(device, lmax, nsims)
        par = _load_ideal(device, lmax, nsims)
        par.qlms_dd.ivfs1 = par.qlms_dd.ivfs2 = pmesh.ShardedIVFS(par.ivfs, mesh)
        idxs = np.arange(nsims)
        with StageTimer(device) as tr:     # first: it builds the tables, cold
            qr = par_ref.qlms_dd.get_sim_qlm_batch('ptt', idxs)
        with StageTimer(device) as t:
            q = par.qlms_dd.get_sim_qlm_batch('ptt', idxs)
        res = {'rel': _rel(q, qr), 'equal': bool(torch.equal(q, qr)), 'seconds': t.seconds,
               'seconds_ref': tr.seconds, 'backend': backend}
        pdist.barrier()
    finally:
        pdist.shutdown()
    log('(11c) world size 1 (%s): ShardedIVFS -> QELib ptt, lmax %d, %d sims: %.3fs (unsharded, '
        'run first with the cold table builds, %.3fs), %.2e relative, bitwise equal: %s'
        % (res['backend'], lmax, nsims, res['seconds'], res['seconds_ref'], res['rel'],
           res['equal']))
    return res


def m_block_rows(device, lmax=2048, batch=4, log=print):
    """11c's second half: K1/K2 on the two balanced m-blocks of lmax 2048 (spin 0, one
    input; the spin-2 pair), f64, batch `batch`, through core.legendre_*_pair with the
    block's m0, against the unsplit call (max relative difference of the concatenated
    blocks), each block timed against its twin. Returns (rows, errors)."""
    from plancklens_tpu_torch.ops.sht import core, gl_geometry
    from plancklens_tpu_torch.parallel.mesh import m_blocks
    device = torch.device(device)
    geom = gl_geometry(lmax)
    blocks = m_blocks(lmax, lmax, 2)
    gen = torch.Generator(device=device).manual_seed(3)
    errs, rows = {}, {}
    for spin, two in ((0, False), (2, True)):
        cx = lambda *s: torch.randn(s, generator=gen, device=device, dtype=torch.complex128)
        C = [cx(batch, lmax + 1, lmax + 1) for _ in range(2)]
        Q = [cx(batch, geom.nrings, lmax + 1) for _ in range(2)]
        whole_s = core.legendre_synth_pair(C[0], C[1] if two else None, spin, geom.theta,
                                           grid_token=geom.token())
        whole_a = core.legendre_anal_pair(Q[0], Q[1] if two else None, spin, geom.theta, lmax,
                                          grid_token=geom.token())
        ps, pa = [], []
        for m0, m1 in blocks:
            sl = slice(m0, m1)
            blk = lambda X: [X[0][..., sl].contiguous(), X[1][..., sl].contiguous() if two else None]
            ps.append(core.legendre_synth_pair(*blk(C), spin, geom.theta,
                                               grid_token=geom.token(), m0=m0))
            pa.append(core.legendre_anal_pair(*blk(Q), spin, geom.theta, lmax,
                                              grid_token=geom.token(), m0=m0))
        for kind, whole, parts in (('synth', whole_s, ps), ('anal', whole_a, pa)):
            errs['%s_spin%d' % (kind, spin)] = max(
                _rel(torch.cat([p[i] for p in parts], -1), whole[i])
                for i in range(2 if two else 1))
        del C, Q, whole_s, whole_a, ps, pa
        for b, (m0, m1) in enumerate(blocks):
            for kind in ('synth', 'anal'):
                name = '%s_pair_mblock%d_spin%d' % (kind, b, spin)
                r = rows[name] = _kernel_row(kind, spin, 1 if two else 0, lmax, geom, device,
                                             batch=batch, m_range=(m0, m1))
                log('(11c) %s on m-block %d (m %d..%d of lmax %d, %s, f64, batch %d, %d rings): '
                    '%.3f ms (plain %.1f ms, %.2e of max, bitwise equal on a second run: %s), '
                    'bound %.3f ms (%s, %.1f%%)'
                    % ('K1' if kind == 'synth' else 'K2', b, m0, m1 - 1, lmax,
                       'spin-2 pair' if two else 'spin 0, one input', batch, geom.nrings,
                       r['ms'], r['plain_ms'], r['rel_err'], r['equal'], r['bound_ms'],
                       r['bound_by'], 100. * r['bound_ms'] / r['ms']))
    log('(11c) m-split %s of lmax %d against the unsplit call (relative to max): %s'
        % (blocks, lmax, ', '.join('%s %.2e' % kv for kv in errs.items())))
    return rows, errs


# ------------------------------------------------------------------ 11d two ranks, one card
def _rank_worker(device, lmax, nsims, batch):
    """One rank of 11d (module docstring); prints 'RESULT <json>'. A bare 'cuda' `device`
    leaves the card and the backend to the resolver (parallel.distributed.card_for,
    backend_for_cards); 'cpu' runs the rehearsal on the CPU."""
    from plancklens_tpu_torch.parallel import distributed as pdist, mesh as pmesh
    from plancklens_tpu_torch.ops.sht import SHT, core, gl_geometry
    from plancklens_tpu_torch.utils import alm as ualm
    t_start = time.perf_counter()
    device = torch.device(device)
    rank, size = pdist.init_distributed(
        device=None if device.type == 'cuda' and device.index is None else device)
    device = pdist.device()
    mesh_m = pmesh.make_mesh(n_sims=1, n_m=size)
    mesh_s = pmesh.make_mesh(n_sims=size, n_m=1)
    lines = []
    sht = SHT(gl_geometry(lmax), lmax, dtype=torch.float64, device=device)
    ssht = pmesh.shard_sht(sht, mesh_m, log=lines.append)
    gen = torch.Generator(device=device).manual_seed(5)          # the same on every rank
    nalm = ualm.getsize(lmax)
    m0s = torch.as_tensor(ualm._lm_indices(lmax)[1] == 0, device=device)
    R, P = sht.geom.nrings, sht.geom.nphi

    def alm():
        a = torch.randn((batch, nalm), generator=gen, device=device, dtype=torch.complex128)
        return torch.where(m0s, a.real.to(a.dtype), a)

    t, g, c = alm(), alm(), alm()
    maps = [torch.randn((batch, R, P), generator=gen, device=device, dtype=torch.float64)
            for _ in range(3)]
    rings = ssht.rings
    _sync(device)
    with core.counting() as counted:
        t0 = time.perf_counter()
        out = {'alm2map_0': ssht.alm2map(t), 'map2alm_0': ssht.map2alm(maps[0][:, rings]),
               'alm2map_2': ssht.alm2map_spin((g, c), 2),
               'map2alm_2': ssht.map2alm_spin((maps[1][:, rings], maps[2][:, rings]), 2)}
        _sync(device)
        secs = time.perf_counter() - t0
    # [kernel, mode, batch, type, calls] lists: JSON keeps no tuple keys
    calls = [list(k) + [n] for k, n in sorted(counted.calls.items())]
    group = pmesh.axis_group(mesh_m, 'm')
    width = max(b - a for a, b in ssht.ring_split)

    def gather(x):   # the ring blocks of every rank, on every rank
        pad = torch.nn.functional.pad(x, (0, 0, 0, width - x.shape[-2]))
        parts = pdist.all_gather_cat(pad[None], group).unbind(0)
        return torch.cat([p[..., :b - a, :] for p, (a, b) in zip(parts, ssht.ring_split)], -2)

    full = {'alm2map_0': gather(out['alm2map_0']),
            'alm2map_2': tuple(gather(x) for x in out['alm2map_2']),
            'map2alm_0': out['map2alm_0'], 'map2alm_2': out['map2alm_2']}
    del out
    # the sims-sharded isotropic filtering of `nsims` sims
    par = _load_ideal(device, lmax, nsims)
    sh = pmesh.ShardedIVFS(par.ivfs, mesh_s)
    _sync(device)
    t1 = time.perf_counter()
    teb = sh.get_sim_teblm_batch(np.arange(nsims))
    _sync(device)
    secs_ivfs = time.perf_counter() - t1
    res = {'rank': rank, 'size': size, 'backend': torch.distributed.get_backend(),
           'device': str(device),
           'split': lines, 'm': [ssht.m0, ssht.m1], 'rings': [rings.start, rings.stop],
           'seconds': secs, 'seconds_ivfs': secs_ivfs, 'calls': calls}
    # every rank holds what it gathered to the single-process result, after the counts
    errs = {'alm2map_0': _rel(full['alm2map_0'], sht.alm2map(t)),
            'map2alm_0': _rel(full['map2alm_0'], sht.map2alm(maps[0]))}
    re, im = sht.alm2map_spin((g, c), 2)
    errs['alm2map_2'] = max(_rel(full['alm2map_2'][0], re), _rel(full['alm2map_2'][1], im))
    rg, rc = sht.map2alm_spin((maps[1], maps[2]), 2)
    errs['map2alm_2'] = max(_rel(full['map2alm_2'][0], rg), _rel(full['map2alm_2'][1], rc))
    ref = par.ivfs.get_sim_teblm_batch(np.arange(nsims))
    errs['ivfs'] = max(_rel(a, b) for a, b in zip(teb, ref))
    res['errs'] = errs
    pdist.barrier()
    pdist.shutdown()
    res['wall'] = time.perf_counter() - t_start
    print('RESULT ' + json.dumps(res), flush=True)


def two_ranks_one_card(device, lmax=2048, nsims=4, batch=4, timeout=400, log=print):
    """11d (module docstring): spawn two ranks of `_rank_worker` on `device`, wait for both
    (killing both on a timeout), and return their results (rank order). Raises if either
    fails. The ranks are launched as `srun -n 2` on one node would start them (a
    SLURM-shaped environment without MASTER_ADDR/MASTER_PORT or PLK_COORD): each resolves
    its rendezvous, rank, card and backend itself (parallel.distributed.launch_env), and
    reports the card and backend it chose."""
    from plancklens_tpu_torch.parallel.distributed import free_slurm_job_id
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(('SLURM_', 'OMPI_', 'PLK_COORD', 'PLK_NPROC', 'PLK_PROCID'))
           and k not in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'LOCAL_WORLD_SIZE',
                         'MASTER_ADDR', 'MASTER_PORT')}
    env.update(SLURM_JOB_ID=str(free_slurm_job_id('127.0.0.1')),
               SLURM_STEP_NODELIST='127.0.0.1', SLURM_NTASKS='2', SLURM_NTASKS_PER_NODE='2')
    cmd = [sys.executable, os.path.abspath(__file__), '--rank-worker',
           '--device', torch.device(device).type,
           '--lmax', str(lmax), '--nsims', str(nsims), '--batch', str(batch)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, env=dict(env, SLURM_PROCID=str(i), SLURM_LOCALID=str(i)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1., timeout - (time.perf_counter() - t0))))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise RuntimeError('11d: a rank ran past %ds (both killed)' % timeout)
    res = []
    for i, (p, (out, err)) in enumerate(zip(procs, outs)):
        line = [s for s in out.splitlines() if s.startswith('RESULT ')]
        if p.returncode != 0 or not line:
            raise RuntimeError('11d: rank %d failed (exit %d):\n%s\n%s'
                               % (i, p.returncode, out[-3000:], err[-3000:]))
        res.append(json.loads(line[-1][7:]))
    for r in res:
        log('(11d) rank %d/%d (the resolver chose %s, %s): %s; sharded SHT (alm2map, map2alm, '
            'spins 0 and 2, f64, batch %d) %.2fs; ShardedIVFS %d sims %.2fs; the rank\'s '
            'process %.1fs; kernel calls [kernel, mode, batch, type, calls] %s'
            % (r['rank'], r['size'], r['device'], r['backend'], r['split'][0], batch,
               r['seconds'], nsims, r['seconds_ivfs'], r['wall'], r['calls']))
    for r in res:
        log('(11d) rank %d: what it gathered against the single-process result (relative to '
            'max): %s' % (r['rank'], ', '.join('%s %.2e' % kv for kv in r['errs'].items())))
    log('(11d) wall %.1fs' % (time.perf_counter() - t0))
    return res


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--device', default='cuda')
    p.add_argument('--parts', default='a,b,c,d')
    p.add_argument('--rank-worker', action='store_true', help=argparse.SUPPRESS)
    p.add_argument('--lmax', type=int, default=2048)
    p.add_argument('--nsims', type=int, default=4)
    p.add_argument('--batch', type=int, default=4)
    args = p.parse_args()
    if args.rank_worker:
        return _rank_worker(args.device, args.lmax, args.nsims, args.batch)
    dev = torch.device(args.device)
    parts = args.parts.split(',')
    if 'a' in parts:
        freq_weighting_full(dev)
        freq_weighting_card_vs_cpu(dev)
        if dev.type == 'cuda':
            fw_kernel_rows(dev)
    if 'b' in parts:
        patchy_full(dev)
        patchy_card_vs_cpu(dev)
    if 'c' in parts:
        sharded_world1(dev)
        if dev.type == 'cuda':
            m_block_rows(dev)
    if 'd' in parts:
        two_ranks_one_card(dev)


if __name__ == '__main__':
    main()
