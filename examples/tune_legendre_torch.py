#!/usr/bin/env python
r"""Time other block shapes of the Legendre kernels K1-K4 on one CUDA device:

    python examples/tune_legendre_torch.py default S_PAIR32=4,2,8,1 LCS=8 PLAIN64=2,2,16,1:KS=1

Each argument is one variant of csrc/legendre_pair.cu, built into its own library from a
copy of the source with some constants replaced, parts joined by ':':

  S_PAIR32, S_PAIR32_WIDE, S_PLAIN32, S_PLAIN32_WIDE, S_PLAIN64, S_PLAIN64_WIDE = batch
      tile, rings per thread, warps per block, blocks meant for an SM of synth_pair_kernel,
      K1 on f32 data and K3 (the PLK_S_* block shapes, by kind of grid and data type; the
      wide shape runs the calls whose batch exceeds the narrow batch tile);
  SNW = warps of a block of synth_pair_mma_kernel, K1 on f64 data;
  PLAIN32, PLAIN64 = the same four numbers of the plain analysis K4 (the PLK_A_* block
      shapes; K2's launch shape comes from `legendre_kernels.plan_pair`, and its fixed
      constants are not tunable: PLC = 16 rows make its two 8-row parity classes);
  LCS, LCH = l steps of a staged chunk of the synthesis and of K4; LUNROLL = unrolling of
      the synthesis's l loop; KS = l steps between two barriers of K4;
  default = the source as it is.

Every variant is first held against the plain torch twins at lmax 256 (pair and plain
grid, f32 <= 1e-5 and f64 <= 1e-12 of max; the synthesis at batch 3 and 5, narrow and wide
shapes, with mmax 256 and 128; K4 with the planner's ring segments and with one), then
timed (CUDA events, least of 3 after a warm-up; 20 at the pixel-window shape)
at lmax 2048: K1 spin-1 pair on the 3073-ring QE grid in f32 at batch 8 and 4 and spin 0
with one input at batch 4 (the main path's K1 shapes), and the pair in f64 at batch 4; K3
n = -2 on the 8191 rings of HEALPix nside 2048 at batch 4 in f64 and at batch 8 in f64
and f32 (the wide shapes); K2 spin-1 pair in f32 at batch 8 and 4, with one input at
batch 8, and in f64 at batch 4; K4 n = -2 on the 8191 rings at batch 4 in f64 and f32; K4
at the exact pixel window's shape (48 node rings, 64 shapes, lmax 512, f64).
One line a variant, with K2's cluster size and K4's segment count in brackets, then each
synthesis and analysis kernel's registers/spilled bytes by template arguments. Compare variants only within one
run: two runs may land on two cards. Raises without a card, and for a variant that does
not build, launch or agree with the twins.
"""
import os
import re
import subprocess
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

import torch

KINDS = {'PAIR32': ('pair', 'f32'),
         'PLAIN32': ('plain', 'f32'), 'PLAIN64': ('plain', 'f64')}
ANAL_KINDS = ('PLAIN32', 'PLAIN64')         # K4's block shapes; K2 has none to tune
SHAPES = ANAL_KINDS + tuple('S_' + k + w for k in KINDS for w in ('', '_WIDE'))
LMAX = 2048


def rel_max(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def least_ms(fn, reps=3):
    fn()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return min(times)


def variant_source(text, spec):
    """(source text, block shapes) of the variant `spec` of the source `text`; the shapes
    are keyed by SHAPES (PLAIN32, PLAIN64 K4, S_PAIR32 ... synthesis)."""
    shapes = {}
    for k in SHAPES:
        define = '#define PLK_%s ' % (k if k.startswith('S_') else 'A_' + k)
        line = [ln for ln in text.splitlines() if ln.startswith(define)]
        if len(line) != 1:
            raise ValueError('the source does not define %s once' % define.split()[1])
        shapes[k] = (line[0], define, tuple(int(x) for x in line[0].split(None, 2)[2].split(',')))
    for part in spec.split(':'):
        if part == 'default':
            continue
        k, v = part.split('=')
        if k in SHAPES:
            new = tuple(int(x) for x in v.split(','))
            if len(new) != 4:
                raise ValueError('%s: a block shape is four numbers' % part)
            line, define, _ = shapes[k]
            text = text.replace(line, define + ', '.join(map(str, new)))
            shapes[k] = (define + ', '.join(map(str, new)), define, new)
        else:
            line = [ln for ln in text.splitlines() if ln.startswith('constexpr int %s = ' % k)]
            if len(line) != 1:
                raise ValueError('%s: the source has no such constant' % part)
            text = text.replace(line[0], 'constexpr int %s = %d;' % (k, int(v)))
    return text, {k: v[2] for k, v in shapes.items()}


def main():
    if not torch.cuda.is_available():
        raise SystemExit('tune_legendre_torch: needs a CUDA device')
    from plancklens_tpu_torch.ops.sht import core, legendre_kernels as lk, HealpixGeometry
    from plancklens_tpu_torch.ops.sht.geometry import gl_geometry
    from plancklens_tpu_torch.ops.sht.pixwin import _ring_Gm
    dev = torch.device('cuda:0')
    print(subprocess.run(['nvidia-smi', '-i', '0', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    with open(lk.SOURCE) as f:
        text0 = f.read()
    gen = torch.Generator(device=dev).manual_seed(1)

    def crandn(shape, cdt):
        return torch.randn(shape, generator=gen, device=dev, dtype=cdt)

    c64, c128 = torch.complex64, torch.complex128
    geom = gl_geometry(3 * LMAX // 2)
    nr = geom.nrings
    t_m, t_p = core.pair_tables(LMAX, LMAX, 1, geom.theta, None, dev)
    t_0, _ = core.pair_tables(LMAX, LMAX, 0, geom.theta, None, dev)
    Cp, Cm = (crandn((8, LMAX + 1, LMAX + 1), c64) for _ in range(2))
    Cp4, Cm4 = Cp[:4].contiguous(), Cm[:4].contiguous()
    Cpd, Cmd = Cp4.to(c128), Cm4.to(c128)
    Qp, Qm = (crandn((8, nr, LMAX + 1), c64) for _ in range(2))
    Qp4, Qm4 = Qp[:4].contiguous(), Qm[:4].contiguous()
    Qpd, Qmd = Qp4.to(c128), Qm4.to(c128)
    hgeom = HealpixGeometry(2048)
    tf = core.full_tables(LMAX, LMAX, -2, hgeom.theta, None, dev)
    C8 = crandn((8, LMAX + 1, LMAX + 1), c128)
    C4, C8f = C8[:4].contiguous(), C8.to(c64)
    Q4 = crandn((4, hgeom.nrings, LMAX + 1), c128)
    Q4f = Q4.to(c64)
    Gm, th_pw, _ = _ring_Gm(128, 128, 512)
    Gm = torch.as_tensor(Gm, device=dev)
    tpw = core.full_tables(512, 512, 2, th_pw, None, dev)
    # the checks at lmax 256: spin-2 pair on 257 rings, n = -2 on 201 random rings; the
    # synthesis also at batch 5 (the wide shapes) and with mmax 128
    ts_m, ts_p = core.pair_tables(256, 256, 2, gl_geometry(256).theta, None, dev)
    th_r = np.sort(np.random.RandomState(2).uniform(0., np.pi, 201))
    th_r[0], th_r[-1] = 4e-4, np.pi - 7e-4
    tr = core.full_tables(256, 256, -2, th_r, None, dev)
    th_h = gl_geometry(256).theta
    tsh_m, tsh_p = core.pair_tables(256, 128, 2, th_h, None, dev)
    trh = core.full_tables(256, 128, -2, th_r, None, dev)
    Qs = {c: (crandn((3, 257, 257), c), crandn((3, 257, 257), c)) for c in (c64, c128)}
    Qr = {c: crandn((3, 201, 257), c) for c in Qs}
    ref_pair = {c: core.legendre_anal_pair_plain(*Qs[c], 2, 256, ts_m, ts_p) for c in Qs}
    ref_plain = {c: core.legendre_anal_plain(Qr[c], 256, tr) for c in Qs}
    synth_cases = []
    for c in Qs:
        for B in (3, 5):
            for tm_, tp_, tpl in ((ts_m, ts_p, tr), (tsh_m, tsh_p, trh)):
                M = tm_['l0'].shape[0]
                S, Sm = crandn((B, 257, M), c), crandn((B, 257, M), c)
                synth_cases.append((S, Sm, tm_, tp_, tpl,
                                    core.legendre_synth_pair_plain(S, Sm, 2, 257, tm_, tp_),
                                    core.legendre_synth_plain(S, tpl)))

    def cluster(Qa, Qb):        # K2's plan of a spin-1 call
        return 'cluster %d' % lk.anal_pair_plan(Qa, Qb, 1).cluster

    def segments(Qa, L):        # K4's plan
        return 'NS %d' % lk.anal_plan(*Qa.shape, L, Qa.dtype, dev).nseg

    os.makedirs(lk.BUILD_DIR, exist_ok=True)
    for n, spec in enumerate(sys.argv[1:] or ['default']):
        text, shapes = variant_source(text0, spec)
        src = os.path.join(lk.BUILD_DIR, 'tune_%d.cu' % n)
        with open(src, 'w') as f:
            f.write(text)
        # point the wrappers at the variant: its source, a fresh library, its shapes
        lk.SOURCE, lk._lib = src, None
        lk.ANAL_TILE = {KINDS[k]: (shapes[k][0], shapes[k][1] * shapes[k][2])
                        for k in ANAL_KINDS}
        lk.SYNTH_SHAPES = {KINDS[k]: (shapes['S_' + k], shapes['S_' + k + '_WIDE'])
                           for k in KINDS}
        lk.SYNTH_MMA_WARPS = int(re.search(r'constexpr int SNW = (\d+);', text).group(1))
        t0 = time.perf_counter()
        lk._load()
        out = [spec, 'built in %.0f s' % (time.perf_counter() - t0)]
        for c, tol in ((c64, 1e-5), (c128, 1e-12)):
            ka = lk.anal_pair(*Qs[c], 2, 256, ts_m, ts_p)
            for nseg in (None, 1):
                err = max([rel_max(a, b) for a, b in zip(ka, ref_pair[c])]
                          + [rel_max(lk.anal(Qr[c], 256, tr, nseg=nseg), ref_plain[c])])
                if not err <= tol:
                    raise RuntimeError('%s, K4 nseg %s: %.2e of max from the twins'
                                       % (c, nseg, err))
        for S, Sm, tm_, tp_, tpl, ref_p, ref_s in synth_cases:
            tol = 1e-5 if S.dtype == c64 else 1e-12
            err = max([rel_max(a, b) for a, b in zip(lk.synth_pair(S, Sm, 2, 257, tm_, tp_), ref_p)]
                      + [rel_max(lk.synth(S, 201, tpl), ref_s)])
            if not err <= tol:
                raise RuntimeError('synthesis, %s, batch %d, mmax %d: %.2e of max from the twins'
                                   % (S.dtype, S.shape[0], S.shape[2] - 1, err))
        for label, plan, fn, reps in (
                ('K1 f32 b8', None, lambda: lk.synth_pair(Cp, Cm, 1, nr, t_m, t_p), 3),
                ('K1 f32 b4', None, lambda: lk.synth_pair(Cp4, Cm4, 1, nr, t_m, t_p), 3),
                ('K1 f32 b4 spin 0 one input', None,
                 lambda: lk.synth_pair(Cp4, None, 0, nr, t_0, t_0), 3),
                ('K1 f64 b4', None, lambda: lk.synth_pair(Cpd, Cmd, 1, nr, t_m, t_p), 3),
                ('K3 f64 b4', None, lambda: lk.synth(C4, hgeom.nrings, tf), 3),
                ('K3 f64 b8', None, lambda: lk.synth(C8, hgeom.nrings, tf), 3),
                ('K3 f32 b8', None, lambda: lk.synth(C8f, hgeom.nrings, tf), 3),
                ('K2 f32 b8', cluster(Qp, Qm), lambda: lk.anal_pair(Qp, Qm, 1, LMAX, t_m, t_p),
                 3),
                ('K2 f32 b4', cluster(Qp4, Qm4),
                 lambda: lk.anal_pair(Qp4, Qm4, 1, LMAX, t_m, t_p), 3),
                ('K2 f32 b8 one input', cluster(Qp, None),
                 lambda: lk.anal_pair(Qp, None, 1, LMAX, t_m, t_p), 3),
                ('K2 f64 b4', cluster(Qpd, Qmd),
                 lambda: lk.anal_pair(Qpd, Qmd, 1, LMAX, t_m, t_p), 3),
                ('K4 f64 b4', segments(Q4, LMAX + 1), lambda: lk.anal(Q4, LMAX, tf), 3),
                ('K4 f32 b4', segments(Q4f, LMAX + 1), lambda: lk.anal(Q4f, LMAX, tf), 3),
                ('K4 pixel window', segments(Gm, 513), lambda: lk.anal(Gm, 512, tpw), 20)):
            ms = least_ms(fn, reps)
            out.append('%s %.3f ms' % (label, ms) if plan is None else
                       '%s %.3f ms (%s)' % (label, ms, plan))
        print(' | '.join(out), flush=True)
        print('    registers/spill store bytes: ' + ', '.join(
            '%s<%s> %d/%d' % (k['kernel'][:5], ','.join(map(str, k['args'])), k['registers'],
                              k['spill_stores'])
            for k in lk.build_report()
            if k['kernel'] in ('synth_pair_kernel', 'synth_pair_mma_kernel', 'anal_pair_kernel',
                               'anal_pair_mma_kernel')),
            flush=True)


if __name__ == '__main__':
    main()
