"""Build, bind and launch the hand-written Hopper Legendre kernels.

csrc/legendre_pair.cu holds all four, replacing the TPU kernels of
plancklens_tpu/ops/sht/pallas_kernel.py:
  K1 `synth_pair`, K2 `anal_pair`: the fused north-south pair transforms
     (`_synth_pair_pallas`, `_anal_pair_pallas`);
  K3 `synth`, K4 `anal`: the plain transforms of one recursion over every ring of any
     grid (`_synth_pallas`, `_anal_pallas`), the pair kernels' no-mirror mode.
Their plain torch twins are `core.legendre_synth_pair_plain`/`legendre_anal_pair_plain`
and `core.legendre_synth_plain`/`legendre_anal_plain`; the public `core.legendre_*`
functions run these wrappers for CUDA tensors and the twins for CPU tensors. The
wrappers here take CUDA tensors only: anything else raises, and so does a failed build
or launch. They keep no record of their calls: the span sht.legendre of the `core` entry
call names the kernel it ran (`core.kernel_calls` counts them).

K1 on f64 data contracts each chunk of l of the recursion's values with the coefficients on
the FP64 tensor cores (`synth_plan`: the design and launch shape from the call's data type,
mode and batch); on f32 data it accumulates on the FP32 pipe beside the f64 recursion.

K2 runs one thread-block cluster for each (m, batch tile): `plan_pair` (plain Python, no
CUDA call) chooses the cluster size, the rings of each block, the warps and the batch tile
from the call's shape; the blocks' partial sums meet in distributed shared memory, each
output element is written once, and there is no workspace and no second kernel. K4 splits
its ring sum over the card: `plan_segments` chooses the number of ring segments NS from the
call's shape and the card's SM count (`anal_plan` gives a call's plan), the wrapper
allocates the workspace of NS - 1 partial sums, and a second hand-written kernel adds the
partials to the output in a fixed order. With NS = 1 the output is written directly and no
second kernel runs.

The shared library is compiled by nvcc from the checkout's sources at first use into
`plancklens_tpu_torch/_build/`, named by a hash of the source and flags (both dtypes are
always built), under a file lock, and bound with ctypes (plain C interface: a build
takes seconds, where one that includes PyTorch's headers takes minutes).
"""
import collections
import ctypes
import fcntl
import hashlib
import itertools
import os
import re
import shutil
import subprocess

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, 'csrc', 'legendre_pair.cu')
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), '_build')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3', '-shared',
              '-Xcompiler', '-fPIC', '-Xptxas', '-v')
DTYPES = ('f32', 'f64')

# (batch tile, rows of one ring pass) of K4 by data type; rows are rings, warps x rings per
# thread of a block. They are csrc/legendre_pair.cu's PLK_A_* block shapes, checked against
# the library at load.
ANAL_TILE = {('plain', 'f32'): (4, 64), ('plain', 'f64'): (2, 64)}
# (batch tile, rings per thread, warps, blocks meant for an SM) of the synthesis kernels,
# a narrow and a wide shape by kind of grid and data type: csrc/legendre_pair.cu's PLK_S_*
# block shapes, checked against the library at load. A call whose batch exceeds the
# narrow batch tile runs the wide shape (`synth_shape`). f64 pair data run K1's MMA design
# (below), which has no entry here.
SYNTH_SHAPES = {('pair', 'f32'): ((4, 3, 8, 1), (8, 2, 8, 1)),
                ('plain', 'f32'): ((4, 6, 8, 1), (8, 4, 8, 1)),
                ('plain', 'f64'): ((4, 6, 8, 1), (8, 3, 8, 1))}
# K1 on f64 data in the pair modes (`synth_pair_mma_kernel`) runs its accumulate on the
# FP64 tensor cores: blocks of SYNTH_MMA_WARPS warps, each warp on its own northern rings
# for the whole l loop (`synth_mma_rings`), batch tiles of 4 maps up to batch 4, else 8.
# Mirrors of csrc/legendre_pair.cu's SNW and smma_* functions, checked at load. PLC's 16
# rows of a chunk make its two 8-row parity classes (PAIR_LC below).
SYNTH_MMA_WARPS = 4
SYNTH_MMA_TILES = (4, 8)
# No crossover by batch: the MMA design beat synth_pair_kernel at every batch timed, batch 1
# included (lmax 2048, 2049 rings, f64: spin 0 4.481 against 9.361 ms at batch 1, 4.346
# against 9.445 at batch 2, 4.646 against 9.369 at batch 4; the spin-2 pair 8.368 against
# 22.864 at batch 1; NVIDIA H100 80GB HBM3, 700 W).
# Blocks wanted for K4's split ring sum, in waves of one block an SM: the blocks differ in
# length by the l range of their m-tile, and the short ones fill the tail of many waves.
WAVES = 4
# Most bytes of partial sums a K4 call may allocate. One partial of the HEALPix path's call
# (batch 4, lmax 2048, complex128) is 0.25 GiB: 2 GiB allows 9 segments there.
WORKSPACE_CAP = 2 * 2 ** 30

# K2's fixed shape (csrc/legendre_pair.cu's PLC and PMAXCS and a warp's 32 lanes, checked
# against the library at load): l steps a chunk, most blocks in a cluster, recursion chains
# of a warp per chain a thread (one on a batch tile of 8 maps, two on one of 4). A block
# has 8 or 16 warps; clusters above 8 blocks are a non-portable size.
PAIR_LC, PAIR_MAX_CLUSTER, PAIR_CHAINS = 16, 16, 32
PAIR_WARPS = (8, 16)
PAIR_TILES = (4, 8)
PAIR_PORTABLE_CLUSTER = 8
# registers a K2 thread may take (__launch_bounds__: 65536 an SM over the 256 threads of
# each of 2 blocks, or the 512 of one)
PAIR_MAX_REGS = 128
SMEM_BYTES = 232448                     # a block's shared memory on the H100 (227 KB)

_lib = None


SegmentPlan = collections.namedtuple(
    'SegmentPlan', 'nseg passes passes_per_seg rows_per_pass blocks workspace_bytes')


PairPlan = collections.namedtuple(
    'PairPlan', 'cluster rings_per_block m_per_block batch_tile lc warps blocks smem_bytes')


SynthPlan = collections.namedtuple(
    'SynthPlan', 'mma batch_tile rings_per_warp warps blocks_per_m blocks smem_bytes shape')


def pair_recs(mode):
    """Recursions of a K2 mode: d_{m,-s} alone in mode 0, both in modes 1 and 2."""
    return 1 if mode == 0 else 2


def pair_outs(mode):
    return 2 if mode == 1 else 1


def pair_nch(bt):
    """Recursion chains a K2 thread runs: two on the batch tile of 4 maps, else one."""
    return 2 if bt == PAIR_TILES[0] else 1


def pair_rings(mode, nw, bt):
    """Northern rings a K2 block of `nw` warps holds: 32 a warp, or 64 when a thread runs
    two rings (mode 0 on 4 maps); one chain a thread in modes 1/2 gives half the warps to
    each recursion."""
    nch = pair_nch(bt)
    rpw = PAIR_CHAINS * nch if mode == 0 else PAIR_CHAINS
    sets = 2 if mode != 0 and nch == 1 else 1
    return nw // sets * rpw


def pair_smem(mode, nw, bt):
    """Bytes of dynamic shared memory of a K2 block of `nw` warps on a batch tile of `bt`
    maps (the source's pair_smem): each warp's lambda tile (LC rows of its 32 or 64 chains
    + 4 doubles), its partial tile (LC rows of outputs x maps + 4 complex f64), two buffers
    of the block's partial tile and of the chunk's table rows."""
    ls = PAIR_CHAINS * pair_nch(bt) + 4
    ps = pair_outs(mode) * bt + 4
    elems = PAIR_LC * pair_outs(mode) * bt
    return (nw * PAIR_LC * ls * 8 + nw * PAIR_LC * ps * 16 + 2 * elems * 16
            + 2 * pair_recs(mode) * 3 * PAIR_LC * 8)


def pair_operand_doubles(mode, bt):
    """f64 registers a thread keeps for the B operands of its warp's k-steps (8 a chain a
    lane): two sets (mode 0: even and odd rows; mode 1: the two outputs) or one (mode 2),
    each of bt / 4 n-tiles of 8 columns."""
    return 8 * pair_nch(bt) * (1 if mode == 2 else 2) * (bt // 4)


def plan_pair(nrings, M, B, mode):
    """K2's launch shape for a pair call of B maps and M columns on `nrings` rings: a
    PairPlan. One cluster of blocks for each (m, batch tile: 4 maps up to batch 4, else 8);
    the blocks of a cluster split the nh = ceil(nrings / 2) northern rings into equal slices
    (`rings_per_block`, the last one shorter; `pair_rings` at most). The fewest warps (8,
    else 16) whose cluster stays within the portable 8 blocks; else 16 warps in up to 16
    blocks; more rings raise."""
    nh = (nrings + 1) // 2
    bt = PAIR_TILES[0] if B <= PAIR_TILES[0] else PAIR_TILES[-1]
    for nw in PAIR_WARPS:
        cs = -(-nh // pair_rings(mode, nw, bt))
        if cs <= PAIR_PORTABLE_CLUSTER:
            break
    if cs > PAIR_MAX_CLUSTER:
        raise ValueError('K2 takes at most %d northern rings in mode %d at batch %d, got %d'
                         % (PAIR_MAX_CLUSTER * pair_rings(mode, PAIR_WARPS[-1], bt), mode,
                            B, nh))
    rs = -(-nh // cs)
    return PairPlan(cs, rs, 1, bt, PAIR_LC, nw, cs * -(-B // bt) * M, pair_smem(mode, nw, bt))


def pair_slices(plan, nrings):
    """[(first, end)] northern rings of each block of a cluster of `plan`, in rank order."""
    nh = (nrings + 1) // 2
    rs = plan.rings_per_block
    return [(r * rs, min(nh, (r + 1) * rs)) for r in range(plan.cluster)]


def synth_shape(kind, dt, B):
    """The block shape (batch tile, rings per thread, warps, blocks an SM) that a synthesis
    call of batch B runs: 'pair' (K1) or 'plain' (K3), 'f32' or 'f64'; the launcher's
    choice, mirrored."""
    narrow, wide = SYNTH_SHAPES[kind, dt]
    return wide if B > narrow[0] else narrow


def synth_mma_chains(mode, bt):
    """Recursion chains a thread of K1's MMA design runs: mode 0 one a ring (two rings on
    the batch tile of 4 maps, one on the tile of 8), modes 1/2 both recursions of a ring."""
    return (2 if bt == SYNTH_MMA_TILES[0] else 1) if mode == 0 else 2


def synth_mma_rings(mode, bt):
    """Northern rings a warp of K1's MMA design owns."""
    return PAIR_CHAINS * synth_mma_chains(mode, bt) if mode == 0 else PAIR_CHAINS


def synth_mma_acc(mode, bt):
    """f64 accumulators a thread of K1's MMA design keeps: mode 0 an even and an odd sum of
    8-ring tiles (m8n8k4), modes 1/2 four 16-row tiles (m16n8k16: the rings' d_{m,-s} and
    (-1)^l d_{m,+s} rows), each over n-tiles of 8 columns (re, im of 4 maps) of every input."""
    nin = 2 if mode == 1 else 1
    if mode == 0:
        return 2 * (synth_mma_rings(mode, bt) // 8) * (bt // 4) * 2
    return 4 * (nin * bt // 4) * 4


def synth_mma_blocks_an_sm(mode, bt):
    """Blocks of K1's MMA design meant for an SM (__launch_bounds__): 16 warps at <= 128
    registers a thread, or 8 where the accumulators alone take 128."""
    return (16 if synth_mma_acc(mode, bt) <= 32 else 8) // SYNTH_MMA_WARPS


def synth_mma_smem(mode, bt):
    """Bytes of dynamic shared memory of a block of K1's MMA design (the source's
    smma_smem): each warp's lambda tile (PAIR_LC rows of its chains + 4 doubles), two
    buffers of the staged coefficient rows (PAIR_LC rows of inputs x maps complex + 4
    doubles) and of the chunk's table rows."""
    nin = 2 if mode == 1 else 1
    ls = PAIR_CHAINS * synth_mma_chains(mode, bt) + 4
    cs = 2 * nin * bt + 4
    return (SYNTH_MMA_WARPS * PAIR_LC * ls * 8 + 2 * PAIR_LC * cs * 8
            + 2 * pair_recs(mode) * 3 * PAIR_LC * 8)


def synth_plan(dt, mode, nrings, M, B):
    """The design and launch shape of a synthesis call of B maps ('f32' or 'f64') in `mode`
    (pair modes 0-2, K1; 3 the plain mode, K3) on `nrings` rings with M columns: a
    SynthPlan. f64 pair calls run K1 on the FP64 tensor cores (`mma` True): batch tiles of
    4 maps up to batch 4, else 8, blocks of SYNTH_MMA_WARPS warps of `synth_mma_rings`
    northern rings, `blocks_per_m` of them for each (m, batch tile). Every other call runs
    `synth_pair_kernel` at `synth_shape`'s block shape (`shape`; the MMA fields None)."""
    kind = 'plain' if mode == 3 else 'pair'
    if kind == 'pair' and dt == 'f64':
        bt = SYNTH_MMA_TILES[0] if B <= SYNTH_MMA_TILES[0] else SYNTH_MMA_TILES[-1]
        rpw = synth_mma_rings(mode, bt)
        nb = -(-((nrings + 1) // 2) // (SYNTH_MMA_WARPS * rpw))
        return SynthPlan(True, bt, rpw, SYNTH_MMA_WARPS, nb, nb * -(-B // bt) * M,
                         synth_mma_smem(mode, bt), None)
    shape = synth_shape(kind, dt, B)
    return SynthPlan(False, shape[0], None, None, None, None, None, shape)


def synth_pair_plan(Cp, Cm, spin, nrings):
    """The SynthPlan that `synth_pair` launches on the inputs Cp (B, lmax + 1, M), Cm (or
    None) of `spin` on `nrings` rings."""
    B, _, M = Cp.shape
    return synth_plan(_suffix(Cp.dtype), pair_mode(spin, Cm is not None), nrings, M, B)


def _shape_code(shape):
    bt, rpt, nws, minb = shape
    return bt << 24 | rpt << 16 | nws << 8 | minb


def plan_segments(rows, L, M, B, batch_tile, rows_per_pass, nout, elem_size, sm_count,
                  nseg=None, cap=WORKSPACE_CAP):
    """How an analysis call splits its ring sum: a SegmentPlan.

    rows: rings the recursion runs on (the northern half of a pair grid, every ring of a
    plain one); the outputs are `nout` arrays (B, L, M) of `elem_size` bytes an element;
    one block covers a batch tile, 32 m and the ring passes (`rows_per_pass` rows each) of
    one segment. Without a split the grid is ceil(M/32) x ceil(B/batch_tile) blocks. The
    plan takes the fewest segments that give WAVES x sm_count blocks, at most one per
    pass and at most what `cap` bytes of partial sums allow (segment 0 adds into the
    outputs, so NS segments need NS - 1 partials), every segment a whole number of passes
    and none empty. `nseg` forces a count instead (clipped to the passes, and lowered to
    the nearest count that leaves no segment empty)."""
    passes = -(-rows // rows_per_pass)
    base = -(-M // 32) * -(-B // batch_tile)
    if nseg is None:
        want = -(-WAVES * sm_count // base)
        fit = 1 + cap // (nout * B * L * M * elem_size)
        nseg = min(want, fit)
    nseg = max(1, min(nseg, passes))
    pps = -(-passes // nseg)
    nseg = -(-passes // pps)
    return SegmentPlan(nseg, passes, pps, rows_per_pass, base * nseg,
                       (nseg - 1) * nout * B * L * M * elem_size)


def segment_rows(plan, rows):
    """[(first row, end row)] of each segment of `plan` over `rows` rings, in order."""
    step = plan.passes_per_seg * plan.rows_per_pass
    return [(s * step, min(rows, (s + 1) * step)) for s in range(plan.nseg)]


def _nvcc():
    cuda_home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH') or '/usr/local/cuda'
    cand = os.path.join(cuda_home, 'bin', 'nvcc')
    return cand if os.path.exists(cand) else shutil.which('nvcc')


def library_path():
    with open(SOURCE, 'rb') as f:
        src = f.read()
    key = hashlib.sha1(src + ' '.join(NVCC_FLAGS + DTYPES).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, 'legendre_pair_%s.so' % key)


def build():
    """Compile the kernels if the current source has no library yet; returns its path.
    The compiler's register/spill report is kept beside it (`.log`)."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, 'build.lock'), 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(so):
            return so
        nvcc = _nvcc()
        if nvcc is None:
            raise RuntimeError('nvcc not found (set CUDA_HOME): the Legendre kernels '
                               'are built from source on the machine with the card')
        tmp = so + '.tmp%d' % os.getpid()
        res = subprocess.run([nvcc, *NVCC_FLAGS, '-o', tmp, SOURCE],
                             capture_output=True, text=True)
        with open(so[:-3] + '.log', 'w') as f:
            f.write(res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError('nvcc failed (%d):\n%s' % (res.returncode, res.stderr))
        os.replace(tmp, so)
    return so


_ENTRY = re.compile(r"Compiling entry function '_Z\w*?\d+([a-z][a-z_]*_kernel)I(\w+)'")
_SPILLS = re.compile(r'(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads')
_REGS = re.compile(r'Used (\d+) registers')


def _template_args(code):
    """The template arguments at the start of a mangled argument list (after its `I`):
    `fLi4ELi3ELin1EE...` -> ('float', 4, 3, -1)."""
    args, i = [], 0
    while code[i] != 'E':
        if code[i] == 'L':                      # a literal: L <type> <digits, n = minus> E
            j = code.index('E', i)
            lit = code[i + 2:j]
            args.append(-int(lit[1:]) if lit.startswith('n') else int(lit))
            i = j + 1
        else:
            args.append({'f': 'float', 'd': 'double', 'i': 'int'}[code[i]])
            i += 1
    return tuple(args)


def ptxas_report(text):
    """The compiler's register and spill report (`nvcc -Xptxas -v`, the `.log` beside the
    library) as one dict a kernel instantiation, in the order compiled: kernel name,
    template arguments (type names and integers), registers, stack frame and spill
    bytes."""
    out, cur = [], None
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = {'kernel': m.group(1), 'args': _template_args(m.group(2))}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = _SPILLS.search(line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = _REGS.search(line)
        if m:
            cur['registers'] = int(m.group(1))
            cur = None
    return out


def build_report():
    """`ptxas_report` of the current library's build log."""
    with open(library_path()[:-3] + '.log') as f:
        return ptxas_report(f.read())


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        p, i = ctypes.c_void_p, ctypes.c_int
        # the pair entry points take two table sets, K2's also its launch shape (warps,
        # batch tile, cluster, rings a block), K1's on f64 data its (batch tile, blocks a
        # column); the plain ones one set, K4's also (workspace, segments); all end with
        # (device, stream)
        for name, extra in (('plk_synth_pair_f32', []), ('plk_synth_pair_mma_f64', [i] * 2),
                            ('plk_anal_pair_f32', [i] * 4), ('plk_anal_pair_f64', [i] * 4)):
            fn = getattr(lib, name)
            fn.argtypes = [p] * 4 + [p] * 12 + [p] + [i] * 5 + extra + [i, p]
            fn.restype = i
        for name, extra in (('plk_synth', []), ('plk_anal', [p, i])):
            for suffix in DTYPES:
                fn = getattr(lib, '%s_%s' % (name, suffix))
                fn.argtypes = [p] * 2 + [p] * 6 + [p] + [i] * 4 + extra + [i, p]
                fn.restype = i
        lib.plk_synth_shape.argtypes = [i, i, i]
        lib.plk_synth_shape.restype = i
        for (kind, suffix), shapes in SYNTH_SHAPES.items():
            for wide, shape in enumerate(shapes):
                got = lib.plk_synth_shape(int(kind == 'plain'), int(suffix == 'f64'), wide)
                if got != _shape_code(shape):
                    raise RuntimeError('the %s %s synthesis kernel (%s) has the block shape '
                                       '%s, its mirror says %s'
                                       % (kind, suffix, ('narrow', 'wide')[wide],
                                          tuple(got >> k & 0xff for k in (24, 16, 8, 0)),
                                          shape))
        lib.plk_synth_pair_mma_shape.argtypes = lib.plk_synth_pair_mma_smem.argtypes = [i, i]
        lib.plk_synth_pair_mma_shape.restype = lib.plk_synth_pair_mma_smem.restype = i
        for mode, bt in itertools.product((0, 1, 2), SYNTH_MMA_TILES):
            want = (synth_mma_rings(mode, bt) << 16 | SYNTH_MMA_WARPS << 8
                    | synth_mma_blocks_an_sm(mode, bt), synth_mma_smem(mode, bt))
            got = (lib.plk_synth_pair_mma_shape(mode, bt), lib.plk_synth_pair_mma_smem(mode, bt))
            if got != want:
                raise RuntimeError('K1 MMA mode %d, batch tile %d: shape code %#x and %d bytes '
                                   'of shared memory, its mirror says %#x and %d'
                                   % ((mode, bt) + got + want))
        lib.plk_anal_pair_shape.restype = i
        want = PAIR_LC << 16 | PAIR_MAX_CLUSTER << 8 | PAIR_CHAINS
        if lib.plk_anal_pair_shape() != want:
            raise RuntimeError('K2 has the shape code %#x, its mirror says %#x'
                               % (lib.plk_anal_pair_shape(), want))
        lib.plk_anal_pair_smem.argtypes = [i, i, i]
        lib.plk_anal_pair_smem.restype = i
        for mode, nw, bt in itertools.product((0, 1, 2), PAIR_WARPS, PAIR_TILES):
            got = lib.plk_anal_pair_smem(mode, nw, bt)
            if got != pair_smem(mode, nw, bt):
                raise RuntimeError('K2 mode %d, %d warps, batch tile %d: %d bytes of shared '
                                   'memory, its mirror says %d'
                                   % (mode, nw, bt, got, pair_smem(mode, nw, bt)))
        lib.plk_anal_tile.argtypes = [i]
        lib.plk_anal_tile.restype = i
        for (kind, suffix), (bt, rpp) in ANAL_TILE.items():
            tile = lib.plk_anal_tile(int(suffix == 'f64'))
            if tile != (bt << 16 | rpp):
                raise RuntimeError('the %s %s analysis kernel tiles (%d, %d), the planner '
                                   'assumes (%d, %d)' % (kind, suffix, tile >> 16,
                                                         tile & 0xffff, bt, rpp))
        _lib = lib
    return _lib


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


_COMPLEX = (torch.complex64, torch.complex128)


def _check_data(name, t, ref, shape):
    if not t.is_cuda:
        raise ValueError('%s must be a CUDA tensor (the kernels run on the card only)' % name)
    if t.dtype not in _COMPLEX:
        raise TypeError('%s must be complex64 or complex128, got %s' % (name, t.dtype))
    if ref is not None and (t.dtype != ref.dtype or t.device != ref.device):
        raise TypeError('%s must match %s/%s' % (name, ref.dtype, ref.device))
    if tuple(t.shape) != tuple(shape):
        raise ValueError('%s has shape %s, expected %s' % (name, tuple(t.shape), shape))
    if not t.is_contiguous():
        raise ValueError('%s must be contiguous' % name)


def _check_tables(t, device, L, M, nrows):
    """An f64 table set on `nrows` rings: the northern half of a pair grid, or every
    ring of a plain one."""
    want = {'alpha': (L, M), 'beta': (L, M), 'gamma': (L, M), 'l0': (M,),
            'seed_v': (nrows, M), 'seed_k': (nrows, M), 'x': (nrows,)}
    for k, shape in want.items():
        v = t[k]
        dt = torch.int32 if k in ('l0', 'seed_k') else torch.float64
        if v.dtype != dt or v.device != device or tuple(v.shape) != shape \
                or not v.is_contiguous():
            raise ValueError('table %s: %s %s %s, expected %s %s %s contiguous'
                             % (k, v.dtype, v.device, tuple(v.shape), dt, device, shape))
    if t['S'] != 256:
        raise ValueError('the kernels run the f64 recursion (S=256), got S=%d' % t['S'])


def _tab_args(t):
    return [_ptr(t[k]) for k in ('alpha', 'beta', 'gamma', 'l0', 'seed_v', 'seed_k')]


def pair_mode(spin, has_second):
    """The mode of a K1/K2 call (csrc/legendre_pair.cu's): 0 spin 0 on one input, 1 two
    inputs, 2 one input of nonzero spin."""
    return 1 if has_second else (0 if spin == 0 else 2)


def _suffix(dtype):
    return 'f32' if dtype == torch.complex64 else 'f64'


def _launch(kind, dtype, dev, *args):
    fn = getattr(_load(), 'plk_%s_%s' % (kind, _suffix(dtype)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(*args, dev.index, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError('%s kernel launch failed: CUDA error %d' % (kind, rc))


def _launch_pair(kind, a_p, a_m, o_p, o_m, t_m, t_p, B, L, M, R, mode, dev, *extra):
    _launch(kind, a_p.dtype, dev, _ptr(a_p), _ptr(a_m), _ptr(o_p), _ptr(o_m),
            *_tab_args(t_m), *_tab_args(t_p), _ptr(t_m['x']), B, L, M, R, mode, *extra)


def anal_pair_plan(Qp, Qm, spin):
    """The PairPlan that `anal_pair` launches on the inputs Qp (B, nrings, M), Qm (or None)
    of `spin`."""
    B, R, M = Qp.shape
    return plan_pair(R, M, B, pair_mode(spin, Qm is not None))


def anal_plan(B, R, M, L, dtype, device, nseg=None):
    """The SegmentPlan of a K4 call on B maps of `dtype` (complex64/128) on R rings with M
    columns and L = lmax + 1 degrees, on the CUDA `device` (its SM count); `nseg` forces a
    count (`plan_segments`)."""
    bt, rpp = ANAL_TILE['plain', _suffix(dtype)]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    esize = torch.empty((), dtype=dtype).element_size()
    return plan_segments(R, L, M, B, bt, rpp, 1, esize, sms, nseg=nseg)


def synth_pair(Cp, Cm, spin, nrings, t_m, t_p):
    """K1: (Fp, Fm) = NS-pair synthesis of Cp (with d_{m,-spin}) and Cm (d_{m,+spin}).

    Cp, Cm: (B, lmax+1, M) complex64/128 contiguous CUDA tensors (Cm may be None);
    t_m/t_p: f64 device table sets on the northern ceil(nrings/2) rings.
    Returns (B, nrings, M) complex outputs, Fm None when Cm is None. One launch of
    `synth_pair_plan`'s design: f64 data on the FP64 tensor cores, f32 data on
    synth_pair_kernel. Bitwise reproducible: each output element is written once."""
    B, L, M = Cp.shape
    nh = (nrings + 1) // 2
    _check_data('Cp', Cp, None, (B, L, M))
    if Cm is not None:
        _check_data('Cm', Cm, Cp, (B, L, M))
    dev = Cp.device
    for t in (t_m, t_p):
        _check_tables(t, dev, L, M, nh)
    Fp = torch.empty((B, nrings, M), dtype=Cp.dtype, device=dev)
    Fm = None if Cm is None else torch.empty_like(Fp)
    mode = pair_mode(spin, Cm is not None)
    plan = synth_pair_plan(Cp, Cm, spin, nrings)
    if plan.mma:
        _launch_pair('synth_pair_mma', Cp, Cm, Fp, Fm, t_m, t_p, B, L, M, nrings, mode, dev,
                     plan.batch_tile, plan.blocks_per_m)
    else:
        _launch_pair('synth_pair', Cp, Cm, Fp, Fm, t_m, t_p, B, L, M, nrings, mode, dev)
    return Fp, Fm


def anal_pair(Qp, Qm, spin, lmax, t_m, t_p):
    """K2: (A, Bc) = NS-pair analysis of Qp (with d_{m,-spin}) and Qm (d_{m,+spin}).

    Qp, Qm: (B, nrings, M) complex64/128 contiguous CUDA tensors, quadrature-weighted
    (Qm may be None). Returns (B, lmax+1, M) complex outputs, Bc None when Qm is None.
    One launch of `anal_pair_plan`'s clusters. Deterministic: the ring sums are reduced in a
    fixed order at every level."""
    B, R, M = Qp.shape
    L = lmax + 1
    _check_data('Qp', Qp, None, (B, R, M))
    if Qm is not None:
        _check_data('Qm', Qm, Qp, (B, R, M))
    dev = Qp.device
    for t in (t_m, t_p):
        _check_tables(t, dev, L, M, (R + 1) // 2)
    A = torch.empty((B, L, M), dtype=Qp.dtype, device=dev)
    Bc = None if Qm is None else torch.empty_like(A)
    plan = anal_pair_plan(Qp, Qm, spin)
    _launch_pair('anal_pair', Qp, Qm, A, Bc, t_m, t_p, B, L, M, R,
                 pair_mode(spin, Qm is not None), dev, plan.warps,
                 plan.batch_tile, plan.cluster, plan.rings_per_block)
    return A, Bc


def synth(C, nrings, t):
    """K3: G = sum_l C_lm d^l_{m,n}(theta_j) on every ring j of any grid (no mirror).

    C: (B, lmax+1, M) complex64/128 contiguous CUDA tensor; t: the f64 device table set
    of d^l_{m,n} on all `nrings` rings. Returns (B, nrings, M) complex."""
    B, L, M = C.shape
    _check_data('C', C, None, (B, L, M))
    dev = C.device
    _check_tables(t, dev, L, M, nrings)
    G = torch.empty((B, nrings, M), dtype=C.dtype, device=dev)
    _launch('synth', C.dtype, dev, _ptr(C), _ptr(G), *_tab_args(t), _ptr(t['x']),
            B, L, M, nrings)
    return G


def anal(Q, lmax, t, nseg=None):
    """K4: A_lm = sum_j Q_jm d^l_{m,n}(theta_j) over every ring j of any grid (no mirror).

    Q: (B, nrings, M) complex64/128 contiguous CUDA tensor, quadrature-weighted; t: the
    f64 device table set on all rings. Returns (B, lmax+1, M) complex. The ring sum runs
    in `plan_segments`' segments (`nseg` forces a count). Deterministic: the ring sums
    are reduced in a fixed order at every level."""
    B, R, M = Q.shape
    L = lmax + 1
    _check_data('Q', Q, None, (B, R, M))
    dev = Q.device
    _check_tables(t, dev, L, M, R)
    A = torch.empty((B, L, M), dtype=Q.dtype, device=dev)
    plan = anal_plan(B, R, M, L, Q.dtype, dev, nseg)
    ws = None           # the nseg - 1 partial sums
    if plan.nseg > 1:
        ws = torch.empty((plan.nseg - 1, B, L, M), dtype=Q.dtype, device=dev)
    _launch('anal', Q.dtype, dev, _ptr(Q), _ptr(A), *_tab_args(t), _ptr(t['x']),
            B, L, M, R, _ptr(ws), plan.nseg)
    return A
