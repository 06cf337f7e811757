// Spin-s Legendre transforms for Hopper (sm_90a): the fused north-south pair kernels and
// their plain (no-mirror) mode.
//
// Replaces the four TPU kernels of the JAX reference package
// (plancklens_tpu/ops/sht/pallas_kernel.py):
//   K1  _make_synth_pair_kernel + _synth_pair_pallas   -> synth_pair_kernel (f32 data) and
//                                                         synth_pair_mma_kernel (f64 data),
//                                                         modes 0-2
//   K2  _make_anal_pair_kernel  + _anal_pair_pallas    -> anal_pair_mma_kernel, modes 0-2
//   K3  _synth_kernel + _synth_pallas                  -> synth_pair_kernel,    mode 3
//   K4  _anal_kernel  + _anal_pallas                   -> anal_pair_kernel,     mode 3
// All run the scaled three-term Wigner-d recursion over l. The pair modes run it on the
// northern half of a north-south symmetric ring grid, for d^l_{m,-s} and d^l_{m,+s} at
// once, and get the southern rings from the mirror identity
// d^l_{mn}(pi - t) = (-1)^{l+m} d^l_{m,-n}(t). The plain mode (3) runs one recursion,
// for d^l_{m,n}, over every ring of any grid (HEALPix, exact pixel-window node grids,
// asymmetric ring sets), with no mirror: north accumulators only, no southern rows.
//
// What bounds them on the H100: not HBM. Per (l, ring, m) the work is an f64 recursion
// step of ~10 operations per recursion and 2 multiply-adds per map (real/imag part), per
// hemisphere in the pair modes; the coefficients (synthesis) and recursion tables are read
// again at every l step, and the Fourier modes (analysis) stay on chip. At the main path's
// shapes (lmax 2048, 1537 northern rings, 2049 m, 8 maps) the pair modes' arithmetic is
// bound by FP32 throughput at ~6 ms, the plain mode at HEALPix shapes (8191 rings, 4 maps,
// f64) by FP64 at ~11 ms; the kernels take a few times that (PERF.md has the times).
//
// What bounds synth_pair_kernel (K1 on f32 data, K3), and what its design does about it.
// Each thread owns (ring, m) points and writes each output element once, so nothing is
// reduced across threads; a step is the recursion of RPT rings and the multiply-adds of BT
// maps, and its time is latency and instruction issue: one block of 8 warps fills an SM
// (150 to 250 registers a thread), so the independent work inside a thread is what hides
// latency.
//   * grid (ring tile, batch tile, m-tile) with the m-tile slowest: the ~132 blocks in
//     flight share one m-tile's coefficient and table columns (a few MB) through L2, so
//     C and the tables come from HBM about once a call; the low-m tiles, whose l loop is
//     longest, start first and the short ones fill the tail;
//   * a batch tile of 4 maps (8 above batch 4: the wide shape) runs the f64 recursion once
//     for all of them;
//   * several rings a thread (3 in the f32 pair modes, 6 on plain grids in f64; PLK_S_*
//     below): their recursions are independent chains that overlap each other's latency;
//   * the coefficient rows of the batch tile and the table rows of the next LCS l steps
//     are staged into shared memory by cp.async while the current LCS compute, two
//     buffers in turn and one barrier a chunk: every warp of a block needs the same rows,
//     and no step waits for its loads;
//   * the effective value d 2^(S k) is one multiplication by an exact power of two
//     (deff_mul), not a call of ldexp, a library routine with branches that costs about
//     a third of a step;
//   * the l loop inside a chunk is unrolled twice, so that the loads of the next step
//     are issued while this one computes.
// What is left is issue: counting its instructions, a step of the f32 pair mode 1 issues
// in about half the time it takes (PERF.md).
//
// K1 on f64 data (synth_pair_mma_kernel, below). There the accumulate, 2 multiply-adds a map
// and hemisphere per (l, ring, m), ran on the FP64 pipe beside the f64 recursion, and with
// one ring a thread (two spilled) the recursion had almost no independent chains to hide
// its latency: at the masked solves' shapes (batch 4, 2049 rings) 9.0 ms for spin 0 and
// 22.5 ms for the spin-2 pair, 5.7% and 9.1% of bound, and the recursion ran twice at
// batch 8. For one column m the synthesis is a matrix product over l, F[j, map] = sum_l
// lambda_l(j) C[l, map]; the design follows K2's:
//   * a thread runs two recursion chains (one on 8-map batch tiles in mode 0), step for
//     step as rec_step rounds, the effective value by deff_mul, and writes each chunk of 16
//     l into its warp's lambda tile, rows ordered by the parity of l;
//   * the warp contracts the tile with the chunk's coefficient rows (staged by cp.async,
//     two buffers in turn, the B operands) on the FP64 tensor cores, into accumulators
//     that stay in registers across all chunks; the mirror comes from the parity classes;
//   * one recursion serves a batch tile of 4 maps (8 above batch 4), whose re/im columns
//     fill the MMA's n dimension;
//   * a warp owns its rings for the whole l loop, so there is no cluster, no distributed
//     shared memory and no cross-warp sum; each output element is written once.
// It runs at 0.35-0.54x the time of the design above at those shapes, batch 1 included
// (PERF.md), so every f64 pair call takes it.
//
// K2, the pair analysis (anal_pair_mma_kernel, below). For one column m it is a matrix
// product over the rings, A[l, map] = sum_j lambda_l(j) Q[j, map]: the recursion produces
// lambda one chunk of 16 l at a time, and the FP64 tensor cores contract it. What bounded
// the earlier design (one block's ring passes adding into the outputs in HBM, a cross-warp
// sum behind a barrier every 2 l steps, a workspace and a second kernel for a split ring
// sum, the accumulate on the FP64/FP32 pipes beside the recursion) is gone by
// construction; what bounds it now is the recursion's latency and the per-chunk phases of
// a block that holds its SM alone or with one other (128 registers a thread, a third to a
// half of them the B operands): at the CinvT shape (f64, batch 8, 1025 northern rings)
// ~10 ms against a bound of 1.03, of which ~4 ms go with the recursion and ~3 ms with the
// MMA phase (PERF.md). Its design:
//   * a thread runs one recursion chain (on 8-map batch tiles) or two (on 4-map tiles: two
//     rings in mode 0, both recursions of a ring in modes 1/2), in f64, step for step as
//     rec_step rounds (never contracted into FMAs), the effective value by deff_mul; a
//     column's seed lies in its first chunk, so the later chunks step without the test;
//   * each warp writes its chains' lambda into its own tile in shared memory, rows ordered
//     by the parity of l, and contracts the tile with B operands it loaded from Q once and
//     keeps in registers (f32 data widened to f64, each output rounded once to f32; TF32
//     would not compute the same function): mode 0 folds the mirror as Qn +- Qs' into one
//     operand per parity class (m8n8k4), modes 1/2 take both classes as one 16-row tile
//     (Hopper's m16n8k16) and put (-1)^l on the odd rows of each recursion's sum;
//   * the blocks of one (m, batch tile) are one thread-block cluster (up to 8 blocks, up to
//     16 as a non-portable size) holding all northern rings: a block sums its warps'
//     partials, and block r sums its share of a chunk's outputs over the cluster in rank
//     order through distributed shared memory and writes each element once, so there is no
//     read-back of the outputs, no workspace and no second kernel; the cluster barrier is
//     split around the next chunk's recursion, and two buffers of block partials make one
//     barrier a chunk both publish and free;
//   * the table rows of the next chunks arrive by cp.async, two buffers in turn; the grid
//     is (cluster rank, batch tile, m), so clusters start in order of m and the low m,
//     whose l loop is longest, run first.
// Q is (B, R, M) and A is (B, L, M), m fastest: a block of one m reads and writes 8- or
// 16-byte elements at stride M, a 32-byte sector each (the inputs once and each output once:
// at the CinvT shape ~0.5 GB of each, ~0.3 ms at the HBM rate).
//
// K4, the plain analysis (anal_pair_kernel in mode 3). Each l step of a block is latency,
// not arithmetic: table rows to fetch, a chain of dependent f64 operations per ring, a
// cross-warp sum through shared memory behind a barrier and an add into global memory, and
// registers allow one block an SM, so nothing else runs meanwhile. The time of a call is
// (steps of all blocks) x (latency of a step) / (SMs kept busy). Keeping the SMs busy:
//   * the ring sum is split: block (s, batch tile, m-tile) runs only the ring passes of
//     segment s, a whole number of passes (one pass = warps x rings per thread), so a
//     call is many short blocks in several waves instead of one wave as slow as its
//     longest; the m-tile is the slowest grid dimension, so the low-m tiles run first;
//   * segment 0 adds into the output itself, segment s > 0 into partial s - 1 of a
//     workspace (NS - 1, B, L, M) that the wrapper allocates; anal_pair_sum_kernel then
//     adds the partials to the output in the order s = 1, 2, ... The segment count comes
//     from the wrapper (legendre_kernels.plan_segments: about 4 waves of blocks, under a
//     workspace cap).
// Shortening the step, the block:
//   * many rings a thread and few warps (PLK_A_* below, at 150 to 250 registers): the
//     independent recursions of a thread's rings overlap each other's latency;
//   * the table rows of the next LCH l steps are staged into shared memory by cp.async
//     while the current LCH compute, two buffers in turn;
//   * one barrier for KS l steps, not two for one: the warps leave their sums of a group
//     of KS steps in one of two shared-memory buffers used in turn, so the barrier that
//     publishes a group also frees the buffer of the group before;
//   * the running sum that a row is added to (every ring pass of a segment after its
//     first) is fetched from global memory before the group's arithmetic.
// It still takes the effective value through deff (ldexp), which K1/K2 replaced by deff_mul.
//
// Precision. The recursion always runs in f64 (S = 256), also for f32 data: an f32
// recursion, as the TPU kernels ran it, loses the small angles near the poles (cos theta
// and 2 cos theta round to within 1e-7 of 1 and 2): at lmax 2048 on the 3073-ring QE grid
// its spin-1 synthesis is off by 5.4e-4 rms and 9.6e-3 of max against f64, and by up to
// 4e-2 on single polar rings. The H100 has native FP64. K3, K4 and K1 on f32 data
// accumulate in the data type; K1 on f64 data accumulates in f64 on the tensor cores, and
// K2 too, rounding each output once to the data type (no TF32 anywhere). HEALPix's polar
// rings (theta = 4.0e-4 at nside 2048) seed far below f64's range; the exponent count k of
// the scaled recursion carries them, north and south alike.
//
// Layout of the work. Synthesis (synth_pair_kernel): one thread per (ring, m) of RPT rings
// keeps the recursion states and the outputs of a batch tile in registers; threads lie
// along m so that a row C[b, l, m..m+31] is one coalesced copy into shared memory, which all
// warps of the block read. synth_pair_mma_kernel: a block holds one m, a warp its rings,
// the outputs of a batch tile in the MMA's accumulator fragments.
// Analysis: the sum over rings is a cross-thread reduction, made deterministic (no float
// atomics). K2: the tensor-core products in a fixed order, the warps' partials summed in
// warp order, the blocks' in rank order. K4: the warps of a block reduce through shared
// memory in a fixed order; each element of the output or a partial is written by one
// block, which adds the sums of its segment's ring passes in order; and the partials are
// added in order of segment.
//
// Layouts (all contiguous, complex interleaved): C (B, L, M), F (B, R, M), Q (B, R, M),
// A (B, L, M); f64 tables alpha/beta/gamma (L, M), seed_v/seed_k (nh, M), l0 (M), x (nh)
// with L = lmax + 1, M = mmax + 1, R = nrings, nh = ceil(R / 2) in the pair modes and
// nh = R in the plain mode.
// mode 0: spin 0, one input (one recursion); mode 1: two inputs and two outputs;
// mode 2: spin != 0, one input (both recursions, one output); mode 3: plain, one input,
// one recursion over all rings.
//
// Plain C interface (ctypes); each entry point returns the first error of the launches it
// makes (cudaGetLastError() after each, K4's second pass included; K2's cluster launch
// through cudaLaunchKernelEx, which also fails when no cluster of its size fits).
#include <cooperative_groups.h>
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int PLAIN = 3;

template <typename T> struct C2t;
template <> struct C2t<float> { using type = float2; };
template <> struct C2t<double> { using type = double2; };

constexpr int S = 256;                 // exponent chunk of the f64 scaled recursion
constexpr double THRESH = 0x1p128;     // 2^(S/2)
constexpr double DOWN = 0x1p-256;      // 2^-S

struct Tables {
  const double* alpha;
  const double* beta;
  const double* gamma;
  const int* l0;
  const double* seed_v;
  const int* seed_k;
};

// recursion state of one (ring, m): d_{l-1}, d_l and the 2^S exponent count k
struct Rec {
  double dm1, d;
  int k;
  double sv;
  int sk, l0;
};

__device__ __forceinline__ void rec_init(Rec& r, const Tables& t, int j, int m, int M,
                                         bool valid) {
  r.l0 = valid ? t.l0[m] : 0x3fffffff;   // masked lanes never seed
  r.sv = valid ? t.seed_v[(size_t)j * M + m] : 0.;
  r.sk = valid ? t.seed_k[(size_t)j * M + m] : 0;
  r.dm1 = 0.;
  r.d = (r.l0 == 0) ? r.sv : 0.;
  r.k = (r.l0 == 0) ? r.sk : 0;
}

// one scaled step l -> l+1; twin of core._rec_step (plain torch) and of the reference's
// core._rec_step / pallas_kernel._kernel_rec: injection zeroes d and replaces k; the
// rescale applies to both d and d_next. Written in round-to-nearest operations that the
// compiler never contracts into FMAs, so that it rounds step for step like the twin's
// separate elementwise ops.
__device__ __forceinline__ void rec_step(Rec& r, int l, double a, double b, double g,
                                         double x) {
  double dn = __dsub_rn(__dmul_rn(__dadd_rn(__dmul_rn(a, x), b), r.d), __dmul_rn(g, r.dm1));
  double dnew = r.d;
  int k = r.k;
  if (l + 1 == r.l0) {
    dnew = 0.;
    dn = r.sv;
    k = r.sk;
  }
  if (k < 0 && fabs(dn) > THRESH) {
    dnew *= DOWN;
    dn *= DOWN;
    k += 1;
  }
  r.dm1 = dnew;
  r.d = dn;
  r.k = k;
}

// rec_step for a state past its seed (l + 1 > l0): the same rounding, without the seed test
__device__ __forceinline__ void rec_step_seeded(Rec& r, double a, double b, double g,
                                                double x) {
  double dn = __dsub_rn(__dmul_rn(__dadd_rn(__dmul_rn(a, x), b), r.d), __dmul_rn(g, r.dm1));
  double dnew = r.d;
  int k = r.k;
  if (k < 0 && fabs(dn) > THRESH) {
    dnew *= DOWN;
    dn *= DOWN;
    k += 1;
  }
  r.dm1 = dnew;
  r.d = dn;
  r.k = k;
}

// effective d = d 2^(S k) (exact), rounded once to the data type
template <typename T>
__device__ __forceinline__ T deff(const Rec& r) {
  return T(r.k == 0 ? r.d : ldexp(r.d, S * r.k));
}

// deff without ldexp, for the synthesis: the same value, bit for bit. A state with k < 0
// has |d| <= 2^(S/2) (rec_step rescales above it; k <= 0 always), so d 2^(S k) is one
// multiplication by an exact power of two, rounded once as ldexp rounds: 2^(S k) is a
// normal double for k >= -3 and the subnormal 2^-1024 for k = -4; for k <= -5 the product
// is below 2^-1075 and rounds to a zero of d's sign, which d x 0 gives. (ldexp takes a
// library routine with branches, in every step of every ring, divergent where k differs
// across a warp.)
__device__ __forceinline__ double pow2_sk(int k) {
  return k >= -3 ? __longlong_as_double((long long)(1023 + S * k) << 52)
                 : (k == -4 ? __longlong_as_double(1LL << 50) : 0.);
}

template <typename T>
__device__ __forceinline__ T deff_mul(const Rec& r) {
  return T(__dmul_rn(r.d, pow2_sk(r.k)));
}

// first l of the block's loop: rows below l0(m) - 1 leave the state at zero, so starting
// there is exact (l0 is nondecreasing in m; the block's first m has the smallest)
__device__ __forceinline__ int loop_start(const int* l0m, const int* l0p, int m_first) {
  int a = l0m[m_first], b = l0p[m_first];
  int lo = a < b ? a : b;
  return lo > 0 ? lo - 1 : 0;
}

// rows the recursion runs on: the northern half (equator included) or, plain, all rings
template <int MODE>
__host__ __device__ __forceinline__ int rec_rows(int R) {
  return MODE == PLAIN ? R : (R + 1) / 2;
}

// ------------------------------------------------------------------ K1/K3 synthesis
// A block is NWS warps (lanes along m, warps along rings) of RPT rings a thread, on a batch
// tile of BT maps; MINB blocks are meant to share an SM. The coefficient rows of the
// batch tile and the table rows of LCS successive l are staged into shared memory by
// cp.async, two buffers in turn: the rows of the next chunk arrive while this one computes.
constexpr int LCS = 16;   // l steps of one staged chunk of coefficients and table rows
// unrolling of the l loop in a chunk (measured: 1 is ~10% slower, 4 spills)
constexpr int LUNROLL = 2;

template <typename T, int BT, int RPT, int NWS, int MINB, int MODE>
__global__ void __launch_bounds__(NWS * 32, MINB)
synth_pair_kernel(const typename C2t<T>::type* __restrict__ Cp,
                  const typename C2t<T>::type* __restrict__ Cm,
                  typename C2t<T>::type* __restrict__ Fp,
                  typename C2t<T>::type* __restrict__ Fm,
                  Tables tm, Tables tp, const double* __restrict__ x,
                  int B, int L, int M, int R) {
  using C2 = typename C2t<T>::type;
  constexpr bool TWO = MODE == 1 || MODE == 2;   // both recursions
  constexpr bool HASM = MODE == 1;               // second input/output
  constexpr bool MIRROR = MODE != PLAIN;         // southern rows from the mirror
  constexpr int NIN = HASM ? 2 : 1;              // inputs
  constexpr int NT = TWO ? 6 : 3;                // table rows of one l step
  extern __shared__ __align__(16) unsigned char smem[];
  C2 (*const cs)[LCS][NIN][BT][32] = reinterpret_cast<C2 (*)[LCS][NIN][BT][32]>(smem);
  double (*const tab)[LCS][NT][32] = reinterpret_cast<double (*)[LCS][NT][32]>(
      smem + 2 * sizeof(C2[LCS][NIN][BT][32]));

  const int nh = rec_rows<MODE>(R), n_s = R - nh;
  const int lane = threadIdx.x, w = threadIdx.y;
  // grid (ring tile, batch tile, m-tile): the m-tile is slowest, so the blocks in flight
  // share one m-tile's coefficient and table columns through L2, and the tiles with the
  // longest l loop start first
  const int m_first = blockIdx.z * 32;
  const int m = m_first + lane;
  const bool mvalid = m < M;
  const int m_in = mvalid ? m : M - 1;      // a column to read for lanes past mmax
  const int b0 = blockIdx.y * BT;

  Rec rm[RPT], rp[RPT];
  double xr[RPT];
  int jr[RPT];
  C2 pn[RPT][BT], ps[RPT][BT], mn[RPT][BT], ms[RPT][BT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    jr[r] = blockIdx.x * (NWS * RPT) + w + r * NWS;
    const bool v = mvalid && jr[r] < nh;
    const int j = jr[r] < nh ? jr[r] : 0;
    xr[r] = x[j];
    rec_init(rm[r], tm, j, m, M, v);
    if (TWO) rec_init(rp[r], tp, j, m, M, v);
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      pn[r][b] = ps[r][b] = mn[r][b] = ms[r][b] = C2{T(0), T(0)};
    }
  }

  // the warps stage rows lc .. lc + LCS - 1 of the coefficients and tables into buffer cb,
  // a row of 32 m a warp in turn (rows past lmax, maps past B and columns past mmax repeat
  // the last: they feed steps that are not run, outputs that are not written and masked
  // lanes, whose recursion never seeds)
  auto stage = [&](int lc, int cb) {
#pragma unroll
    for (int i = w; i < LCS * NIN * BT; i += NWS) {
      const int s = i / (NIN * BT), in = (i / BT) % NIN, b = i % BT;
      const int l = lc + s < L ? lc + s : L - 1;
      const int bb = b0 + b < B ? b0 + b : B - 1;
      __pipeline_memcpy_async(&cs[cb][s][in][b][lane],
                              (in == 0 ? Cp : Cm) + ((size_t)bb * L + l) * M + m_in,
                              sizeof(C2));
    }
#pragma unroll
    for (int i = w; i < LCS * NT; i += NWS) {
      const int s = i / NT, k = i % NT;
      const double* row = k == 0 ? tm.alpha : k == 1 ? tm.beta : k == 2 ? tm.gamma
                        : k == 3 ? tp.alpha : k == 4 ? tp.beta : tp.gamma;
      __pipeline_memcpy_async(&tab[cb][s][k][lane],
                              row + (size_t)(lc + s < L ? lc + s : L - 1) * M + m_in, 8);
    }
    __pipeline_commit();
  };

  const int lbeg = loop_start(tm.l0, TWO ? tp.l0 : tm.l0, m_first);
  stage(lbeg, 0);
  for (int lc = lbeg, cb = 0; lc < L; lc += LCS, cb ^= 1) {
    // one barrier a chunk: it publishes buffer cb, and every thread is past its reads of
    // the other buffer (the chunk before), which is refilled next
    __pipeline_wait_prior(0);
    __syncthreads();
    if (lc + LCS < L) stage(lc + LCS, cb ^ 1);
    const int lend = lc + LCS < L ? lc + LCS : L;
#pragma unroll LUNROLL
    for (int l = lc; l < lend; ++l) {
      const int s = l - lc;
      const double am = tab[cb][s][0][lane], bm = tab[cb][s][1][lane],
                   gm = tab[cb][s][2][lane];
      const double ap = TWO ? tab[cb][s][3 % NT][lane] : 0.,
                   bp = TWO ? tab[cb][s][4 % NT][lane] : 0.,
                   gp = TWO ? tab[cb][s][5 % NT][lane] : 0.;
      C2 cp[BT], cm[BT];
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        cp[b] = cs[cb][s][0][b][lane];
        if (HASM) cm[b] = cs[cb][s][NIN - 1][b][lane];
      }
      const T sgn = (l & 1) ? T(-1) : T(1);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const T dm = deff_mul<T>(rm[r]);
        const T dp = TWO ? deff_mul<T>(rp[r]) : dm;
        const T dps = sgn * dp, dms = sgn * dm;
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          pn[r][b].x += cp[b].x * dm;  pn[r][b].y += cp[b].y * dm;
          if (MIRROR) { ps[r][b].x += cp[b].x * dps; ps[r][b].y += cp[b].y * dps; }
          if (HASM) {
            mn[r][b].x += cm[b].x * dp;  mn[r][b].y += cm[b].y * dp;
            ms[r][b].x += cm[b].x * dms; ms[r][b].y += cm[b].y * dms;
          }
        }
        rec_step(rm[r], l, am, bm, gm, xr[r]);
        if (TWO) rec_step(rp[r], l, ap, bp, gp, xr[r]);
      }
    }
  }

  if (!mvalid) return;
  const T sgn_m = (m & 1) ? T(-1) : T(1);
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int j = jr[r];
    if (j >= nh) continue;
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      if (b0 + b >= B) continue;
      const size_t base = (size_t)(b0 + b) * R;
      Fp[(base + j) * M + m] = pn[r][b];
      if (MIRROR && j < n_s)
        Fp[(base + R - 1 - j) * M + m] = C2{sgn_m * ps[r][b].x, sgn_m * ps[r][b].y};
      if (HASM) {
        Fm[(base + j) * M + m] = mn[r][b];
        if (j < n_s) Fm[(base + R - 1 - j) * M + m] = C2{sgn_m * ms[r][b].x, sgn_m * ms[r][b].y};
      }
    }
  }
}

// ------------------------------------------------------------------------ K4 analysis
// A block is NWA warps (lanes along m, warps along rings) of RPT rings a thread, on a
// batch tile of BT maps; MINB blocks are meant to share an SM. Plain mode only (MODE is
// PLAIN: one recursion over every ring, no mirror); K2 is anal_pair_mma_kernel below.
constexpr int LCH = 16;   // l steps of one staged chunk of table rows
constexpr int KS = 2;     // l steps between two barriers of a block (measured: 1 and 4 are slower)

template <typename T, int BT, int RPT, int NWA, int MINB, int MODE>
__global__ void __launch_bounds__(NWA * 32, MINB)
anal_pair_kernel(const typename C2t<T>::type* __restrict__ Qp,
                 typename C2t<T>::type* __restrict__ A,
                 typename C2t<T>::type* __restrict__ ws,
                 Tables tm, const double* __restrict__ x,
                 int B, int L, int M, int R, int pps) {
  using C2 = typename C2t<T>::type;
  static_assert(MODE == PLAIN, "the pair modes run anal_pair_mma_kernel");
  static_assert(BT <= NWA, "one warp per output for the rows below the loop");
  constexpr int PPW = (KS * BT + NWA - 1) / NWA;   // (step, output) rows a warp sums

  // two buffers of the warps' partial sums of KS successive l steps, used in turn
  static_assert(LCH % KS == 0, "whole groups of steps in a chunk of table rows");
  extern __shared__ __align__(16) unsigned char smem[];
  T (*const red)[KS][BT][2][NWA][32] = reinterpret_cast<T (*)[KS][BT][2][NWA][32]>(smem);
  // two buffers of the recursion tables' rows of LCH successive l, staged by cp.async:
  // the rows of the next chunk arrive while this one computes
  double (*const tab)[3][LCH][32] =
      reinterpret_cast<double (*)[3][LCH][32]>(smem + 2 * sizeof(T[KS][BT][2][NWA][32]));

  const int nh = R;
  const int lane = threadIdx.x, w = threadIdx.y;
  // grid (ring segment, batch tile, m-tile): the m-tile is slowest, so the tiles with the
  // longest l loop start first
  const int seg = blockIdx.x;
  const int m_first = blockIdx.z * 32;
  const int m = m_first + lane;
  const bool mvalid = m < M;
  const int m_in = mvalid ? m : M - 1;      // a column to read for lanes past mmax
  const int b0 = blockIdx.y * BT;
  const int lbeg = loop_start(tm.l0, tm.l0, m_first);

  // Output v < BT of a block is map b0 + v: a row of the output in segment 0, of partial
  // seg - 1 of the workspace otherwise. Every row l >= lbeg is written in each ring pass of
  // the segment; segment 0 also writes the rows below lbeg, once, and no partial holds them.
  auto out_row = [&](int v, int l) {
    C2* const base = seg == 0 ? A : ws + (size_t)(seg - 1) * ((size_t)B * L * M);
    return base + ((size_t)(b0 + v) * L + l) * M + m;
  };
  auto out_valid = [&](int v) { return mvalid && (b0 + v) < B; };
  if (seg == 0 && w < BT && out_valid(w)) {
    for (int l = 0; l < lbeg; ++l) *out_row(w, l) = C2{T(0), T(0)};
  }

  // the segment's ring passes: pps passes of NWA * RPT rows, the last segment's fewer
  const int j_begin = seg * pps * (NWA * RPT);
  const int j_end = min(nh, j_begin + pps * (NWA * RPT));
  int group = 0;      // groups of KS l steps of this block so far, over all its passes
  // the warps stage rows lc .. lc + LCH - 1 of each table into buffer cb, a row a warp
  // (rows past lmax and columns past mmax repeat the last: they feed masked lanes and
  // steps that are not run)
  auto stage = [&](int lc, int cb) {
#pragma unroll
    for (int i = w; i < LCH; i += NWA) {
      const size_t at = (size_t)(lc + i < L ? lc + i : L - 1) * M + m_in;
      __pipeline_memcpy_async(&tab[cb][0][i][lane], tm.alpha + at, 8);
      __pipeline_memcpy_async(&tab[cb][1][i][lane], tm.beta + at, 8);
      __pipeline_memcpy_async(&tab[cb][2][i][lane], tm.gamma + at, 8);
    }
    __pipeline_commit();
  };
  for (int j0 = j_begin; j0 < j_end; j0 += NWA * RPT) {
    Rec rm[RPT];
    double xr[RPT];
    C2 qpn[RPT][BT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int jj = j0 + w + r * NWA;
      const bool v = mvalid && jj < nh;
      const int j = jj < nh ? jj : 0;
      xr[r] = x[j];
      rec_init(rm[r], tm, j, m, M, v);
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        const bool vb = v && (b0 + b) < B;
        const size_t base = (size_t)(b0 + b) * R;
        qpn[r][b] = vb ? Qp[(base + j) * M + m] : C2{T(0), T(0)};
      }
    }
    const bool first = j0 == j_begin;

    // (every thread is past the last barrier of the pass before, so past its table reads)
    stage(lbeg, 0);
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int lc = lbeg, cb = 0; lc < L; lc += LCH, cb ^= 1) {
      if (lc + LCH < L) stage(lc + LCH, cb ^ 1);
      const int lend = lc + LCH < L ? lc + LCH : L;
      // The l steps go in groups of KS between barriers. In a group every warp leaves its
      // rings' sums of each step in shared memory; after the barrier the KS * BT (step,
      // output) rows of the group are shared out over the warps, PPW a warp, each summed
      // over the warps' partials in a fixed order and added to the running sum in global
      // memory, which was fetched before the group's arithmetic to hide its latency.
      for (int ls = lc; ls < lend; ls += KS, ++group) {
        T (&rd)[KS][BT][2][NWA][32] = red[group & 1];
        C2 prev[PPW];
#pragma unroll
        for (int i = 0; i < PPW; ++i) {
          const int p = w + i * NWA, kk = p / BT, v = p % BT;
          prev[i] = C2{T(0), T(0)};
          if (!first && p < KS * BT && ls + kk < lend && out_valid(v))
            prev[i] = *out_row(v, ls + kk);
        }
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const int l = ls + kk;
          if (l >= lend) break;
          const double am = tab[cb][0][l - lc][lane], bm = tab[cb][1][l - lc][lane],
                       gm = tab[cb][2][l - lc][lane];
          C2 va[BT];
#pragma unroll
          for (int b = 0; b < BT; ++b) va[b] = C2{T(0), T(0)};
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            const T dm = deff<T>(rm[r]);
#pragma unroll
            for (int b = 0; b < BT; ++b) {
              va[b].x += qpn[r][b].x * dm;
              va[b].y += qpn[r][b].y * dm;
            }
            rec_step(rm[r], l, am, bm, gm, xr[r]);
          }
#pragma unroll
          for (int b = 0; b < BT; ++b) {
            rd[kk][b][0][w][lane] = va[b].x;
            rd[kk][b][1][w][lane] = va[b].y;
          }
        }
        // one barrier a group: the next group writes the other buffer, and this buffer
        // is written again only after the next group's barrier, which every reader
        // below reaches after its reads. The barrier of a chunk's last group also
        // publishes the next chunk's table rows, and ends the reads of this chunk's
        if (ls + KS >= lend) __pipeline_wait_prior(0);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < PPW; ++i) {
          const int p = w + i * NWA, kk = p / BT, v = p % BT;
          if (p < KS * BT && ls + kk < lend && out_valid(v)) {
            T sx = T(0), sy = T(0);
#pragma unroll
            for (int ww = 0; ww < NWA; ++ww) {   // fixed order: deterministic
              sx += rd[kk][v][0][ww][lane];
              sy += rd[kk][v][1][ww][lane];
            }
            *out_row(v, ls + kk) = C2{prev[i].x + sx, prev[i].y + sy};
          }
        }
      }
    }
  }
}

// second pass of K4's split ring sum: out += partial 0 + partial 1 + ... in this order, for
// the rows l >= lbeg of each m-tile (segment 0 wrote the rows below, the partials do not
// hold them). One thread per output element; MODE as in the analysis kernel.
template <typename T, int MODE>
__global__ void __launch_bounds__(256)
anal_pair_sum_kernel(typename C2t<T>::type* __restrict__ A,
                     const typename C2t<T>::type* __restrict__ ws,
                     const int* __restrict__ l0, int B, int L, int M, int npart) {
  using C2 = typename C2t<T>::type;
  static_assert(MODE == PLAIN, "the pair modes have no second pass");
  const size_t n = (size_t)B * L * M;
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int m = (int)(e % M), l = (int)((e / M) % L);
  if (l < loop_start(l0, l0, m & ~31)) return;
  C2* const o = A + e;
  C2 acc = *o;
  for (int s = 0; s < npart; ++s) {           // fixed order: deterministic
    const C2 p = ws[(size_t)s * n + e];
    acc.x += p.x;
    acc.y += p.y;
  }
  *o = acc;
}

// ------------------------------------------------------- K2 pair analysis on the FP64 MMA
// For one column m the pair analysis is a matrix product over the rings j:
//   A[l, map] = sum_j lambda_l(j) Q[j, map],
// with lambda the recursion's effective values. A block holds a slice of the northern
// rings of one m and one batch tile; the blocks of one (m, batch tile) are one thread-block
// cluster that together hold every northern ring. A thread runs NCH recursion chains (a
// chain: one recursion, d_{m,-s} or d_{m,+s}, on one ring): on a batch tile of 8 maps one,
// on a tile of 4 maps two (two rings in mode 0, both recursions of a ring in modes 1/2), so
// that the B operands (below) take the same registers. A warp's 32 NCH chains are the
// columns of its lambda tile. Per chunk of PLC l steps:
//   * every thread writes its chains' PLC values into its warp's lambda tile in shared
//     memory, rows ordered even l first (lc is even, so row p < 8 holds l = lc + 2p and row
//     8 + p holds l = lc + 2p + 1); only the warp itself reads its tile;
//   * the warp contracts its tile with the B operands of its chains, which it loaded from
//     Q once and keeps in registers (f64; f32 data is widened), on the FP64 tensor cores,
//     and leaves the partial tile in shared memory: mode 0 as two 8-row products (m8n8k4)
//     with one operand a parity class, modes 1/2 as one 16-row product (m16n8k16, Hopper's
//     f64 shape);
//   * after one barrier the block sums its warps' partials in warp order, and after one
//     cluster barrier block r sums its share of the chunk's outputs over the cluster's
//     blocks in rank order through distributed shared memory and writes each once (rounded
//     once to the data type). The cluster barrier is split (arrive, the next chunk's
//     recursion, wait), and the block partials have two buffers, so one barrier a chunk
//     both publishes the partials and frees the buffer of the chunk before.
// The B operands, columns (re, im) of the batch tile's maps:
//   mode 0: even-l rows with Qn + Qs', odd-l rows with Qn - Qs' (Qs' the mirror ring's data
//           times (-1)^m, zero for the equator of an odd ring count);
//   modes 1/2: output A takes Qpn on the d_{m,-s} chains and (-1)^l Qps' on the d_{m,+s}
//           chains, output B (mode 1) (-1)^l Qms' on the first and Qmn on the second;
//           (-1)^l is the sign of a row class, applied to the partial of each recursion.
constexpr int PLC = 16;        // l steps of one chunk: 8 even and 8 odd rows
constexpr int PMAXCS = 16;     // most blocks in a cluster (above 8 a non-portable size)

template <int MODE> __host__ __device__ constexpr int pair_recs() { return MODE == 0 ? 1 : 2; }
template <int MODE> __host__ __device__ constexpr int pair_outs() { return MODE == 1 ? 2 : 1; }
// recursion chains a thread: two on the narrow batch tile
template <int BT> __host__ __device__ constexpr int pair_nch() { return BT == 4 ? 2 : 1; }
// row stride (doubles) of a warp's lambda tile: 32 NCH chains + 4 for the banks
template <int BT> __host__ __device__ constexpr int pair_ls() { return 32 * pair_nch<BT>() + 4; }
// rings of a warp, and of a block of nw warps (one chain a thread in modes 1/2 splits the
// warps into one set a recursion)
template <int MODE, int BT> __host__ __device__ constexpr int pair_rpw() {
  return MODE == 0 ? 32 * pair_nch<BT>() : 32;
}
template <int MODE, int BT> __host__ __device__ constexpr int pair_sets() {
  return MODE != 0 && pair_nch<BT>() == 1 ? 2 : 1;
}
template <int MODE, int BT> __host__ __device__ constexpr int pair_rings(int nw) {
  return nw / pair_sets<MODE, BT>() * pair_rpw<MODE, BT>();
}
// complex row stride of a warp's partial tile: (outputs x maps) + 4 for the banks
template <int MODE, int BT> __host__ __device__ constexpr int pair_ps() {
  return pair_outs<MODE>() * BT + 4;
}
// complex elements of a chunk's output tile
template <int MODE, int BT> __host__ __device__ constexpr int pair_elems() {
  return PLC * pair_outs<MODE>() * BT;
}
// dynamic shared memory of a block of nw warps on a batch tile of BT maps: lambda tiles,
// warp partials, two buffers of block partials, two buffers of the chunk's table rows
template <int MODE, int BT> __host__ __device__ constexpr int pair_smem(int nw) {
  return nw * PLC * pair_ls<BT>() * 8 + nw * PLC * pair_ps<MODE, BT>() * 16 +
         2 * pair_elems<MODE, BT>() * 16 + 2 * pair_recs<MODE>() * 3 * PLC * 8;
}

// D += A B on the FP64 tensor cores: 8 x 8 x 4 (mode 0's rows of one parity class) and the
// sm_90 shape 16 x 8 x 16 (modes 1/2: both classes, four k-steps)
__device__ __forceinline__ void mma_f64(double (&d)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
               : "+d"(d[0]), "+d"(d[1])
               : "d"(a), "d"(b));
}
__device__ __forceinline__ void mma_f64_k16(double (&d)[4], const double (&a)[8],
                                            const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
        "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// one component (0 real, 1 imaginary) of a complex element, widened to f64
template <typename T>
__device__ __forceinline__ double comp(const typename C2t<T>::type* q, size_t at, int part) {
  return (double)reinterpret_cast<const T*>(q)[2 * at + part];
}

template <typename T, int NW, int BT, int MODE>
__global__ void __launch_bounds__(NW * 32, 16 / NW)
anal_pair_mma_kernel(const typename C2t<T>::type* __restrict__ Qp,
                     const typename C2t<T>::type* __restrict__ Qm,
                     typename C2t<T>::type* __restrict__ A,
                     typename C2t<T>::type* __restrict__ Bo,
                     Tables tm, Tables tp, const double* __restrict__ x,
                     int B, int L, int M, int R, int rs) {
  using C2 = typename C2t<T>::type;
  constexpr int NREC = pair_recs<MODE>(), NOUT = pair_outs<MODE>(), PS = pair_ps<MODE, BT>();
  constexpr int E = pair_elems<MODE, BT>();
  constexpr int NTH = NW * 32;
  constexpr int NCH = pair_nch<BT>(), LS = pair_ls<BT>();
  constexpr int KS = 8 * NCH;                // k-steps of 4 chains in a warp's tile
  constexpr int PNT = BT / 4;                // n-tiles of 8 columns: re, im of 4 maps
  constexpr int RPW = pair_rpw<MODE, BT>(), SETS = pair_sets<MODE, BT>();
  constexpr int RMAX = pair_rings<MODE, BT>(NW);
  constexpr bool BOTH = MODE != 0 && NCH == 2;   // a thread runs both recursions of a ring
  constexpr int NOP = MODE == 2 ? 1 : 2;     // B operand sets: mode 0 even/odd, mode 1 outputs
  static_assert(E <= NTH, "one element of the block sum a thread");
  extern __shared__ __align__(16) unsigned char smem[];
  double (*const lam)[PLC][LS] = reinterpret_cast<double (*)[PLC][LS]>(smem);
  double2 (*const wp)[PLC][PS] =
      reinterpret_cast<double2 (*)[PLC][PS]>(smem + NW * PLC * LS * 8);
  double2 (*const bp)[E] = reinterpret_cast<double2 (*)[E]>(
      smem + NW * PLC * LS * 8 + NW * PLC * PS * 16);
  double (*const tab)[NREC * 3][PLC] = reinterpret_cast<double (*)[NREC * 3][PLC]>(
      smem + NW * PLC * LS * 8 + NW * PLC * PS * 16 + 2 * E * 16);

  // the cluster is the grid's x dimension: cs blocks, block rank blockIdx.x
  cg::cluster_group cl = cg::this_cluster();
  const int cs = gridDim.x, rank = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int mi = blockIdx.z;                 // column: m - m0
  const int b0 = blockIdx.y * BT;
  const int nh = (R + 1) / 2, n_s = R - nh;
  const double sgn_m = (mi & 1) ? -1. : 1.;
  const int lc0 = loop_start(tm.l0, NREC == 2 ? tp.l0 : tm.l0, mi) & ~1;
  const int nch = lc0 < L ? (L - lc0 + PLC - 1) / PLC : 0;

  // the warp's rings start at wi0 of the block's slice; one chain a thread in modes 1/2
  // gives the second set of warps the d_{m,+s} recursion
  const int wset = w * SETS / NW;
  const int wi0 = (w % (NW / SETS)) * RPW;
  auto live_warp = [&](int ww) {             // has a ring of the grid
    const int i0 = (ww % (NW / SETS)) * RPW;
    return i0 < rs && rank * rs + i0 < nh;
  };
  const bool live = live_warp(w);
  // column c of the warp's tile: its recursion (0: d_{m,-s}) and its ring in the slice
  auto col_half = [&](int c) { return BOTH ? c / 32 : wset; };
  auto col_ring = [&](int c) { return wi0 + (MODE == 0 ? c : c % 32); };

  Rec st[NCH];
  double xr[NCH];
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {
    const int c = 32 * ch + lane, i = col_ring(c), j = rank * rs + i;
    const bool valid = i < rs && j < nh;
    if (col_half(c))   // (not `half ? tp : tm`: a reference chosen at run time puts both on the stack)
      rec_init(st[ch], tp, valid ? j : 0, mi, M, valid);
    else
      rec_init(st[ch], tm, valid ? j : 0, mi, M, valid);
    xr[ch] = x[valid ? j : 0];
  }

  // B operands of the warp's k-steps (tile columns 4 ks + t4), columns 8 nt + g of the
  // product: map b0 + 4 nt + g / 2, part g % 2
  double bf[NOP][PNT][KS];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int c = 4 * ks + t4, ic = col_ring(c), jc = rank * rs + ic;
    const bool ok = live && ic < rs && jc < nh;
    const bool first = col_half(c) == 0;     // a d_{m,-s} chain
#pragma unroll
    for (int nt = 0; nt < PNT; ++nt) {
      const int bb = b0 + 4 * nt + (g >> 1), part = g & 1;
      const bool okb = ok && bb < B;
      const size_t n_at = ((size_t)bb * R + jc) * M + mi;
      const size_t s_at = ((size_t)bb * R + (R - 1 - jc)) * M + mi;
      const bool oks = okb && jc < n_s;
      if (MODE == 0) {
        const double qn = okb ? comp<T>(Qp, n_at, part) : 0.;
        const double qs = oks ? sgn_m * comp<T>(Qp, s_at, part) : 0.;
        bf[0][nt][ks] = qn + qs;
        bf[NOP - 1][nt][ks] = qn - qs;
      } else {
        bf[0][nt][ks] = first ? (okb ? comp<T>(Qp, n_at, part) : 0.)
                              : (oks ? sgn_m * comp<T>(Qp, s_at, part) : 0.);
        if (MODE == 1)
          bf[NOP - 1][nt][ks] = first ? (oks ? sgn_m * comp<T>(Qm, s_at, part) : 0.)
                                      : (okb ? comp<T>(Qm, n_at, part) : 0.);
      }
    }
  }

  // rows l < lc0 are zero: block r writes those with l % cs == r
  {
    const int lz = lc0 < L ? lc0 : L;
    const int nrow = lz > rank ? (lz - rank + cs - 1) / cs : 0;
    for (int e = tid; e < nrow * NOUT * BT; e += NTH) {
      const int k = e / (NOUT * BT), v = e % (NOUT * BT), o = v / BT, b = v % BT;
      if (b0 + b < B)
        (o == 0 ? A : Bo)[((size_t)(b0 + b) * L + rank + cs * k) * M + mi] = C2{T(0), T(0)};
    }
  }
  if (nch == 0) return;   // every block of the cluster returns here, before any barrier

  // the table rows of chunk c into buffer cb (rows past lmax repeat the last: they feed
  // steps whose outputs are not written)
  auto stage = [&](int c, int cb) {
    for (int e = tid; e < NREC * 3 * PLC; e += NTH) {
      const int k = e / PLC, s = e % PLC;
      const double* row = k == 0 ? tm.alpha : k == 1 ? tm.beta : k == 2 ? tm.gamma
                        : k == 3 ? tp.alpha : k == 4 ? tp.beta : tp.gamma;
      const int l = lc0 + c * PLC + s < L ? lc0 + c * PLC + s : L - 1;
      __pipeline_memcpy_async(&tab[cb][k][s], row + (size_t)l * M + mi, 8);
    }
    __pipeline_commit();
  };
  // the warp's lambda tile of chunk c. A column's recursions seed at l0 - 1, in chunk 0
  // (lc0 >= l0 - 2), so the later chunks step without the seed test
  auto recur = [&](int c) {
    if (!live) return;
    const int lc = lc0 + c * PLC, cb = c & 1;
    if (c == 0) {
#pragma unroll
      for (int s = 0; s < PLC; ++s)
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          const int h = 3 * col_half(32 * ch + lane);
          lam[w][(s & 1) * 8 + (s >> 1)][32 * ch + lane] = deff_mul<double>(st[ch]);
          rec_step(st[ch], lc + s, tab[cb][h][s], tab[cb][h + 1][s], tab[cb][h + 2][s],
                   xr[ch]);
        }
    } else {
#pragma unroll
      for (int s = 0; s < PLC; ++s)
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          const int h = 3 * col_half(32 * ch + lane);
          lam[w][(s & 1) * 8 + (s >> 1)][32 * ch + lane] = deff_mul<double>(st[ch]);
          rec_step_seeded(st[ch], tab[cb][h][s], tab[cb][h + 1][s], tab[cb][h + 2][s],
                          xr[ch]);
        }
    }
  };
  // the warp's partial tile of chunk c: rows 8 q + g (l = lc + 2 g + q), complex columns
  // o * BT + 4 nt + t4
  auto contract = [&]() {
    if (!live) return;
    __syncwarp();
    if constexpr (MODE == 0) {   // the fold: even rows with Qn + Qs', odd rows with Qn - Qs'
      double acc[2][PNT][2];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int nt = 0; nt < PNT; ++nt) acc[q][nt][0] = acc[q][nt][1] = 0.;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const double a0 = lam[w][g][4 * ks + t4], a1 = lam[w][8 + g][4 * ks + t4];
#pragma unroll
        for (int nt = 0; nt < PNT; ++nt) {
          mma_f64(acc[0][nt], a0, bf[0][nt][ks]);
          mma_f64(acc[1][nt], a1, bf[NOP - 1][nt][ks]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < PNT; ++nt) {
        wp[w][g][4 * nt + t4] = double2{acc[0][nt][0], acc[0][nt][1]};
        wp[w][8 + g][4 * nt + t4] = double2{acc[1][nt][0], acc[1][nt][1]};
      }
    } else {
      // modes 1/2: both classes in one 16-row tile; k-step kk covers the tile columns
      // 16 kk + t4 + 4 i, of recursion kk / 2 when a thread runs both. One sum each
      // recursion, so that (-1)^l goes on the odd rows of output A's d_{m,+s} sum and of
      // output B's d_{m,-s} sum
      constexpr int NH = BOTH ? 2 : 1;
#pragma unroll
      for (int o = 0; o < NOUT; ++o) {
        double acc[NH][PNT][4];
#pragma unroll
        for (int h = 0; h < NH; ++h)
#pragma unroll
          for (int nt = 0; nt < PNT; ++nt) acc[h][nt][0] = acc[h][nt][1] = acc[h][nt][2] =
              acc[h][nt][3] = 0.;
#pragma unroll
        for (int kk = 0; kk < KS / 4; ++kk) {
          double a[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) a[i] = lam[w][(i & 1) * 8 + g][16 * kk + t4 + 4 * (i >> 1)];
#pragma unroll
          for (int nt = 0; nt < PNT; ++nt) {
            const double b[4] = {bf[o][nt][4 * kk], bf[o][nt][4 * kk + 1],
                                 bf[o][nt][4 * kk + 2], bf[o][nt][4 * kk + 3]};
            mma_f64_k16(acc[BOTH ? kk / 2 : 0][nt], a, b);
          }
        }
#pragma unroll
        for (int nt = 0; nt < PNT; ++nt) {
          double e0 = 0., e1 = 0., o0 = 0., o1 = 0.;
#pragma unroll
          for (int h = 0; h < NH; ++h) {
            const int half = BOTH ? h : wset;
            const double so = (o == 0) == (half == 0) ? 1. : -1.;
            e0 += acc[h][nt][0];
            e1 += acc[h][nt][1];
            o0 += so * acc[h][nt][2];
            o1 += so * acc[h][nt][3];
          }
          wp[w][g][o * BT + 4 * nt + t4] = double2{e0, e1};
          wp[w][8 + g][o * BT + 4 * nt + t4] = double2{o0, o1};
        }
      }
    }
  };

  stage(0, 0);
  if (nch > 1) stage(1, 1);
  __pipeline_wait_prior(0);
  __syncthreads();
  recur(0);
  for (int c = 0; c < nch; ++c) {
    const int cb = c & 1;
    contract();
    // publishes the warps' partials and the next chunk's table rows; every thread is past
    // its reads of this chunk's table rows, whose buffer is refilled next
    __pipeline_wait_prior(0);
    __syncthreads();
    if (c + 2 < nch) stage(c + 2, cb);
    if (tid < E) {                          // the block's sum, in warp order
      const int p = tid / (NOUT * BT), col = tid % (NOUT * BT);
      double2 s{0., 0.};
      for (int ww = 0; ww < NW; ++ww) {
        if (!live_warp(ww)) continue;
        const double2 v = wp[ww][p][col];
        s.x += v.x;
        s.y += v.y;
      }
      bp[cb][tid] = s;
    }
    cluster_arrive();
    if (c + 1 < nch) recur(c + 1);
    cluster_wait();
    // block r's share of the outputs: the cluster's sum in rank order, written once
    const int lc = lc0 + c * PLC;
    for (int e = rank + cs * tid; e < E; e += cs * NTH) {
      double2 s{0., 0.};
      for (int r = 0; r < cs; ++r) {
        const double2 v = *cl.map_shared_rank(&bp[cb][e], r);
        s.x += v.x;
        s.y += v.y;
      }
      const int p = e / (NOUT * BT), col = e % (NOUT * BT), o = col / BT, b = col % BT;
      const int l = lc + 2 * (p & 7) + (p >> 3);
      if (l < L && b0 + b < B)
        (o == 0 ? A : Bo)[((size_t)(b0 + b) * L + l) * M + mi] = C2{T(s.x), T(s.y)};
    }
  }
  // no block leaves while another may still read its partials
  cluster_arrive();
  cluster_wait();
}

// ------------------------------------------------- K1 at f64 on the FP64 MMA (pair modes)
// For one column m the pair synthesis is a matrix product over l:
//   F[j, map] = sum_l lambda_l(j) C[l, map],
// with lambda the recursion's effective values on the northern ring j. A block of SNW warps
// holds one m, one batch tile and SNW RPW consecutive northern rings; a warp owns its RPW
// rings for the whole l loop, so nothing is summed across warps or blocks and each output
// element is written once. A thread runs NCH recursion chains: mode 0 on one ring each (two
// rings on the tile of 4 maps, one on the tile of 8), modes 1/2 both recursions of one ring.
// Per chunk of PLC l steps:
//   * the block's threads stage the chunk's coefficient rows of the batch tile (rows in the
//     order of the parity of l, as the lambda tile's) and table rows into shared memory by
//     cp.async, two buffers in turn, one barrier a chunk;
//   * every thread writes its chains' PLC values into its warp's lambda tile (row p < 8
//     holds l = lc + 2p, row 8 + p holds l = lc + 2p + 1; rows past lmax are zero);
//   * the warp contracts the tile with the staged rows on the FP64 tensor cores into
//     accumulators that stay in registers across the chunks:
//       mode 0 (m8n8k4): rows = rings, the even and odd rows of l into separate sums E and
//         O; north E + O, south (-1)^m (E - O);
//       modes 1/2 (m16n8k16): rows = lambda of d_{m,-s} and (-1)^l lambda of d_{m,+s} on
//         each ring, columns = Cp and (-1)^l Cm (the sign on the odd rows of the B
//         operand): Fp north = d_{m,-s} x Cp, Fp south = (-1)^m (-1)^l d_{m,+s} x Cp, Fm
//         north = (-1)^l d_{m,+s} x (-1)^l Cm, Fm south = (-1)^m d_{m,-s} x (-1)^l Cm.
// The recursion runs step for step as rec_step rounds (never contracted into FMAs), the
// effective value by deff_mul, as in K2; the accumulate is f64 throughout (no TF32).
constexpr int SNW = 4;         // warps of a K1 MMA block

template <int MODE> __host__ __device__ constexpr int smma_nin() { return MODE == 1 ? 2 : 1; }
template <int MODE, int BT> __host__ __device__ constexpr int smma_nch() {
  return MODE == 0 ? (BT == 4 ? 2 : 1) : 2;
}
// rings of a warp
template <int MODE, int BT> __host__ __device__ constexpr int smma_rpw() {
  return MODE == 0 ? 32 * smma_nch<MODE, BT>() : 32;
}
// row strides (doubles) of the lambda tile and of the staged coefficient rows, padded so
// that the fragment loads of a half-warp hit distinct banks
template <int MODE, int BT> __host__ __device__ constexpr int smma_ls() {
  return 32 * smma_nch<MODE, BT>() + 4;
}
template <int MODE, int BT> __host__ __device__ constexpr int smma_cs() {
  return 2 * smma_nin<MODE>() * BT + 4;
}
// accumulator doubles of a thread: mode 0 two parity classes of RPW / 8 ring tiles, modes
// 1/2 four 16-row tiles; n-tiles of 8 columns (re, im of 4 maps) over the inputs
template <int MODE, int BT> __host__ __device__ constexpr int smma_acc() {
  return MODE == 0 ? 2 * (smma_rpw<MODE, BT>() / 8) * (BT / 4) * 2
                   : 4 * (smma_nin<MODE>() * BT / 4) * 4;
}
// blocks meant for an SM: 16 warps at <= 128 registers a thread, 8 where the accumulators
// alone take 128
template <int MODE, int BT> __host__ __device__ constexpr int smma_minb() {
  return (smma_acc<MODE, BT>() <= 32 ? 16 : 8) / SNW;
}
// dynamic shared memory of a block: the warps' lambda tiles, two buffers of staged
// coefficient rows and of table rows
template <int MODE, int BT> __host__ __device__ constexpr int smma_smem() {
  return SNW * PLC * smma_ls<MODE, BT>() * 8 + 2 * PLC * smma_cs<MODE, BT>() * 8 +
         2 * pair_recs<MODE>() * 3 * PLC * 8;
}

// (MINB = smma_minb<MODE, BT>(); the mode is the last template argument, as in the other
// kernels, which the profile readers rely on)
template <int BT, int MINB, int MODE>
__global__ void __launch_bounds__(SNW * 32, MINB)
synth_pair_mma_kernel(const double2* __restrict__ Cp, const double2* __restrict__ Cm,
                      double2* __restrict__ Fp, double2* __restrict__ Fm, Tables tm,
                      Tables tp, const double* __restrict__ x, int B, int L, int M, int R) {
  constexpr int NREC = pair_recs<MODE>(), NIN = smma_nin<MODE>();
  constexpr int NCH = smma_nch<MODE, BT>(), RPW = smma_rpw<MODE, BT>();
  constexpr int LS = smma_ls<MODE, BT>(), CS = smma_cs<MODE, BT>();
  constexpr int NTH = SNW * 32;
  constexpr int NT = NIN * BT / 4;            // n-tiles of 8 columns
  constexpr int NTI = BT / 4;                 // n-tiles of one input
  constexpr int NRT0 = MODE == 0 ? RPW / 8 : 1;   // mode 0: 8-ring tiles
  constexpr int NRT1 = MODE == 0 ? 1 : 4;         // modes 1/2: 16-row tiles
  extern __shared__ __align__(16) unsigned char smem[];
  double (*const lam)[PLC][LS] = reinterpret_cast<double (*)[PLC][LS]>(smem);
  double (*const cst)[PLC][CS] =
      reinterpret_cast<double (*)[PLC][CS]>(smem + SNW * PLC * LS * 8);
  double (*const tab)[NREC * 3][PLC] = reinterpret_cast<double (*)[NREC * 3][PLC]>(
      smem + SNW * PLC * LS * 8 + 2 * PLC * CS * 8);

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  // grid (ring slice, batch tile, m): m slowest, so the blocks in flight share one
  // column's coefficient and table rows through L2, and the low m, whose l loop is
  // longest, start first
  const int mi = blockIdx.z;                  // column: m - m0
  const int b0 = blockIdx.y * BT;
  const int nh = (R + 1) / 2, n_s = R - nh;
  const int j0 = (blockIdx.x * SNW + w) * RPW;    // the warp's first ring
  const bool live = j0 < nh;
  const int lc0 = loop_start(tm.l0, NREC == 2 ? tp.l0 : tm.l0, mi) & ~1;
  const int nch = lc0 < L ? (L - lc0 + PLC - 1) / PLC : 0;

  Rec st[NCH];
  double xr[NCH];
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {
    const int j = j0 + (MODE == 0 ? 32 * ch + lane : lane);
    const bool valid = j < nh;
    if (MODE != 0 && ch == 1)
      rec_init(st[ch], tp, valid ? j : 0, mi, M, valid);
    else
      rec_init(st[ch], tm, valid ? j : 0, mi, M, valid);
    xr[ch] = x[valid ? j : 0];
  }
  double ae[NRT0][NT][2], ao[NRT0][NT][2];    // mode 0: even and odd sums
  double acc[NRT1][NT][4];                    // modes 1/2
#pragma unroll
  for (int rt = 0; rt < NRT0; ++rt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) ae[rt][nt][i] = ao[rt][nt][i] = 0.;
#pragma unroll
  for (int rt = 0; rt < NRT1; ++rt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[rt][nt][i] = 0.;

  // rows lc .. lc + PLC - 1 of the batch tile's coefficients and of the tables into buffer
  // cb (rows past lmax and maps past B repeat the last: they meet zero lambda rows or feed
  // outputs that are not written)
  auto stage = [&](int c, int cb) {
    const int lc = lc0 + c * PLC;
    for (int e = tid; e < PLC * NIN * BT; e += NTH) {
      const int s = e / (NIN * BT), v = e % (NIN * BT), in = v / BT, b = v % BT;
      const int l = lc + s < L ? lc + s : L - 1;
      const int bb = b0 + b < B ? b0 + b : B - 1;
      __pipeline_memcpy_async(&cst[cb][(s & 1) * 8 + (s >> 1)][2 * v],
                              (in == 0 ? Cp : Cm) + ((size_t)bb * L + l) * M + mi, 16);
    }
    for (int e = tid; e < NREC * 3 * PLC; e += NTH) {
      const int k = e / PLC, s = e % PLC;
      const double* row = k == 0 ? tm.alpha : k == 1 ? tm.beta : k == 2 ? tm.gamma
                        : k == 3 ? tp.alpha : k == 4 ? tp.beta : tp.gamma;
      const int l = lc + s < L ? lc + s : L - 1;
      __pipeline_memcpy_async(&tab[cb][k][s], row + (size_t)l * M + mi, 8);
    }
    __pipeline_commit();
  };
  // the warp's lambda tile of chunk c. A column's recursions seed at l0 - 1, in chunk 0
  // (lc0 >= l0 - 2), so the later chunks step without the seed test
  auto put = [&](int ch, int lc, int s) {
    double v = deff_mul<double>(st[ch]);
    if (MODE != 0 && ch == 1 && (s & 1)) v = -v;          // (-1)^l d_{m,+s}
    lam[w][(s & 1) * 8 + (s >> 1)][32 * ch + lane] = lc + s < L ? v : 0.;
  };
  auto recur = [&](int c, int cb) {
    const int lc = lc0 + c * PLC;
    if (c == 0) {
#pragma unroll
      for (int s = 0; s < PLC; ++s)
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          const int h = (MODE != 0 && ch == 1) ? 3 : 0;
          put(ch, lc, s);
          rec_step(st[ch], lc + s, tab[cb][h][s], tab[cb][h + 1][s], tab[cb][h + 2][s],
                   xr[ch]);
        }
    } else {
#pragma unroll
      for (int s = 0; s < PLC; ++s)
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          const int h = (MODE != 0 && ch == 1) ? 3 : 0;
          put(ch, lc, s);
          rec_step_seeded(st[ch], tab[cb][h][s], tab[cb][h + 1][s], tab[cb][h + 2][s],
                          xr[ch]);
        }
    }
  };
  // the warp's tile times the staged rows, added to its accumulators; tiles with no ring
  // of the grid are skipped (the test is uniform over the warp)
  auto contract = [&](int cb) {
    if constexpr (MODE == 0) {
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const int row = 8 * q + 4 * ks + t4;
          double bf[NT];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) bf[nt] = cst[cb][row][8 * nt + g];
#pragma unroll
          for (int rt = 0; rt < NRT0; ++rt) {
            if (j0 + 8 * rt >= nh) continue;
            const double a = lam[w][row][8 * rt + g];
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              if (q == 0)
                mma_f64(ae[rt][nt], a, bf[nt]);
              else
                mma_f64(ao[rt][nt], a, bf[nt]);
            }
          }
        }
    } else {
      double bf[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const double v = cst[cb][t4 + 4 * i][8 * nt + g];
          bf[nt][i] = (nt >= NTI && i >= 2) ? -v : v;     // (-1)^l Cm: odd rows negated
        }
#pragma unroll
      for (int rt = 0; rt < NRT1; ++rt) {
        if (j0 + 16 * (rt & 1) >= nh) continue;
        double a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = lam[w][t4 + 4 * (i >> 1)][16 * rt + g + 8 * (i & 1)];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_f64_k16(acc[rt][nt], a, bf[nt]);
      }
    }
  };

  if (nch > 0) stage(0, 0);
  for (int c = 0; c < nch; ++c) {
    const int cb = c & 1;
    // one barrier a chunk: it publishes buffer cb, and every warp is past its reads of
    // the other buffer (the chunk before), which is refilled next
    __pipeline_wait_prior(0);
    __syncthreads();
    if (c + 1 < nch) stage(c + 1, cb ^ 1);
    if (live) {
      recur(c, cb);
      __syncwarp();
      contract(cb);
    }
  }
  if (!live) return;

  // each output element once: (re, im) of map 4 nt' + t4 on the fragment's ring
  const double sgn_m = (mi & 1) ? -1. : 1.;
  auto put_out = [&](double2* F, int b, int j, bool south, double re, double im) {
    if (j >= nh || b >= B) return;
    if (!south)
      F[((size_t)b * R + j) * M + mi] = double2{re, im};
    else if (j < n_s)
      F[((size_t)b * R + (R - 1 - j)) * M + mi] = double2{sgn_m * re, sgn_m * im};
  };
  if constexpr (MODE == 0) {
#pragma unroll
    for (int rt = 0; rt < NRT0; ++rt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int j = j0 + 8 * rt + g, b = b0 + 4 * nt + t4;
        put_out(Fp, b, j, false, ae[rt][nt][0] + ao[rt][nt][0], ae[rt][nt][1] + ao[rt][nt][1]);
        put_out(Fp, b, j, true, ae[rt][nt][0] - ao[rt][nt][0], ae[rt][nt][1] - ao[rt][nt][1]);
      }
  } else {
#pragma unroll
    for (int rt = 0; rt < NRT1; ++rt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int j = j0 + 16 * (rt & 1) + g + 8 * hh, b = b0 + 4 * (nt % NTI) + t4;
          const bool plus = rt >= 2, second = nt >= NTI;    // (-1)^l d_{m,+s} rows; Cm
          put_out(second ? Fm : Fp, b, j, plus != second, acc[rt][nt][2 * hh],
                  acc[rt][nt][2 * hh + 1]);
        }
  }
}

Tables make_tables(const void* a, const void* b, const void* g, const void* l0,
                   const void* sv, const void* sk) {
  return Tables{static_cast<const double*>(a), static_cast<const double*>(b),
                static_cast<const double*>(g), static_cast<const int*>(l0),
                static_cast<const double*>(sv), static_cast<const int*>(sk)};
}

// bytes of dynamic shared memory of a synthesis block: two buffers of LCS steps of the
// coefficient rows and the table rows
template <typename T, int BT, int MODE>
constexpr int synth_smem() {
  return 2 * LCS * 32 * ((MODE == 1 ? 2 : 1) * BT * (int)sizeof(typename C2t<T>::type) +
                         (MODE == 1 || MODE == 2 ? 6 : 3) * (int)sizeof(double));
}

template <typename T, int BT, int RPT, int NWS, int MINB, int MODE>
int launch_synth(const void* Cp, const void* Cm, void* Fp, void* Fm, Tables tm,
                 Tables tp, const void* x, int B, int L, int M, int R, int device,
                 void* stream) {
  using C2 = typename C2t<T>::type;
  constexpr int smem = synth_smem<T, BT, MODE>();
  static_assert(smem <= 232448, "a synthesis block's staging buffers exceed 227 KB");
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int nh = rec_rows<MODE>(R);
  const int btiles = (B + BT - 1) / BT, mtiles = (M + 31) / 32;
  if (btiles > 65535 || mtiles > 65535) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(synth_pair_kernel<T, BT, RPT, NWS, MINB, MODE>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 block(32, NWS);
  dim3 grid((nh + NWS * RPT - 1) / (NWS * RPT), btiles, mtiles);
  synth_pair_kernel<T, BT, RPT, NWS, MINB, MODE>
      <<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const C2*>(Cp), static_cast<const C2*>(Cm), static_cast<C2*>(Fp),
          static_cast<C2*>(Fm), tm, tp, static_cast<const double*>(x), B, L, M, R);
  return (int)cudaGetLastError();
}

// K4: the ring sum in `nseg` segments of a whole number of passes each; `ws` holds the
// nseg - 1 partials (B, L, M) of the segments after the first and may be null for one
// segment, when the output is written directly and no second kernel runs.
template <typename T, int BT, int RPT, int NWA, int MINB>
int launch_anal(const void* Q, void* A, void* ws, Tables t, const void* x, int B, int L, int M,
                int R, int nseg, int device, void* stream) {
  using C2 = typename C2t<T>::type;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int passes = (R + NWA * RPT - 1) / (NWA * RPT);
  const int btiles = (B + BT - 1) / BT, mtiles = (M + 31) / 32;
  if (nseg < 1 || nseg > passes || (nseg > 1 && ws == nullptr) || btiles > 65535 ||
      mtiles > 65535)
    return (int)cudaErrorInvalidValue;
  const int pps = (passes + nseg - 1) / nseg;
  if ((passes + pps - 1) / pps != nseg) return (int)cudaErrorInvalidValue;  // an empty segment
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 block(32, NWA);
  dim3 grid(nseg, btiles, mtiles);
  // two buffers each of per-warp partial sums and of staged table rows: up to 112 KB, so
  // dynamic shared memory
  const int smem = 2 * KS * BT * 2 * NWA * 32 * (int)sizeof(T) + 2 * 3 * LCH * 32 * (int)sizeof(double);
  e = cudaFuncSetAttribute(anal_pair_kernel<T, BT, RPT, NWA, MINB, PLAIN>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  anal_pair_kernel<T, BT, RPT, NWA, MINB, PLAIN><<<grid, block, smem, st>>>(
      static_cast<const C2*>(Q), static_cast<C2*>(A), static_cast<C2*>(ws), t,
      static_cast<const double*>(x), B, L, M, R, pps);
  e = cudaGetLastError();
  if (e != cudaSuccess || nseg == 1) return (int)e;
  const size_t total = (size_t)B * L * M;
  anal_pair_sum_kernel<T, PLAIN><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      static_cast<C2*>(A), static_cast<const C2*>(ws), t.l0, B, L, M, nseg - 1);
  return (int)cudaGetLastError();
}

// K2: one cluster of cs blocks of nw warps for each (batch tile of BT maps, m), block r on
// the northern rings r rs .. (r + 1) rs - 1. The shape comes from the wrapper's planner
// (legendre_kernels.plan_pair) and is checked here.
template <typename T, int NW, int BT, int MODE>
int launch_anal_pair_mma(const void* Qp, const void* Qm, void* A, void* Bo, Tables tm,
                         Tables tp, const void* x, int B, int L, int M, int R, int cs, int rs,
                         int device, void* stream) {
  using C2 = typename C2t<T>::type;
  constexpr int RMAX = pair_rings<MODE, BT>(NW);
  constexpr int smem = pair_smem<MODE, BT>(NW);
  static_assert(smem <= 232448, "a K2 block's shared memory exceeds 227 KB");
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int nh = (R + 1) / 2;
  const int btiles = (B + BT - 1) / BT;
  if (cs < 1 || cs > PMAXCS || rs < 1 || rs > RMAX || (long long)cs * rs < nh ||
      btiles > 65535 || M > 65535)
    return (int)cudaErrorInvalidValue;
  auto kern = anal_pair_mma_kernel<T, NW, BT, MODE>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if (cs > 8) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, btiles, M);
  cfg.blockDim = dim3(NW * 32, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int nclusters = 0;
  e = cudaOccupancyMaxActiveClusters(&nclusters, (void*)kern, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (nclusters < 1) return (int)cudaErrorLaunchOutOfResources;
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const C2*>(Qp), static_cast<const C2*>(Qm),
                         static_cast<C2*>(A), static_cast<C2*>(Bo), tm, tp,
                         static_cast<const double*>(x), B, L, M, R, rs);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_anal_pair_mma_mode(const void* Qp, const void* Qm, void* A, void* Bo, Tables tm,
                              Tables tp, const void* x, int B, int L, int M, int R, int mode,
                              int nw, int bt, int cs, int rs, int device, void* stream) {
#define PLK_K2(NW, BT, MODE)                                                               \
  if (nw == NW && bt == BT && mode == MODE)                                                \
    return launch_anal_pair_mma<T, NW, BT, MODE>(Qp, Qm, A, Bo, tm, tp, x, B, L, M, R, cs, \
                                                 rs, device, stream);
  PLK_K2(8, 4, 0) PLK_K2(16, 4, 0) PLK_K2(8, 8, 0) PLK_K2(16, 8, 0)
  PLK_K2(8, 4, 1) PLK_K2(16, 4, 1) PLK_K2(8, 8, 1) PLK_K2(16, 8, 1)
  PLK_K2(8, 4, 2) PLK_K2(16, 4, 2) PLK_K2(8, 8, 2) PLK_K2(16, 8, 2)
#undef PLK_K2
  return (int)cudaErrorInvalidValue;
}

// K1 at f64 on the FP64 MMA: nb blocks of SNW warps for each (batch tile of BT maps, m),
// block x on the northern rings from x SNW RPW. The shape comes from the wrapper's planner
// (legendre_kernels.synth_plan) and is checked here.
template <int BT, int MODE>
int launch_synth_pair_mma(const void* Cp, const void* Cm, void* Fp, void* Fm, Tables tm,
                          Tables tp, const void* x, int B, int L, int M, int R, int nb,
                          int device, void* stream) {
  constexpr int smem = smma_smem<MODE, BT>();
  static_assert(smem <= 232448, "a K1 MMA block's shared memory exceeds 227 KB");
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int nh = (R + 1) / 2;
  const int btiles = (B + BT - 1) / BT;
  if (nb < 1 || (long long)nb * SNW * smma_rpw<MODE, BT>() < nh || btiles > 65535 || M > 65535)
    return (int)cudaErrorInvalidValue;
  auto kern = synth_pair_mma_kernel<BT, smma_minb<MODE, BT>(), MODE>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(nb, btiles, M), SNW * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double2*>(Cp), static_cast<const double2*>(Cm),
      static_cast<double2*>(Fp), static_cast<double2*>(Fm), tm, tp,
      static_cast<const double*>(x), B, L, M, R);
  return (int)cudaGetLastError();
}

// the pair modes 0-2 of one data type and block shape, chosen at run time
template <typename T, int BT, int RPT, int NWS, int MINB>
int launch_synth_pair(const void* Cp, const void* Cm, void* Fp, void* Fm, Tables tm,
                      Tables tp, const void* x, int B, int L, int M, int R, int mode,
                      int device, void* stream) {
  switch (mode) {
    case 0: return launch_synth<T, BT, RPT, NWS, MINB, 0>(Cp, Cm, Fp, Fm, tm, tp, x, B, L, M, R, device, stream);
    case 1: return launch_synth<T, BT, RPT, NWS, MINB, 1>(Cp, Cm, Fp, Fm, tm, tp, x, B, L, M, R, device, stream);
    case 2: return launch_synth<T, BT, RPT, NWS, MINB, 2>(Cp, Cm, Fp, Fm, tm, tp, x, B, L, M, R, device, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Synthesis: batch tile, rings per thread, warps per block and blocks meant for an SM, of
// each kind of grid and data type, a narrow shape and a wide one; a call whose batch
// exceeds the narrow shape's batch tile runs the wide one (legendre_kernels.synth_shape
// mirrors the choice). Measured on the H100 (PERF.md): 8 warps with the most rings a
// thread that stay unspilled; f32 pair data at batch 8 is faster as one tile of 8 maps x
// 2 rings than as two of 4 x 3. f64 pair data run synth_pair_mma_kernel.
#define PLK_S_PAIR32 4, 3, 8, 1
#define PLK_S_PAIR32_WIDE 8, 2, 8, 1
#define PLK_S_PLAIN32 4, 6, 8, 1
#define PLK_S_PLAIN32_WIDE 8, 4, 8, 1
#define PLK_S_PLAIN64 4, 6, 8, 1
#define PLK_S_PLAIN64_WIDE 8, 3, 8, 1
constexpr int shape_code(int bt, int rpt, int nws, int minb) {
  return (bt << 24) | (rpt << 16) | (nws << 8) | minb;
}
constexpr int batch_tile(int bt, int, int, int) { return bt; }

// K4: batch tile, rings per thread, warps per block and blocks meant for an SM, by data
// type. Measured on the H100 (PERF.md): few warps with many rings a thread, at 210 to 250
// registers and one block an SM, beat more warps or more blocks with fewer rings, except
// for f32 data.
#define PLK_A_PLAIN32 4, 4, 16, 1
#define PLK_A_PLAIN64 2, 8, 8, 1
constexpr int tile_code(int bt, int rpt, int nwa, int) { return (bt << 16) | (nwa * rpt); }

}  // namespace

#define PLK_TABLE_ARGS                                                            \
  const void *am, const void *bm, const void *gm, const void *l0m, const void *svm, \
      const void *skm, const void *ap, const void *bp, const void *gp,           \
      const void *l0p, const void *svp, const void *skp
#define PLK_TABLES_M make_tables(am, bm, gm, l0m, svm, skm)
#define PLK_TABLES_P make_tables(ap, bp, gp, l0p, svp, skp)

extern "C" {

// (batch tile << 16) | rows of one ring pass of K4, for the wrapper's segment planner
int plk_anal_tile(int f64) { return f64 ? tile_code(PLK_A_PLAIN64) : tile_code(PLK_A_PLAIN32); }

// (batch tile << 24) | (rings per thread << 16) | (warps << 8) | blocks an SM of the
// synth_pair_kernel shape that a call of the kind and data type runs, narrow or wide, for
// the wrapper's check of its mirror; -1 for f64 pair data, which run synth_pair_mma_kernel
int plk_synth_shape(int plain, int f64, int wide) {
  if (plain)
    return f64 ? (wide ? shape_code(PLK_S_PLAIN64_WIDE) : shape_code(PLK_S_PLAIN64))
               : (wide ? shape_code(PLK_S_PLAIN32_WIDE) : shape_code(PLK_S_PLAIN32));
  return f64 ? -1 : (wide ? shape_code(PLK_S_PAIR32_WIDE) : shape_code(PLK_S_PAIR32));
}

// Pair modes on f32 data; the synthesis takes its wide shape above the narrow batch tile.
int plk_synth_pair_f32(const void* Cp, const void* Cm, void* Fp, void* Fm, PLK_TABLE_ARGS,
                       const void* x, int B, int L, int M, int R, int mode, int device,
                       void* stream) {
  if (B > batch_tile(PLK_S_PAIR32))
    return launch_synth_pair<float, PLK_S_PAIR32_WIDE>(Cp, Cm, Fp, Fm, PLK_TABLES_M,
                                                       PLK_TABLES_P, x, B, L, M, R, mode,
                                                       device, stream);
  return launch_synth_pair<float, PLK_S_PAIR32>(Cp, Cm, Fp, Fm, PLK_TABLES_M, PLK_TABLES_P, x,
                                                B, L, M, R, mode, device, stream);
}

// K1 on f64 data on the FP64 tensor cores: batch tiles of bt maps (4 or 8), nb blocks of
// SNW warps for each (batch tile, m).
int plk_synth_pair_mma_f64(const void* Cp, const void* Cm, void* Fp, void* Fm, PLK_TABLE_ARGS,
                           const void* x, int B, int L, int M, int R, int mode, int bt, int nb,
                           int device, void* stream) {
#define PLK_K1M(BT, MODE)                                                                  \
  if (bt == BT && mode == MODE)                                                            \
    return launch_synth_pair_mma<BT, MODE>(Cp, Cm, Fp, Fm, PLK_TABLES_M, PLK_TABLES_P, x, B, \
                                           L, M, R, nb, device, stream);
  PLK_K1M(4, 0) PLK_K1M(8, 0) PLK_K1M(4, 1) PLK_K1M(8, 1) PLK_K1M(4, 2) PLK_K1M(8, 2)
#undef PLK_K1M
  return (int)cudaErrorInvalidValue;
}

// K1 MMA's shape for the wrapper's mirror: (rings a warp << 16) | (warps << 8) | (blocks
// meant for an SM), and its bytes of dynamic shared memory a block
int plk_synth_pair_mma_shape(int mode, int bt) {
#define PLK_K1M(BT, MODE)                                                                   \
  if (bt == BT && mode == MODE)                                                             \
    return (smma_rpw<MODE, BT>() << 16) | (SNW << 8) | smma_minb<MODE, BT>();
  PLK_K1M(4, 0) PLK_K1M(8, 0) PLK_K1M(4, 1) PLK_K1M(8, 1) PLK_K1M(4, 2) PLK_K1M(8, 2)
#undef PLK_K1M
  return -1;
}

int plk_synth_pair_mma_smem(int mode, int bt) {
#define PLK_K1M(BT, MODE) \
  if (bt == BT && mode == MODE) return smma_smem<MODE, BT>();
  PLK_K1M(4, 0) PLK_K1M(8, 0) PLK_K1M(4, 1) PLK_K1M(8, 1) PLK_K1M(4, 2) PLK_K1M(8, 2)
#undef PLK_K1M
  return -1;
}

// K2 on the FP64 tensor cores: nw warps a block (8 or 16), batch tiles of bt maps (4 or
// 8), clusters of cs blocks of rs northern rings each.
int plk_anal_pair_f32(const void* Qp, const void* Qm, void* A, void* Bo, PLK_TABLE_ARGS,
                          const void* x, int B, int L, int M, int R, int mode, int nw, int bt,
                          int cs, int rs, int device, void* stream) {
  return launch_anal_pair_mma_mode<float>(Qp, Qm, A, Bo, PLK_TABLES_M, PLK_TABLES_P, x, B, L,
                                          M, R, mode, nw, bt, cs, rs, device, stream);
}

int plk_anal_pair_f64(const void* Qp, const void* Qm, void* A, void* Bo, PLK_TABLE_ARGS,
                          const void* x, int B, int L, int M, int R, int mode, int nw, int bt,
                          int cs, int rs, int device, void* stream) {
  return launch_anal_pair_mma_mode<double>(Qp, Qm, A, Bo, PLK_TABLES_M, PLK_TABLES_P, x, B, L,
                                           M, R, mode, nw, bt, cs, rs, device, stream);
}

// K2's fixed shape for the wrapper's mirror: (l steps a chunk << 16) | (most blocks a
// cluster << 8) | lanes of a warp
int plk_anal_pair_shape() { return (PLC << 16) | (PMAXCS << 8) | 32; }

// bytes of dynamic shared memory of a K2 block of nw warps on batch tiles of bt maps
int plk_anal_pair_smem(int mode, int nw, int bt) {
  if (bt == 4)
    return mode == 0 ? pair_smem<0, 4>(nw) : mode == 1 ? pair_smem<1, 4>(nw) : pair_smem<2, 4>(nw);
  return mode == 0 ? pair_smem<0, 8>(nw) : mode == 1 ? pair_smem<1, 8>(nw) : pair_smem<2, 8>(nw);
}

// Plain mode (K3/K4), one table set on all R rings.
#define PLK_PLAIN_TABLE_ARGS                                                       \
  const void *a, const void *b, const void *g, const void *l0, const void *sv,     \
      const void *sk

int plk_synth_f32(const void* C, void* F, PLK_PLAIN_TABLE_ARGS, const void* x, int B,
                  int L, int M, int R, int device, void* stream) {
  const Tables t = make_tables(a, b, g, l0, sv, sk);
  if (B > batch_tile(PLK_S_PLAIN32))
    return launch_synth<float, PLK_S_PLAIN32_WIDE, PLAIN>(C, nullptr, F, nullptr, t, t, x, B,
                                                          L, M, R, device, stream);
  return launch_synth<float, PLK_S_PLAIN32, PLAIN>(C, nullptr, F, nullptr, t, t, x, B, L, M,
                                                   R, device, stream);
}

int plk_synth_f64(const void* C, void* F, PLK_PLAIN_TABLE_ARGS, const void* x, int B,
                  int L, int M, int R, int device, void* stream) {
  const Tables t = make_tables(a, b, g, l0, sv, sk);
  if (B > batch_tile(PLK_S_PLAIN64))
    return launch_synth<double, PLK_S_PLAIN64_WIDE, PLAIN>(C, nullptr, F, nullptr, t, t, x, B,
                                                           L, M, R, device, stream);
  return launch_synth<double, PLK_S_PLAIN64, PLAIN>(C, nullptr, F, nullptr, t, t, x, B, L, M,
                                                    R, device, stream);
}

int plk_anal_f32(const void* Q, void* A, PLK_PLAIN_TABLE_ARGS, const void* x, int B,
                 int L, int M, int R, void* ws, int nseg, int device, void* stream) {
  return launch_anal<float, PLK_A_PLAIN32>(Q, A, ws, make_tables(a, b, g, l0, sv, sk), x, B,
                                           L, M, R, nseg, device, stream);
}

int plk_anal_f64(const void* Q, void* A, PLK_PLAIN_TABLE_ARGS, const void* x, int B,
                 int L, int M, int R, void* ws, int nseg, int device, void* stream) {
  return launch_anal<double, PLK_A_PLAIN64>(Q, A, ws, make_tables(a, b, g, l0, sv, sk), x, B,
                                            L, M, R, nseg, device, stream);
}

}  // extern "C"
