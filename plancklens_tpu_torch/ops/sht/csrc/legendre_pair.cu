// Spin-s Legendre transforms for Hopper (sm_90a): the fused north-south pair kernels and
// their plain (no-mirror) mode.
//
// Replaces the four TPU kernels of the JAX reference package
// (plancklens_tpu/ops/sht/pallas_kernel.py):
//   K1  _make_synth_pair_kernel + _synth_pair_pallas   -> synth_pair_kernel, modes 0-2
//   K2  _make_anal_pair_kernel  + _anal_pair_pallas    -> anal_pair_kernel,  modes 0-2
//   K3  _synth_kernel + _synth_pallas                  -> synth_pair_kernel, mode 3
//   K4  _anal_kernel  + _anal_pallas                   -> anal_pair_kernel,  mode 3
// All run the scaled three-term Wigner-d recursion over l. The pair modes run it on the
// northern half of a north-south symmetric ring grid, for d^l_{m,-s} and d^l_{m,+s} at
// once, and get the southern rings from the mirror identity
// d^l_{mn}(pi - t) = (-1)^{l+m} d^l_{m,-n}(t). The plain mode (3) runs one recursion,
// for d^l_{m,n}, over every ring of any grid (HEALPix, exact pixel-window node grids,
// asymmetric ring sets), with no mirror: north accumulators only, no southern rows.
//
// What bounds them on the H100: not HBM. Per (l, ring, m) the work is an f64 recursion
// step of ~10 operations per recursion and 2 multiply-adds per map in the data type
// (real/imag part), per hemisphere in the pair modes; the coefficients (synthesis) and
// recursion tables are read again at every l step, and the Fourier modes (analysis) stay
// in registers. At the main path's shapes (lmax 2048, 1537 northern rings, 2049 m, 8 maps)
// the pair modes' arithmetic is bound by FP32 throughput at ~6 ms, the plain mode at
// HEALPix shapes (8191 rings, 4 maps, f64) by FP64 at ~11 ms; the kernels take a few
// times that (PERF.md has the times).
//
// What bounds the synthesis (K1/K3), and what its design does about it. Each thread owns
// (ring, m) points and writes each output element once, so nothing is reduced across
// threads; a step is the recursion of RPT rings and the multiply-adds of BT maps, and its
// time is latency and instruction issue: one block of 8 warps fills an SM (150 to 250
// registers a thread), so the independent work inside a thread is what hides latency.
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
// What bounds the analysis (K2/K4), and what its design does about it. Each l step of a
// block is latency, not arithmetic: table rows to fetch, a chain of dependent f64
// operations per ring, a cross-warp sum through shared memory behind a barrier and an add
// into global memory, and registers allow one block an SM, so nothing else runs meanwhile.
// The time of a call is (steps of all blocks) x (latency of a step) / (SMs kept busy).
// Keeping the SMs busy, the grid:
//   * the ring sum is split: block (s, batch tile, m-tile) runs only the ring passes of
//     segment s, a whole number of passes (one pass = warps x rings per thread), so a
//     call is many short blocks in several waves instead of one wave of 65 x ceil(B/BT)
//     blocks as slow as its longest;
//   * the m-tile is the slowest grid dimension, so blocks start in order of m: the low-m
//     tiles, whose l loop is longest (it starts at l0(m) - 1), run first and the short
//     ones fill the tail;
//   * segment 0 adds into the outputs themselves, segment s > 0 into partial s - 1 of a
//     workspace (NS - 1, legs, B, L, M) that the wrapper allocates; anal_pair_sum_kernel
//     then adds the partials to the outputs in the order s = 1, 2, ... One segment
//     (small ring counts, or enough m and batch tiles to fill the card without a split)
//     needs no workspace and no second kernel. The segment count comes from the wrapper
//     (legendre_kernels.plan_segments: about 4 waves of blocks, under a workspace cap).
// Shortening the step, the block:
//   * many rings a thread and few warps (PLK_A_* below: 8 warps x 3 rings in the pair
//     modes, 8 x 8 on plain grids in f64, at 150 to 250 registers): the independent
//     recursions of a thread's rings overlap each other's latency, and fewer warps leave
//     fewer partial sums to exchange;
//   * the table rows of the next LCH l steps are staged into shared memory by cp.async
//     while the current LCH compute (all warps of a block need the same 3 or 6 rows of
//     256 bytes, a new set from L2 at every l), two buffers in turn;
//   * one barrier for KS l steps, not two for one: the warps leave their sums of a group
//     of KS steps in one of two shared-memory buffers used in turn, so the barrier that
//     publishes a group also frees the buffer of the group before; the KS * NV rows of a
//     group are shared out over all warps for the cross-warp sum;
//   * the running sum that a row is added to (every ring pass of a segment after its
//     first) is fetched from global memory before the group's arithmetic, not between
//     barriers.
// What is left is still latency: counting its operations, the arithmetic units could take
// a step in about a third of the time it takes (PERF.md).
//
// Precision. The recursion always runs in f64 (S = 256), also for f32 data: an f32
// recursion, as the TPU kernels ran it, loses the small angles near the poles (cos theta
// and 2 cos theta round to within 1e-7 of 1 and 2): at lmax 2048 on the 3073-ring QE grid
// its spin-1 synthesis is off by 5.4e-4 rms and 9.6e-3 of max against f64, and by up to
// 4e-2 on single polar rings. The H100 has native FP64. The accumulation runs in the data
// type. HEALPix's polar rings (theta = 4.0e-4 at nside 2048) seed far below f64's range;
// the exponent count k of the scaled recursion carries them, north and south alike.
//
// Layout of the work. Synthesis: one thread per (ring, m) of RPT rings keeps the recursion
// states and the outputs of a batch tile in registers; threads lie along m so that a row
// C[b, l, m..m+31] is one coalesced copy into shared memory, which all warps of the block
// read.
// Analysis: the sum over rings is a cross-thread reduction, made deterministic (no float
// atomics) at each of its three levels: the warps of a block reduce through shared memory
// in a fixed order; each element of an output or a partial is written by one block, which
// adds the sums of its segment's ring passes in order; and the partials are added in
// order of segment. Nothing is tiled over l and there is no tensor-core path;
// both are later work (PERF.md).
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
// makes (cudaGetLastError() after each, the second pass of the analysis included).
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// outputs of an analysis call: two legs in mode 1, else one
template <int MODE>
__host__ __device__ constexpr int anal_legs() {
  return MODE == 1 ? 2 : 1;
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

// ------------------------------------------------------------------- K2/K4 analysis
// A block is NWA warps (lanes along m, warps along rings) of RPT rings a thread, on a
// batch tile of BT maps; MINB blocks are meant to share an SM.
constexpr int LCH = 16;   // l steps of one staged chunk of table rows
constexpr int KS = 2;     // l steps between two barriers of a block (measured: 1 and 4 are slower)

template <typename T, int BT, int RPT, int NWA, int MINB, int MODE>
__global__ void __launch_bounds__(NWA * 32, MINB)
anal_pair_kernel(const typename C2t<T>::type* __restrict__ Qp,
                 const typename C2t<T>::type* __restrict__ Qm,
                 typename C2t<T>::type* __restrict__ A,
                 typename C2t<T>::type* __restrict__ Bo,
                 typename C2t<T>::type* __restrict__ ws,
                 Tables tm, Tables tp, const double* __restrict__ x,
                 int B, int L, int M, int R, int pps) {
  using C2 = typename C2t<T>::type;
  constexpr bool TWO = MODE == 1 || MODE == 2;
  constexpr bool HASM = MODE == 1;
  constexpr bool MIRROR = MODE != PLAIN;
  constexpr int NLEG = anal_legs<MODE>();
  constexpr int NV = BT * NLEG;      // (map, leg) outputs of a thread per l
  static_assert(NV <= NWA, "one warp per output for the rows below the loop");
  constexpr int PPW = (KS * NV + NWA - 1) / NWA;   // (step, output) rows a warp sums

  // two buffers of the warps' partial sums of KS successive l steps, used in turn
  static_assert(LCH % KS == 0, "whole groups of steps in a chunk of table rows");
  extern __shared__ __align__(16) unsigned char smem[];
  T (*const red)[KS][NV][2][NWA][32] = reinterpret_cast<T (*)[KS][NV][2][NWA][32]>(smem);
  // two buffers of the recursion tables' rows of LCH successive l, staged by cp.async:
  // the rows of the next chunk arrive while this one computes
  constexpr int NT = TWO ? 6 : 3;
  double (*const tab)[NT][LCH][32] =
      reinterpret_cast<double (*)[NT][LCH][32]>(smem + 2 * sizeof(T[KS][NV][2][NWA][32]));

  const int nh = rec_rows<MODE>(R), n_s = R - nh;
  const int lane = threadIdx.x, w = threadIdx.y;
  // grid (ring segment, batch tile, m-tile): the m-tile is slowest, so the tiles with the
  // longest l loop start first
  const int seg = blockIdx.x;
  const int m_first = blockIdx.z * 32;
  const int m = m_first + lane;
  const bool mvalid = m < M;
  const int m_in = mvalid ? m : M - 1;      // a column to read for lanes past mmax
  const int b0 = blockIdx.y * BT;
  const T sgn_m = (m & 1) ? T(-1) : T(1);
  const int lbeg = loop_start(tm.l0, TWO ? tp.l0 : tm.l0, m_first);

  // Output v < NV of a block is (map b0 + v / NLEG, leg v % NLEG): a row of the outputs
  // in segment 0, of partial seg - 1 of the workspace otherwise. Every row l >= lbeg is
  // written in each ring pass of the segment; segment 0 also writes the rows below lbeg,
  // once, and no partial holds them.
  auto out_row = [&](int v, int l) {
    C2* const base = seg == 0 ? (v % NLEG == 0 ? A : Bo)
                              : ws + ((size_t)(seg - 1) * NLEG + v % NLEG) * ((size_t)B * L * M);
    return base + ((size_t)(b0 + v / NLEG) * L + l) * M + m;
  };
  auto out_valid = [&](int v) { return mvalid && (b0 + v / NLEG) < B; };
  if (seg == 0 && w < NV && out_valid(w)) {
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
      if (TWO) {
        __pipeline_memcpy_async(&tab[cb][3][i][lane], tp.alpha + at, 8);
        __pipeline_memcpy_async(&tab[cb][4][i][lane], tp.beta + at, 8);
        __pipeline_memcpy_async(&tab[cb][5][i][lane], tp.gamma + at, 8);
      }
    }
    __pipeline_commit();
  };
  for (int j0 = j_begin; j0 < j_end; j0 += NWA * RPT) {
    Rec rm[RPT], rp[RPT];
    double xr[RPT];
    C2 qpn[RPT][BT], qps[RPT][BT], qmn[RPT][BT], qms[RPT][BT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int jj = j0 + w + r * NWA;
      const bool v = mvalid && jj < nh;
      const int j = jj < nh ? jj : 0;
      xr[r] = x[j];
      rec_init(rm[r], tm, j, m, M, v);
      if (TWO) rec_init(rp[r], tp, j, m, M, v);
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        const bool vb = v && (b0 + b) < B;
        const size_t base = (size_t)(b0 + b) * R;
        const C2 z{T(0), T(0)};
        qpn[r][b] = vb ? Qp[(base + j) * M + m] : z;
        if (MIRROR) {
          C2 s = (vb && j < n_s) ? Qp[(base + R - 1 - j) * M + m] : z;
          qps[r][b] = C2{sgn_m * s.x, sgn_m * s.y};
        }
        if (HASM) {
          qmn[r][b] = vb ? Qm[(base + j) * M + m] : z;
          C2 s = (vb && j < n_s) ? Qm[(base + R - 1 - j) * M + m] : z;
          qms[r][b] = C2{sgn_m * s.x, sgn_m * s.y};
        }
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
      // rings' sums of each step in shared memory; after the barrier the KS * NV (step,
      // output) rows of the group are shared out over the warps, PPW a warp, each summed
      // over the warps' partials in a fixed order and added to the running sum in global
      // memory, which was fetched before the group's arithmetic to hide its latency.
      for (int ls = lc; ls < lend; ls += KS, ++group) {
        T (&rd)[KS][NV][2][NWA][32] = red[group & 1];
        C2 prev[PPW];
#pragma unroll
        for (int i = 0; i < PPW; ++i) {
          const int p = w + i * NWA, kk = p / NV, v = p % NV;
          prev[i] = C2{T(0), T(0)};
          if (!first && p < KS * NV && ls + kk < lend && out_valid(v))
            prev[i] = *out_row(v, ls + kk);
        }
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const int l = ls + kk;
          if (l >= lend) break;
          const double am = tab[cb][0][l - lc][lane], bm = tab[cb][1][l - lc][lane],
                       gm = tab[cb][2][l - lc][lane];
          const double ap = TWO ? tab[cb][3][l - lc][lane] : 0.,
                       bp = TWO ? tab[cb][4][l - lc][lane] : 0.,
                       gp = TWO ? tab[cb][5][l - lc][lane] : 0.;
          const T sgn = (l & 1) ? T(-1) : T(1);
          C2 va[BT], vb[BT];
#pragma unroll
          for (int b = 0; b < BT; ++b) va[b] = vb[b] = C2{T(0), T(0)};
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            const T dm = deff<T>(rm[r]);
            const T dp = TWO ? deff<T>(rp[r]) : dm;
            const T dps = sgn * dp, dms = sgn * dm;
#pragma unroll
            for (int b = 0; b < BT; ++b) {
              if (MIRROR) {
                va[b].x += qpn[r][b].x * dm + qps[r][b].x * dps;
                va[b].y += qpn[r][b].y * dm + qps[r][b].y * dps;
              } else {
                va[b].x += qpn[r][b].x * dm;
                va[b].y += qpn[r][b].y * dm;
              }
              if (HASM) {
                vb[b].x += qmn[r][b].x * dp + qms[r][b].x * dms;
                vb[b].y += qmn[r][b].y * dp + qms[r][b].y * dms;
              }
            }
            rec_step(rm[r], l, am, bm, gm, xr[r]);
            if (TWO) rec_step(rp[r], l, ap, bp, gp, xr[r]);
          }
#pragma unroll
          for (int b = 0; b < BT; ++b) {
            rd[kk][b * NLEG][0][w][lane] = va[b].x;
            rd[kk][b * NLEG][1][w][lane] = va[b].y;
            if (HASM) {
              rd[kk][b * NLEG + 1][0][w][lane] = vb[b].x;
              rd[kk][b * NLEG + 1][1][w][lane] = vb[b].y;
            }
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
          const int p = w + i * NWA, kk = p / NV, v = p % NV;
          if (p < KS * NV && ls + kk < lend && out_valid(v)) {
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

// second pass of a split ring sum: out += partial 0 + partial 1 + ... in this order, for
// the rows l >= lbeg of each m-tile (segment 0 wrote the rows below, the partials do not
// hold them). One thread per output element; MODE as in the analysis kernel.
template <typename T, int MODE>
__global__ void __launch_bounds__(256)
anal_pair_sum_kernel(typename C2t<T>::type* __restrict__ A,
                     typename C2t<T>::type* __restrict__ Bo,
                     const typename C2t<T>::type* __restrict__ ws,
                     const int* __restrict__ l0m, const int* __restrict__ l0p,
                     int B, int L, int M, int npart) {
  using C2 = typename C2t<T>::type;
  constexpr int NLEG = anal_legs<MODE>();
  const size_t n = (size_t)B * L * M;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= NLEG * n) return;
  const int leg = (int)(idx / n);
  const size_t e = idx - leg * n;
  const int m = (int)(e % M), l = (int)((e / M) % L);
  if (l < loop_start(l0m, l0p, m & ~31)) return;
  C2* const o = (leg == 0 ? A : Bo) + e;
  C2 acc = *o;
  for (int s = 0; s < npart; ++s) {           // fixed order: deterministic
    const C2 p = ws[((size_t)s * NLEG + leg) * n + e];
    acc.x += p.x;
    acc.y += p.y;
  }
  *o = acc;
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

// The ring sum in `nseg` segments of a whole number of passes each; `ws` holds the
// nseg - 1 partials (legs, B, L, M) of the segments after the first and may be null for
// one segment, when the outputs are written directly and no second kernel runs.
template <typename T, int BT, int RPT, int NWA, int MINB, int MODE>
int launch_anal(const void* Qp, const void* Qm, void* A, void* Bo, void* ws, Tables tm,
                Tables tp, const void* x, int B, int L, int M, int R, int nseg, int device,
                void* stream) {
  using C2 = typename C2t<T>::type;
  constexpr bool TWO = MODE == 1 || MODE == 2;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int nh = rec_rows<MODE>(R);
  const int passes = (nh + NWA * RPT - 1) / (NWA * RPT);
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
  const int smem = 2 * KS * BT * anal_legs<MODE>() * 2 * NWA * 32 * (int)sizeof(T) +
                   2 * (TWO ? 6 : 3) * LCH * 32 * (int)sizeof(double);
  e = cudaFuncSetAttribute(anal_pair_kernel<T, BT, RPT, NWA, MINB, MODE>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  anal_pair_kernel<T, BT, RPT, NWA, MINB, MODE><<<grid, block, smem, st>>>(
      static_cast<const C2*>(Qp), static_cast<const C2*>(Qm), static_cast<C2*>(A),
      static_cast<C2*>(Bo), static_cast<C2*>(ws), tm, tp, static_cast<const double*>(x), B,
      L, M, R, pps);
  e = cudaGetLastError();
  if (e != cudaSuccess || nseg == 1) return (int)e;
  const size_t total = (size_t)anal_legs<MODE>() * B * L * M;
  anal_pair_sum_kernel<T, MODE><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      static_cast<C2*>(A), static_cast<C2*>(Bo), static_cast<const C2*>(ws), tm.l0,
      TWO ? tp.l0 : tm.l0, B, L, M, nseg - 1);
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

template <typename T, int BT, int RPT, int NWA, int MINB>
int launch_anal_pair(const void* Qp, const void* Qm, void* A, void* Bo, void* ws, Tables tm,
                     Tables tp, const void* x, int B, int L, int M, int R, int mode,
                     int nseg, int device, void* stream) {
  switch (mode) {
    case 0: return launch_anal<T, BT, RPT, NWA, MINB, 0>(Qp, Qm, A, Bo, ws, tm, tp, x, B, L, M, R, nseg, device, stream);
    case 1: return launch_anal<T, BT, RPT, NWA, MINB, 1>(Qp, Qm, A, Bo, ws, tm, tp, x, B, L, M, R, nseg, device, stream);
    case 2: return launch_anal<T, BT, RPT, NWA, MINB, 2>(Qp, Qm, A, Bo, ws, tm, tp, x, B, L, M, R, nseg, device, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Synthesis: batch tile, rings per thread, warps per block and blocks meant for an SM, of
// each kind of grid and data type, a narrow shape and a wide one; a call whose batch
// exceeds the narrow shape's batch tile runs the wide one (legendre_kernels.synth_shape
// mirrors the choice). Measured on the H100 (PERF.md): 8 warps with the most rings a
// thread that stay unspilled; f32 pair data at batch 8 is faster as one tile of 8 maps x
// 2 rings than as two of 4 x 3; f64 pair data keeps one ring a thread (two spill).
#define PLK_S_PAIR32 4, 3, 8, 1
#define PLK_S_PAIR32_WIDE 8, 2, 8, 1
#define PLK_S_PAIR64 4, 1, 8, 1
#define PLK_S_PAIR64_WIDE 4, 1, 8, 1
#define PLK_S_PLAIN32 4, 6, 8, 1
#define PLK_S_PLAIN32_WIDE 8, 4, 8, 1
#define PLK_S_PLAIN64 4, 6, 8, 1
#define PLK_S_PLAIN64_WIDE 8, 3, 8, 1
constexpr int shape_code(int bt, int rpt, int nws, int minb) {
  return (bt << 24) | (rpt << 16) | (nws << 8) | minb;
}
constexpr int batch_tile(int bt, int, int, int) { return bt; }

// Analysis: batch tile, rings per thread, warps per block and blocks meant for an SM, of
// each kind of grid and data type. Measured on the H100 (PERF.md): few warps with many
// rings a thread, at 210 to 250 registers and one block an SM, beat more warps or more
// blocks with fewer rings, except for f32 data on plain grids.
#define PLK_A_PAIR32 4, 3, 8, 1
#define PLK_A_PAIR64 2, 3, 8, 1
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

// (batch tile << 16) | rows of one ring pass of the analysis kernels, for the wrapper's
// segment planner
int plk_anal_tile(int plain, int f64) {
  return plain ? (f64 ? tile_code(PLK_A_PLAIN64) : tile_code(PLK_A_PLAIN32))
               : (f64 ? tile_code(PLK_A_PAIR64) : tile_code(PLK_A_PAIR32));
}

// (batch tile << 24) | (rings per thread << 16) | (warps << 8) | blocks an SM of the
// synthesis kernel that a call of the kind and data type runs, narrow or wide, for the
// wrapper's check of its mirror
int plk_synth_shape(int plain, int f64, int wide) {
  if (plain)
    return f64 ? (wide ? shape_code(PLK_S_PLAIN64_WIDE) : shape_code(PLK_S_PLAIN64))
               : (wide ? shape_code(PLK_S_PLAIN32_WIDE) : shape_code(PLK_S_PLAIN32));
  return f64 ? (wide ? shape_code(PLK_S_PAIR64_WIDE) : shape_code(PLK_S_PAIR64))
             : (wide ? shape_code(PLK_S_PAIR32_WIDE) : shape_code(PLK_S_PAIR32));
}

// Pair modes; the synthesis takes its wide shape above the narrow batch tile.
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

int plk_synth_pair_f64(const void* Cp, const void* Cm, void* Fp, void* Fm, PLK_TABLE_ARGS,
                       const void* x, int B, int L, int M, int R, int mode, int device,
                       void* stream) {
  if (B > batch_tile(PLK_S_PAIR64))
    return launch_synth_pair<double, PLK_S_PAIR64_WIDE>(Cp, Cm, Fp, Fm, PLK_TABLES_M,
                                                        PLK_TABLES_P, x, B, L, M, R, mode,
                                                        device, stream);
  return launch_synth_pair<double, PLK_S_PAIR64>(Cp, Cm, Fp, Fm, PLK_TABLES_M, PLK_TABLES_P,
                                                 x, B, L, M, R, mode, device, stream);
}

// Analysis: the ring sum in nseg segments, ws the workspace of nseg - 1 partials.
int plk_anal_pair_f32(const void* Qp, const void* Qm, void* A, void* Bo, PLK_TABLE_ARGS,
                      const void* x, int B, int L, int M, int R, int mode, void* ws,
                      int nseg, int device, void* stream) {
  return launch_anal_pair<float, PLK_A_PAIR32>(Qp, Qm, A, Bo, ws, PLK_TABLES_M, PLK_TABLES_P,
                                               x, B, L, M, R, mode, nseg, device, stream);
}

int plk_anal_pair_f64(const void* Qp, const void* Qm, void* A, void* Bo, PLK_TABLE_ARGS,
                      const void* x, int B, int L, int M, int R, int mode, void* ws,
                      int nseg, int device, void* stream) {
  return launch_anal_pair<double, PLK_A_PAIR64>(Qp, Qm, A, Bo, ws, PLK_TABLES_M,
                                                PLK_TABLES_P, x, B, L, M, R, mode, nseg,
                                                device, stream);
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
  const Tables t = make_tables(a, b, g, l0, sv, sk);
  return launch_anal<float, PLK_A_PLAIN32, PLAIN>(Q, nullptr, A, nullptr, ws, t, t, x, B, L,
                                                  M, R, nseg, device, stream);
}

int plk_anal_f64(const void* Q, void* A, PLK_PLAIN_TABLE_ARGS, const void* x, int B,
                 int L, int M, int R, void* ws, int nseg, int device, void* stream) {
  const Tables t = make_tables(a, b, g, l0, sv, sk);
  return launch_anal<double, PLK_A_PLAIN64, PLAIN>(Q, nullptr, A, nullptr, ws, t, t, x, B, L,
                                                   M, R, nseg, device, stream);
}

}  // extern "C"
