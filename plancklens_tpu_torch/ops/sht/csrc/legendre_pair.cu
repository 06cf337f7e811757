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
// recursion tables are re-read from L1/L2 at every l step, and the Fourier modes
// (analysis) stay in registers. At the main path's shapes (lmax 2048, 1537 northern
// rings, 2049 m, 8 maps) the pair modes' arithmetic is FP32-issue bound at ~6 ms; this
// first version takes 67 ms (K1) and 221 ms (K2) on an H100 80GB HBM3 at a 700 W power
// limit (spin 1, f32). With 128 registers a thread one 512-thread block fills an SM, so
// latency hiding and L1 load traffic bound K1; K2 runs only 65 x ceil(B/4) blocks on 132
// SMs (PERF.md). The plain mode at HEALPix shapes (8191 rings, batch <= 8) does one
// recursion for 4 maps, so the f64 recursion weighs as much as the f32 accumulate there;
// it takes four rings per thread (f32) where the pair modes take two, since it keeps a
// quarter of their accumulators, which halves K4's ring passes. K4 inherits K2's
// occupancy limit (65 blocks at batch <= 4); splitting the rings over blocks is left to
// the redesign of K2/K4 (ROADMAP).
//
// Precision. The recursion always runs in f64 (S = 256), also for f32 data: an f32
// recursion, as the TPU kernels ran it, loses the small angles near the poles (cos theta
// and 2 cos theta round to within 1e-7 of 1 and 2): at lmax 2048 on the 3073-ring QE grid
// its spin-1 synthesis is off by 5.4e-4 rms and 9.6e-3 of max against f64, and by up to
// 4e-2 on single polar rings. The H100 has native FP64. The accumulation runs in the data
// type. HEALPix's polar rings (theta = 4.0e-4 at nside 2048) seed far below f64's range;
// the exponent count k of the scaled recursion carries them, north and south alike.
//
// Why the first version is simple. Synthesis: one thread per (ring, m) keeps the
// recursion state and the outputs of a batch tile in registers; threads lie along m so
// that the reads of C[b, l, m..m+31] coalesce, and the ring-warps of a block share them
// through L1. Analysis: the sum over rings is a cross-thread reduction, made deterministic
// (no float atomics): the warps of a block reduce through shared memory in a fixed
// order, and each output element is owned by one thread of one block, which adds the
// partial sums of successive ring passes in order. Nothing is tiled over l and there is
// no tensor-core path yet; both are later work (PERF.md).
//
// Layouts (all contiguous, complex interleaved): C (B, L, M), F (B, R, M), Q (B, R, M),
// A (B, L, M); f64 tables alpha/beta/gamma (L, M), seed_v/seed_k (nh, M), l0 (M), x (nh)
// with L = lmax + 1, M = mmax + 1, R = nrings, nh = ceil(R / 2) in the pair modes and
// nh = R in the plain mode.
// mode 0: spin 0, one input (one recursion); mode 1: two inputs and two outputs;
// mode 2: spin != 0, one input (both recursions, one output); mode 3: plain, one input,
// one recursion over all rings.
//
// Plain C interface (ctypes); each entry point returns cudaGetLastError() of its launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 16;   // warps per block (rings of a block; lanes run along m)
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
template <typename T, int BT, int RPT, int MODE>
__global__ void __launch_bounds__(NW * 32, 1)
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
  const int nh = rec_rows<MODE>(R), n_s = R - nh;
  const int lane = threadIdx.x, w = threadIdx.y;
  const int m_first = blockIdx.x * 32;
  const int m = m_first + lane;
  const bool mvalid = m < M;
  const int b0 = blockIdx.z * BT;

  Rec rm[RPT], rp[RPT];
  double xr[RPT];
  int jr[RPT];
  C2 pn[RPT][BT], ps[RPT][BT], mn[RPT][BT], ms[RPT][BT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    jr[r] = blockIdx.y * (NW * RPT) + w + r * NW;
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

  const int lbeg = loop_start(tm.l0, TWO ? tp.l0 : tm.l0, m_first);
  for (int l = lbeg; l < L; ++l) {
    const size_t lm = (size_t)l * M + m;
    double am = 0., bm = 0., gm = 0., ap = 0., bp = 0., gp = 0.;
    C2 cp[BT], cm[BT];
    if (mvalid) {
      am = tm.alpha[lm]; bm = tm.beta[lm]; gm = tm.gamma[lm];
      if (TWO) { ap = tp.alpha[lm]; bp = tp.beta[lm]; gp = tp.gamma[lm]; }
    }
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      const bool v = mvalid && (b0 + b) < B;
      const size_t idx = ((size_t)(b0 + b) * L + l) * M + m;
      cp[b] = v ? Cp[idx] : C2{T(0), T(0)};
      if (HASM) cm[b] = v ? Cm[idx] : C2{T(0), T(0)};
    }
    const T sgn = (l & 1) ? T(-1) : T(1);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const T dm = deff<T>(rm[r]);
      const T dp = TWO ? deff<T>(rp[r]) : dm;
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
template <typename T, int BT, int RPT, int MODE>
__global__ void __launch_bounds__(NW * 32, 1)
anal_pair_kernel(const typename C2t<T>::type* __restrict__ Qp,
                 const typename C2t<T>::type* __restrict__ Qm,
                 typename C2t<T>::type* __restrict__ A,
                 typename C2t<T>::type* __restrict__ Bo,
                 Tables tm, Tables tp, const double* __restrict__ x,
                 int B, int L, int M, int R) {
  using C2 = typename C2t<T>::type;
  constexpr bool TWO = MODE == 1 || MODE == 2;
  constexpr bool HASM = MODE == 1;
  constexpr bool MIRROR = MODE != PLAIN;
  constexpr int NLEG = HASM ? 2 : 1;
  constexpr int NV = BT * NLEG;      // (map, leg) outputs of a thread per l
  static_assert(NV <= NW, "one reducing warp per output");
  __shared__ T red[NV][2][NW][32];

  const int nh = rec_rows<MODE>(R), n_s = R - nh;
  const int lane = threadIdx.x, w = threadIdx.y;
  const int m_first = blockIdx.x * 32;
  const int m = m_first + lane;
  const bool mvalid = m < M;
  const int b0 = blockIdx.y * BT;
  const T sgn_m = (m & 1) ? T(-1) : T(1);
  const int lbeg = loop_start(tm.l0, TWO ? tp.l0 : tm.l0, m_first);

  // the reducing thread (warp w < NV, lane) owns output (map b0 + w / NLEG, leg w % NLEG,
  // m): it writes rows below lbeg once and every row l >= lbeg in each ring pass
  const bool owner = w < NV;
  const int ob = w / NLEG, oleg = w % NLEG;
  const bool ovalid = owner && mvalid && (b0 + ob) < B;
  C2* const out = oleg == 0 ? A : Bo;
  if (ovalid) {
    for (int l = 0; l < lbeg; ++l)
      out[((size_t)(b0 + ob) * L + l) * M + m] = C2{T(0), T(0)};
  }

  for (int j0 = 0; j0 < nh; j0 += NW * RPT) {
    Rec rm[RPT], rp[RPT];
    double xr[RPT];
    C2 qpn[RPT][BT], qps[RPT][BT], qmn[RPT][BT], qms[RPT][BT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int jj = j0 + w + r * NW;
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
    const bool first = j0 == 0;

    for (int l = lbeg; l < L; ++l) {
      const size_t lm = (size_t)l * M + m;
      double am = 0., bm = 0., gm = 0., ap = 0., bp = 0., gp = 0.;
      if (mvalid) {
        am = tm.alpha[lm]; bm = tm.beta[lm]; gm = tm.gamma[lm];
        if (TWO) { ap = tp.alpha[lm]; bp = tp.beta[lm]; gp = tp.gamma[lm]; }
      }
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
        red[b * NLEG][0][w][lane] = va[b].x;
        red[b * NLEG][1][w][lane] = va[b].y;
        if (HASM) {
          red[b * NLEG + 1][0][w][lane] = vb[b].x;
          red[b * NLEG + 1][1][w][lane] = vb[b].y;
        }
      }
      __syncthreads();
      if (ovalid) {
        T sx = T(0), sy = T(0);
#pragma unroll
        for (int ww = 0; ww < NW; ++ww) {   // fixed order: deterministic
          sx += red[w][0][ww][lane];
          sy += red[w][1][ww][lane];
        }
        C2* o = out + ((size_t)(b0 + ob) * L + l) * M + m;
        if (first) {
          *o = C2{sx, sy};
        } else {
          C2 prev = *o;
          *o = C2{prev.x + sx, prev.y + sy};
        }
      }
      __syncthreads();
    }
  }
}

Tables make_tables(const void* a, const void* b, const void* g, const void* l0,
                   const void* sv, const void* sk) {
  return Tables{static_cast<const double*>(a), static_cast<const double*>(b),
                static_cast<const double*>(g), static_cast<const int*>(l0),
                static_cast<const double*>(sv), static_cast<const int*>(sk)};
}

template <typename T, int BT, int RPT, int MODE>
int launch_synth(const void* Cp, const void* Cm, void* Fp, void* Fm, Tables tm,
                 Tables tp, const void* x, int B, int L, int M, int R, int device,
                 void* stream) {
  using C2 = typename C2t<T>::type;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int nh = rec_rows<MODE>(R);
  dim3 block(32, NW);
  dim3 grid((M + 31) / 32, (nh + NW * RPT - 1) / (NW * RPT), (B + BT - 1) / BT);
  synth_pair_kernel<T, BT, RPT, MODE><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const C2*>(Cp), static_cast<const C2*>(Cm), static_cast<C2*>(Fp),
      static_cast<C2*>(Fm), tm, tp, static_cast<const double*>(x), B, L, M, R);
  return (int)cudaGetLastError();
}

template <typename T, int BT, int RPT, int MODE>
int launch_anal(const void* Qp, const void* Qm, void* A, void* Bo, Tables tm,
                Tables tp, const void* x, int B, int L, int M, int R, int device,
                void* stream) {
  using C2 = typename C2t<T>::type;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  dim3 block(32, NW);
  dim3 grid((M + 31) / 32, (B + BT - 1) / BT);
  anal_pair_kernel<T, BT, RPT, MODE><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const C2*>(Qp), static_cast<const C2*>(Qm), static_cast<C2*>(A),
      static_cast<C2*>(Bo), tm, tp, static_cast<const double*>(x), B, L, M, R);
  return (int)cudaGetLastError();
}

// the pair modes 0-2 of one direction and dtype, chosen at run time
template <typename T, int BT, int RPT, bool SYNTH>
int launch_pair(const void* in_p, const void* in_m, void* out_p, void* out_m, Tables tm,
                Tables tp, const void* x, int B, int L, int M, int R, int mode,
                int device, void* stream) {
  switch (mode) {
    case 0:
      return SYNTH ? launch_synth<T, BT, RPT, 0>(in_p, in_m, out_p, out_m, tm, tp, x, B, L, M, R, device, stream)
                   : launch_anal<T, BT, RPT, 0>(in_p, in_m, out_p, out_m, tm, tp, x, B, L, M, R, device, stream);
    case 1:
      return SYNTH ? launch_synth<T, BT, RPT, 1>(in_p, in_m, out_p, out_m, tm, tp, x, B, L, M, R, device, stream)
                   : launch_anal<T, BT, RPT, 1>(in_p, in_m, out_p, out_m, tm, tp, x, B, L, M, R, device, stream);
    case 2:
      return SYNTH ? launch_synth<T, BT, RPT, 2>(in_p, in_m, out_p, out_m, tm, tp, x, B, L, M, R, device, stream)
                   : launch_anal<T, BT, RPT, 2>(in_p, in_m, out_p, out_m, tm, tp, x, B, L, M, R, device, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

#define PLK_TABLE_ARGS                                                            \
  const void *am, const void *bm, const void *gm, const void *l0m, const void *svm, \
      const void *skm, const void *ap, const void *bp, const void *gp,           \
      const void *l0p, const void *svp, const void *skp
#define PLK_TABLES_M make_tables(am, bm, gm, l0m, svm, skm)
#define PLK_TABLES_P make_tables(ap, bp, gp, l0p, svp, skp)

extern "C" {

// Pair modes. f32 data: batch tile 4, two rings per thread; f64 data: batch tile 2, one
// ring.
int plk_synth_pair_f32(const void* Cp, const void* Cm, void* Fp, void* Fm, PLK_TABLE_ARGS,
                       const void* x, int B, int L, int M, int R, int mode, int device,
                       void* stream) {
  return launch_pair<float, 4, 2, true>(Cp, Cm, Fp, Fm, PLK_TABLES_M, PLK_TABLES_P, x, B, L,
                                        M, R, mode, device, stream);
}

int plk_synth_pair_f64(const void* Cp, const void* Cm, void* Fp, void* Fm, PLK_TABLE_ARGS,
                       const void* x, int B, int L, int M, int R, int mode, int device,
                       void* stream) {
  return launch_pair<double, 2, 1, true>(Cp, Cm, Fp, Fm, PLK_TABLES_M, PLK_TABLES_P, x, B,
                                         L, M, R, mode, device, stream);
}

int plk_anal_pair_f32(const void* Qp, const void* Qm, void* A, void* Bo, PLK_TABLE_ARGS,
                      const void* x, int B, int L, int M, int R, int mode, int device,
                      void* stream) {
  return launch_pair<float, 4, 2, false>(Qp, Qm, A, Bo, PLK_TABLES_M, PLK_TABLES_P, x, B, L,
                                         M, R, mode, device, stream);
}

int plk_anal_pair_f64(const void* Qp, const void* Qm, void* A, void* Bo, PLK_TABLE_ARGS,
                      const void* x, int B, int L, int M, int R, int mode, int device,
                      void* stream) {
  return launch_pair<double, 2, 1, false>(Qp, Qm, A, Bo, PLK_TABLES_M, PLK_TABLES_P, x, B,
                                          L, M, R, mode, device, stream);
}

// Plain mode (K3/K4), one table set on all R rings. f32 data: batch tile 4, four rings
// per thread; f64 data: batch tile 2, two rings.
#define PLK_PLAIN_TABLE_ARGS                                                       \
  const void *a, const void *b, const void *g, const void *l0, const void *sv,     \
      const void *sk

int plk_synth_f32(const void* C, void* F, PLK_PLAIN_TABLE_ARGS, const void* x, int B,
                  int L, int M, int R, int device, void* stream) {
  const Tables t = make_tables(a, b, g, l0, sv, sk);
  return launch_synth<float, 4, 4, PLAIN>(C, nullptr, F, nullptr, t, t, x, B, L, M, R,
                                          device, stream);
}

int plk_synth_f64(const void* C, void* F, PLK_PLAIN_TABLE_ARGS, const void* x, int B,
                  int L, int M, int R, int device, void* stream) {
  const Tables t = make_tables(a, b, g, l0, sv, sk);
  return launch_synth<double, 2, 2, PLAIN>(C, nullptr, F, nullptr, t, t, x, B, L, M, R,
                                           device, stream);
}

int plk_anal_f32(const void* Q, void* A, PLK_PLAIN_TABLE_ARGS, const void* x, int B,
                 int L, int M, int R, int device, void* stream) {
  const Tables t = make_tables(a, b, g, l0, sv, sk);
  return launch_anal<float, 4, 4, PLAIN>(Q, nullptr, A, nullptr, t, t, x, B, L, M, R,
                                         device, stream);
}

int plk_anal_f64(const void* Q, void* A, PLK_PLAIN_TABLE_ARGS, const void* x, int B,
                 int L, int M, int R, int device, void* stream) {
  const Tables t = make_tables(a, b, g, l0, sv, sk);
  return launch_anal<double, 2, 2, PLAIN>(Q, nullptr, A, nullptr, t, t, x, B, L, M, R,
                                          device, stream);
}

}  // extern "C"
