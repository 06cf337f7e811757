// plkcore: native host-side numerical kernels (the PyTorch port's copy of
// plancklens_tpu/native/plkcore.cc, opt-in behind PLK_NATIVE=1).
//
// C++/OpenMP equivalents of the reference's in-repo Fortran layer
// (reference: plancklens/wigners/wigners.f90, plancklens/n1/n1f.f90):
//   - Gauss-Legendre nodes/weights by vectorised Newton iteration (get_xgwg role)
//   - Wigner small-d synthesis/analysis via scaled Jacobi three-term recursions
//     (wignerpos / wignercoeff roles)
//
// These serve the host-side precompute paths (quadrature grids, the Wigner transforms of
// 1-D host operands). Exposed with a plain C ABI for ctypes binding; built at first use by
// plancklens_tpu_torch/native/__init__.py.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// P_n and P_n' at a block of nodes by upward recursion, l outer / node inner:
// the inner loop is a contiguous fused multiply-add stream the compiler
// vectorizes (the per-node scalar form costs ~40x more wall for the same flops).
inline void legendre_pn_block(int n, int m, const double* x, double* pn, double* dpn,
                              double* scratch) {
    double* p0 = scratch;        // P_{l-1}
    double* p1 = pn;             // P_l  (ends at l = n, in place)
    for (int k = 0; k < m; ++k) { p0[k] = 1.0; p1[k] = x[k]; }
    for (int l = 2; l <= n; ++l) {
        const double a = (2.0 * l - 1.0) / l, b = (l - 1.0) / l;
        for (int k = 0; k < m; ++k) {
            const double p2 = a * x[k] * p1[k] - b * p0[k];
            p0[k] = p1[k];
            p1[k] = p2;
        }
    }
    for (int k = 0; k < m; ++k)
        dpn[k] = n * (x[k] * p1[k] - p0[k]) / (x[k] * x[k] - 1.0);
}

}  // namespace

extern "C" {

// n-point Gauss-Legendre rule on (-1, 1); x ascending, w the weights.
// Vectorised Newton from the Tricomi initial guess on the x > 0 half (mirror
// symmetry halves the work); OpenMP splits the node block across threads.
void plk_gauleg(int n, double* x, double* w) {
    const int m = (n + 1) / 2;  // nodes with x >= 0, largest x first
    std::vector<double> xk(m), pn(m), dpn(m), scratch(m);
#pragma omp parallel
    {
#ifdef _OPENMP
        const int nt = omp_get_num_threads(), t = omp_get_thread_num();
#else
        const int nt = 1, t = 0;
#endif
        const int k0 = (int)((long long)m * t / nt);
        const int k1 = (int)((long long)m * (t + 1) / nt);
        const int mb = k1 - k0;
        if (mb > 0) {
            for (int k = k0; k < k1; ++k)
                xk[k] = std::cos(M_PI * (k + 0.75) / (n + 0.5));
            for (int it = 0; it < 100; ++it) {
                legendre_pn_block(n, mb, &xk[k0], &pn[k0], &dpn[k0], &scratch[k0]);
                double dmax = 0.0;
                for (int k = k0; k < k1; ++k) {
                    const double dx = pn[k] / dpn[k];
                    xk[k] -= dx;
                    dmax = std::max(dmax, std::abs(dx));
                }
                if (dmax < 1e-15) break;
            }
            legendre_pn_block(n, mb, &xk[k0], &pn[k0], &dpn[k0], &scratch[k0]);
        }
    }
    for (int k = 0; k < m; ++k) {
        double xv = xk[k];
        if (2 * k == n - 1) xv = 0.0;  // odd n: the middle root is exactly 0
        const double wv = 2.0 / ((1.0 - xv * xv) * dpn[k] * dpn[k]);
        x[n - 1 - k] = xv;   // positive half, ascending output
        w[n - 1 - k] = wv;
        x[k] = -xv;          // mirrored negative half
        w[k] = wv;
    }
}

// Wigner small-d synthesis: xi_i = sum_l cl_l (2l+1)/(4pi) d^l_{s1 s2}(x_i).
// Scaled-Jacobi three-term recursion per node, vectorised over nodes with OpenMP.
void plk_wignerpos(int nx, int lmax, const double* cl, const double* x,
                   int s1, int s2, double* xi) {
    const int a = std::abs(s1 - s2);
    const int b = std::abs(s1 + s2);
    const int l0 = (a + b) / 2;
    const double sgn = (s1 > s2 && ((s1 - s2) % 2)) ? -1.0 : 1.0;
    if (l0 > lmax) {
        std::memset(xi, 0, sizeof(double) * nx);
        return;
    }
    const int K = lmax - l0;
    // scaled-Jacobi recursion coefficients (match ops/wigner.py::_jacobi_rec_coeffs)
    std::vector<double> At(K > 1 ? K - 1 : 0), Bt(At.size()), Ct(At.size());
    {
        std::vector<double> rho(K + 2, 1.0);
        for (int k = 1; k <= K + 1; ++k)
            rho[k] = std::sqrt((double)k * (k + a + b) / ((double)(k + a) * (k + b)));
        for (int k = 1; k < K; ++k) {
            double tkab = 2.0 * k + a + b;
            double A = (tkab + 1.0) * (tkab + 2.0) / (2.0 * (k + 1.0) * (k + a + b + 1.0));
            double B = (tkab + 1.0) * ((double)a * a - (double)b * b)
                       / (2.0 * (k + 1.0) * (k + a + b + 1.0) * tkab);
            double C = (k + (double)a) * (k + (double)b) * (tkab + 2.0)
                       / ((k + 1.0) * (k + a + b + 1.0) * tkab);
            At[k - 1] = A * rho[k + 1];
            Bt[k - 1] = B * rho[k + 1];
            Ct[k - 1] = C * rho[k + 1] * rho[k];
        }
    }
    double lnr0 = 0.5 * (std::lgamma(a + b + 1.0) - std::lgamma(a + 1.0) - std::lgamma(b + 1.0));
    std::vector<double> clm(K + 1);
    for (int k = 0; k <= K; ++k)
        clm[k] = cl[l0 + k] * (2.0 * (l0 + k) + 1.0) / (4.0 * M_PI);

#pragma omp parallel for schedule(static)
    for (int i = 0; i < nx; ++i) {
        const double xv = x[i];
        // guard the 0 * log(0) = NaN at the poles x = +-1 (ops/wigner.py:110-114)
        double lnpref = lnr0;
        if (a > 0) lnpref += a * std::log(std::sqrt(0.5 * (1.0 - xv)));
        if (b > 0) lnpref += b * std::log(std::sqrt(0.5 * (1.0 + xv)));
        const double pref = sgn * std::exp(lnpref);
        double p0 = pref;
        double acc = clm[0] * p0;
        if (K >= 1) {
            double r1_over_r0 = std::sqrt((1.0 + a + b) / ((1.0 + a) * (1.0 + b)));
            double p1 = r1_over_r0 * ((a + 1.0) + 0.5 * (a + b + 2.0) * (xv - 1.0)) * pref;
            acc += clm[1] * p1;
            for (int k = 1; k < K; ++k) {
                double p2 = (At[k - 1] * xv + Bt[k - 1]) * p1 - Ct[k - 1] * p0;
                acc += clm[k + 1] * p2;
                p0 = p1;
                p1 = p2;
            }
        }
        xi[i] = acc;
    }
}

// Wigner small-d analysis: cl_l = 2 pi sum_i xi_i d^l_{s1 s2}(x_i), l = 0..lmax.
void plk_wignercoeff(int nx, int lmax, const double* xi, const double* x,
                     int s1, int s2, double* cl) {
    const int a = std::abs(s1 - s2);
    const int b = std::abs(s1 + s2);
    const int l0 = (a + b) / 2;
    const double sgn = (s1 > s2 && ((s1 - s2) % 2)) ? -1.0 : 1.0;
    std::memset(cl, 0, sizeof(double) * (lmax + 1));
    if (l0 > lmax) return;
    const int K = lmax - l0;
    std::vector<double> At(K > 1 ? K - 1 : 0), Bt(At.size()), Ct(At.size());
    {
        std::vector<double> rho(K + 2, 1.0);
        for (int k = 1; k <= K + 1; ++k)
            rho[k] = std::sqrt((double)k * (k + a + b) / ((double)(k + a) * (k + b)));
        for (int k = 1; k < K; ++k) {
            double tkab = 2.0 * k + a + b;
            double A = (tkab + 1.0) * (tkab + 2.0) / (2.0 * (k + 1.0) * (k + a + b + 1.0));
            double B = (tkab + 1.0) * ((double)a * a - (double)b * b)
                       / (2.0 * (k + 1.0) * (k + a + b + 1.0) * tkab);
            double C = (k + (double)a) * (k + (double)b) * (tkab + 2.0)
                       / ((k + 1.0) * (k + a + b + 1.0) * tkab);
            At[k - 1] = A * rho[k + 1];
            Bt[k - 1] = B * rho[k + 1];
            Ct[k - 1] = C * rho[k + 1] * rho[k];
        }
    }
    double lnr0 = 0.5 * (std::lgamma(a + b + 1.0) - std::lgamma(a + 1.0) - std::lgamma(b + 1.0));

#ifdef _OPENMP
    int nthreads = omp_get_max_threads();
#else
    int nthreads = 1;
#endif
    std::vector<double> partial((size_t)nthreads * (K + 1), 0.0);
#pragma omp parallel
    {
#ifdef _OPENMP
        double* acc = &partial[(size_t)omp_get_thread_num() * (K + 1)];
#else
        double* acc = partial.data();
#endif
#pragma omp for schedule(static)
        for (int i = 0; i < nx; ++i) {
            const double xv = x[i];
            const double w = 2.0 * M_PI * xi[i];
            // guard the 0 * log(0) = NaN at the poles x = +-1 (ops/wigner.py:110-114)
            double lnpref = lnr0;
            if (a > 0) lnpref += a * std::log(std::sqrt(0.5 * (1.0 - xv)));
            if (b > 0) lnpref += b * std::log(std::sqrt(0.5 * (1.0 + xv)));
            const double pref = sgn * std::exp(lnpref);
            double p0 = pref;
            acc[0] += w * p0;
            if (K >= 1) {
                double r1_over_r0 = std::sqrt((1.0 + a + b) / ((1.0 + a) * (1.0 + b)));
                double p1 = r1_over_r0 * ((a + 1.0) + 0.5 * (a + b + 2.0) * (xv - 1.0)) * pref;
                acc[1] += w * p1;
                for (int k = 1; k < K; ++k) {
                    double p2 = (At[k - 1] * xv + Bt[k - 1]) * p1 - Ct[k - 1] * p0;
                    acc[k + 1] += w * p2;
                    p0 = p1;
                    p1 = p2;
                }
            }
        }
    }
    for (int t = 0; t < nthreads; ++t)
        for (int k = 0; k <= K; ++k)
            cl[l0 + k] += partial[(size_t)t * (K + 1) + k];
}

int plk_version() { return 1; }

}  // extern "C"
