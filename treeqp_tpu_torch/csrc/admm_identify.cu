// Scaled ADMM active-set identification of all general stage QPs, the
// whole iteration loop in one launch, one thread per node.
//
// Replaces the Pallas kernel admm_identify of treeqp_tpu/ops/qpgen_lanes.py
// (reached through the cold start of tdunes._qpgen_batch; it seeds the
// working set of the qpOASES stage-QP plugin's role,
// dual_Newton_tree_qpoases.c). Per node n, with G [ng, nz], L [nz, nz]
// the lower Cholesky factor of H + G' diag(rho) G, rho, lo, hi [ng] and
// h, z0 [nz], all node-major:
//   y = clip(G z0, lo, hi), lm = 0;
//   iters times: z = L'^-1 L^-1 (h + G'(rho (y - lm))), t = G z + lm,
//                y = clip(t, lo, hi), lm = t - y;
// out: lm [N, ng] (the scaled multipliers; mu = rho lm).
//
// Templated on the scalar type: float, as on the TPU
// (qpgen_factor_dtype="float32" or f32 data), and double for f64 data with
// qpgen_factor_dtype="same". Every product and sum is rounded on its own
// (no FMA contraction) in the order of the Pallas body and of the plain
// twin ops/qpgen_lanes.admm_identify_ref: G z sums over z per row g, G'u
// over g in order with h added last, and the triangular solves divide by
// L_ii with no pivot floor (crown_kernels._ltrsv / _uttrsv). The twin
// therefore reproduces the kernel bit for bit, and the working sets derived
// from lm agree exactly.
//
// What bounds it on the card: latency. Each thread runs iters x
// (4 ng nz + 2 nz^2) dependent operations alone. G and L (171 values a node
// at the general C/D trees' nz = 9, ng = 10) are read from global memory
// through the read-only cache on every iteration, the iterates live in
// local arrays, and 32-thread blocks spread the nodes over all SMs. The
// bound (the operations at the FP32 peak) is a few microseconds; a warp per
// node, or G and L staged in shared memory, is the redesign for speed.

#include "tq_eval.cuh"

namespace {

constexpr int kMaxNz = 16;  // stage dim nz = nxm + num the kernel takes
constexpr int kMaxNg = 32;  // constraint rows ng = nz + ncm
constexpr int kThreads = 32;

__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(kThreads) admm_identify_kernel(
    const T* __restrict__ G, const T* __restrict__ L, const T* __restrict__ rho,
    const T* __restrict__ lo, const T* __restrict__ hi, const T* __restrict__ h,
    const T* __restrict__ z0, T* __restrict__ lm_out, int N, int ng, int nz,
    int iters) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const T* Gn = G + (size_t)n * ng * nz;
  const T* Ln = L + (size_t)n * nz * nz;
  const T* rn = rho + (size_t)n * ng;
  const T* lon = lo + (size_t)n * ng;
  const T* hin = hi + (size_t)n * ng;
  const T* hn = h + (size_t)n * nz;
  T y[kMaxNg], lm[kMaxNg], z[kMaxNz];
  for (int k = 0; k < nz; ++k) z[k] = z0[(size_t)n * nz + k];
  for (int g = 0; g < ng; ++g) {
    y[g] = tq::clip(tq::row_dot(Gn, z, g, nz, nz), lon[g], hin[g]);
    lm[g] = T(0);
  }
  for (int it = 0; it < iters; ++it) {
    // right-hand side h + G'(rho (y - lm)): the sum over g first, h last
    for (int k = 0; k < nz; ++k) z[k] = T(0);
    for (int g = 0; g < ng; ++g) {
      const T u = tq::mul(rn[g], tq::sub(y[g], lm[g]));
      for (int k = 0; k < nz; ++k) z[k] = tq::add(z[k], tq::mul(Gn[g * nz + k], u));
    }
    for (int k = 0; k < nz; ++k) z[k] = tq::add(hn[k], z[k]);
    // z = L'^-1 L^-1 rhs, in place
    for (int i = 0; i < nz; ++i) {
      T acc = z[i];
      for (int m = 0; m < i; ++m) acc = tq::sub(acc, tq::mul(Ln[i * nz + m], z[m]));
      z[i] = div_rn(acc, Ln[i * nz + i]);
    }
    for (int i = nz - 1; i >= 0; --i) {
      T acc = z[i];
      for (int m = i + 1; m < nz; ++m) acc = tq::sub(acc, tq::mul(Ln[m * nz + i], z[m]));
      z[i] = div_rn(acc, Ln[i * nz + i]);
    }
    for (int g = 0; g < ng; ++g) {
      const T t = tq::add(tq::row_dot(Gn, z, g, nz, nz), lm[g]);
      y[g] = tq::clip(t, lon[g], hin[g]);
      lm[g] = tq::sub(t, y[g]);
    }
  }
  for (int g = 0; g < ng; ++g) lm_out[(size_t)n * ng + g] = lm[g];
}

template <typename T>
int launch(const T* G, const T* L, const T* rho, const T* lo, const T* hi,
           const T* h, const T* z0, T* lm, int N, int ng, int nz, int iters,
           void* stream) {
  if (N <= 0 || nz <= 0 || nz > kMaxNz || ng < nz || ng > kMaxNg || iters < 0)
    return (int)cudaErrorInvalidValue;
  admm_identify_kernel<T><<<(N + kThreads - 1) / kThreads, kThreads, 0,
                            (cudaStream_t)stream>>>(G, L, rho, lo, hi, h, z0, lm, N,
                                                    ng, nz, iters);
  return (int)cudaGetLastError();
}

}  // namespace

// G, L, rho, lo, hi, h, z0, lm, N, ng, nz, iters, stream
extern "C" int tq_admm_identify_f32(const float* G, const float* L, const float* rho,
                                    const float* lo, const float* hi, const float* h,
                                    const float* z0, float* lm, int N, int ng, int nz,
                                    int iters, void* stream) {
  return launch(G, L, rho, lo, hi, h, z0, lm, N, ng, nz, iters, stream);
}

extern "C" int tq_admm_identify_f64(const double* G, const double* L,
                                    const double* rho, const double* lo,
                                    const double* hi, const double* h, const double* z0,
                                    double* lm, int N, int ng, int nz, int iters,
                                    void* stream) {
  return launch(G, L, rho, lo, hi, h, z0, lm, N, ng, nz, iters, stream);
}
