// Scaled ADMM active-set identification of all general stage QPs, the
// whole iteration loop in one launch, a group of lanes per node.
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
// What bounds it on the card: latency. An iteration is a chain of ~nz
// dependent divisions in each triangular solve plus the sums around them
// (~4 ng nz + 2 nz^2 operations a node); the operations at the FP32 peak
// take a few microseconds for all nodes. The thread-per-node kernel this
// replaces kept its iterates in a local-memory frame and read G and L
// through L1 on every iteration (~20k cycles an iteration). Design:
// - A group of GL lanes takes a node: GL = 16 when ng <= 16, else 32.
//   Lane g owns row g of G with rho_g, lo_g, hi_g, y_g and lm_g; lane k
//   owns column k of G, h_k and row k of L's solves. G and L are read into
//   registers once per launch; the iterates stay in registers and move by
//   __shfl_sync. nz is a template parameter (one instantiation per
//   nz = 1 .. 16, as chain_factor.cu's per n), so every loop is unrolled
//   and every array index constant.
// - G'u: lane k folds G_gk u_g in over g ascending, u_g broadcast from
//   lane g; h_k is added last.
// - L w = rhs, right-looking: lane m divides once its row is complete and
//   broadcasts w_m; lanes i > m fold in L_im w_m, so each row meets its
//   products in ascending m, the twin's order.
// - L' z = w, left-looking: for i = nz-1 .. 0 lane i folds in L_mi z_m over
//   m ascending from i+1 (every lane holds the z_m solved so far) and
//   divides; z_i is broadcast. This keeps the twin's ascending m.
// - Only the lane whose quotient is broadcast divides its own dividend; the
//   others divide d by d, and a zero dividend gets its signed zero without
//   dividing (a zero or special dividend sends the whole warp's division
//   down its slow path).
// - t_g = G_g z + lm_g on lane g from the broadcast z; y_g, lm_g by the clip.

#include "tq_eval.cuh"
#include "tq_lanes.cuh"

namespace {

constexpr int kMaxNz = 16;  // stage dim nz = nxm + num the kernel takes
constexpr int kMaxNg = 32;  // constraint rows ng = nz + ncm
constexpr int kThreads = 128;

template <typename T, int NZ>
__device__ __forceinline__ T dot(const T (&a)[NZ], const T (&b)[NZ]) {
  T acc = T(0);
#pragma unroll
  for (int c = 0; c < NZ; ++c) acc = tq::add(acc, tq::mul(a[c], b[c]));
  return acc;
}

template <typename T, int NZ, int GL>
__global__ void __launch_bounds__(kThreads) admm_identify_kernel(
    const T* __restrict__ G, const T* __restrict__ L, const T* __restrict__ rho,
    const T* __restrict__ lo, const T* __restrict__ hi, const T* __restrict__ h,
    const T* __restrict__ z0, T* __restrict__ lm_out, int N, int ng, int iters) {
  const int lane = threadIdx.x % GL;
  const int node = (blockIdx.x * kThreads + threadIdx.x) / GL;
  const bool live = node < N;  // a group past the last node stores nothing
  const size_t n = live ? node : N - 1;
  const bool grow = lane < ng;  // owns row g = lane of G
  const bool kcol = lane < NZ;  // owns column k = lane of G and row k of L
  const int g = grow ? lane : 0;
  const int k = kcol ? lane : 0;
  const T* Gn = G + n * ng * NZ;
  const T* Ln = L + n * NZ * NZ;
  T Gr[NZ], Gc[GL], Lx[NZ], z[NZ];
#pragma unroll
  for (int c = 0; c < NZ; ++c) Gr[c] = Gn[g * NZ + c];
#pragma unroll
  for (int r = 0; r < GL; ++r) Gc[r] = r < ng ? Gn[r * NZ + k] : T(0);
  // L_km left of the diagonal (the forward solve), L_mk below it (the back
  // solve)
#pragma unroll
  for (int m = 0; m < NZ; ++m) Lx[m] = m < k ? Ln[k * NZ + m] : Ln[m * NZ + k];
  const T d = kcol ? Ln[k * NZ + k] : T(1);
  const T rh = rho[n * ng + g], lo_g = lo[n * ng + g], hi_g = hi[n * ng + g];
  const T hk = h[n * NZ + k];
#pragma unroll
  for (int c = 0; c < NZ; ++c) z[c] = z0[n * NZ + c];
  T y = tq::clip(dot(Gr, z), lo_g, hi_g);
  T lm = T(0);
  for (int it = 0; it < iters; ++it) {
    // right-hand side h + G'(rho (y - lm)): the sum over g first, h last
    const T u = tq::mul(rh, tq::sub(y, lm));
    T w = T(0);
#pragma unroll
    for (int r = 0; r < GL; ++r) {
      const T ur = __shfl_sync(tq::kFull, u, r, GL);
      if (r < ng) w = tq::add(w, tq::mul(Gc[r], ur));
    }
    w = tq::add(hk, w);
    // L w = rhs
#pragma unroll
    for (int m = 0; m < NZ; ++m) {
      const T wm = __shfl_sync(tq::kFull, tq::quotient(w, d, lane == m), m, GL);
      if (lane > m) w = tq::sub(w, tq::mul(Lx[m], wm));
      if (lane == m) w = wm;
    }
    // L' z = w
#pragma unroll
    for (int i = NZ - 1; i >= 0; --i) {
      T a = w;
#pragma unroll
      for (int m = i + 1; m < NZ; ++m) a = tq::sub(a, tq::mul(Lx[m], z[m]));
      z[i] = __shfl_sync(tq::kFull, tq::quotient(a, d, lane == i), i, GL);
    }
    const T t = tq::add(dot(Gr, z), lm);
    y = tq::clip(t, lo_g, hi_g);
    lm = tq::sub(t, y);
  }
  if (live && grow) lm_out[n * ng + lane] = lm;
}

template <typename T, int NZ>
int launch_nz(const T* G, const T* L, const T* rho, const T* lo, const T* hi, const T* h,
              const T* z0, T* lm, int N, int ng, int iters, cudaStream_t st) {
  const int GL = ng <= 16 ? 16 : 32;
  const long long threads = (long long)N * GL;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  if (GL == 16)
    admm_identify_kernel<T, NZ, 16><<<blocks, kThreads, 0, st>>>(G, L, rho, lo, hi, h, z0,
                                                                 lm, N, ng, iters);
  else
    admm_identify_kernel<T, NZ, 32><<<blocks, kThreads, 0, st>>>(G, L, rho, lo, hi, h, z0,
                                                                 lm, N, ng, iters);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* G, const T* L, const T* rho, const T* lo, const T* hi,
           const T* h, const T* z0, T* lm, int N, int ng, int nz, int iters,
           void* stream) {
  if (N <= 0 || nz <= 0 || nz > kMaxNz || ng < nz || ng > kMaxNg || iters < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (nz) {
#define TQ_NZ(NZ_) \
  case NZ_:        \
    return launch_nz<T, NZ_>(G, L, rho, lo, hi, h, z0, lm, N, ng, iters, st);
    TQ_NZ(1) TQ_NZ(2) TQ_NZ(3) TQ_NZ(4) TQ_NZ(5) TQ_NZ(6) TQ_NZ(7) TQ_NZ(8)
    TQ_NZ(9) TQ_NZ(10) TQ_NZ(11) TQ_NZ(12) TQ_NZ(13) TQ_NZ(14) TQ_NZ(15) TQ_NZ(16)
#undef TQ_NZ
    default:
      return (int)cudaErrorInvalidValue;
  }
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
