// The IPM's crown tree-Riccati recursion, factorize and solve, each in one
// launch of one thread block.
//
// Replaces the Pallas kernels crown_ric_factor and crown_ric_solve of
// treeqp_tpu/ops/crown_riccati.py (reached through
// ipm_multistage.ipm_ms_solve on box-only trees and ipm.ipm_solve on
// diagonal box-only trees, on their f32-factored iterations with
// chain_backend="pallas"). Tensors are node-major [Nc, ...].
//
// The level schedule (ops/crown_riccati._get_sched) lists each level's
// nodes, deepest stage first, the root last: lev_node[lev_ptr[r] ..
// lev_ptr[r+1]); the parents those nodes feed, acc_node[acc_ptr[r] ..];
// each node's kids, kid_idx[kid_ptr[n] .. kid_ptr[n+1]) ascending. Threads
// stride over a level's nodes, then over its parents, a barrier after
// each:
//   factor: M = Wsum_n + diag(hbar_n), tq_riccati.cuh's stage factors and
//     W_n = AB_n' P_n AB_n into Wc; Wsum_p += (sum over p's kids of Wc);
//   solve: m = rg_n + wsum_n, p, k and w_n = AB_n'(P_n rb_n + p_n) into wv;
//     wsum_p += (sum over p's kids of wv); then the root (thread 0) solves
//     P_0 dx_0 = -p_0 (clamped Cholesky, no shift); then, nearest level
//     first, dx = AB_n dz_parent + rb_n, du = K dx + k, dlam = P dx + p.
// Wsum / wsum start as the chains' terms Wsum0 / wsum0 at the chain roots.
// The TPU kernel computed every level on all lanes and moved the sums with
// a 0/1 [NPc, NPc] matmul per level; here the sums are index lists in a
// fixed order (no atomics, the same bits on every run) and the crown has
// no node or depth cap.
//
// What bounds it on the card: latency. A level is one stage of ~2.7k
// dependent flops per thread (nx = 8, nz = 9) plus the kid sums, with two
// barriers, and the levels run in sequence on one SM: 5 levels on the
// 341-node crown of the spring-mass tree, 21 on its 4437-node whole tree.

#include "tq_riccati.cuh"

namespace {

// operands: hbar, AB, Wsum0, lev_ptr, lev_node, acc_ptr, acc_node, kid_ptr,
// kid_idx, P, Lu, K, Mxu, Wsum, Wc
struct FactorOps {
  const void* p[15];
};

// operands: P, Lu, K, Mxu, AB, rg, rb, wsum0, lev_ptr, lev_node, acc_ptr,
// acc_node, kid_ptr, kid_idx, par, p, k, wsum, wv, dz, dl
struct SolveOps {
  const void* p[21];
};

template <class T>
__device__ inline T* arg(const void* p) {
  return static_cast<T*>(const_cast<void*>(p));
}

// dst[parent] += sum over its kids of src[kid] (rows of width w), for the
// parents of one level; threads stride over the parents.
__device__ inline void kid_sums(float* __restrict__ dst, const float* __restrict__ src,
                                const int* __restrict__ acc_node, int a0, int a1,
                                const int* __restrict__ kid_ptr,
                                const int* __restrict__ kid_idx, int w) {
  for (int a = a0 + threadIdx.x; a < a1; a += blockDim.x) {
    const int par = acc_node[a];
    for (int e = 0; e < w; ++e) {
      float s = 0.f;
      for (int c = kid_ptr[par]; c < kid_ptr[par + 1]; ++c)
        s += src[(size_t)kid_idx[c] * w + e];
      dst[(size_t)par * w + e] += s;
    }
  }
}

__global__ void __launch_bounds__(1024) crown_ric_factor_kernel(
    FactorOps ops, int Nc, int nx, int nz, int n_lev, float reg) {
  const float* hbar = arg<const float>(ops.p[0]);
  const float* AB = arg<const float>(ops.p[1]);
  const float* Wsum0 = arg<const float>(ops.p[2]);
  const int* lev_ptr = arg<const int>(ops.p[3]);
  const int* lev_node = arg<const int>(ops.p[4]);
  const int* acc_ptr = arg<const int>(ops.p[5]);
  const int* acc_node = arg<const int>(ops.p[6]);
  const int* kid_ptr = arg<const int>(ops.p[7]);
  const int* kid_idx = arg<const int>(ops.p[8]);
  float* P = arg<float>(ops.p[9]);
  float* Lu = arg<float>(ops.p[10]);
  float* K = arg<float>(ops.p[11]);
  float* Mxu = arg<float>(ops.p[12]);
  float* Wsum = arg<float>(ops.p[13]);
  float* Wc = arg<float>(ops.p[14]);
  const int nu = nz - nx, nn = nz * nz;
  for (int e = threadIdx.x; e < Nc * nn; e += blockDim.x) Wsum[e] = Wsum0[e];
  __syncthreads();
  for (int r = 0; r < n_lev; ++r) {
    for (int i = lev_ptr[r] + threadIdx.x; i < lev_ptr[r + 1]; i += blockDim.x) {
      const size_t n = lev_node[i];
      float M[tq::kMaxN * tq::kMaxN];
      for (int e = 0; e < nn; ++e) M[e] = Wsum[n * nn + e];
      for (int d = 0; d < nz; ++d) M[d * nz + d] += hbar[n * nz + d];
      tq::ric_stage_factor(M, AB + n * nx * nz, nx, nz, reg, P + n * nx * nx,
                           Lu + n * nu * nu, K + n * nu * nx, Mxu + n * nx * nu,
                           Wc + n * nn);
    }
    __syncthreads();
    kid_sums(Wsum, Wc, acc_node, acc_ptr[r], acc_ptr[r + 1], kid_ptr, kid_idx, nn);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(1024) crown_ric_solve_kernel(
    SolveOps ops, int Nc, int nx, int nz, int n_lev) {
  const float* P = arg<const float>(ops.p[0]);
  const float* Lu = arg<const float>(ops.p[1]);
  const float* K = arg<const float>(ops.p[2]);
  const float* Mxu = arg<const float>(ops.p[3]);
  const float* AB = arg<const float>(ops.p[4]);
  const float* rg = arg<const float>(ops.p[5]);
  const float* rb = arg<const float>(ops.p[6]);
  const float* wsum0 = arg<const float>(ops.p[7]);
  const int* lev_ptr = arg<const int>(ops.p[8]);
  const int* lev_node = arg<const int>(ops.p[9]);
  const int* acc_ptr = arg<const int>(ops.p[10]);
  const int* acc_node = arg<const int>(ops.p[11]);
  const int* kid_ptr = arg<const int>(ops.p[12]);
  const int* kid_idx = arg<const int>(ops.p[13]);
  const int* par = arg<const int>(ops.p[14]);
  float* p = arg<float>(ops.p[15]);
  float* k = arg<float>(ops.p[16]);
  float* wsum = arg<float>(ops.p[17]);
  float* wv = arg<float>(ops.p[18]);
  float* dz = arg<float>(ops.p[19]);
  float* dl = arg<float>(ops.p[20]);
  const int nu = nz - nx;
  for (int e = threadIdx.x; e < Nc * nz; e += blockDim.x) wsum[e] = wsum0[e];
  __syncthreads();
  // backward right-hand-side sweep
  for (int r = 0; r < n_lev; ++r) {
    for (int i = lev_ptr[r] + threadIdx.x; i < lev_ptr[r + 1]; i += blockDim.x) {
      const size_t n = lev_node[i];
      float m[tq::kMaxN];
      for (int e = 0; e < nz; ++e) m[e] = rg[n * nz + e] + wsum[n * nz + e];
      tq::ric_stage_bwd(m, P + n * nx * nx, Lu + n * nu * nu, Mxu + n * nx * nu,
                        AB + n * nx * nz, rb + n * nx, nx, nz, p + n * nx, k + n * nu,
                        wv + n * nz);
    }
    __syncthreads();
    kid_sums(wsum, wv, acc_node, acc_ptr[r], acc_ptr[r + 1], kid_ptr, kid_idx, nz);
    __syncthreads();
  }
  // the root: P_0 dx_0 = -p_0
  if (threadIdx.x == 0) {
    float Lp[tq::kMaxN * tq::kMaxN], dx[tq::kMaxN];
    for (int e = 0; e < nx * nx; ++e) Lp[e] = P[e];
    tq::chol_inplace<true>(Lp, nx, 0.f);
    for (int x = 0; x < nx; ++x) dx[x] = p[x];
    tq::ltrsv_inplace(Lp, dx, nx);
    tq::uttrsv_inplace(Lp, dx, nx);
    for (int x = 0; x < nx; ++x) dx[x] = -dx[x];
    for (int u = 0; u < nu; ++u) {
      float s = 0.f;
      for (int x = 0; x < nx; ++x) s += K[u * nx + x] * dx[x];
      dz[nx + u] = s + k[u];
    }
    for (int x = 0; x < nx; ++x) {
      float s = 0.f;
      for (int c = 0; c < nx; ++c) s += P[x * nx + c] * dx[c];
      dl[x] = s + p[x];
      dz[x] = dx[x];
    }
  }
  __syncthreads();
  // forward sweep, the level nearest the root first
  for (int r = n_lev - 2; r >= 0; --r) {
    for (int i = lev_ptr[r] + threadIdx.x; i < lev_ptr[r + 1]; i += blockDim.x) {
      const size_t n = lev_node[i];
      tq::ric_stage_fwd(dz + (size_t)par[n] * nz, P + n * nx * nx, K + n * nu * nx,
                        AB + n * nx * nz, rb + n * nx, p + n * nx, k + n * nu, nx, nz,
                        dz + n * nz, dl + n * nx);
    }
    __syncthreads();
  }
}

}  // namespace

// pointers (FactorOps), Nc, nx, nz, n_lev, reg, threads, stream
extern "C" int tq_crown_ric_factor(const void* const* p, int Nc, int nx, int nz,
                                   int n_lev, float reg, int threads, void* stream) {
  FactorOps ops;
  for (int i = 0; i < 15; ++i) ops.p[i] = p[i];
  crown_ric_factor_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(ops, Nc, nx, nz,
                                                                   n_lev, reg);
  return (int)cudaGetLastError();
}

// pointers (SolveOps), Nc, nx, nz, n_lev, threads, stream
extern "C" int tq_crown_ric_solve(const void* const* p, int Nc, int nx, int nz,
                                  int n_lev, int threads, void* stream) {
  SolveOps ops;
  for (int i = 0; i < 21; ++i) ops.p[i] = p[i];
  crown_ric_solve_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(ops, Nc, nx, nz,
                                                                  n_lev);
  return (int)cudaGetLastError();
}
